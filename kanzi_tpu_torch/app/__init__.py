"""kanzi-compatible command-line application.

Flags mirror the reference CLI (v2/app/Kanzi.go): -c/-d/-y modes,
-i/-o/-b/-t/-e/-j/-v/-l/-x/-s/-f/--rm/--from/--to, block size with K/M/G
suffixes plus 'auto', level presets 0-9, multi-file inputs with directory
walk and size-ordered scheduling.

One flag is added to kanzi_tpu.app's: --device=<cuda|cpu|none> (cuda by
default) is the `device` of every Writer and Reader the CLI builds, so the
HUFFMAN, ANS0, ANS1 and RANGE entropy stages run on the card, block events
(-v 3 and above) included. Without a card, --device cuda exits with an
error before any output file is created; the CLI never moves to the host
on its own. A failure of the card during a run (a DeviceFault: a refused
launch, a failed kernel build, an error of the CUDA context) prints the
fault and exits with ERR_UNKNOWN, never with a corrupt input's code. The
-y header table parses headers only, on the host.
"""

from __future__ import annotations

import os
import sys
import time

from .. import (LEVEL_PRESETS, DEFAULT_BLOCK_SIZE, Reader, Writer, KanziError,
                __version__, _kernels, block_size_for_level)
from ..core import (ERR_CREATE_COMPRESSOR, ERR_CREATE_DECOMPRESSOR,
                    ERR_INVALID_PARAM, ERR_MISSING_PARAM, ERR_OPEN_FILE,
                    ERR_OVERWRITE_FILE, ERR_CREATE_FILE, ERR_PROCESS_BLOCK,
                    ERR_INVALID_FILE, ERR_UNKNOWN, EventType)
from .infoprinter import COMPRESSION, DECOMPRESSION, INFO, InfoPrinter

_APP_HEADER = f"kanzi_tpu_torch {__version__} (C) 2026"

_HELP = """Usage: kanzi_tpu_torch [arguments]

   -h, --help              display this message
   -c, --compress          compress mode
   -d, --decompress        decompress mode
   -y, --info              display headers of compressed files
   -i, --input=<file>      name of the input file/directory ('STDIN' for stdin)
   -o, --output=<file>     name of the output file/directory ('STDOUT', 'NONE')
   -b, --block=<size>      block size [1024..1GiB] (suffix K/M/G), or 'auto'
   -l, --level=<0..9>      compression level preset:
                           0 = NONE&NONE, 1 = LZX&NONE, 2 = DNA+LZ&HUFFMAN,
                           3 = TEXT+UTF+PACK+MM+LZX&HUFFMAN,
                           4 = TEXT+UTF+EXE+PACK+MM+ROLZ&NONE,
                           5 = TEXT+UTF+BWT+RANK+ZRLT&ANS0,
                           6 = TEXT+UTF+BWT+SRT+ZRLT&FPAQ,
                           7 = LZP+TEXT+UTF+BWT+LZP&CM,
                           8 = EXE+RLT+TEXT+UTF+DNA&TPAQ,
                           9 = EXE+RLT+TEXT+UTF+DNA&TPAQX
   -t, --transform=<list>  '+'-joined transforms: NONE BWT BWTS LZ LZX LZP
                           ROLZ ROLZX RLT ZRLT MTFT RANK SRT TEXT UTF EXE
                           MM PACK DNA
   -e, --entropy=<name>    NONE HUFFMAN FPAQ RANGE ANS0 ANS1 CM TPAQ TPAQX
   -j, --jobs=<n>          number of concurrent jobs [1..64] (0 = all cores)
   -v, --verbose=<0..5>    verbosity level
   -x, -x32, -x64, --checksum=<size>
                           write block checksums (32 or 64 bits)
   -s, --skip              detect and copy incompressible blocks
   -f, --force             overwrite the output file
   --rm                    remove the input file after successful processing
   --from=<n>, --to=<n>    decompress only blocks in [from, to)
   --no-file-reorder       keep command-line file order (multi-file mode)
   --no-dot-files          skip dot files (alias: --skip-dot-files)
   --no-links              skip symbolic links (alias: --skip-links)
   --cpuProf=<file>        dump a CPU profile of the run to <file>
   --device=<name>         cuda (default), cpu (plain PyTorch) or none (host C++)
"""


def _parse_block_size(s: str) -> int:
    s = s.strip().upper()
    if s == "AUTO":
        return -1
    mult = 1
    if s.endswith("K"):
        mult, s = 1024, s[:-1]
    elif s.endswith("M"):
        mult, s = 1024 * 1024, s[:-1]
    elif s.endswith("G"):
        mult, s = 1 << 30, s[:-1]
    return int(s) * mult


from ..internal import create_file_list as _collect_files_sorted


def _collect_files(name: str, no_dot_files: bool, no_links: bool) -> list[str]:
    return _collect_files_sorted(name, no_dot_files, no_links, reorder=False)


class _Args:
    mode = ""
    input_name = ""
    output_name = ""
    block_size = -2  # unset
    level = -1
    transform = ""
    entropy = ""
    jobs = -1
    verbose = 1
    checksum = 0
    skip = False
    force = False
    remove = False
    block_from = None
    block_to = None
    file_reorder = True
    no_dot_files = False
    no_links = False
    cpu_prof = ""
    device = "cuda"  # the Writers' and Readers' device; None: host C++


def _parse_args(argv: list[str]) -> _Args | int:
    a = _Args()
    value_opts = {
        "-i": "input", "--input": "input",
        "-o": "output", "--output": "output",
        "-b": "block", "--block": "block",
        "-l": "level", "--level": "level",
        "-t": "transform", "--transform": "transform",
        "-e": "entropy", "--entropy": "entropy",
        "-j": "jobs", "--jobs": "jobs",
        "-v": "verbose", "--verbose": "verbose",
        "--from": "from", "--to": "to",
        "-p": "cpuProf", "--cpuProf": "cpuProf",  # both reference spellings
        "--device": "device",
    }
    i = 0
    pending = None
    while i < len(argv):
        arg = argv[i].strip()
        i += 1
        if pending is None:
            if arg in ("-h", "--help"):
                return 0
            if arg in ("-c", "--compress"):
                a.mode = "c"
                continue
            if arg in ("-d", "--decompress"):
                a.mode = "d"
                continue
            if arg in ("-y", "--info"):
                a.mode = "y"
                continue
            if arg in ("-f", "--force"):
                a.force = True
                continue
            if arg in ("-s", "--skip"):
                a.skip = True
                continue
            if arg == "-x" or arg == "-x32":
                a.checksum = 32
                continue
            if arg == "-x64":
                a.checksum = 64
                continue
            if arg.startswith("--checksum="):
                # Reference long form (Kanzi.go:628-650): only 32/64 valid,
                # anything else is ERR_INVALID_PARAM.
                val = arg[len("--checksum="):].strip()
                if val not in ("32", "64"):
                    print(f"Warning: invalid option [checksum={val}]",
                          file=sys.stderr)
                    return ERR_INVALID_PARAM
                a.checksum = int(val)
                continue
            if arg == "--rm":
                a.remove = True
                continue
            if arg == "--no-file-reorder":
                a.file_reorder = False
                continue
            # Both spellings accepted: ours and the reference's
            # (Kanzi.go:441,451 --skip-dot-files/--skip-links), so existing
            # kanzi scripts work unchanged.
            if arg in ("--no-dot-files", "--skip-dot-files"):
                a.no_dot_files = True
                continue
            if arg in ("--no-links", "--skip-links"):
                a.no_links = True
                continue
            key = None
            val = None
            if "=" in arg:
                k, val = arg.split("=", 1)
                key = value_opts.get(k)
            elif arg in value_opts:
                pending = value_opts[arg]
                continue
            if key is None:
                print(f"Warning: ignoring unknown option [{arg}]", file=sys.stderr)
                continue
        else:
            key, val = pending, arg
            pending = None

        try:
            if key == "input":
                # keywords are case-insensitive (BlockCompressor.go:339
                # strings.EqualFold) — normalize once here
                a.input_name = "STDIN" if val.upper() == "STDIN" else val
            elif key == "output":
                a.output_name = (val.upper()
                                 if val.upper() in ("STDOUT", "NONE") else val)
            elif key == "block":
                a.block_size = _parse_block_size(val)
            elif key == "level":
                a.level = int(val)
            elif key == "transform":
                a.transform = val
            elif key == "entropy":
                a.entropy = val
            elif key == "jobs":
                a.jobs = int(val)
            elif key == "verbose":
                a.verbose = int(val)
            elif key == "from":
                a.block_from = int(val)
            elif key == "to":
                a.block_to = int(val)
            elif key == "cpuProf":
                a.cpu_prof = val
            elif key == "device":
                dev = val.strip().lower()
                if dev not in ("cuda", "cpu", "none"):
                    raise ValueError(val)
                a.device = None if dev == "none" else dev
        except ValueError:
            print(f"Invalid value for option {key}: {val}", file=sys.stderr)
            return ERR_INVALID_PARAM
    if pending is not None:
        print(f"Warning: ignoring option [{pending}] with no value", file=sys.stderr)
    return a


def _compress_one(a: _Args, in_path: str, out_path: str, listener) -> int:
    transform, entropy = a.transform or "NONE", a.entropy or "NONE"
    if a.level >= 0:
        if a.level > 9:
            print(f"Invalid compression level: {a.level}", file=sys.stderr)
            return ERR_INVALID_PARAM
        transform, entropy = LEVEL_PRESETS[a.level]

    if in_path == "STDIN":
        fin = sys.stdin.buffer
        file_size = 0
    else:
        try:
            fin = open(in_path, "rb")
            file_size = os.path.getsize(in_path)
        except OSError as e:
            print(f"Cannot open input file '{in_path}': {e}", file=sys.stderr)
            return ERR_OPEN_FILE

    block_size = a.block_size
    if block_size == -1:  # auto: fileSize/jobs rounded (reference :522-528)
        jobs = max(a.jobs, 1)
        block_size = max((file_size + jobs - 1) // jobs, 1024)
        block_size = (block_size + 63) & ~63
        block_size = min(block_size, 1 << 30)
    elif block_size == -2:
        block_size = block_size_for_level(a.level) if a.level >= 0 else DEFAULT_BLOCK_SIZE

    if out_path not in ("STDOUT", "NONE") and os.path.exists(out_path) and not a.force:
        print(f"File '{out_path}' exists, use -f to overwrite", file=sys.stderr)
        return ERR_OVERWRITE_FILE

    start = time.time()
    from ..core import Event
    from ..kio import NullOutputStream
    if out_path == "STDOUT":
        fout = sys.stdout.buffer
    elif out_path == "NONE":
        fout = NullOutputStream()
    else:
        try:
            fout = open(out_path, "wb")
        except OSError as e:
            print(f"Cannot create output file '{out_path}': {e}", file=sys.stderr)
            return ERR_CREATE_FILE

    w = Writer(fout, transform=transform, entropy=entropy,
               block_size=block_size, jobs=max(a.jobs, 1), checksum=a.checksum,
               file_size=file_size,
               ctx={"skipBlocks": True} if a.skip else None, device=a.device)
    if listener:
        w.add_listener(listener)
        listener.process_event(Event(EventType.COMPRESSION_START, -1, 0,
                                     time_=start))
    # stream in bounded chunks (the Writer batches into block buffers)
    read_size = max(block_size, 1 << 20)
    nread = 0
    while True:
        chunk = fin.read(read_size)
        if not chunk:
            break
        nread += len(chunk)
        w.write(chunk)
    w.close()
    nwritten = w.written_bytes
    if in_path != "STDIN":
        fin.close()
    if out_path not in ("STDOUT", "NONE"):
        fout.close()
    if listener:
        listener.process_event(Event(EventType.COMPRESSION_END, -1, nwritten,
                                     time_=time.time()))

    dt = time.time() - start
    if a.verbose >= 1:
        ratio = nwritten / max(nread, 1)
        speed = nread / max(dt, 1e-9) / 1024
        print(f"Compressed {in_path}: {nread} => {nwritten} bytes "
              f"({100 * ratio:.2f}%) in {1000 * dt:.0f} ms ({speed:.0f} KiB/s)",
              file=sys.stderr)
    if a.remove and in_path != "STDIN":
        os.remove(in_path)
    return 0


def _decompress_one(a: _Args, in_path: str, out_path: str, listener) -> int:
    if in_path == "STDIN":
        fin = sys.stdin.buffer
        in_size = 0
    else:
        try:
            fin = open(in_path, "rb")
            in_size = os.path.getsize(in_path)
        except OSError as e:
            print(f"Cannot open input file '{in_path}': {e}", file=sys.stderr)
            return ERR_OPEN_FILE

    if out_path not in ("STDOUT", "NONE") and os.path.exists(out_path) and not a.force:
        print(f"File '{out_path}' exists, use -f to overwrite", file=sys.stderr)
        return ERR_OVERWRITE_FILE

    ctx = {}
    if a.block_from is not None:
        ctx["from"] = a.block_from
    if a.block_to is not None:
        ctx["to"] = a.block_to

    start = time.time()
    from ..core import Event
    from ..kio import NullOutputStream
    if out_path == "STDOUT":
        fout = sys.stdout.buffer
    elif out_path == "NONE":
        fout = NullOutputStream()
    else:
        fout = open(out_path, "wb")

    r = Reader(fin, jobs=max(a.jobs, 1), ctx=ctx,  # streaming source
               device=a.device)
    if listener:
        r.add_listener(listener)
        listener.process_event(Event(EventType.DECOMPRESSION_START, -1, 0,
                                     time_=start))
    ndec = 0
    while True:
        data = r.read(1 << 20)
        if not data:
            break
        ndec += len(data)
        fout.write(data)
    r.close()
    if in_path != "STDIN":
        fin.close()
    if out_path not in ("STDOUT", "NONE"):
        fout.close()
    dt = time.time() - start
    # A --from/--to partial decode is expected to be smaller than the header's
    # outputSize: skip the size check then (ref: v2/app/BlockDecompressor.go:716-728).
    if (r.outputSize and ndec != r.outputSize
            and a.block_from is None and a.block_to is None):
        print(f"Corrupted bitstream: invalid output size (expected "
              f"{r.outputSize}, got {ndec})", file=sys.stderr)
        return ERR_INVALID_FILE
    if listener:
        listener.process_event(Event(EventType.DECOMPRESSION_END, -1,
                                     ndec, time_=time.time()))

    if a.verbose >= 1:
        speed = ndec / max(dt, 1e-9) / 1024
        print(f"Decompressed {in_path}: {in_size or 'stream'} => {ndec} bytes "
              f"in {1000 * dt:.0f} ms ({speed:.0f} KiB/s)", file=sys.stderr)
    if a.remove and in_path != "STDIN":
        os.remove(in_path)
    return 0


def _info_one(a: _Args, in_path: str, printer) -> int:
    # streaming source: only the header bytes are read; the listener
    # receives AFTER_HEADER_DECODING with the parsed HeaderInfo and
    # renders the table row (reference: InfoPrinter INFO mode)
    with open(in_path, "rb") as f:
        r = Reader(f, ctx={"from": 1, "to": 1,
                           "inputName": in_path,
                           "fileSize": os.path.getsize(in_path)}, device=None)
        if printer is not None:
            r.listeners.append(printer)
        r._read_header()
    return 0


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    parsed = _parse_args(argv)
    if isinstance(parsed, int):
        if parsed == 0:
            print(_APP_HEADER)
            print(_HELP)
        return parsed
    a = parsed

    if not a.mode:
        print(_APP_HEADER)
        print(_HELP)
        return 0
    if a.jobs == 0:
        a.jobs = min(os.cpu_count() or 1, 64)
    elif a.jobs < 0:
        a.jobs = max((os.cpu_count() or 1) // 2, 1)
    a.jobs = min(a.jobs, 64)

    # reference attach conditions: verbosity > 2 for c/d
    # (BlockCompressor.go:439, BlockDecompressor.go:332) with
    # firstBlockId = --from on decompression (BlockDecompressor.go:339-345)
    listener = None
    if a.verbose > 2:
        if a.mode == "c":
            listener = InfoPrinter(a.verbose, COMPRESSION)
        else:
            listener = InfoPrinter(a.verbose, DECOMPRESSION,
                                   first_block_id=a.block_from or 1)

    if a.mode == "y":
        if not a.input_name:
            print("Missing input file name", file=sys.stderr)
            return ERR_MISSING_PARAM
        # one shared INFO printer renders the -y header table through the
        # listener surface (reference: InfoPrinter type INFO,
        # v2/app/InfoPrinter.go:311-407); column-title row prints once.
        # INFO mode requires verbosity > 0 (BlockDecompressor.go:332):
        # -y -v 0 prints nothing, like the reference.
        res = 0
        printer = InfoPrinter(a.verbose, INFO, out=sys.stdout) \
            if a.verbose > 0 else None
        for f in _collect_files(a.input_name, a.no_dot_files, a.no_links):
            res = res or _info_one(a, f, printer)
        return res

    # the device is checked before any input is read or output created:
    # a request for the card never runs on the host instead
    try:
        _kernels.resolve_device(a.device)
    except RuntimeError:
        print(f"No CUDA device is available for --device {a.device}: pass "
              "--device cpu (the kernels' plain PyTorch versions) or "
              "--device none (the host C++ engine)", file=sys.stderr)
        return ERR_CREATE_COMPRESSOR if a.mode == "c" else ERR_CREATE_DECOMPRESSOR

    if not a.input_name and not a.output_name:
        a.input_name, a.output_name = "STDIN", "STDOUT"
        a.verbose = 0

    inputs = ["STDIN"] if a.input_name in ("", "STDIN") else \
        _collect_files(a.input_name, a.no_dot_files, a.no_links)
    if len(inputs) > 1 and a.file_reorder:
        # sort by (directory, size desc) for balanced scheduling (ref File.go)
        inputs.sort(key=lambda p: (os.path.dirname(p), -os.path.getsize(p)))

    profiler = None
    if a.cpu_prof:
        import cProfile
        profiler = cProfile.Profile()
        profiler.enable()

    def _out_path_for(in_path: str) -> str:
        if a.mode == "c":
            if len(inputs) == 1:
                return a.output_name or (
                    in_path + ".knz" if in_path != "STDIN" else "STDOUT")
            return in_path + ".knz"
        if len(inputs) == 1:
            if a.output_name:
                return a.output_name
            if in_path.endswith(".knz"):
                return in_path[:-4]
            return in_path + ".out" if in_path != "STDIN" else "STDOUT"
        return in_path[:-4] if in_path.endswith(".knz") else in_path + ".out"

    def _run_one(in_path: str, jobs: int) -> int:
        sub = a
        if jobs != a.jobs:
            import copy
            sub = copy.copy(a)
            sub.jobs = jobs
        try:
            if a.mode == "c":
                return _compress_one(sub, in_path, _out_path_for(in_path), listener)
            return _decompress_one(sub, in_path, _out_path_for(in_path), listener)
        except _kernels.DeviceFault as e:
            print(f"Device fault while processing '{in_path}': {e}", file=sys.stderr)
            return ERR_UNKNOWN

    res = 0
    if len(inputs) > 1 and a.jobs > 1 and a.verbose > 1:
        # reference BlockCompressor.go:386-389: concurrent multi-file block
        # events interleave, so cap verbosity at the per-file summaries
        print("Warning: limiting verbosity to 1 due to concurrent processing"
              " of input files.", file=sys.stderr)
        a.verbose = 1
        listener = None  # block-event listener attaches at verbosity > 2
    if len(inputs) > 1 and a.jobs > 1 and "STDIN" not in inputs:
        # multi-file worker pool: jobs split across concurrent file tasks
        # (reference P3, v2/app/BlockCompressor.go:543-618 +
        # internal.ComputeJobsPerTask)
        from concurrent.futures import ThreadPoolExecutor
        from ..internal import compute_jobs_per_task
        tasks = min(len(inputs), a.jobs)
        per_task = compute_jobs_per_task(a.jobs, tasks)
        with ThreadPoolExecutor(max_workers=tasks) as pool:
            futs = [pool.submit(_run_one, p, per_task[i % tasks])
                    for i, p in enumerate(inputs)]
            for f in futs:
                res = res or f.result()
    else:
        for in_path in inputs:
            res = res or _run_one(in_path, a.jobs)

    if profiler is not None:
        profiler.disable()
        profiler.dump_stats(a.cpu_prof)
        print(f"CPU profile written to {a.cpu_prof}", file=sys.stderr)
    return res
