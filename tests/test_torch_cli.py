"""The port's CLI against kanzi_tpu's: the same argv through
kanzi_tpu.app.main and kanzi_tpu_torch.app.main (in-process, stdin, stdout
and stderr captured; the port with --device cpu and --device none). Exit
codes are equal, output files equal byte for byte, and stdout and stderr
equal once times (`N ms`, `N KiB/s`) and the app header are masked."""

import io
import os
import re
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from kanzi_tpu.app import main as ref_main
from kanzi_tpu_torch import _kernels
from kanzi_tpu_torch.app import main as port_main
from kanzi_tpu_torch.core import ERR_INVALID_PARAM

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEVICES = ("cpu", "none")

with open(os.path.join(ROOT, "SURVEY.md"), "rb") as _fh:
    _TEXT = _fh.read()


def _mixed(n: int, seed: int = 5) -> bytes:
    """Seeded text, random, zero, DNA and int32-delta parts, cut to n."""
    rng = np.random.default_rng(seed)
    parts = [_TEXT * (n // len(_TEXT) // 2 + 1),
             rng.integers(0, 256, n // 8, dtype=np.uint8).tobytes(),
             np.zeros(n // 8, dtype=np.uint8).tobytes(),
             np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n // 8)].tobytes(),
             np.cumsum(rng.integers(-3, 4, n // 32)).astype("<i4").tobytes()]
    return b"".join(parts)[:n]


_MASKS = ((re.compile(r"\d+ ms"), "N ms"), (re.compile(r"\d+ KiB/s"), "N KiB/s"),
          (re.compile(r"^kanzi_tpu(_torch)? \S+ \(C\) \d+$", re.M), "HEADER"))


def _mask(text: str) -> str:
    for pat, sub in _MASKS:
        text = pat.sub(sub, text)
    return text


def _run(main, argv, stdin=b""):
    """(exit code, stdout bytes, stderr text) of main(argv) in-process."""
    out = io.BytesIO()
    fake_out = io.TextIOWrapper(out, write_through=True)
    fake_in = io.TextIOWrapper(io.BytesIO(stdin))
    err = io.StringIO()
    with mock.patch.object(sys, "stdin", fake_in), \
            mock.patch.object(sys, "stdout", fake_out), \
            mock.patch.object(sys, "stderr", err):
        rc = main(list(argv))
        fake_out.flush()
    return rc, out.getvalue(), err.getvalue()


def _snapshot(root):
    """Every file under root: relative path -> bytes."""
    files = {}
    for dirpath, _dirs, names in os.walk(root):
        for name in names:
            p = os.path.join(dirpath, name)
            with open(p, "rb") as fh:
                files[os.path.relpath(p, root)] = fh.read()
    return files


def _restore(root, files):
    """Put back the files of a snapshot: remove the new ones, rewrite the
    changed or removed ones (links that the run left alone stay links)."""
    now = _snapshot(root)
    for rel in now.keys() - files.keys():
        os.remove(os.path.join(root, rel))
    for rel, content in files.items():
        if now.get(rel) != content:
            with open(os.path.join(root, rel), "wb") as fh:
                fh.write(content)


def _same(root, argv, device, stdin=b"", any_order=False):
    """Run argv through kanzi_tpu's CLI, then (from the same files) through
    the port's with --device; hold exit codes, the files left and the
    masked text equal (as sorted lines where `any_order`: the multi-file
    pool prints each file's line when it ends). Returns the reference's
    (rc, stdout, stderr)."""
    before = _snapshot(root)
    want = _run(ref_main, argv, stdin)
    want_files = _snapshot(root)
    _restore(root, before)
    got = _run(port_main, [*argv, f"--device={device}"], stdin)
    assert got[0] == want[0], (argv, got[2], want[2])
    assert got[1] == want[1], argv
    order = sorted if any_order else list
    assert order(_mask(got[2]).splitlines()) == order(_mask(want[2]).splitlines()), argv
    assert _snapshot(root) == want_files, argv
    return want


@pytest.fixture
def work(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


@pytest.mark.parametrize("level", range(10))
def test_levels_match_reference(work, level):
    (work / "mix.bin").write_bytes(_mixed(256 * 1024))
    for device in DEVICES:
        _same(work, ["-c", "-i", "mix.bin", "-o", "mix.knz", "-l", str(level),
                     "-b", "64k", "-j", "4", "-f", "-x32"], device)
        _same(work, ["-d", "-i", "mix.knz", "-o", "mix.out", "-j", "4", "-f"], device)
        assert (work / "mix.out").read_bytes() == (work / "mix.bin").read_bytes()


@pytest.mark.parametrize("entropy,transform", [("ANS1", "NONE"), ("RANGE", "LZ")])
def test_ans1_range_match_reference(work, entropy, transform):
    # the plain range and ANS1 loops are slow on the CPU: 64 KiB, 4 blocks
    (work / "s.bin").write_bytes(_mixed(64 * 1024, seed=6))
    for device in DEVICES:
        _same(work, ["-c", "-i", "s.bin", "-o", "s.knz", "-e", entropy, "-t",
                     transform, "-b", "16k", "-j", "4", "-f", "-s"], device)
        _same(work, ["-d", "-i", "s.knz", "-o", "s.out", "-j", "4", "-f"], device)
        assert (work / "s.out").read_bytes() == (work / "s.bin").read_bytes()


@pytest.mark.parametrize("device", DEVICES)
def test_stdin_stdout_pipe(work, device):
    data = b"stdin to stdout pipe " * 500 + _mixed(20000)
    rc, blob, _ = _same(work, ["-c", "-i", "STDIN", "-o", "STDOUT", "-l", "2",
                               "-v", "0"], device, stdin=data)
    assert rc == 0 and blob[:4] == b"KANZ"
    rc, out, _ = _same(work, ["-d", "-i", "stdin", "-o", "stdout", "-v", "0"],
                       device, stdin=blob)
    assert rc == 0 and out == data
    # no -i and no -o: stdin to stdout, quiet
    rc, blob2, _ = _same(work, ["-c", "-l", "2"], device, stdin=data)
    assert rc == 0 and blob2 == blob


@pytest.mark.parametrize("device", DEVICES)
def test_multi_file_worker_pool(work, device):
    """-j 4 over a directory: the file worker pool, one Writer a file on
    the pool's threads (device Writers at once with --device cpu)."""
    d = work / "dir"
    d.mkdir()
    for i in range(5):
        (d / f"w{i}.dat").write_bytes(f"file {i} ".encode() * (100 * (i + 1))
                                      + _mixed(3000, seed=i))
    sources = _snapshot(d)
    _same(work, ["-c", "-i", "dir", "-l", "2", "-f", "-j", "4", "-b", "4k"], device,
          any_order=True)
    assert sorted(_snapshot(d)) == sorted([*sources, *(p + ".knz" for p in sources)])
    for p in list(sources):
        os.remove(d / p)
    _same(work, ["-d", "-i", "dir", "-f", "-j", "4", "-v", "2"], device, any_order=True)
    assert {p: c for p, c in _snapshot(d).items() if not p.endswith(".knz")} == sources


def test_counts_hold_under_threads():
    """The multi-file pool runs device Writers on several threads, all
    counting launches: no count is lost (more threads than cores, a short
    switch interval)."""
    import threading

    n_threads, n_calls = 4 * (os.cpu_count() or 1), 2000
    _kernels.reset_counts()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [_kernels.count_plain("pack_lanes")
                                                    for _ in range(n_calls)])
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert _kernels.plain_calls["pack_lanes"] == n_threads * n_calls


@pytest.mark.parametrize("device", DEVICES)
def test_overwrite_protection(work, device):
    (work / "in.txt").write_bytes(b"overwrite test" * 10)
    (work / "out.knz").write_bytes(b"existing")
    rc, _, _ = _same(work, ["-c", "-i", "in.txt", "-o", "out.knz", "-l", "1"], device)
    assert rc != 0 and (work / "out.knz").read_bytes() == b"existing"
    rc, _, _ = _same(work, ["-c", "-i", "in.txt", "-o", "out.knz", "-l", "2", "-f"],
                     device)
    assert rc == 0


@pytest.mark.parametrize("checksum,bits", [("-x32", 32), ("-x64", 64), ("-x", 32),
                                           ("--checksum=32", 32), ("--checksum=64", 64)])
def test_checksums_and_info_table(work, checksum, bits):
    (work / "in.txt").write_bytes(_mixed(50000))
    for device in DEVICES:
        rc, _, _ = _same(work, ["-c", "-i", "in.txt", "-o", "in.knz", "-l", "3",
                                "-f", checksum, "-v", "0"], device)
        assert rc == 0
        for v in ("1", "4"):
            rc, out, _ = _same(work, ["-y", "-i", "in.knz", "-v", v], device)
            assert rc == 0 and b"|     File Name      |Ver|Check|Block Size" in out
        assert f"|   {bits}|".encode() in out


@pytest.mark.parametrize("device", DEVICES)
def test_invalid_checksum_rejected(work, device):
    (work / "in.txt").write_bytes(b"checksum long form " * 200)
    rc, _, err = _same(work, ["-c", "-i", "in.txt", "-o", "in.knz", "-l", "1",
                              "--checksum=16"], device)
    assert rc == ERR_INVALID_PARAM and "checksum=16" in err


@pytest.mark.parametrize("device", DEVICES)
def test_rm_flag(work, device):
    (work / "in.txt").write_bytes(_mixed(30000))
    rc, _, _ = _same(work, ["-c", "-i", "in.txt", "-o", "o.knz", "-l", "2", "-f",
                            "--rm"], device)
    assert rc == 0 and not (work / "in.txt").exists()


@pytest.mark.parametrize("device", DEVICES)
def test_from_to_partial_decode(work, device):
    data = b"cli from/to partial decode " * 9000
    (work / "in.bin").write_bytes(data)
    _same(work, ["-c", "-i", "in.bin", "-o", "in.knz", "-b", "64K", "-l", "2",
                 "-f"], device)
    rc, _, _ = _same(work, ["-d", "-i", "in.knz", "-o", "part.bin", "--from", "2",
                            "--to", "4", "-f", "-j", "4", "-v", "4"], device)
    assert rc == 0 and (work / "part.bin").read_bytes() == data[65536:3 * 65536]


@pytest.mark.parametrize("flags", [("--no-dot-files", "--no-links"),
                                   ("--skip-dot-files", "--skip-links")])
def test_dot_files_and_links(work, flags):
    d = work / "dir"
    d.mkdir()
    (d / "plain.txt").write_bytes(b"visible data " * 20)
    (d / ".hidden").write_bytes(b"dot file " * 20)
    os.symlink(d / "plain.txt", d / "link.txt")
    for device in DEVICES:
        rc, _, _ = _same(work, ["-c", "-i", "dir", "-l", "2", "-f", "-v", "0",
                                *flags], device)
        assert rc == 0
        assert sorted(p for p in os.listdir(d) if p.endswith(".knz")) == ["plain.txt.knz"]
        for p in os.listdir(d):
            if p.endswith(".knz"):
                os.remove(d / p)


BLOCK_LINE = re.compile(r"^Block (\d+): \d+ => \d+ \[\d+ ms\] => \d+ \[\d+ ms\]")


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("verbose,jobs", [("3", "4"), ("4", "4"), ("5", "1")])
def test_block_lines(work, device, verbose, jobs):
    """-v 3 and above attach the block listener: with --device cpu the
    Writer's and Reader's device paths send the events (-v 4: one line a
    block, in order; -v 5: every event, at jobs=1 so that the order is
    the reference's)."""
    (work / "in.txt").write_bytes(_mixed(5 * 16384 + 77, seed=9))
    _kernels.reset_counts()
    _, _, err = _same(work, ["-c", "-i", "in.txt", "-o", "in.knz", "-l", "2", "-b",
                             "16k", "-j", jobs, "-v", verbose, "-f", "-x32", "-s"],
                      device)
    _, _, err_d = _same(work, ["-d", "-i", "in.knz", "-o", "in.out", "-j", jobs,
                               "-v", verbose, "-f"], device)
    if device == "cpu":  # the entropy stage stayed on the device path
        assert _kernels.plain_calls["pack_lanes"] > 0
        assert _kernels.plain_calls["decode_lanes"] > 0
    for text in (err, err_d):
        ids = [int(m.group(1)) for m in map(BLOCK_LINE.match, text.splitlines()) if m]
        assert ids == ([] if verbose == "3" else [1, 2, 3, 4, 5, 6]), text
    if verbose == "5":
        assert '"type":"BLOCK_INFO"' in err and '"type":"AFTER_ENTROPY"' in err_d


def test_help_and_device_flag(work):
    rc, out, _ = _run(port_main, ["--help"])
    want_rc, want, _ = _run(ref_main, ["--help"])
    assert rc == want_rc == 0
    lines = out.decode().splitlines()
    assert lines[0].startswith("kanzi_tpu_torch ")
    device_lines = [ln for ln in lines if "--device" in ln]
    assert len(device_lines) == 1
    port_help = "\n".join(ln for ln in lines[1:] if ln not in device_lines)
    assert port_help == "\n".join(want.decode().splitlines()[1:]).replace(
        "Usage: kanzi_tpu ", "Usage: kanzi_tpu_torch ")
    (work / "in.txt").write_bytes(b"device flag " * 100)
    for bad in ("--device=tpu", "--device=gpu"):
        rc, _, err = _run(port_main, ["-c", "-i", "in.txt", "-o", "o.knz", bad])
        assert rc == ERR_INVALID_PARAM and "device" in err
        assert not (work / "o.knz").exists()
    # the spaced form takes the same values
    rc, _, _ = _run(port_main, ["-c", "-i", "in.txt", "-o", "o.knz", "-l", "2",
                                "--device", "None"])
    assert rc == 0 and (work / "o.knz").exists()


def test_cuda_without_a_card_exits_and_writes_nothing(work):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    (work / "in.txt").write_bytes(_mixed(20000))
    env = dict(os.environ, PYTHONPATH=ROOT)
    for argv in (["-c", "-i", "in.txt", "-o", "in.knz", "-l", "2"],
                 ["-c", "-i", "in.txt", "-o", "in.knz", "-l", "2", "--device", "cuda"]):
        res = subprocess.run([sys.executable, "-m", "kanzi_tpu_torch", *argv],
                             cwd=work, env=env, capture_output=True, text=True,
                             timeout=120)
        assert res.returncode != 0
        assert "No CUDA device" in res.stderr, res.stderr
        assert res.stdout == ""
        assert sorted(os.listdir(work)) == ["in.txt"]
    # decompress too: a host stream, and no output file left
    rc, _, _ = _run(port_main, ["-c", "-i", "in.txt", "-o", "in.knz", "-l", "2",
                                "--device=none"])
    assert rc == 0
    rc, _, err = _run(port_main, ["-d", "-i", "in.knz", "-o", "in.out"])
    assert rc != 0 and "No CUDA device" in err
    assert not (work / "in.out").exists()
