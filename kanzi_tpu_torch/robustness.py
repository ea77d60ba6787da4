"""Hostile streams for the decode contract, and the outcome of a decode.

The contract (kanzi_tpu's tests/test_faults_and_cli.py): every corrupt or
truncated stream decodes to the same bytes, or raises the same KanziError
code, on the device route as on the host C++ route (device=None), and none
raises a DeviceFault. `streams` makes seeded good streams of the four
device entropy codecs and mutates them:

- xor: one to three byte XORs anywhere in the stream (the recipe of
  test_fuzz_mutations_never_crash_or_pass_silently);
- payload: one to three byte XORs inside one block's entropy payload;
- trunc: the stream cut at a seeded point;
- header: a byte XOR in the first 48 bytes of a block's entropy payload,
  where its first chunk's header sits (ANS: logRange, alphabet and
  frequencies; RANGE: alphabet, logRange and frequency table; HUFFMAN:
  the code lengths);
- logrange: ANS, the 3-bit logRange field that opens a block's payload;
- size: one bit of a block's pre-transform size field;
- chunksize: one bit of a size varint of a block's first chunk: ANS,
  its stream size; HUFFMAN, a lane's bit count.

`outcome` names what a decode gave; `check` decodes each stream on a
device and on the host and counts the outcomes. chip_smoke.py's
robustness phase and tests/test_torch_gpu.py run them on the card,
tests/test_torch_conformance_fuzz.py on the CPU ("cpu" against None and
kanzi_tpu).
"""

from __future__ import annotations

import hashlib
import time

import numpy as np

from . import native
from .bench import MIB, synth_corpus
from .core import KanziError

SEED = 0x524F42          # "ROB"

# the device entropy codecs, on the chains of the main path
CODECS = {
    "HUFFMAN": dict(transform="DNA+LZ", entropy="HUFFMAN"),   # level 2: K4
    "ANS0": dict(transform="TEXT+UTF+BWT+RANK+ZRLT", entropy="ANS0"),  # level 5: K6
    "ANS1": dict(transform="NONE", entropy="ANS1"),           # K6, order 1
    "RANGE": dict(transform="LZ", entropy="RANGE"),           # K8
}
KINDS = ("xor", "payload", "trunc", "header", "logrange", "size", "chunksize")


def outcome(decode) -> tuple:
    """("bytes", sha256 of what decode() returns) or ("KanziError", code);
    any other exception (a DeviceFault above all) propagates."""
    try:
        return "bytes", hashlib.sha256(decode()).hexdigest()
    except KanziError as e:
        return "KanziError", e.code


def _frames(blob: bytes) -> list:
    """(payload bit position, entropy payload bit position, size field bit
    position and width) of each block frame."""
    from .kio.compressed_stream import frame_table
    frames, r = frame_table(blob)
    out = []
    for pos, _ in frames:
        byte, k = pos >> 3, pos & 7
        mode = ((blob[byte] << 8 | (blob[byte + 1] if byte + 1 < len(blob) else 0))
                >> (8 - k)) & 0xFF
        hdr = 16 if mode & 0x10 else 8
        width = 8 * (1 + ((mode >> 5) & 3))
        out.append((pos, pos + hdr + width + r.checksum_bits, pos + hdr, width))
    return out


def _read_bits(blob: bytes, at: int, n: int) -> int:
    v = 0
    for j in range(n):
        p = at + j
        v = (v << 1) | ((blob[p >> 3] >> (7 - (p & 7))) & 1)
    return v


def _flip(blob: bytes, at: int, mask: int, width: int) -> bytes:
    """XOR `mask` (`width` bits, most significant first) in at bit `at`."""
    b = bytearray(blob)
    for j in range(width):
        if (mask >> (width - 1 - j)) & 1 and at + j < 8 * len(b):
            b[(at + j) >> 3] ^= 0x80 >> ((at + j) & 7)
    return bytes(b)


def _varint_at(byte: np.ndarray, p: int) -> tuple:
    """The varint at bit `p` (`byte` holds the byte at every bit): (value,
    bit width)."""
    v, shift, q = 0, 0, p
    for _ in range(4):
        c = int(byte[q])
        q += 8
        v |= (c & 0x7F) << shift
        shift += 7
        if c < 0x80:
            break
    return v, q - p


def _chunk_size_field(blob: bytes, start: int, codec: str, out_len: int):
    """The bit position and width of a size varint of a block's first
    chunk: ANS, its stream size, where a varint equal to the prepare's is
    followed by the prepare's four states; HUFFMAN, one of its four lane
    sizes, where four varints equal to the prepare's follow each other.
    None where there is none."""
    from .bitstream import BitReader
    br = BitReader(blob)
    br._pos = start
    nbits = min(8 * len(blob) - start, 8 * 65536)
    payload = np.frombuffer(br.read_array(nbits), np.uint8)
    try:
        if codec == "HUFFMAN":
            *_, flags, _, sizes = native.huffman_dec_prepare(payload, out_len,
                                                             with_lane_bits=True)
            want, tail = [int(v) for v in sizes[:4]], []
        else:
            _, _, states, _, buf_sz, flags, _, _ = native.ans_dec_prepare(
                payload, out_len, 1 if codec == "ANS1" else 0)
            want, tail = [int(buf_sz[0])], [int(s) & 0xFFFFFFFF for s in states[0]]
    except native.NativeError:
        return None
    if not len(flags) or flags[0] != 0:
        return None
    bits = np.unpackbits(payload)
    if len(bits) < 8 * 40:
        return None
    # the byte at every bit position; the candidates start with the first
    # size's varint
    win = np.lib.stride_tricks.sliding_window_view(bits, 8)
    byte = win.astype(np.int64) @ (1 << np.arange(7, -1, -1))
    first, v = [], want[0]
    while True:
        first.append((v & 0x7F) | (0x80 if v >= 0x80 else 0))
        v >>= 7
        if not v:
            break
    span = len(byte) - 8 * 24
    hit = np.ones(span, bool)
    for j, c in enumerate(first):
        hit &= byte[8 * j:8 * j + span] == c
    for p in np.nonzero(hit)[0].tolist():
        fields, q = [], p
        for w in want:
            v, width = _varint_at(byte, q)
            if v != w:
                break
            fields.append((start + q, width))
            q += width
        else:
            if all(_read_bits(blob, start + q + 32 * j, 32) == t for j, t in enumerate(tail)):
                return fields[len(fields) // 2]
    return None


def mutate(blob: bytes, kind: str, codec: str, rng):
    """One mutant of `blob` of the given kind, or None where the kind does
    not apply."""
    if kind == "xor":
        b = bytearray(blob)
        for _ in range(int(rng.integers(1, 4))):
            b[int(rng.integers(0, len(b)))] ^= int(rng.integers(1, 256))
        return bytes(b)
    if kind == "trunc":
        return blob[:int(rng.integers(1, len(blob)))]
    frames = _frames(blob)
    f = int(rng.integers(0, len(frames)))
    pos, start, size_at, size_width = frames[f]
    end = frames[f + 1][0] - 8 if f + 1 < len(frames) else 8 * len(blob) - 16
    if kind == "payload":
        b = blob
        for _ in range(int(rng.integers(1, 4))):
            b = _flip(b, int(rng.integers(start, max(end, start + 8))),
                      int(rng.integers(1, 256)), 8)
        return b
    if kind == "header":
        return _flip(blob, start + 8 * int(rng.integers(0, 48)), int(rng.integers(1, 256)), 8)
    if kind == "size":
        return _flip(blob, size_at + int(rng.integers(0, size_width)), 1, 1)
    if kind == "logrange":
        return _flip(blob, start, int(rng.integers(1, 8)), 3) if codec.startswith("ANS") else None
    if codec == "RANGE":
        return None
    found = _chunk_size_field(blob, start, codec, _read_bits(blob, size_at, size_width))
    if found is None:
        return None
    at, width = found
    return _flip(blob, at + int(rng.integers(0, width)), 1, 1)


def streams(count: int, big: int = 0, seed: int = SEED, block: int = 64 << 10,
            nblocks: int = 4):
    """`count` mutants of seeded good streams, in turns over the codecs,
    checksum 32 and 0 and the kinds, of `nblocks` blocks of `block`
    bytes; then `big` more of one-block streams of the main path's 4 MiB
    blocks. Yields (codec, block size, checksum, kind, good data, mutant).
    The good streams are made on the host C++ route."""
    from . import compress
    rng = np.random.default_rng(seed)
    corpus = synth_corpus(8 * MIB if big else max(block * nblocks, MIB), seed)
    made = {}

    def good(codec, bs, checksum, n):
        key = (codec, bs, checksum)
        if key not in made:
            at = int(rng.integers(0, len(corpus) - n + 1))
            data = corpus[at:at + n]
            made[key] = data, compress(data, block_size=bs, checksum=checksum,
                                       jobs=4, device=None, **CODECS[codec])
        return made[key]

    plan = [(block, nblocks * block)] * count + [(4 * MIB, 4 * MIB)] * big
    for i, (bs, n) in enumerate(plan):
        codec = list(CODECS)[i % len(CODECS)]
        checksum = 32 if (i // len(CODECS)) % 2 == 0 else 0
        data, blob = good(codec, bs, checksum, n)
        k = i // (2 * len(CODECS))
        for j in range(len(KINDS)):
            kind = KINDS[(k + j) % len(KINDS)]
            bad = mutate(blob, kind, codec, rng)
            if bad is not None and bad != blob:
                yield codec, bs, checksum, kind, data, bad
                break


def check(cases, decode_device, decode_host, jobs=(4,)) -> dict:
    """Decode every case on the device and on the host, decode(bytes,
    jobs) each, the k-th case at jobs[k % len(jobs)] on both (a Reader's
    outcome may depend on it); count the outcomes. Returns {"streams",
    "exact", "other_bytes", "rejected" {code: n}, "wrong_bytes" (a mutant
    with checksum 32 that decoded to other bytes than the input),
    "disagree" [(codec, block size, kind, checksum, jobs, device, host)],
    "by_codec", "seconds"}."""
    t0 = time.perf_counter()
    res = {"streams": 0, "exact": 0, "other_bytes": 0, "rejected": {},
           "wrong_bytes": 0, "disagree": [], "by_codec": {}}
    for k, (codec, bs, checksum, kind, data, bad) in enumerate(cases):
        j = jobs[k % len(jobs)]
        got = outcome(lambda: decode_device(bad, j))
        want = outcome(lambda: decode_host(bad, j))
        res["streams"] += 1
        res["by_codec"][f"{codec}@{bs >> 10}K"] = res["by_codec"].get(f"{codec}@{bs >> 10}K", 0) + 1
        if got != want:
            res["disagree"].append((codec, bs, kind, checksum, j, got, want))
        if got[0] == "KanziError":
            res["rejected"][got[1]] = res["rejected"].get(got[1], 0) + 1
        elif got[1] == hashlib.sha256(data).hexdigest():
            res["exact"] += 1
        else:
            res["other_bytes"] += 1
            res["wrong_bytes"] += checksum == 32
    res["seconds"] = time.perf_counter() - t0
    return res
