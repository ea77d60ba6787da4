"""Support utilities: data typing, integer log2, squash/stretch, histograms,
entropy estimation, magic-number detection, job partitioning.

Semantics follow the reference spec (v2/internal/Global.go, Magic.go); the
histogram/entropy paths are numpy-vectorized host fallbacks — the batched
device versions live in kanzi_tpu_torch.ops.block_stats.
"""

from __future__ import annotations

import enum
import math

import numpy as np


class DataType(enum.IntEnum):
    """Detected input data type, drives transform skip heuristics
    (reference: v2/internal/Global.go:22-36)."""
    UNDEFINED = 0
    TEXT = 1
    MULTIMEDIA = 2
    EXE = 3
    NUMERIC = 4
    BASE64 = 5
    DNA = 6
    BIN = 7
    UTF8 = 8
    SMALL_ALPHABET = 9


# ---------------------------------------------------------------------------
# Integer log2 (reference: v2/internal/Global.go:146-191)
# ---------------------------------------------------------------------------

# LOG2_4096[x] = round(4096 * log2(x)) for x in [0..256] (x=0 -> 0)
LOG2_4096 = np.zeros(257, dtype=np.uint32)
for _x in range(1, 257):
    LOG2_4096[_x] = int(math.floor(4096.0 * math.log2(_x) + 0.5))
LOG2_4096.setflags(write=False)


def log2_no_check(x: int) -> int:
    """floor(log2(x)) for x >= 1."""
    return x.bit_length() - 1


def log2(x: int) -> int:
    if x <= 0:
        raise ValueError("Cannot calculate log of a negative or null value")
    return x.bit_length() - 1


def log2_1024(x: int) -> int:
    """1024 * log2(x), max error ~0.1% (reference Log2ScaledBy1024)."""
    if x <= 0:
        raise ValueError("Cannot calculate log of a negative or null value")
    if x < 256:
        return int(LOG2_4096[x] + 2) >> 2
    log = x.bit_length() - 1
    if x & (x - 1) == 0:
        return log << 10
    return ((log - 7) * 1024) + (int(LOG2_4096[x >> (log - 7)] + 2) >> 2)


def _log2_1024_vec(x: np.ndarray) -> np.ndarray:
    """Vectorized log2_1024 over positive int64 values."""
    x = x.astype(np.int64)
    out = np.zeros_like(x)
    small = (x > 0) & (x < 256)
    out[small] = (LOG2_4096[x[small]].astype(np.int64) + 2) >> 2
    big = x >= 256
    if np.any(big):
        xb = x[big]
        # floor(log2) via float log2 is exact for x < 2^48 except at powers
        # of two boundaries; compute carefully with bit tricks
        logs = np.frompyfunc(lambda v: int(v).bit_length() - 1, 1, 1)(xb).astype(np.int64)
        pow2 = (xb & (xb - 1)) == 0
        res = ((logs - 7) << 10) + ((LOG2_4096[(xb >> (logs - 7)).astype(np.int64)].astype(np.int64) + 2) >> 2)
        res[pow2] = logs[pow2] << 10
        out[big] = res
    return out


# ---------------------------------------------------------------------------
# Squash / stretch: the 12-bit logistic nonlinearity used by the
# context-mixing coders (reference: v2/internal/Global.go:89-144)
# ---------------------------------------------------------------------------

# 65536 / (1 + exp(-alpha*x)), alpha ~= 0.54, sampled at 33 points
_INV_EXP = (
    0, 8, 22, 47, 88, 160, 283, 492,
    848, 1451, 2459, 4117, 6766, 10819, 16608, 24127,
    32768, 41409, 48928, 54717, 58770, 61419, 63077, 64085,
    64688, 65044, 65253, 65376, 65448, 65489, 65514, 65528,
    65536,
)

SQUASH_TABLE = np.zeros(4096, dtype=np.int32)
for _x in range(-2047, 2048):
    _w = _x & 127
    _y = (_x >> 7) + 16
    SQUASH_TABLE[_x + 2047] = (_INV_EXP[_y] * (128 - _w) + _INV_EXP[_y + 1] * _w) >> 11
SQUASH_TABLE[4095] = 4095
SQUASH_TABLE.setflags(write=False)

STRETCH_TABLE = np.zeros(4096, dtype=np.int32)
_pi = 0
for _x in range(-2047, 2048):
    _i = int(SQUASH_TABLE[_x + 2047])
    while _pi <= _i:
        STRETCH_TABLE[_pi] = _x
        _pi += 1
STRETCH_TABLE[4095] = 2047
STRETCH_TABLE.setflags(write=False)


def squash(d: int) -> int:
    """p = 1/(1+exp(-d)); d scaled by 8 bits, p scaled by 12 bits."""
    if d >= 2048:
        return 4095
    if d <= -2048:
        return 0
    return int(SQUASH_TABLE[d + 2047])


# ---------------------------------------------------------------------------
# Histograms & entropy estimation
# ---------------------------------------------------------------------------

def compute_histogram_order0(block) -> np.ndarray:
    """Order-0 byte histogram (256 bins, int64)."""
    buf = np.frombuffer(block, dtype=np.uint8) if not isinstance(block, np.ndarray) else block
    return np.bincount(buf, minlength=256).astype(np.int64)


def compute_histogram_order1(block) -> np.ndarray:
    """Order-1 histogram: (256, 256) counts of (prev, cur) pairs, with prev=0
    before the first byte (matches reference lane-0 seeding,
    v2/internal/Global.go:313)."""
    buf = np.frombuffer(block, dtype=np.uint8) if not isinstance(block, np.ndarray) else block
    if len(buf) == 0:
        return np.zeros((256, 256), dtype=np.int64)
    prev = np.empty_like(buf)
    prev[0] = 0
    prev[1:] = buf[:-1]
    idx = prev.astype(np.int64) * 256 + buf
    return np.bincount(idx, minlength=65536).astype(np.int64).reshape(256, 256)


def first_order_entropy_1024(block_len: int, histo: np.ndarray) -> int:
    """Order-0 entropy scaled by 1024 (range [0..1024]); >= 973 means
    incompressible (reference ComputeFirstOrderEntropy1024)."""
    if block_len == 0:
        return 0
    h = np.asarray(histo, dtype=np.int64)[:256]
    nz = h[h > 0]
    if len(nz) == 0:
        return 0
    log_len = log2_1024(block_len)
    logs = _log2_1024_vec(nz)
    total = int(np.sum((nz * (log_len - logs)) >> 3, dtype=np.int64))
    return total // block_len


_BASE64_SYMBOLS = b"ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/"
_NUMERIC_SYMBOLS = b"0123456789+-*/=,.:; "
_DNA_SYMBOLS = b'acgntuACGNTU"'


def detect_simple_type(count: int, freqs0: np.ndarray) -> DataType:
    """DNA/NUMERIC/BASE64/BIN/SMALL_ALPHABET classification from order-0
    frequencies (reference DetectSimpleType, v2/internal/Global.go:346-419)."""
    if count == 0:
        return DataType.UNDEFINED
    f = np.asarray(freqs0, dtype=np.int64)
    if int(f[list(_DNA_SYMBOLS[:12])].sum()) > count - count // 12:
        return DataType.DNA
    if int(f[list(_NUMERIC_SYMBOLS)].sum()) == count:
        return DataType.NUMERIC
    if int(f[list(_BASE64_SYMBOLS)].sum()) + int(f[0x3D]) == count:
        return DataType.BASE64
    present = int(np.count_nonzero(f[:256]))
    if present == 256:
        return DataType.BIN
    if present <= 4:
        return DataType.SMALL_ALPHABET
    return DataType.UNDEFINED


def compute_jobs_per_task(jobs: int, tasks: int) -> list[int]:
    """Distribute `jobs` over `tasks`: quotient + round-robin remainder
    (reference ComputeJobsPerTask, v2/internal/Global.go:424-460)."""
    if tasks <= 0 or jobs <= 0:
        raise ValueError("jobs and tasks must be positive")
    if jobs <= tasks:
        q, r = 1, 0
    else:
        q, r = jobs // tasks, jobs - (jobs // tasks) * tasks
    result = [q] * tasks
    n = 0
    while r:
        result[n] += 1
        r -= 1
        n = (n + 1) % tasks
    return result


# ---------------------------------------------------------------------------
# Magic numbers (reference: v2/internal/Magic.go)
# ---------------------------------------------------------------------------

NO_MAGIC = 0
JPG_MAGIC = 0xFFD8FFE0
GIF_MAGIC = 0x47494638
PDF_MAGIC = 0x25504446
ZIP_MAGIC = 0x504B0304
LZMA_MAGIC = 0x377ABCAF
PNG_MAGIC = 0x89504E47
ELF_MAGIC = 0x7F454C46
MAC_MAGIC32 = 0xFEEDFACE
MAC_CIGAM32 = 0xCEFAEDFE
MAC_MAGIC64 = 0xFEEDFACF
MAC_CIGAM64 = 0xCFFAEDFE
ZSTD_MAGIC = 0x28B52FFD
BROTLI_MAGIC = 0x81CFB2CE
RIFF_MAGIC = 0x52494646
CAB_MAGIC = 0x4D534346
FLAC_MAGIC = 0x664C6143
XZ_MAGIC = 0xFD377A58
RAR_MAGIC = 0x52617221
KNZ_MAGIC = 0x4B414E5A
BZIP2_MAGIC = 0x425A68
MP3_ID3_MAGIC = 0x494433
GZIP_MAGIC = 0x1F8B
BMP_MAGIC = 0x424D
WIN_MAGIC = 0x4D5A
PBM_MAGIC = 0x5034
PGM_MAGIC = 0x5035
PPM_MAGIC = 0x5036

_KEYS32 = frozenset((
    GIF_MAGIC, PDF_MAGIC, ZIP_MAGIC, LZMA_MAGIC, PNG_MAGIC,
    ELF_MAGIC, MAC_MAGIC32, MAC_CIGAM32, MAC_MAGIC64, MAC_CIGAM64,
    ZSTD_MAGIC, BROTLI_MAGIC, CAB_MAGIC, RIFF_MAGIC, FLAC_MAGIC,
    XZ_MAGIC, KNZ_MAGIC, RAR_MAGIC,
))
_KEYS16 = frozenset((GZIP_MAGIC, BMP_MAGIC, WIN_MAGIC))

_COMPRESSED_MAGICS = frozenset((
    JPG_MAGIC, GIF_MAGIC, PNG_MAGIC, LZMA_MAGIC, ZSTD_MAGIC, BROTLI_MAGIC,
    CAB_MAGIC, ZIP_MAGIC, GZIP_MAGIC, BZIP2_MAGIC, FLAC_MAGIC, MP3_ID3_MAGIC,
    XZ_MAGIC, KNZ_MAGIC, RAR_MAGIC,
))
_MULTIMEDIA_MAGICS = frozenset((
    JPG_MAGIC, GIF_MAGIC, PNG_MAGIC, RIFF_MAGIC, FLAC_MAGIC, MP3_ID3_MAGIC,
    BMP_MAGIC, PBM_MAGIC, PGM_MAGIC, PPM_MAGIC,
))
_EXECUTABLE_MAGICS = frozenset((
    ELF_MAGIC, WIN_MAGIC, MAC_MAGIC32, MAC_CIGAM32, MAC_MAGIC64, MAC_CIGAM64,
))


def get_magic_type(src) -> int:
    """Detect a known file magic from the first 4 bytes."""
    if len(src) < 4:
        return NO_MAGIC
    b = bytes(src[:4])
    key = int.from_bytes(b, "big")
    if (key & ~0x0F) == JPG_MAGIC:
        return key
    if (key >> 8) in (BZIP2_MAGIC, MP3_ID3_MAGIC):
        return key >> 8
    if key in _KEYS32:
        return key
    key16 = key >> 16
    if key16 in _KEYS16:
        return key16
    if key16 in (PBM_MAGIC, PGM_MAGIC, PPM_MAGIC):
        subkey = (key >> 8) & 0xFF
        if subkey in (0x07, 0x0A, 0x0D, 0x20):
            return key16
    return NO_MAGIC


def is_data_compressed(magic: int) -> bool:
    return magic in _COMPRESSED_MAGICS


def is_data_multimedia(magic: int) -> bool:
    return magic in _MULTIMEDIA_MAGICS


def is_data_executable(magic: int) -> bool:
    return magic in _EXECUTABLE_MAGICS


class BufferStream:
    """Closable in-memory read/write stream (reference:
    v2/internal/BufferStream.go:24-82).

    Unlike io.BytesIO, reads consume from the front of what writes appended
    (pipe-like), and any operation after close() raises OSError — used for
    per-task local bitstreams and by the fault-injection tests.
    """

    def __init__(self, data: bytes = b""):
        self._buf = bytearray(data)
        self._rpos = 0
        self._closed = False

    def write(self, b) -> int:
        if self._closed:
            raise OSError("stream closed")
        self._buf += bytes(b)
        return len(b)

    def read(self, n: int = -1) -> bytes:
        if self._closed:
            raise OSError("stream closed")
        end = len(self._buf) if n < 0 else min(len(self._buf), self._rpos + n)
        res = bytes(self._buf[self._rpos:end])
        self._rpos = end
        return res

    def __len__(self) -> int:
        return len(self._buf) - self._rpos

    def close(self) -> None:
        self._closed = True

    def getvalue(self) -> bytes:
        return bytes(self._buf)


_RESERVED_NAMES = {
    "CON", "PRN", "AUX", "NUL",
    *(f"COM{i}" for i in range(1, 10)), *(f"LPT{i}" for i in range(1, 10)),
}


def is_reserved_name(name: str) -> bool:
    """Windows reserved device names (reference: v2/internal/File.go)."""
    import os as _os
    base = _os.path.basename(name).split(".")[0].upper()
    return base in _RESERVED_NAMES


def create_file_list(name: str, no_dot_files: bool = False,
                     no_links: bool = False, reorder: bool = True) -> list[str]:
    """Recursive walk with symlink/dot-file filters, sorted by
    (directory, size desc) for balanced multi-file scheduling
    (reference: v2/internal/File.go:31-220)."""
    import os as _os
    if not _os.path.isdir(name):
        return [name]
    out: list[str] = []
    for root, dirs, files in _os.walk(name, followlinks=not no_links):
        if no_dot_files:
            dirs[:] = [d for d in dirs if not d.startswith(".")]
        for f in files:
            if no_dot_files and f.startswith("."):
                continue
            p = _os.path.join(root, f)
            if no_links and _os.path.islink(p):
                continue
            out.append(p)
    if reorder:
        out.sort(key=lambda p: (_os.path.dirname(p), -_os.path.getsize(p)))
    return out
