"""MSB-first bitstream writer/reader.

Implements the exact bit-level contract of the KANZ container (reference:
v2/bitstream/DefaultOutputBitStream.go, DefaultInputBitStream.go):

- values are written MSB-first; write_bits(v, n) emits the n low bits of v,
  most significant of those n bits first
- byte arrays are bit-packed with no alignment
- the final byte of a closed stream is zero-padded in its low bits

The per-field scalar path uses Python ints (exact 64-bit semantics via
masking); the bulk array paths (used for block payload splicing) are
numpy-vectorized so host-side frame assembly is bandwidth-bound, not
interpreter-bound.
"""

from __future__ import annotations

import numpy as np

from .core import KanziError, ERR_READ_FILE, ERR_WRITE_FILE

_MASK64 = (1 << 64) - 1


class BitWriter:
    """Accumulates bits MSB-first into an in-memory byte buffer."""

    __slots__ = ("_chunks", "_acc", "_nbits", "_closed", "_flushed_bytes")

    def __init__(self):
        self._chunks: list[bytes] = []
        self._acc = 0          # pending bits (value of the bit string), < 8 bits
        self._nbits = 0        # number of pending bits in _acc
        self._closed = False
        self._flushed_bytes = 0

    @property
    def written(self) -> int:
        """Exact number of bits written so far."""
        return self._flushed_bytes * 8 + self._nbits

    def write_bit(self, bit: int) -> None:
        self.write_bits(bit & 1, 1)

    def write_bits(self, value: int, count: int) -> int:
        """Write the `count` low bits of `value`, MSB of those bits first."""
        if self._closed:
            raise KanziError("Stream closed", ERR_WRITE_FILE)
        if not 1 <= count <= 64:
            raise KanziError(f"Invalid bit count: {count} (must be in [1..64])",
                             ERR_WRITE_FILE)
        acc = (self._acc << count) | (value & ((1 << count) - 1))
        nbits = self._nbits + count
        if nbits >= 8:
            nbytes = nbits >> 3
            rem = nbits & 7
            self._chunks.append((acc >> rem).to_bytes(nbytes, "big"))
            self._flushed_bytes += nbytes
            acc &= (1 << rem) - 1
            nbits = rem
        self._acc = acc
        self._nbits = nbits
        return count

    def write_array(self, data, count: int) -> int:
        """Write `count` bits taken MSB-first from byte buffer `data`."""
        if self._closed:
            raise KanziError("Stream closed", ERR_WRITE_FILE)
        buf = np.frombuffer(data, dtype=np.uint8) if not isinstance(data, np.ndarray) \
            else data.view(np.uint8)
        if count > len(buf) * 8:
            raise KanziError(f"Invalid length: {count}", ERR_WRITE_FILE)
        full = count >> 3
        rem = count & 7
        k = self._nbits
        if full:
            if k == 0:
                self._chunks.append(buf[:full].tobytes())
            else:
                # shift the whole array left by (8-k) bits, prepending the
                # pending k bits; vectorized over the full payload
                c = np.empty(full + 1, dtype=np.uint16)
                c[0] = self._acc
                c[1:] = buf[:full]
                out = (((c[:-1] << (8 - k)) | (c[1:] >> k)) & 0xFF).astype(np.uint8)
                self._chunks.append(out.tobytes())
                self._acc = int(buf[full - 1]) & ((1 << k) - 1)
            self._flushed_bytes += full
        if rem:
            self.write_bits(int(buf[full]) >> (8 - rem), rem)
        return count

    def close(self) -> None:
        """Pad the final partial byte with low zero bits. Idempotent."""
        if self._closed:
            return
        if self._nbits:
            self._chunks.append(bytes([(self._acc << (8 - self._nbits)) & 0xFF]))
            self._acc = 0
            self._nbits = 0
        self._closed = True

    def getvalue(self) -> bytes:
        """Bytes so far (pending partial byte padded low, without closing)."""
        tail = b""
        if self._nbits:
            tail = bytes([(self._acc << (8 - self._nbits)) & 0xFF])
        return b"".join(self._chunks) + tail


class DebugBitWriter:
    """Delegating writer that logs every bit-level operation — debugging aid
    (reference: v2/bitstream/DebugOutputBitStream.go).

    `out` is a text stream (e.g. sys.stderr); `hexa` switches between binary
    and hex rendering; `mark` appends a /length marker per call.
    """

    def __init__(self, delegate, out=None, width: int = 80,
                 hexa: bool = False, mark: bool = False):
        import sys
        self._d = delegate
        self._out = out if out is not None else sys.stderr
        self._width = max(width, 8)
        self._hexa = hexa
        self._mark = mark
        self._col = 0

    def _emit(self, text: str) -> None:
        self._out.write(text)
        self._col += len(text)
        if self._col >= self._width:
            self._out.write("\n")
            self._col = 0
        else:
            self._out.write(" ")
            self._col += 1

    def _show(self, value: int, count: int) -> None:
        if self._hexa:
            s = format(value & ((1 << count) - 1), f"0{(count + 3) // 4}X")
        else:
            s = format(value & ((1 << count) - 1), f"0{count}b")
        if self._mark:
            s += f"/{count}"
        self._emit(s)

    @property
    def written(self) -> int:
        return self._d.written

    @property
    def _chunks(self):
        # container-internal drain hook: expose the delegate's completed
        # chunks so an injected debug stream is a drop-in Writer bitstream
        # (Writer(obs=...), reference NewWriterWithCtx2)
        return self._d._chunks

    def write_bit(self, bit: int) -> None:
        self._show(bit & 1, 1)
        self._d.write_bit(bit)

    def write_bits(self, value: int, count: int) -> int:
        self._show(value, count)
        return self._d.write_bits(value, count)

    def write_array(self, data, count: int) -> int:
        buf = np.frombuffer(data, dtype=np.uint8) if not isinstance(data, np.ndarray) \
            else data
        for i in range((count + 7) >> 3):
            self._show(int(buf[i]), min(8, count - 8 * i))
        return self._d.write_array(data, count)

    def close(self) -> None:
        self._d.close()

    def getvalue(self) -> bytes:
        return self._d.getvalue()


class DebugBitReader:
    """Delegating reader that logs every bit-level operation
    (reference: v2/bitstream/DebugInputBitStream.go)."""

    def __init__(self, delegate, out=None, width: int = 80,
                 hexa: bool = False, mark: bool = False):
        import sys
        self._d = delegate
        self._out = out if out is not None else sys.stderr
        self._width = max(width, 8)
        self._hexa = hexa
        self._mark = mark
        self._col = 0

    def _emit(self, text: str) -> None:
        self._out.write(text)
        self._col += len(text)
        if self._col >= self._width:
            self._out.write("\n")
            self._col = 0
        else:
            self._out.write(" ")
            self._col += 1

    def _show(self, value: int, count: int) -> None:
        if self._hexa:
            s = format(value & ((1 << count) - 1), f"0{(count + 3) // 4}X")
        else:
            s = format(value & ((1 << count) - 1), f"0{count}b")
        if self._mark:
            s += f"/{count}"
        self._emit(s)

    @property
    def read(self) -> int:
        return self._d.read

    @property
    def _pos(self) -> int:
        # container-internal cursor passthrough so an injected debug stream
        # is a drop-in Reader bitstream (Reader(ibs=...), reference
        # NewReaderWithCtx2)
        return self._d._pos

    @_pos.setter
    def _pos(self, v: int) -> None:
        self._d._pos = v

    def has_more(self) -> bool:
        return self._d.has_more()

    def read_bit(self) -> int:
        bit = self._d.read_bit()
        self._show(bit, 1)
        return bit

    def read_bits(self, count: int) -> int:
        val = self._d.read_bits(count)
        self._show(val, count)
        return val

    def read_array(self, count: int) -> bytes:
        data = self._d.read_array(count)
        buf = np.frombuffer(data, dtype=np.uint8)
        for i in range((count + 7) >> 3):
            self._show(int(buf[i]), min(8, count - 8 * i))
        return data


class BitReader:
    """Reads bits MSB-first from an in-memory byte buffer."""

    __slots__ = ("_buf", "_nbits_total", "_pos")

    def __init__(self, data):
        self._buf = np.frombuffer(data, dtype=np.uint8) if not isinstance(data, np.ndarray) \
            else data.view(np.uint8)
        self._nbits_total = len(self._buf) * 8
        self._pos = 0  # bit position

    @property
    def read(self) -> int:
        """Number of bits consumed so far."""
        return self._pos

    def has_more(self) -> bool:
        return self._pos < self._nbits_total

    def read_bit(self) -> int:
        return self.read_bits(1)

    def read_bits(self, count: int) -> int:
        if not 1 <= count <= 64:
            raise KanziError(f"Invalid bit count: {count}", ERR_READ_FILE)
        end = self._pos + count
        if end > self._nbits_total:
            raise KanziError("No more data to read in the bitstream", ERR_READ_FILE)
        first = self._pos >> 3
        last = (end + 7) >> 3
        val = int.from_bytes(self._buf[first:last].tobytes(), "big")
        tail = (last << 3) - end
        self._pos = end
        return (val >> tail) & ((1 << count) - 1)

    def read_array(self, count: int) -> bytes:
        """Read `count` bits into a byte buffer (last byte padded low)."""
        end = self._pos + count
        if end > self._nbits_total:
            raise KanziError("No more data to read in the bitstream", ERR_READ_FILE)
        nbytes = (count + 7) >> 3
        first = self._pos >> 3
        k = self._pos & 7
        if k == 0:
            out = self._buf[first:first + nbytes].copy()
        else:
            src = self._buf[first:first + nbytes + 1]
            if len(src) < nbytes + 1:
                src = np.concatenate([src, np.zeros(1, dtype=np.uint8)])
            s = src.astype(np.uint16)
            out = (((s[:-1] << k) | (s[1:] >> (8 - k))) & 0xFF).astype(np.uint8)
        rem = count & 7
        if rem:
            out[-1] &= (0xFF << (8 - rem)) & 0xFF
        self._pos = end
        return out.tobytes()
