"""The entropy headers that the range and ANS codecs share
(entropy/EntropyUtils.go): alphabets and frequencies."""

from __future__ import annotations

from .format import Bits, FormatError


def read_alphabet(bits: Bits) -> list[int]:
    if bits.read(1) == 0:
        return [] if bits.read(1) else list(range(256))
    last = bits.read(5)
    masks = bits.read_bytes(last + 1)
    return [8 * i + j for i in range(last + 1) for j in range(8) if (masks[i] >> j) & 1]


def read_frequencies(bits: Bits, alphabet: list[int], log_range: int) -> list[int]:
    """The 256 frequencies of one alphabet: the first inferred, the others
    packed in groups of 6 or 8 with a per-group bit width."""
    scale = 1 << log_range
    freqs = [0] * 256
    group = 6 if len(alphabet) < 64 else 8
    llr = 3
    while (1 << llr) <= log_range:
        llr += 1
    total = 0
    for i in range(1, len(alphabet), group):
        log_max = bits.read(llr)
        if (1 << log_max) > scale:
            raise FormatError("frequency width")
        for j in range(i, min(i + group, len(alphabet))):
            f = 1 + bits.read(log_max) if log_max else 1
            if f >= scale:
                raise FormatError("frequency")
            freqs[alphabet[j]] = f
            total += f
    if total >= scale:
        raise FormatError("frequency sum")
    freqs[alphabet[0]] = scale - total
    return freqs


def slots(freqs: list[int], log_range: int) -> tuple[bytes, list[int]]:
    """Slot -> symbol map and cumulative frequencies."""
    f2s = bytearray(1 << log_range)
    cum = [0] * 257
    for s in range(256):
        f = freqs[s]
        cum[s + 1] = cum[s] + f
        if f:
            f2s[cum[s]:cum[s] + f] = bytes((s,)) * f
    return bytes(f2s), cum
