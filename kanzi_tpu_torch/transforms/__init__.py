"""Transform stage: registry, factory and the ≤8-transform sequence.

Chain encoding: a 48-bit value with 8 six-bit slots, MSB slot first
(reference: v2/transform/Factory.go:25-54). The skip-flags byte produced by
the sequence is part of the bitstream (bit i set = transform i skipped).
"""

from __future__ import annotations

import numpy as np

from .base import Transform, TransformSkip, as_u8

_ONE_SHIFT = 6
_MAX_SHIFT = (8 - 1) * _ONE_SHIFT
_MASK = (1 << _ONE_SHIFT) - 1

NONE_TYPE = 0
BWT_TYPE = 1
BWTS_TYPE = 2
LZ_TYPE = 3
RLT_TYPE = 5
ZRLT_TYPE = 6
MTFT_TYPE = 7
RANK_TYPE = 8
EXE_TYPE = 9
DICT_TYPE = 10
ROLZ_TYPE = 11
ROLZX_TYPE = 12
SRT_TYPE = 13
LZP_TYPE = 14
MM_TYPE = 15
LZX_TYPE = 16
UTF_TYPE = 17
PACK_TYPE = 18
DNA_TYPE = 19

_NAME_BY_ID = {
    NONE_TYPE: "NONE", BWT_TYPE: "BWT", BWTS_TYPE: "BWTS", LZ_TYPE: "LZ",
    RLT_TYPE: "RLT", ZRLT_TYPE: "ZRLT", MTFT_TYPE: "MTFT", RANK_TYPE: "RANK",
    EXE_TYPE: "EXE", DICT_TYPE: "TEXT", ROLZ_TYPE: "ROLZ", ROLZX_TYPE: "ROLZX",
    SRT_TYPE: "SRT", LZP_TYPE: "LZP", MM_TYPE: "MM", LZX_TYPE: "LZX",
    UTF_TYPE: "UTF", PACK_TYPE: "PACK", DNA_TYPE: "DNA",
}
_ID_BY_NAME = {v: k for k, v in _NAME_BY_ID.items()}

# SBRT modes (reference: v2/transform/SBRT.go)
SBRT_MODE_MTF = 1
SBRT_MODE_RANK = 2
SBRT_MODE_TIMESTAMP = 3


def get_type(name: str) -> int:
    """Pack 'A+B+C' into the 48-bit chain value, MSB slot first."""
    tokens = name.split("+")
    if len(tokens) > 8:
        raise ValueError(f"Only 8 transforms allowed: '{name}'")
    res = 0
    shift = _MAX_SHIFT
    for token in tokens:
        t = token.upper()
        if t not in _ID_BY_NAME:
            raise ValueError(f"Unknown transform type: '{token}'")
        tk = _ID_BY_NAME[t]
        if tk != NONE_TYPE:
            res |= tk << shift
            shift -= _ONE_SHIFT
    return res


def get_name(ttype: int) -> str:
    parts = []
    for i in range(8):
        t = (ttype >> (_MAX_SHIFT - _ONE_SHIFT * i)) & _MASK
        if t == NONE_TYPE:
            continue
        if t not in _NAME_BY_ID:
            raise ValueError(f"Unknown transform type: '{t}'")
        parts.append(_NAME_BY_ID[t])
    return "+".join(parts) if parts else "NONE"


def _new_transform(ctx: dict, ttype: int) -> Transform:
    """Instantiate one transform; some registry entries parameterize a shared
    implementation (reference: v2/transform/Factory.go:97-185)."""
    from .null import NullTransform

    if ttype == NONE_TYPE:
        return NullTransform(ctx)
    if ttype in (LZ_TYPE, LZX_TYPE, LZP_TYPE):
        from .lz import LZCodec
        ctx["lz"] = ttype
        return LZCodec(ctx)
    if ttype == ZRLT_TYPE:
        from .native_backed import ZRLT
        return ZRLT(ctx)
    if ttype == RLT_TYPE:
        from .native_backed import RLT
        return RLT(ctx)
    if ttype == SRT_TYPE:
        from .native_backed import SRT
        return SRT(ctx)
    if ttype == RANK_TYPE:
        from .native_backed import SBRT
        ctx["sbrt"] = SBRT_MODE_RANK
        return SBRT(ctx)
    if ttype == MTFT_TYPE:
        from .native_backed import SBRT
        ctx["sbrt"] = SBRT_MODE_MTF
        return SBRT(ctx)
    if ttype == BWT_TYPE:
        from .native_backed import BWTBlockCodec
        return BWTBlockCodec(ctx)
    if ttype == BWTS_TYPE:
        from .native_backed import BWTS
        return BWTS(ctx)
    if ttype == DICT_TYPE:
        from .content_aware import TextCodec
        entropy_name = str(ctx.get("entropy", "")).upper()
        ctx["textcodec"] = 2 if entropy_name in ("NONE", "ANS0", "HUFFMAN", "RANGE") else 1
        return TextCodec(ctx)
    if ttype == UTF_TYPE:
        from .content_aware import UTFCodec
        return UTFCodec(ctx)
    if ttype == PACK_TYPE:
        from .alias import AliasCodec
        return AliasCodec(ctx)
    if ttype == DNA_TYPE:
        from .alias import AliasCodec
        ctx["packOnlyDNA"] = True
        return AliasCodec(ctx)
    if ttype == MM_TYPE:
        from .content_aware import FSDCodec
        return FSDCodec(ctx)
    if ttype == EXE_TYPE:
        from .content_aware import EXECodec
        return EXECodec(ctx)
    if ttype in (ROLZ_TYPE, ROLZX_TYPE):
        from .content_aware import ROLZCodec
        return ROLZCodec(ctx, extra=(ttype == ROLZX_TYPE))
    raise ValueError(f"Unknown transform type: '{ttype}'")


class Sequence:
    """Chain of up to 8 transforms with skip-flag tracking
    (reference: v2/transform/Sequence.go:29-222)."""

    def __init__(self, transforms: list[Transform]):
        if not 1 <= len(transforms) <= 8:
            raise ValueError("Only 1 to 8 transforms allowed")
        self.transforms = transforms
        self.skip_flags = 0

    def __len__(self):
        return len(self.transforms)

    def forward(self, src) -> tuple[np.ndarray, int]:
        """Run the chain; returns (output, skip_flags). A transform that
        raises TransformSkip (or errors) is recorded as skipped and its input
        passes through."""
        self.skip_flags = 0xFF
        buf = as_u8(src)
        if len(buf) == 0:
            return buf, self.skip_flags
        # the reference sizes every ping-pong buffer to the chain-composed
        # max (Sequence.go:75-97); transforms see that capacity, not their
        # own MaxEncodedLen
        required = self.max_encoded_len(len(buf))
        for i, t in enumerate(self.transforms):
            t.seq_required = required
            try:
                nxt = t.forward(buf)
            except TransformSkip:
                continue
            buf = as_u8(nxt)
            self.skip_flags &= ~(1 << (7 - i)) & 0xFF
        return buf, self.skip_flags

    def inverse(self, src) -> np.ndarray:
        buf = as_u8(src)
        if len(buf) == 0:
            return buf
        if self.skip_flags == 0xFF:
            return buf
        for i in range(len(self.transforms) - 1, -1, -1):
            if self.skip_flags & (1 << (7 - i)):
                continue
            buf = as_u8(self.transforms[i].inverse(buf))
        return buf

    def set_skip_flags(self, flags: int) -> None:
        self.skip_flags = flags & 0xFF

    def max_encoded_len(self, src_len: int) -> int:
        required = src_len
        for t in self.transforms:
            required = max(required, t.max_encoded_len(required))
        return required


def new_sequence(ctx: dict, ttype: int) -> Sequence:
    """Build the transform sequence for a 48-bit chain value
    (reference: v2/transform/Factory.go:58-95)."""
    nbtr = 0
    for s in range(_MAX_SHIFT, -1, -_ONE_SHIFT):
        if (ttype >> s) & _MASK != NONE_TYPE:
            nbtr += 1
    nbtr = max(nbtr, 1)
    # the first nbtr slots hold the chain (get_type packs contiguously)
    ids = [(ttype >> (_MAX_SHIFT - _ONE_SHIFT * i)) & _MASK for i in range(nbtr)]
    return Sequence([_new_transform(ctx, t) for t in ids])
