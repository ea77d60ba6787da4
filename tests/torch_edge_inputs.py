"""Seeded numpy inputs for the rANS encode, the Huffman lane pack and
decode and the range encode and decode that the kernels' designs are
sensitive to. The CPU tests hold the port's plain versions against
kanzi_tpu on them; tests/test_torch_gpu.py holds the kernels against the
plain versions on the same inputs. Imports numpy only.
"""

import numpy as np


def _enc_tables(rng, B, S, emit_all=False):
    """(B, 5, S) int32 planes xMax, bias, cmplFreq, invShift, invFreq of
    random u32 bits; invShift in [32, 64) as the host's (the JAX version
    shifts by invShift - 32 unmasked). xMax 0: every step emits."""
    t = rng.integers(0, 1 << 32, (B, 5, S), dtype=np.uint64)
    t[:, 3] = rng.integers(32, 64, (B, S))
    if emit_all:
        t[:, 0] = 0
    return t.astype(np.uint32).view(np.int32)


def _enc_syms(rng, B, G, order):
    if order == 0:
        return rng.integers(0, 256, (B, G, 4), dtype=np.uint8)
    return rng.integers(0, 1 << 16, (B, G, 4), dtype=np.uint64).astype(np.uint16)


def encode_cases() -> dict:
    """name -> (syms (B, G, 4) uint8 or uint16, ngroups (B,) int32, tables
    (B, 5, S) int32). Symbols past a row's ngroups are not zero."""
    cases = {}
    rng = np.random.default_rng(0xA5)
    # every step emits (npairs = 4G): the whole row is one in-place move
    for order, B, G, S in ((0, 3, 200, 256), (1, 1, 600, 65536)):
        ng = np.array([G, G, 57][:B], np.int32)
        cases[f"emit_all_o{order}"] = (_enc_syms(rng, B, G, order), ng,
                                       _enc_tables(rng, B, S, emit_all=True))
    # ngroups 0, 1, partial, full, negative and past G (clamped)
    B, G = 6, 128
    cases["ngroups_edges"] = (_enc_syms(rng, B, G, 0),
                              np.array([0, 1, 77, G, -3, G + 5], np.int32),
                              _enc_tables(rng, B, 256))
    # rows of different ngroups in one batch, B not a multiple of 8 (the
    # order-0 rows of a CTA), several tiles of groups
    B, G = 11, 300
    cases["mixed_ngroups"] = (_enc_syms(rng, B, G, 0),
                              rng.integers(0, G + 1, B).astype(np.int32),
                              _enc_tables(rng, B, 256))
    # order-1 u16 indices over the whole of S = 65536, more than one tile
    B, G = 2, 1100
    cases["order1_u16"] = (_enc_syms(rng, B, G, 1), np.array([G, 700], np.int32),
                           _enc_tables(rng, B, 65536))
    return cases


def _dec_tables(rng, C, any_entries=False):
    """(C, 4096) uint16 code -> (symbol << 8) | length; lengths 1..12 as
    the host's, or any u16 (lengths 0..255)."""
    if any_entries:
        return rng.integers(0, 1 << 16, (C, 4096)).astype(np.uint16)
    sym = rng.integers(0, 256, (C, 4096))
    return ((sym << 8) | rng.integers(1, 13, (C, 4096))).astype(np.uint16)


def decode_cases() -> dict:
    """name -> (lanes (L, S) uint8, table_idx (L,) int32, dtables (C, 4096)
    uint16)."""
    cases = {}
    rng = np.random.default_rng(0x5A)
    # four consecutive lanes share a table (the Reader's layout), in no
    # chunk order; L = 20: the last CTA of 8 lanes holds 4
    idx = np.repeat(np.array([0, 2, 1, 3, 4], np.int32), 4)
    cases["shared_quads"] = (rng.integers(0, 256, (20, 6160), dtype=np.uint8),
                             idx, _dec_tables(rng, 5))
    # lanes that use the tables in no particular order
    cases["shuffled_tables"] = (rng.integers(0, 256, (13, 6160), dtype=np.uint8),
                                rng.integers(0, 6, 13).astype(np.int32),
                                _dec_tables(rng, 6))
    # rows far shorter than a lane's bits: the bit position runs past the
    # stride; an odd stride puts the rows off 4-byte alignment
    cases["past_stride"] = (rng.integers(0, 256, (9, 37), dtype=np.uint8),
                            rng.integers(0, 2, 9).astype(np.int32),
                            _dec_tables(rng, 2))
    # any u16 entry: lengths 0 (no advance) to 255 (several words a step)
    cases["any_entries"] = (rng.integers(0, 256, (10, 101), dtype=np.uint8),
                            rng.integers(0, 3, 10).astype(np.int32),
                            _dec_tables(rng, 3, any_entries=True))
    return cases


def _norm_tables(rng, B, shift, single=False):
    """(B, 2, 256) int32 planes cumFreq, freq normalized to 2^shift, as the
    host's: every symbol at least 1; `single`: symbol 0 takes it all."""
    total = 1 << shift
    freq = np.zeros((B, 256), np.int64)
    if single:
        freq[:, 0] = total
    else:
        w = rng.random((B, 256)) ** 3
        freq = 1 + np.floor(w / w.sum(1, keepdims=True) * (total - 256)).astype(np.int64)
        freq[:, 0] += total - freq.sum(1)
    cum = np.cumsum(freq, 1) - freq
    return np.stack([cum, freq], 1).astype(np.int32)


def _u32_tables(rng, B, hi):
    """(B, 2, 256) int32 holding u32 planes: cumFreq in [2^24, 2^31) or, with
    `hi`, at or above 2^31; freq the same for a tenth of the symbols and
    in [1, 16) for the rest, so that the range shrinks and the state
    renormalizes."""
    lo_b, hi_b = ((1 << 31), (1 << 32)) if hi else ((1 << 24), (1 << 31))
    t = rng.integers(lo_b, hi_b, (B, 2, 256), dtype=np.uint64)
    small = rng.random((B, 256)) < 0.9
    t[:, 1][small] = rng.integers(1, 16, int(small.sum()), dtype=np.uint64)
    return t.astype(np.uint32).view(np.int32)


def range_encode_cases() -> dict:
    """name -> (syms (B, N) uint8, nvalid (B,) int32, tables (B, 2, 256)
    int32 u32 planes, shifts (B,) int32). Bytes past a row's nvalid are not
    zero. A shift of 64 or more makes range >> shift 0, so that every byte
    emits twice; kanzi_tpu reads a negative shift as a u32 above 63, the
    port clamps it to 0 (the tests compare kanzi_tpu at 0 there)."""
    cases = {}
    rng = np.random.default_rng(0x7E)
    # nvalid 0, 1, N, negative, past N, partial; N spans three 1 KiB tiles
    B, N = 6, 2100
    cases["nvalid_edges"] = (rng.integers(0, 256, (B, N), dtype=np.uint8),
                             np.array([0, 1, N, -3, N + 5, 1500], np.int32),
                             _norm_tables(rng, B, 12), np.full(B, 12, np.int32))
    # rows of different lengths in one batch, B odd
    B, N = 11, 1300
    cases["mixed_nvalid"] = (rng.integers(0, 256, (B, N), dtype=np.uint8),
                             rng.integers(0, N + 1, B).astype(np.int32),
                             _norm_tables(rng, B, 12), np.full(B, 12, np.int32))
    # logRange 8, 11, 12, and shifts outside [0, 63]
    sh = np.array([8, 11, 12, 64, 100, (1 << 31) - 1, -1], np.int32)
    tabs = np.concatenate([_norm_tables(rng, 1, int(s) if 0 <= s <= 12 else 12)
                           for s in sh])
    cases["shifts"] = (rng.integers(0, 256, (len(sh), 900), dtype=np.uint8),
                       np.full(len(sh), 900, np.int32), tabs, sh)
    # freq 1 (and 0) at logRange 12: the range collapses, a byte emits twice
    B, N = 2, 700
    t = np.zeros((B, 2, 256), np.int32)
    t[:, 0] = rng.integers(0, 1 << 12, (B, 256))
    t[0, 1] = 1
    t[1, 1] = rng.integers(0, 2, 256)
    cases["two_emissions"] = (rng.integers(0, 256, (B, N), dtype=np.uint8),
                              np.full(B, N, np.int32), t, np.full(B, 12, np.int32))
    # a single-symbol table over a run of that symbol
    cases["single_symbol"] = (np.zeros((2, 1100), np.uint8),
                              np.array([1100, 600], np.int32),
                              _norm_tables(rng, 2, 12, single=True),
                              np.full(2, 12, np.int32))
    # random u32 tables, bit 31 set in every third entry; freq of any
    # magnitude (u32 bits shifted down by 0 to 32), so that the range
    # shrinks at some bytes and the state renormalizes
    B, N = 3, 1200
    t = rng.integers(0, 1 << 32, (B, 2, 256), dtype=np.uint64)
    t[:, :, ::3] |= 1 << 31
    t[:, 1] >>= rng.integers(0, 33, (B, 256)).astype(np.uint64)
    cases["random_u32"] = (rng.integers(0, 256, (B, N), dtype=np.uint8),
                           np.array([N, 800, 1], np.int32),
                           t.astype(np.uint32).view(np.int32), np.full(B, 12, np.int32))
    return cases


def range_u32_cases() -> dict:
    """name -> (encode (syms, nvalid, tables, shifts), decode (bufs (B, S)
    uint8 with zero guard bytes, tables, f2s (B, 4096) uint8, shifts, nvalid,
    glen)): the table planes as u32 in [2^24, 2^31) ("2^24") and at or
    above 2^31 ("2^31")."""
    cases = {}
    for name, hi in (("2^24", False), ("2^31", True)):
        rng = np.random.default_rng(24 + 7 * hi)
        B, N = 3, 1100
        enc = (rng.integers(0, 256, (B, N), dtype=np.uint8),
               np.array([N, 700, 1], np.int32), _u32_tables(rng, B, hi),
               np.array([12, 11, 8], np.int32))
        glen = 300
        S = (60 + 28 * 2 * glen) // 8 + 16
        bufs = rng.integers(0, 256, (B, S), dtype=np.uint8)
        bufs[:, -8:] = 0
        dec = (bufs, _u32_tables(rng, B, hi),
               rng.integers(0, 256, (B, 4096), dtype=np.uint8),
               np.array([12, 11, 12], np.int32),
               np.array([glen, 200, 0], np.int32), glen)
        cases[name] = (enc, dec)
    return cases


def _pack_tables(rng, C, lengths=(1, 13), wide=False):
    """(C, 256) int32 (len << 12) | code entries: lengths drawn from
    [lengths[0], lengths[1]); codes that fit their lengths, or with `wide`
    any 12-bit code (wider than its length: neighbours overlap)."""
    ln = rng.integers(lengths[0], lengths[1], (C, 256))
    code = rng.integers(0, 1 << 12, (C, 256))
    if not wide:
        code &= (1 << np.minimum(ln, 12)) - 1
    return ((ln << 12) | code).astype(np.int32)


def pack_cases() -> dict:
    """name -> (syms (L, frag) uint8 or int32, lane_len (L,) int32,
    table_idx (L,) int32, tables (C, 256) int32). The "negative_entry"
    case has a negative entry for a valid symbol of lane 2 only: the CPU
    raises ValueError on it, the kernel gives that lane nbits -1."""
    cases = {}
    rng = np.random.default_rng(0x3C)

    def syms(L, frag, dtype=np.uint8, hi=256):
        return rng.integers(0, hi, (L, frag)).astype(dtype)

    # frag 4096 (full lanes, 16-byte loads), 512 (int32 rows), 37 (rows at
    # offsets that are not 16-byte aligned: one symbol a load)
    for frag, dtype in ((4096, np.uint8), (512, np.int32), (37, np.uint8), (37, np.int32)):
        L = 9
        cases[f"frag{frag}_{np.dtype(dtype).name}"] = (
            syms(L, frag, dtype), rng.integers(0, frag + 1, L).astype(np.int32),
            rng.integers(0, 3, L).astype(np.int32), _pack_tables(rng, 3))
    # lane_len 0, 1, full, and negative or past frag (clamped)
    cases["lane_len_edges"] = (syms(6, 4096), np.array([0, 1, 4096, 4095, -5, 5000], np.int32),
                               np.array([0, 1, 0, 1, 0, 1], np.int32), _pack_tables(rng, 2))
    # int32 symbols above 255 and negative: read as their low byte
    s = syms(4, 512, np.int32, hi=1 << 31)
    s[1] = -rng.integers(1, 1 << 31, 512)
    cases["syms_above_255"] = (s, np.full(4, 512, np.int32),
                               np.array([0, 1, 1, 0], np.int32), _pack_tables(rng, 2))
    # codes wider than their lengths, lengths 0 to 12
    cases["wide_codes"] = (syms(5, 4096), np.full(5, 4096, np.int32),
                           rng.integers(0, 2, 5).astype(np.int32),
                           _pack_tables(rng, 2, (0, 13), wide=True))
    # lengths 0 and 13 to 40 (words past nwords are dropped)
    t = _pack_tables(rng, 2, (13, 41), wide=True)
    t[rng.random(t.shape) < 0.2] &= 0xFFF
    cases["long_lengths"] = (syms(4, 4096), np.array([4096, 4096, 2000, 700], np.int32),
                             np.array([0, 1, 0, 1], np.int32), t)
    # 12-bit codes of 12 bits: every word of the lane is full
    cases["full_12bit"] = (syms(4, 4096), np.full(4, 4096, np.int32),
                           np.array([0, 1, 1, 0], np.int32),
                           ((12 << 12) | rng.integers(0, 1 << 12, (2, 256))).astype(np.int32))
    # a negative entry for a valid symbol of lane 2 (table 1, symbol 7)
    s, t = syms(4, 4096), _pack_tables(rng, 2)
    t[1, 7] = -(5 << 12) - 3
    s[2, 100] = 7
    s[[0, 1, 3]] = np.where(s[[0, 1, 3]] == 7, 8, s[[0, 1, 3]])
    cases["negative_entry"] = (s, np.full(4, 4096, np.int32),
                               np.array([0, 0, 1, 1], np.int32), t)
    return cases


def ans_u32_cases() -> dict:
    """name -> (decode rows {bufs, nbytes, states0, f2s, dtabs, ngroups,
    lr}, order): table planes of u32 values, freq in [2^17, 2^24)
    ("freq_2^17"), [2^24, 2^31) ("freq_2^24") and at or above 2^31
    ("freq_2^31"), cumFreq at or above 2^31 ("cum_2^31"), and rows whose
    freqs are all below 2^16 but one of the second row's, 2^24 + 5
    ("mixed"), in both orders, at logRange 12. Each row's stream holds
    every byte the row can read; the third row has no groups."""
    cases = {}
    planes = {"freq_2^17": ((1 << 17, 1 << 24), (0, 1 << 16)),
              "freq_2^24": ((1 << 24, 1 << 31), (0, 1 << 16)),
              "freq_2^31": ((1 << 31, 1 << 32), (0, 1 << 16)),
              "cum_2^31": ((1, 1 << 12), (1 << 31, 1 << 32)),
              "mixed": ((1, 1 << 16), (0, 1 << 16))}
    for order in (0, 1):
        for i, (name, (freq, cum)) in enumerate(planes.items()):
            rng = np.random.default_rng(170 + 10 * order + i)
            B, G, lr = 3, 64, 12
            T = 65536 if order else 256
            S = 8 * G + 16
            dtabs = np.stack([rng.integers(*freq, (B, T), dtype=np.uint64),
                              rng.integers(*cum, (B, T), dtype=np.uint64)], axis=1)
            if name == "mixed":
                dtabs[1, 0, 7] = (1 << 24) + 5
            cases[f"{name}_o{order}"] = ({
                "bufs": rng.integers(0, 256, (B, S), dtype=np.uint8),
                "nbytes": np.full(B, S, np.int32),
                "states0": rng.integers(1 << 15, 1 << 32, (B, 4),
                                        dtype=np.uint64).astype(np.uint32),
                "f2s": rng.integers(0, 256, (B, (256 if order else 1) << lr),
                                    dtype=np.uint8),
                "dtabs": dtabs.astype(np.uint32),
                "ngroups": np.array([G, 40, 0], np.int32),
                "lr": np.full(B, lr, np.int32)}, order)
    return cases
