"""Seeded numpy inputs for the rANS encode and Huffman lane decode that the
kernels' designs are sensitive to. The CPU tests hold the port's plain
versions against kanzi_tpu on them; tests/test_torch_gpu.py holds the
kernels against the plain versions on the same inputs. Imports numpy only.
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
