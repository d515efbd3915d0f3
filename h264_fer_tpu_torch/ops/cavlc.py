"""CAVLC residual block coding (norm 9.2; reference residual.cpp), host side.

A copy of h264_fer_tpu/ops/cavlc.py. The decoding half: nC to table
context, the prefix-decode tables built from the coding tables of
ops/cavlc_tables.py, level_prefix / level_suffix, and one 4x4 (or 2x2
chroma DC) block; the semantic reference of the native slice decoder's
CAVLC (native/decoder_native.cpp) and the entropy stage of the decoder's
Python form. The writing half: one block's (value, nbits) symbols, which
the host per-MB encoder (codec/encoder_host.py) writes and sizes. The
device encoders write theirs in bulk (ops/cavlc_bulk.py).
"""

from __future__ import annotations

from ..bitstream.bitio import BitReader, BitWriter
from .cavlc_tables import (
    COEFF_TOKEN_BITS,
    COEFF_TOKEN_LEN,
    RUN_BEFORE_BITS,
    RUN_BEFORE_LEN,
    TOTAL_ZEROS_BITS,
    TOTAL_ZEROS_CDC_BITS,
    TOTAL_ZEROS_CDC_LEN,
    TOTAL_ZEROS_LEN,
)


def nc_context(nc: int) -> int:
    """Map nC to coeff_token table context (norm Table 9-5 columns)."""
    if nc == -1:
        return 4
    if nc < 2:
        return 0
    if nc < 4:
        return 1
    if nc < 8:
        return 2
    return 3


# ---------------------------------------------------------------------------
# Decode-side prefix lookups, built once from the coding tables.

_decode_tables: dict = {}


def _build_decode_table(len_arr, bits_arr, payload):
    """(length, code) → payload dict plus max code length."""
    table = {}
    maxlen = 0
    for i in range(len_arr.shape[0]):
        for j in range(len_arr.shape[1]):
            n = int(len_arr[i, j])
            if n <= 0:
                continue
            table[(n, int(bits_arr[i, j]))] = payload(i, j)
            maxlen = max(maxlen, n)
    return table, maxlen


def _get_decode_table(kind: str, idx: int):
    """The (length, code) → payload table of coeff_token ("ct", context
    idx), total_zeros ("tz" / chroma DC "tzc", TotalCoeff idx + 1) or
    run_before ("rb", zerosLeft idx + 1)."""
    key = (kind, idx)
    t = _decode_tables.get(key)
    if t is None:
        if kind == "ct":
            t = _build_decode_table(
                COEFF_TOKEN_LEN[idx], COEFF_TOKEN_BITS[idx], lambda tc, t1: (tc, t1))
        elif kind == "tz":
            t = _build_decode_table(TOTAL_ZEROS_LEN[idx: idx + 1].T,
                                    TOTAL_ZEROS_BITS[idx: idx + 1].T, lambda tz, _: tz)
        elif kind == "tzc":
            t = _build_decode_table(TOTAL_ZEROS_CDC_LEN[idx: idx + 1].T,
                                    TOTAL_ZEROS_CDC_BITS[idx: idx + 1].T, lambda tz, _: tz)
        elif kind == "rb":
            t = _build_decode_table(RUN_BEFORE_LEN[idx: idx + 1].T,
                                    RUN_BEFORE_BITS[idx: idx + 1].T, lambda rb, _: rb)
        else:
            raise KeyError(kind)
        _decode_tables[key] = t
    return t


# Dense direct-indexed decode tables: one maxlen-bit peek indexes a flat
# list (the reference peeks 24 bits and binary-searches,
# residual_tables.cpp:1012-1030; a dense LUT beats the search in Python).
# Entry = (payload, code length); unused slots keep length 0 and raise.

_dense_tables: dict = {}


def _get_dense_table(kind: str, idx: int):
    key = (kind, idx)
    t = _dense_tables.get(key)
    if t is None:
        table, maxlen = _get_decode_table(kind, idx)
        size = 1 << maxlen
        vals = [None] * size
        lens = [0] * size
        # VLC codes are prefix-free, so each slot belongs to one codeword
        for (n, code), payload in table.items():
            base = code << (maxlen - n)
            for s in range(base, base + (1 << (maxlen - n))):
                vals[s] = payload
                lens[s] = n
        t = (vals, lens, maxlen)
        _dense_tables[key] = t
    return t


def _decode_vlc_dense(r: BitReader, kind: str, idx: int):
    vals, lens, maxlen = _get_dense_table(kind, idx)
    v = r.peek(maxlen)
    n = lens[v]
    if n == 0:
        raise ValueError("invalid VLC codeword")
    r.skip(n)
    return vals[v]


# ---------------------------------------------------------------------------
# Level prefix/suffix (norm 9.2.2.1).


def decode_level_code(r: BitReader, suffix_len: int) -> int:
    """Read level_prefix + level_suffix, return levelCode
    (reference residual.cpp:1264-1300). The prefix's leading zeros come
    from one 24-bit peek, with a bit loop for out-of-norm prefixes."""
    v = r.peek(24)
    if v:
        prefix = 24 - v.bit_length()
        r.skip(prefix + 1)
    else:
        r.skip(24)
        prefix = 24
        while r.read_bit() == 0:
            prefix += 1
    if prefix == 14 and suffix_len == 0:
        size = 4
    elif prefix >= 15:
        size = prefix - 3
    else:
        size = suffix_len
    suffix = r.read(size) if (size > 0 or prefix >= 14) else 0
    level_code = (min(prefix, 15) << suffix_len) + suffix
    if prefix >= 15 and suffix_len == 0:
        level_code += 15
    return level_code


# ---------------------------------------------------------------------------
# Block decode.


def decode_residual_block(r: BitReader, nc: int, start_idx: int, end_idx: int,
                          max_num_coeff: int):
    """Decode one CAVLC residual block (reference residual_block_cavlc,
    residual.cpp:1069-1386, after the nC derivation).

    Returns (coeff_level list of max_num_coeff ints, total_coeff).
    """
    coeff = [0] * max_num_coeff
    total_coeff, trailing_ones = _decode_vlc_dense(r, "ct", nc_context(nc))
    if total_coeff == 0:
        return coeff, 0

    suffix_len = 1 if (total_coeff > 10 and trailing_ones < 3) else 0
    level = [0] * total_coeff
    for i in range(total_coeff):
        if i < trailing_ones:
            level[i] = 1 - 2 * r.read_bit()
        else:
            level_code = decode_level_code(r, suffix_len)
            if i == trailing_ones and trailing_ones < 3:
                level_code += 2
            if level_code & 1:
                level[i] = (-level_code - 1) >> 1
            else:
                level[i] = (level_code + 2) >> 1
            if suffix_len == 0:
                suffix_len = 1
            if abs(level[i]) > (3 << (suffix_len - 1)) and suffix_len < 6:
                suffix_len += 1

    if total_coeff < end_idx - start_idx + 1:
        zeros_left = _decode_vlc_dense(r, "tz" if nc != -1 else "tzc", total_coeff - 1)
    else:
        zeros_left = 0

    run = [0] * total_coeff
    for j in range(total_coeff - 1):
        if zeros_left > 0:
            if zeros_left > 6:
                rb = 7 - r.read(3)
                if rb == 7:
                    while r.read_bit() == 0:
                        rb += 1
            else:
                rb = _decode_vlc_dense(r, "rb", zeros_left - 1)
            run[j] = rb
        zeros_left -= run[j]
    run[total_coeff - 1] = zeros_left

    coeff_num = -1
    for i in range(total_coeff - 1, -1, -1):
        coeff_num += run[i] + 1
        coeff[start_idx + coeff_num] = level[i]
    return coeff, total_coeff


# ---------------------------------------------------------------------------
# Block encode.


def encode_level_code(level_code: int, suffix_len: int):
    """(prefix, suffix_size, suffix) for a level code at adaptive suffix_len.

    Closed form of the reference's levelcode_to_outputstream generation
    (residual_tables.cpp:940-1006): the decomposition is unique, prefix
    capped at 15 with a 12-bit escape suffix.
    """
    if suffix_len == 0:
        if level_code < 14:
            return level_code, 0, 0
        if level_code < 30:
            return 14, 4, level_code - 14
        return 15, 12, level_code - 30
    prefix = level_code >> suffix_len
    if prefix < 15:
        return prefix, suffix_len, level_code & ((1 << suffix_len) - 1)
    return 15, 12, level_code - (15 << suffix_len)


def _level_to_code(level: int, first_non_t1: bool) -> int:
    """levelCode from a signed level (inverse of residual.cpp:1302-1312)."""
    code = 2 * level - 2 if level > 0 else -2 * level - 1
    if first_non_t1:
        code -= 2
    return code


def block_symbols(levels, nc: int, max_num_coeff: int):
    """(value, nbits) symbol list for one block (reference
    residual_block_cavlc_write, residual.cpp:374-666). `levels` is the
    zig-zag-ordered coefficient list (length max_num_coeff).

    Returns (symbols, total_coeff).
    """
    nonzero_pos = [i for i in range(max_num_coeff) if levels[i] != 0]
    total_coeff = len(nonzero_pos)
    # trailing ones: up to 3 final +-1 coefficients
    trailing_ones = 0
    for i in range(total_coeff - 1, -1, -1):
        if abs(levels[nonzero_pos[i]]) == 1 and trailing_ones < 3:
            trailing_ones += 1
        else:
            break
    ctx = nc_context(nc)
    n = int(COEFF_TOKEN_LEN[ctx, total_coeff, trailing_ones])
    assert n > 0, (nc, total_coeff, trailing_ones)
    syms = [(int(COEFF_TOKEN_BITS[ctx, total_coeff, trailing_ones]), n)]
    if total_coeff == 0:
        return syms, 0

    # trailing one signs, then levels high-frequency-first
    rev = nonzero_pos[::-1]
    for i in range(trailing_ones):
        syms.append((1 if levels[rev[i]] < 0 else 0, 1))
    suffix_len = 1 if (total_coeff > 10 and trailing_ones < 3) else 0
    for i in range(trailing_ones, total_coeff):
        lv = int(levels[rev[i]])
        code = _level_to_code(lv, i == trailing_ones and trailing_ones < 3)
        prefix, ssize, suffix = encode_level_code(code, suffix_len)
        syms.append((1, prefix + 1))  # prefix zeros then the stop bit
        if ssize > 0:
            syms.append((suffix, ssize))
        if suffix_len == 0:
            suffix_len = 1
        if abs(lv) > (3 << (suffix_len - 1)) and suffix_len < 6:
            suffix_len += 1

    total_zeros = nonzero_pos[-1] + 1 - total_coeff
    if total_coeff < max_num_coeff:
        if nc != -1:
            syms.append((int(TOTAL_ZEROS_BITS[total_coeff - 1, total_zeros]),
                         int(TOTAL_ZEROS_LEN[total_coeff - 1, total_zeros])))
        else:
            syms.append((int(TOTAL_ZEROS_CDC_BITS[total_coeff - 1, total_zeros]),
                         int(TOTAL_ZEROS_CDC_LEN[total_coeff - 1, total_zeros])))

    zeros_left = total_zeros
    for i in range(total_coeff - 1, 0, -1):
        if zeros_left <= 0:
            break
        run_before = nonzero_pos[i] - nonzero_pos[i - 1] - 1
        if zeros_left > 6:
            # escape coding (reference residual.cpp:73-84)
            if run_before < 7:
                syms.append((7 - run_before, 3))
            else:
                syms.append((1, run_before - 4 + 1))  # zeros then the stop bit
        else:
            syms.append((int(RUN_BEFORE_BITS[zeros_left - 1, run_before]),
                         int(RUN_BEFORE_LEN[zeros_left - 1, run_before])))
        zeros_left -= run_before
    return syms, total_coeff


def write_residual_block(w: BitWriter, levels, nc: int, max_num_coeff: int) -> int:
    """Write one block; returns its TotalCoeff."""
    syms, total_coeff = block_symbols(levels, nc, max_num_coeff)
    for v, n in syms:
        w.write(v, n)
    return total_coeff


def size_residual_block(levels, nc: int, max_num_coeff: int) -> int:
    """Exact bit cost (reference residual_block_cavlc_size,
    residual.cpp:673-957)."""
    syms, _ = block_symbols(levels, nc, max_num_coeff)
    return sum(n for _, n in syms)
