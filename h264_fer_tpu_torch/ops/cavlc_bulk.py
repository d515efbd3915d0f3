"""Batched CAVLC symbols and bit packing for every block of a frame (torch).

The counterpart of h264_fer_tpu/ops/cavlc_jax.py (norm 9.2; reference
residual_block_cavlc_write, residual.cpp:374-957): every block's symbols
are computed at once; the only sequential structure is the norm's own
per-coefficient adaptive state (suffixLength), unrolled over the static
coefficient depth. Only the coeff_token depends on nC, so it is chosen per
block afterwards (finalize_symbols).

Symbol stream layout per block (fixed slots; empty slots have length 0):
  slot 0        coeff_token        (filled by finalize_symbols)
  slot 1        trailing-one signs (t1 bits)
  slots 2..L+1  level codes        (prefix+stop+suffix fused, <= 28 bits)
  slot L+2      total_zeros
  slots L+3..   run_before         (L-1 slots)

pack_symbols places the stream into 64-bit words with an exclusive cumsum
of the lengths and index_add_ of each symbol's one or two word parts: the
parts occupy disjoint bits, so the integer add equals an or, and is exact
under atomics in any order.
"""

from __future__ import annotations

import numpy as np
import torch

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
from .device import const

I32 = torch.int32
MAX_SYMBOL_BITS = 28  # longest fused symbol (a level code)

# coeff_token tables as (68, 5): row tc*4 + t1, column nC context
_CT_LEN = np.moveaxis(COEFF_TOKEN_LEN, 0, -1).reshape(-1, 5)
_CT_BITS = np.moveaxis(COEFF_TOKEN_BITS, 0, -1).reshape(-1, 5)


def nc_to_ctx(nc):
    """nC → coeff_token table context (Table 9-5 columns); nc >= 0."""
    return ((nc >= 2).to(I32) + (nc >= 4).to(I32) + (nc >= 8).to(I32))


def ue_bits(v):
    """Bit length of ue(v): 2*floor(log2(v+1)) + 1."""
    vv = v.to(torch.int64) + 1
    nb = torch.zeros(v.shape, dtype=I32, device=v.device)
    for k in range(1, 32):
        nb = nb + (vv >= (1 << k)).to(I32)
    return 2 * nb + 1


def ue_code(v):
    """(value, length) of ue(v) as one fused symbol: value v + 1 in
    `length` bits (the leading zeros are implicit)."""
    return v + 1, ue_bits(v)


def se_code(v):
    return ue_code(torch.where(v > 0, 2 * v - 1, -2 * v))


def block_symbols_bulk(levels, max_num_coeff: int, sizes_only: bool = False):
    """Per-block CAVLC symbols for a batch of blocks.

    levels: (..., L) int32 zig-zag lists. max_num_coeff: 16/15/4, 4 selecting
    the chroma DC total_zeros table; or a tensor of 15s and 16s that
    broadcasts over the blocks (lists of 15 zero-padded to L = 16). Returns dict: tc, t1, rest_bits (all
    bits but coeff_token), ct_len / ct_val (..., 5) per nC context, and the
    symbol stream vals / lens (..., 2L+3) with slot 0 zero. With
    sizes_only, only tc, t1, rest_bits and ct_len (what a bit-size
    comparison needs, as the JAX function's sizes_only).
    """
    L = levels.shape[-1]
    dev = levels.device
    lead = levels.shape[:-1]
    pos = torch.arange(L, dtype=I32, device=dev)
    nz = levels != 0
    nzi = nz.to(I32)
    tc = nzi.sum(dim=-1, dtype=I32)

    # nonzero values/positions in reverse scan order: the rank of nonzero i
    # from the top is the number of nonzeros at positions > i
    rank = tc[..., None] - torch.cumsum(nzi, dim=-1, dtype=I32)
    onehot = ((rank[..., None] == pos) & nz[..., None]).to(I32)  # (..., L, Lrev)
    rev_vals = (levels[..., None] * onehot).sum(dim=-2, dtype=I32)
    rev_pos = (pos[:, None] * onehot).sum(dim=-2, dtype=I32)
    valid = pos < tc[..., None]

    # trailing ones: run of |level| == 1 from the top, capped at 3
    ones = ((rev_vals.abs() == 1) & valid)[..., :3].to(I32)
    t1 = torch.cumprod(ones, dim=-1).sum(dim=-1, dtype=I32)

    ct_len = const(_CT_LEN, dev)[(tc * 4 + t1).long()]  # (..., 5)
    bits = t1.clone()
    if not sizes_only:
        zero = torch.zeros(lead, dtype=I32, device=dev)
        vcols = [zero]  # slot 0: coeff_token (finalize_symbols)
        lcols = [zero, t1]
        # trailing one signs, fused into one symbol of t1 bits
        sign = (rev_vals < 0).to(I32)
        t1_val = zero
        for k in range(3):
            shift = (t1 - 1 - k).clamp(min=0)
            t1_val = t1_val + torch.where(k < t1, sign[..., k] << shift, 0)
        vcols.append(t1_val)

    # level codes (adaptive suffixLength, unrolled over L)
    suffix_len = torch.where((tc > 10) & (t1 < 3), 1, 0).to(I32)
    for i in range(L):
        active = (i >= t1) & (i < tc)
        lv = rev_vals[..., i]
        code = torch.where(lv > 0, 2 * lv - 2, -2 * lv - 1)
        code = code - 2 * ((t1 == i) & (t1 < 3)).to(I32)
        sl = suffix_len
        # suffix_len == 0
        p0 = torch.where(code < 14, code, torch.where(code < 30, 14, 15))
        s0 = torch.where(code < 14, 0, torch.where(code < 30, 4, 12))
        # suffix_len > 0
        pr = code >> sl
        px = pr.clamp(max=15)
        sx = torch.where(pr < 15, sl, 12)
        prefix = torch.where(sl == 0, p0, px)
        ssize = torch.where(sl == 0, s0, sx)
        length = torch.where(active, prefix + 1 + ssize, 0).to(I32)
        bits = bits + length
        if not sizes_only:
            u0 = torch.where(code < 14, 0,
                             torch.where(code < 30, code - 14, code - 30))
            ux = torch.where(pr < 15, code & ((1 << sl) - 1), code - (15 << sl))
            suffix = torch.where(sl == 0, u0, ux)
            vcols.append(torch.where(active, (1 << ssize) | suffix, 0).to(I32))
            lcols.append(length)
        sl1 = sl.clamp(min=1)
        grow = (lv.abs() > (3 << (sl1 - 1))) & (sl1 < 6)
        suffix_len = torch.where(active, sl1 + grow.to(I32), suffix_len)

    # total_zeros
    total_zeros = torch.where(tc > 0, rev_pos[..., 0] + 1 - tc, 0)
    if isinstance(max_num_coeff, int) and max_num_coeff == 4:
        tzl, tzb = TOTAL_ZEROS_CDC_LEN, TOTAL_ZEROS_CDC_BITS
    else:
        tzl, tzb = TOTAL_ZEROS_LEN, TOTAL_ZEROS_BITS
    tz_active = (tc > 0) & (tc < max_num_coeff)
    tz_flat = ((tc - 1).clamp(0, tzl.shape[0] - 1) * tzl.shape[1]
               + total_zeros.clamp(0, tzl.shape[1] - 1)).long()
    tz_len = torch.where(tz_active, const(tzl.reshape(-1), dev)[tz_flat], 0)
    bits = bits + tz_len

    # run_before: zerosLeft before run k is rev_pos[k] + k + 1 - tc, so the
    # whole section vectorizes over k
    k_run = torch.arange(L - 1, dtype=I32, device=dev)
    zeros_left = rev_pos[..., : L - 1] + k_run + 1 - tc[..., None]
    active = (k_run <= tc[..., None] - 2) & (zeros_left > 0)
    run = torch.where(active, rev_pos[..., : L - 1] - rev_pos[..., 1:] - 1, 0)
    esc = zeros_left > 6
    rb_flat = ((zeros_left - 1).clamp(0, 5) * RUN_BEFORE_LEN.shape[1]
               + run.clamp(0, 6)).long()
    rb_len = torch.where(esc, torch.where(run < 7, 3, run - 3),
                         const(RUN_BEFORE_LEN.reshape(-1), dev)[rb_flat])
    rb_len = torch.where(active, rb_len, 0).to(I32)
    bits = bits + rb_len.sum(dim=-1, dtype=I32)
    out = {"tc": tc, "t1": t1, "rest_bits": bits, "ct_len": ct_len}
    if sizes_only:
        return out

    vcols.append(torch.where(tz_active, const(tzb.reshape(-1), dev)[tz_flat], 0))
    lcols.append(tz_len)
    rb_val = torch.where(esc, torch.where(run < 7, 7 - run, 1),
                         const(RUN_BEFORE_BITS.reshape(-1), dev)[rb_flat])
    rb_val = torch.where(active, rb_val, 0).to(I32)
    vals = torch.cat([torch.stack(vcols, dim=-1).to(I32), rb_val], dim=-1)
    lens = torch.cat([torch.stack(lcols, dim=-1).to(I32), rb_len], dim=-1)
    ct_val = const(_CT_BITS, dev)[(tc * 4 + t1).long()]
    return {**out, "ct_val": ct_val, "vals": vals, "lens": lens}


def finalize_symbols(blk, ctx):
    """(vals, lens) with slot 0 set to the coeff_token of the resolved nC
    context `ctx` (..., int in 0..4)."""
    sel = ctx.long()[..., None]
    vals = blk["vals"].clone()
    lens = blk["lens"].clone()
    vals[..., 0] = blk["ct_val"].gather(-1, sel)[..., 0]
    lens[..., 0] = blk["ct_len"].gather(-1, sel)[..., 0]
    return vals, lens


def pack_symbols(vals, lens):
    """Pack a flat symbol stream MSB-first into int64 words.

    vals/lens: (n,) int32; each value in `length` <= 28 bits, zero lengths
    skipped. Returns (words (n*28//64 + 2,) int64, nbits 0-d int64): bit 0
    of the payload is the most significant bit of words[0]. The word count
    is the worst case, so nothing is ever cut, and nbits is exact.
    """
    n = vals.shape[0]
    nw = n * MAX_SYMBOL_BITS // 64 + 2
    ln = lens.to(torch.int64)
    v = torch.where(ln > 0, vals.to(torch.int64), 0)
    end = torch.cumsum(ln, dim=0)
    off = end - ln
    word = off >> 6
    sh = 64 - (off & 63) - ln  # < 0: the symbol spills into the next word
    fits = sh >= 0
    hi = torch.where(fits, v << sh.clamp(min=0), v >> (-sh).clamp(min=0))
    lo = torch.where(fits, 0, v << (64 + sh).clamp(0, 63))
    words = torch.zeros(nw + 1, dtype=torch.int64, device=vals.device)
    words.index_add_(0, word, hi)
    words.index_add_(0, word + 1, lo)
    nbits = end[-1] if n else torch.zeros((), dtype=torch.int64,
                                            device=vals.device)
    return words[:nw], nbits


def words_to_bytes(words: np.ndarray, total_bits: int) -> bytes:
    """Host side: int64 words of pack_symbols → the first
    ceil(total_bits / 8) bytes of the big-endian payload."""
    nbytes = (int(total_bits) + 7) // 8
    return np.asarray(words, np.int64).astype(">i8").tobytes()[:nbytes]
