"""The port's CAVLC symbols, Exp-Golomb codes, bit packing and I16 slice
entropy equal the JAX package's (ops/cavlc_jax.py,
codec/tpu_entropy.i16_slice_entropy). Split from
tests/test_torch_entropy.py, which keeps the routing, table and wrapper
tests, so that the JAX comparisons run in a file of at most ten tests."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from h264_fer_tpu.codec.tpu_entropy import i16_slice_entropy as jax_entropy
from h264_fer_tpu.ops import cavlc_jax
from h264_fer_tpu_torch.codec.entropy import i16_slice_entropy
from h264_fer_tpu_torch.ops import cavlc_bulk
from test_tpu_entropy import _random_frame_levels

torch.set_num_threads(1)


@pytest.mark.parametrize("wmb,hmb,density", [(9, 11, 0.35), (4, 3, 0.9),
                                             (16, 2, 0.05)])
def test_i16_slice_entropy_matches_jax(wmb, hmb, density):
    nmb = wmb * hmb
    levels = _random_frame_levels(np.random.default_rng(nmb), nmb, density)
    ref = jax_entropy(*(jnp.asarray(a) for a in levels), wmb=wmb, hmb=hmb)
    got = i16_slice_entropy(*(torch.from_numpy(a) for a in levels),
                            wmb=wmb, hmb=hmb)
    nbits = int(ref["nbits"])
    assert int(got["nbits"]) == nbits
    assert (cavlc_bulk.words_to_bytes(got["words"].numpy(), nbits)
            == cavlc_jax.words_to_bytes(np.asarray(ref["words"]), nbits))
    for key in ("mb_type", "cbp_luma", "cbp_chroma", "tc_luma", "tc_chroma"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]),
                                      err_msg=key)


@pytest.mark.parametrize("max_num_coeff,L", [(16, 16), (15, 15), (4, 4)])
def test_block_symbols_match_jax(max_num_coeff, L):
    rng = np.random.default_rng(L)
    amp = rng.choice([1, 2, 4, 40, 3000], (300, 1))
    lv = rng.integers(-amp, amp + 1, (300, L)).astype(np.int32)
    lv = np.where(rng.random((300, L)) < rng.random((300, 1)), lv, 0)
    ref = cavlc_jax.block_symbols_bulk(jnp.asarray(lv), max_num_coeff)
    got = cavlc_bulk.block_symbols_bulk(torch.from_numpy(lv), max_num_coeff)
    for key in ("tc", "t1", "rest_bits", "ct_len", "ct_val", "vals", "lens"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]),
                                      err_msg=key)
    ctx = rng.integers(0, 5 if max_num_coeff == 4 else 4, 300).astype(np.int32)
    if max_num_coeff == 4:
        ctx[:] = 4
    rv, rl = cavlc_jax.finalize_symbols(ref, jnp.asarray(ctx))
    gv, gl = cavlc_bulk.finalize_symbols(got, torch.from_numpy(ctx))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(rl))


def test_exp_golomb_and_nc_ctx():
    v = np.concatenate([np.arange(0, 600), [4094, 4095, 65535, 2 ** 20]]
                       ).astype(np.int32)
    for a, b in zip(cavlc_bulk.ue_code(torch.from_numpy(v)),
                    cavlc_jax.ue_code(jnp.asarray(v))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    s = np.arange(-300, 301).astype(np.int32)
    for a, b in zip(cavlc_bulk.se_code(torch.from_numpy(s)),
                    cavlc_jax.se_code(jnp.asarray(s))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    nc = np.arange(0, 20).astype(np.int32)
    np.testing.assert_array_equal(cavlc_bulk.nc_to_ctx(torch.from_numpy(nc)).numpy(),
                                  np.asarray(cavlc_jax.nc_to_ctx(jnp.asarray(nc))))


def test_pack_symbols_matches_jax():
    """Random streams with symbols of every length 0..28 at every bit
    alignment: the int64 index_add_ packing gives the same bytes and the
    same bit count as the reference packer."""
    rng = np.random.default_rng(2)
    n = 5000
    lens = rng.integers(0, 29, n).astype(np.int32)
    lens[rng.random(n) < 0.3] = 0
    vals = (rng.integers(0, 2 ** 31 - 1, n) & ((1 << lens) - 1)).astype(np.int32)
    words, nbits = cavlc_bulk.pack_symbols(torch.from_numpy(vals),
                                           torch.from_numpy(lens))
    rw, rn, ok = cavlc_jax.pack_symbols(jnp.asarray(vals), jnp.asarray(lens))
    assert bool(ok) and int(nbits) == int(rn) == int(lens.sum())
    assert (cavlc_bulk.words_to_bytes(words.numpy(), int(nbits))
            == cavlc_jax.words_to_bytes(np.asarray(rw), int(rn)))
