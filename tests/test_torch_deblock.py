"""The port's in-loop filter (K8's plain twin and its bS maps) against the
JAX package: the JAX device filter deblock_frame_device and the host
oracle codec/loopfilter.deblock_frame, exactly, on intra state (bS 3/4) at
QP 16, 32 and 44, the QP 8 no-op, and random inter state (bS 0-4) on QCIF
and on a tall 64x208 grid. The CUDA kernel is held against the plain twin
on the card by chip_smoke.py; here the wrapper must route CPU tensors to
the plain code."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from h264_fer_tpu.codec.loopfilter import deblock_frame as host_deblock
from h264_fer_tpu.kernels.deblock_tpu import _bs_maps, deblock_frame_device
from h264_fer_tpu.ops.tables import RASTER_TO_LUMA_BLOCK
from h264_fer_tpu_torch.codec.iframe import device_i16_frame
from h264_fer_tpu_torch.kernels.deblock import (bs_maps, deblock_frame,
                                               deblock_frame_plain)
from h264_fer_tpu_torch.ops.transform import chroma_qp

torch.set_num_threads(1)

_RASTER_Q = np.array([(b // 8) * 2 + (b % 4) // 2 for b in range(16)])


def _frame(rng, w, h):
    """Blocky content with noise, so that edges fall on both sides of the
    alpha / beta thresholds."""
    base = rng.integers(40, 200, (h // 8, w // 8))
    y = np.kron(base, np.ones((8, 8))) + rng.integers(-6, 7, (h, w))
    c = np.kron(base[::2, ::2], np.ones((8, 8))) + rng.integers(-4, 5, (h // 2, w // 2))
    return (np.clip(y, 0, 255).astype(np.uint8),
            np.clip(c, 0, 255).astype(np.uint8),
            np.clip(255 - c, 0, 255).astype(np.uint8))


def _intra_state(w, h, qp):
    """The recon and state of an all-I16 frame from the port's encoder."""
    planes = _frame(np.random.default_rng(qp), w, h)
    out = device_i16_frame(*(torch.from_numpy(p) for p in planes), qp, chroma_qp(qp))
    nmb = (w // 16) * (h // 16)
    return ([out[k].numpy() for k in ("recon_y", "recon_cb", "recon_cr")],
            np.ones(nmb, bool), out["nz_luma"].numpy(), np.zeros((nmb, 4, 2), np.int32))


def _inter_state(w, h, seed):
    """Random P-frame state: mixed intra flags, sparse nz flags and quadrant
    MVs whose neighbour deltas fall on both sides of 4."""
    rng = np.random.default_rng(seed)
    nmb = (w // 16) * (h // 16)
    mv = (rng.integers(-3, 4, (nmb, 1, 2)) * 2 + rng.integers(-2, 3, (nmb, 4, 2)))
    return (list(_frame(rng, w, h)), rng.random(nmb) < 0.15,
            rng.random((nmb, 16)) < 0.3, mv.astype(np.int32))


def _references(planes, mb_intra, nz, mv, w, h, qp):
    """(JAX device filter, host oracle) outputs on the same state."""
    qpc = chroma_qp(qp)
    mv44 = np.repeat(mv[:, :, None, :], 4, axis=2)
    dev = deblock_frame_device(*(jnp.asarray(p, jnp.int32) for p in planes),
                               jnp.asarray(mb_intra), jnp.asarray(nz), jnp.asarray(mv44),
                               wmb=w // 16, hmb=h // 16, qp=qp, qpc=qpc)

    class State:  # the host filter works in place on an encoder-like state
        pass

    st = State()
    st.wmb, st.hmb, st.qpy, st.qpc = w // 16, h // 16, qp, qpc
    st.y, st.cb, st.cr = (p.astype(np.int32).copy() for p in planes)
    st.mb_intra, st.nz_luma, st.mv = mb_intra, nz, mv44
    host_deblock(st)
    return [np.asarray(p) for p in dev], [st.y, st.cb, st.cr]


def _check(state, w, h, qp):
    planes, mb_intra, nz, mv = state
    got = deblock_frame_plain(*(torch.from_numpy(np.ascontiguousarray(a))
                                for a in (*planes, mb_intra, nz, mv)), qp, chroma_qp(qp))
    ref_dev, ref_host = _references(planes, mb_intra, nz, mv, w, h, qp)
    for k, name in enumerate(("y", "cb", "cr")):
        assert got[k].dtype == torch.uint8
        np.testing.assert_array_equal(got[k].numpy(), ref_dev[k], err_msg=f"{name} vs JAX")
        np.testing.assert_array_equal(got[k].numpy(), ref_host[k], err_msg=f"{name} vs host")
    return got


@pytest.mark.parametrize("qp", [16, 32, 44])
def test_plain_k8_intra_state(qp):
    state = _intra_state(176, 144, qp)
    got = _check(state, 176, 144, qp)
    assert not np.array_equal(got[0].numpy(), state[0][0])  # the filter acted


def test_plain_k8_qp8_is_a_noop():
    state = _intra_state(176, 144, 8)
    got = _check(state, 176, 144, 8)
    for g, p in zip(got, state[0]):
        np.testing.assert_array_equal(g.numpy(), p)


@pytest.mark.parametrize("wh, qp", [((176, 144), 30), ((64, 208), 38)])
def test_plain_k8_random_inter_state(wh, qp):
    w, h = wh
    state = _inter_state(w, h, seed=w + qp)
    bs_v, bs_h = bs_maps(*(torch.from_numpy(a) for a in state[1:]), w // 16, h // 16)
    assert set(np.unique(torch.cat([bs_v, bs_h]).numpy())) == {0, 1, 2, 3, 4}
    _check(state, w, h, qp)


@pytest.mark.parametrize("wh", [(176, 144), (64, 208)])
def test_bs_maps_match_jax(wh):
    w, h = wh
    _, mb_intra, nz, mv = _inter_state(w, h, seed=3)
    nz_raster = jnp.asarray(nz)[:, jnp.asarray(RASTER_TO_LUMA_BLOCK)]
    want = _bs_maps(jnp.asarray(mb_intra), nz_raster, jnp.asarray(mv)[:, _RASTER_Q],
                    w // 16, h // 16)
    got = bs_maps(*(torch.from_numpy(a) for a in (mb_intra, nz, mv)), w // 16, h // 16)
    for g, r in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_wrapper_routes_cpu_to_plain_without_launch():
    planes, mb_intra, nz, mv = _inter_state(48, 32, seed=5)
    args = [torch.from_numpy(a) for a in (*planes, mb_intra, nz, mv)]
    before = deblock_frame.launches
    got = deblock_frame(*args, 30, chroma_qp(30))
    want = deblock_frame_plain(*args, 30, chroma_qp(30))
    assert deblock_frame.launches == before
    for g, r in zip(got, want):
        assert g.dtype == torch.uint8 and torch.equal(g, r)
