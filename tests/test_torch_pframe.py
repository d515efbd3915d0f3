"""The port's P-frame stages and the plain twins of K2-K5 against the JAX
package, exactly: the XLA contract twins (integer_score_map,
qpel_refine_map, pframe_decide_impl, mc_luma_bulk / mc_chroma_bulk,
interpolated_planes_jax, pframe_maps, pframe_residual_recon,
p_slice_entropy_impl) in every metric tier, on negative MVs, MVs at the
search limits and tied scores; and the Pallas kernels of K2, K3 and K5 in
interpret mode, as the JAX package runs them on the CPU.

The CUDA kernels are held against these plain twins on the card by
chip_smoke.py; here each wrapper must route CPU tensors to its twin."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from h264_fer_tpu.codec import tpu_pframe as jp
from h264_fer_tpu.codec.tpu_entropy import p_slice_entropy as jax_p_entropy
from h264_fer_tpu.kernels.mc_pallas import mc_bulk_pallas_impl
from h264_fer_tpu.kernels.me_int_pallas import integer_score_map_pallas_impl
from h264_fer_tpu.kernels.me_pallas import qpel_refine_pallas_impl
from h264_fer_tpu.kernels.wavefront_p import pframe_decide as jax_decide
from h264_fer_tpu.ops.cavlc_jax import words_to_bytes as jax_words_to_bytes
from h264_fer_tpu.ops.interp import interpolated_planes_jax, pad_chroma_jax
from h264_fer_tpu.ops.transform import chroma_qp
from h264_fer_tpu_torch.codec import pframe as tp
from h264_fer_tpu_torch.codec.entropy import p_slice_entropy
from h264_fer_tpu_torch.kernels import mc, me_int, me_qpel, wavefront_p
from h264_fer_tpu_torch.ops.cavlc_bulk import words_to_bytes
from h264_fer_tpu_torch.ops.interp import (interpolated_planes, interpolated_planes_plain,
                                           pad_chroma)

torch.set_num_threads(1)

# (W, H, window): a small and a wider search window
GEOMS = [(80, 48, 4), (96, 64, 8)]
QPS = [28, 40, 46]  # SAD, SSD, 2*SSD
# (geometry, qp, flat) of the JAX reference maps and decisions: every metric
# tier on the wider window, the 2*SSD tier on the small one, and flat
# content where every candidate ties (each new geometry and metric costs a
# JAX compile of the decision)
CASES = [(GEOMS[1], qp, False) for qp in QPS] + [(GEOMS[0], 46, False),
                                                 (GEOMS[1], 28, True)]
# the cases whose decisions come from the JAX decision wavefront: every
# metric tier once; the other case takes the port's plain K4, which these
# hold equal to the reference, as the input of the residual and entropy
DECIDE_CASES = [c for c in CASES if c[:2] != (GEOMS[1], 46)]
# jitted references: one compile each instead of one per eager op
_jax_residual_recon = jax.jit(jp.pframe_residual_recon,
                              static_argnums=(8, 9, 10, 11, 12))
_jax_mc_luma = jax.jit(jp.mc_luma_bulk, static_argnums=(2, 3, 4))
_jax_mc_chroma = jax.jit(jp.mc_chroma_bulk, static_argnums=(2, 3, 4))


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(got, ref, what=""):
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref), err_msg=what)


def _frames(w, h, seed, flat=False):
    """(ref, src) (y, cb, cr) uint8 planes: src is ref moved by (-3, -2)
    samples plus noise, so the search finds negative MVs; flat content
    makes every score of a block tie."""
    rng = np.random.default_rng(seed)

    def moved(p):
        if flat:
            return np.full_like(p, 128)
        noise = rng.integers(-6, 7, p.shape)
        return np.clip(np.roll(p, (2, 3), (0, 1)) + noise, 0, 255).astype(np.uint8)

    ref = tuple(np.full(s, 128, np.uint8) if flat
                else rng.integers(0, 256, s).astype(np.uint8)
                for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2)))
    return ref, tuple(moved(p) for p in ref)


def _prev_mv(rng, nmb, lim):
    """Previous-frame MVs: zeros, values past the c2 limit lim - 3 (q2ok
    false, clamped), and the limit itself, both signs."""
    prev = rng.integers(-lim - 3, lim + 4, (nmb, 4, 2)).astype(np.int32)
    prev[rng.random(nmb) < 0.3] = 0
    prev[0, 0] = (lim - 3, -(lim - 3))
    prev[-1, 3] = (-(lim - 3), lim - 3)
    prev[nmb // 2, 1] = (lim - 2, 0)
    return prev


@pytest.fixture(scope="module")
def cases():
    """JAX references of the bulk maps and the decision per (geometry, qp),
    computed once; the flat pair gives tied scores everywhere."""
    out = {}
    for (w, h, win), qp, flat in CASES:
        wmb, hmb = w // 16, h // 16
        ext = win + 2
        ref, src = _frames(w, h, w + qp, flat)
        prev = _prev_mv(np.random.default_rng(qp), wmb * hmb, 4 * ext - 4)
        planes = interpolated_planes_jax(jnp.asarray(ref[0], jnp.int32), ext)
        src_y = jnp.asarray(src[0], jnp.int32)
        maps = jp.pframe_maps(src_y, planes, jnp.asarray(prev), wmb, hmb, win, qp,
                              pallas=False)
        md = jp.adaptive_maxdiff(src_y, wmb, hmb, -1)
        args = (src_y, planes, maps["int_map"], maps["c1mv"], maps["q1map"],
                maps["c2mv"], maps["q2map"], maps["q2ok"], md)
        kw = dict(wmb=wmb, hmb=hmb, window=win, ext=ext,
                  metric_id=maps["metric_id"], lam=maps["lam"])
        if ((w, h, win), qp, flat) in DECIDE_CASES:
            dec = jax_decide(*args, **kw)
        else:
            dec = wavefront_p.pframe_decide_plain(*(_t(a) for a in args), **kw)
        out[(w, h, win, qp, flat)] = dict(ref=ref, src=src, prev=prev, planes=planes,
                                          maps=maps, md=md, dec=dec)
    return out


def _case(cases, geom, qp, flat=False):
    return cases[(*geom, qp, flat)]


@pytest.mark.parametrize("geom,qp", [(GEOMS[0], 46), (GEOMS[1], 28)])
def test_interpolated_planes_and_pad_chroma(cases, geom, qp):
    c = _case(cases, geom, qp)
    ext = geom[2] + 2
    planes = interpolated_planes_plain(_t(c["ref"][0]), ext)
    assert planes.dtype == torch.uint8
    _eq(planes, c["planes"])
    assert torch.equal(interpolated_planes(_t(c["ref"][0]), ext), planes)  # the dispatcher
    ext_c = ext // 2 + 1
    _eq(pad_chroma(_t(c["ref"][1]), ext_c),
        pad_chroma_jax(jnp.asarray(c["ref"][1]), ext_c))


@pytest.mark.parametrize("geom,qp,flat", CASES)
def test_integer_score_map_matches_xla(cases, geom, qp, flat):
    c = _case(cases, geom, qp, flat)
    w, h, win = geom
    metric_id, _ = tp.me_params(qp)
    ref = jp.integer_score_map(jnp.asarray(c["src"][0], jnp.int32),
                               c["planes"][0], win + 2, win, metric_id)
    before = me_int.integer_score_map.launches
    got = me_int.integer_score_map(_t(c["src"][0]), _t(c["planes"][0]), win + 2,
                                   win, metric_id)
    assert me_int.integer_score_map.launches == before  # CPU: the plain twin
    _eq(got, ref)


def test_qpel_refine_map_at_limits_matches_xla():
    """Centres at ±(lim - 3) and negative centres, every metric tier."""
    w, h, win = GEOMS[1]
    ext = win + 2
    lim = 4 * ext - 4
    ref, src = _frames(w, h, 5)
    planes = interpolated_planes(_t(ref[0]), ext)
    nb = (w // 8) * (h // 8)
    rng = np.random.default_rng(6)
    centres = rng.integers(-(lim - 3), lim - 2, (nb, 2)).astype(np.int32)
    centres[: nb // 4] = rng.choice([-(lim - 3), lim - 3], (nb // 4, 2))
    for metric_id in range(3):
        want = jp.qpel_refine_map(jnp.asarray(src[0], jnp.int32),
                                  jnp.asarray(planes.numpy(), jnp.int32),
                                  jnp.asarray(centres), ext, metric_id)
        _eq(me_qpel.qpel_refine_map_plain(_t(src[0]), planes, _t(centres), ext,
                                          metric_id), want, f"metric {metric_id}")


def test_mc_bulk_at_limits_matches_xla():
    w, h, win = GEOMS[1]
    wmb, hmb = w // 16, h // 16
    ext = win + 2
    ext_c = ext // 2 + 1
    lim = 4 * ext - 4
    ref, _ = _frames(w, h, 9)
    rng = np.random.default_rng(10)
    mv = rng.integers(-lim, lim + 1, (wmb * hmb, 4, 2)).astype(np.int32)
    mv[0] = ((-lim, -lim), (lim, lim), (-lim, lim), (lim, -lim))
    planes = interpolated_planes(_t(ref[0]), ext)
    pads = [pad_chroma(_t(p), ext_c) for p in ref[1:]]
    before = mc.mc_bulk.launches
    got = mc.mc_bulk(planes, *pads, _t(mv), ext, ext_c, wmb, hmb)
    assert mc.mc_bulk.launches == before
    jplanes = jnp.asarray(planes.numpy(), jnp.int32)
    _eq(got[0], _jax_mc_luma(jplanes, jnp.asarray(mv), ext, wmb, hmb), "luma")
    for k in (1, 2):
        want = _jax_mc_chroma(pad_chroma_jax(jnp.asarray(ref[k]), ext_c),
                                 jnp.asarray(mv), ext_c, wmb, hmb)
        _eq(got[k], want, f"chroma {k}")


def test_mb_window_gather_matches_jax():
    w, h, win = GEOMS[0]
    ext = win + 2
    lim = 4 * ext - 4
    ref, _ = _frames(w, h, 12)
    planes = interpolated_planes(_t(ref[0]), ext)
    rng = np.random.default_rng(13)
    n = 12
    mv = rng.integers(-lim, lim + 1, (n, 2)).astype(np.int32)
    mbx = rng.integers(0, w // 16, n).astype(np.int32)
    mby = rng.integers(0, h // 16, n).astype(np.int32)
    want = jp.mb_window_gather(jnp.asarray(planes.numpy(), jnp.int32),
                               jnp.asarray(mv), jnp.asarray(mbx), jnp.asarray(mby),
                               ext)
    _eq(wavefront_p.mb_window_gather(planes, _t(mv), _t(mbx).long(),
                                     _t(mby).long(), ext), want)


@pytest.mark.parametrize("kernel", ["me_int", "me_qpel", "mc"])
def test_plain_twin_matches_pallas_interpret(kernel):
    """K2, K3 and K5's Pallas kernels in interpret mode, on one small
    geometry, against the port's plain twins."""
    w, h, win = 48, 32, 4
    wmb, hmb = w // 16, h // 16
    ext = win + 2
    ext_c = ext // 2 + 1
    lim = 4 * ext - 4
    ref, src = _frames(w, h, 21)
    planes = interpolated_planes(_t(ref[0]), ext)
    jplanes = jnp.asarray(planes.numpy(), jnp.int32)
    jsrc = jnp.asarray(src[0], jnp.int32)
    rng = np.random.default_rng(22)
    if kernel == "me_int":
        want = integer_score_map_pallas_impl(jsrc, jplanes[0], ext, win, 0)
        got = me_int.integer_score_map(_t(src[0]), planes[0], ext, win, 0)
        _eq(got, want)
    elif kernel == "me_qpel":
        nb = (w // 8) * (h // 8)
        # the Pallas kernel takes c1 as the integer argmin it always is
        # (frac 0, me_pallas.py:94-96); c2 at any quarter-pel position
        c1 = (4 * rng.integers(-win, win + 1, (nb, 2))).astype(np.int32)
        c2 = rng.integers(-(lim - 3), lim - 2, (nb, 2)).astype(np.int32)
        want = qpel_refine_pallas_impl(jsrc, jplanes, jnp.asarray(c1),
                                       jnp.asarray(c2), win, ext, 1)
        got = me_qpel.qpel_refine_maps(_t(src[0]), planes, _t(c1), _t(c2), ext, 1)
        for g, r in zip(got, want):
            _eq(g, r)
    else:
        mv = rng.integers(-lim, lim + 1, (wmb * hmb, 4, 2)).astype(np.int32)
        pads = [pad_chroma_jax(jnp.asarray(p), ext_c) for p in ref[1:]]
        want = mc_bulk_pallas_impl(jplanes, *pads, jnp.asarray(mv), ext, ext_c,
                                   wmb, hmb)
        got = mc.mc_bulk(planes, *(pad_chroma(_t(p), ext_c) for p in ref[1:]),
                         _t(mv), ext, ext_c, wmb, hmb)
        for g, r in zip(got, want):
            _eq(g, r)


def test_me_params_and_adaptive_maxdiff():
    for qp in range(52):
        assert tp.me_params(qp) == jp.me_params(qp)
    ref, src = _frames(96, 64, 30)
    for cfg in (-1, 5):
        _eq(tp.adaptive_maxdiff(_t(src[0]), 6, 4, cfg),
            jp.adaptive_maxdiff(jnp.asarray(src[0], jnp.int32), 6, 4, cfg))


def _port_maps(c, geom, qp):
    w, h, win = geom
    planes = interpolated_planes(_t(c["ref"][0]), win + 2)
    return planes, tp.pframe_maps(_t(c["src"][0]), planes, _t(c["prev"]),
                                  w // 16, h // 16, win, qp)


@pytest.mark.parametrize("geom,qp,flat", CASES)
def test_pframe_maps_match_jax(cases, geom, qp, flat):
    c = _case(cases, geom, qp, flat)
    _, got = _port_maps(c, geom, qp)
    for key in ("int_map", "c1mv", "q1map", "c2mv", "q2map", "q2ok"):
        _eq(got[key], c["maps"][key], key)
    for key in ("metric_id", "lam", "ext"):
        assert got[key] == c["maps"][key], key
    assert not bool(got["q2ok"].all()) and bool(got["q2ok"].any())


@pytest.mark.parametrize("geom,qp,flat", DECIDE_CASES)
def test_pframe_decide_plain_matches_xla(cases, geom, qp, flat):
    """The plain K4 on the reference's own maps; flat content ties every
    candidate, so the argmin must take the first index."""
    c = _case(cases, geom, qp, flat)
    w, h, win = geom
    m = c["maps"]
    args = [_t(m[k]) for k in ("int_map", "c1mv", "q1map", "c2mv", "q2map",
                               "q2ok")]
    before = wavefront_p.pframe_decide.launches
    got = wavefront_p.pframe_decide(
        _t(c["src"][0]), interpolated_planes(_t(c["ref"][0]), win + 2), *args,
        _t(c["md"]), w // 16, h // 16, win, win + 2, m["metric_id"], m["lam"])
    assert wavefront_p.pframe_decide.launches == before
    for key in ("skip", "mb_type", "mv", "mvd"):
        _eq(got[key], c["dec"][key], key)
    if not flat:
        assert (got["mv"] < 0).any() and not bool(got["skip"].all())


def _levels_and_entropy(c, geom, qp, prefilter):
    w, h, win = geom
    wmb, hmb = w // 16, h // 16
    ext = win + 2
    ext_c = ext // 2 + 1
    qpc = chroma_qp(qp)
    dec = {k: np.asarray(v) for k, v in c["dec"].items()}
    jplanes = c["planes"]
    pred = (_jax_mc_luma(jplanes, jnp.asarray(dec["mv"]), ext, wmb, hmb),
            *(_jax_mc_chroma(pad_chroma_jax(jnp.asarray(p), ext_c),
                                jnp.asarray(dec["mv"]), ext_c, wmb, hmb)
              for p in c["ref"][1:]))
    src = [jnp.asarray(p, jnp.int32) for p in c["src"]]
    ref = _jax_residual_recon(*src, *pred, jnp.asarray(dec["skip"]), c["md"],
                              wmb, hmb, qp, qpc, prefilter)
    args = (*(_t(p) for p in c["src"]), *(_t(p) for p in pred), _t(dec["skip"]),
            _t(c["md"]), wmb, hmb, qp, qpc, prefilter)
    return dec, ref, tp.pframe_residual_recon_plain(*args), args


@pytest.mark.parametrize("geom,qp,prefilter", [(GEOMS[1], 28, True),
                                               (GEOMS[1], 40, False),
                                               (GEOMS[1], 46, True)])
def test_pframe_residual_recon_matches_jax(cases, geom, qp, prefilter):
    _, ref, got, args = _levels_and_entropy(_case(cases, geom, qp), geom, qp, prefilter)
    for key in ("luma", "cdc", "cac"):
        _eq(got[0][key], ref[0][key], key)
    for k in (1, 2, 3):
        _eq(got[k], ref[k], f"recon {k}")
    disp = tp.pframe_residual_recon(*args)  # the dispatcher: CPU tensors take the twin
    assert all(torch.equal(disp[0][k], got[0][k]) for k in got[0])
    assert all(torch.equal(a, b) for a, b in zip(disp[1:], got[1:]))


@pytest.mark.parametrize("geom,qp", [(GEOMS[1], qp) for qp in QPS])
def test_p_slice_entropy_matches_jax(cases, geom, qp):
    w, h, _ = geom
    dec, ref, got, _ = _levels_and_entropy(_case(cases, geom, qp), geom, qp, qp < 36)
    lv = got[0]
    want = jax_p_entropy(jnp.asarray(dec["skip"]), jnp.asarray(dec["mb_type"]),
                         jnp.asarray(dec["mvd"]), ref[0]["luma"], ref[0]["cdc"],
                         ref[0]["cac"], wmb=w // 16, hmb=h // 16)
    out = p_slice_entropy(_t(dec["skip"]), _t(dec["mb_type"]), _t(dec["mvd"]),
                          lv["luma"], lv["cdc"], lv["cac"], wmb=w // 16, hmb=h // 16)
    nbits = int(want["nbits"])
    assert int(out["nbits"]) == nbits
    assert (words_to_bytes(out["words"].numpy(), nbits)
            == jax_words_to_bytes(np.asarray(want["words"]), nbits))
    for key in ("trail_bits", "cbp_luma", "cbp_chroma", "tc_luma", "tc_chroma",
                "nz_luma"):
        _eq(out[key], want[key], key)


def test_p_slice_entropy_trailing_skip_run_matches_jax():
    """A slice that ends on a run of skipped MBs writes the trailing
    mb_skip_run; one whose last MB is coded writes none."""
    wmb, hmb = GEOMS[1][0] // 16, GEOMS[1][1] // 16  # the compiled geometry
    nmb = wmb * hmb
    rng = np.random.default_rng(40)
    for last_coded in (nmb - 5, nmb - 1):
        skip = np.zeros(nmb, bool)
        skip[last_coded + 1:] = True
        skip[[1, 2, 6]] = True
        mb_type = rng.choice([0, 1, 2, 4], nmb).astype(np.int32)
        mvd = rng.integers(-40, 41, (nmb, 4, 2)).astype(np.int32)
        luma = np.where(rng.random((nmb, 16, 16)) < 0.1,
                        rng.integers(-3, 4, (nmb, 16, 16)), 0).astype(np.int32)
        cdc = np.where(rng.random((2, nmb, 4)) < 0.2,
                       rng.integers(-3, 4, (2, nmb, 4)), 0).astype(np.int32)
        cac = np.where(rng.random((2, nmb, 4, 15)) < 0.05,
                       rng.integers(-2, 3, (2, nmb, 4, 15)), 0).astype(np.int32)
        luma[skip], cdc[:, skip], cac[:, skip] = 0, 0, 0
        arrays = (skip, mb_type, mvd, luma, cdc, cac)
        want = jax_p_entropy(*(jnp.asarray(a) for a in arrays), wmb=wmb, hmb=hmb)
        got = p_slice_entropy(*(_t(a) for a in arrays), wmb=wmb, hmb=hmb)
        nbits = int(want["nbits"])
        assert int(got["nbits"]) == nbits
        assert (int(got["trail_bits"]) > 0) == (last_coded < nmb - 1)
        _eq(got["trail_bits"], want["trail_bits"])
        assert (words_to_bytes(got["words"].numpy(), nbits)
                == jax_words_to_bytes(np.asarray(want["words"]), nbits))
