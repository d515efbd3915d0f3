"""The plain K1t (K1t's plain twin, the K1 wavefront writing its levels)
equals the JAX package's pallas_i16_frame run in interpret mode on the
CPU, exactly. Split from tests/test_torch_wavefront.py (its helpers are
that file's) so that each file holds at most ten tests."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from h264_fer_tpu.kernels.wavefront_pallas import pallas_i16_frame
from h264_fer_tpu.ops.transform import chroma_qp
from h264_fer_tpu_torch.kernels.wavefront_i16 import i16_frame_plain
from test_torch_wavefront import _compare, _decided_modes, _planes

torch.set_num_threads(1)


@pytest.mark.parametrize("wh", [(176, 144), (80, 176)])
@pytest.mark.parametrize("qp", [10, 40])
def test_plain_k1t_matches_pallas_i16_frame(wh, qp):
    """K1t's plain twin gives the tuple of pallas_i16_frame, the Pallas
    kernel that writes the levels itself, run in interpret mode as
    tests/test_pallas_wavefront.py runs it."""
    w, h = wh
    planes = _planes(np.random.default_rng(7), w, h)
    y32, cb32, cr32 = (jnp.asarray(p, jnp.int32) for p in planes)
    m16, cm = _decided_modes(planes[0], qp)
    ref = pallas_i16_frame(y32, cb32, cr32, jnp.asarray(m16), jnp.asarray(cm),
                           wmb=w // 16, hmb=h // 16, qp=qp, qpc=chroma_qp(qp))
    t = [torch.from_numpy(p) for p in planes]
    got = i16_frame_plain(*t, torch.from_numpy(m16), torch.from_numpy(cm), qp, chroma_qp(qp))
    _compare(ref, got, f"K1t {w}x{h} qp{qp}")
