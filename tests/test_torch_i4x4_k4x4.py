"""The plain K4x4 (recon and levels) against the JAX package's Pallas kernel
pallas_i4x4_luma run in interpret mode on the CPU, exactly, in the decided
and in random modes. Split from tests/test_torch_i4x4.py (its grids and
content are that file's) so that each file holds at most ten tests."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from h264_fer_tpu.codec.tpu_intra import intra_mode_decision as jax_decision
from h264_fer_tpu.kernels.wavefront_pallas import pallas_i4x4_luma
from h264_fer_tpu_torch.kernels.wavefront_i4x4 import i4x4_luma
from test_torch_i4x4 import GRIDS, _luma

torch.set_num_threads(1)


@pytest.mark.parametrize("wh", GRIDS)
def test_plain_k4x4_matches_pallas(wh):
    """In the decided modes at QP 28, and in random modes everywhere, the
    frame edges included, at QP 10."""
    w, h = wh
    rng = np.random.default_rng(11)
    y = _luma(rng, w, h)
    nmb = (w // 16) * (h // 16)
    decided = np.array(jax_decision(jnp.asarray(y), wmb=w // 16, hmb=h // 16,
                                    qp=28, modes_only=True)["mode4"], np.int32)
    for qp, m4 in ((28, decided),
                   (10, rng.integers(0, 9, (nmb, 16)).astype(np.int32))):
        want = pallas_i4x4_luma(jnp.asarray(y), jnp.asarray(m4), wmb=w // 16,
                                hmb=h // 16, qp=qp)
        got = i4x4_luma(torch.from_numpy(y.astype(np.uint8)),
                        torch.from_numpy(m4), qp)
        for name, g, r in zip(("recon", "levels"), got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r),
                                          err_msg=f"{name} {w}x{h} qp{qp}")
