"""The port's Intra16x16 mode decision equals
intra_mode_decision(..., i16_only=True) of the JAX package."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from h264_fer_tpu.codec.tpu_intra import intra_mode_decision
from h264_fer_tpu_torch.codec.intra_decision import intra16_mode_decision

torch.set_num_threads(1)


def _check(y, qp):
    h, w = y.shape
    ref = intra_mode_decision(jnp.asarray(y), wmb=w // 16, hmb=h // 16,
                              qp=qp, i16_only=True)
    mode, satd = intra16_mode_decision(torch.from_numpy(y), qp)
    np.testing.assert_array_equal(mode.numpy(), np.asarray(ref["mode16"]))
    np.testing.assert_array_equal(satd.numpy(), np.asarray(ref["satd16"]))
    return mode.numpy()


@pytest.mark.parametrize("wh", [(176, 144), (80, 176)])
@pytest.mark.parametrize("qp", [4, 28, 45])
def test_mode16_matches_jax(wh, qp):
    w, h = wh
    rng = np.random.default_rng(qp)
    yy, xx = np.mgrid[0:h, 0:w]
    y = ((xx * 3 + yy * 2) % 256 + rng.integers(0, 40, (h, w))).astype(np.int32)
    y = np.clip(y, 0, 255)
    modes = _check(y, qp)
    assert len(set(modes.tolist())) > 1  # the content exercises several modes


def test_equal_satd_takes_first_mode():
    """A flat frame gives every available mode the same SATD: the decision
    must take the first available one, as jnp.argmin does."""
    y = np.full((48, 64), 77, np.int32)
    modes = _check(y, 28).reshape(3, 4)
    assert modes[0, 0] == 2  # no neighbour: only DC is ungated
    assert (modes[0, 1:] == 1).all()  # top row: H is the first available
    assert (modes[1:] == 0).all()  # V is first wherever the top exists
