"""The port's copied spec tables equal the JAX package's, array by array."""

import numpy as np
import pytest
import torch

from h264_fer_tpu.codec import decoder as jax_decoder
from h264_fer_tpu.ops import cavlc_tables as jax_cavlc_tables
from h264_fer_tpu.ops import deblock as jax_deblock
from h264_fer_tpu.ops import tables as jax_tables
from h264_fer_tpu_torch.ops import cavlc_tables, deblock, tables

torch.set_num_threads(1)

TABLES = ["ZIGZAG_YX", "ZIGZAG_FLAT", "INV_ZIGZAG_FLAT", "LEVEL_SCALE",
          "LEVEL_QUANTIZE", "QPI_TO_QPC", "INTRA4X4_SCAN_ORDER_XY",
          "RASTER_TO_LUMA_BLOCK", "CODENUM_TO_CBP_INTER", "CBP_TO_CODENUM_INTER",
          "CODENUM_TO_CBP_INTRA", "CBP_TO_CODENUM_INTRA", "SUB_MB_NUM_PARTS"]
CAVLC_TABLES = ["COEFF_TOKEN_LEN", "COEFF_TOKEN_BITS", "TOTAL_ZEROS_LEN",
                "TOTAL_ZEROS_BITS", "TOTAL_ZEROS_CDC_LEN",
                "TOTAL_ZEROS_CDC_BITS", "RUN_BEFORE_LEN", "RUN_BEFORE_BITS"]
DEBLOCK_TABLES = ["ALPHA", "BETA", "TC0"]


@pytest.mark.parametrize("name", TABLES)
def test_spec_table_copy(name):
    ours, ref = getattr(tables, name), getattr(jax_tables, name)
    assert ours.dtype == ref.dtype
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("name", CAVLC_TABLES)
def test_cavlc_table_copy(name):
    ours, ref = getattr(cavlc_tables, name), getattr(jax_cavlc_tables, name)
    assert ours.dtype == ref.dtype
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("name", DEBLOCK_TABLES)
def test_deblock_table_copy(name):
    ours, ref = getattr(deblock, name), getattr(jax_deblock, name)
    assert ours.dtype == ref.dtype
    np.testing.assert_array_equal(ours, ref)


def test_every_cavlc_table_is_copied():
    names = {n for n in dir(jax_cavlc_tables)
             if isinstance(getattr(jax_cavlc_tables, n), np.ndarray)}
    assert names == set(CAVLC_TABLES)


def test_block_neighbour_maps():
    assert tables.LUMA_NBR == tuple(jax_decoder._luma_blk_neighbors(b) for b in range(16))
    assert tables.CHROMA_NBR == tuple(jax_decoder._chroma_blk_neighbors(b) for b in range(4))
