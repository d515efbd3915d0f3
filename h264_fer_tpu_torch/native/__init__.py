"""The native slice decoder (decoder_native.cpp), loaded with ctypes.

The counterpart of the decoder half of h264_fer_tpu/native/__init__.py
(_decoder_tables :205, decode_slice_native :222). decoder_native.cpp has a
plain C interface and is built by g++ (kernels/build.compile_host_source)
on first use into h264_fer_tpu_torch/_build/, under a name that carries a
hash of the source and the flags. A missing g++ or a failed build raises:
there is no switch that turns the native form off and no silent fallback
to the Python form (codec.decoder.Decoder(native=False) asks for it).
"""

from __future__ import annotations

import ctypes
import pathlib
import threading

import numpy as np

SOURCE = pathlib.Path(__file__).parent / "decoder_native.cpp"

_lock = threading.Lock()
_lib = None

# decode_slice's error codes (decoder_native.cpp), as the Python form raises them
ERRORS = {
    -3: "bad mb_type",
    -4: "I_PCM not supported (matches reference)",
    -5: "bad intra_chroma_pred_mode",
    -6: "bad coded_block_pattern codeNum",
    -7: "bad mb_qp_delta",
    -8: "bad TotalCoeff",
    -9: "invalid VLC codeword",
    -10: "P slice without reference frame",
}


def _decoder_tables():
    """The 14 int32 tables decoder_init copies, flattened."""
    from ..ops import cavlc_tables as CT
    from ..ops import tables as TT

    c = lambda a: np.ascontiguousarray(np.asarray(a).reshape(-1), np.int32)
    return (
        c(CT.COEFF_TOKEN_LEN), c(CT.COEFF_TOKEN_BITS),
        c(CT.TOTAL_ZEROS_LEN), c(CT.TOTAL_ZEROS_BITS),
        c(CT.TOTAL_ZEROS_CDC_LEN), c(CT.TOTAL_ZEROS_CDC_BITS),
        c(CT.RUN_BEFORE_LEN), c(CT.RUN_BEFORE_BITS),
        c(TT.CODENUM_TO_CBP_INTRA), c(TT.CODENUM_TO_CBP_INTER),
        c(TT.INTRA4X4_SCAN_ORDER_XY), c(TT.RASTER_TO_LUMA_BLOCK),
        c(TT.QPI_TO_QPC), c(TT.ZIGZAG_FLAT),
    )


def load() -> ctypes.CDLL:
    """The native decoder library with its tables initialised, built with
    g++ on first use. Raises RuntimeError when g++ is missing or fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        from ..kernels.build import compile_host_source

        lib = ctypes.CDLL(str(compile_host_source(SOURCE)[0]))
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i = ctypes.c_int
        lib.decoder_init.restype = None
        lib.decoder_init.argtypes = [i32p] * 14
        lib.decode_slice.restype = ctypes.c_long
        lib.decode_slice.argtypes = [
            u8p, ctypes.c_long, ctypes.c_long,
            i, i, i, i, i, i, i, i, i, i,
            i32p, i32p,
            i32p, i32p, i32p,
            i32p, i32p, i32p,
            i32p, i32p, i32p, i32p, i32p, i32p,
            u8p, u8p, i32p,
        ]
        lib.dec_block_test.restype = ctypes.c_long
        lib.dec_block_test.argtypes = [u8p, ctypes.c_long, ctypes.c_long, i, i, i32p]
        for name in ("pred16_test", "pred4_test", "predc_test"):
            fn = getattr(lib, name)
            fn.restype = None
            fn.argtypes = [i32p, i, i32p]
        lib.decoder_init(*_decoder_tables())
        _lib = lib
        return lib


def decode_slice_native(lib, dec, rbsp: bytes, bit_pos: int, shd, spec_mode: bool) -> int:
    """Decode one slice's MBs with the native library `lib` (load()) into
    the Decoder `dec`'s state arrays, from bit `bit_pos` of `rbsp` (just
    after the slice header). Returns the final QPy. Raises ValueError (or
    NotImplementedError for I_PCM) on the syntax checks of the Python
    form."""
    data = np.frombuffer(rbsp, np.uint8)
    mbqpd = np.asarray([dec.mb_qp_delta], np.int32)
    qpy_out = np.zeros(1, np.int32)
    is_i = shd.slice_type % 5 == 2
    z32 = np.zeros(1, np.int32)  # placeholder reference for I slices
    refs = (z32, z32, z32) if is_i else (dec.ref_y, dec.ref_cb, dec.ref_cr)
    if any(r is None for r in refs):
        raise ValueError(ERRORS[-10])
    res = lib.decode_slice(
        np.ascontiguousarray(data), len(rbsp), bit_pos,
        shd.slice_type, dec.qpy, dec.wmb, dec.hmb,
        dec.pps.chroma_qp_index_offset,
        int(dec.pps.constrained_intra_pred_flag),
        int(shd.num_ref_idx_active_override_flag),
        int(dec.pps.num_ref_idx_l0_active),
        int(shd.num_ref_idx_l0_active_minus1),
        int(spec_mode),
        mbqpd, dec.stale_chroma_ac.reshape(-1),
        dec.y.reshape(-1), dec.cb.reshape(-1), dec.cr.reshape(-1),
        *(np.ascontiguousarray(r.reshape(-1)) for r in refs),
        dec.mb_type, dec.tc_luma.reshape(-1), dec.tc_chroma.reshape(-1),
        dec.i4x4_mode.reshape(-1), dec.mv.reshape(-1), dec.num_parts,
        dec.mb_intra.view(np.uint8), dec.mb_i4x4.view(np.uint8), qpy_out,
    )
    if res < 0:
        if res == -4:
            raise NotImplementedError(ERRORS[-4])
        raise ValueError(ERRORS.get(int(res), f"native decode error {res}"))
    dec.mb_qp_delta = int(mbqpd[0])
    return int(qpy_out[0])
