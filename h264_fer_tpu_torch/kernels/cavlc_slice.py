"""Whole-slice CAVLC (K10): every macroblock_layer symbol of a slice packed
into its payload words on the card.

`i16_entropy`, `mixed_entropy`, `p_entropy` and `chroma_entropy` are the
wrappers of the CUDA kernel csrc/cavlc_slice.cu, the device form of the XLA
programs h264_fer_tpu/codec/tpu_entropy.py i16_slice_entropy_impl (:433),
mixed_slice_entropy_impl (:185), p_slice_entropy_impl (:298) and
chroma_setup (:153) over ops/cavlc_jax.py (block_symbols_bulk :82,
finalize_symbols :243, pack_symbols :271), which no Pallas kernel
replaced. They take CUDA tensors only: codec/entropy.py's public functions
send a CPU tensor to their plain twins (the *_plain functions there) and a
CUDA one here, and each wrapper returns every key its plain twin returns,
equal word for word. A slice or band is four launches (state, sizes, the
offset scan, the symbols), the chroma setup alone two, each counted on its
wrapper's `.launches`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.cavlc_bulk import MAX_SYMBOL_BITS
from ..ops.cavlc_tables import (
    COEFF_TOKEN_BITS,
    COEFF_TOKEN_LEN,
    RUN_BEFORE_BITS,
    RUN_BEFORE_LEN,
    TOTAL_ZEROS_BITS,
    TOTAL_ZEROS_CDC_BITS,
    TOTAL_ZEROS_CDC_LEN,
    TOTAL_ZEROS_LEN,
)
from ..ops.device import const
from ..ops.tables import CBP_TO_CODENUM_INTER, CBP_TO_CODENUM_INTRA
from . import build

I32, I64 = torch.int32, torch.int64

# the kernel's tables, one int32 buffer in this order (csrc/cavlc.cuh names
# each offset k<Name>); the first four are K6's (kernels/wavefront_mixed
# .TABLES)
TABLE_PARTS = (("CtLen", COEFF_TOKEN_LEN), ("TzLen", TOTAL_ZEROS_LEN),
               ("RbLen", RUN_BEFORE_LEN), ("CbpIntra", CBP_TO_CODENUM_INTRA),
               ("CtBits", COEFF_TOKEN_BITS), ("TzBits", TOTAL_ZEROS_BITS),
               ("RbBits", RUN_BEFORE_BITS), ("TzCdcLen", TOTAL_ZEROS_CDC_LEN),
               ("TzCdcBits", TOTAL_ZEROS_CDC_BITS), ("CbpInter", CBP_TO_CODENUM_INTER))
TABLES = np.concatenate([np.asarray(t).reshape(-1) for _, t in TABLE_PARTS]).astype(np.int32)
OFFSETS = dict(zip([name for name, _ in TABLE_PARTS],
                   np.cumsum([0] + [np.size(t) for _, t in TABLE_PARTS[:-1]]).tolist()))

FORMS = {"i16": 0, "mixed": 1, "p": 2, "chroma": 3}


def block_slots(n: int) -> int:
    """Symbol slots of a block of n levels in the plain twins' streams
    (ops/cavlc_bulk.block_symbols_bulk): coeff_token, the signs, n level
    codes, total_zeros and n - 1 run_befores."""
    return 2 * n + 2


CHROMA_SLOTS = 2 * block_slots(4) + 8 * block_slots(15)
# symbol slots per MB of each form's plain stream: the header, the luma
# blocks, the chroma blocks
MB_SLOTS = {"i16": 3 + block_slots(16) + 16 * block_slots(15) + CHROMA_SLOTS,
            "mixed": 1 + 16 + 3 + block_slots(16) + 16 * block_slots(16) + CHROMA_SLOTS,
            "p": 16 + 16 * block_slots(16) + CHROMA_SLOTS}


def n_words(form: str, nmb: int) -> int:
    """Length of the plain twin's `words` for a slice of nmb MBs
    (pack_symbols' worst case: MAX_SYMBOL_BITS a slot); P's stream has one
    slot more, the trailing skip run."""
    return (nmb * MB_SLOTS[form] + (form == "p")) * MAX_SYMBOL_BITS // 64 + 2


# the C entry point's arguments after `form`, in order; the ints among them
ARGS = ("mode16", "cmode", "i16dc", "i16ac", "choice4", "lv4", "prev_flags", "rem_modes",
        "skip", "ptype", "mvd", "luma", "cdc", "cac", "valid", "chroma_bits",
        "top_tc_luma", "top_cbp_luma", "top_tc_chroma", "top_cbp_chroma", "run_lead",
        "run_lead_value", "tabs", "mb_type", "cbp_luma", "tc_luma", "cbp_chroma",
        "tc_chroma", "nz_luma", "mb_bits", "run", "offs", "nbits", "trail_bits", "words",
        "nwords", "wmb", "nmb", "band")
INT_ARGS = ("run_lead_value", "nwords", "wmb", "nmb", "band")


def _arg(name: str, t, shape, dtype, device):
    """t as a contiguous tensor; ValueError unless it is a `dtype` tensor of
    `shape` on `device`."""
    if not isinstance(t, torch.Tensor):
        raise ValueError(f"{name}: expected a tensor, got {type(t).__name__}")
    t = t.contiguous()
    build.check_tensor(name, t, shape, dtype, device)
    return t


def _device(t) -> torch.device:
    """The CUDA device of the first input; ValueError for any other."""
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError("K10 takes CUDA tensors; codec/entropy.py sends CPU tensors to "
                         "the plain twins")
    return t.device


def _grid(wmb: int, hmb: int) -> int:
    if wmb <= 0 or hmb <= 0:
        raise ValueError(f"grid of {wmb}x{hmb} MBs")
    return wmb * hmb


def _chroma_in(cdc, cac, nmb: int, dev) -> dict:
    return {"cdc": _arg("cdc", cdc, (2, nmb, 4), I32, dev),
            "cac": _arg("cac", cac, (2, nmb, 4, 15), I32, dev)}


def _top(top_ctx, wmb: int, dev, chroma_only: bool = False) -> dict:
    """The halo arguments of top_ctx: (tc_luma (wmb, 16), cbp_luma (wmb,),
    tc_chroma (2, wmb, 4), cbp_chroma (wmb,)), or its last two alone for
    the chroma setup; None: no halo."""
    names = ("top_tc_luma", "top_cbp_luma", "top_tc_chroma", "top_cbp_chroma")
    shapes = ((wmb, 16), (wmb,), (2, wmb, 4), (wmb,))
    if chroma_only:
        names, shapes = names[2:], shapes[2:]
    if top_ctx is None:
        return {}
    if len(top_ctx) != len(names):
        raise ValueError(f"top_ctx: expected {len(names)} tensors, got {len(top_ctx)}")
    return {n: _arg(n, t, s, I32, dev) for n, t, s in zip(names, top_ctx, shapes)}


def _launch(wrapper, form: str, args: dict, dev) -> None:
    """One call of the C entry point cavlc_slice: `args` by ARGS name (a
    missing pointer is null, a missing int 0), the table buffer added."""
    args = {**args, "tabs": const(TABLES, dev)}
    vals = [FORMS[form]] + [args.get(n, 0 if n in INT_ARGS else None) for n in ARGS]
    build.launch(wrapper, "cavlc_slice", "cavlc_slice", vals, dev)


def _state(nmb: int, dev, *keys) -> dict:
    shapes = {"mb_type": (nmb,), "cbp_luma": (nmb,), "tc_luma": (nmb, 16),
              "cbp_chroma": (nmb,), "tc_chroma": (2, nmb, 4), "mb_bits": (nmb,),
              "run": (nmb,), "trail_bits": ()}
    out = {k: torch.empty(shapes[k], dtype=I32, device=dev) for k in keys if k in shapes}
    if "nz_luma" in keys:
        out["nz_luma"] = torch.empty((nmb, 16), dtype=torch.bool, device=dev)
    return out


def _payload(form: str, nmb: int, dev) -> dict:
    """The zeroed words (one spare word past the plain twin's length, as
    pack_symbols has), nbits and the MB offsets."""
    nw = n_words(form, nmb)
    return {"words": torch.zeros(nw + 1, dtype=I64, device=dev), "nwords": nw + 1,
            "nbits": torch.empty((), dtype=I64, device=dev),
            "offs": torch.empty(nmb, dtype=I64, device=dev)}


def chroma_entropy(cdc, cac, wmb: int, hmb: int, top_ctx=None) -> dict:
    """K10's chroma setup (chroma_setup_plain's cbp_chroma, tc_chroma and
    bits) of CUDA tensors cdc (2, nmb, 4), cac (2, nmb, 4, 15) int32;
    top_ctx: None or the row above's (tc_chroma (2, wmb, 4), cbp_chroma
    (wmb,)). Two launches."""
    dev = _device(cdc)
    nmb = _grid(wmb, hmb)
    args = {**_chroma_in(cdc, cac, nmb, dev), **_top(top_ctx, wmb, dev, chroma_only=True),
            **_state(nmb, dev, "cbp_chroma", "tc_chroma", "mb_bits"), "wmb": wmb, "nmb": nmb}
    _launch(chroma_entropy, "chroma", args, dev)
    return {"cbp_chroma": args["cbp_chroma"], "tc_chroma": args["tc_chroma"],
            "bits": args["mb_bits"]}


def i16_entropy(mode16, cmode, i16dc, i16ac, cdc, cac, wmb: int, hmb: int, top_ctx=None,
                valid=None) -> dict:
    """K10 on an all-I16 slice: i16_slice_entropy_plain's function and keys
    (words, nbits, mb_type, cbp_luma, cbp_chroma, tc_luma, tc_chroma).
    Four launches."""
    dev = _device(mode16)
    nmb = _grid(wmb, hmb)
    args = {"mode16": _arg("mode16", mode16, (nmb,), I32, dev),
            "cmode": _arg("cmode", cmode, (nmb,), I32, dev),
            "i16dc": _arg("i16dc", i16dc, (nmb, 16), I32, dev),
            "i16ac": _arg("i16ac", i16ac, (nmb, 16, 15), I32, dev),
            **_chroma_in(cdc, cac, nmb, dev), **_top(top_ctx, wmb, dev),
            **_state(nmb, dev, "mb_type", "cbp_luma", "tc_luma", "cbp_chroma", "tc_chroma",
                     "mb_bits"),
            **_payload("i16", nmb, dev), "wmb": wmb, "nmb": nmb}
    if valid is not None:
        args["valid"] = _arg("valid", valid, (nmb,), torch.bool, dev)
    _launch(i16_entropy, "i16", args, dev)
    return {"words": args["words"][:-1], "nbits": args["nbits"],
            **{k: args[k] for k in ("mb_type", "cbp_luma", "cbp_chroma", "tc_luma",
                                    "tc_chroma")}}


def mixed_entropy(choice4, mode16, cmode, i16dc, i16ac, lv4, prev_flags, rem_modes,
                  cbp_luma, tc_luma, cdc, cac, wmb: int, hmb: int, top_ctx=None,
                  valid=None, chroma=None) -> dict:
    """K10 on a mixed I4x4/I16 slice: mixed_slice_entropy_plain's function
    and keys (words, nbits, mb_type, cbp_luma, cbp_chroma, tc_luma,
    tc_chroma, nz_luma). chroma (required): the slice's chroma setup,
    chroma_entropy's dict for the same cdc, cac and top_ctx; ValueError
    when None. Four launches."""
    dev = _device(choice4)
    nmb = _grid(wmb, hmb)
    if chroma is None:
        raise ValueError("chroma: K10's mixed form takes the slice's chroma setup "
                         "(chroma_setup of the same cdc, cac and top_ctx)")
    args = {"choice4": _arg("choice4", choice4, (nmb,), torch.bool, dev),
            "mode16": _arg("mode16", mode16, (nmb,), I32, dev),
            "cmode": _arg("cmode", cmode, (nmb,), I32, dev),
            "i16dc": _arg("i16dc", i16dc, (nmb, 16), I32, dev),
            "i16ac": _arg("i16ac", i16ac, (nmb, 16, 15), I32, dev),
            "lv4": _arg("lv4", lv4, (nmb, 16, 16), I32, dev),
            "prev_flags": _arg("prev_flags", prev_flags, (nmb, 16), torch.bool, dev),
            "rem_modes": _arg("rem_modes", rem_modes, (nmb, 16), I32, dev),
            "cbp_luma": _arg("cbp_luma", cbp_luma, (nmb,), I32, dev),
            "tc_luma": _arg("tc_luma", tc_luma, (nmb, 16), I32, dev),
            **_chroma_in(cdc, cac, nmb, dev), **_top(top_ctx, wmb, dev)}
    if valid is not None:
        args["valid"] = _arg("valid", valid, (nmb,), torch.bool, dev)
    args.update(cbp_chroma=_arg("chroma cbp_chroma", chroma["cbp_chroma"], (nmb,), I32, dev),
                tc_chroma=_arg("chroma tc_chroma", chroma["tc_chroma"], (2, nmb, 4), I32, dev),
                chroma_bits=_arg("chroma bits", chroma["bits"], (nmb,), I32, dev),
                **_state(nmb, dev, "mb_type", "nz_luma", "mb_bits"),
                **_payload("mixed", nmb, dev), wmb=wmb, nmb=nmb)
    _launch(mixed_entropy, "mixed", args, dev)
    return {"words": args["words"][:-1], "nbits": args["nbits"],
            **{k: args[k] for k in ("mb_type", "cbp_luma", "cbp_chroma", "tc_luma",
                                    "tc_chroma", "nz_luma")}}


def p_entropy(skip, mb_type, mvd, luma_levels, cdc, cac, wmb: int, hmb: int, top_ctx=None,
              run_lead=None) -> dict:
    """K10 on a P slice: p_slice_entropy_plain's function and keys (words,
    nbits, trail_bits, cbp_luma, cbp_chroma, tc_luma, tc_chroma, nz_luma).
    run_lead: None for a whole slice, else a band's (an int, or a one-element
    integer tensor on the card, read there). Four launches."""
    dev = _device(skip)
    nmb = _grid(wmb, hmb)
    args = {"skip": _arg("skip", skip, (nmb,), torch.bool, dev),
            "ptype": _arg("mb_type", mb_type, (nmb,), I32, dev),
            "mvd": _arg("mvd", mvd, (nmb, 4, 2), I32, dev),
            "luma": _arg("luma_levels", luma_levels, (nmb, 16, 16), I32, dev),
            **_chroma_in(cdc, cac, nmb, dev), **_top(top_ctx, wmb, dev),
            **_state(nmb, dev, "cbp_luma", "tc_luma", "cbp_chroma", "tc_chroma", "nz_luma",
                     "mb_bits", "run", "trail_bits"),
            **_payload("p", nmb, dev), "wmb": wmb, "nmb": nmb}
    if isinstance(run_lead, torch.Tensor):
        if run_lead.numel() != 1 or run_lead.device != dev or run_lead.is_floating_point():
            raise ValueError(f"run_lead: expected one integer on {dev}, got "
                             f"{run_lead.dtype} {tuple(run_lead.shape)} on {run_lead.device}")
        args.update(run_lead=run_lead.reshape(1).to(I64), band=1)
    elif run_lead is not None:
        if not -2**31 <= int(run_lead) < 2**31:
            raise ValueError(f"run_lead {run_lead} outside int32")
        args.update(run_lead_value=int(run_lead), band=1)
    _launch(p_entropy, "p", args, dev)
    return {"words": args["words"][:-1], "nbits": args["nbits"],
            **{k: args[k] for k in ("trail_bits", "cbp_luma", "cbp_chroma", "tc_luma",
                                    "tc_chroma", "nz_luma")}}


# kernel launches so far, counted by the C entry point: four per slice or
# band, two per chroma setup
chroma_entropy.launches = 0
i16_entropy.launches = 0
mixed_entropy.launches = 0
p_entropy.launches = 0
