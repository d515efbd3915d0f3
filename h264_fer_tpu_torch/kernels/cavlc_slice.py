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
equal word for word. A slice, band or chroma setup is one launch, counted on
its wrapper's `.launches`, after one fill: the call's workspace is one
torch.empty (`layout`) whose first part (the words, the look-back
descriptors, the ticket counter and flags) the entry point zeroes with one
cudaMemsetAsync; the state outputs are views of its last part.
"""

from __future__ import annotations

import ctypes
import functools

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


MBS_PER_TICKET = 8  # csrc/cavlc_slice.cu kMbs
DESC_WORDS = 4  # int64 look-back descriptor words a ticket (csrc/cavlc_slice.cu step 5)


def tickets(nmb: int) -> int:
    """Tickets of a slice of nmb MBs: runs of MBS_PER_TICKET in raster order."""
    return -(-nmb // MBS_PER_TICKET)


# the C entry point's arguments after `form`: the fields of csrc/cavlc_slice
# .cu's struct Args in order, one 8-byte slot each (a data pointer, 0 for
# null, or an int)
ARGS = ("mode16", "cmode", "i16dc", "i16ac", "choice4", "lv4", "prev_flags", "rem_modes",
        "skip", "ptype", "mvd", "luma", "cdc", "cac", "valid", "top_tc_luma", "top_cbp_luma",
        "top_tc_chroma", "top_cbp_chroma", "run_lead", "run_lead_value", "tabs", "mb_type",
        "cbp_luma", "tc_luma", "cbp_chroma", "tc_chroma", "nz_luma", "mb_bits", "nbits",
        "trail_bits", "words", "nwords", "sync", "desc", "zeroed", "zeroed_bytes", "wmb",
        "nmb", "band")
_SLOT = {name: i for i, name in enumerate(ARGS)}


def _arg(name: str, t, shape, dtype, device):
    """t as a contiguous tensor; ValueError unless it is a `dtype` tensor of
    `shape` on `device`."""
    if (isinstance(t, torch.Tensor) and t.dtype == dtype and t.shape == shape
            and t.is_contiguous() and t.device == device):
        return t
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


_TABS: dict = {}  # the table buffer on each device


def _launch(wrapper, form: str, args: dict, dev) -> None:
    """One call of the C entry point cavlc_slice: `args` by ARGS name (a
    tensor as its data pointer, an int as it is; a missing one 0), the
    table buffer added, packed into one int64 array."""
    tabs = _TABS.get(dev)
    if tabs is None:
        tabs = _TABS[dev] = const(TABLES, dev)
    slots = [0] * len(ARGS)
    slots[_SLOT["tabs"]] = tabs.data_ptr()
    for name, v in args.items():
        slots[_SLOT[name]] = v.data_ptr() if isinstance(v, torch.Tensor) else v
    slots = np.array(slots, dtype=np.int64)
    build.launch(wrapper, "cavlc_slice", "cavlc_slice", [FORMS[form], slots, len(ARGS)], dev)


# each form's state outputs: int32 words an MB (nz_luma: 16 bools), and shape
STATE = {"i16": ("mb_type", "cbp_luma", "tc_luma", "cbp_chroma", "tc_chroma"),
         "mixed": ("mb_type", "nz_luma"),
         "p": ("cbp_luma", "tc_luma", "cbp_chroma", "tc_chroma", "nz_luma", "trail_bits"),
         "chroma": ("cbp_chroma", "tc_chroma", "mb_bits")}
_PER_MB = {"mb_type": 1, "cbp_luma": 1, "tc_luma": 16, "cbp_chroma": 1, "tc_chroma": 8,
           "nz_luma": 4, "mb_bits": 1, "trail_bits": 0}


@functools.lru_cache(maxsize=64)
def layout(form: str, nmb: int) -> tuple:
    """The call's workspace, one int64 buffer: (its length, the words'
    length with one spare word past n_words, as pack_symbols has (0 for the
    chroma setup), the words before the state outputs, which the entry
    point zeroes: words, nbits, the look-back descriptors (DESC_WORDS a
    ticket) and the int32 ticket counter and state flags; then {state
    output: (int32 offset, shape, stride)})."""
    nt = tickets(nmb)
    nw = 0 if form == "chroma" else n_words(form, nmb) + 1
    ndesc = 0 if form == "chroma" else DESC_WORDS * nt
    zeroed = nw + 1 + ndesc + (nt + 2) // 2
    shapes = {"tc_luma": (nmb, 16), "tc_chroma": (2, nmb, 4), "nz_luma": (nmb, 16),
              "trail_bits": ()}
    state, at = {}, 2 * zeroed
    for k in STATE[form]:
        shape = shapes.get(k, (nmb,))
        state[k] = (at, shape, tuple(int(np.prod(shape[i + 1:])) for i in range(len(shape))))
        at += _PER_MB[k] * nmb or 1
    return (at + 1) // 2, nw, zeroed, state


def workspace(form: str, nmb: int, dev) -> tuple:
    """The call's workspace (layout; torch.empty, the entry point zeroes
    its first part) and its arguments: the words, nbits and the state
    outputs as views, the addresses of the descriptors, the flags and the
    zeroed part. Returns (buffer, {ARGS name: tensor or int})."""
    n, nw, zeroed, state = layout(form, nmb)
    ws = torch.empty(n, dtype=I64, device=dev)
    base = ws.data_ptr()
    out = {"words": base, "nwords": nw, "desc": base + 8 * (nw + 1),
           "sync": base + 8 * (zeroed - (tickets(nmb) + 2) // 2), "zeroed": base,
           "zeroed_bytes": 8 * zeroed}
    if form != "chroma":
        out["nbits"] = ws[nw]
    ws32 = ws.view(I32)
    for k, (at, shape, stride) in state.items():
        out[k] = (ws.view(torch.bool).as_strided(shape, stride, 4 * at) if k == "nz_luma"
                  else ws32.as_strided(shape, stride, at))
    return ws, out


# each slice form's keys after words and nbits, in its plain twin's order
KEYS = {"i16": ("mb_type", "cbp_luma", "cbp_chroma", "tc_luma", "tc_chroma"),
        "mixed": ("mb_type", "cbp_luma", "cbp_chroma", "tc_luma", "tc_chroma", "nz_luma"),
        "p": ("trail_bits", "cbp_luma", "cbp_chroma", "tc_luma", "tc_chroma", "nz_luma")}


def fill(form: str, nmb: int, dev):
    """A workspace of the form for nmb MBs, its first part zeroed by the
    fill a call makes (cudaMemsetAsync), alone: no kernel. For timing the
    fill apart from the call."""
    ws, args = workspace(form, nmb, dev)
    fn = build.function("cavlc_slice", "cavlc_slice_fill",
                        (ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p))
    err = fn(args["zeroed"], args["zeroed_bytes"], build.current_stream_handle(dev))
    if err:
        raise RuntimeError(f"cavlc_slice_fill failed: CUDA error {err}")
    return ws


def _slice_out(form: str, ws, args: dict) -> dict:
    """The words in full (the plain twin's length), nbits and the form's
    KEYS."""
    return {"words": ws[: n_words(form, args["nmb"])], "nbits": args["nbits"],
            **{k: args[k] for k in KEYS[form]}}


def chroma_entropy(cdc, cac, wmb: int, hmb: int, top_ctx=None) -> dict:
    """K10's chroma setup (chroma_setup_plain's cbp_chroma, tc_chroma and
    bits) of CUDA tensors cdc (2, nmb, 4), cac (2, nmb, 4, 15) int32;
    top_ctx: None or the row above's (tc_chroma (2, wmb, 4), cbp_chroma
    (wmb,)). One launch."""
    dev = _device(cdc)
    nmb = _grid(wmb, hmb)
    args = workspace("chroma", nmb, dev)[1]
    args.update(_chroma_in(cdc, cac, nmb, dev), wmb=wmb, nmb=nmb)
    if top_ctx is not None:
        args.update(_top(top_ctx, wmb, dev, chroma_only=True))
    _launch(chroma_entropy, "chroma", args, dev)
    return {"cbp_chroma": args["cbp_chroma"], "tc_chroma": args["tc_chroma"],
            "bits": args["mb_bits"]}


def i16_entropy(mode16, cmode, i16dc, i16ac, cdc, cac, wmb: int, hmb: int, top_ctx=None,
                valid=None) -> dict:
    """K10 on an all-I16 slice: i16_slice_entropy_plain's function and keys
    (words, nbits, mb_type, cbp_luma, cbp_chroma, tc_luma, tc_chroma).
    One launch."""
    dev = _device(mode16)
    nmb = _grid(wmb, hmb)
    ws, slots = workspace("i16", nmb, dev)
    args = {"mode16": _arg("mode16", mode16, (nmb,), I32, dev),
            "cmode": _arg("cmode", cmode, (nmb,), I32, dev),
            "i16dc": _arg("i16dc", i16dc, (nmb, 16), I32, dev),
            "i16ac": _arg("i16ac", i16ac, (nmb, 16, 15), I32, dev),
            **_chroma_in(cdc, cac, nmb, dev), **_top(top_ctx, wmb, dev), **slots,
            "wmb": wmb, "nmb": nmb}
    if valid is not None:
        args["valid"] = _arg("valid", valid, (nmb,), torch.bool, dev)
    _launch(i16_entropy, "i16", args, dev)
    return _slice_out("i16", ws, args)


def mixed_entropy(choice4, mode16, cmode, i16dc, i16ac, lv4, prev_flags, rem_modes,
                  cbp_luma, tc_luma, cdc, cac, wmb: int, hmb: int, top_ctx=None,
                  valid=None, chroma=None) -> dict:
    """K10 on a mixed I4x4/I16 slice: mixed_slice_entropy_plain's function
    and keys (words, nbits, mb_type, cbp_luma, cbp_chroma, tc_luma,
    tc_chroma, nz_luma). chroma (required, as by the twin): the slice's
    chroma setup, whose cbp_chroma and tc_chroma it reads (chroma_setup of
    the same cdc, cac and top_ctx); ValueError when None. One launch."""
    dev = _device(choice4)
    nmb = _grid(wmb, hmb)
    if chroma is None:
        raise ValueError("chroma: K10's mixed form takes the slice's chroma setup "
                         "(chroma_setup of the same cdc, cac and top_ctx)")
    ws, slots = workspace("mixed", nmb, dev)
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
            **_chroma_in(cdc, cac, nmb, dev), **_top(top_ctx, wmb, dev),
            "cbp_chroma": _arg("chroma cbp_chroma", chroma["cbp_chroma"], (nmb,), I32, dev),
            "tc_chroma": _arg("chroma tc_chroma", chroma["tc_chroma"], (2, nmb, 4), I32,
                              dev),
            **slots, "wmb": wmb, "nmb": nmb}
    if valid is not None:
        args["valid"] = _arg("valid", valid, (nmb,), torch.bool, dev)
    _launch(mixed_entropy, "mixed", args, dev)
    return _slice_out("mixed", ws, args)


def p_entropy(skip, mb_type, mvd, luma_levels, cdc, cac, wmb: int, hmb: int, top_ctx=None,
              run_lead=None) -> dict:
    """K10 on a P slice: p_slice_entropy_plain's function and keys (words,
    nbits, trail_bits, cbp_luma, cbp_chroma, tc_luma, tc_chroma, nz_luma).
    run_lead: None for a whole slice, else a band's (an int, or a one-element
    integer tensor on the card, read there). One launch."""
    dev = _device(skip)
    nmb = _grid(wmb, hmb)
    ws, slots = workspace("p", nmb, dev)
    args = {"skip": _arg("skip", skip, (nmb,), torch.bool, dev),
            "ptype": _arg("mb_type", mb_type, (nmb,), I32, dev),
            "mvd": _arg("mvd", mvd, (nmb, 4, 2), I32, dev),
            "luma": _arg("luma_levels", luma_levels, (nmb, 16, 16), I32, dev),
            **_chroma_in(cdc, cac, nmb, dev), **_top(top_ctx, wmb, dev), **slots,
            "wmb": wmb, "nmb": nmb}
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
    return _slice_out("p", ws, args)


# kernel launches so far, counted by the C entry point: one per slice, band
# or chroma setup
chroma_entropy.launches = 0
i16_entropy.launches = 0
mixed_entropy.launches = 0
p_entropy.launches = 0
