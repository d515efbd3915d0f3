"""Device programs: a frame or GOP function run as one captured CUDA graph.

The counterpart of the reference's compiled entry points, the jax.jit of
codec/tpu_iframe.device_i16_frame_impl and device_mixed_frame_impl,
tpu_pframe.device_p_frame_impl and tpu_gop.device_gop_ippp_impl: XLA
compiles each into one program per static key and the host launches it
once a frame or GOP. A `DeviceProgram` holds one body, a plain function
of tensors, for one static key (frame size, QP, window, MAXDIFF,
prefilter, mode, GOP length, device), with its static input slots and its
static outputs; `program` keeps one per key for one lane.

On a card, a program's first call warms the body up once on a side stream
(which builds the kernels, fills the ops.device.const tables and sizes the
persistent grids of K2, K10 and K13), captures it with torch.cuda.CUDAGraph
and replays it; every later call is the input copies and one replay, so the
Python wrappers, the ctypes calls and the eager allocations leave the
per-frame path. The warm-up and the capture run on a stream of the
program's own card, so that a lane on any card captures its own work. A
capture that fails raises: a program on a card never runs its launches
eagerly, unless it was made while `DeviceProgram.graphs` was False (a
check's eager baseline, chip_smoke.py). On the CPU (the tests) the plain
form runs the same body eagerly into the same slots and outputs.

The rules a body keeps:
- it reads nothing back (no .item(), .cpu() or int() of a tensor) and
  makes no host-to-device copy but through ops.device.const;
- every buffer a kernel expects fresh is made inside the body (the
  dataflow scratch, K4x4's edge slots, K10's workspace), so that its
  allocation and zeroing are captured and run again on every replay;
- state that outlives a call is a slot the body updates in place.

A replay overwrites the static outputs, and the encoders queue every
frame before they read the first payload. So a call copies the outputs
named in `keep` into fresh tensors on the calling stream, after the
replay: one device copy of each whole tensor (a payload's `words` is
sized for the worst case, so the copy moves all of it, not the used
words, which the host does not know before its read-back); the other
outputs are the static ones, valid until the next call. Each replay
adds the launches it captured to each kernel wrapper's `launches`; the
warm-up and the capture add none. While the class attribute `spans` is a
list, each replay appends to it the pair of CUDA events recorded around
it on the calling stream: the device time of the replays, for a busy
share that needs no profiler over them (torch.profiler's CUPTI tracing
has crashed the process in a graph replay on an H100).
"""

from __future__ import annotations

import time

import torch


def counters() -> list:
    """Every kernel wrapper that counts its launches (a `launches`
    attribute), each once."""
    from ..kernels import (cavlc_slice, deblock, interp, mc, me_int, me_qpel, me_topk,
                           mode_decision, residual_p, wavefront_i16, wavefront_i4x4,
                           wavefront_mixed, wavefront_p)

    found = {}
    for mod in (cavlc_slice, deblock, interp, mc, me_int, me_qpel, me_topk, mode_decision,
                residual_p, wavefront_i16, wavefront_i4x4, wavefront_mixed, wavefront_p):
        for fn in vars(mod).values():
            if callable(fn) and hasattr(fn, "launches"):
                found[id(fn)] = fn
    return list(found.values())


def _leaves(x) -> list:
    """The tensors of a tensor or a list / tuple of tensors, in order."""
    return list(x) if isinstance(x, (list, tuple)) else [x]


def fill(dst, src) -> None:
    """Copy src into dst, tensor by tensor (a tensor or a list or tuple of
    them), on the current stream."""
    for d, s in zip(_leaves(dst), _leaves(src), strict=True):
        if d is not s:
            d.copy_(s, non_blocking=True)


def _clone(x):
    if isinstance(x, (list, tuple)):
        return type(x)(t.clone() for t in x)
    return x.clone()


class DeviceProgram:
    """One body for one static key on one device.

    body(**slots) returns a dict of tensors or lists of tensors; slots
    maps each argument to its static tensor (or list of tensors), which a
    call fills (`__call__`'s keyword arguments, or the caller writing into
    `slots` first). keep: the outputs a call copies out unless it names
    others. A program on a card is a captured graph, unless it was made
    while the class attribute `graphs` was False: then it runs the plain
    form there too (the eager launches a check compares replays with)."""

    graphs = True
    spans = None

    def __init__(self, body, slots: dict, keep=()) -> None:
        self.body = body
        self.slots = slots
        self.keep = tuple(keep)
        leaves = [t for v in slots.values() for t in _leaves(v)]
        self.device = leaves[0].device
        if any(t.device != self.device for t in leaves):
            raise ValueError("a program's slots must lie on one device")
        self.graph = DeviceProgram.graphs and self.device.type == "cuda"
        self.outputs = None  # the static outputs
        self.cuda_graph = None
        self.captured = {}  # wrapper → launches a replay makes
        self.capture_ms = None  # warm-up and capture, host clock

    def __call__(self, keep=None, **inputs) -> dict:
        """Fill the slots named in `inputs`, run the body (a replay on a
        card) and return its outputs: those named in `keep` (None: the
        program's `keep`) copied, the rest static."""
        keep = self.keep if keep is None else tuple(keep)
        for name, value in inputs.items():
            fill(self.slots[name], value)
        if not self.graph:
            self._plain()
        else:
            if self.cuda_graph is None:
                self._capture()
            if DeviceProgram.spans is None:
                self.cuda_graph.replay()
            else:
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                self.cuda_graph.replay()
                end.record()
                DeviceProgram.spans.append((start, end))
            for fn, n in self.captured.items():
                fn.launches += n
        return {k: _clone(v) if k in keep else v for k, v in self.outputs.items()}

    def _plain(self) -> None:
        """The body, eagerly, its results copied into the static outputs
        (the first call's results become them)."""
        out = self.body(**self.slots)
        if self.outputs is None:
            self.outputs = out
        else:
            for k, v in out.items():
                fill(self.outputs[k], v)

    def _warm_up(self) -> None:
        """Run the body once, eagerly, on the current stream, and put back
        every slot as it was: a body may update its state slots in place,
        and the replay that follows the capture is the call's one run. The
        outputs are dropped."""
        leaves = [t for v in self.slots.values() for t in _leaves(v)]
        saved = [t.clone() for t in leaves]
        self.body(**self.slots)
        for t, before in zip(leaves, saved):
            t.copy_(before)

    def _capture(self) -> None:
        """Warm the body up on a side stream of the program's card, then
        capture it on that stream (torch.cuda.graph's own default stream
        lies on the card of the process's first capture); the launch
        counts go back to what they were, and `captured` keeps the
        capture's."""
        fns = counters()
        before = [fn.launches for fn in fns]
        t0 = time.perf_counter()
        dev = self.device
        with torch.cuda.device(dev):
            caller = torch.cuda.current_stream(dev)
            side = torch.cuda.Stream(dev)
            side.wait_stream(caller)
            with torch.cuda.stream(side):
                self._warm_up()
            caller.wait_stream(side)
            warm = [fn.launches for fn in fns]
            graph = torch.cuda.CUDAGraph()
            try:
                # synchronises the card, then captures on `side`
                with torch.cuda.graph(graph, stream=side):
                    outputs = self.body(**self.slots)
            finally:
                captured = {fn: fn.launches - w for fn, w in zip(fns, warm)}
                for fn, b in zip(fns, before):
                    fn.launches = b
        self.captured = {fn: n for fn, n in captured.items() if n}
        self.outputs = outputs
        self.cuda_graph = graph
        self.capture_ms = (time.perf_counter() - t0) * 1e3


def program(programs: dict, key: tuple, make, limit: int | None = None) -> DeviceProgram:
    """The program of `key` in `programs` (one lane's, or one session's),
    made by make() on first use. Two lanes hold two instances of one key:
    two replays of one graph at once would share its buffers. limit: the
    most programs `programs` keeps; a new key past it drops the least
    recently used one (its graph and the memory pool of its outputs, once
    its last replay has ended)."""
    prog = programs.pop(key, None)
    if prog is None:
        if limit is not None and len(programs) >= limit:
            old = programs.pop(next(iter(programs)))
            if old.cuda_graph is not None:
                torch.cuda.synchronize(old.device)
        prog = make()
    programs[key] = prog  # the most recently used last
    return prog


def planes(shape: tuple, device, n: int | None = None):
    """Input slots of uint8 planes: one (shape) tensor, or for n frames
    one (n, *shape) tensor, whose frames the GOP body takes as views."""
    full = shape if n is None else (n, *shape)
    return torch.empty(full, dtype=torch.uint8, device=device)
