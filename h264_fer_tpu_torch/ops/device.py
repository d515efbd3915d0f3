"""Device selection and device-resident spec tables.

The entry points run on the card unless the caller asks for the CPU. A
request for CUDA on a machine without it raises: nothing falls back to the
CPU silently.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

DEFAULT_DEVICE = torch.device("cuda")


def resolve_device(device) -> torch.device:
    """torch.device for `device` (a device, or a string such as "cpu");
    raises RuntimeError for CUDA when no card is visible."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def resolve_devices(devices) -> list:
    """The torch.devices of a device list, each CUDA entry with its index:
    every visible card for None. A device may appear more than once (each
    entry is a lane of its own: n entries of "cuda:0" run n shares or bands
    on one card, n of "cpu" on the CPU). Raises ValueError for an empty
    list, a list that mixes CPU and CUDA entries or a card that is not
    there, and RuntimeError for CUDA without a card."""
    if devices is None:
        resolve_device("cuda")
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("the device list is empty")
    if len({d.type for d in devs}) > 1:
        raise ValueError(f"the device list mixes CPU and CUDA: {devs}")
    devs = [resolve_device(d) for d in devs]
    if devs[0].type == "cuda":
        devs = [torch.device("cuda", torch.cuda.current_device() if d.index is None
                             else d.index) for d in devs]
        missing = [d for d in devs if d.index >= torch.cuda.device_count()]
        if missing:
            raise ValueError(f"no such card: {missing}")
    return devs


def on_card(x) -> bool:
    """Which route a kernel's dispatcher takes for tensor x: False for a
    CPU tensor (the plain twin), True for a CUDA one (the kernel); raises
    ValueError for any other device."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return True


# unbounded: a captured device program (codec/program.py) keeps the
# address of every table it read, so no table may be freed
@functools.lru_cache(maxsize=None)
def _const(data: bytes, dtype: str, shape: tuple, device: torch.device):
    arr = np.frombuffer(data, dtype=np.dtype(dtype)).reshape(shape)
    return torch.from_numpy(arr.copy()).to(device)


def const(array, device) -> torch.Tensor:
    """A small constant numpy table as a tensor on `device`, uploaded once
    per (table, device): a pageable host-to-device copy synchronises the
    stream, so the frame path never uploads a table twice. Callers must
    not write to the returned tensor."""
    a = np.ascontiguousarray(array)
    return _const(a.tobytes(), a.dtype.str, a.shape, torch.device(device))


def upload(plane, device) -> torch.Tensor:
    """A uint8 host plane on `device`: through a pinned host buffer and a
    non-blocking copy when the device is a card, so that the host goes on
    queueing work."""
    plane = np.asarray(plane, dtype=np.uint8)
    out = torch.empty(plane.shape, dtype=torch.uint8, device=device)
    upload_into(out, plane)
    return out


def upload_into(slot, planes) -> None:
    """Copy uint8 host planes into the uint8 tensor `slot` (a device
    program's input slot) on the current stream: `planes` one plane of
    slot's shape, or a sequence of planes that fill its first dimension.
    On a card, through a fresh pinned host buffer and a non-blocking copy,
    so that the host goes on queueing work."""
    host = torch.empty(slot.shape, dtype=torch.uint8,
                       pin_memory=slot.device.type == "cuda")
    arr = host.numpy()
    if isinstance(planes, (list, tuple)):
        if len(planes) != arr.shape[0]:
            raise ValueError(f"{len(planes)} planes for a slot of {arr.shape[0]}")
        for dst, plane in zip(arr, planes):
            dst[...] = plane
    else:
        arr[...] = planes
    slot.copy_(host, non_blocking=True)
