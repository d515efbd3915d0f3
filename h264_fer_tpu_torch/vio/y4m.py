"""Y4M (YUV4MPEG2) frame input and output, raw YUV and PSNR (reference
fileIO.cpp).

Frames are 8-bit 4:2:0 planar: Y (H, W), Cb (H/2, W/2), Cr (H/2, W/2) as
NumPy uint8 arrays. The reader center-crops input to multiples of 16 in
both dimensions, as the reference does (ReadFromY4M, fileIO.cpp:290-312), so
that encoder inputs match.

A copy of h264_fer_tpu/vio/y4m.py: the reader, Y4MWriter (the decoder's
output), the raw planar write_yuv / read_yuv and psnr.
"""

from __future__ import annotations

import io
from dataclasses import dataclass

import numpy as np


@dataclass
class Y4MHeader:
    width: int
    height: int
    fps_num: int = 24
    fps_den: int = 1


def _parse_header_line(line: bytes) -> Y4MHeader:
    if not line.startswith(b"YUV4MPEG2"):
        raise ValueError("not a Y4M stream")
    w = h = None
    fn, fd = 24, 1
    for tok in line.split()[1:]:
        if tok[:1] == b"W":
            w = int(tok[1:])
        elif tok[:1] == b"H":
            h = int(tok[1:])
        elif tok[:1] == b"F":
            parts = tok[1:].split(b":")
            fn, fd = int(parts[0]), int(parts[1])
    if w is None or h is None:
        raise ValueError("Y4M header missing W/H")
    return Y4MHeader(w, h, fn, fd)


class Y4MReader:
    """Iterates (Y, Cb, Cr) uint8 frames from a Y4M stream.

    With `crop_to_mb=True` (the reference's behavior,
    fileIO.cpp:240-252,290-312), frames are center-cropped to multiples of
    16, with the left/top crop rounded down to even so chroma stays aligned.
    """

    def __init__(self, f, crop_to_mb: bool = True) -> None:
        if isinstance(f, (str, bytes)) and not isinstance(f, bytes):
            f = open(f, "rb")
        elif isinstance(f, bytes):
            f = io.BytesIO(f)
        self.f = f
        self.header = _parse_header_line(self._read_line())
        self.crop_to_mb = crop_to_mb
        w, h = self.header.width, self.header.height
        if crop_to_mb:
            self.width, self.height = (w // 16) * 16, (h // 16) * 16
            # center crop, offsets exactly as the reference computes them
            # (fileIO.cpp:290-293: cropTop=(diff)>>1, chroma crop = cropTop>>1)
            self._x0 = (w - self.width) >> 1
            self._y0 = (h - self.height) >> 1
        else:
            if w % 16 or h % 16:
                raise ValueError("frame size not multiple of 16; use crop_to_mb")
            self.width, self.height = w, h
            self._x0 = self._y0 = 0

    def _read_line(self) -> bytes:
        out = bytearray()
        while True:
            b = self.f.read(1)
            if not b or b == b"\n":
                return bytes(out)
            out += b

    def read_frame(self):
        line = self._read_line()
        if not line:
            return None
        if not line.startswith(b"FRAME"):
            raise ValueError(f"bad FRAME marker: {line!r}")
        w, h = self.header.width, self.header.height
        ysz, csz = w * h, (w // 2) * (h // 2)
        raw = self.f.read(ysz + 2 * csz)
        if len(raw) < ysz + 2 * csz:
            return None
        y = np.frombuffer(raw, np.uint8, ysz).reshape(h, w)
        cb = np.frombuffer(raw, np.uint8, csz, ysz).reshape(h // 2, w // 2)
        cr = np.frombuffer(raw, np.uint8, csz, ysz + csz).reshape(h // 2, w // 2)
        x0, y0, cw, ch = self._x0, self._y0, self.width, self.height
        cx0, cy0 = x0 >> 1, y0 >> 1
        y = y[y0 : y0 + ch, x0 : x0 + cw]
        cb = cb[cy0 : cy0 + ch // 2, cx0 : cx0 + cw // 2]
        cr = cr[cy0 : cy0 + ch // 2, cx0 : cx0 + cw // 2]
        return np.ascontiguousarray(y), np.ascontiguousarray(cb), np.ascontiguousarray(cr)

    def __iter__(self):
        while True:
            fr = self.read_frame()
            if fr is None:
                return
            yield fr


class Y4MWriter:
    """Writes (Y, Cb, Cr) uint8 frames as a Y4M stream, with the header
    parameters of the reference writer (fileIO.cpp:147)."""

    def __init__(self, f, width: int, height: int, fps_num: int = 24,
                 fps_den: int = 1) -> None:
        if isinstance(f, str):
            f = open(f, "wb")
        self.f = f
        self.f.write(b"YUV4MPEG2 C420jpeg W%d H%d F%d:%d Ip A1:1\n"
                     % (width, height, fps_num, fps_den))

    def write_frame(self, y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> None:
        self.f.write(b"FRAME\n")
        for plane in (y, cb, cr):
            self.f.write(np.ascontiguousarray(plane).tobytes())

    def close(self) -> None:
        self.f.close()


def write_yuv(f, frames) -> None:
    """Raw planar YUV writer (reference writeToYUV, fileIO.cpp:100-132)."""
    if isinstance(f, str):
        with open(f, "wb") as out:
            write_yuv(out, frames)
        return
    for frame in frames:
        for plane in frame:
            f.write(np.ascontiguousarray(plane).tobytes())


def read_yuv(path: str, width: int, height: int):
    """Raw planar 4:2:0 frames of `path` as (y, cb, cr) uint8 arrays."""
    data = np.fromfile(path, np.uint8)
    ysz, csz = width * height, (width // 2) * (height // 2)
    fsz = ysz + 2 * csz
    out = []
    for base in range(0, len(data) - fsz + 1, fsz):
        y = data[base: base + ysz].reshape(height, width)
        cb = data[base + ysz: base + ysz + csz].reshape(height // 2, width // 2)
        cr = data[base + ysz + csz: base + fsz].reshape(height // 2, width // 2)
        out.append((y, cb, cr))
    return out


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(255.0 * 255.0 / mse)
