"""Annex-B NAL unit framing (norm 7.3.1/B.1; reference nal.cpp).

A copy of h264_fer_tpu/bitstream/nal.py, except that emulation prevention
is inserted by a scan for zero pairs (bytes.find) instead of the JAX
package's native extension; the output is the same byte string.

Decode: scan for 4-byte start codes 00 00 00 01 (the reference requires the
4-byte form to *find* a NAL start, nal.cpp:86-98, but terminates a NAL at
either 00 00 00 or 00 00 01, nal.cpp:141-155), strip the one-byte header,
remove emulation-prevention 0x03 bytes (nal.cpp:208-224).

Encode: 4-byte start code + header byte + RBSP with 0x03 inserted before any
of {00,01,02,03} that follows two zero bytes (nal.cpp:261-299).
"""

from __future__ import annotations

from dataclasses import dataclass

# nal_unit_type values supported by the codec (h264_globals.h:82-86)
NAL_NOT_IDR = 1
NAL_IDR = 5
NAL_SEI = 6
NAL_SPS = 7
NAL_PPS = 8


@dataclass
class NalUnit:
    nal_ref_idc: int
    nal_unit_type: int
    rbsp: bytes


def remove_emulation_prevention(ebsp: bytes) -> bytes:
    """Strip 0x03 emulation-prevention bytes (7.3.1; nal.cpp:208-224)."""
    out = bytearray()
    pos = 0
    i = ebsp.find(b"\x00\x00\x03")
    while i >= 0:
        out += ebsp[pos : i + 2]
        pos = i + 3  # skip the emulation prevention byte
        i = ebsp.find(b"\x00\x00\x03", pos)
    out += ebsp[pos:]
    return bytes(out)


def insert_emulation_prevention(rbsp: bytes) -> bytes:
    """Insert 0x03 before {00,01,02,03} following two zeros (nal.cpp:272-295).

    Jumps from one 00 00 pair to the next, so a payload of hundreds of KB
    costs a few scans in C rather than a Python step per byte. After an
    inserted 0x03 the zero count restarts at the byte that follows it,
    as in the byte-wise loop of the reference.
    """
    out = bytearray()
    n = len(rbsp)
    start = 0  # first byte not yet copied to out
    i = rbsp.find(b"\x00\x00")
    while 0 <= i and i + 2 < n:
        if rbsp[i + 2] <= 3:
            out += rbsp[start : i + 2]
            out.append(3)
            start = i + 2
        i = rbsp.find(b"\x00\x00", i + 2)
    out += rbsp[start:]
    return bytes(out)


def iter_nal_units(stream: bytes):
    """Yield NalUnit for each Annex-B NAL in `stream`.

    Matches the reference scanner: starts are the 4-byte code only; a NAL
    ends at the next 00 00 0{0,1} or end of stream.
    """
    pos = 0
    n = len(stream)
    while True:
        start = stream.find(b"\x00\x00\x00\x01", pos)
        if start < 0:
            return
        start += 4
        # find end: next 00 00 00 or 00 00 01
        ends = [j for j in (stream.find(b"\x00\x00\x00", start),
                            stream.find(b"\x00\x00\x01", start)) if j >= 0]
        end = min(ends, default=n)
        header = stream[start]
        yield NalUnit(
            nal_ref_idc=(header >> 5) & 3,
            nal_unit_type=header & 0x1F,
            rbsp=remove_emulation_prevention(stream[start + 1 : end]),
        )
        pos = end


def write_nal_unit(nal_ref_idc: int, nal_unit_type: int, rbsp: bytes) -> bytes:
    header = ((nal_ref_idc & 3) << 5) | (nal_unit_type & 0x1F)
    return b"\x00\x00\x00\x01" + bytes([header]) + insert_emulation_prevention(rbsp)
