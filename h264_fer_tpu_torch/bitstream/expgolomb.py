"""Exp-Golomb codes (norm 9.1; reference expgolomb.cpp).

A copy of h264_fer_tpu/bitstream/expgolomb.py (host side: slice headers and
parameter sets; the device symbols are in ops/cavlc_bulk.py).
"""

from __future__ import annotations

from .bitio import BitReader, BitWriter


def ue_code(code_num: int) -> tuple[int, int]:
    """(bits, nbits) of the unsigned Exp-Golomb code for code_num."""
    x = code_num + 1
    nbits = 2 * (x.bit_length() - 1) + 1
    return x, nbits


def se_to_ue(v: int) -> int:
    """Signed→unsigned mapping (norm 9.1.1; reference SC_to_UC,
    expgolomb.cpp:108-118): v<=0 → -2v, v>0 → 2v-1."""
    return -2 * v if v <= 0 else 2 * v - 1


def se_code(v: int) -> tuple[int, int]:
    return ue_code(se_to_ue(v))


def write_ue(w: BitWriter, code_num: int) -> None:
    bits, n = ue_code(code_num)
    w.write(bits, n)


def write_se(w: BitWriter, v: int) -> None:
    write_ue(w, se_to_ue(v))


def read_ue(r: BitReader) -> int:
    # one 24-bit peek covers codes up to 23 bits (ue < 4095), the common
    # case by far (reference expGolomb_UD's 24-bit fast path,
    # expgolomb.cpp:122-140); longer codes fall back to bit stepping
    v = r.peek(24)
    if v:
        zeros = 24 - v.bit_length()
        if zeros <= 11:  # whole code (2*zeros+1 <= 23 bits) inside the peek
            r.skip(2 * zeros + 1)
            return (v >> (23 - 2 * zeros)) - 1
    zeros = 0
    while r.read_bit() == 0:
        zeros += 1
    if zeros == 0:
        return 0
    return (1 << zeros) - 1 + r.read(zeros)


def read_se(r: BitReader) -> int:
    k = read_ue(r)
    return (k + 1) // 2 if k % 2 else -(k // 2)


def read_te(r: BitReader, max_val: int) -> int:
    """Truncated Exp-Golomb (norm 9.1: when range is 0..1 it is one inverted
    bit; reference expGolomb_TD expgolomb.cpp:156-178)."""
    if max_val == 1:
        return 1 - r.read_bit()
    return read_ue(r)
