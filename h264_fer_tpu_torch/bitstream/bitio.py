"""MSB-first bit reader/writer over RBSP byte arrays (host side).

Semantics match the reference's rbsp_IO.cpp: a bit reader with
byte/bit cursors over an RBSP buffer (rbsp_IO.cpp:58-66,254-325) and an
accumulate-and-flush bit writer (rbsp_IO.cpp:123-191). One deliberate
reference behavior we must replicate for bit-exact decode of its streams:
`more_rbsp_data()` is the *byte-count approximation*
`current_byte < total_size - 1` (rbsp_IO.cpp:193-196), NOT the spec's
trailing-bits test.

A copy of h264_fer_tpu/bitstream/bitio.py. The device packs the slice
payload (ops/cavlc_bulk.py); only headers and the payload splice are
written here.
"""

from __future__ import annotations


class BitWriter:
    """MSB-first bit writer accumulating into a bytearray."""

    __slots__ = ("_buf", "_acc", "_nacc")

    def __init__(self) -> None:
        self._buf = bytearray()
        self._acc = 0  # bit accumulator, MSB-first (left-aligned on flush)
        self._nacc = 0  # number of valid bits in _acc

    def write(self, value: int, nbits: int) -> None:
        """Append the low `nbits` bits of `value`, MSB first."""
        if nbits == 0:
            return
        self._acc = (self._acc << nbits) | (value & ((1 << nbits) - 1))
        self._nacc += nbits
        while self._nacc >= 8:
            self._nacc -= 8
            self._buf.append((self._acc >> self._nacc) & 0xFF)
        self._acc &= (1 << self._nacc) - 1

    def write_flag(self, flag) -> None:
        self.write(1 if flag else 0, 1)

    def write_bits_list(self, values_and_lengths) -> None:
        for v, n in values_and_lengths:
            self.write(v, n)

    def append_bits(self, data: bytes, nbits: int) -> None:
        """Append the first `nbits` bits of `data` (MSB-first) in bulk —
        the splice point for natively packed payloads (native packer
        output starts at bit 0; here it lands at any bit offset)."""
        if nbits == 0:
            return
        if self._nacc == 0:
            full, rem = divmod(nbits, 8)
            self._buf += data[:full]
            if rem:
                self.write(data[full] >> (8 - rem), rem)
            return
        nby = (nbits + 7) // 8
        v = int.from_bytes(data[:nby], "big") >> (nby * 8 - nbits)
        acc = (self._acc << nbits) | v
        total = self._nacc + nbits
        full, rem = divmod(total, 8)
        self._buf += (acc >> rem).to_bytes(full, "big")
        self._acc = acc & ((1 << rem) - 1)
        self._nacc = rem

    @property
    def bit_position(self) -> int:
        return len(self._buf) * 8 + self._nacc

    def rbsp_trailing_bits(self) -> None:
        """Stop bit + zero padding to a byte boundary (norm 7.3.2.11;
        reference rbsp_encoding.cpp:108-117)."""
        self.write(1, 1)
        if self._nacc:
            self.write(0, 8 - self._nacc)

    def getvalue(self) -> bytes:
        assert self._nacc == 0, "unflushed bits; call rbsp_trailing_bits()"
        return bytes(self._buf)


class BitReader:
    """MSB-first bit reader over an RBSP byte buffer."""

    __slots__ = ("data", "nbytes", "byte", "bit")

    def __init__(self, data: bytes) -> None:
        self.data = data
        self.nbytes = len(data)
        self.byte = 0
        self.bit = 0

    def read(self, nbits: int) -> int:
        """Read `nbits` bits MSB-first (reference getRawBits)."""
        v = 0
        byte, bit, data = self.byte, self.bit, self.data
        while nbits > 0:
            avail = 8 - bit
            take = avail if avail < nbits else nbits
            cur = data[byte]
            v = (v << take) | ((cur >> (avail - take)) & ((1 << take) - 1))
            bit += take
            if bit == 8:
                bit = 0
                byte += 1
            nbits -= take
        self.byte, self.bit = byte, bit
        return v

    def read_bit(self) -> int:
        cur = self.data[self.byte]
        v = (cur >> (7 - self.bit)) & 1
        self.bit += 1
        if self.bit == 8:
            self.bit = 0
            self.byte += 1
        return v

    def peek(self, nbits: int) -> int:
        """Peek up to 24 bits without advancing (reference peekRawBits).

        Reads past the end are zero-padded (the reference relies on the
        caller never decoding past more_rbsp_data; zero padding keeps the
        table lookups in-bounds on the final bits)."""
        acc = 0
        byte = self.byte
        need = self.bit + nbits
        nb = (need + 7) // 8
        for i in range(nb):
            b = self.data[byte + i] if byte + i < self.nbytes else 0
            acc = (acc << 8) | b
        acc >>= nb * 8 - need
        return acc & ((1 << nbits) - 1)

    def skip(self, nbits: int) -> None:
        pos = self.byte * 8 + self.bit + nbits
        self.byte, self.bit = pos >> 3, pos & 7

    def more_rbsp_data(self) -> bool:
        """Reference's byte-count approximation (rbsp_IO.cpp:193-196)."""
        return self.byte < self.nbytes - 1

    @property
    def bit_position(self) -> int:
        return self.byte * 8 + self.bit
