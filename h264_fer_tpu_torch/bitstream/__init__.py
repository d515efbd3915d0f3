"""Host-side bitstream syntax: bit I/O, Exp-Golomb, NAL framing, headers."""
