"""Frame-level encode stages: mode decision, slice entropy, the I16 frame."""
