"""Frame input and output."""
