"""Spec tables, transforms, intra prediction and CAVLC symbols in PyTorch."""
