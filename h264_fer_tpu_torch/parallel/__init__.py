"""Sequence encoders that stitch device frames into an Annex-B stream."""
