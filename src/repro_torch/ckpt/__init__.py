"""Checkpoints: the reference's on-disk format, written and read by torch."""
