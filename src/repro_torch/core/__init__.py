"""Tile geometry, conv backends, halo exchange and the tiled executor."""
