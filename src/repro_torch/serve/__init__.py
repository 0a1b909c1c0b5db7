"""Tiled-CNN serving: executable cache and dynamic-batching engine."""
