"""Serving: the LM slot engine (``engine.py``), and tiled-CNN serving
(``cnn_engine.py``, ``exec_cache.py``: executable cache and dynamic-batching
engine)."""
