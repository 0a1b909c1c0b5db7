"""Synthetic LM batches (``repro/data/synthetic.py``).

``synth_batch`` draws with numpy exactly as the reference does - the same
``SeedSequence([seed, step])`` stream, so both packages see the same bits
for the same (seed, step), and a restart replays the stream.  ``place``
moves a batch to the run's device (the reference's sharded device_put is a
plain copy on one device).  The prefetching ``SyntheticStream`` is not
ported: the driver calls ``make_batch(step)`` itself.
"""
from __future__ import annotations

import numpy as np
import torch


def synth_like(spec, rng: np.random.Generator, vocab: int) -> np.ndarray:
    if np.issubdtype(spec.dtype, np.integer):
        return rng.integers(0, max(vocab, 2), size=spec.shape, dtype=np.int32)
    return rng.standard_normal(size=spec.shape).astype(spec.dtype)


def synth_batch(specs: dict, cfg, seed: int, step: int) -> dict:
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    out = {}
    for k, spec in specs.items():
        arr = synth_like(spec, rng, cfg.vocab)
        if k == "positions" and arr.ndim == 3:
            # monotone position streams for mrope
            t = spec.shape[-1]
            arr = np.broadcast_to(np.arange(t, dtype=np.int32), spec.shape).copy()
        out[k] = arr
    return out


def place(batch: dict, device: str | torch.device) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}
