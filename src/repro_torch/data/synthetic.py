"""Synthetic LM batches (``repro/data/synthetic.py``).

``synth_batch`` draws with numpy exactly as the reference does - the same
``SeedSequence([seed, step])`` stream, so both packages see the same bits
for the same (seed, step), and a restart replays the stream.  ``place``
moves a batch to the run's device (the reference's sharded device_put is a
plain copy on one device).  A float entry (a VLM's ``patch_embeds``,
Whisper's ``frames``) has a torch dtype in its spec: it is drawn as the
reference draws it, float64 standard normal, and cast by torch, which rounds
float64 -> bfloat16 through float32 as ``ml_dtypes``' cast does (the same
bits; ``tests/test_torch_vlm.py``).  ``SyntheticStream`` draws the same
stream on a prefetching thread, from ``start_step`` on, and places each batch on
``device`` as it is taken.  The launchers' driver calls ``make_batch(step)``
itself, as the reference's does.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from repro_torch.launch.mesh import resolve_device

# how long ``SyntheticStream.close`` waits for its worker (which checks for
# the stop at least every 0.5 s) to end
CLOSE_TIMEOUT_S = 5.0


def synth_like(spec, rng: np.random.Generator, vocab: int):
    """A numpy int32 array for an integer spec; for a float spec (a torch
    dtype) a CPU tensor of that dtype."""
    if isinstance(spec.dtype, torch.dtype):
        return torch.from_numpy(rng.standard_normal(size=spec.shape)).to(spec.dtype)
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
    return {k: (v if isinstance(v, torch.Tensor) else
                torch.from_numpy(np.ascontiguousarray(v))).to(device) for k, v in batch.items()}


class SyntheticStream:
    """Deterministic, prefetching batch stream: ``(step, batch)`` for steps
    ``start_step, start_step + 1, ...``, each ``synth_batch(specs, cfg, seed,
    step)`` placed on ``device``.  A daemon thread keeps up to ``prefetch``
    host batches ready; ``close()`` stops it and waits for it to end."""

    def __init__(self, specs: dict, cfg, seed: int = 0, start_step: int = 0, prefetch: int = 2,
                 device: str | torch.device = "cuda"):
        self.specs = specs
        self.cfg = cfg
        self.seed = seed
        self.step = start_step
        self.device = resolve_device(device)
        self._q: queue.Queue = queue.Queue(maxsize=max(prefetch, 1))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        step = self.step
        while not self._stop.is_set():
            batch = synth_batch(self.specs, self.cfg, self.seed, step)
            try:
                self._q.put((step, batch), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator[tuple[int, dict]]:
        return self

    def __next__(self) -> tuple[int, dict]:
        step, batch = self._q.get()
        return step, place(batch, self.device)

    def close(self) -> None:
        self._stop.set()
        self._thread.join(CLOSE_TIMEOUT_S)
