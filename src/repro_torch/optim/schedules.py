"""Learning-rate schedules of the step, as ``repro/optim/schedules.py``.

A host int step gives a Python float.  A 0-d integer tensor step (the
trainer's ``TrainState.step``) gives a 0-d fp64 tensor on its device: a
captured training step reads the step where it lies on the card at every
replay, where a Python number would be baked into the graph at its capture.
Its value is the host path's: the reference's operations in fp64, which an
fp32 update rounds once, as it rounds a Python float (the reference's fp32
evaluation rounds at each operation, up to a few ulps from that value
where the cosine nears -1).
"""
from __future__ import annotations

import math

import torch


def linear_warmup(step, warmup: int, base: float):
    if isinstance(step, torch.Tensor):
        return base * torch.clamp((step.double() + 1) / max(warmup, 1), max=1.0)
    return base * min(1.0, (step + 1) / max(warmup, 1))


def cosine_schedule(step, warmup: int, total: int, base: float, floor: float = 0.1):
    if isinstance(step, torch.Tensor):
        step = step.double()
        warm = linear_warmup(step, warmup, base)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, base * cos)
    if step < warmup:
        return linear_warmup(step, warmup, base)
    frac = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return base * (floor + (1 - floor) * 0.5 * (1 + math.cos(math.pi * frac)))
