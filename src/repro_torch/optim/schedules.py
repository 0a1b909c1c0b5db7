"""Learning-rate schedules (pure functions of the int step), as
``repro/optim/schedules.py``."""
from __future__ import annotations

import math


def linear_warmup(step: int, warmup: int, base: float) -> float:
    return base * min(1.0, (step + 1) / max(warmup, 1))


def cosine_schedule(step: int, warmup: int, total: int, base: float, floor: float = 0.1) -> float:
    if step < warmup:
        return linear_warmup(step, warmup, base)
    frac = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return base * (floor + (1 - floor) * 0.5 * (1 + math.cos(math.pi * frac)))
