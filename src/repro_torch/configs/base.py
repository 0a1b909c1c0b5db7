"""Run configuration: the trainer's part of ``repro/configs/base.py``.

``ParallelConfig`` and ``TrainConfig`` with the fields the port reads, under
the reference's names and defaults.  On the virtual tile mesh only
``grad_accum`` of the reference's ``ParallelConfig`` acts; its mesh-axis and
LM fields, and ``TrainConfig``'s logging and checkpoint cadence, come back
with the features that read them (the LM side is ROADMAP A.18, checkpoints
A.15).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """How a model maps onto the mesh."""

    grad_accum: int = 1


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    weight_decay: float = 0.1
    warmup: int = 100
    optimizer: str = "adamw"         # adamw | adafactor | sgd
    grad_clip: float = 1.0
    grad_compression: Optional[str] = None   # None | "int8"
    steps: int = 100
    seed: int = 0
