"""Training step factory: grad accumulation, clipping, LR schedule,
optimizer update, optional int8-EF gradient compression - the tiled-CNN
path of ``repro/train/trainer.py``.

``make_train_step(arch, pcfg, tcfg)`` returns ``(init_state, train_step)``;
``on_grads(step, loss, grads)``, if given, sees each step's batch-end
gradients before the trainer tail, so a run's own gradients can be held
against a reference.
For a tiled-CNN bundle (``arch.kind == "tiled_cnn"``) the grads come from
``core.fusion.make_deferred_grad_step``: ``pcfg.grad_accum`` microbatches
accumulate per-tile weight-gradient partial sums, and one division by the
global count at batch end gives the final gradients - the paper's schedule.
The trainer tail then runs optional int8 error-feedback compression,
global-norm clipping, the cosine/warmup schedule and the optimizer update.
The LM path is ROADMAP A.18.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.configs.base import ParallelConfig, TrainConfig
from repro_torch.optim.compression import CompressionState, compress_with_feedback, init_error
from repro_torch.optim.optimizers import clip_by_global_norm, make_optimizer
from repro_torch.optim.schedules import cosine_schedule


class TrainState(NamedTuple):
    params: Any
    opt: Any
    step: int
    ef: Optional[Any] = None      # error-feedback buffers (compression)


def _make_init_state(arch, opt, tcfg: TrainConfig):
    def init_state(seed: int | torch.Generator = 0) -> TrainState:
        params = arch.init(seed)
        ef = init_error(params).error if tcfg.grad_compression == "int8" else None
        return TrainState(params, opt.init(params), 0, ef)

    return init_state


def _apply_updates(state: TrainState, loss, grads, opt, tcfg: TrainConfig):
    """Shared trainer tail: EF compression -> clip -> schedule -> update."""
    ef = state.ef
    if ef is not None:
        grads, st = compress_with_feedback(grads, CompressionState(ef))
        ef = st.error
    grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
    lr = cosine_schedule(state.step, tcfg.warmup, tcfg.steps, tcfg.lr)
    params, opt_state = opt.update(grads, state.opt, state.params, lr)
    new_state = TrainState(params, opt_state, state.step + 1, ef)
    return new_state, {"loss": loss, "grad_norm": gnorm, "lr": lr}


def make_train_step(arch, pcfg: ParallelConfig, tcfg: TrainConfig, *, on_grads=None):
    if getattr(arch, "kind", None) != "tiled_cnn":
        raise NotImplementedError("the LM training path: ROADMAP A.18 (LM side)")
    if tcfg.grad_compression not in (None, "int8"):
        raise ValueError(f"grad_compression must be None or 'int8'; got {tcfg.grad_compression!r}")
    return _make_tiled_cnn_train_step(arch, pcfg, tcfg, on_grads)


def _make_tiled_cnn_train_step(arch, pcfg: ParallelConfig, tcfg: TrainConfig, on_grads):
    from repro_torch.core.fusion import make_deferred_grad_step

    opt = make_optimizer(tcfg.optimizer, weight_decay=tcfg.weight_decay)
    init_state = _make_init_state(arch, opt, tcfg)
    accum = max(pcfg.grad_accum, 1)
    grad_step = make_deferred_grad_step(arch.plan, arch.mesh, arch.loss_local,
                                        microbatches=accum)

    def train_step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        def split(v):
            v = torch.as_tensor(v, device=arch.mesh.device)
            if v.shape[0] % accum:
                raise ValueError(
                    f"global batch {v.shape[0]} not divisible by "
                    f"grad_accum={accum} (tiled-CNN microbatch split)"
                )
            return v.reshape((accum, v.shape[0] // accum) + tuple(v.shape[1:]))

        loss, grads = grad_step(state.params, split(batch["x"]), split(batch["t"]))
        if on_grads is not None:
            on_grads(state.step, loss, grads)
        return _apply_updates(state, loss, grads, opt, tcfg)

    return init_state, train_step
