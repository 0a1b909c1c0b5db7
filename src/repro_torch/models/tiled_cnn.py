"""Tiled-CNN architecture bundle: a ``StackPlan``, its virtual tile mesh
and the shard-local loss - the surface of ``repro/models/tiled_cnn.py``.

``kind == "tiled_cnn"`` routes ``train.trainer.make_train_step`` onto the
deferred-aggregation path (paper §4.1).  Batches are dicts
``{"x": (B, H, W, C), "t": (B, OH, OW, Cout)}`` with the global batch B
divisible by ``grad_accum``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core.fusion import StackPlan
from repro_torch.core.spatial import freeze_bn_stats, init_stack_params
from repro_torch.launch.mesh import DistTileMesh, TileMesh
from repro_torch.parallel.dist import broadcast_

LossLocal = Callable[[torch.Tensor, torch.Tensor], tuple[torch.Tensor, float]]


@dataclasses.dataclass
class TiledCNNArch:
    """Planner output + mesh + loss: everything the trainer and the serve
    engine need."""

    plan: StackPlan
    mesh: TileMesh
    loss_local: LossLocal | None = None
    kind: str = "tiled_cnn"

    def init(self, seed: int | torch.Generator = 0, dtype=torch.float32):
        """He-initialised params on the mesh's device, from a seed or a CPU
        ``torch.Generator``; on ranks, rank 0's, broadcast to every rank."""
        gen = seed if isinstance(seed, torch.Generator) else torch.Generator().manual_seed(seed)
        params = init_stack_params(gen, self.plan.layers, dtype, self.mesh.device)
        if isinstance(self.mesh, DistTileMesh):
            broadcast_(self.mesh.group, [v for p in params for v in p.values()])
        return params

    def abstract_params(self):
        """The params' shapes and dtypes as ``meta`` tensors, drawing and
        allocating nothing (``train/trainer.py:abstract_of``)."""
        from repro_torch.train.trainer import abstract_of

        return abstract_of(self.init)[0]

    @property
    def out_channels(self) -> int:
        return self.plan.layers[-1].out_channels

    def target_shape(self, batch: int) -> tuple[int, ...]:
        return (batch, *self.plan.out_hw(), self.out_channels)

    def serve_plan(self) -> StackPlan:
        """The forward-only twin of the plan: BN from frozen statistics."""
        return self.plan.inference_twin()

    def serve_params(self, params, calibration):
        """Params + frozen BN statistics from a calibration batch (numpy or
        tensor, (B, H, W, C))."""
        x = torch.as_tensor(calibration, device=self.mesh.device)
        return freeze_bn_stats(params, self.plan.layers, x)

    def make_serve_engine(self, params, *, calibration=None, **engine_kw):
        """A ``CNNServeEngine`` over this arch's plan and mesh.  Pass
        ``calibration`` to freeze BN stats here; otherwise ``params`` must
        already carry ``bn_mean``/``bn_var``.  ``engine_kw`` goes to the
        engine as is: ``hw`` and ``cluster`` price its modeled step bound."""
        from repro_torch.serve.cnn_engine import CNNServeEngine

        if calibration is not None:
            params = self.serve_params(params, calibration)
        return CNNServeEngine(self.serve_plan(), self.mesh, params, **engine_kw)
