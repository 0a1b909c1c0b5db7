"""Tiled-CNN architecture bundle: a ``StackPlan`` + its virtual tile mesh.

The serving surface of ``repro/models/tiled_cnn.py``; the training surface
(loss, deferred gradients, trainer) is the next slice (ROADMAP A.7-A.8).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.fusion import StackPlan
from repro_torch.core.spatial import freeze_bn_stats, init_stack_params
from repro_torch.launch.mesh import TileMesh


@dataclasses.dataclass
class TiledCNNArch:
    """Planner output + mesh: everything the serve engine needs."""

    plan: StackPlan
    mesh: TileMesh

    def init(self, seed: int | torch.Generator = 0, dtype=torch.float32):
        """He-initialised params on the mesh's device, from a seed or a CPU
        ``torch.Generator``."""
        gen = seed if isinstance(seed, torch.Generator) else torch.Generator().manual_seed(seed)
        return init_stack_params(gen, self.plan.layers, dtype, self.mesh.device)

    @property
    def out_channels(self) -> int:
        return self.plan.layers[-1].out_channels

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
        already carry ``bn_mean``/``bn_var``."""
        from repro_torch.serve.cnn_engine import CNNServeEngine

        if calibration is not None:
            params = self.serve_params(params, calibration)
        return CNNServeEngine(self.serve_plan(), self.mesh, params, **engine_kw)
