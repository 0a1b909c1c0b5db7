"""YOLOv2 first-16-layers (the paper's evaluation network, §5).

Darknet-19 prefix: conv3x3(+BN+leaky) / maxpool stages, 416x416 -> 26x26
feature maps.  The port of ``repro/models/yolo.py``, with the planning
knobs the port supports (``core/fusion.build_stack_plan``: groupings,
schedules, crossovers).  At the paper's 416 geometry every layer extent
divides over a 2x2 grid (tiles down to 13x13), so the uniform executor
trains and serves it as is.
"""
from __future__ import annotations

import torch

from repro_torch.core.fusion import (
    StackPlan,
    build_stack_plan,
    make_deferred_grad_step,
    make_tiled_forward,
    make_tiled_loss,
)
from repro_torch.core.grouping import PIPELINE_MICROBATCHES
from repro_torch.core.spatial import LayerDef, init_stack_params
from repro_torch.launch.mesh import make_tile_mesh, resolve_device
from repro_torch.models.tiled_cnn import TiledCNNArch


def yolov2_16_layers(in_ch: int = 3, batch_norm: bool = True) -> list[LayerDef]:
    c = lambda cin, cout, k: LayerDef(
        k, 1, cin, cout, act="leaky", batch_norm=batch_norm, use_bias=not batch_norm
    )
    p = lambda ch: LayerDef(2, 2, ch, ch, pool=True, act="linear")
    return [
        c(in_ch, 32, 3),     # 1
        p(32),               # 2
        c(32, 64, 3),        # 3
        p(64),               # 4
        c(64, 128, 3),       # 5
        c(128, 64, 1),       # 6
        c(64, 128, 3),       # 7
        p(128),              # 8
        c(128, 256, 3),      # 9
        c(256, 128, 1),      # 10
        c(128, 256, 3),      # 11
        p(256),              # 12
        c(256, 512, 3),      # 13
        c(512, 256, 1),      # 14
        c(256, 512, 3),      # 15
        c(512, 256, 1),      # 16
    ]


def make_plan(
    input_hw: tuple[int, int] = (512, 512),
    n: int = 2,
    m: int = 2,
    groups=None,
    batch_norm: bool = True,
) -> StackPlan:
    layers = yolov2_16_layers(batch_norm=batch_norm)
    return build_stack_plan(input_hw, layers, n, m, groups)


def init_yolo(seed: int | torch.Generator, plan: StackPlan, dtype=torch.float32,
              device="cuda"):
    gen = seed if isinstance(seed, torch.Generator) else torch.Generator().manual_seed(seed)
    return init_stack_params(gen, plan.layers, dtype, resolve_device(device))


def l2_loss_local(y: torch.Tensor, t: torch.Tensor):
    """(sum, count) of the squared error over the tiles it is given - the
    paper measures the training cycle, so a dense regression target over
    the output feature map stands in for the detection head (which lives
    beyond layer 16).  The difference is taken in fp32, as the reference
    does, or in fp64 for fp64 operands.  On ranks it sees the rank's block
    of tiles, so its count is the block's; the executor sums both over the
    ranks."""
    d = (y - t).to(torch.promote_types(y.dtype, torch.float32))
    return torch.sum(d * d), float(d.numel())


def make_yolo_tiled_arch(
    input_hw: tuple[int, int] = (64, 64),
    depth: int = 8,
    n: int = 2,
    m: int = 2,
    groups=None,
    *,
    backend: str = "torch",
    schedule: str = "sync",
    hw=None,
    batch: int = 1,
    crossover: int | str | None = None,
    mem_limit: float | None = None,
    partition=None,
    ragged_exec: str = "spec",
    pipeline: int | str | None = None,
    microbatches: int | None = None,
    wire_codec: str = "none",
    batch_norm: bool = True,
    device: str | torch.device = "cuda",
    mesh=None,
    loss_local=l2_loss_local,
) -> TiledCNNArch:
    """Planner -> arch bundle for the trainer and the serve engine: a
    YOLOv2 prefix of ``depth`` layers tiled n x m on a virtual mesh on
    ``device``, with the conv backend ("torch" | "cuda") and grouping
    profile chosen at plan time: ``groups="auto"`` runs the cost model on
    ``hw`` (a profile, its name, a ClusterSpec or a cluster spec string) at
    ``batch``, under ``mem_limit``, with ``microbatches`` (default the
    planner's standard M) for the pipeline bubble model; ``schedule`` and
    ``crossover`` as in ``build_stack_plan``; ``partition`` (an explicit
    ``TilePartition``, else derived: cluster-balanced or near-even) and
    ``ragged_exec`` pass through to it, and ``wire_codec``, the plan's codec,
    which the trainer's grad step and the serve engine's forward run.
    ``mesh`` replaces the virtual n x m mesh: a ``DistTileMesh``
    (``launch/mesh.py:make_dist_tile_mesh``) runs the plan (either
    schedule, a crossover, any codec, a ragged partition, a pipeline tail)
    on this rank's block of the grid."""
    layers = yolov2_16_layers(batch_norm=batch_norm)[:depth]
    plan = build_stack_plan(
        input_hw, layers, n, m, groups,
        backend=backend, schedule=schedule, hw=hw, batch=batch,
        crossover=crossover, mem_limit=mem_limit, partition=partition,
        ragged_exec=ragged_exec, pipeline=pipeline,
        microbatches=PIPELINE_MICROBATCHES if microbatches is None else microbatches,
        wire_codec=wire_codec, device=mesh.device if mesh is not None else device,
    )
    return TiledCNNArch(
        plan=plan,
        mesh=mesh if mesh is not None else make_tile_mesh(n, m, device),
        loss_local=loss_local,
    )


def make_yolo_train_fns(plan: StackPlan, mesh, microbatches: int = 1):
    """(forward, loss, deferred_grad_step) over the virtual tile mesh."""
    fwd = make_tiled_forward(plan, mesh)
    loss = make_tiled_loss(plan, mesh, l2_loss_local)
    step = make_deferred_grad_step(plan, mesh, l2_loss_local, microbatches=microbatches)
    return fwd, loss, step
