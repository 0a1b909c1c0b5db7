"""Fused, grouped execution stacks (paper §4.2) on the virtual tile mesh.

The uniform, sync, all-spatial subset of ``repro/core/fusion.py``: the
planner for explicit (or no) groupings, the per-tile executor, the forward /
inference wrappers that split a global batch into tiles and assemble the
global output, and the training entry points - the tiled loss and the
deferred-aggregation gradient step.  A group exchanges halos once at its
input; inside it every tile carries a recursively grown halo and recomputes
boundary regions redundantly.

Halo-width algebra (from the eq. 1 recursion, DESIGN.md §2):

    group_halo_lo = sum_l P_l * prod_{l'<l in group} S_l'
    group_halo_hi = sum_l (K_l - S_l - P_l) * prod_{l'<l in group} S_l'

and the remaining halo after layer l shrinks as (h - P_l) / S_l.

What the reference also plans, and the port does not yet, raises
``NotImplementedError`` naming its ROADMAP item.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.core.backend import get_conv_backend
from repro_torch.core.halo import halo_exchange_2d
from repro_torch.core.spatial import LayerDef, apply_layer_local, stack_reference
from repro_torch.core.tiling import (
    Group,
    TilePartition,
    bounds_sizes,
    crossover_of,
    derive_axis_bounds,
    no_grouping,
    pipeline_first_of,
    validate_profile,
)
from repro_torch.launch.mesh import TileMesh


@dataclasses.dataclass(frozen=True)
class StackPlan:
    """Static geometry for an (n x m)-tiled, grouped conv stack.

    The fields are the reference's, so ``plan_manifest`` describes a port
    plan exactly as it describes the JAX plan with the same knobs.  The port
    builds uniform, all-spatial, sync plans only: ``crossover`` is None,
    ``stages`` empty and ``wire_codec`` "none"."""

    layers: tuple[LayerDef, ...]
    groups: tuple[Group, ...]
    n: int
    m: int
    input_hw: tuple[int, int]
    map_hw: tuple[tuple[int, int], ...]          # extent at each layer input; [-1] = output
    shard_hw: tuple[tuple[int, int], ...]        # shard extent per layer input
    group_halos: tuple[tuple[int, int, int, int], ...]   # (top,bot,left,right) @ group input
    rem_halos: tuple[tuple[int, int, int, int], ...]     # remaining halo after each layer
    group_of_layer: tuple[int, ...]
    backend: str = "torch"                       # conv compute path (core.backend)
    schedule: str = "sync"
    block_oh: int | None = None                  # conv output-row block (None = auto)
    crossover: int | None = None
    partition: TilePartition | None = None       # input-level tile boundaries
    tile_rows: tuple[tuple[int, ...], ...] = ()  # per layer input: per-tile-row extents
    tile_cols: tuple[tuple[int, ...], ...] = ()
    ragged_exec: str = "spec"
    stages: tuple[tuple[int, int], ...] = ()
    wire_codec: str = "none"
    inference: bool = False                      # forward-only serve plan (DESIGN.md §13)

    @property
    def n_layers(self) -> int:
        return len(self.layers)

    def inference_twin(self) -> "StackPlan":
        """The forward-only serving twin: same geometry and compute knobs,
        BN from frozen statistics."""
        if self.stages:
            raise ValueError(
                "pipeline plans have no inference twin: serve steps need a "
                "single-shot forward layout; replan without the pipeline tail"
            )
        return dataclasses.replace(self, inference=True)

    def out_hw(self) -> tuple[int, int]:
        return self.map_hw[-1]

    @property
    def is_uniform(self) -> bool:
        """True when every tile has the same shape at every layer."""
        if not self.tile_rows:
            return True
        return all(
            len(set(r)) == 1 and len(set(c)) == 1
            for r, c in zip(self.tile_rows, self.tile_cols)
        )


def build_stack_plan(
    input_hw: tuple[int, int],
    layers: Sequence[LayerDef],
    n: int,
    m: int,
    groups: Sequence[Group] | str | None = None,
    *,
    backend: str = "torch",
    schedule: str = "sync",
    block_oh: int | None = None,
    hw=None,
    crossover: int | str | None = None,
    partition: TilePartition | None = None,
    pipeline: int | str | None = None,
    wire_codec: str = "none",
    inference: bool = False,
) -> StackPlan:
    """Planner: all static geometry + compute-path choices for a tiled stack.

    groups: an explicit profile or None (= sync every layer).  backend:
    registered conv compute path ("torch" | "cuda").  inference: plan a
    forward-only serve step (BN from frozen statistics).  The reference's
    other planning modes raise ``NotImplementedError`` with their ROADMAP
    item: ``groups="auto"`` and ``hw`` (the grouping cost model, A.9),
    overlap (A.10), crossover (A.11), non-uniform partitions (A.12),
    pipelines (A.13) and wire codecs (A.14)."""
    get_conv_backend(backend)   # fail fast on unknown backends
    if schedule in ("overlap", "auto"):
        raise NotImplementedError(f"schedule={schedule!r}: ROADMAP A.10 (overlap schedule)")
    if schedule != "sync":
        raise ValueError(f"schedule must be 'sync', 'overlap', or 'auto'; got {schedule!r}")
    if block_oh is not None and block_oh < 1:
        raise ValueError(f"block_oh must be a positive int or None; got {block_oh!r}")
    if wire_codec != "none":
        raise NotImplementedError(f"wire_codec={wire_codec!r}: ROADMAP A.14 (wire codecs)")
    if isinstance(groups, str):
        if groups != "auto":
            raise ValueError(f"groups must be a profile, None, or 'auto'; got {groups!r}")
        raise NotImplementedError("groups='auto': ROADMAP A.9 (grouping cost model)")
    if hw is not None:
        raise NotImplementedError("hardware profiles / clusters: ROADMAP A.9 (grouping cost model)")
    if crossover is not None:
        raise NotImplementedError("spatial->data crossover: ROADMAP A.11 (hybrid plans)")
    if pipeline is not None:
        raise NotImplementedError("pipeline tails: ROADMAP A.13 (pipeline mode)")
    layers = tuple(layers)
    groups = tuple(no_grouping(len(layers))) if groups is None else tuple(groups)
    validate_profile(groups, len(layers))
    if crossover_of(groups) is not None:
        raise NotImplementedError("data-mode groups: ROADMAP A.11 (hybrid plans)")
    if pipeline_first_of(groups) is not None:
        raise NotImplementedError("pipeline-mode groups: ROADMAP A.13 (pipeline mode)")
    if partition is not None and (partition.n, partition.m) != (n, m):
        raise ValueError(
            f"partition grid {(partition.n, partition.m)} != tile grid {(n, m)}"
        )

    map_hw = [tuple(input_hw)]
    for l in layers:
        h, w = map_hw[-1]
        map_hw.append((l.out_extent(h), l.out_extent(w)))

    strides = [l.stride for l in layers]
    try:
        row_bounds = derive_axis_bounds(
            partition.row_bounds if partition else None, strides, [e[0] for e in map_hw], n
        )
        col_bounds = derive_axis_bounds(
            partition.col_bounds if partition else None, strides, [e[1] for e in map_hw], m
        )
    except ValueError as e:
        raise ValueError(
            f"cannot partition map extents over the {n}x{m} tile grid: {e}; "
            "use a coarser grid or different boundaries"
        ) from None
    if partition is None:
        partition = TilePartition(row_bounds[0], col_bounds[0])
    tile_rows = [bounds_sizes(b) for b in row_bounds]
    tile_cols = [bounds_sizes(b) for b in col_bounds]
    if any(len(set(r)) > 1 for r in tile_rows) or any(len(set(c)) > 1 for c in tile_cols):
        raise NotImplementedError(
            f"non-uniform tile partition (rows {tile_rows[0]}, cols {tile_cols[0]} "
            "or deeper layers): ROADMAP A.12 (non-uniform partitions)"
        )
    shard_hw = [(r[0], c[0]) for r, c in zip(tile_rows, tile_cols)]

    group_halos: list[tuple[int, int, int, int]] = []
    rem_halos: list[tuple[int, int, int, int]] = [None] * len(layers)  # type: ignore
    group_of_layer: list[int] = [0] * len(layers)
    for gi, g in enumerate(groups):
        hl = hh = 0
        sprod = 1
        for l in g.layers:
            p = layers[l].padding
            q = layers[l].kernel - layers[l].stride - p
            hl += p * sprod
            hh += q * sprod
            sprod *= layers[l].stride
        group_halos.append((hl, hh, hl, hh))
        # The exchange ships at most one neighbour strip per side.
        if tile_rows[g.start][0] < max(hl, hh) or tile_cols[g.start][0] < max(hl, hh):
            raise ValueError(
                f"group ({g.start}, {g.end}) halo ({hl}, {hh}) exceeds the "
                f"smallest tile of partition rows={tile_rows[g.start]} "
                f"cols={tile_cols[g.start]}; use a finer grouping or a less "
                "skewed partition"
            )
        cur_lo, cur_hi = hl, hh
        for l in g.layers:
            group_of_layer[l] = gi
            p = layers[l].padding
            q = layers[l].kernel - layers[l].stride - p
            cur_lo = (cur_lo - p) // layers[l].stride
            cur_hi = (cur_hi - q) // layers[l].stride
            rem_halos[l] = (cur_lo, cur_hi, cur_lo, cur_hi)
        if cur_lo != 0 or cur_hi != 0:
            raise ValueError(f"group ({g.start}, {g.end}) does not consume its halo")

    return StackPlan(
        layers=layers,
        groups=groups,
        n=n,
        m=m,
        input_hw=tuple(input_hw),
        map_hw=tuple(map_hw),
        shard_hw=tuple(shard_hw),
        group_halos=tuple(group_halos),
        rem_halos=tuple(rem_halos),
        group_of_layer=tuple(group_of_layer),
        backend=backend,
        schedule=schedule,
        block_oh=block_oh,
        partition=partition,
        tile_rows=tuple(tile_rows),
        tile_cols=tuple(tile_cols),
        inference=inference,
    )


PLAN_MANIFEST_VERSION = 3


def plan_manifest(plan: StackPlan) -> dict:
    """JSON-serializable description of a StackPlan: layer stack, tile grid,
    partition boundaries, grouping profile and compute knobs - the
    reference's manifest without its ``cluster`` entry."""
    return {
        "version": PLAN_MANIFEST_VERSION,
        "input_hw": list(plan.input_hw),
        "n": plan.n,
        "m": plan.m,
        "layers": [dataclasses.asdict(l) for l in plan.layers],
        "groups": [[g.start, g.end, g.mode] for g in plan.groups],
        "crossover": plan.crossover,
        "stages": [list(s) for s in plan.stages],
        "partition": None
        if plan.partition is None
        else {
            "row_bounds": list(plan.partition.row_bounds),
            "col_bounds": list(plan.partition.col_bounds),
        },
        "backend": plan.backend,
        "schedule": plan.schedule,
        "block_oh": plan.block_oh,
        "ragged_exec": plan.ragged_exec,
        "wire_codec": plan.wire_codec,
        "inference": plan.inference,
    }


def apply_stack_local(params: Sequence[dict], x: torch.Tensor, plan: StackPlan) -> torch.Tensor:
    """Forward through all groups on tiles ``x`` = (n, m, b, h/n, w/m, c):
    at each group input a 2-round halo exchange, then the group's layers.
    Training BN averages over the b images of every tile (the virtual mesh
    has no batch axis)."""
    if not plan.is_uniform or plan.schedule != "sync" or plan.crossover is not None:
        raise NotImplementedError(
            "apply_stack_local runs uniform, all-spatial, sync plans only "
            "(ROADMAP A.10-A.12)"
        )
    for gi, g in enumerate(plan.groups):
        x = halo_exchange_2d(x, plan.group_halos[gi])
        for l in g.layers:
            x = apply_layer_local(
                x,
                params[l],
                plan.layers[l],
                out_halo=plan.rem_halos[l],
                shard_out_hw=plan.shard_hw[l + 1],
                map_out_hw=plan.map_hw[l + 1],
                mask_offmap=(l != g.end),
                backend=plan.backend,
                block_oh=plan.block_oh,
                inference=plan.inference,
            )
    return x


def make_tiled_forward(plan: StackPlan, mesh: TileMesh):
    """Forward over the virtual mesh: ``(params, x_global) -> y_global``.

    ``x_global`` (B, H, W, C) is split into the n x m tiles, run through
    ``apply_stack_local`` (one kernel launch per conv layer for all tiles),
    and the global output is assembled in row-major tile order."""
    if (mesh.n, mesh.m) != (plan.n, plan.m):
        raise ValueError(f"mesh grid {(mesh.n, mesh.m)} != plan grid {(plan.n, plan.m)}")

    def fwd(params, x):
        x = torch.as_tensor(x, device=mesh.device)
        if x.dim() != 4 or tuple(x.shape[1:3]) != plan.input_hw:
            raise ValueError(
                f"input {tuple(x.shape)} does not match the plan's (B, "
                f"{plan.input_hw[0]}, {plan.input_hw[1]}, C)"
            )
        return mesh.merge(apply_stack_local(params, mesh.split(x), plan))

    return fwd


def _check_not_inference(plan: StackPlan, what: str) -> None:
    if plan.inference:
        raise ValueError(
            f"{what} is a training entry point, but the plan is forward-only "
            "(inference=True): training BN needs cross-tile batch statistics "
            "the serve executor deliberately does not take; build a training "
            "plan (inference=False) instead"
        )


def _check_trainable(plan: StackPlan) -> None:
    """The reference's training executors beyond the uniform sync path
    raise here with their ROADMAP item (the planner refuses them already;
    this guards hand-built plans)."""
    if plan.stages:
        raise NotImplementedError("pipeline training: ROADMAP A.13 (pipeline mode)")
    if plan.crossover is not None:
        raise NotImplementedError("hybrid (spatial->data) training: ROADMAP A.11 (hybrid plans)")
    if not plan.is_uniform:
        raise NotImplementedError("ragged training: ROADMAP A.12 (non-uniform partitions)")
    if plan.wire_codec != "none":
        raise NotImplementedError(f"wire_codec={plan.wire_codec!r}: ROADMAP A.14 (wire codecs)")


def _tile(mesh: TileMesh, a) -> torch.Tensor:
    return mesh.split(torch.as_tensor(a, device=mesh.device))


def make_tiled_loss(plan: StackPlan, mesh: TileMesh, loss_local):
    """Scalar loss over the *global* output map: ``(params, x, target) ->
    loss`` with x (B, H, W, C) and target (B, OH, OW, Cout).

    ``loss_local(y, t) -> (sum, count)`` sees all tiles at once, as
    ``(n, m, B, h, w, C)`` tensors, so its sum and count already are the
    reference's psums over the tiles: ``loss = sum_tiles s / sum_tiles c``,
    the untiled loss exactly.  Autograd through it gives the paper's tiled
    backward pass."""
    _check_not_inference(plan, "make_tiled_loss")
    _check_trainable(plan)

    def loss(params, x, target):
        y = apply_stack_local(params, _tile(mesh, x), plan)
        s, c = loss_local(y, _tile(mesh, target))
        return s / c

    return loss


def make_deferred_grad_step(
    plan: StackPlan,
    mesh: TileMesh,
    loss_local,
    *,
    microbatches: int = 1,
):
    """Paper §4.1 deferred weight aggregation: ``(params, xs, ts) ->
    (loss_mean, grads)`` with xs (microbatches, b, H, W, C) and ts
    (microbatches, b, OH, OW, Cout).  ``grads`` mirrors ``params`` (a list
    of per-layer dicts).

    A Python loop over the microbatches accumulates each one's weight
    gradients (in place into the first one's, to hold one copy), and ONE
    division by the global count at batch end gives the final gradients -
    the reference's scan followed by its single psum.  The cross-tile sum
    of the weight gradients needs no separate step here: the tiles are the
    batch dimension of every conv, so wgrad (B3 on the card) sums the
    per-tile partials inside its own reduction.  A ``torch.distributed``
    backend, one tile per device, makes that sum an explicit all-reduce
    (later work)."""
    _check_not_inference(plan, "make_deferred_grad_step")
    _check_trainable(plan)

    def step(params, xs, ts):
        xs = torch.as_tensor(xs, device=mesh.device)
        ts = torch.as_tensor(ts, device=mesh.device)
        if xs.shape[0] != microbatches or ts.shape[0] != microbatches:
            raise ValueError(
                f"grad step built for microbatches={microbatches}; got "
                f"{xs.shape[0]} input and {ts.shape[0]} target microbatches"
            )
        live = [{k: v.detach().requires_grad_(True) for k, v in p.items()} for p in params]
        leaves = [v for p in live for v in p.values()]
        acc = None
        loss_sum = cnt = 0.0
        for i in range(microbatches):
            y = apply_stack_local(live, mesh.split(xs[i]), plan)
            s, c = loss_local(y, mesh.split(ts[i]))
            g = torch.autograd.grad(s, leaves, allow_unused=True)
            g = [torch.zeros_like(v) if gi is None else gi for v, gi in zip(leaves, g)]
            if acc is None:
                acc = g
            else:
                for a, gi in zip(acc, g):
                    a.add_(gi)
            loss_sum = loss_sum + s.detach()
            cnt = cnt + c
        it = iter(a / cnt for a in acc)
        grads = [{k: next(it) for k in p} for p in live]
        return loss_sum / cnt, grads

    return step


def make_tiled_infer(plan: StackPlan, mesh: TileMesh):
    """The serve step: ``make_tiled_forward`` of a forward-only plan, run
    under ``torch.inference_mode``.  Training plans are refused, so the
    train/serve BN semantics stay an explicit plan-time choice."""
    if not plan.inference:
        raise ValueError(
            "make_tiled_infer needs a forward-only plan: build with "
            "build_stack_plan(..., inference=True) or take "
            "plan.inference_twin(); training plans use batch BN statistics"
        )
    fwd = make_tiled_forward(plan, mesh)

    def infer(params, x):
        with torch.inference_mode():
            return fwd(params, x)

    return infer


def reference_forward(params, x, plan: StackPlan):
    return stack_reference(x, params, plan.layers, inference=plan.inference)


def reference_loss(params, x, target, plan: StackPlan, loss_local):
    """The untiled loss: ``reference_forward`` then ``loss_local`` over the
    whole map."""
    y = reference_forward(params, x, plan)
    s, c = loss_local(y, target)
    return s / c
