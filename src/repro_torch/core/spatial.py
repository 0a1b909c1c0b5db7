"""Tiled spatial (H x W) convolution / pooling primitives (paper §4.1).

The uniform-partition subset of ``repro/core/spatial.py``, plus the overlap
split geometry (``split_1d``) the cost model reads.  Layout: NHWC
activations, HWIO filters, as in the reference.  Tiled functions run on the
virtual tile mesh: a tile batch is one tensor ``(n, m, B, h, w, C)``, and
each conv or pool runs once over all tiles reshaped to ``(n*m*B, h, w, C)``.

For a layer with kernel K, stride S and padding P the tile-level halo is
``halo_lo = P``, ``halo_hi = K - S - P``; a VALID conv over the
halo-extended tile reproduces the global padded conv exactly, because edge
tiles receive zeros.  Training BN (``_bn_tiled``) takes exact cross-tile
batch statistics: a sum over the tile dimensions is the reference's
``psum``, and autograd differentiates through it as ``jax.grad`` does
through ``shard_map``; on ranks (``parallel/dist.py``) the block's sums are
all-reduced.  Inference BN from frozen statistics is elementwise and needs
no collective.

Two executors beside the sync layer: the overlap schedule's group lead
(``apply_group_lead_overlap``: packed exchange, interior conv on owned data,
boundary strips once the strips land) and the hybrid plans' data-mode
layers (``reshard_spatial_to_data`` turns the tile grid into batch blocks of
full maps; ``apply_layer_data`` runs a layer on them with no exchange).

Non-uniform partitions (DESIGN.md §8-9) keep the tiles in a padded layout
``(n, m, B, Hc, Wc, C)`` - every tile at the canonical extent, its valid
window first - and run one of two layers: the padded executor's
(``apply_layer_local_ragged``: one conv over every padded tile, then
validity masks that keep pad slots zero) or the shape-specialised one's
(``apply_layer_local_spec``: one conv per tile-shape class over the tiles'
TRUE extents).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn.functional as F

from repro_torch.core.backend import ACTIVATIONS as _ACTIVATIONS
from repro_torch.core.backend import get_conv_backend, pad_for_valid
from repro_torch.core.halo import WireCtx, _residual, halo_exchange_1d_packed
from repro_torch.optim.compression import ef_encode
from repro_torch.launch.mesh import plan_constant, unpack_grid
from repro_torch.core.tiling import ConvSpec
from repro_torch.parallel.dist import active_tile_mesh, all_reduce_sum

# ---------------------------------------------------------------------------
# Layer definitions (geometry + compute attributes)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LayerDef:
    """One conv or pool layer of a spatial stack."""

    kernel: int
    stride: int = 1
    in_channels: int = 0
    out_channels: int = 0
    pool: bool = False           # max-pool (no params) if True
    pad: int | None = None       # symmetric padding; default K//2 conv, 0 pool
    act: str = "leaky"
    use_bias: bool = True
    batch_norm: bool = False     # BN w/ exact cross-tile statistics

    @property
    def padding(self) -> int:
        if self.pad is not None:
            return self.pad
        return 0 if self.pool else self.kernel // 2

    @property
    def halo(self) -> tuple[int, int]:
        lo = self.padding
        hi = self.kernel - self.stride - lo
        if hi < 0:
            raise ValueError(
                f"unsupported geometry K={self.kernel} S={self.stride} P={lo}"
            )
        return lo, hi

    def spec(self) -> ConvSpec:
        return ConvSpec(
            kernel=self.kernel,
            stride=self.stride,
            in_channels=self.in_channels,
            out_channels=self.out_channels,
            pool=self.pool,
        )

    def out_extent(self, h: int) -> int:
        return (h + 2 * self.padding - self.kernel) // self.stride + 1


def init_layer_params(
    gen: torch.Generator, layer: LayerDef, dtype=torch.float32, device="cpu"
) -> dict:
    """He-initialised conv params; empty dict for pools.  Drawn from the CPU
    generator ``gen`` and then moved, so a seed gives the same params on
    every device (not the JAX package's numbers: the RNGs differ)."""
    if layer.pool:
        return {}
    k = layer.kernel
    fan_in = k * k * layer.in_channels
    w = torch.randn((k, k, layer.in_channels, layer.out_channels), generator=gen,
                    dtype=dtype) * math.sqrt(2.0 / fan_in)
    params = {"w": w.to(device)}
    if layer.use_bias:
        params["b"] = torch.zeros(layer.out_channels, dtype=dtype, device=device)
    if layer.batch_norm:
        params["bn_scale"] = torch.ones(layer.out_channels, dtype=dtype, device=device)
        params["bn_bias"] = torch.zeros(layer.out_channels, dtype=dtype, device=device)
    return params


def init_stack_params(
    gen: torch.Generator, layers: Sequence[LayerDef], dtype=torch.float32, device="cpu"
) -> list[dict]:
    return [init_layer_params(gen, l, dtype, device) for l in layers]


# ---------------------------------------------------------------------------
# Untiled reference (the oracle every tiled path is tested against)
# ---------------------------------------------------------------------------


def conv2d_same(x: torch.Tensor, w: torch.Tensor, stride: int, pad: int) -> torch.Tensor:
    return F.conv2d(
        x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), stride=stride, padding=pad
    ).permute(0, 2, 3, 1)


def maxpool2d(x: torch.Tensor, kernel: int, stride: int, pad: int) -> torch.Tensor:
    xp = F.pad(x, (0, 0, pad, pad, pad, pad), value=float("-inf")) if pad else x
    return _valid_pool(xp, kernel, stride)


def _bn_apply(x, mean, var, scale, bias, eps=1e-5):
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def _bn_infer(y: torch.Tensor, params: dict, layer: LayerDef) -> torch.Tensor:
    """Inference-mode BN from the frozen ``bn_mean`` / ``bn_var`` params:
    elementwise, so safe on halo slots and free of collectives."""
    if "bn_mean" not in params or "bn_var" not in params:
        raise ValueError(
            "inference plan needs frozen BN statistics: params lack "
            "bn_mean/bn_var - attach them with freeze_bn_stats(params, "
            "layers, calibration_batch) before building the serve step"
        )
    return _bn_apply(
        y, params["bn_mean"], params["bn_var"], params["bn_scale"], params["bn_bias"]
    )


def apply_layer_reference(
    x: torch.Tensor, params: dict, layer: LayerDef, *, inference: bool = False
) -> torch.Tensor:
    """Global (untiled) forward of one layer - the exactness oracle.
    ``inference=True`` applies BN from the frozen statistics."""
    p = layer.padding
    if layer.pool:
        return maxpool2d(x, layer.kernel, layer.stride, p)
    y = conv2d_same(x, params["w"], layer.stride, p)
    if layer.use_bias:
        y = y + params["b"]
    if layer.batch_norm:
        if inference:
            y = _bn_infer(y, params, layer)
        else:
            mean = torch.mean(y, dim=(0, 1, 2))
            var = torch.mean(torch.square(y - mean), dim=(0, 1, 2))
            y = _bn_apply(y, mean, var, params["bn_scale"], params["bn_bias"])
    return _ACTIVATIONS[layer.act](y)


def stack_reference(
    x: torch.Tensor,
    params: Sequence[dict],
    layers: Sequence[LayerDef],
    *,
    inference: bool = False,
) -> torch.Tensor:
    for p, l in zip(params, layers):
        x = apply_layer_reference(x, p, l, inference=inference)
    return x.contiguous()


@torch.no_grad()
def freeze_bn_stats(
    params: Sequence[dict], layers: Sequence[LayerDef], x: torch.Tensor
) -> list[dict]:
    """A copy of ``params`` where every BN layer gains ``bn_mean`` /
    ``bn_var``: the batch statistics of the calibration batch ``x`` pushed
    through the training-mode reference forward.  With the same batch, the
    inference forward then reproduces the training forward."""
    out = []
    for p, l in zip(params, layers):
        p = dict(p)
        if l.batch_norm and not l.pool:
            y = conv2d_same(x, p["w"], l.stride, l.padding)
            if l.use_bias:
                y = y + p["b"]
            mean = torch.mean(y, dim=(0, 1, 2))
            var = torch.mean(torch.square(y - mean), dim=(0, 1, 2))
            p["bn_mean"], p["bn_var"] = mean, var
            x = apply_layer_reference(x, p, l, inference=True)
        else:
            x = apply_layer_reference(x, p, l)
        out.append(p)
    return out


# ---------------------------------------------------------------------------
# Tiled compute on the virtual mesh: tiles are (n, m, B, h, w, C)
# ---------------------------------------------------------------------------


def _valid_pool(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """VALID NHWC max pool."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), kernel, stride)
    return y.permute(0, 2, 3, 1).contiguous()


def _offmap_mask(
    n: int,
    m: int,
    ext_h: int,
    ext_w: int,
    halo: tuple[int, int, int, int],
    shard_hw: tuple[int, int],
    map_hw: tuple[int, int],
    device=None,
    origin: tuple[int, int] = (0, 0),
) -> torch.Tensor:
    """(n, m, ext_h, ext_w) 0/1 mask of positions inside the true map bounds,
    per tile of a block whose first tile is tile ``origin`` of the grid.
    Grouped execution computes values at off-map positions of intermediate
    layers; the untiled oracle treats those positions as zero padding, so
    they are zeroed before they feed the next conv."""
    rows = ((torch.arange(n, device=device)[:, None] + origin[0]) * shard_hw[0] - halo[0]
            + torch.arange(ext_h, device=device)[None, :])            # (n, ext_h)
    cols = ((torch.arange(m, device=device)[:, None] + origin[1]) * shard_hw[1] - halo[2]
            + torch.arange(ext_w, device=device)[None, :])            # (m, ext_w)
    rmask = (rows >= 0) & (rows < map_hw[0])
    cmask = (cols >= 0) & (cols < map_hw[1])
    return (rmask[:, None, :, None] & cmask[None, :, None, :]).to(torch.float32)


def _core_mask(
    ext_h: int, ext_w: int, halo: tuple[int, int, int, int], device=None
) -> torch.Tensor:
    """Mask selecting the core (owned) region of a halo-extended tile."""
    top, bottom, left, right = halo
    r = torch.arange(ext_h, device=device)
    c = torch.arange(ext_w, device=device)
    rmask = (r >= top) & (r < ext_h - bottom)
    cmask = (c >= left) & (c < ext_w - right)
    return (rmask[:, None] & cmask[None, :]).to(torch.float32)


def _bn_tiled(y, layer, params, core_halo, n_global):
    """Exact cross-tile batch norm on tiles ``(n, m, B, h, w, C)``:
    statistics over core (owned) positions only - halo positions are
    duplicated across tiles and must not be counted twice - summed over the
    tile dimensions (the reference's psum) and over B, h, w; on ranks, the
    block's two sums in one all-reduce.  The variance is the reference's
    ``E[y^2] - mean^2``."""
    ext_h, ext_w = y.shape[3], y.shape[4]
    mask = _core_mask(ext_h, ext_w, core_halo, y.device)[:, :, None].to(y.dtype)
    dims = (0, 1, 2, 3, 4)
    s = torch.sum(y * mask, dim=dims)
    ss = torch.sum(torch.square(y) * mask, dim=dims)
    mesh = active_tile_mesh()
    if mesh is not None:
        s, ss = all_reduce_sum(torch.stack([s, ss]), mesh.group).unbind(0)
    mean = s / n_global
    var = ss / n_global - torch.square(mean)
    return _bn_apply(y, mean, var, params["bn_scale"], params["bn_bias"])


def apply_layer_local(
    x: torch.Tensor,
    params: dict,
    layer: LayerDef,
    *,
    out_halo: tuple[int, int, int, int],
    shard_out_hw: tuple[int, int],
    map_out_hw: tuple[int, int],
    mask_offmap: bool,
    backend: str = "torch",
    block_oh: int | None = None,
    inference: bool = False,
) -> torch.Tensor:
    """One layer on halo-extended tiles ``(n, m, B, H, W, C)`` (input halo
    already present).  ``out_halo``: remaining halo on the output (0s when
    the layer ends its group); ``mask_offmap`` zeroes off-map positions a
    later layer of the group would consume.  Training BN statistics
    average over the B images of the map."""
    n, m, b = x.shape[:3]
    y, fused = _conv_or_pool(x.reshape(n * m * b, *x.shape[3:]), params, layer,
                             backend, block_oh)
    return _finish_layer(
        y.reshape(n, m, b, *y.shape[1:]),
        params,
        layer,
        fused=fused,
        out_halo=out_halo,
        shard_out_hw=shard_out_hw,
        map_out_hw=map_out_hw,
        mask_offmap=mask_offmap,
        inference=inference,
    )


def _conv_or_pool(
    x: torch.Tensor,
    params: dict,
    layer: LayerDef,
    backend: str,
    block_oh: int | None = None,
) -> tuple[torch.Tensor, bool]:
    """VALID conv/pool of an NHWC tile batch through the backend registry.
    Returns ``(y, fused)``: ``fused`` says the backend applied the
    activation."""
    if layer.pool:
        return _valid_pool(x, layer.kernel, layer.stride), False
    be = get_conv_backend(backend)
    fused = (not layer.batch_norm) and layer.act in be.fused_acts
    b = params["b"] if layer.use_bias else None
    y = be(x, params["w"], b, stride=layer.stride,
           act=layer.act if fused else "linear", block_oh=block_oh)
    return y, fused


def _finish_layer(
    y: torch.Tensor,
    params: dict,
    layer: LayerDef,
    *,
    fused: bool,
    out_halo: tuple[int, int, int, int],
    shard_out_hw: tuple[int, int],
    map_out_hw: tuple[int, int],
    mask_offmap: bool,
    inference: bool = False,
    batch_global: int | None = None,
) -> torch.Tensor:
    """Post-conv tail on tiles ``(n, m, B, h, w, C)``: cross-tile BN
    (frozen-stats BN for inference plans), unfused activation, off-map
    masking.  ``batch_global`` is the images of the map the statistics
    average over (default B: on spatial tiles every tile holds them all;
    after a crossover each tile holds a batch block of them)."""
    if layer.batch_norm and not layer.pool:
        if inference:
            y = _bn_infer(y, params, layer)
        else:
            bg = y.shape[2] if batch_global is None else batch_global
            n_global = bg * map_out_hw[0] * map_out_hw[1]
            y = _bn_tiled(y, layer, params, out_halo, n_global)
    if not fused:
        y = _ACTIVATIONS[layer.act](y)
    if mask_offmap and any(h > 0 for h in out_halo):
        n, m, _, eh, ew, _ = y.shape
        mesh = active_tile_mesh()
        mask = _offmap_mask(n, m, eh, ew, out_halo, shard_out_hw, map_out_hw, y.device,
                            (0, 0) if mesh is None else mesh.origin)
        y = y * mask[:, :, None, :, :, None].to(y.dtype)
    return y


# ---------------------------------------------------------------------------
# Ragged (non-uniform partition) execution: padded-to-max tiles + validity
# masks (DESIGN.md §8)
# ---------------------------------------------------------------------------


def _fit_extent(y: torch.Tensor, target_hw: tuple[int, int],
                dims: tuple[int, int] = (3, 4)) -> torch.Tensor:
    """Pad (zeros) or slice ``y`` to the canonical static extent the next
    ragged layer expects.  Slots beyond every tile's valid count are
    re-zeroed by the validity mask (padded) or never read (spec)."""
    for d, tgt in zip(dims, target_hw):
        cur = y.shape[d]
        if cur > tgt:
            y = y.narrow(d, 0, tgt)
        elif cur < tgt:
            pad = [0, 0] * (y.dim() - 1 - d) + [0, tgt - cur]
            y = F.pad(y, pad)
    return y


def _axis_span(lo: int, sizes, ext: int, device) -> torch.Tensor:
    """(tiles, ext) bool: slots ``[lo, lo + sizes[i])`` of each tile along
    one axis."""
    slot = torch.arange(ext, device=device)[None, :]
    return (slot >= lo) & (slot < lo + plan_constant(tuple(sizes), device)[:, None])


def _axis_on_map(offsets, lo: int, ext: int, extent: int, device) -> torch.Tensor:
    """(tiles, ext) bool: slots whose global position ``offsets[i] - lo +
    slot`` lies inside the map ``[0, extent)``."""
    g = plan_constant(tuple(offsets), device)[:, None] - lo + torch.arange(ext, device=device)
    return (g >= 0) & (g < extent)


def _grid_mask(r: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return (r[:, None, :, None] & c[None, :, None, :]).to(torch.float32)


def _ragged_mask(
    ext_h: int,
    ext_w: int,
    halo: tuple[int, int, int, int],
    out_size: tuple[tuple[int, ...], tuple[int, ...]],
    out_off: tuple[tuple[int, ...], tuple[int, ...]],
    map_hw: tuple[int, int],
    device=None,
) -> torch.Tensor:
    """(n, m, ext_h, ext_w) 0/1 mask over ragged tiles' canonical extended
    output.  A slot survives iff it is inside its tile's valid window (rows
    ``[0, top + own_i + bottom)``, the rest being pad slots) and inside the
    true map (the off-map clause of ``_offmap_mask``, with the tile origin
    read from the boundary table).  Zeroing both restores the padded-tile
    invariant - pad slots exactly zero - that the exchange, BN statistics,
    loss sums and the weight-gradient partial sums rely on."""
    top, bottom, left, right = halo
    r = (_axis_span(0, [top + s + bottom for s in out_size[0]], ext_h, device)
         & _axis_on_map(out_off[0], top, ext_h, map_hw[0], device))
    c = (_axis_span(0, [left + s + right for s in out_size[1]], ext_w, device)
         & _axis_on_map(out_off[1], left, ext_w, map_hw[1], device))
    return _grid_mask(r, c)


def _core_mask_ragged(
    ext_h: int,
    ext_w: int,
    halo: tuple[int, int, int, int],
    out_size: tuple[tuple[int, ...], tuple[int, ...]],
    device=None,
) -> torch.Tensor:
    """(n, m, ext_h, ext_w) core (owned) region of ragged halo-extended
    tiles: rows ``[top, top + own_i)``, cols ``[left, left + own_j)``."""
    return _grid_mask(_axis_span(halo[0], out_size[0], ext_h, device),
                      _axis_span(halo[2], out_size[1], ext_w, device))


def apply_layer_local_ragged(
    x: torch.Tensor,
    params: dict,
    layer: LayerDef,
    *,
    out_halo: tuple[int, int, int, int],
    out_size: tuple[tuple[int, ...], tuple[int, ...]],
    out_off: tuple[tuple[int, ...], tuple[int, ...]],
    canon_out_hw: tuple[int, int],
    map_out_hw: tuple[int, int],
    backend: str = "torch",
    block_oh: int | None = None,
    inference: bool = False,
    batch_global: int | None = None,
) -> torch.Tensor:
    """One layer of ragged tiles in the padded layout ``(n, m, B, Hc, Wc,
    C)`` (valid window ``[0, lo + own + hi)``, zeros beyond): ONE conv over
    every padded tile - a valid output's window reads only valid or
    correctly zero slots (the padded-tile invariant and stride-aligned
    boundaries, DESIGN.md §8) - then the output is refit to the canonical
    extent, BN takes its statistics over each tile's ragged core, and the
    combined validity / off-map mask re-zeroes the pad slots for the next
    layer.  ``out_size`` / ``out_off``: per-axis tile extents and map
    offsets at the layer output."""
    n, m, b = x.shape[:3]
    y, fused = _conv_or_pool(x.reshape(n * m * b, *x.shape[3:]), params, layer, backend,
                             block_oh)
    y = _fit_extent(y.reshape(n, m, b, *y.shape[1:]), canon_out_hw)
    eh, ew = y.shape[3], y.shape[4]
    if layer.batch_norm and not layer.pool:
        if inference:
            y = _bn_infer(y, params, layer)   # elementwise; pad slots re-zeroed below
        else:
            bg = b if batch_global is None else batch_global
            n_global = bg * map_out_hw[0] * map_out_hw[1]
            mask = _core_mask_ragged(eh, ew, out_halo, out_size, y.device)
            mask = mask[:, :, None, :, :, None].to(y.dtype)
            dims = (0, 1, 2, 3, 4)
            mean = torch.sum(y * mask, dim=dims) / n_global
            var = torch.sum(torch.square(y) * mask, dim=dims) / n_global - torch.square(mean)
            y = _bn_apply(y, mean, var, params["bn_scale"], params["bn_bias"])
    if not fused:
        y = _ACTIVATIONS[layer.act](y)
    mask = _ragged_mask(eh, ew, out_halo, out_size, out_off, map_out_hw, y.device)
    return y * mask[:, :, None, :, :, None].to(y.dtype)


# ---------------------------------------------------------------------------
# Shape-specialised (non-uniform partition) execution: one program per
# distinct tile shape (DESIGN.md §9)
# ---------------------------------------------------------------------------


def _offmap_mask_spec(
    ext_h: int,
    ext_w: int,
    halo: tuple[int, int, int, int],
    out_off: tuple[tuple[int, ...], tuple[int, ...]],
    map_hw: tuple[int, int],
    device=None,
) -> torch.Tensor:
    """(n, m, ext_h, ext_w) off-map rim mask of specialised ragged tiles:
    ``_ragged_mask`` without the validity clause.  The spec executor never
    reads pad slots (each consumer takes its class's valid window), so only
    the oracle's SAME padding is left to enforce: mid-group halo slots off
    the true map are zeroed before the next conv reads them."""
    return _grid_mask(_axis_on_map(out_off[0], halo[0], ext_h, map_hw[0], device),
                      _axis_on_map(out_off[1], halo[2], ext_w, map_hw[1], device))


def _conv_or_pool_spec(
    x: torch.Tensor,
    params: dict,
    layer: LayerDef,
    backend: str,
    block_oh: int | None,
    out_hw: tuple[int, int],
) -> tuple[torch.Tensor, bool]:
    """``_conv_or_pool`` on one shape class's valid windows, held to the
    planner's output extent.  The reference routes this call through
    ``_conv_valid_s1`` and ``_pool_nonoverlap`` only to dodge XLA-CPU's
    slow paths inside ``lax.switch`` branches; their semantics are the plain
    conv's and pool's (``F.max_pool2d``'s backward, like
    ``select_and_scatter``, sends a tied window's gradient to its first
    maximum in row-major order), so the port calls ``_conv_or_pool``."""
    y, fused = _conv_or_pool(x, params, layer, backend, block_oh)
    if tuple(y.shape[1:3]) != tuple(out_hw):
        raise AssertionError(
            f"spec class geometry drift: conv of {tuple(x.shape[1:3])} gave "
            f"{tuple(y.shape[1:3])}, planner said {tuple(out_hw)}"
        )
    return y, fused


def apply_layer_local_spec(
    x: torch.Tensor,
    params: dict,
    layer: LayerDef,
    *,
    classes: Sequence[tuple[int, ...]],
    class_io: Sequence[tuple[tuple[int, int], tuple[int, int]]],
    out_halo: tuple[int, int, int, int],
    canon_out_hw: tuple[int, int],
    map_out_hw: tuple[int, int],
    out_off: tuple[tuple[int, ...], tuple[int, ...]] | None,
    mask_offmap: bool = False,
    backend: str = "torch",
    block_oh: int | None = None,
    inference: bool = False,
    batch_global: int | None = None,
) -> torch.Tensor:
    """One layer of shape-specialised ragged tiles (DESIGN.md §9), the
    counterpart of the reference's one ``lax.switch`` branch per distinct
    (row, col) shape.  ``classes[k]`` are the flat indices ``i * m + j`` of
    class k's tiles, ``class_io[k] = ((vin_r, vin_c), (vout_r, vout_c))`` its
    valid extended input and output extents.  Per class: the tiles are
    index-selected out of the padded ``(n, m, B, Hc, Wc, C)`` layout, sliced
    to their true window, and convolved in ONE call on ``(count * B, vin_r,
    vin_c, C)`` - one kernel launch per class and layer, no MACs on pad
    slots; BN sums run over the class's true core, and the output is repadded
    to the canonical extent and gathered back into tile order.  Pad slots
    beyond a class's window hold whatever BN and the activation make of the
    zeros (never read: every consumer takes valid windows), and autograd gives
    them zero cotangent, as AD does in the reference."""
    n, m, b = x.shape[:3]
    bn_stats = layer.batch_norm and not layer.pool and not inference
    flat = x.reshape(n * m, b, *x.shape[3:])
    outs, s, ss, fused = [], 0.0, 0.0, False
    for tiles, ((vin_r, vin_c), (vout_r, vout_c)) in zip(classes, class_io):
        xv = flat[:, :, :vin_r, :vin_c]
        if len(tiles) < n * m:
            xv = xv.index_select(0, plan_constant(tuple(tiles), x.device))
        y, fused = _conv_or_pool_spec(xv.reshape(len(tiles) * b, *xv.shape[2:]), params, layer,
                                      backend, block_oh, (vout_r, vout_c))
        y = y.reshape(len(tiles), b, *y.shape[1:])
        if bn_stats:
            top, bottom, left, right = out_halo
            core = y[:, :, top:vout_r - bottom, left:vout_c - right]
            s = s + torch.sum(core, dim=(0, 1, 2, 3))
            ss = ss + torch.sum(torch.square(core), dim=(0, 1, 2, 3))
        outs.append(_fit_extent(y, canon_out_hw, dims=(2, 3)))
    y = outs[0] if len(outs) == 1 else torch.cat(outs)
    order = [t for tiles in classes for t in tiles]
    if order != list(range(n * m)):
        inv = [0] * len(order)
        for k, t in enumerate(order):
            inv[t] = k
        y = y.index_select(0, plan_constant(tuple(inv), y.device))
    y = y.reshape(n, m, b, *y.shape[2:])
    if bn_stats:
        bg = b if batch_global is None else batch_global
        n_global = bg * map_out_hw[0] * map_out_hw[1]
        mean = s / n_global
        var = ss / n_global - torch.square(mean)
        y = _bn_apply(y, mean, var, params["bn_scale"], params["bn_bias"])
    elif layer.batch_norm and not layer.pool:
        y = _bn_infer(y, params, layer)
    if not fused:
        y = _ACTIVATIONS[layer.act](y)
    if mask_offmap and any(out_halo):
        mask = _offmap_mask_spec(y.shape[3], y.shape[4], out_halo, out_off, map_out_hw, y.device)
        y = y * mask[:, :, None, :, :, None].to(y.dtype)
    return y


# ---------------------------------------------------------------------------
# Hybrid partitioning: spatial->data reshard + data-mode (full-map) layers
# ---------------------------------------------------------------------------


def _batch_block_slice(x: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """Full maps (b, H, W, C) -> batch blocks (n, m, b/(n*m), H, W, C): tile
    (i, j) keeps batch block i*m + j, the reference's ``P((row_axis,
    col_axis))`` batch sharding of the data-mode tail."""
    t = n * m
    b = x.shape[0]
    if b % t:
        raise ValueError(
            f"data-mode batch split needs the per-microbatch batch ({b}) "
            f"divisible by the tile count ({n}x{m}={t})"
        )
    return x.reshape(n, m, b // t, *x.shape[1:])


def _sum_in_order(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` one index after another, in index order."""
    acc = t.select(dim, 0)
    for k in range(1, t.shape[dim]):
        acc = acc + t.select(dim, k)
    return acc


def _ef_chunks(codec, chunks: torch.Tensor, res: list, dim: int):
    """EF-encode every (sender, destination) chunk of ``chunks`` (the
    destination at ``dim``) against its own residual; -> (the decoded
    chunks, each destination's new residual)."""
    payload, new = ef_encode(codec, chunks, torch.stack(res, dim), dim + 1)
    applied = codec.decode(payload, chunks.shape, torch.float32, dim + 1)
    return applied, list(new.unbind(dim))


class _WireAllGather(torch.autograd.Function):
    """The reference's two compressed tiled all-gathers (rows, then
    columns) of the tile grid ``(n, m, b, h, w, C)`` into the full maps
    ``(b, n*h, m*w, C)`` every device holds.  Forward: each tile's block is
    encoded on its own, its own block included; the row-gathered array of
    tile column j, the same on every tile of the column, is encoded once
    per column.  Backward, modelled per device: a device's cotangent is its
    batch block's only (the full maps are consumed by ``_batch_block_slice``
    alone); each device splits it into one chunk per destination, EF-encodes
    each chunk against the residual of its (sender, destination) pair, and
    each destination sums the decoded chunks in source order - columns
    first, then rows.  The new residuals are the gradients of ``res``."""

    @staticmethod
    def forward(ctx, x, codec, *res):
        n, m, b, h, w, c = x.shape
        ctx.codec, ctx.shape = codec, x.shape
        ctx.save_for_backward(*res)
        own = codec.decode(codec.encode(x, 2), x.shape, x.dtype, 2)
        rows = own.permute(1, 2, 0, 3, 4, 5).reshape(m, b, n * h, w, c)
        rows = codec.decode(codec.encode(rows, 1), rows.shape, rows.dtype, 1)
        return rows.permute(1, 2, 0, 3, 4).reshape(b, n * h, m * w, c)

    @staticmethod
    def backward(ctx, ct):
        n, m, b, h, w, c = ctx.shape
        codec, t = ctx.codec, n * m
        res = list(ctx.saved_tensors)
        blocks = ct.reshape(t, b // t, *ct.shape[1:])
        per_dev = ct.new_zeros((t, t, *blocks.shape[1:]))
        per_dev.diagonal(0, 0, 1).copy_(blocks.movedim(0, -1))   # device d: block d only
        per_dev = per_dev.reshape(n, m, b, n * h, m * w, c)
        # column gather: device (i, j) sends chunk j' of its columns to (i, j')
        chunks = per_dev.reshape(n, m, b, n * h, m, w, c).permute(0, 1, 4, 2, 3, 5, 6)
        applied, new_col = _ef_chunks(codec, chunks, res[n:], 2)
        rows_ct = _sum_in_order(applied, 1)                       # (n, m, b, n*h, w, c)
        # row gather: device (i, j) sends chunk i' of its rows to (i', j)
        chunks = rows_ct.reshape(n, m, b, n, h, w, c).permute(0, 1, 3, 2, 4, 5, 6)
        applied, new_row = _ef_chunks(codec, chunks, res[:n], 2)
        ct_x = _sum_in_order(applied, 0).transpose(0, 1)          # (n, m, b, h, w, c)
        return (ct_x.to(ct.dtype), None, *new_row, *new_col)


def _wire_all_gather(x: torch.Tensor, wire: WireCtx) -> torch.Tensor:
    """Tiles ``(n, m, b, h, w, C)`` -> the full maps ``(b, n*h, m*w, C)``
    through the compressed all-gathers (``_WireAllGather``), with the
    residuals drawn in the reference's order: n for the row gather, then m
    for the column gather (one per destination); none when ``x`` takes no
    gradient (``halo.wire_shift`` says why)."""
    n, m, b, h, w, c = x.shape
    res = [_residual(wire, x.shape, x) for _ in range(n)]
    res += [_residual(wire, (n, m, b, n * h, w, c), x) for _ in range(m)]
    return _WireAllGather.apply(x, wire.codec, *res)


def reshard_spatial_to_data(x: torch.Tensor, wire: WireCtx | None = None) -> torch.Tensor:
    """The spatial->data crossover (DESIGN.md §7): core tiles
    ``(n, m, b, h, w, C)`` (halo consumed by the previous group) -> batch
    blocks of full maps ``(n, m, b/(n*m), n*h, m*w, C)``, tile (i, j)
    holding batch block i*m + j.

    The reference all-gathers the tile grid (``_wire_all_gather``, twice)
    and slices each device's block (``_batch_block_slice``).  On the
    virtual mesh that is one merge and one reshape - no tile gets the full
    batch's maps - and autograd gives the adjoint (the reduce-scatter and
    the zero-padded scatter) as ``jax.grad`` does.  Under a codec the merge
    goes through the compressed gathers."""
    n, m, b, h, w, c = x.shape
    if wire is not None:
        return _batch_block_slice(_wire_all_gather(x, wire), n, m)
    full = x.permute(2, 0, 3, 1, 4, 5).reshape(b, n * h, m * w, c)
    return _batch_block_slice(full, n, m)


def reshard_spatial_to_data_ragged(
    x: torch.Tensor, row_sizes: tuple[int, ...], col_sizes: tuple[int, ...],
    wire: WireCtx | None = None,
) -> torch.Tensor:
    """The spatial->data crossover of ragged tiles: the padded core tiles
    ``(n, m, b, Hmax, Wmax, C)`` are stitched back into full maps from each
    tile's valid window (the boundary tables are plan constants, so this is
    ``TileMesh.merge``'s gather), then split into batch blocks as
    ``reshard_spatial_to_data`` does.  Autograd gives the adjoint: the
    scatter back into padded tiles.  Under a codec the padded tiles, pad
    slots included, go through the compressed gathers first."""
    n, m, b, hmax, wmax, c = x.shape
    if (n, m) != (len(row_sizes), len(col_sizes)) or (hmax, wmax) != (max(row_sizes),
                                                                      max(col_sizes)):
        raise ValueError(
            f"padded tiles {tuple(x.shape)} inconsistent with sizes {row_sizes} x {col_sizes}"
        )
    if wire is not None:
        full = _wire_all_gather(x, wire)
    else:
        full = x.permute(2, 0, 3, 1, 4, 5).reshape(b, n * hmax, m * wmax, c)
    return _batch_block_slice(unpack_grid(full, row_sizes, col_sizes), n, m)


def apply_layer_data(
    x: torch.Tensor,
    params: dict,
    layer: LayerDef,
    *,
    map_out_hw: tuple[int, int],
    batch_global: int,
    backend: str = "torch",
    block_oh: int | None = None,
    inference: bool = False,
) -> torch.Tensor:
    """One data-mode layer on batch blocks of full, unhaloed maps
    ``(n, m, bs, H, W, C)``.  The SAME boundary is materialised locally
    (``pad_for_valid``) so the VALID-only conv backends run unchanged, with
    no exchange.  Training BN sums over the same tile dimensions with the
    global ``batch_global x H x W`` count, so its statistics stay exact
    (each (image, position) lives in exactly one tile)."""
    n, m, bs = x.shape[:3]
    xp = pad_for_valid(x.reshape(n * m * bs, *x.shape[3:]), layer.padding, pool=layer.pool)
    y, fused = _conv_or_pool(xp, params, layer, backend, block_oh)
    return _finish_layer(
        y.reshape(n, m, bs, *y.shape[1:]),
        params,
        layer,
        fused=fused,
        out_halo=(0, 0, 0, 0),
        shard_out_hw=map_out_hw,
        map_out_hw=map_out_hw,
        mask_offmap=False,
        inference=inference,
        batch_global=batch_global,
    )


# ---------------------------------------------------------------------------
# Overlap schedule: interior/boundary split of a group-lead layer
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SplitSpec1D:
    """Static interior/boundary split of one spatial dim of a group-lead
    layer on a halo-extended tile (DESIGN.md §5).

    Output positions (extended coords, ``out`` of them) split into a lo
    boundary band [0, i0), the interior [i0, i1], and a hi boundary band
    (i1, out).  Interior outputs depend only on owned input rows
    [int_in_lo, int_in_hi) (owned coords) - computable before any halo
    strip arrives."""

    out: int        # output extent of the halo-extended tile
    i0: int         # first interior output index
    i1: int         # last interior output index (inclusive)
    int_in_lo: int  # owned-coords input slab [lo, hi) feeding the interior
    int_in_hi: int

    @property
    def n_lo(self) -> int:
        return self.i0

    @property
    def n_hi(self) -> int:
        return self.out - 1 - self.i1


def split_1d(own: int, lo: int, hi: int, kernel: int, stride: int) -> SplitSpec1D | None:
    """Interior/boundary split along one dim, or None when no output is
    computable from owned data alone (tile thinner than the kernel's reach
    into the halo - the executor then falls back to whole-tile compute)."""
    out = (own + lo + hi - kernel) // stride + 1
    i0 = -(-lo // stride)                     # ceil(lo / stride)
    i1 = (lo + own - kernel) // stride
    if i1 < i0:
        return None
    return SplitSpec1D(
        out=out,
        i0=i0,
        i1=i1,
        int_in_lo=i0 * stride - lo,
        int_in_hi=i1 * stride + kernel - lo,
    )


def _assemble(lo: torch.Tensor, core: torch.Tensor, hi: torch.Tensor, w_lo: int, w_hi: int,
              *, dim: int) -> torch.Tensor:
    parts = ([lo] if w_lo > 0 else []) + [core] + ([hi] if w_hi > 0 else [])
    if len(parts) == 1:
        return core
    return torch.cat(parts, dim=dim)


def apply_group_lead_overlap(
    x: torch.Tensor,
    params: dict,
    layer: LayerDef,
    *,
    halo: tuple[int, int, int, int],
    out_halo: tuple[int, int, int, int],
    shard_out_hw: tuple[int, int],
    map_out_hw: tuple[int, int],
    mask_offmap: bool,
    backend: str = "torch",
    block_oh: int | None = None,
    inference: bool = False,
    batch_global: int | None = None,
    wire: WireCtx | None = None,
) -> torch.Tensor:
    """Group-lead layer under the overlap schedule on core tiles
    ``(n, m, B, h, w, C)``: packed halo exchange and interior/boundary
    split execution (DESIGN.md §5).

    The interior of the output depends on owned data only, so its conv is
    issued before any received strip is consumed.  The boundary pieces -
    the left/right strips of the interior rows, then the top/bottom bands -
    are computed from the extended tile, and the pieces are concatenated
    back into ``conv_valid(extended tile)``: every output position comes
    from the identical input window, so the result equals the sync
    schedule's by position.  The sums may run in another order (each piece
    is its own conv call, whose kernel picks its tiling by shape).  Without
    an interior (a tile thinner than the kernel's reach into the halo) the
    whole extended tile is one conv, as in the reference."""
    top, bottom, left, right = halo
    k, s = layer.kernel, layer.stride
    n, m, b, own_h, own_w = x.shape[:5]
    rs = split_1d(own_h, top, bottom, k, s)
    cs = split_1d(own_w, left, right, k, s)

    def conv(slab):
        y, fused = _conv_or_pool(slab.reshape(n * m * b, *slab.shape[3:]), params, layer,
                                 backend, block_oh)
        return y.reshape(n, m, b, *y.shape[1:]), fused

    def finish(y, fused):
        return _finish_layer(y, params, layer, fused=fused, out_halo=out_halo,
                             shard_out_hw=shard_out_hw, map_out_hw=map_out_hw,
                             mask_offmap=mask_offmap, inference=inference,
                             batch_global=batch_global)

    # 1. the packed row exchange (nothing below consumes it yet)
    row_lo, row_hi = halo_exchange_1d_packed(x, top, bottom, tile_dim=0, dim=3, wire=wire)

    if rs is None or cs is None:
        # no interior: whole-tile compute on the assembled extended tile
        ext = _assemble(row_lo, x, row_hi, top, bottom, dim=3)
        col_lo, col_hi = halo_exchange_1d_packed(ext, left, right, tile_dim=1, dim=4, wire=wire)
        ext = _assemble(col_lo, ext, col_hi, left, right, dim=4)
        return finish(*conv(ext))

    # 2. interior compute from owned data only
    y_int, fused = conv(x[:, :, :, rs.int_in_lo:rs.int_in_hi, cs.int_in_lo:cs.int_in_hi])

    # 3. the column exchange over the row-extended tile (carries the corners)
    x_rows = _assemble(row_lo, x, row_hi, top, bottom, dim=3)
    col_lo, col_hi = halo_exchange_1d_packed(x_rows, left, right, tile_dim=1, dim=4, wire=wire)
    ext = _assemble(col_lo, x_rows, col_hi, left, right, dim=4)

    # 4. the boundary pieces from the extended tile (extended coords)
    mid_rows = slice(rs.i0 * s, rs.i1 * s + k)
    mid = [y_int]
    if cs.n_lo:
        mid.insert(0, conv(ext[:, :, :, mid_rows, 0:(cs.i0 - 1) * s + k])[0])
    if cs.n_hi:
        mid.append(conv(ext[:, :, :, mid_rows, (cs.i1 + 1) * s:(cs.out - 1) * s + k])[0])
    bands = [mid[0] if len(mid) == 1 else torch.cat(mid, dim=4)]
    if rs.n_lo:
        bands.insert(0, conv(ext[:, :, :, 0:(rs.i0 - 1) * s + k])[0])
    if rs.n_hi:
        bands.append(conv(ext[:, :, :, (rs.i1 + 1) * s:(rs.out - 1) * s + k])[0])
    y = bands[0] if len(bands) == 1 else torch.cat(bands, dim=3)
    return finish(y, fused)
