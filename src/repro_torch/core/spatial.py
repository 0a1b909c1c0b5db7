"""Tiled spatial (H x W) convolution / pooling primitives (paper §4.1).

The uniform-partition subset of ``repro/core/spatial.py``.  Layout: NHWC
activations, HWIO filters, as in the reference.  Tiled functions run on the
virtual tile mesh: a tile batch is one tensor ``(n, m, B, h, w, C)``, and
each conv or pool runs once over all tiles reshaped to ``(n*m*B, h, w, C)``.

For a layer with kernel K, stride S and padding P the tile-level halo is
``halo_lo = P``, ``halo_hi = K - S - P``; a VALID conv over the
halo-extended tile reproduces the global padded conv exactly, because edge
tiles receive zeros.  Training BN (``_bn_tiled``) takes exact cross-tile
batch statistics: a sum over the tile dimensions is the reference's
``psum``, and autograd differentiates through it as ``jax.grad`` does
through ``shard_map``.  Inference BN from frozen statistics is elementwise
and needs no collective.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn.functional as F

from repro_torch.core.backend import ACTIVATIONS as _ACTIVATIONS, get_conv_backend
from repro_torch.core.tiling import ConvSpec

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
) -> torch.Tensor:
    """(n, m, ext_h, ext_w) 0/1 mask of positions inside the true map bounds,
    per tile.  Grouped execution computes values at off-map positions of
    intermediate layers; the untiled oracle treats those positions as zero
    padding, so they are zeroed before they feed the next conv."""
    rows = (torch.arange(n, device=device)[:, None] * shard_hw[0] - halo[0]
            + torch.arange(ext_h, device=device)[None, :])            # (n, ext_h)
    cols = (torch.arange(m, device=device)[:, None] * shard_hw[1] - halo[2]
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
    tile dimensions (the reference's psum) and over B, h, w.  The variance
    is the reference's ``E[y^2] - mean^2``."""
    ext_h, ext_w = y.shape[3], y.shape[4]
    mask = _core_mask(ext_h, ext_w, core_halo, y.device)[:, :, None].to(y.dtype)
    dims = (0, 1, 2, 3, 4)
    s = torch.sum(y * mask, dim=dims)
    ss = torch.sum(torch.square(y) * mask, dim=dims)
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
) -> torch.Tensor:
    """Post-conv tail on tiles ``(n, m, B, h, w, C)``: cross-tile BN
    (frozen-stats BN for inference plans), unfused activation, off-map
    masking."""
    if layer.batch_norm and not layer.pool:
        if inference:
            y = _bn_infer(y, params, layer)
        else:
            n_global = y.shape[2] * map_out_hw[0] * map_out_hw[1]
            y = _bn_tiled(y, layer, params, out_halo, n_global)
    if not fused:
        y = _ACTIVATIONS[layer.act](y)
    if mask_offmap and any(h > 0 for h in out_halo):
        n, m, _, eh, ew, _ = y.shape
        mask = _offmap_mask(n, m, eh, ew, out_halo, shard_out_hw, map_out_hw, y.device)
        y = y * mask[:, :, None, :, :, None].to(y.dtype)
    return y
