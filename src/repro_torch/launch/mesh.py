"""The virtual tile mesh: an n x m tile grid held on ONE device.

The JAX reference runs ``shard_map`` over an (n, m) device mesh, one tile
per device.  One H100 is one device, so the port keeps the tile grid as
leading tensor dimensions instead: activations live as
``(n, m, B, h, w, C)``, a ``ppermute`` between neighbouring tiles is a
zero-filled shift along the n or m dimension (``core/halo.py``), and each
conv runs once over all tiles reshaped to ``(n*m*B, h, w, C)`` - one kernel
launch per conv layer per dispatch, not n*m.
"""
from __future__ import annotations

import dataclasses

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on.  ``"cuda"`` (the default of every
    entry point) raises when no card is present - the caller must ask for
    ``"cpu"`` explicitly, so a run never lands on the CPU by accident."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain torch path on the CPU"
        )
    return dev


@dataclasses.dataclass(frozen=True)
class TileMesh:
    """n x m tile grid on one device (the counterpart of a 2-D jax Mesh)."""

    n: int
    m: int
    device: torch.device

    def split(self, x: torch.Tensor) -> torch.Tensor:
        """Global (B, H, W, C) -> tiles (n, m, B, H/n, W/m, C)."""
        b, h, w, c = x.shape
        if h % self.n or w % self.m:
            raise ValueError(
                f"map {h}x{w} does not split evenly over the {self.n}x{self.m} grid"
            )
        t = x.reshape(b, self.n, h // self.n, self.m, w // self.m, c)
        return t.permute(1, 3, 0, 2, 4, 5).contiguous()

    def merge(self, t: torch.Tensor) -> torch.Tensor:
        """Tiles (n, m, B, h, w, C) -> global (B, n*h, m*w, C), row-major
        tile order (the inverse of ``split``)."""
        n, m, b, h, w, c = t.shape
        return t.permute(2, 0, 3, 1, 4, 5).reshape(b, n * h, m * w, c)


def make_tile_mesh(n: int, m: int, device: str | torch.device = "cuda") -> TileMesh:
    """Paper-native 2-D tile grid as a virtual mesh on ``device``."""
    if n < 1 or m < 1:
        raise ValueError(f"tile grid must be positive; got {n}x{m}")
    return TileMesh(n, m, resolve_device(device))
