"""Logical-axis sharding API: ``repro/parallel/api.py`` on the virtual mesh.

Models annotate activations and params with *logical* axis names; a rules
table maps each to mesh axes, and ``logical_spec`` resolves a tensor's
logical names to a spec - one entry per dimension: ``None``, a mesh axis, or
a tuple of them - with the reference's rules: an axis absent from the mesh,
already used by an earlier dimension, of size 1 or not dividing the
dimension leaves that dimension unsharded.

The mesh is a ``launch/mesh.py:VirtualMesh``: named axes held on one
device.  One device holds every shard, so ``constrain`` places nothing (it
checks the rank, as the reference's does under a mesh, and returns ``x``),
``gather_for_compute`` returns the params as they are, and
``named_sharding`` returns the resolved spec.  What reads the mesh is the
code whose arithmetic depends on it: the MoE dispatch's groups and expert
shards (``models/mlp.py``), the sequence-sharded mixers
(``core/sequence.py``, ``models/mamba2.py``) and the sequence-sharded
decode (``models/attention.py``).

The active mesh and rules are thread-local, as the reference's.  Autograd
runs a CUDA backward - a checkpoint's recomputation included - on a thread
of its own, so code that reads the mesh under a checkpoint re-enters the
forward's with ``captured_ctx``.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence, Union

import torch

from repro_torch.launch.mesh import VirtualMesh

Axis = Union[None, str, tuple[str, ...]]
Spec = tuple

# Logical axis -> mesh axis (or tuple of mesh axes), the reference's table.
DEFAULT_RULES: dict[str, Axis] = {
    "batch": ("pod", "data"),
    "seq": None,              # sequence stays unsharded inside attention/mlp
    "seq_resid": "model",     # sequence-parallel residual stream between blocks
    "seq_shard": "model",     # long-context cache sharding (flash-decode)
    "ce_rows": ("pod", "data"),
    "moe_groups": ("pod", "data"),   # MoE dispatch groups: off the expert axis
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "ff": "model",
    "vocab": "model",
    "experts": "model",
    "expert_ff": None,
    "fsdp": "data",           # parameter sharding (FSDP) dimension
    "conv_tile_h": "data",    # paper-native spatial tiling axes
    "conv_tile_w": "model",
    "state": None,
}

# Named parallelism layouts: rule-override tables (the reference's).
LAYOUTS: dict[str, dict[str, Axis]] = {
    "tp-sp": {},
    "fsdp": {
        "heads": None,
        "kv_heads": None,
        "ff": None,
        "vocab": "model",
        "experts": None,
        "seq_resid": None,
        "fsdp": ("data", "model"),
        "batch": ("pod", "data", "model"),
        "zero3": True,
    },
    "ep-fsdp": {
        "heads": None,
        "kv_heads": None,
        "ff": None,
        "vocab": "model",
        "seq_resid": None,
        "experts": "model",
        "fsdp": ("data", "model"),
        "batch": ("pod", "data", "model"),
        "zero3": True,
    },
}


def layout_rules(layout: str) -> dict[str, Axis]:
    return {**DEFAULT_RULES, **LAYOUTS[layout]}


class _Active(threading.local):
    def __init__(self):
        self.mesh: Optional[VirtualMesh] = None
        self.rules: dict[str, Axis] = dict(DEFAULT_RULES)


_ACTIVE = _Active()


@contextlib.contextmanager
def sharding_ctx(mesh: Optional[VirtualMesh], rules: Optional[dict[str, Axis]] = None):
    """Install ``mesh`` and ``rules`` (over ``DEFAULT_RULES``) for the
    current thread, and restore the previous ones on exit."""
    if mesh is not None and not isinstance(mesh, VirtualMesh):
        raise TypeError(f"expected a launch.mesh.VirtualMesh or None; got {type(mesh).__name__}")
    prev_mesh, prev_rules = _ACTIVE.mesh, _ACTIVE.rules
    _ACTIVE.mesh = mesh
    _ACTIVE.rules = {**DEFAULT_RULES, **(rules or {})}
    try:
        yield
    finally:
        _ACTIVE.mesh, _ACTIVE.rules = prev_mesh, prev_rules


def captured_ctx():
    """A function that re-enters the mesh and rules active now:
    ``enter = captured_ctx()`` in a forward, ``with enter():`` where a
    checkpoint's recomputation or a backward may run on another thread or
    after the forward's ``sharding_ctx`` has closed."""
    mesh, rules = _ACTIVE.mesh, dict(_ACTIVE.rules)
    return lambda: sharding_ctx(mesh, rules)


def active_mesh() -> Optional[VirtualMesh]:
    return _ACTIVE.mesh


def axis_size(mesh_axis: Axis) -> int:
    """The size of a mesh axis (a product for a tuple of axes); 1 without a
    mesh, for ``None`` and for an axis the mesh lacks."""
    mesh = _ACTIVE.mesh
    if mesh is None or mesh_axis is None:
        return 1
    if isinstance(mesh_axis, str):
        return mesh.shape.get(mesh_axis, 1)
    n = 1
    for a in mesh_axis:
        n *= mesh.shape.get(a, 1)
    return n


def _resolve(logical: Sequence[Optional[str]], shape: Sequence[int]) -> Spec:
    """Logical names -> a spec with the reference's divisibility fallback:
    an entry per dimension of ``zip(shape, logical)``."""
    mesh = _ACTIVE.mesh
    spec: list = []
    used: set[str] = set()
    for dim, name in zip(shape, logical):
        if name is None:
            spec.append(None)
            continue
        mesh_axis = _ACTIVE.rules.get(name)
        if mesh_axis is None:
            spec.append(None)
            continue
        axes = (mesh_axis,) if isinstance(mesh_axis, str) else tuple(mesh_axis)
        # drop axes already used by an earlier dim or absent from the mesh
        axes = tuple(a for a in axes if a not in used and (mesh is None or a in mesh.shape))
        size = 1
        for a in axes:
            size *= mesh.shape[a] if mesh is not None else 1
        if not axes or size == 1 or dim % size != 0:
            spec.append(None)
            continue
        used.update(axes)
        spec.append(axes[0] if len(axes) == 1 else axes)
    return tuple(spec)


def logical_spec(logical: Sequence[Optional[str]], shape: Sequence[int]) -> Spec:
    return _resolve(logical, shape)


def constrain(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """The reference's sharding constraint: without a mesh ``x``; under one
    the rank is checked, and ``x`` comes back as it is (one device holds
    every shard)."""
    if _ACTIVE.mesh is None:
        return x
    if len(logical) != x.dim():
        raise ValueError(f"{logical} rank != array rank {tuple(x.shape)}")
    return x


def gather_for_compute(params):
    """The reference's ZeRO-3 materialisation point: on one device every
    parameter is whole already, so ``params`` come back as they are."""
    return params


def named_sharding(logical: Sequence[Optional[str]], shape: Sequence[int]) -> Optional[Spec]:
    """The resolved spec under a mesh (the reference's ``NamedSharding``
    holds the mesh and this spec), ``None`` without one."""
    if _ACTIVE.mesh is None:
        return None
    return _resolve(logical, shape)
