"""Parameter, optimizer-state, batch and cache sharding rules:
``repro/parallel/sharding.py``.

Every parameter leaf, by its path (the reference's ``keystr_slash``
spelling, ``ckpt/manager.py:map_with_path``) and rank, maps to logical axes:
dimensions that carry heads, ff, experts or vocab go to the TP axis
("model"), one remaining large dimension to the FSDP axis ("data").  A
stacked segment's leading repeats dimension stays unsharded: each rule is
right-aligned to the trailing dimensions.  Optimizer state mirrors its
parameter (adafactor's factored moments drop the reduced entry).

The resolved specs come from ``parallel.api.logical_spec`` against the
active virtual mesh: a tree of spec tuples under a mesh, of ``None``
without one (where the reference gives a ``NamedSharding`` or ``None``).
A leaf is a tensor, a ``meta`` tensor or a ``TensorSpec``: only its shape is
read.
"""
from __future__ import annotations

from typing import Any, Optional

from repro_torch.ckpt.manager import map_with_path
from repro_torch.parallel.api import active_mesh, logical_spec

# (substring match on path, trailing-dims logical axes), the reference's table
_RULES: list[tuple[str, tuple]] = [
    ("embed", ("vocab", "fsdp")),
    ("lm_head", ("vocab", "fsdp")),
    ("dec_pos", (None, "fsdp")),
    # attention
    ("w_q", ("fsdp", "heads", None)),
    ("w_k", ("fsdp", "kv_heads", None)),
    ("w_v", ("fsdp", "kv_heads", None)),
    ("w_o", ("heads", None, "fsdp")),
    # mla
    ("w_dq", ("fsdp", None)),
    ("w_uq", ("fsdp", "heads", None)),
    ("w_dkv", ("fsdp", None)),
    ("w_uk", ("fsdp", "heads", None)),
    ("w_uv", ("fsdp", "heads", None)),
    # mlp
    ("w_gate", ("fsdp", "ff")),
    ("w_up", ("fsdp", "ff")),
    ("w_down", ("ff", "fsdp")),
    # moe: a leading experts dim; the longest matching pattern wins
    ("moe/w_gate", ("experts", "fsdp", None)),
    ("moe/w_up", ("experts", "fsdp", None)),
    ("moe/w_down", ("experts", None, "fsdp")),
    ("router", (None, None)),
    # mamba
    ("w_in", ("fsdp", "ff")),
    ("w_out", ("ff", "fsdp")),
    ("conv_w", (None, None)),
    # mtp
    ("mtp/proj", ("fsdp", None)),
]


def _shape(leaf) -> tuple:
    """A leaf's shape: a tensor's or spec's, ``()`` for a Python scalar
    (the optimizer's step count)."""
    return tuple(getattr(leaf, "shape", ()))


def _spec_or_none(log: tuple, shape: tuple) -> Optional[tuple]:
    return logical_spec(log, shape) if active_mesh() is not None else None


def logical_for_param(path: str, ndim: int) -> tuple:
    logical: Optional[tuple] = None
    best = -1
    for pat, rule in _RULES:
        if pat in path and len(pat) > best:
            logical = rule
            best = len(pat)
    if logical is None:
        logical = ()
    if len(logical) > ndim:          # e.g. a bias matched under attention
        logical = logical[-ndim:] if ndim else ()
    pad = (None,) * (ndim - len(logical))
    return pad + tuple(logical)


def param_logical_tree(params: Any) -> Any:
    return map_with_path(lambda path, p: logical_for_param(path, len(_shape(p))), params)


def param_shardings(params: Any) -> Any:
    """A tree of resolved specs for the active mesh (``None`` off-mesh)."""

    def leaf(path, p):
        shape = _shape(p)
        return _spec_or_none(logical_for_param(path, len(shape)), shape)

    return map_with_path(leaf, params)


def state_shardings(opt_state: Any, params: Any) -> Any:
    """Optimizer-state specs from the parameter rules: a moment of the
    parameter's shape takes its spec; adafactor's factored ``vr`` / ``vc``
    drop the reduced dimension's entry; anything else (the step count) is
    replicated.  A state leaf takes the rule of the first parameter, in
    path order, whose path its own path contains, as the reference's."""
    flat_params: dict[str, tuple] = {}

    def record(path, p):
        shape = _shape(p)
        flat_params[path] = (shape, logical_for_param(path, len(shape)))
        return p

    map_with_path(record, params)

    def leaf(path, s):
        sshape = _shape(s)
        match = next(((shape, log) for ppath, (shape, log) in flat_params.items()
                      if ppath and ppath in path), None)
        if match is None:
            log: tuple = ()
        else:
            shape, plog = match
            if sshape == shape:
                log = plog
            elif sshape == shape[:-1]:
                log = plog[:-1]
            elif sshape == tuple(shape[:-2]) + tuple(shape[-1:]):
                log = plog[:-2] + plog[-1:]
            else:
                log = ()
        return _spec_or_none(log, sshape)

    return map_with_path(leaf, opt_state)


def batch_shardings(batch_specs: dict) -> dict:
    """Input batch: dim 0 (dim 1 for M-RoPE's (3, B, T) positions) over the
    DP axes."""
    out = {}
    for k, spec in batch_specs.items():
        shape = _shape(spec)
        if k == "positions" and len(shape) == 3:
            log = (None, "batch", None)
        else:
            log = ("batch",) + (None,) * (len(shape) - 1)
        out[k] = _spec_or_none(log, shape)
    return out


def cache_shardings(cache_specs: Any, *, seq_sharded: bool = False) -> Any:
    """KV / MLA / SSM cache specs for serving: batch over the DP axes,
    KV heads over TP; ``seq_sharded`` puts a KV or MLA cache's sequence dim
    on the ``seq_shard`` axis instead (flash-decode, ``decode_attention``)."""

    def leaf(path, s):
        shape = _shape(s)
        nd = len(shape)
        if nd == 0:
            log: tuple = ()
        elif "ssm" in path:                     # (B, H, N, P) state
            log = ("batch", "heads", None, None)
        elif "conv" in path:                    # (B, K-1, conv_dim) ring
            log = ("batch",) + (None,) * (nd - 1)
        elif nd == 4:                           # (B, S, Hkv, Dh) kv cache
            log = (("batch", "seq_shard", None, None) if seq_sharded
                   else ("batch", None, "kv_heads", None))
        elif nd == 3:                           # MLA (B, S, rank) compressed
            log = ("batch", "seq_shard" if seq_sharded else None, None)
        else:
            log = ("batch",) + (None,) * (nd - 1)
        return _spec_or_none(log, shape)

    return map_with_path(leaf, cache_specs)
