"""Dense (gated) MLP (``repro/models/mlp.py``).  Mixture-of-Experts is
ROADMAP A.18."""
from __future__ import annotations

import torch

from repro_torch.models.common import ACT, dense_init


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, dtype, gated: bool = True,
             bias: bool = False) -> dict:
    p = {
        "w_up": dense_init(gen, (d_model, d_ff), dtype),
        "w_down": dense_init(gen, (d_ff, d_model), dtype, fan_in=d_ff),
    }
    if gated:
        p["w_gate"] = dense_init(gen, (d_model, d_ff), dtype)
    if bias:
        p["b_up"] = torch.zeros((d_ff,), dtype=dtype, device=gen.device)
        p["b_down"] = torch.zeros((d_model,), dtype=dtype, device=gen.device)
    return p


def mlp(params: dict, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    up = x @ params["w_up"]
    if "b_up" in params:
        up = up + params["b_up"]
    if "w_gate" in params:
        h = ACT[act](x @ params["w_gate"]) * up
    else:
        h = ACT[act](up)
    y = h @ params["w_down"]
    if "b_down" in params:
        y = y + params["b_down"]
    return y


def init_moe(*_a, **_k):
    raise NotImplementedError("Mixture-of-Experts layers: ROADMAP A.18")


def moe(*_a, **_k):
    raise NotImplementedError("Mixture-of-Experts layers: ROADMAP A.18")
