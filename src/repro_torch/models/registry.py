"""Architecture registry: ``--arch <id>`` -> config + model functions + specs
(``repro/models/registry.py``).

Only the configs the port can run resolve: the dense ``qwen2-7b`` (GQA,
QKV bias), ``codeqwen1.5-7b`` (MHA, QKV bias), ``stablelm-1.6b``
(LayerNorm, partial rotary) and ``command-r-35b`` (LayerNorm, parallel
attention||MLP block, tied embeddings), ``mamba2-780m`` (SSD), and the
Mixture-of-Experts ``mixtral-8x22b`` (sliding window),
``jamba-v0.1-52b`` (Mamba, attention without RoPE, MoE on alternate
layers) and ``deepseek-v3-671b`` (MLA, 3 dense layers then 256 routed
experts beside a shared one, an MTP head).  Every other id of the reference raises naming its ROADMAP A.18
item (``ROADMAP_ITEMS``).  A bundle's ``init(seed)`` draws its
params on the bundle's device; ``decode_fn`` and ``make_caches`` are the
serving surface (``models/lm.py:decode_step``, ``init_caches`` on the
bundle's device), and ``cache_specs`` gives the caches' shapes and dtypes
as ``meta`` tensors, allocating nothing.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch.mesh import resolve_device

ARCH_MODULES = {
    "codeqwen1.5-7b": "repro_torch.configs.codeqwen1_5_7b",
    "stablelm-1.6b": "repro_torch.configs.stablelm_1_6b",
    "qwen2-7b": "repro_torch.configs.qwen2_7b",
    "command-r-35b": "repro_torch.configs.command_r_35b",
    "mamba2-780m": "repro_torch.configs.mamba2_780m",
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "qwen2-vl-2b": None,
    "jamba-v0.1-52b": "repro_torch.configs.jamba_v0_1_52b",
    "whisper-medium": None,
}

ARCH_IDS = list(ARCH_MODULES)
# the ROADMAP item that ports each id still missing
ROADMAP_ITEMS = {
    "qwen2-vl-2b": "A.18.5",
    "whisper-medium": "A.18.6",
}


class TensorSpec(NamedTuple):
    """Shape and numpy dtype of one batch entry (the reference's
    ``jax.ShapeDtypeStruct``)."""

    shape: tuple
    dtype: Any


@dataclasses.dataclass
class ArchBundle:
    cfg: ModelConfig
    device: torch.device
    init: Callable[[Any], Any]                 # (seed | torch.Generator) -> params
    loss_fn: Callable[..., torch.Tensor]       # (params, batch, *, remat, ...)
    input_specs: Callable[[ShapeConfig], dict]

    def decode_fn(self, params, token, caches, seq_sharded=False):
        """(params, (B, 1) tokens, caches) -> (fp32 logits (B, 1, V), caches),
        the caches written in place."""
        from repro_torch.models.lm import decode_step

        return decode_step(params, token, caches, self.cfg, seq_sharded_cache=seq_sharded)

    def make_caches(self, batch: int, max_seq: int) -> list:
        from repro_torch.models.lm import init_caches

        return init_caches(self.cfg, batch, max_seq, self.cfg.act_dtype, self.device)

    def cache_specs(self, batch: int, max_seq: int) -> list:
        """The caches' shapes and dtypes as ``meta`` tensors (the reference's
        ``jax.eval_shape`` of ``make_caches``): ``KVCache``, ``MLACache`` and
        ``MambaState`` tuples alike."""
        from repro_torch.models.lm import init_caches

        return init_caches(self.cfg, batch, max_seq, self.cfg.act_dtype, "meta")


def load_config(name: str, reduced: bool = False) -> ModelConfig:
    if name not in ARCH_MODULES:
        raise ValueError(f"unknown arch {name!r}; one of {ARCH_IDS}")
    if ARCH_MODULES[name] is None:
        raise NotImplementedError(f"--arch {name}: not ported yet (ROADMAP {ROADMAP_ITEMS[name]})")
    mod = importlib.import_module(ARCH_MODULES[name])
    return mod.reduced() if reduced else mod.CONFIG


def with_depth(cfg: ModelConfig, n_periods: int) -> ModelConfig:
    """Depth-reduced copy: the irregular prefix + ``n_periods`` repeats of the
    periodic block (see ``models.lm.plan_segments``)."""
    from repro_torch.models.lm import plan_segments

    segs = plan_segments(cfg)
    prefix = 0 if len(segs) == 1 else len(segs[0].block)
    period = len(segs[-1].block)
    depth = prefix + n_periods * period
    kw = {"n_layers": depth}
    if cfg.encoder_decoder and cfg.n_encoder_layers:
        kw["n_encoder_layers"] = max(1, cfg.n_encoder_layers * depth // cfg.n_layers)
    return dataclasses.replace(cfg, **kw)


def _lm_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    b, t = shape.global_batch, shape.seq_len
    i32 = np.dtype(np.int32)
    if shape.kind == "decode":
        return {"token": TensorSpec((b, 1), i32)}
    if cfg.family == "vlm":
        raise NotImplementedError("VLM input specs (Qwen2-VL): ROADMAP A.18")
    return {"tokens": TensorSpec((b, t), i32), "labels": TensorSpec((b, t), i32)}


def get_arch(name: str, reduced: bool = False, device: str | torch.device = "cuda") -> ArchBundle:
    return bundle_from_cfg(load_config(name, reduced), device)


def bundle_from_cfg(cfg: ModelConfig, device: str | torch.device = "cuda") -> ArchBundle:
    if cfg.encoder_decoder:
        raise NotImplementedError("encoder-decoder models (Whisper): ROADMAP A.18")
    from repro_torch.models import lm as L

    dev = resolve_device(device)

    def init(seed):
        gen = seed if isinstance(seed, torch.Generator) else \
            torch.Generator(device=dev).manual_seed(int(seed))
        return L.init_lm(gen, cfg)

    return ArchBundle(
        cfg=cfg,
        device=dev,
        init=init,
        loss_fn=lambda params, batch, remat="full", **kw: L.lm_loss(
            params, batch, cfg, remat=remat, **kw),
        input_specs=lambda shape: _lm_input_specs(cfg, shape),
    )
