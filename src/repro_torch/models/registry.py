"""Architecture registry: ``--arch <id>`` -> config + model functions + specs
(``repro/models/registry.py``).

Every id of the reference resolves: the dense ``qwen2-7b`` (GQA, QKV bias),
``codeqwen1.5-7b`` (MHA, QKV bias), ``stablelm-1.6b`` (LayerNorm, partial
rotary) and ``command-r-35b`` (LayerNorm, parallel attention||MLP block,
tied embeddings), ``mamba2-780m`` (SSD), the Mixture-of-Experts
``mixtral-8x22b`` (sliding window), ``jamba-v0.1-52b`` (Mamba, attention
without RoPE, MoE on alternate layers) and ``deepseek-v3-671b`` (MLA, 3
dense layers then 256 routed experts beside a shared one, an MTP head), the
VLM ``qwen2-vl-2b`` (M-RoPE, patch embeddings in place of the leading
tokens) and the encoder-decoder ``whisper-medium`` (``models/whisper.py``).
``ROADMAP_ITEMS`` would name the A.18 item of an id still to port; it is
empty.  A bundle's ``init(seed)`` draws its params on the bundle's device;
``decode_fn`` and ``make_caches`` are the serving surface
(``models/lm.py:decode_step`` and ``init_caches``, or Whisper's
``whisper_decode_step`` and ``init_whisper_caches`` with the cross K/V of
``max_seq`` rows, as the reference's), and ``cache_specs`` and
``abstract_params`` give the caches' and the params' shapes and dtypes as
``meta`` tensors, allocating nothing.  The dry run's grid
(``launch/dryrun.py``) is ``all_cells``: every id under each of
``configs.base.SHAPES``, ``cell_supported`` saying which run;
``period_counts`` and ``with_depth`` cut a config by its segment plan.

A batch entry's ``TensorSpec`` has a numpy dtype for integers and the
config's torch activation dtype for floats (``patch_embeds``, ``frames``):
numpy has no bfloat16 without ``ml_dtypes``, so ``data.synthetic`` draws a
float entry in numpy and casts it in torch.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig
from repro_torch.launch.mesh import resolve_device

ARCH_MODULES = {
    "codeqwen1.5-7b": "repro_torch.configs.codeqwen1_5_7b",
    "stablelm-1.6b": "repro_torch.configs.stablelm_1_6b",
    "qwen2-7b": "repro_torch.configs.qwen2_7b",
    "command-r-35b": "repro_torch.configs.command_r_35b",
    "mamba2-780m": "repro_torch.configs.mamba2_780m",
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "qwen2-vl-2b": "repro_torch.configs.qwen2_vl_2b",
    "jamba-v0.1-52b": "repro_torch.configs.jamba_v0_1_52b",
    "whisper-medium": "repro_torch.configs.whisper_medium",
}

ARCH_IDS = list(ARCH_MODULES)
# the ROADMAP item that ports each id still missing: none since A.18.5/A.18.6
ROADMAP_ITEMS: dict[str, str] = {}


class TensorSpec(NamedTuple):
    """Shape and dtype of one batch entry (the reference's
    ``jax.ShapeDtypeStruct``): numpy int32 for ids and positions, the
    config's torch dtype for a float entry."""

    shape: tuple
    dtype: Any


@dataclasses.dataclass
class ArchBundle:
    cfg: ModelConfig
    device: torch.device
    init: Callable[[Any], Any]                 # (seed | torch.Generator) -> params
    loss_fn: Callable[..., torch.Tensor]       # (params, batch, *, remat, ...)
    input_specs: Callable[[ShapeConfig], dict]

    def decode_fn(self, params, token, caches, seq_sharded=None):
        """(params, (B, 1) tokens, caches) -> (fp32 logits (B, 1, V), caches),
        the caches written in place; ``seq_sharded`` takes the flash-decode
        form (``decode_step``'s ``seq_sharded_cache``).  The reference's
        encoder-decoder bundle takes no ``seq_sharded``, so Whisper's raises
        its ``TypeError`` for one."""
        if self.cfg.encoder_decoder:
            from repro_torch.models.whisper import whisper_decode_step

            if seq_sharded is not None:
                raise TypeError("decode_fn() got an unexpected keyword argument 'seq_sharded'")
            return whisper_decode_step(params, token, caches, self.cfg)
        from repro_torch.models.lm import decode_step

        return decode_step(params, token, caches, self.cfg,
                           seq_sharded_cache=bool(seq_sharded))

    def make_caches(self, batch: int, max_seq: int, device=None) -> list:
        """Zeroed caches on the bundle's device (or ``device``): an
        encoder-decoder's cross K/V take ``max_seq`` rows too."""
        dev = self.device if device is None else device
        if self.cfg.encoder_decoder:
            from repro_torch.models.whisper import init_whisper_caches

            return init_whisper_caches(self.cfg, batch, max_seq, max_seq, self.cfg.act_dtype,
                                       dev)
        from repro_torch.models.lm import init_caches

        return init_caches(self.cfg, batch, max_seq, self.cfg.act_dtype, dev)

    def abstract_params(self):
        """The params' shapes and dtypes as ``meta`` tensors, drawing and
        allocating nothing (the reference's ``jax.eval_shape`` of ``init``):
        ``init`` traced under ``FakeTensorMode``
        (``train/trainer.py:abstract_of``)."""
        from repro_torch.train.trainer import abstract_of

        return abstract_of(self.init)[0]

    def cache_specs(self, batch: int, max_seq: int) -> list:
        """The caches' shapes and dtypes as ``meta`` tensors (the reference's
        ``jax.eval_shape`` of ``make_caches``): ``KVCache``, ``MLACache``,
        ``MambaState`` and ``WhisperCache`` tuples alike."""
        return self.make_caches(batch, max_seq, "meta")


def load_config(name: str, reduced: bool = False) -> ModelConfig:
    if name not in ARCH_MODULES:
        raise ValueError(f"unknown arch {name!r}; one of {ARCH_IDS}")
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


def period_counts(cfg: ModelConfig) -> tuple[int, int]:
    """(prefix_layers, total_periods) of the periodic segment plan."""
    from repro_torch.models.lm import plan_segments

    segs = plan_segments(cfg)
    prefix = 0 if len(segs) == 1 else len(segs[0].block)
    period = len(segs[-1].block)
    return prefix, (cfg.n_layers - prefix) // period


def _vision_tokens(seq: int) -> int:
    # 25% of the context is vision patches (dynamic-resolution stand-in)
    return max(4, seq // 4)


def _lm_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    b, t = shape.global_batch, shape.seq_len
    i32 = np.dtype(np.int32)
    if shape.kind == "decode":
        return {"token": TensorSpec((b, 1), i32)}
    specs = {"tokens": TensorSpec((b, t), i32), "labels": TensorSpec((b, t), i32)}
    if cfg.family == "vlm":
        specs["patch_embeds"] = TensorSpec((b, _vision_tokens(t), cfg.d_model), cfg.act_dtype)
        specs["positions"] = TensorSpec((3, b, t), i32)
    return specs


def _whisper_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    b, t = shape.global_batch, shape.seq_len
    i32 = np.dtype(np.int32)
    if shape.kind == "decode":
        return {"token": TensorSpec((b, 1), i32)}
    td = max(8, t // 4)
    return {"frames": TensorSpec((b, t, cfg.d_model), cfg.act_dtype),
            "tokens": TensorSpec((b, td), i32), "labels": TensorSpec((b, td), i32)}


def get_arch(name: str, reduced: bool = False, device: str | torch.device = "cuda") -> ArchBundle:
    return bundle_from_cfg(load_config(name, reduced), device)


def bundle_from_cfg(cfg: ModelConfig, device: str | torch.device = "cuda") -> ArchBundle:
    if cfg.encoder_decoder:
        from repro_torch.models import whisper as W

        init_fn, loss, specs = W.init_whisper, W.whisper_loss, _whisper_input_specs
    else:
        from repro_torch.models import lm as L

        init_fn, loss, specs = L.init_lm, L.lm_loss, _lm_input_specs
    dev = resolve_device(device)

    def init(seed):
        gen = seed if isinstance(seed, torch.Generator) else \
            torch.Generator(device=dev).manual_seed(int(seed))
        return init_fn(gen, cfg)

    return ArchBundle(
        cfg=cfg,
        device=dev,
        init=init,
        loss_fn=lambda params, batch, remat="full", **kw: loss(params, batch, cfg, remat=remat,
                                                               **kw),
        input_specs=lambda shape: specs(cfg, shape),
    )


def cell_supported(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Which (arch x shape) cells run: a 500k-token decode needs
    sub-quadratic serving (the reference's rule)."""
    if shape.name == "long_500k":
        if not cfg.sub_quadratic():
            return False, (
                "long_500k needs sub-quadratic serving; "
                f"{cfg.name} is pure full-attention (skip per assignment)"
            )
    return True, ""


def all_cells(reduced: bool = False):
    """Yield (arch, shape, supported, reason) for the 10 x 4 grid."""
    for name in ARCH_IDS:
        cfg = load_config(name, reduced)
        for shape in SHAPES.values():
            ok, why = cell_supported(cfg, shape)
            yield name, shape, ok, why
