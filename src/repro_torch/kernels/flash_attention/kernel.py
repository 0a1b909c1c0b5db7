"""Wrapper of the hand-written CUDA flash-attention forward
(``csrc/flash_attention_fwd.cu``).

``flash_attention_fwd`` has the signature of
``repro/kernels/flash_attention/kernel.py:flash_attention_fwd`` minus
``interpret``.  A CPU tensor takes the plain version (``ref.py``); a CUDA
tensor launches the kernel on the current stream or raises - there is no
fallback.  Which of the kernel's instances runs is fixed by the dtype and
head dim alone (``fa_instance``): fp32 takes the SIMT instance (fp32 FFMA on
CUDA cores), bf16 the tensor-core instance (TMA + ``wgmma``).
``flash_attention_fwd.launches`` counts the kernel's launches and nothing
else; ``flash_attention_fwd.launches_by_instance`` splits them by instance.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import attention_ref, rounded_scale

_MAX_DH = 128
_MAX_GRID_YZ = 65535
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float] + [ctypes.c_int] * 3
# instance name -> (the C launcher's instance code, query rows per CTA)
INSTANCES = {
    "simt_fp32_dh64": (0, 64),
    "simt_fp32_dh128": (1, 64),
    "wgmma_bf16_dh64": (2, 128),
    "wgmma_bf16_dh128": (3, 128),
}
# TMA reads bf16 q / k / v: every global stride a multiple of 16 bytes
_TMA_ALIGN = 16


def fa_instance(dtype: torch.dtype, dh: int) -> str:
    """The kernel instance that runs (B, T, H, ``dh``) operands of ``dtype``:
    a pure function of the two, never chosen by a failure.  Raises where no
    instance takes them."""
    if dh < 1 or dh > _MAX_DH:
        raise ValueError(f"head dim {dh} outside [1, {_MAX_DH}]")
    width = 64 if dh <= 64 else 128
    if dtype == torch.float32:
        return f"simt_fp32_dh{width}"
    if dtype == torch.bfloat16:
        if (dh * 2) % _TMA_ALIGN:
            raise ValueError(
                f"bf16 head dim {dh}: the tensor-core instance loads q, k and v by TMA, "
                f"which needs every global stride a multiple of {_TMA_ALIGN} bytes, so "
                f"the head dim must be a multiple of {_TMA_ALIGN // 2}")
        return f"wgmma_bf16_dh{width}"
    raise TypeError(f"flash_attention_fwd takes float32 or bfloat16 q, k, v; got {dtype}")


def flash_attention_fwd(
    q: torch.Tensor,              # (B, Tq, Hq, Dh)
    k: torch.Tensor,              # (B, Tk, Hkv, Dh)
    v: torch.Tensor,              # (B, Tk, Hkv, Dh)
    *,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
    bq: int = 512,
    bk: int = 512,
) -> torch.Tensor:
    """Softmax attention, output in q's type.  ``bq`` and ``bk`` re-tile the
    TPU kernel's blocks only; the CUDA kernel's tiles are fixed per instance,
    so they are validated and otherwise ignored."""
    if bq < 1 or bk < 1:
        raise ValueError(f"bq and bk must be positive; got {bq}, {bk}")
    if window is not None and window < 1:
        raise ValueError(f"window must be positive or None; got {window}")
    b, tq, hq, dh = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != dh or hkv == 0 or hq % hkv:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}: "
                         f"need k == v in shape, the same B and Dh, and Hq a multiple of Hkv")
    scale = scale if scale is not None else dh ** -0.5
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window, scale=scale)
    if not all(t.is_cuda and t.device == q.device for t in (k, v)) or not q.is_cuda:
        raise ValueError(f"flash_attention_fwd launches on CUDA tensors on one device; got "
                         f"{[str(t.device) for t in (q, k, v)]}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_fwd takes q, k, v of one type; "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    instance = fa_instance(q.dtype, dh)
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention_fwd needs contiguous (B, T, H, Dh) operands")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    if tk == 0:
        return out.zero_()
    code, rows = INSTANCES[instance]
    if b > _MAX_GRID_YZ or max(hq, -(-tq // rows)) > _MAX_GRID_YZ:
        raise ValueError(f"flash_attention_fwd grid too large for B={b}, Tq={tq}, Hq={hq}")
    if instance.startswith("wgmma") and any(t.data_ptr() % _TMA_ALIGN for t in (q, k, v)):
        raise ValueError(f"the tensor-core instance loads q, k and v by TMA, which needs "
                         f"{_TMA_ALIGN}-byte aligned base addresses")
    # the scale as JAX applies it to a q of this type (a weakly typed float)
    s = rounded_scale(scale, q.dtype)
    _build.run("flash_attention_fwd", _ARGTYPES, q.device,
               q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
               b, tq, tk, hq, hkv, dh, s, int(causal), 0 if window is None else int(window), code)
    flash_attention_fwd.launches += 1
    flash_attention_fwd.launches_by_instance[instance] += 1
    return out


def reset_launches() -> None:
    """Sets every launch count of the wrapper to 0."""
    flash_attention_fwd.launches = 0
    flash_attention_fwd.launches_by_instance = dict.fromkeys(INSTANCES, 0)


reset_launches()
