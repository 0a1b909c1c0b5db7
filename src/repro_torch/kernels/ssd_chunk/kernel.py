"""Wrapper of the hand-written CUDA SSD intra-chunk kernel
(``csrc/ssd_chunk_fwd.cu``).

``ssd_chunk_fwd`` has the signature of
``repro/kernels/ssd_chunk/kernel.py:ssd_chunk_fwd`` minus ``interpret``.  A
CPU tensor takes the plain version (``ref.py``); a CUDA tensor launches the
kernel on the current stream or raises - there is no fallback.  dt is cast
to fp32 here, as the reference kernel's wrapper does; every output is fp32.
Which of the kernel's instances runs is fixed by the types and shapes alone
(``ssd_instance``): bf16 x, B and C take the tensor-core instance (TMA +
``wgmma``, C·Bᵀ shared by a slab of heads, ``ssd_slab``), every other case
the SIMT instance (fp32 FFMA on CUDA cores).  ``ssd_chunk_fwd.launches``
counts the kernel's launches and nothing else;
``ssd_chunk_fwd.launches_by_instance`` splits them by instance.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_chunk.ref import chunk_len, ssd_chunk_ref

_DTYPES = (torch.float32, torch.bfloat16)
_MAX_N, _MAX_P, _MAX_Q = 128, 64, 8192      # the kernel's NMAX, PMAX and cum buffer
_MAX_GRID_YZ = 65535
_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 11
_SMS = 132               # SMs of an H100 SXM: the slab rule's card
# instance name -> the C launcher's instance code
INSTANCES = {"simt_fp32": 0, "wgmma_bf16": 1}
# The tensor-core instance: TMA reads x, B and C, which needs every global
# stride a multiple of 16 bytes (N and P multiples of 8 bf16); each warpgroup
# keeps C·Bᵀ for every key tile of a chunk in registers, 4 tiles of 64 keys
# at most (Q <= 256).
_TC_ALIGN, _TC_MAX_Q = 16, 256
# Shared memory the tensor-core instance has for the slab's log-decay prefix
# and dt (8 bytes per head and position): 227 KB less the 1 KB alignment pad
# and its fixed tiles (C 32 KB, B 64 KB, x 32 KB, mbarriers).
_TC_SLAB_BYTES = 232448 - 1024 - 131152


def ssd_instance(x_dtype: torch.dtype, bc_dtype: torch.dtype, n: int, p: int, q: int) -> str:
    """The kernel instance that runs x of ``x_dtype`` (head dim ``p``), B and
    C of ``bc_dtype`` (state dim ``n``) and chunks of ``q``: "wgmma_bf16"
    where x, B and C are bf16, N and P are multiples of 8 (TMA's 16-byte
    strides) and Q <= 256 (C·Bᵀ of a chunk in registers); "simt_fp32" for
    every other case - fp32 or mixed types (the fp32 gradient checks), the
    SSD_CASES shape with N = 4, chunks past 256.  A pure function of its
    arguments, never chosen by a failure."""
    if (x_dtype == bc_dtype == torch.bfloat16 and n % (_TC_ALIGN // 2) == 0
            and p % (_TC_ALIGN // 2) == 0 and q <= _TC_MAX_Q):
        return "wgmma_bf16"
    return "simt_fp32"


def ssd_slab(heads_per_group: int, q: int, groups: int, chunks: int) -> int:
    """Heads per CTA of the tensor-core instance: the largest divisor of
    H/G whose log-decay prefix fits shared memory (``_TC_SLAB_BYTES``) and
    whose grid - (Q/128 row CTAs + 1 state CTA) x G x H/G/slab x B*nc, one
    CTA per SM - still puts a CTA on every SM; where no divisor does, the
    one that gives the most CTAs (1).  Larger slabs share C·Bᵀ among more
    heads; smaller ones fill the card."""
    qp = -(-q // 64) * 64
    cap = _TC_SLAB_BYTES // (8 * (qp + 2))
    roles = -(-q // 128) + 1
    divisors = [d for d in range(heads_per_group, 0, -1) if heads_per_group % d == 0 and d <= cap]
    for d in divisors:
        if roles * groups * (heads_per_group // d) * chunks >= _SMS:
            return d
    return divisors[-1]


def ssd_chunk_fwd(
    x: torch.Tensor,      # (B, T, H, P)
    dt: torch.Tensor,     # (B, T, H) softplus'd step sizes
    A: torch.Tensor,      # (H,) fp32, negative
    Bm: torch.Tensor,     # (B, T, G, N)
    Cm: torch.Tensor,     # (B, T, G, N)
    *,
    chunk: int = 256,
):
    """-> (y_intra (B,T,H,P), S (B,nc,H,N,P), decay (B,nc,H), pref (B,T,H)), fp32."""
    b, t, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    if (tuple(dt.shape) != (b, t, h) or tuple(A.shape) != (h,) or Bm.shape != Cm.shape
            or tuple(Bm.shape[:2]) != (b, t) or g == 0 or h % g):
        raise ValueError(f"x {tuple(x.shape)}, dt {tuple(dt.shape)}, A {tuple(A.shape)}, "
                         f"B {tuple(Bm.shape)}, C {tuple(Cm.shape)}: need dt (B,T,H), A (H,), "
                         f"B == C (B,T,G,N) in shape, and H a multiple of G")
    q = chunk_len(t, chunk)
    if x.device.type == "cpu":
        return ssd_chunk_ref(x, dt, A, Bm, Cm, chunk=chunk)
    if not x.is_cuda or not all(u.device == x.device for u in (dt, A, Bm, Cm)):
        raise ValueError(f"ssd_chunk_fwd launches on CUDA tensors on one device; got "
                         f"{[str(u.device) for u in (x, dt, A, Bm, Cm)]}")
    if x.dtype not in _DTYPES or Bm.dtype not in _DTYPES or Cm.dtype != Bm.dtype:
        raise TypeError(f"ssd_chunk_fwd takes float32 or bfloat16 x and B, C of one such type; "
                        f"got {x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if A.dtype != torch.float32:
        raise TypeError(f"A must be float32; got {A.dtype}")
    if n > _MAX_N or p > _MAX_P or q > _MAX_Q:
        raise ValueError(f"ssd_chunk_fwd takes N <= {_MAX_N}, P <= {_MAX_P}, chunk <= {_MAX_Q}; "
                         f"got N {n}, P {p}, chunk {q}")
    if not (x.is_contiguous() and Bm.is_contiguous() and Cm.is_contiguous()):
        raise ValueError("ssd_chunk_fwd needs contiguous x, B and C")
    nc = t // q
    if h > _MAX_GRID_YZ or b * nc > _MAX_GRID_YZ:
        raise ValueError(f"ssd_chunk_fwd grid too large for H={h}, B*nc={b * nc}")
    instance = ssd_instance(x.dtype, Bm.dtype, n, p, q)
    slab = ssd_slab(h // g, q, g, b * nc) if instance == "wgmma_bf16" else 1
    if instance == "wgmma_bf16" and any(u.data_ptr() % _TC_ALIGN for u in (x, Bm, Cm)):
        raise ValueError(f"the tensor-core instance loads x, B and C by TMA, which needs "
                         f"{_TC_ALIGN}-byte aligned base addresses")
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty((b, t, h, p), **f32)
    S = torch.empty((b, nc, h, n, p), **f32)
    decay = torch.empty((b, nc, h), **f32)
    pref = torch.empty((b, t, h), **f32)
    if b == 0 or h == 0:
        return y, S, decay, pref
    dtf = dt.to(torch.float32).contiguous()
    a = A.contiguous()
    _build.run("ssd_chunk_fwd", _ARGTYPES, x.device,
               x.data_ptr(), dtf.data_ptr(), a.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
               y.data_ptr(), S.data_ptr(), decay.data_ptr(), pref.data_ptr(),
               b, t, h, p, g, n, q, int(x.dtype == torch.bfloat16),
               int(Bm.dtype == torch.bfloat16), INSTANCES[instance], slab)
    ssd_chunk_fwd.launches += 1
    ssd_chunk_fwd.launches_by_instance[instance] += 1
    return y, S, decay, pref


def reset_launches() -> None:
    """Sets every launch count of the wrapper to 0."""
    ssd_chunk_fwd.launches = 0
    ssd_chunk_fwd.launches_by_instance = dict.fromkeys(INSTANCES, 0)


reset_launches()
