"""Wrapper of the hand-written CUDA SSD intra-chunk kernel
(``csrc/ssd_chunk_fwd.cu``).

``ssd_chunk_fwd`` has the signature of
``repro/kernels/ssd_chunk/kernel.py:ssd_chunk_fwd`` minus ``interpret``.  A
CPU tensor takes the plain version (``ref.py``); a CUDA tensor launches the
kernel on the current stream or raises - there is no fallback.  dt is cast
to fp32 here, as the reference kernel's wrapper does; every output is fp32.
``ssd_chunk_fwd.launches`` counts the kernel's launches and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_chunk.ref import chunk_len, ssd_chunk_ref

_DTYPES = (torch.float32, torch.bfloat16)
_MAX_N, _MAX_P, _MAX_Q = 128, 64, 8192      # the kernel's NMAX, PMAX and cum buffer
_MAX_GRID_YZ = 65535
_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9


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
               int(Bm.dtype == torch.bfloat16))
    ssd_chunk_fwd.launches += 1
    return y, S, decay, pref


ssd_chunk_fwd.launches = 0
