"""Plain torch versions of the tiled conv2d kernels: the forward (VALID conv
+ bias + act), its input gradient (dgrad) and its weight gradient (wgrad).

The counterparts of ``repro/kernels/conv2d_tiled/ref.py`` and of the
arithmetic in ``repro/kernels/conv2d_tiled/backward.py``: NHWC/HWIO at the
interface, products and sums in fp32 (fp64 for fp64 operands, so the
autograd path can be gradchecked), output cast to the promoted dtype.  CPU
tensors take these paths inside the kernel wrappers; on the card they are
only the yardsticks the kernels are held against (set
``torch.backends.cudnn.allow_tf32 = False`` and
``torch.backends.cuda.matmul.allow_tf32 = False`` first, or cuDNN and the
matmuls compute fp32 in TF32).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _acc_dtype(*ts: torch.Tensor) -> torch.dtype:
    return torch.float64 if any(t.dtype == torch.float64 for t in ts) else torch.float32


def conv2d_ref(
    x: torch.Tensor,                  # (N, H, W, Cin)
    w: torch.Tensor,                  # (K, K, Cin, Cout)
    b: torch.Tensor | None = None,    # (Cout,)
    *,
    stride: int = 1,
    act: str = "linear",
) -> torch.Tensor:
    acc = _acc_dtype(x, w)
    y = F.conv2d(
        x.to(acc).permute(0, 3, 1, 2), w.to(acc).permute(3, 2, 0, 1), stride=stride
    ).permute(0, 2, 3, 1)
    if b is not None:
        y = y + b.to(acc)
    if act == "relu":
        y = torch.clamp_min(y, 0.0)
    elif act == "leaky":
        y = torch.where(y > 0, y, 0.1 * y)
    elif act != "linear":
        raise ValueError(f"unsupported fused activation {act!r}")
    return y.to(torch.promote_types(x.dtype, w.dtype)).contiguous()


def rotate_filter_ref(w: torch.Tensor) -> torch.Tensor:
    """HWIO filter -> 180-degree-rotated, channel-swapped filter for dgrad:
    ``rotate_filter_ref(w)[u, v, co, ci] == w[K-1-u, K-1-v, ci, co]``."""
    return w.flip(0, 1).permute(0, 1, 3, 2)


def conv2d_dgrad_ref(
    g: torch.Tensor,                  # (N, OH, OW, Cout) cotangent of the VALID conv
    w: torch.Tensor,                  # (K, K, Cin, Cout)
    in_hw: tuple[int, int],           # (H, W) of the forward (padded) input
    stride: int = 1,
) -> torch.Tensor:
    """(N, H, W, Cin) input gradient, as ``backward.py:conv2d_dgrad_tile``
    computes it: the cotangent dilated by the stride and zero-padded K-1 low
    and K-1+r high (r = rows past the last forward window), convolved VALID
    with the rotated filter."""
    n, oh, ow, cout = g.shape
    k = w.shape[0]
    h, wd = in_hw
    rh = h - ((oh - 1) * stride + k)
    rw = wd - ((ow - 1) * stride + k)
    if rh < 0 or rw < 0:
        raise ValueError(
            f"cotangent {tuple(g.shape)} inconsistent with input {tuple(in_hw)}, K={k}, S={stride}"
        )
    acc = _acc_dtype(g, w)
    g_dil = g.new_zeros((n, h + k - 1, wd + k - 1, cout), dtype=acc)
    g_dil[:, k - 1:k - 1 + (oh - 1) * stride + 1:stride,
          k - 1:k - 1 + (ow - 1) * stride + 1:stride] = g.to(acc)
    dx = conv2d_ref(g_dil, rotate_filter_ref(w.to(acc)))
    return dx.to(torch.promote_types(g.dtype, w.dtype))


def conv2d_wgrad_ref(
    x: torch.Tensor,                  # (N, H, W, Cin) forward (padded) input
    g: torch.Tensor,                  # (N, OH, OW, Cout)
    kernel: int,
    stride: int = 1,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """(K, K, Cin, Cout) weight gradient, as ``backward.py:_wgrad_kernel``
    computes it: per tap (ki, kj), one (N*OH*OW, Cin)^T (N*OH*OW, Cout)
    matmul of the strided input window with the cotangent.  ``out_dtype``
    defaults to the promoted input/cotangent dtype."""
    n, oh, ow, cout = g.shape
    cin = x.shape[-1]
    acc = _acc_dtype(x, g)
    g2 = g.to(acc).reshape(-1, cout)
    dw = x.new_empty((kernel, kernel, cin, cout), dtype=acc)
    for ki in range(kernel):
        for kj in range(kernel):
            xs = x[:, ki:ki + (oh - 1) * stride + 1:stride, kj:kj + (ow - 1) * stride + 1:stride]
            dw[ki, kj] = xs.to(acc).reshape(-1, cin).T @ g2
    return dw.to(torch.promote_types(x.dtype, g.dtype) if out_dtype is None else out_dtype)
