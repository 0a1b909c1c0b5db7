// VALID NHWC conv2d of a halo-extended tile, fused bias + activation.
//
// Replaces the Pallas TPU kernel repro/kernels/conv2d_tiled/kernel.py
// (conv2d_tile / _conv_kernel): same function - y = act(conv_valid(x, w) + b)
// with x (N, H, W, Cin) NHWC, w (K, K, Cin, Cout) HWIO, fp32 products and
// accumulation, output in result_type(x, w) - but not the same blocking.
//
// Design: implicit GEMM on CUDA cores.  Output pixels of one image are the
// GEMM rows (M = OH*OW), output channels the columns (Cout), and the
// reduction runs over k = (ki*K + kj)*Cin + ci, for which the HWIO filter
// is already a row-major (K*K*Cin, Cout) matrix.  One CTA computes a
// 64-pixel x 64-channel output block of one image (grid: Cout blocks,
// pixel blocks, images); 256 threads each keep a 4x4 fp32 accumulator in
// registers.  Every BK=16 slice of the reduction is gathered from x (the
// im2col row is never materialised) and loaded from w into shared memory,
// then consumed by 16 rank-1 updates.  Ragged edges (Cin=3, Cout not a
// multiple of 64, pixel count not a multiple of 64) are bounds-checked, so
// nothing needs padding and Cin carries no vector-load assumption.
//
// Bound: fp32 FLOPs on CUDA cores (67 TFLOP/s on an H100 SXM) for every
// conv of the serve path except the Cin=3 first layer, which moves more
// bytes than it computes.  The serve path is fp32 and TF32 tensor cores
// would not meet the fp32 tolerance (atol 2e-5, rtol 1e-4), so this kernel
// stays on FFMA; a tensor-core mode (bf16 wgmma, TMA-fed) is later work.
//
// The TPU kernel's block_oh output-row blocking exists to bound a VMEM
// accumulator; here the accumulator lives in registers at a fixed tile, so
// the wrapper accepts block_oh and ignores it (results do not depend on it).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;        // output pixels per CTA
constexpr int BN = 64;        // output channels per CTA
constexpr int BK = 16;        // reduction slice per shared-memory stage
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int APAD = 4;       // keeps float4 alignment, breaks store conflicts

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// act: 0 linear, 1 relu, 2 leaky (slope 0.1, darknet's)
template <typename TX, typename TW, typename TO>
__global__ void __launch_bounds__(THREADS)
conv2d_tile_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                   const float* __restrict__ bias, TO* __restrict__ out,
                   int H, int W, int Cin, int K, int Cout, int OH, int OW,
                   int stride, int act) {
  __shared__ __align__(16) float As[BK][BM + APAD];
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int img = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int co0 = blockIdx.x * BN;
  const int P = OH * OW;
  const int KD = K * K * Cin;
  const TX* xn = x + (long long)img * H * W * Cin;

  // A (input gather): each thread loads reduction column a_k of rows
  // a_m + 16*i; a warp covers 16 consecutive k, i.e. consecutive channels.
  const int a_k = tid % BK;
  const int a_m = tid / BK;
  int a_base[4];
  bool a_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + a_m + 16 * i;
    a_ok[i] = m < P;
    const int oh = a_ok[i] ? m / OW : 0;
    const int ow = a_ok[i] ? m - oh * OW : 0;
    a_base[i] = (oh * stride * W + ow * stride) * Cin;
  }
  // B (filter): each thread loads column b_n of rows b_k + 4*i; a warp
  // covers 32 consecutive output channels.
  const int b_n = tid % BN;
  const int b_k = tid / BN;
  const bool b_ok = co0 + b_n < Cout;

  const int ty = tid / 16;
  const int tx = tid % 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < KD; k0 += BK) {
    const int k = k0 + a_k;
    const bool k_ok = k < KD;
    int off = 0;
    if (k_ok) {
      const int tap = k / Cin;
      const int ci = k - tap * Cin;
      const int ki = tap / K;
      const int kj = tap - ki * K;
      off = (ki * W + kj) * Cin + ci;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      As[a_k][a_m + 16 * i] = (k_ok && a_ok[i]) ? to_f32(xn[a_base[i] + off]) : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kk = k0 + b_k + 4 * i;
      Bs[b_k + 4 * i][b_n] =
          (kk < KD && b_ok) ? to_f32(w[(long long)kk * Cout + co0 + b_n]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  // fused epilogue: bias + activation, cast to the output type
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= P) continue;
    TO* orow = out + ((long long)img * P + m) * Cout;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = co0 + tx * 4 + j;
      if (co >= Cout) continue;
      float v = acc[i][j] + (bias != nullptr ? bias[co] : 0.f);
      if (act == 1) {
        v = fmaxf(v, 0.f);
      } else if (act == 2) {
        v = v > 0.f ? v : 0.1f * v;
      }
      orow[co] = from_f32<TO>(v);
    }
  }
}

template <typename TX, typename TW, typename TO>
void launch(const void* x, const void* w, const float* bias, void* out, int N, int H,
            int W, int Cin, int K, int Cout, int OH, int OW, int stride, int act,
            cudaStream_t stream) {
  const dim3 grid((Cout + BN - 1) / BN, (OH * OW + BM - 1) / BM, N);
  conv2d_tile_kernel<TX, TW, TO><<<grid, THREADS, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w), bias,
      static_cast<TO*>(out), H, W, Cin, K, Cout, OH, OW, stride, act);
}

}  // namespace

extern "C" {

// Launches on ``stream`` and returns cudaGetLastError() (0 on success).
// x_bf16 / w_bf16 select bf16 (1) or fp32 (0) operands; the output is fp32
// unless both are bf16.  ``bias`` is fp32 (Cout,) or null.
int conv2d_tile_launch(const void* x, const void* w, const void* bias, void* out,
                       int N, int H, int W, int Cin, int K, int Cout, int OH, int OW,
                       int stride, int act, int x_bf16, int w_bf16, void* stream) {
  const float* b = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!x_bf16 && !w_bf16) {
    launch<float, float, float>(x, w, b, out, N, H, W, Cin, K, Cout, OH, OW, stride, act, s);
  } else if (x_bf16 && !w_bf16) {
    launch<__nv_bfloat16, float, float>(x, w, b, out, N, H, W, Cin, K, Cout, OH, OW,
                                        stride, act, s);
  } else if (!x_bf16 && w_bf16) {
    launch<float, __nv_bfloat16, float>(x, w, b, out, N, H, W, Cin, K, Cout, OH, OW,
                                        stride, act, s);
  } else {
    launch<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16>(x, w, b, out, N, H, W, Cin, K,
                                                        Cout, OH, OW, stride, act, s);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* conv2d_tile_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
