// Weight gradient (wgrad) of the VALID strided NHWC conv of a tile batch.
//
// Replaces the Pallas TPU kernel repro/kernels/conv2d_tiled/backward.py
// (conv2d_wgrad_tile / _wgrad_kernel): same function -
//   dw[ki, kj, ci, co] = sum_{n, oh, ow} x[n, S*oh+ki, S*ow+kj, ci] * g[n, oh, ow, co]
// with x (N, H, W, Cin) NHWC, g (N, OH, OW, Cout), dw (K, K, Cin, Cout) HWIO,
// fp32 products and accumulation, output in the caller's dtype.
//
// Design: a GEMM whose rows are the filter rows m = (ki*K + kj)*Cin + ci
// (the HWIO filter is already a row-major (K*K*Cin, Cout) matrix), whose
// columns are the output channels, and whose reduction runs over every
// pixel r = (n, oh, ow) of the tile batch.  The output is small (27 x 32 at
// YOLOv2-16's first layer, at most 2304 x 512) and the reduction long
// (~7e5 pixels at the first layer of a 4-image microbatch on a 2x2 grid),
// so one block per output tile - the TPU kernel's (Cout/bc, K, K) grid -
// would leave most of the 132 SMs idle.  The reduction is split instead
// (split-K): block (co-tile, m-tile, s) sums the pixels of slice s into a
// 64 x 64 register tile (256 threads, 4 x 4 fp32 accumulators each, BK=16
// pixels staged in shared memory per step) and writes an fp32 partial to a
// workspace the wrapper allocates.  A second kernel sums the partials of
// every output element in slice order and casts.  No atomics: the split
// depends on the shape only, so the result is the same on every run.
//
// Bound: fp32 FLOPs on CUDA cores (67 TFLOP/s on an H100 SXM) for the wide
// layers; the first layer (Cin = 3: 27 filter rows) reads far more
// cotangent bytes than it does FLOPs and is bound by HBM bandwidth.  Both
// loads are coalesced: x along ci for a fixed pixel and tap, g along co.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;        // filter rows (ki, kj, ci) per CTA
constexpr int BN = 64;        // output channels per CTA
constexpr int BK = 16;        // pixels per shared-memory stage
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int APAD = 4;       // keeps float4 alignment

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// grid: (Cout tiles, filter-row tiles, splits); slice s covers pixels
// [s*chunk, min(R, (s+1)*chunk)) of R = N*OH*OW.
template <typename TX, typename TG>
__global__ void __launch_bounds__(THREADS)
conv2d_wgrad_partial_kernel(const TX* __restrict__ x, const TG* __restrict__ g,
                            float* __restrict__ part, int H, int W, int Cin, int K,
                            int Cout, int OH, int OW, int stride, long long R,
                            long long chunk) {
  __shared__ __align__(16) float As[BK][BM + APAD];
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int co0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const long long r_begin = (long long)blockIdx.z * chunk;
  const long long r_end = min(R, r_begin + chunk);
  const int KKC = K * K * Cin;
  const int OP = OH * OW;

  // A (activation gather): each thread owns filter row a_m and loads pixels
  // a_k + 4*i of the stage; lanes run along ci, contiguous in x.
  const int a_m = tid % BM;
  const int a_k = tid / BM;
  const bool a_row_ok = m0 + a_m < KKC;
  int a_off = 0;
  if (a_row_ok) {
    const int m = m0 + a_m;
    const int tap = m / Cin;
    const int ci = m - tap * Cin;
    const int ki = tap / K;
    const int kj = tap - ki * K;
    a_off = (ki * W + kj) * Cin + ci;
  }
  // B (cotangent): each thread loads channel b_n of pixels b_k + 4*i.
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

  for (long long r0 = r_begin; r0 < r_end; r0 += BK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kk = a_k + 4 * i;
      const long long r = r0 + kk;
      float v = 0.f;
      if (a_row_ok && r < r_end) {
        const long long n = r / OP;
        const int rem = (int)(r - n * OP);
        const int oh = rem / OW;
        const int ow = rem - oh * OW;
        v = to_f32(x[((n * H + (long long)oh * stride) * W + (long long)ow * stride) * Cin + a_off]);
      }
      As[kk][a_m] = v;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kk = b_k + 4 * i;
      const long long r = r0 + kk;
      Bs[kk][b_n] = (b_ok && r < r_end) ? to_f32(g[r * Cout + co0 + b_n]) : 0.f;
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

  float* out = part + (long long)blockIdx.z * KKC * Cout;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= KKC) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = co0 + tx * 4 + j;
      if (co < Cout) out[(long long)m * Cout + co] = acc[i][j];
    }
  }
}

// dw[e] = sum over s in order of part[s][e], cast to the output type.
template <typename TO>
__global__ void conv2d_wgrad_reduce_kernel(const float* __restrict__ part,
                                           TO* __restrict__ dw, int splits,
                                           long long total) {
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += part[(long long)k * total + e];
    dw[e] = from_f32<TO>(s);
  }
}

template <typename TX, typename TG>
void launch_partial(const void* x, const void* g, float* part, int N, int H, int W,
                    int Cin, int K, int Cout, int OH, int OW, int stride, int splits,
                    long long chunk, cudaStream_t stream) {
  const dim3 grid((Cout + BN - 1) / BN, (K * K * Cin + BM - 1) / BM, splits);
  conv2d_wgrad_partial_kernel<TX, TG><<<grid, THREADS, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TG*>(g), part, H, W, Cin, K, Cout,
      OH, OW, stride, (long long)N * OH * OW, chunk);
}

}  // namespace

extern "C" {

// Launches both passes on ``stream`` and returns cudaGetLastError() (0 on
// success).  ``part`` is fp32 workspace of splits * K*K*Cin * Cout floats;
// x_bf16 / g_bf16 select bf16 (1) or fp32 (0) operands, out_bf16 the type
// of ``dw``.
int conv2d_wgrad_tile_launch(const void* x, const void* g, void* part, void* dw, int N,
                             int H, int W, int Cin, int K, int Cout, int OH, int OW,
                             int stride, int splits, long long chunk, int x_bf16,
                             int g_bf16, int out_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  if (!x_bf16 && !g_bf16) {
    launch_partial<float, float>(x, g, p, N, H, W, Cin, K, Cout, OH, OW, stride, splits,
                                 chunk, s);
  } else if (x_bf16 && !g_bf16) {
    launch_partial<__nv_bfloat16, float>(x, g, p, N, H, W, Cin, K, Cout, OH, OW, stride,
                                         splits, chunk, s);
  } else if (!x_bf16 && g_bf16) {
    launch_partial<float, __nv_bfloat16>(x, g, p, N, H, W, Cin, K, Cout, OH, OW, stride,
                                         splits, chunk, s);
  } else {
    launch_partial<__nv_bfloat16, __nv_bfloat16>(x, g, p, N, H, W, Cin, K, Cout, OH, OW,
                                                 stride, splits, chunk, s);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = (long long)K * K * Cin * Cout;
  const int threads = 256;
  const long long want = (total + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 65535 ? want : 65535);
  if (out_bf16) {
    conv2d_wgrad_reduce_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        p, static_cast<__nv_bfloat16*>(dw), splits, total);
  } else {
    conv2d_wgrad_reduce_kernel<float><<<blocks, threads, 0, s>>>(
        p, static_cast<float*>(dw), splits, total);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* conv2d_wgrad_tile_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
