// Input gradient (dgrad) of the VALID strided NHWC conv of a tile batch.
//
// Replaces the Pallas TPU path repro/kernels/conv2d_tiled/backward.py
// (conv2d_dgrad_tile, which runs the forward kernel kernel.py:conv2d_tile
// on transformed operands): same function -
//   dx[n, p, q, ci] = sum_{ki, kj, co} g[n, oh, ow, co] * w[ki, kj, ci, co]
//   over the (oh, ow) with p = S*oh + ki, q = S*ow + kj -
// with g (N, OH, OW, Cout), w (K, K, Cin, Cout) HWIO, dx (N, H, W, Cin),
// fp32 products and accumulation, output in result_type(g, w).
//
// The reference builds the stride-dilated cotangent padded by K-1 low and
// K-1+r high (r = (H-K) mod S) and the 180-degree-rotated, I/O-swapped
// filter in memory, then runs the forward conv.  Here neither copy exists:
// the kernel is the forward kernel's implicit GEMM (conv2d_tile.cu) with a
// different gather.  GEMM rows are the dx pixels of one image (M = H*W),
// columns the input channels (Cin), and the reduction runs over
// k = (u*K + v)*Cout + co, the rotated tap (u, v) = (K-1-ki, K-1-kj).  A
// row's value at k is g[n, (p-ki)/S, (q-kj)/S, co] when p-ki and q-kj are
// non-negative multiples of S inside g, and zero otherwise: the zero border
// and the dilation live in that bounds check, so the zeros are never
// loaded.  The filter is read rotated in place (w[ki, kj, ci, co]).
//
// Tile: 64 dx pixels x 64 input channels per CTA, 256 threads with a 4x4
// fp32 accumulator each, BK=16 reduction slices staged in shared memory -
// the forward kernel's tile; each slice is summed on its own before it is
// added to the total (chip_smoke.py prints how close the result and the
// plain fp32 version each come to an fp64 dgrad).  Ragged pixel counts,
// Cin and Cout are bounds-checked.  Stride 1 (every YOLOv2-16 conv) skips
// the divisibility test; stride 2 and ragged r > 0 take the general gather.
//
// Bound: fp32 FLOPs on CUDA cores (67 TFLOP/s on an H100 SXM) for the
// training shapes - the same MACs as the forward conv.  The gathered g
// slice has consecutive threads on consecutive output channels (coalesced);
// the filter slice is read along Cout for a fixed ci (16 consecutive
// floats per group of lanes), which costs more transactions than the
// forward kernel's filter load - later work, with tensor-core modes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;        // dx pixels per CTA
constexpr int BN = 64;        // input channels per CTA
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

template <typename TG, typename TW, typename TO>
__global__ void __launch_bounds__(THREADS)
conv2d_dgrad_kernel(const TG* __restrict__ g, const TW* __restrict__ w,
                    TO* __restrict__ dx, int OH, int OW, int Cout, int K, int Cin,
                    int H, int W, int stride) {
  __shared__ __align__(16) float As[BK][BM + APAD];
  __shared__ __align__(16) float Bs[BK][BN + APAD];

  const int tid = threadIdx.x;
  const int img = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int c0 = blockIdx.x * BN;
  const int P = H * W;
  const int KD = K * K * Cout;
  const TG* gn = g + (long long)img * OH * OW * Cout;

  // A (cotangent gather): each thread loads reduction column a_k of rows
  // a_m + 16*i; a warp covers 16 consecutive k, i.e. consecutive channels.
  const int a_k = tid % BK;
  const int a_m = tid / BK;
  int a_p[4], a_q[4];
  bool a_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + a_m + 16 * i;
    a_ok[i] = m < P;
    a_p[i] = a_ok[i] ? m / W : 0;
    a_q[i] = a_ok[i] ? m - a_p[i] * W : 0;
  }
  // B (rotated filter): each thread loads reduction row b_k of columns
  // b_n + 16*i; lanes run along k, i.e. along Cout, contiguous in w.
  const int b_k = tid % BK;
  const int b_n = tid / BK;

  const int ty = tid / 16;
  const int tx = tid % 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < KD; k0 += BK) {
    {
      const int k = k0 + a_k;
      const bool k_ok = k < KD;
      int ki = 0, kj = 0, co = 0;
      if (k_ok) {
        const int tap = k / Cout;             // rotated tap u*K + v
        co = k - tap * Cout;
        const int u = tap / K;
        ki = K - 1 - u;
        kj = K - 1 - (tap - u * K);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float v = 0.f;
        const int rh = a_p[i] - ki;
        const int rw = a_q[i] - kj;
        if (k_ok && a_ok[i] && rh >= 0 && rw >= 0) {
          if (stride == 1) {
            if (rh < OH && rw < OW) v = to_f32(gn[((long long)rh * OW + rw) * Cout + co]);
          } else if (rh % stride == 0 && rw % stride == 0) {
            const int oh = rh / stride;
            const int ow = rw / stride;
            if (oh < OH && ow < OW) v = to_f32(gn[((long long)oh * OW + ow) * Cout + co]);
          }
        }
        As[a_k][a_m + 16 * i] = v;
      }
    }
    {
      const int k = k0 + b_k;
      const bool k_ok = k < KD;
      long long wrow = 0;
      if (k_ok) {
        const int tap = k / Cout;
        const int co = k - tap * Cout;
        const int u = tap / K;
        const int ki = K - 1 - u;
        const int kj = K - 1 - (tap - u * K);
        wrow = (long long)(ki * K + kj) * Cin * Cout + co;   // + ci * Cout
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = b_n + 16 * i;
        const int ci = c0 + n;
        Bs[b_k][n] = (k_ok && ci < Cin) ? to_f32(w[wrow + (long long)ci * Cout]) : 0.f;
      }
    }
    __syncthreads();
    // Two-level sum: each BK slice is summed on its own, then added to the
    // running total, which keeps the rounding error of the long reduction
    // (K*K*Cout terms, twice the forward's at YOLOv2-16's widest layers)
    // below that of one running sum, for 16 more adds per slice.
    float st[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) st[i][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) st[i][j] = fmaf(av[i], bv[j], st[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += st[i][j];
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= P) continue;
    TO* orow = dx + ((long long)img * P + m) * Cin;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ci = c0 + tx * 4 + j;
      if (ci < Cin) orow[ci] = from_f32<TO>(acc[i][j]);
    }
  }
}

template <typename TG, typename TW, typename TO>
void launch(const void* g, const void* w, void* dx, int N, int OH, int OW, int Cout,
            int K, int Cin, int H, int W, int stride, cudaStream_t stream) {
  const dim3 grid((Cin + BN - 1) / BN, (H * W + BM - 1) / BM, N);
  conv2d_dgrad_kernel<TG, TW, TO><<<grid, THREADS, 0, stream>>>(
      static_cast<const TG*>(g), static_cast<const TW*>(w), static_cast<TO*>(dx),
      OH, OW, Cout, K, Cin, H, W, stride);
}

}  // namespace

extern "C" {

// Launches on ``stream`` and returns cudaGetLastError() (0 on success).
// g_bf16 / w_bf16 select bf16 (1) or fp32 (0) operands; dx is fp32 unless
// both are bf16.
int conv2d_dgrad_tile_launch(const void* g, const void* w, void* dx, int N, int OH,
                             int OW, int Cout, int K, int Cin, int H, int W, int stride,
                             int g_bf16, int w_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!g_bf16 && !w_bf16) {
    launch<float, float, float>(g, w, dx, N, OH, OW, Cout, K, Cin, H, W, stride, s);
  } else if (g_bf16 && !w_bf16) {
    launch<__nv_bfloat16, float, float>(g, w, dx, N, OH, OW, Cout, K, Cin, H, W, stride, s);
  } else if (!g_bf16 && w_bf16) {
    launch<float, __nv_bfloat16, float>(g, w, dx, N, OH, OW, Cout, K, Cin, H, W, stride, s);
  } else {
    launch<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16>(g, w, dx, N, OH, OW, Cout, K, Cin,
                                                        H, W, stride, s);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* conv2d_dgrad_tile_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
