// Weight gradient (wgrad) of the VALID strided NHWC conv of a tile batch.
//
// Replaces the Pallas TPU kernel repro/kernels/conv2d_tiled/backward.py
// (conv2d_wgrad_tile / _wgrad_kernel): same function -
//   dw[ki, kj, ci, co] = sum_{n, oh, ow} x[n, S*oh+ki, S*ow+kj, ci] * g[n, oh, ow, co]
// with x (N, H, W, Cin) NHWC, g (N, OH, OW, Cout), dw (K, K, Cin, Cout) HWIO,
// fp32 products and accumulation (backward.py:119-120), output in the
// caller's dtype.  fp32 FFMA throughout: TF32 would miss the fp32 bar.
//
// Design: a GEMM whose rows are the filter rows m = (ki*K + kj)*Cin + ci
// (the HWIO filter is already a row-major (K*K*Cin, Cout) matrix), whose
// columns are the output channels, and whose reduction runs over every
// pixel r = (n, oh, ow) of the tile batch.  The output is small (27 x 32 at
// YOLOv2-16's first layer, at most 2304 x 512) and the reduction long
// (~7e5 pixels at the first layer of a 4-image microbatch on a 2x2 grid),
// so the reduction is split (split-K): block (co-tile, m-tile, s) sums the
// pixels of slice s and writes an fp32 partial to a workspace the wrapper
// allocates; a second kernel sums the partials of every output element in
// an order fixed by the code and casts.  No atomics: the split depends on
// the shape only, so the result is the same on every run.
//
// The partial kernel:
// * tiles picked per shape by the wrapper (kernel.py:wgrad_tile) from three
//   instances: 128 x 128 (8 x 8 fp32 accumulators per thread) for the wide
//   layers, 128 x 64 (8 x 4) where Cout <= 64, 32 x 32 (4 x 4, 64 threads)
//   for the first layer's 27 x 32 output;
// * register blocking: each thread's 8 x 8 block is fed per pixel by 4
//   shared-memory float4 loads (two along m, two along co) for 64 FFMAs;
// * double buffering: stage s+1's 16 pixels are in flight while stage s is
//   multiplied - fp32 operands by cp.async straight into shared memory (16
//   bytes where Cin / Cout are multiples of 4 and the bases 16-byte aligned,
//   else 4), bf16 operands through registers, widened when stored;
// * the im2col gather walks each thread's pixel coordinates (n, oh, ow)
//   forward by 16 pixels a stage with compares and subtractions, no
//   division.  Both tiles are stored pixel-major ([pixel][m], [pixel][co]),
//   which is how both global operands are laid out, so no transpose.
//
// Bound: fp32 FFMA on CUDA cores (67 TFLOP/s on an H100 SXM) for the wide
// layers; the first layer (Cin = 3: 27 filter rows) reads far more
// cotangent bytes than it does FLOPs and is bound by HBM bandwidth.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BK = 16;   // pixels per stage

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// copy `bytes` (4 or 16) from global to shared, or zeros where !ok
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// grid: (Cout tiles, filter-row tiles, splits); slice s covers pixels
// [s*chunk, min(R, (s+1)*chunk)) of R = N*OH*OW.  Thread (ty, tx) owns
// filter rows r*(BM/RM) + 4*ty + {0..3} and channels r*(BN/RN) + 4*tx + {0..3}.
template <int BM, int BN, int TM, int TN, typename TX, typename TG>
__global__ void __launch_bounds__((BM / TM) * (BN / TN), (BM / TM) * (BN / TN) >= 256 ? 2 : 8)
conv2d_wgrad_partial_kernel(const TX* __restrict__ x, const TG* __restrict__ g,
                            float* __restrict__ part, int H, int W, int Cin, int K, int Cout,
                            int OH, int OW, int stride, long long R, long long chunk, int vec_a,
                            int vec_b) {
  constexpr int THREADS = (BM / TM) * (BN / TN);
  constexpr int RM = TM / 4, RN = TN / 4;           // float4 groups per thread
  constexpr int A_ROW = BM / 4, B_ROW = BN / 4;     // float4 slots per pixel
  constexpr int A_PASS = THREADS / A_ROW, B_PASS = THREADS / B_ROW;   // pixels per pass
  constexpr int A_SLOTS = BK / A_PASS, B_SLOTS = BK / B_PASS;
  static_assert(TM % 4 == 0 && TN % 4 == 0 && THREADS % A_ROW == 0 && THREADS % B_ROW == 0 &&
                    BK % A_PASS == 0 && BK % B_PASS == 0,
                "tile shape");
  constexpr bool A_ASYNC = std::is_same<TX, float>::value;
  constexpr bool B_ASYNC = std::is_same<TG, float>::value;
  __shared__ __align__(16) float As[2][BK][BM];
  __shared__ __align__(16) float Bs[2][BK][BN];

  const int tid = threadIdx.x;
  const int co0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const long long r_begin = (long long)blockIdx.z * chunk;
  const long long r_end = min(R, r_begin + chunk);
  const int rows = K * K * Cin;
  const int OP = OH * OW;
  const int n_stages = (int)((r_end - r_begin + BK - 1) / BK);

  // A (activation gather): filter rows m0 + 4*am + {0..3} of pixels
  // ak + A_PASS*i; lanes run along m, i.e. along ci, contiguous in x
  const int am = tid % A_ROW, ak = tid / A_ROW;
  int a_off[4];
  bool a_ok[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int m = m0 + 4 * am + e;
    a_ok[e] = m < rows;
    const int tap = m / Cin, ci = m - (m / Cin) * Cin;
    const int ki = tap / K, kj = tap - (tap / K) * K;
    a_off[e] = a_ok[e] ? (ki * W + kj) * Cin + ci : 0;
  }
  int a_n[A_SLOTS], a_oh[A_SLOTS], a_ow[A_SLOTS];
#pragma unroll
  for (int i = 0; i < A_SLOTS; ++i) {
    const long long r = min(r_begin + ak + A_PASS * i, R - 1);   // divisions once, here
    a_n[i] = (int)(r / OP);
    const int rem = (int)(r - (long long)a_n[i] * OP);
    a_oh[i] = rem / OW;
    a_ow[i] = rem - a_oh[i] * OW;
  }
  // B (cotangent): channels co0 + 4*bn + {0..3} of pixels bk + B_PASS*i
  const int bn = tid % B_ROW, bk = tid / B_ROW;
  bool b_ok[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) b_ok[e] = co0 + 4 * bn + e < Cout;

  float a_reg[A_SLOTS][4], b_reg[B_SLOTS][4];   // bf16 operands' stage in flight

  // issue stage s's loads into buffer `buf` (cp.async) or registers (bf16),
  // then step the gather coordinates on by BK pixels
  auto fetch = [&](int s, int buf) {
    const long long base = r_begin + (long long)s * BK;
#pragma unroll
    for (int i = 0; i < A_SLOTS; ++i) {
      const int kk = ak + A_PASS * i;
      const bool live = base + kk < r_end;
      const TX* src = x + (live ? (((long long)a_n[i] * H + a_oh[i] * stride) * W +
                                   a_ow[i] * stride) * Cin
                                : 0);
      if constexpr (A_ASYNC) {
        float* dst = &As[buf][kk][4 * am];
        if (vec_a) {
          cp_async16(dst, src + a_off[0], live && a_ok[0]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) cp_async4(dst + e, src + a_off[e], live && a_ok[e]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) a_reg[i][e] = live && a_ok[e] ? to_f32(src[a_off[e]]) : 0.f;
      }
      a_ow[i] += BK;
      while (a_ow[i] >= OW) {
        a_ow[i] -= OW;
        if (++a_oh[i] == OH) {
          a_oh[i] = 0;
          ++a_n[i];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < B_SLOTS; ++i) {
      const int kk = bk + B_PASS * i;
      const bool live = base + kk < r_end;
      const TG* src = g + (live ? (base + kk) * Cout + co0 + 4 * bn : 0);
      if constexpr (B_ASYNC) {
        float* dst = &Bs[buf][kk][4 * bn];
        if (vec_b) {
          cp_async16(dst, src, live && b_ok[0]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) cp_async4(dst + e, src + e, live && b_ok[e]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) b_reg[i][e] = live && b_ok[e] ? to_f32(src[e]) : 0.f;
      }
    }
  };
  // bf16 operands: the registers of the stage in flight into buffer `buf`
  auto store = [&](int buf) {
    if constexpr (!A_ASYNC) {
#pragma unroll
      for (int i = 0; i < A_SLOTS; ++i)
        *reinterpret_cast<float4*>(&As[buf][ak + A_PASS * i][4 * am]) =
            make_float4(a_reg[i][0], a_reg[i][1], a_reg[i][2], a_reg[i][3]);
    }
    if constexpr (!B_ASYNC) {
#pragma unroll
      for (int i = 0; i < B_SLOTS; ++i)
        *reinterpret_cast<float4*>(&Bs[buf][bk + B_PASS * i][4 * bn]) =
            make_float4(b_reg[i][0], b_reg[i][1], b_reg[i][2], b_reg[i][3]);
    }
  };

  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  fetch(0, 0);
  store(0);
  cp_async_commit();
  for (int s = 0; s < n_stages; ++s) {
    const int cur = s & 1;
    if (s + 1 < n_stages) fetch(s + 1, cur ^ 1);
    cp_async_commit();
    cp_async_wait_one();         // stage s has landed (s+1 may be in flight)
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        const float4 v = *reinterpret_cast<const float4*>(&As[cur][kk][r * (BM / RM) + 4 * ty]);
        a[4 * r] = v.x;
        a[4 * r + 1] = v.y;
        a[4 * r + 2] = v.z;
        a[4 * r + 3] = v.w;
      }
#pragma unroll
      for (int r = 0; r < RN; ++r) {
        const float4 v = *reinterpret_cast<const float4*>(&Bs[cur][kk][r * (BN / RN) + 4 * tx]);
        b[4 * r] = v.x;
        b[4 * r + 1] = v.y;
        b[4 * r + 2] = v.z;
        b[4 * r + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (s + 1 < n_stages) store(cur ^ 1);
    __syncthreads();
  }

  float* out = part + (long long)blockIdx.z * rows * Cout;
  const bool vec_out = (Cout & 3) == 0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + (i / 4) * (BM / RM) + 4 * ty + i % 4;
    if (m >= rows) continue;
#pragma unroll
    for (int r = 0; r < RN; ++r) {
      const int co = co0 + r * (BN / RN) + 4 * tx;
      float* dst = out + (long long)m * Cout + co;
      if (vec_out && co + 3 < Cout) {
        *reinterpret_cast<float4*>(dst) =
            make_float4(acc[i][4 * r], acc[i][4 * r + 1], acc[i][4 * r + 2], acc[i][4 * r + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (co + e < Cout) dst[e] = acc[i][4 * r + e];
      }
    }
  }
}

// dw[e] = sum over s of part[s][e], cast to the output type, in an order
// fixed by the shape: `ways` warps (1, 2, 4 or 8) share 32 consecutive
// elements, warp r of them summing splits r, r + ways, ... in turn (four
// loads in flight), and the first adds the `ways` sums in warp order.  The
// host picks `ways` so that about 2^18 threads run (reduce_ways): the first
// layer has 864 outputs and ~2000 splits, where one chain per output left
// most SMs idle, and the widest layers have 1.2M outputs and 8 splits.
constexpr int RED_WARPS = 8;

template <typename TO>
__global__ void __launch_bounds__(32 * RED_WARPS)
conv2d_wgrad_reduce_kernel(const float* __restrict__ part, TO* __restrict__ dw, int splits,
                           long long total, int ways) {
  __shared__ float sums[RED_WARPS][32];
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int r = w % ways;                                   // this warp's split residue
  const long long e = ((long long)blockIdx.x * (RED_WARPS / ways) + w / ways) * 32 + lane;
  float s = 0.f;
  if (e < total) {
    int k = r;
    for (; k + 3 * ways < splits; k += 4 * ways) {
      const float a0 = part[(long long)k * total + e];
      const float a1 = part[(long long)(k + ways) * total + e];
      const float a2 = part[(long long)(k + 2 * ways) * total + e];
      const float a3 = part[(long long)(k + 3 * ways) * total + e];
      s = (((s + a0) + a1) + a2) + a3;
    }
    for (; k < splits; k += ways) s += part[(long long)k * total + e];
  }
  sums[w][lane] = s;
  __syncthreads();
  if (r == 0 && e < total) {
    float t = s;
    for (int i = 1; i < ways; ++i) t += sums[w + i][lane];
    dw[e] = from_f32<TO>(t);
  }
}

// warps per 32 outputs in the reduce: a power of two <= RED_WARPS and <=
// splits, enough that total * ways reaches about 2^18 threads
int reduce_ways(long long total, int splits) {
  int ways = 1;
  while (ways < RED_WARPS && 2 * ways <= splits && total * ways < (1 << 18)) ways *= 2;
  return ways;
}

template <int BM, int BN, int TM, int TN, typename TX, typename TG>
void launch_partial(const void* x, const void* g, float* part, int N, int H, int W, int Cin,
                    int K, int Cout, int OH, int OW, int stride, int splits, long long chunk,
                    cudaStream_t stream) {
  const dim3 grid((Cout + BN - 1) / BN, (K * K * Cin + BM - 1) / BM, splits);
  const int vec_a = Cin % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int vec_b = Cout % 4 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0;
  conv2d_wgrad_partial_kernel<BM, BN, TM, TN, TX, TG><<<grid, (BM / TM) * (BN / TN), 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TG*>(g), part, H, W, Cin, K, Cout, OH, OW,
      stride, (long long)N * OH * OW, chunk, vec_a, vec_b);
}

// tile: 0 = 32 x 32 (4 x 4 per thread), 1 = 128 x 64 (8 x 4), 2 = 128 x 128 (8 x 8)
template <typename TX, typename TG>
void launch_tile(int tile, const void* x, const void* g, float* part, int N, int H, int W,
                 int Cin, int K, int Cout, int OH, int OW, int stride, int splits, long long chunk,
                 cudaStream_t s) {
  if (tile == 0)
    launch_partial<32, 32, 4, 4, TX, TG>(x, g, part, N, H, W, Cin, K, Cout, OH, OW, stride,
                                         splits, chunk, s);
  else if (tile == 1)
    launch_partial<128, 64, 8, 4, TX, TG>(x, g, part, N, H, W, Cin, K, Cout, OH, OW, stride,
                                          splits, chunk, s);
  else
    launch_partial<128, 128, 8, 8, TX, TG>(x, g, part, N, H, W, Cin, K, Cout, OH, OW, stride,
                                           splits, chunk, s);
}

}  // namespace

extern "C" {

// Launches both passes on ``stream`` and returns cudaGetLastError() (0 on
// success).  ``part`` is fp32 workspace of splits * K*K*Cin * Cout floats;
// x_bf16 / g_bf16 select bf16 (1) or fp32 (0) operands, out_bf16 the type
// of ``dw``; ``tile`` the partial kernel's tile (see launch_tile).
int conv2d_wgrad_tile_launch(const void* x, const void* g, void* part, void* dw, int N,
                             int H, int W, int Cin, int K, int Cout, int OH, int OW,
                             int stride, int splits, long long chunk, int x_bf16,
                             int g_bf16, int out_bf16, int tile, void* stream) {
  if (tile < 0 || tile > 2) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  if (!x_bf16 && !g_bf16) {
    launch_tile<float, float>(tile, x, g, p, N, H, W, Cin, K, Cout, OH, OW, stride, splits, chunk,
                              s);
  } else if (x_bf16 && !g_bf16) {
    launch_tile<__nv_bfloat16, float>(tile, x, g, p, N, H, W, Cin, K, Cout, OH, OW, stride,
                                      splits, chunk, s);
  } else if (!x_bf16 && g_bf16) {
    launch_tile<float, __nv_bfloat16>(tile, x, g, p, N, H, W, Cin, K, Cout, OH, OW, stride,
                                      splits, chunk, s);
  } else {
    launch_tile<__nv_bfloat16, __nv_bfloat16>(tile, x, g, p, N, H, W, Cin, K, Cout, OH, OW,
                                              stride, splits, chunk, s);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = (long long)K * K * Cin * Cout;
  const int ways = reduce_ways(total, splits);
  const long long per_block = 32LL * (RED_WARPS / ways);
  const unsigned blocks = static_cast<unsigned>((total + per_block - 1) / per_block);
  if (out_bf16) {
    conv2d_wgrad_reduce_kernel<__nv_bfloat16><<<blocks, 32 * RED_WARPS, 0, s>>>(
        p, static_cast<__nv_bfloat16*>(dw), splits, total, ways);
  } else {
    conv2d_wgrad_reduce_kernel<float><<<blocks, 32 * RED_WARPS, 0, s>>>(
        p, static_cast<float*>(dw), splits, total, ways);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* conv2d_wgrad_tile_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
