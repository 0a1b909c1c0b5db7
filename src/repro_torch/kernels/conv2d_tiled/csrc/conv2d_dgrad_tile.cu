// Input gradient (dgrad) of the VALID strided NHWC conv of a tile batch.
//
// Replaces the Pallas TPU path repro/kernels/conv2d_tiled/backward.py
// (conv2d_dgrad_tile, which runs the forward kernel kernel.py:conv2d_tile
// on transformed operands): same function -
//   dx[n, p, q, ci] = sum_{ki, kj, co} g[n, oh, ow, co] * w[ki, kj, ci, co]
//   over the (oh, ow) with p = S*oh + ki, q = S*ow + kj -
// with g (N, OH, OW, Cout), w (K, K, Cin, Cout) HWIO, dx (N, H, W, Cin),
// fp32 products and accumulation, output in result_type(g, w).  fp32 FFMA
// throughout: TF32 would miss the fp32 bar.
//
// The reference builds the stride-dilated cotangent padded by K-1 low and
// K-1+r high (r = (H-K) mod S) and the 180-degree-rotated, I/O-swapped
// filter in memory, then runs the forward conv.  Here neither copy exists.
// The kernel is a GEMM dx[m, ci] = sum_k A[m, k] * B[ci, k] whose rows m are
// the dx pixels of the whole batch (M = N*H*W), whose columns are the input
// channels, and whose reduction runs over k = (ki*K + kj)*Cout + co.  Both
// operands are K-major with no transpose: A[m, k] = g[n, (p-ki)/S, (q-kj)/S,
// co] where p-ki and q-kj are non-negative multiples of S inside g (zero
// otherwise: the zero border and the dilation are the copy's bounds, so the
// zeros are never loaded), contiguous along co for one tap; B[ci, k] =
// w[ki, kj, ci, co], the filter read rotated in place, contiguous along co.
// Taps are walked in (ki, kj) order; the order of a sum's terms is fixed by
// the shape.
//
// The partial kernel:
// * tiles picked per shape by the wrapper (backward.py:dgrad_tile) from
//   three instances: 128 x 128 (8 x 8 fp32 accumulators per thread) for
//   Cin > 64, 128 x 64 (8 x 4) for Cin = 64 and a narrow 128 x 32 (8 x 4,
//   128 threads) for Cin = 32, so that no CTA carries idle columns;
// * deterministic split-K (backward.py:dgrad_split): where the output tiles
//   do not fill the card, block (m-tile, ci-tile, s) sums the reduction
//   slice s into an fp32 workspace the wrapper allocates, and a second
//   kernel sums the slices of each element in slice order and casts.  No
//   atomics, so a rerun gives the same bits.  One slice writes dx directly;
// * the stride-1 gather ("stride1", every YOLOv2-16 conv: Cout a multiple
//   of the 16-term stage): a stage's 16 terms share one tap, so (ki, kj, co)
//   advance once per stage with no division, each row's (n, p, q) is
//   computed once per CTA, and both tiles load straight along co with
//   16-byte cp.async (4-byte copies where a base is not 16-byte aligned);
//   the zero border goes into cp.async's source size (zero fill).  Other
//   strides and Couts take the "general" gather: one division per term and
//   stage, the stride's divisibility test per element, loads through
//   registers;
// * cp.async double buffering: stage s+1 is in flight while stage s is
//   multiplied; bf16 operands are staged through registers and widened when
//   stored.  Shared rows hold 16 terms + 4 floats of pad, so a warp's
//   16-byte reads along k are free of bank conflicts; the inner loop reads
//   float4s along k from both tiles (per 4 terms: TM + TN float4 reads for
//   4 * TM * TN FFMAs);
// * two-level sums: each stage's 16 terms are summed on their own before
//   they join the running total, which keeps the rounding error of the long
//   reduction (K*K*Cout = 4608 terms at YOLOv2-16's widest layers) below
//   that of one running sum (chip_smoke.py prints how close the result and
//   the plain fp32 version each come to an fp64 dgrad).
//
// Bound: fp32 FLOPs on CUDA cores (67 TFLOP/s on an H100 SXM) for the
// training shapes - the same MACs as the forward conv.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BK = 16;         // reduction terms per stage
constexpr int KPAD = BK + 4;   // floats per shared-memory row
constexpr int FAR = -(1 << 28);   // the p of a row past M: every bounds test fails

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
// copy `bytes` (16 or 4) from global to shared, or zeros where !ok
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

// grid: (m tiles, ci tiles, splits); slice s covers the reduction terms
// [s*chunk, min(KD, (s+1)*chunk)).  Thread (ty, tx) owns dx rows
// m0 + ty + (BM/TM)*i and channels c0 + tx + (BN/TN)*j.  Loads: slot
// tid + THREADS*i of a tile is row (slot / 4), terms 4*(slot % 4) .. +3 of
// the stage, for A (dx rows) and B (channels) alike.
template <int BM, int BN, int TM, int TN, bool FAST, typename TG, typename TW, typename TO>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
conv2d_dgrad_partial_kernel(const TG* __restrict__ g, const TW* __restrict__ w,
                            float* __restrict__ part, TO* __restrict__ dx, int OH, int OW,
                            int Cout, int K, int Cin, int H, int W, int stride, int M, int KD,
                            int chunk, int vec) {
  constexpr int TX = BN / TN, TY = BM / TM;       // threads along ci and along m
  constexpr int THREADS = TX * TY;
  constexpr int A_SLOTS = BM * (BK / 4) / THREADS, B_SLOTS = BN * (BK / 4) / THREADS;
  static_assert(A_SLOTS >= 1 && B_SLOTS >= 1 && BM * (BK / 4) % THREADS == 0 &&
                    BN * (BK / 4) % THREADS == 0 && THREADS % 4 == 0,
                "tile shape");
  constexpr bool A_ASYNC = FAST && std::is_same<TG, float>::value;
  constexpr bool B_ASYNC = FAST && std::is_same<TW, float>::value;
  __shared__ __align__(16) float As[2][BM][KPAD];
  __shared__ __align__(16) float Bs[2][BN][KPAD];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int c0 = blockIdx.y * BN;
  const int k_begin = blockIdx.z * chunk;
  const int k_end = min(KD, k_begin + chunk);
  const int n_stages = (k_end - k_begin + BK - 1) / BK;
  const int quarter = tid % 4;      // this thread's 4 terms of a stage: 4*quarter .. +3

  // each A slot's dx pixel (n, p, q), divisions once per CTA; a_n = n*OH*OW
  int a_p[A_SLOTS], a_q[A_SLOTS], a_n[A_SLOTS];
#pragma unroll
  for (int i = 0; i < A_SLOTS; ++i) {
    const int m = m0 + tid / 4 + (THREADS / 4) * i;
    const int hw = H * W;
    const int n = m / hw, rem = m - (m / hw) * hw;
    a_p[i] = m < M ? rem / W : FAR;
    a_q[i] = rem - (rem / W) * W;
    a_n[i] = n * OH * OW;
  }
  bool b_ok[B_SLOTS];
#pragma unroll
  for (int i = 0; i < B_SLOTS; ++i) b_ok[i] = c0 + tid / 4 + (THREADS / 4) * i < Cin;

  // the stride-1 gather's tap and channel offset of the next stage to fetch
  int ki = 0, kj = 0, co0 = 0;
  if constexpr (FAST) {
    const int tap = k_begin / Cout;
    co0 = k_begin - tap * Cout;
    ki = tap / K;
    kj = tap - ki * K;
  }

  float a_reg[A_SLOTS][4], b_reg[B_SLOTS][4];   // a stage in flight through registers

  // issue stage s's loads into buffer `buf` (cp.async) or registers
  auto fetch = [&](int s, int buf) {
    if constexpr (FAST) {
      const int co = co0 + 4 * quarter;
#pragma unroll
      for (int i = 0; i < A_SLOTS; ++i) {
        const int rh = a_p[i] - ki, rw = a_q[i] - kj;
        const bool ok = rh >= 0 && rh < OH && rw >= 0 && rw < OW;
        const TG* src = g + (ok ? ((long long)a_n[i] + rh * OW + rw) * Cout + co : 0);
        if constexpr (A_ASYNC) {
          float* dst = &As[buf][tid / 4 + (THREADS / 4) * i][4 * quarter];
          if (vec) {
            cp_async16(dst, src, ok);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) cp_async4(dst + e, src + e, ok);
          }
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) a_reg[i][e] = ok ? to_f32(src[e]) : 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < B_SLOTS; ++i) {
        const int ci = c0 + tid / 4 + (THREADS / 4) * i;
        const TW* src = w + (b_ok[i] ? ((long long)(ki * K + kj) * Cin + ci) * Cout + co : 0);
        if constexpr (B_ASYNC) {
          float* dst = &Bs[buf][tid / 4 + (THREADS / 4) * i][4 * quarter];
          if (vec) {
            cp_async16(dst, src, b_ok[i]);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) cp_async4(dst + e, src + e, b_ok[i]);
          }
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) b_reg[i][e] = b_ok[i] ? to_f32(src[e]) : 0.f;
        }
      }
      co0 += BK;                     // the next stage: the next 16 channels or the next tap
      if (co0 == Cout) {
        co0 = 0;
        if (++kj == K) {
          kj = 0;
          ++ki;
        }
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = k_begin + s * BK + 4 * quarter + e;
        const bool k_ok = k < k_end;
        const int tap = k_ok ? k / Cout : 0;
        const int co = k_ok ? k - tap * Cout : 0;
        const int ti = tap / K, tj = tap - (tap / K) * K;
#pragma unroll
        for (int i = 0; i < A_SLOTS; ++i) {
          float v = 0.f;
          const int rh = a_p[i] - ti, rw = a_q[i] - tj;
          if (k_ok && rh >= 0 && rw >= 0 && rh % stride == 0 && rw % stride == 0) {
            const int oh = rh / stride, ow = rw / stride;
            if (oh < OH && ow < OW)
              v = to_f32(g[((long long)a_n[i] + oh * OW + ow) * Cout + co]);
          }
          a_reg[i][e] = v;
        }
#pragma unroll
        for (int i = 0; i < B_SLOTS; ++i) {
          const int ci = c0 + tid / 4 + (THREADS / 4) * i;
          b_reg[i][e] = k_ok && b_ok[i]
                            ? to_f32(w[((long long)(ti * K + tj) * Cin + ci) * Cout + co])
                            : 0.f;
        }
      }
    }
  };
  // operands staged in registers: the stage in flight into buffer `buf`
  auto store = [&](int buf) {
    if constexpr (!A_ASYNC) {
#pragma unroll
      for (int i = 0; i < A_SLOTS; ++i)
        *reinterpret_cast<float4*>(&As[buf][tid / 4 + (THREADS / 4) * i][4 * quarter]) =
            make_float4(a_reg[i][0], a_reg[i][1], a_reg[i][2], a_reg[i][3]);
    }
    if constexpr (!B_ASYNC) {
#pragma unroll
      for (int i = 0; i < B_SLOTS; ++i)
        *reinterpret_cast<float4*>(&Bs[buf][tid / 4 + (THREADS / 4) * i][4 * quarter]) =
            make_float4(b_reg[i][0], b_reg[i][1], b_reg[i][2], b_reg[i][3]);
    }
  };

  const int tx = tid % TX, ty = tid / TX;
  float acc[TM][TN], st[TM][TN];
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
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) st[i][j] = 0.f;
#pragma unroll
    for (int k4 = 0; k4 < BK; k4 += 4) {
      float4 b[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = *reinterpret_cast<const float4*>(&Bs[cur][tx + TX * j][k4]);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(&As[cur][ty + TY * i][k4]);
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          st[i][j] = fmaf(a.x, b[j].x, st[i][j]);
          st[i][j] = fmaf(a.y, b[j].y, st[i][j]);
          st[i][j] = fmaf(a.z, b[j].z, st[i][j]);
          st[i][j] = fmaf(a.w, b[j].w, st[i][j]);
        }
      }
    }
    // two-level sum: the stage's own sum joins the total
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] += st[i][j];
    if (s + 1 < n_stages) store(cur ^ 1);
    __syncthreads();
  }

  float* out = part == nullptr ? nullptr : part + (long long)blockIdx.z * M * Cin;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + TY * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int ci = c0 + tx + TX * j;
      if (ci >= Cin) continue;
      const long long e = (long long)m * Cin + ci;
      if (out != nullptr)
        out[e] = acc[i][j];
      else
        dx[e] = from_f32<TO>(acc[i][j]);
    }
  }
}

// dx[e] = sum over s of part[s][e] in slice order, cast to the output type;
// V4: four consecutive elements a thread by float4 (total % 4 == 0), else one
template <typename TO, bool V4>
__global__ void __launch_bounds__(256)
conv2d_dgrad_reduce_kernel(const float* __restrict__ part, TO* __restrict__ dx, int splits,
                           long long total) {
  const long long e = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * (V4 ? 4 : 1);
  if (e >= total) return;
  if constexpr (V4) {
    float4 t = *reinterpret_cast<const float4*>(part + e);
    for (int s = 1; s < splits; ++s) {
      const float4 v = *reinterpret_cast<const float4*>(part + (long long)s * total + e);
      t.x += v.x;
      t.y += v.y;
      t.z += v.z;
      t.w += v.w;
    }
    dx[e] = from_f32<TO>(t.x);
    dx[e + 1] = from_f32<TO>(t.y);
    dx[e + 2] = from_f32<TO>(t.z);
    dx[e + 3] = from_f32<TO>(t.w);
  } else {
    float t = part[e];
    for (int s = 1; s < splits; ++s) t += part[(long long)s * total + e];
    dx[e] = from_f32<TO>(t);
  }
}

template <int BM, int BN, int TM, int TN, typename TG, typename TW, typename TO>
void launch_partial(const void* g, const void* w, float* part, void* dx, int N, int OH, int OW,
                    int Cout, int K, int Cin, int H, int W, int stride, int splits, int chunk,
                    int fast, cudaStream_t stream) {
  const int M = N * H * W;
  const dim3 grid((M + BM - 1) / BM, (Cin + BN - 1) / BN, splits);
  const int threads = (BM / TM) * (BN / TN);
  const int vec = reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if (fast) {
    conv2d_dgrad_partial_kernel<BM, BN, TM, TN, true, TG, TW, TO><<<grid, threads, 0, stream>>>(
        static_cast<const TG*>(g), static_cast<const TW*>(w), part, static_cast<TO*>(dx), OH,
        OW, Cout, K, Cin, H, W, stride, M, K * K * Cout, chunk, vec);
  } else {
    conv2d_dgrad_partial_kernel<BM, BN, TM, TN, false, TG, TW, TO><<<grid, threads, 0, stream>>>(
        static_cast<const TG*>(g), static_cast<const TW*>(w), part, static_cast<TO*>(dx), OH,
        OW, Cout, K, Cin, H, W, stride, M, K * K * Cout, chunk, vec);
  }
}

// tile: 0 = 128 x 32 (8 x 4 per thread), 1 = 128 x 64 (8 x 4), 2 = 128 x 128 (8 x 8)
template <typename TG, typename TW, typename TO>
cudaError_t launch_typed(int tile, const void* g, const void* w, void* part, void* dx, int N,
                         int OH, int OW, int Cout, int K, int Cin, int H, int W, int stride,
                         int splits, int chunk, int fast, cudaStream_t s) {
  float* p = splits > 1 ? static_cast<float*>(part) : nullptr;
  if (tile == 0)
    launch_partial<128, 32, 8, 4, TG, TW, TO>(g, w, p, dx, N, OH, OW, Cout, K, Cin, H, W, stride,
                                              splits, chunk, fast, s);
  else if (tile == 1)
    launch_partial<128, 64, 8, 4, TG, TW, TO>(g, w, p, dx, N, OH, OW, Cout, K, Cin, H, W, stride,
                                              splits, chunk, fast, s);
  else
    launch_partial<128, 128, 8, 8, TG, TW, TO>(g, w, p, dx, N, OH, OW, Cout, K, Cin, H, W,
                                               stride, splits, chunk, fast, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long total = (long long)N * H * W * Cin;
  if (total % 4 == 0) {
    conv2d_dgrad_reduce_kernel<TO, true><<<static_cast<unsigned>((total / 4 + 255) / 256), 256, 0,
                                           s>>>(p, static_cast<TO*>(dx), splits, total);
  } else {
    conv2d_dgrad_reduce_kernel<TO, false><<<static_cast<unsigned>((total + 255) / 256), 256, 0,
                                            s>>>(p, static_cast<TO*>(dx), splits, total);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the partial kernel and, where splits > 1, the reduce on
// ``stream``; returns the first cudaError_t (0 on success).  ``part`` is
// fp32 workspace of splits * N*H*W * Cin floats (unused when splits == 1);
// ``chunk`` the reduction terms per slice (a multiple of 16); ``fast``
// selects the stride-1 gather (stride 1, Cout a multiple of 16); g_bf16 /
// w_bf16 select bf16 (1) or fp32 (0) operands - dx is fp32 unless both are
// bf16; ``tile`` the partial kernel's tile (see launch_typed).
int conv2d_dgrad_tile_launch(const void* g, const void* w, void* part, void* dx, int N, int OH,
                             int OW, int Cout, int K, int Cin, int H, int W, int stride,
                             int splits, int chunk, int fast, int g_bf16, int w_bf16, int tile,
                             void* stream) {
  if (tile < 0 || tile > 2 || splits < 1 || chunk < BK || chunk % BK != 0 ||
      (fast && (stride != 1 || Cout % BK != 0)) || (splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (!g_bf16 && !w_bf16) {
    err = launch_typed<float, float, float>(tile, g, w, part, dx, N, OH, OW, Cout, K, Cin, H, W,
                                            stride, splits, chunk, fast, s);
  } else if (g_bf16 && !w_bf16) {
    err = launch_typed<__nv_bfloat16, float, float>(tile, g, w, part, dx, N, OH, OW, Cout, K,
                                                    Cin, H, W, stride, splits, chunk, fast, s);
  } else if (!g_bf16 && w_bf16) {
    err = launch_typed<float, __nv_bfloat16, float>(tile, g, w, part, dx, N, OH, OW, Cout, K,
                                                    Cin, H, W, stride, splits, chunk, fast, s);
  } else {
    err = launch_typed<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16>(
        tile, g, w, part, dx, N, OH, OW, Cout, K, Cin, H, W, stride, splits, chunk, fast, s);
  }
  return static_cast<int>(err);
}

const char* conv2d_dgrad_tile_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
