// VALID NHWC conv2d of a batch of halo-extended tiles, fused bias + activation.
//
// Replaces the Pallas TPU kernel repro/kernels/conv2d_tiled/kernel.py
// (conv2d_tile / _conv_kernel): same function - y = act(conv_valid(x, w) + b)
// with x (N, H, W, Cin) NHWC, w (K, K, Cin, Cout) HWIO, fp32 products and
// accumulation, output in result_type(x, w) - but not the same blocking.
//
// The kernel is a GEMM y[m, co] = sum_k A[m, k] B[k, co] whose rows m are the
// output pixels of the whole batch (M = N*OH*OW, flattened across tiles and
// images, so no image pads a block), whose columns are the output channels
// and whose reduction runs over k = (ki*K + kj)*Cin + ci.  A[m, k] =
// x[n, S*oh + ki, S*ow + kj, ci] is contiguous along ci for one tap; B[k, co]
// = w is the HWIO filter read as a row-major (K*K*Cin, Cout) matrix.  Each
// row's (n, oh, ow) - its base offset in x - is computed once per CTA.  Taps
// are walked in (ki, kj) order and a slice's terms are summed in k order
// with one running sum, so a result's bits are fixed by the shape.
//
// The partial kernel:
// * tiles picked per shape by the wrapper (kernel.py:fwd_tile) from three
//   instances: 128 x 128 (8 x 8 fp32 accumulators per thread: 64 FFMAs per
//   16 floats read from shared memory) for Cout > 64, 128 x 64 (8 x 4) for
//   Cout = 64 and a narrow 128 x 32 (8 x 4, 128 threads) for Cout <= 32,
//   so that no CTA carries idle columns;
// * one running sum a thread (no two-level sums): <= 128 registers a thread,
//   so two 256-thread blocks stay resident per SM (__launch_bounds__(.., 2))
//   in the fp32 instances of the vector gather (the path's; min_blocks);
// * the "vector" gather (kernel.py:fwd_gather; every YOLOv2-16 conv but the
//   Cin = 3 first layer: Cin a multiple of the 16-term stage): a stage's 16
//   terms share one tap, so (ki, kj, ci) advance once per stage with no
//   division, at any stride (the stride moves a row's base, not the walk),
//   and the A tile loads straight along ci with 16-byte cp.async.  Other
//   Cins take the "general" gather: one division per term and stage, loads
//   through registers;
// * the B tile (16 filter rows x BN channels) loads along co with 16-byte
//   cp.async where Cout is a multiple of 4 and w is 16-byte aligned, else
//   with 4-byte copies; cp.async's source size zero-fills past Cout and KD;
// * cp.async double buffering: stage s+1 is in flight while stage s is
//   multiplied; bf16 operands are staged through registers and widened when
//   stored.  A rows hold 16 terms + 4 floats of pad (16-byte reads along k
//   free of bank conflicts); B rows hold BN channels; per 4 terms a thread
//   reads TM float4s of A and 4 * TN / 4 float4s of B for 4 * TM * TN FFMAs;
// * deterministic split-K (kernel.py:fwd_split) only where the output tiles
//   do not fill the card (the 1x1 layers): block (m-tile, co-tile, s) sums
//   slice s into an fp32 workspace, and a second kernel sums each element's
//   slices in slice order, adds the bias and applies the activation once.
//   No atomics: a rerun gives the same bits.  One slice writes y directly,
//   bias and activation in the partial kernel's epilogue;
// * a vectorised epilogue: a thread's columns come in runs of 4 (tx*4 + j,
//   and 64 + tx*4 + j for the 128-wide tile), stored as one 16-byte (fp32) or
//   8-byte (bf16) store where Cout is a multiple of 4, else element by
//   element.
//
// Bound: fp32 FLOPs on CUDA cores (67 TFLOP/s on an H100 SXM) for every conv
// of the serve path except the Cin=3 first layer, which moves more bytes
// than it computes.  The serve path is fp32 and TF32 tensor cores would not
// meet the fp32 tolerance (atol 2e-5, rtol 1e-4), so this kernel stays on
// FFMA.
//
// The TPU kernel's block_oh output-row blocking exists to bound a VMEM
// accumulator; here the M-tile spans the batch, so the wrapper accepts
// block_oh and ignores it (results do not depend on it).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BK = 16;         // reduction terms per stage
constexpr int KPAD = BK + 4;   // floats per shared-memory row of the A tile

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
// copy 16 or 4 bytes from global to shared, or zeros where !ok
__device__ __forceinline__ void cp_async16(float* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const void* src, bool ok) {
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

// act: 0 linear, 1 relu, 2 leaky (slope 0.1, darknet's)
__device__ __forceinline__ float activate(float v, int act) {
  if (act == 1) return fmaxf(v, 0.f);
  if (act == 2) return v > 0.f ? v : 0.1f * v;
  return v;
}

// four consecutive outputs of one row, in the output type
__device__ __forceinline__ void store4(float* dst, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(dst) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, float a, float b, float c, float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b), hi = __floats2bfloat162_rn(c, d);
  uint2 v;
  v.x = *reinterpret_cast<const uint32_t*>(&lo);
  v.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = v;
}

// grid: (m tiles, co tiles, splits); slice s covers the reduction terms
// [s*chunk, min(KD, (s+1)*chunk)).  Thread (ty, tx) owns rows m0 + ty + TY*i
// and channels c0 + (j/4)*4*TX + 4*tx + j%4.  A loads: slot tid + THREADS*i
// is row slot/4, terms 4*(slot%4) .. +3 of the stage.  B loads: slot
// tid + THREADS*i is filter row slot/(BN/4), channels 4*(slot%(BN/4)) .. +3.
// Two blocks resident per SM (<= 128 registers a thread at 256 threads) for
// the fp32 instances of the vector gather, which the serve and train paths
// run; the others stage operands through registers and keep the compiler's
// default of one block per SM (up to 255 registers, no spill).
template <bool VEC, typename TX, typename TW>
constexpr int min_blocks() {
  return VEC && std::is_same<TX, float>::value && std::is_same<TW, float>::value ? 2 : 1;
}

template <int BM, int BN, int TM, int TN, bool VEC, typename TX, typename TW, typename TO>
__global__ void __launch_bounds__((BM / TM) * (BN / TN), (min_blocks<VEC, TX, TW>()))
conv2d_tile_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                   const float* __restrict__ bias, float* __restrict__ part,
                   TO* __restrict__ out, int H, int W, int Cin, int K, int Cout, int OH, int OW,
                   int stride, int act, int M, int KD, int chunk, int w_vec, int o_vec) {
  constexpr int TX_ = BN / TN, TY = BM / TM;     // threads along co and along m
  constexpr int THREADS = TX_ * TY;
  constexpr int A_SLOTS = BM * (BK / 4) / THREADS;
  constexpr int B_SLOTS = BK * (BN / 4) / THREADS;
  static_assert(A_SLOTS >= 1 && B_SLOTS >= 1 && BM * (BK / 4) % THREADS == 0 &&
                    BK * (BN / 4) % THREADS == 0 && TN % 4 == 0,
                "tile shape");
  constexpr bool A_ASYNC = VEC && std::is_same<TX, float>::value;
  constexpr bool B_ASYNC = std::is_same<TW, float>::value;
  __shared__ __align__(16) float As[2][BM][KPAD];
  __shared__ __align__(16) float Bs[2][BK][BN];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int c0 = blockIdx.y * BN;
  const int k_begin = blockIdx.z * chunk;
  const int k_end = min(KD, k_begin + chunk);
  const int n_stages = (k_end - k_begin + BK - 1) / BK;
  const int quarter = tid % 4;      // this thread's 4 terms of an A stage: 4*quarter .. +3

  // each A slot's row: its base offset in x (divisions once per CTA), or -1 past M
  int a_base[A_SLOTS];
#pragma unroll
  for (int i = 0; i < A_SLOTS; ++i) {
    const int m = m0 + tid / 4 + (THREADS / 4) * i;
    const int p = OH * OW;
    const int n = m / p, r = m - n * p;
    const int oh = r / OW, ow = r - oh * OW;
    a_base[i] = m < M ? ((n * H + oh * stride) * W + ow * stride) * Cin : -1;
  }
  // each B slot's filter row within the stage and channel run
  const int b_row0 = tid / (BN / 4), b_col = 4 * (tid % (BN / 4));
  constexpr int B_ROW_STEP = THREADS / (BN / 4);
  const int co_b = c0 + b_col;

  // the vector gather's tap offset ((ki*W + kj)*Cin + ci0) of the next stage to fetch
  int ki = 0, kj = 0, ci0 = 0;
  if constexpr (VEC) {   // Cin > 0 here
    const int tap = k_begin / Cin;
    ci0 = k_begin - tap * Cin;
    ki = tap / K;
    kj = tap - ki * K;
  }

  float a_reg[A_SLOTS][4], b_reg[B_SLOTS][4];   // a stage in flight through registers

  // issue stage s's loads into buffer `buf` (cp.async) or registers
  auto fetch = [&](int s, int buf) {
    const int k0 = k_begin + s * BK;
    if constexpr (VEC) {
      const int off = (ki * W + kj) * Cin + ci0 + 4 * quarter;
#pragma unroll
      for (int i = 0; i < A_SLOTS; ++i) {
        const bool ok = a_base[i] >= 0;
        const TX* src = x + (ok ? a_base[i] + off : 0);
        if constexpr (A_ASYNC) {
          cp_async16(&As[buf][tid / 4 + (THREADS / 4) * i][4 * quarter], src, ok);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) a_reg[i][e] = ok ? to_f32(src[e]) : 0.f;
        }
      }
      ci0 += BK;                     // the next stage: the next 16 channels or the next tap
      if (ci0 == Cin) {
        ci0 = 0;
        if (++kj == K) {
          kj = 0;
          ++ki;
        }
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = k0 + 4 * quarter + e;
        const bool k_ok = k < k_end;
        const int tap = k_ok ? k / Cin : 0;
        const int ci = k_ok ? k - tap * Cin : 0;
        const int ti = tap / K, tj = tap - (tap / K) * K;
        const int off = (ti * W + tj) * Cin + ci;
#pragma unroll
        for (int i = 0; i < A_SLOTS; ++i)
          a_reg[i][e] = k_ok && a_base[i] >= 0 ? to_f32(x[a_base[i] + off]) : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < B_SLOTS; ++i) {
      const int r = b_row0 + B_ROW_STEP * i;
      const int k = k0 + r;
      const bool k_ok = k < k_end;
      const TW* src = w + (k_ok ? (long long)k * Cout + co_b : 0);
      if constexpr (B_ASYNC) {
        float* dst = &Bs[buf][r][b_col];
        if (w_vec) {
          cp_async16(dst, src, k_ok && co_b < Cout);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) cp_async4(dst + e, src + e, k_ok && co_b + e < Cout);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) b_reg[i][e] = k_ok && co_b + e < Cout ? to_f32(src[e]) : 0.f;
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
        *reinterpret_cast<float4*>(&Bs[buf][b_row0 + B_ROW_STEP * i][b_col]) =
            make_float4(b_reg[i][0], b_reg[i][1], b_reg[i][2], b_reg[i][3]);
    }
  };

  const int tx = tid % TX_, ty = tid / TX_;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  if (n_stages > 0) {
    fetch(0, 0);
    store(0);
  }
  cp_async_commit();
  for (int s = 0; s < n_stages; ++s) {
    const int cur = s & 1;
    if (s + 1 < n_stages) fetch(s + 1, cur ^ 1);
    cp_async_commit();
    cp_async_wait_one();         // stage s has landed (s+1 may be in flight)
    __syncthreads();
    // per 4 terms: 4 * TN / 4 float4s of B, then per row one float4 of A
#pragma unroll
    for (int k4 = 0; k4 < BK; k4 += 4) {
      float4 b[4][TN / 4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int jg = 0; jg < TN / 4; ++jg)
          b[kk][jg] = *reinterpret_cast<const float4*>(&Bs[cur][k4 + kk][jg * 4 * TX_ + 4 * tx]);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 a4 = *reinterpret_cast<const float4*>(&As[cur][ty + TY * i][k4]);
        const float a[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int jg = 0; jg < TN / 4; ++jg) {
            acc[i][4 * jg] = fmaf(a[kk], b[kk][jg].x, acc[i][4 * jg]);
            acc[i][4 * jg + 1] = fmaf(a[kk], b[kk][jg].y, acc[i][4 * jg + 1]);
            acc[i][4 * jg + 2] = fmaf(a[kk], b[kk][jg].z, acc[i][4 * jg + 2]);
            acc[i][4 * jg + 3] = fmaf(a[kk], b[kk][jg].w, acc[i][4 * jg + 3]);
          }
      }
    }
    if (s + 1 < n_stages) store(cur ^ 1);
    __syncthreads();
  }

  // epilogue: fp32 partial sums to the workspace, or bias + activation in the output type
  float* pout = part == nullptr ? nullptr : part + (long long)blockIdx.z * M * Cout;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + TY * i;
    if (m >= M) continue;
#pragma unroll
    for (int jg = 0; jg < TN / 4; ++jg) {
      const int co = c0 + jg * 4 * TX_ + 4 * tx;
      if (co >= Cout) continue;
      const long long e = (long long)m * Cout + co;
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        v[q] = acc[i][4 * jg + q];
        if (pout == nullptr) v[q] = activate(v[q] + (bias != nullptr && co + q < Cout ? bias[co + q] : 0.f), act);
      }
      if (o_vec) {
        if (pout != nullptr)
          store4(pout + e, v[0], v[1], v[2], v[3]);
        else
          store4(out + e, v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (co + q >= Cout) break;
          if (pout != nullptr)
            pout[e + q] = v[q];
          else
            out[e + q] = from_f32<TO>(v[q]);
        }
      }
    }
  }
}

// y[e] = act(sum over s of part[s][e] in slice order + bias[e % Cout]), cast
// to the output type; V4: four consecutive elements of one row a thread
// (Cout % 4 == 0), else one
template <typename TO, bool V4>
__global__ void __launch_bounds__(256)
conv2d_tile_reduce_kernel(const float* __restrict__ part, const float* __restrict__ bias,
                          TO* __restrict__ out, int splits, long long total, int Cout, int act) {
  const long long e = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * (V4 ? 4 : 1);
  if (e >= total) return;
  const int co = static_cast<int>(e % Cout);
  if constexpr (V4) {
    float4 t = *reinterpret_cast<const float4*>(part + e);
    for (int s = 1; s < splits; ++s) {
      const float4 v = *reinterpret_cast<const float4*>(part + (long long)s * total + e);
      t.x += v.x;
      t.y += v.y;
      t.z += v.z;
      t.w += v.w;
    }
    if (bias != nullptr) {
      t.x += bias[co];
      t.y += bias[co + 1];
      t.z += bias[co + 2];
      t.w += bias[co + 3];
    }
    store4(out + e, activate(t.x, act), activate(t.y, act), activate(t.z, act),
           activate(t.w, act));
  } else {
    float t = part[e];
    for (int s = 1; s < splits; ++s) t += part[(long long)s * total + e];
    if (bias != nullptr) t += bias[co];
    out[e] = from_f32<TO>(activate(t, act));
  }
}

template <int BM, int BN, int TM, int TN, typename TX, typename TW, typename TO>
void launch_partial(const void* x, const void* w, const float* bias, float* part, void* out,
                    int N, int H, int W, int Cin, int K, int Cout, int OH, int OW, int stride,
                    int act, int splits, int chunk, int vec, cudaStream_t stream) {
  const int M = N * OH * OW;
  const dim3 grid((M + BM - 1) / BM, (Cout + BN - 1) / BN, splits);
  const int threads = (BM / TM) * (BN / TN);
  // 16-byte B copies and output stores: rows of Cout elements on aligned bases
  const int w_vec = Cout % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const void* dst = part != nullptr ? static_cast<const void*>(part) : out;
  const int o_vec = Cout % 4 == 0 && reinterpret_cast<uintptr_t>(dst) % 16 == 0;
  if (vec) {
    conv2d_tile_kernel<BM, BN, TM, TN, true, TX, TW, TO><<<grid, threads, 0, stream>>>(
        static_cast<const TX*>(x), static_cast<const TW*>(w), bias, part, static_cast<TO*>(out),
        H, W, Cin, K, Cout, OH, OW, stride, act, M, K * K * Cin, chunk, w_vec, o_vec);
  } else {
    conv2d_tile_kernel<BM, BN, TM, TN, false, TX, TW, TO><<<grid, threads, 0, stream>>>(
        static_cast<const TX*>(x), static_cast<const TW*>(w), bias, part, static_cast<TO*>(out),
        H, W, Cin, K, Cout, OH, OW, stride, act, M, K * K * Cin, chunk, w_vec, o_vec);
  }
}

// tile: 0 = 128 x 32 (8 x 4 per thread), 1 = 128 x 64 (8 x 4), 2 = 128 x 128 (8 x 8)
template <typename TX, typename TW, typename TO>
cudaError_t launch_typed(int tile, const void* x, const void* w, const float* bias, void* part,
                         void* out, int N, int H, int W, int Cin, int K, int Cout, int OH, int OW,
                         int stride, int act, int splits, int chunk, int vec, cudaStream_t s) {
  float* p = splits > 1 ? static_cast<float*>(part) : nullptr;
  if (tile == 0)
    launch_partial<128, 32, 8, 4, TX, TW, TO>(x, w, bias, p, out, N, H, W, Cin, K, Cout, OH, OW,
                                              stride, act, splits, chunk, vec, s);
  else if (tile == 1)
    launch_partial<128, 64, 8, 4, TX, TW, TO>(x, w, bias, p, out, N, H, W, Cin, K, Cout, OH, OW,
                                              stride, act, splits, chunk, vec, s);
  else
    launch_partial<128, 128, 8, 8, TX, TW, TO>(x, w, bias, p, out, N, H, W, Cin, K, Cout, OH,
                                               OW, stride, act, splits, chunk, vec, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long total = (long long)N * OH * OW * Cout;
  TO* o = static_cast<TO*>(out);
  if (Cout % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0) {
    conv2d_tile_reduce_kernel<TO, true><<<static_cast<unsigned>((total / 4 + 255) / 256), 256, 0,
                                          s>>>(p, bias, o, splits, total, Cout, act);
  } else {
    conv2d_tile_reduce_kernel<TO, false><<<static_cast<unsigned>((total + 255) / 256), 256, 0,
                                           s>>>(p, bias, o, splits, total, Cout, act);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the partial kernel and, where splits > 1, the reduce on
// ``stream``; returns the first cudaError_t (0 on success).  ``bias`` is fp32
// (Cout,) or null; ``part`` fp32 workspace of splits * N*OH*OW * Cout floats
// (unused when splits == 1); ``chunk`` the reduction terms per slice (a
// multiple of 16); ``vec`` selects the vector gather (Cin a multiple of 16,
// x 16-byte aligned); x_bf16 / w_bf16 select bf16 (1) or fp32 (0) operands -
// the output is fp32 unless both are bf16; ``tile`` the partial kernel's
// tile (see launch_typed).
int conv2d_tile_launch(const void* x, const void* w, const void* bias, void* part, void* out,
                       int N, int H, int W, int Cin, int K, int Cout, int OH, int OW, int stride,
                       int act, int splits, int chunk, int vec, int x_bf16, int w_bf16, int tile,
                       void* stream) {
  if (tile < 0 || tile > 2 || splits < 1 || chunk < BK || chunk % BK != 0 ||
      (vec && (Cin % BK != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0)) ||
      (splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!x_bf16 && !w_bf16)
    return static_cast<int>(launch_typed<float, float, float>(
        tile, x, w, b, part, out, N, H, W, Cin, K, Cout, OH, OW, stride, act, splits, chunk, vec,
        s));
  if (x_bf16 && !w_bf16)
    return static_cast<int>(launch_typed<__nv_bfloat16, float, float>(
        tile, x, w, b, part, out, N, H, W, Cin, K, Cout, OH, OW, stride, act, splits, chunk, vec,
        s));
  if (!x_bf16 && w_bf16)
    return static_cast<int>(launch_typed<float, __nv_bfloat16, float>(
        tile, x, w, b, part, out, N, H, W, Cin, K, Cout, OH, OW, stride, act, splits, chunk, vec,
        s));
  return static_cast<int>(launch_typed<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16>(
      tile, x, w, b, part, out, N, H, W, Cin, K, Cout, OH, OW, stride, act, splits, chunk, vec,
      s));
}

const char* conv2d_tile_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
