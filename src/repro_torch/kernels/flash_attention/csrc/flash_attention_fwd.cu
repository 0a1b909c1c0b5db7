// FlashAttention forward: causal / sliding-window / GQA, online softmax in fp32.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention/kernel.py
// (flash_attention_fwd / _fa_kernel): the same function - s = (q*scale)·kᵀ in
// fp32 with q*scale rounded to q's type first (kernel.py:62), masking with the
// finite sentinel -1e30 (kernel.py:54,75) and m starting at it, key and query
// positions both from 0 (so Tq != Tk aligns causality at the start), keys past
// Tk masked, acc / max(l, 1e-30) (kernel.py:91), output in q's type.
//
// The TPU grid walks the KV blocks in order on one core and carries the
// running (m, l, acc) in VMEM scratch across grid steps.  Here the KV walk is
// a loop inside the CTA and the running state lives in registers; KV head =
// head / (Hq / Hkv).  KV tiles wholly above the causal diagonal or wholly
// outside the window are skipped: every row of the query tile then sees at
// least one real key before or inside the tiles that are walked, and a masked
// tile met first (p = exp(0) = 1) is wiped by alpha = exp(-1e30 - m) = 0 once
// a real key arrives, as in the TPU kernel.
//
// Two instances, chosen by the wrapper from the dtype and head dim alone
// (kernel.py:fa_instance) and passed in as `instance`:
//
// * simt_fp32_dh{64,128} - fp32 operands.  One CTA per (64 query rows, head,
//   batch).  Per KV tile of 64 keys, K and V are staged in shared memory
//   (K transposed, so a thread's 4 keys are one float4), the 64x64 score tile
//   is computed by 256 threads, each a 4x4 register block (fp32 FFMA over
//   Dh), the row max / sum are reduced over the 16 threads that share a row
//   with warp shuffles, p is written to shared memory (transposed), and each
//   thread accumulates a 4 x (DH/16) block of p·v in registers.  Head dims up
//   to 64 use DH=64, up to 128 DH=128 (tail columns zero-filled).  Shared
//   memory at DH=128: 120 KB, dynamic; one CTA per SM.  Bound: fp32 FFMA on
//   CUDA cores (67 TFLOP/s): 4·B·Hq·Dh per unmasked (query, key) pair.
//
// * wgmma_bf16_dh{64,128} - bf16 operands, on Hopper's tensor cores.  One CTA
//   per (128 query rows, head, batch), the query tiles walked longest-first
//   (the grid's slowest index runs from the last tile down).  Three
//   warpgroups: a producer that issues TMA loads (Q once; K and V through a
//   2-stage ring of 128-key tiles, each signalled on its own mbarrier) and
//   gives its registers to two consumer warpgroups (setmaxnreg 24 / 240) of
//   64 query rows each.  TMA sees q, k, v as 4-d (Dh, H, T, B) tensors, with
//   64-element (128-byte) boxes in the 128-byte swizzle, so a Dh-128 row is
//   two panels; out-of-bounds rows and columns (ragged T, head dims under
//   the instance's width) arrive as zeros.  A consumer scales its Q rows in
//   place (q*scale rounded to bf16, as the reference), then per half of a
//   stage (64 keys: S and P of a half fit in registers beside O unspilled):
//     S = Q·Kᵀ     wgmma m64n64k16, both operands K-major in shared memory,
//                  fp32 accumulators (bf16 x bf16 products are exact in fp32,
//                  so S is the reference's S up to the order of summation);
//     mask         only on halves that cross the diagonal, the window edge
//                  or Tk (a separate branch; interior halves take none);
//                  halves wholly past Tk or above the diagonal for all 64
//                  rows are skipped;
//     softmax      online, on the accumulator fragment: a row's max over the
//                  4 threads of a quad, m / l / alpha in fp32;
//     O += P·V     P split in registers into two bf16 terms, p = hi + lo
//                  (16 significant bits; one bf16 term alone, as FA2/FA3
//                  round P, left rows with few keys close to the bf16 bar
//                  against the fp32 reference), each wgmma's register A operand; V
//                  stays in shared memory as an MN-major B operand (the
//                  transpose bit), m64n{DH}k16, two products per 16 keys.
//   The output is stored from registers (rows >= Tq and columns >= dh
//   masked).  Shared memory at DH=128: Q 32 KB + 2 x (K 32 KB + V 32 KB) =
//   160 KB.  Bound: bf16 tensor cores (989 TFLOP/s) for the LM shapes.
//   A wait on an mbarrier that has not completed after ~10 s traps (a launch
//   error) rather than hanging the card.
#include <cuda.h>            // CUtensorMap and its enums (types only; libcuda via dlsym)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <cstdio>

#include "../../csrc/hopper.cuh"   // mbarrier, TMA and wgmma helpers (shared with B5)

namespace {

constexpr float NEG_INF = -1e30f;

// ---------------------------------------------------------------------------
// simt_fp32: fp32 FFMA on CUDA cores
// ---------------------------------------------------------------------------
namespace simt {

constexpr int BQ = 64;         // query rows per CTA
constexpr int BK = 64;         // keys per KV tile
constexpr int THREADS = 256;   // 16 x 16: ty owns 4 rows, tx 4 score columns
constexpr int PAD = 4;         // keeps float4 alignment, spreads transposed stores

template <int DH>
constexpr int smem_floats() {
  return DH * (BQ + PAD) + DH * (BK + PAD) + BK * DH + BK * (BQ + PAD);
}

template <int DH>
__global__ void __launch_bounds__(THREADS)
flash_attention_fwd_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ out,
                           int Tq, int Tk, int Hq, int Hkv, int dh, float scale,
                           int causal, int window) {
  constexpr int NC = DH / 16;              // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                        // [DH][BQ + PAD]  (q*scale, transposed)
  float* Ks = Qs + DH * (BQ + PAD);        // [DH][BK + PAD]  (transposed)
  float* Vs = Ks + DH * (BK + PAD);        // [BK][DH]
  float* Ps = Vs + BK * DH;                // [BK][BQ + PAD]  (p, transposed)

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const long long q_row_stride = (long long)Hq * dh;
  const long long k_row_stride = (long long)Hkv * dh;
  const float* qb = q + (long long)b * Tq * q_row_stride + (long long)h * dh;
  const float* kb = k + (long long)b * Tk * k_row_stride + (long long)hk * dh;
  const float* vb = v + (long long)b * Tk * k_row_stride + (long long)hk * dh;

  for (int i = tid; i < BQ * DH; i += THREADS) {
    const int r = i / DH, d = i % DH;
    float val = 0.f;
    if (q0 + r < Tq && d < dh) val = qb[(q0 + r) * q_row_stride + d] * scale;
    Qs[d * (BQ + PAD) + r] = val;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  // KV tiles to walk: skip those wholly above the diagonal / outside the window
  int k_end = Tk;
  if (causal) k_end = min(k_end, q0 + BQ);            // keys <= last query row
  int k_begin = 0;
  if (window > 0) {
    const int first = q0 - window + 1;                // first key the first row sees
    if (first > 0) k_begin = (first / BK) * BK;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();   // previous tile's Ks / Vs / Ps are consumed (and Qs is written)
    for (int i = tid; i < BK * DH; i += THREADS) {
      const int r = i / DH, d = i % DH;
      float kv = 0.f, vv = 0.f;
      if (k0 + r < Tk && d < dh) {
        kv = kb[(k0 + r) * k_row_stride + d];
        vv = vb[(k0 + r) * k_row_stride + d];
      }
      Ks[d * (BK + PAD) + r] = kv;
      Vs[r * DH + d] = vv;
    }
    __syncthreads();

    // s = (q*scale) · kᵀ : rows ty*4+i, keys tx*4+j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&Qs[d * (BQ + PAD) + ty * 4]);
      const float4 c = *reinterpret_cast<const float4*>(&Ks[d * (BK + PAD) + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

    // mask, online softmax update (16 threads share each row)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx * 4 + j;
        bool ok = kp < Tk;
        if (causal) ok = ok && qp >= kp;
        if (window > 0) ok = ok && qp - kp < window;
        if (!ok) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        Ps[(tx * 4 + j) * (BQ + PAD) + ty * 4 + i] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc += p · v : rows ty*4+i, columns tx*4 + 64*g + e
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float4 p4 = *reinterpret_cast<const float4*>(&Ps[kk * (BQ + PAD) + ty * 4]);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int g = 0; g < NC / 4; ++g) {
        const float4 v4 = *reinterpret_cast<const float4*>(&Vs[kk * DH + g * 64 + tx * 4]);
        const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][g * 4 + e] = fmaf(pv[i], vv[e], acc[i][g * 4 + e]);
      }
    }
  }

  float* ob = out + (long long)b * Tq * q_row_stride + (long long)h * dh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= Tq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int g = 0; g < NC / 4; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = g * 64 + tx * 4 + e;
        if (d < dh) ob[r * q_row_stride + d] = acc[i][g * 4 + e] / denom;
      }
  }
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int Tq,
                   int Tk, int Hq, int Hkv, int dh, float scale, int causal, int window,
                   cudaStream_t stream) {
  constexpr int bytes = smem_floats<DH>() * (int)sizeof(float);
  auto kern = flash_attention_fwd_simt_kernel<DH>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + BQ - 1) / BQ, Hq, B);
  kern<<<grid, THREADS, bytes, stream>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                         static_cast<const float*>(v), static_cast<float*>(out), Tq,
                                         Tk, Hq, Hkv, dh, scale, causal, window);
  return cudaGetLastError();
}

}  // namespace simt

// ---------------------------------------------------------------------------
// wgmma_bf16: TMA + wgmma on the tensor cores, warp-specialised
// ---------------------------------------------------------------------------
namespace tc {

using namespace hopper;

constexpr int BQ = 128;          // query rows per CTA: two consumer warpgroups x 64
constexpr int BK = 128;          // keys per KV stage
constexpr int STAGES = 2;        // K/V ring depth
constexpr int PANEL = 64;        // bf16 per 128-byte swizzled row (one TMA box row)
constexpr int THREADS = 384;     // producer warpgroup + 2 consumer warpgroups
constexpr float LOG2E = 1.4426950408889634f;

template <int DH>
struct Smem {
  static constexpr int NP = DH / PANEL;                       // panels per row
  __nv_bfloat16 q[NP][BQ * PANEL];                            // 1024-byte aligned base
  __nv_bfloat16 k[STAGES][NP][BK * PANEL];
  __nv_bfloat16 v[STAGES][NP][BK * PANEL];
  uint64_t q_full;
  uint64_t k_full[STAGES];
  uint64_t v_full[STAGES];
  uint64_t empty[STAGES];
};

template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                                 const __grid_constant__ CUtensorMap kmap,
                                 const __grid_constant__ CUtensorMap vmap,
                                 __nv_bfloat16* __restrict__ out, int Tq, int Tk, int Hq, int Hkv,
                                 int dh, float scale, int causal, int window) {
  using S = Smem<DH>;
  constexpr int NP = S::NP;
  constexpr int BOX_BYTES = BK * PANEL * 2;        // one 128-row x 64-column box
  static_assert(BQ == BK, "Q and K/V share one TMA box shape");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  const uint32_t pad = (1024u - (smem_u32(smem_raw) & 1023u)) & 1023u;
  S& sm = *reinterpret_cast<S*>(smem_raw + pad);

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;    // longest causal rows first
  const int hk = h / (Hq / Hkv);

  // KV tiles to walk: skip those wholly above the diagonal / outside the window
  int k_end = Tk;
  if (causal) k_end = min(k_end, min(q0 + BQ, Tq));
  int k_begin = 0;
  if (window > 0) {
    const int first = q0 - window + 1;
    if (first > 0) k_begin = (first / BK) * BK;
  }
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.empty[s], 2 * 128);    // every consumer thread releases the stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues every TMA load --------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(&sm.q_full, NP * BOX_BYTES);
      for (int p = 0; p < NP; ++p) tma_load_4d(sm.q[p], &qmap, &sm.q_full, p * PANEL, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(&sm.empty[s], ((i / STAGES) - 1) & 1);
        const int k0 = k_begin + i * BK;
        mbar_expect_tx(&sm.k_full[s], NP * BOX_BYTES);
        for (int p = 0; p < NP; ++p)
          tma_load_4d(sm.k[s][p], &kmap, &sm.k_full[s], p * PANEL, hk, k0, b);
        mbar_expect_tx(&sm.v_full[s], NP * BOX_BYTES);
        for (int p = 0; p < NP; ++p)
          tma_load_4d(sm.v[s][p], &vmap, &sm.v_full[s], p * PANEL, hk, k0, b);
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = wg - 1;
    const int lt = threadIdx.x % 128;
    const int warp = lt / 32, lane = lt % 32;
    const int g = lane / 4, t = lane % 4;
    const int row_lo = q0 + cw * 64;              // this warpgroup's rows
    const int row_hi = row_lo + 63;
    const int qa = row_lo + warp * 16 + g;        // the thread's two rows
    const int qb = qa + 8;

    // q*scale rounded to bf16, in place, on this warpgroup's rows
    mbar_wait(&sm.q_full, 0);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      uint4* rows = reinterpret_cast<uint4*>(sm.q[p] + cw * 64 * PANEL);
      for (int i = lt; i < 64 * PANEL / 8; i += 128) {
        uint4 w = rows[i];
        uint32_t* u = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[e]));
          u[e] = pack_bf16(f.x * scale, f.y * scale);
        }
        rows[i] = w;
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // generic writes -> wgmma
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");

    // descriptor low words: Q rows of this warpgroup, stage 0 of K (K-major,
    // leading byte offset unused) and of V (MN-major, leading byte offset =
    // one panel: the next 64 columns of Dh)
    constexpr uint32_t PANEL_UNITS = BK * PANEL * 2 / 16;       // one panel, 16-byte units
    constexpr uint32_t STAGE_UNITS = NP * PANEL_UNITS;          // one K or V stage
    const uint32_t q_lo = desc_lo(sm.q[0] + cw * 64 * PANEL, 16);
    const uint32_t k_lo0 = desc_lo(sm.k[0][0], 16);
    const uint32_t v_lo0 = desc_lo(sm.v[0][0], BK * PANEL * 2);

    float o[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
    float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;   // l: this thread's share

    // Each 128-key stage is taken as two halves of BH = 64 keys, each its own
    // online-softmax step: S and P of a half need 32 registers each, which
    // leaves room for O and both bf16 terms of P without a spill.
    constexpr int BH = 64;
    constexpr uint32_t HALF_UNITS = BH * PANEL * 2 / 16;         // 64 rows of 128 bytes
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % STAGES;
      const uint32_t parity = (i / STAGES) & 1;
      const uint32_t k_lo = k_lo0 + s * STAGE_UNITS, v_lo = v_lo0 + s * STAGE_UNITS;
      mbar_wait(&sm.k_full[s], parity);
      bool v_ready = false;
#pragma unroll
      for (int half = 0; half < BK / BH; ++half) {
        const int k0 = k_begin + i * BK + half * BH;
        // keys wholly past Tk, or causally past every row of this warpgroup,
        // add nothing (every row has met a real key in an earlier half)
        if (k0 >= Tk || (causal && k0 > row_hi)) continue;

        // S = (q*scale) · kᵀ for these 64 keys
        float sc[BH / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) {   // 16 columns of Dh: 32 bytes; 4 per panel
          const uint32_t step = (kk / 4) * PANEL_UNITS + (kk % 4) * 2;
          wgmma_ss_n64(sc, desc(q_lo + step), desc(k_lo + half * HALF_UNITS + step), kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs<BH / 2>(sc);

        // the mask, only on halves that cross Tk, the diagonal or the window edge
        const bool ragged = k0 + BH > Tk;
        const bool diag = causal && k0 + BH - 1 > row_lo;
        const bool edge = window > 0 && k0 <= row_hi - window;
        if (ragged || diag || edge) {
#pragma unroll
          for (int j = 0; j < BH / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int kp = k0 + 8 * j + 2 * t + e;
              bool ok_a = kp < Tk, ok_b = kp < Tk;
              if (causal) {
                ok_a = ok_a && qa >= kp;
                ok_b = ok_b && qb >= kp;
              }
              if (window > 0) {
                ok_a = ok_a && qa - kp < window;
                ok_b = ok_b && qb - kp < window;
              }
              if (!ok_a) sc[4 * j + e] = NEG_INF;
              if (!ok_b) sc[4 * j + 2 + e] = NEG_INF;
            }
        }

        // online softmax on the fragment: rows qa (sc[4j], sc[4j+1]) and qb
        float mx_a = NEG_INF, mx_b = NEG_INF;
#pragma unroll
        for (int j = 0; j < BH / 8; ++j) {
          mx_a = fmaxf(mx_a, fmaxf(sc[4 * j], sc[4 * j + 1]));
          mx_b = fmaxf(mx_b, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
          mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
        }
        const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
        const float alpha_a = exp2f((m_a - mn_a) * LOG2E);
        const float alpha_b = exp2f((m_b - mn_b) * LOG2E);
        m_a = mn_a;
        m_b = mn_b;
        // p as two bf16 terms, p = hi + lo (16 significant bits): the A
        // fragments of P·V for keys 16kk..16kk+15 are accumulator chunks 2kk
        // and 2kk+1 of S, register for register
        uint32_t p_hi[BH / 16][4], p_lo[BH / 16][4];
        float rs_a = 0.f, rs_b = 0.f;
#pragma unroll
        for (int j = 0; j < BH / 8; ++j) {
          const float pa0 = exp2f((sc[4 * j] - mn_a) * LOG2E);
          const float pa1 = exp2f((sc[4 * j + 1] - mn_a) * LOG2E);
          const float pb0 = exp2f((sc[4 * j + 2] - mn_b) * LOG2E);
          const float pb1 = exp2f((sc[4 * j + 3] - mn_b) * LOG2E);
          rs_a += pa0 + pa1;
          rs_b += pb0 + pb1;
          const uint32_t ha = pack_bf16(pa0, pa1), hb = pack_bf16(pb0, pb1);
          const float2 fa = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ha));
          const float2 fb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hb));
          p_hi[j / 2][(j % 2) * 2] = ha;
          p_hi[j / 2][(j % 2) * 2 + 1] = hb;
          p_lo[j / 2][(j % 2) * 2] = pack_bf16(pa0 - fa.x, pa1 - fa.y);
          p_lo[j / 2][(j % 2) * 2 + 1] = pack_bf16(pb0 - fb.x, pb1 - fb.y);
        }
        l_a = l_a * alpha_a + rs_a;
        l_b = l_b * alpha_b + rs_b;
#pragma unroll
        for (int j = 0; j < DH / 8; ++j) {
          o[4 * j] *= alpha_a;
          o[4 * j + 1] *= alpha_a;
          o[4 * j + 2] *= alpha_b;
          o[4 * j + 3] *= alpha_b;
        }

        // O += P · V
        if (!v_ready) {
          mbar_wait(&sm.v_full[s], parity);
          v_ready = true;
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BH / 16; ++kk) {   // 16 keys: 16 rows of 128 bytes
          const uint64_t dv = desc(v_lo + half * HALF_UNITS + kk * 16 * PANEL * 2 / 16);
          if constexpr (DH == 128) {
            wgmma_rs_n128(o, p_lo[kk], dv);
            wgmma_rs_n128(o, p_hi[kk], dv);
          } else {
            wgmma_rs_n64(o, p_lo[kk], dv);
            wgmma_rs_n64(o, p_hi[kk], dv);
          }
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs<DH / 2>(o);
      }
      // the stage's V has landed before it is released (TMA writes must not
      // overlap the next round's loads into it)
      if (!v_ready) mbar_wait(&sm.v_full[s], parity);
      mbar_arrive(&sm.empty[s]);
    }

    // out = acc / max(l, 1e-30), rows < Tq and columns < dh
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
    }
    const float inv_a = 1.f / fmaxf(l_a, 1e-30f), inv_b = 1.f / fmaxf(l_b, 1e-30f);
    const long long row_stride = (long long)Hq * dh;
    __nv_bfloat16* ob = out + (long long)b * Tq * row_stride + (long long)h * dh;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      const int col = 8 * j + 2 * t;
      if (col >= dh) continue;
      if (qa < Tq)
        *reinterpret_cast<uint32_t*>(ob + qa * row_stride + col) =
            pack_bf16(o[4 * j] * inv_a, o[4 * j + 1] * inv_a);
      if (qb < Tq)
        *reinterpret_cast<uint32_t*>(ob + qb * row_stride + col) =
            pack_bf16(o[4 * j + 2] * inv_b, o[4 * j + 3] * inv_b);
    }
  }
}

// (B, T, H, dh) bf16 as the 4-d tensor (dh, H, T, B), boxes of 64 x 1 x 128 x 1
CUresult make_map(EncodeTiled encode, CUtensorMap* map, const void* base, int B, int T, int H,
                  int dh) {
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)H, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)dh * 2, (cuuint64_t)H * dh * 2,
                                 (cuuint64_t)T * H * dh * 2};
  const cuuint32_t box[4] = {PANEL, 1, BK, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Tq, int Tk, int Hq,
           int Hkv, int dh, float scale, int causal, int window, cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return ERR_BASE;
  CUtensorMap qm, km, vm;
  CUresult r = make_map(encode, &qm, q, B, Tq, Hq, dh);
  if (r == CUDA_SUCCESS) r = make_map(encode, &km, k, B, Tk, Hkv, dh);
  if (r == CUDA_SUCCESS) r = make_map(encode, &vm, v, B, Tk, Hkv, dh);
  if (r != CUDA_SUCCESS) return ERR_BASE + static_cast<int>(r);
  constexpr int bytes = sizeof(Smem<DH>) + 1024;   // + the 1024-byte alignment pad
  auto kern = flash_attention_fwd_wgmma_kernel<DH>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(Hq, B, (Tq + BQ - 1) / BQ);
  kern<<<grid, THREADS, bytes, stream>>>(qm, km, vm, static_cast<__nv_bfloat16*>(out), Tq, Tk, Hq,
                                         Hkv, dh, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

extern "C" {

// q: (B, Tq, Hq, dh), k/v: (B, Tk, Hkv, dh), out: (B, Tq, Hq, dh), all
// contiguous and of one type; Hq a multiple of Hkv; window <= 0 means none;
// scale already rounded to q's type.  `instance`: 0 simt_fp32_dh64, 1
// simt_fp32_dh128 (fp32, dh <= 64 / 128), 2 wgmma_bf16_dh64, 3
// wgmma_bf16_dh128 (bf16, dh a multiple of 8, 16-byte aligned bases).
// Returns a cudaError_t, or a code past it (see *_error_string).
int flash_attention_fwd_launch(const void* q, const void* k, const void* v, void* out, int B,
                               int Tq, int Tk, int Hq, int Hkv, int dh, float scale, int causal,
                               int window, int instance, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (instance) {
    case 0:
      return simt::launch<64>(q, k, v, out, B, Tq, Tk, Hq, Hkv, dh, scale, causal, window, st);
    case 1:
      return simt::launch<128>(q, k, v, out, B, Tq, Tk, Hq, Hkv, dh, scale, causal, window, st);
    case 2:
      return tc::launch<64>(q, k, v, out, B, Tq, Tk, Hq, Hkv, dh, scale, causal, window, st);
    case 3:
      return tc::launch<128>(q, k, v, out, B, Tq, Tk, Hq, Hkv, dh, scale, causal, window, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* flash_attention_fwd_error_string(int err) {
  static thread_local char buf[96];
  if (err == tc::ERR_BASE) return "cuTensorMapEncodeTiled not found in libcuda.so.1";
  if (err > tc::ERR_BASE) {
    snprintf(buf, sizeof(buf), "cuTensorMapEncodeTiled failed with CUresult %d",
             err - tc::ERR_BASE);
    return buf;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
