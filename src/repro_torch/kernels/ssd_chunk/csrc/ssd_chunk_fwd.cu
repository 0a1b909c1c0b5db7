// Mamba2 SSD intra-chunk forward: per (batch, chunk, head)
//   cum     = cumsum(dt·A)                                (inclusive, fp32)
//   y_intra = Σ_{j<=i} (C_i·B_j) · exp(cum_i − cum_j) · dt_j · x_j
//   S       = Σ_j exp(cum_Q − cum_j) · dt_j · B_j ⊗ x_j     (the chunk's state)
//   decay   = exp(cum_Q),  pref = exp(cum)
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_chunk/kernel.py
// (ssd_chunk_fwd / _ssd_kernel), which holds one (chunk, head) in VMEM per
// grid step and forms the Q x Q matrix M whole.  The intra-chunk output is
// causal attention with a decay in place of the softmax: C the queries, B
// the keys, x the values, the weight exp(cum_i − cum_j)·dt_j, no running max
// and no normaliser.  Head h reads group h / (H/G).  Two instances, chosen
// by the wrapper from the types and shapes alone (kernel.py:ssd_instance)
// and passed in as `instance`:
//
// * simt_fp32 - every type mix; fp32 FFMA on CUDA cores.  One CTA per (64
//   rows of a chunk, head, batch x chunk), 64-key tiles j <= i staged in
//   shared memory as fp32 (C and B transposed, so a thread's 4 rows or keys
//   are one float4), 256 threads each computing a 4x4 block of C·B over N,
//   the decay and dt applied in registers and the product p written to
//   shared memory, then a 4 x (P/16) block of p·x accumulated in registers.
//   Key tiles above the diagonal are skipped; inside the diagonal tile, and
//   past the chunk's end when Q is not a multiple of 64, entries are
//   selected to 0, never multiplied by a mask, so exp of a positive exponent
//   is never formed.  One more CTA per (chunk, head, batch) - blockIdx.x ==
//   Q/64 rounded up - sums the state S over all Q positions in a fixed order
//   (no atomics: the same bits every run) and writes decay.  Thread 0 sums
//   the log-decay prefix.  Shared memory 105 KB at Q = 256, so two CTAs fit
//   on an SM.  Bound: fp32 operations on CUDA cores (67 TFLOP/s).
//
// * wgmma_bf16 - bf16 x, B and C (the Mamba2 path), on Hopper's tensor
//   cores.  C·Bᵀ does not depend on the head, so it is computed once per
//   slab of heads of one group (kernel.py:ssd_slab) and reused for every
//   head of the slab.  CTA roles per (batch x chunk, group, slab):
//     row CTAs   128 rows of the chunk each, two warpgroups of 64 rows.  A
//                warpgroup computes S = C·Bᵀ for its rows and every 64-key
//                tile at or below its diagonal with wgmma m64n64k16 (both
//                operands K-major in shared memory, 128-byte swizzle, fp32
//                accumulators: bf16 x bf16 products are exact in fp32) and
//                keeps all of them in registers (up to 4 x 32 floats).  Then
//                per head: M_ij = S_ij·exp(cum_i − cum_j)·dt_j on the
//                accumulator fragment (selected to 0 above the diagonal and
//                past Q: the exponent is masked, ROADMAP C.1), M split into
//                three bf16 terms hi + mid + lo (24 significant bits: M to
//                fp32's precision, up to underflow of tiny terms), and y +=
//                M·x_h as three wgmma m64n64k16 per 16 keys, M the register A
//                operand and x_h's key tile an MN-major B operand in shared
//                memory.  y leaves in 16-byte stores (lanes t, t^1 swap
//                halves of their fragment rows).
//     state CTA  S_h = Bᵀ·diag(w_h)·x_h, w_j = exp(cum_Q − cum_j)·dt_j, as
//                its transpose (P x N) = (w∘x_h)ᵀ·B: warpgroup wg takes B's
//                columns 64wg .. 64wg + 63.  The A operand (w∘x_h)ᵀ comes
//                from x_h's key tile by ldmatrix.trans, is scaled by w_j in
//                fp32 and split in three bf16 terms as M is; B's key tiles
//                are the MN-major B operand.  The 64 x 64 result goes
//                through shared memory (XOR-swizzled, free of bank
//                conflicts) to 16-byte stores; the state CTA writes decay.
//   TMA loads C (once), B (once) and x (a 4-stage ring of 64-key tiles,
//   each signalled on its own mbarrier and released by all 8 warps)
//   through 4-d views (columns, group or head, position in the chunk, batch
//   x chunk), so rows past Q - and columns past N or P - arrive as zeros.
//   Thread 0 issues every load; the ring walks (head, key tile) in order.
//   The log-decay prefix is the same sequential fp32 adds as simt_fp32,
//   one lane per head of the slab, so cum, pref and decay equal the plain
//   version's bit for bit.  Every sum's order is fixed by the shape: a rerun
//   gives the same bits.  Shared memory: C 32 KB + B 64 KB + x 32 KB + the
//   slab's cum and dt (8 bytes per head and position: 96 KB at 48 heads x
//   Q 256), one CTA per SM.  Bound: bytes on HBM at the Mamba2 shape
//   (x, B, C, dt in; y, S, pref out).
//
// Rounding follows the plain version (ref.py): dt·A is rounded to fp32 and
// summed in order, one add at a time, as torch.cumsum does along a
// non-innermost dim on the card (__fmul_rn / __fadd_rn keep nvcc from
// fusing them into an FMA); cum_i − cum_j is an fp32 difference, then expf;
// (C·B)·decay·dt in that order; w = exp(cum_Q − cum_j)·dt, then w·B
// (simt_fp32) or w·x (wgmma_bf16), then the sum with the other factor.
#include <cuda.h>            // CUtensorMap and its enums (types only; libcuda via dlsym)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <cstdio>

#include "../../csrc/hopper.cuh"   // mbarrier, TMA and wgmma helpers (shared with B4)

namespace {

// ---------------------------------------------------------------------------
// simt_fp32: fp32 FFMA on CUDA cores
// ---------------------------------------------------------------------------
namespace simt {

constexpr int BQ = 64;          // rows per CTA
constexpr int BK = 64;          // keys per tile
constexpr int THREADS = 256;    // 16 x 16: ty owns 4 rows, tx 4 keys / 4 columns
constexpr int NMAX = 128;       // d_state (N); smaller N is zero-filled
constexpr int PMAX = 64;        // head dim (P); smaller P is zero-filled
constexpr int PAD = 4;          // keeps float4 alignment, spreads transposed stores

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__host__ __device__ constexpr int tile_floats() {
  // query CTA: Cs [NMAX][BQ+PAD], Bs [NMAX][BK+PAD], Xs [BK][PMAX], Ps [BK][BQ+PAD];
  // the state CTA reuses the same area as WBs [BK][NMAX], Xs [BK][PMAX]
  return NMAX * (BQ + PAD) + NMAX * (BK + PAD) + BK * PMAX + BK * (BQ + PAD);
}

__host__ __device__ constexpr int round4(int v) { return (v + 3) / 4 * 4; }

template <typename TX, typename TB>
__global__ void __launch_bounds__(THREADS)
ssd_chunk_fwd_simt_kernel(const TX* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const TB* __restrict__ Bm,
                     const TB* __restrict__ Cm, float* __restrict__ y, float* __restrict__ S,
                     float* __restrict__ decay, float* __restrict__ pref,
                     int T, int H, int P, int G, int N, int Q) {
  extern __shared__ __align__(16) float smem[];
  float* tile = smem;                        // tile_floats()
  float* cum = tile + tile_floats();         // [round4(Q)]
  float* dts = cum + round4(Q);              // [round4(Q)]  dt, then w in the state CTA

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int nqt = (Q + BQ - 1) / BQ;
  const bool state_cta = blockIdx.x == nqt;
  const int h = blockIdx.y;
  const int nc = T / Q;
  const int b = blockIdx.z / nc, c = blockIdx.z % nc;
  const int g = h / (H / G);
  const long long t0 = (long long)b * T + (long long)c * Q;   // first row of the chunk
  const float a = A[h];

  // dt of the chunk and its log-decay prefix, up to the last row this CTA needs
  const int i0 = blockIdx.x * BQ;
  const int need = state_cta ? Q : min(Q, i0 + BQ);
  for (int i = tid; i < need; i += THREADS) {
    const float d = dt[(t0 + i) * H + h];
    dts[i] = d;
    cum[i] = __fmul_rn(d, a);
  }
  __syncthreads();
  if (tid == 0) {
    float acc = 0.f;
    for (int i = 0; i < need; ++i) {
      acc = __fadd_rn(acc, cum[i]);
      cum[i] = acc;
    }
  }
  __syncthreads();

  if (state_cta) {
    // S[n][p] = Σ_j (w_j B_j[n]) x_j[p], w_j = exp(cum_Q − cum_j) dt_j;
    // thread (ty, tx) owns n in [8 ty, 8 ty + 8), p in [4 tx, 4 tx + 4)
    float* WBs = tile;                 // [BK][NMAX]
    float* Xs = tile + BK * NMAX;      // [BK][PMAX]
    const float cq = cum[Q - 1];
    for (int j = tid; j < Q; j += THREADS) dts[j] = expf(__fsub_rn(cq, cum[j])) * dts[j];
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
    for (int j0 = 0; j0 < Q; j0 += BK) {
      __syncthreads();   // w is written / the previous tile is consumed
      for (int idx = tid; idx < BK * NMAX; idx += THREADS) {
        const int r = idx / NMAX, d = idx % NMAX, j = j0 + r;
        float v = 0.f;
        if (j < Q && d < N) v = dts[j] * to_f32(Bm[((t0 + j) * G + g) * N + d]);
        WBs[idx] = v;
      }
      for (int idx = tid; idx < BK * PMAX; idx += THREADS) {
        const int r = idx / PMAX, d = idx % PMAX, j = j0 + r;
        Xs[idx] = (j < Q && d < P) ? to_f32(x[((t0 + j) * H + h) * P + d]) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        const float4 w0 = *reinterpret_cast<const float4*>(&WBs[kk * NMAX + ty * 8]);
        const float4 w1 = *reinterpret_cast<const float4*>(&WBs[kk * NMAX + ty * 8 + 4]);
        const float4 xv = *reinterpret_cast<const float4*>(&Xs[kk * PMAX + tx * 4]);
        const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
        const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][e] = fmaf(wv[i], xs[e], acc[i][e]);
      }
    }
    float* Sb = S + ((long long)blockIdx.z * H + h) * N * P;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int n = ty * 8 + i;
      if (n >= N) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = tx * 4 + e;
        if (p < P) Sb[(long long)n * P + p] = acc[i][e];
      }
    }
    if (tid == 0) decay[(long long)blockIdx.z * H + h] = expf(cq);
    return;
  }

  float* Cs = tile;                          // [NMAX][BQ + PAD]  transposed
  float* Bs = Cs + NMAX * (BQ + PAD);        // [NMAX][BK + PAD]  transposed
  float* Xs = Bs + NMAX * (BK + PAD);        // [BK][PMAX]
  float* Ps = Xs + BK * PMAX;                // [BK][BQ + PAD]    p, transposed

  for (int idx = tid; idx < BQ * NMAX; idx += THREADS) {
    const int r = idx / NMAX, d = idx % NMAX, i = i0 + r;
    Cs[d * (BQ + PAD) + r] = (i < Q && d < N) ? to_f32(Cm[((t0 + i) * G + g) * N + d]) : 0.f;
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  for (int j0 = 0; j0 <= i0 && j0 < Q; j0 += BK) {     // key tiles at or below the diagonal
    __syncthreads();   // Cs is written / the previous tile is consumed
    for (int idx = tid; idx < BK * NMAX; idx += THREADS) {
      const int r = idx / NMAX, d = idx % NMAX, j = j0 + r;
      Bs[d * (BK + PAD) + r] = (j < Q && d < N) ? to_f32(Bm[((t0 + j) * G + g) * N + d]) : 0.f;
    }
    for (int idx = tid; idx < BK * PMAX; idx += THREADS) {
      const int r = idx / PMAX, d = idx % PMAX, j = j0 + r;
      Xs[idx] = (j < Q && d < P) ? to_f32(x[((t0 + j) * H + h) * P + d]) : 0.f;
    }
    __syncthreads();

    // s = C_i · B_j : rows ty*4+i, keys tx*4+j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < NMAX; ++d) {
      const float4 cv4 = *reinterpret_cast<const float4*>(&Cs[d * (BQ + PAD) + ty * 4]);
      const float4 bv4 = *reinterpret_cast<const float4*>(&Bs[d * (BK + PAD) + tx * 4]);
      const float cv[4] = {cv4.x, cv4.y, cv4.z, cv4.w};
      const float bv[4] = {bv4.x, bv4.y, bv4.z, bv4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(cv[i], bv[j], s[i][j]);
    }

    // p = (C·B) · exp(cum_i − cum_j) · dt_j for j <= i < Q, else 0 (selected)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = i0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = j0 + tx * 4 + j;
        float pv = 0.f;
        if (kj <= qi && qi < Q) pv = s[i][j] * expf(__fsub_rn(cum[qi], cum[kj])) * dts[kj];
        Ps[(tx * 4 + j) * (BQ + PAD) + ty * 4 + i] = pv;
      }
    }
    __syncthreads();

    // acc += p · x : rows ty*4+i, columns tx*4+e
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float4 p4 = *reinterpret_cast<const float4*>(&Ps[kk * (BQ + PAD) + ty * 4]);
      const float4 x4 = *reinterpret_cast<const float4*>(&Xs[kk * PMAX + tx * 4]);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
      const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = fmaf(pv[i], xv[e], acc[i][e]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = i0 + ty * 4 + i;
    if (qi >= Q) continue;
    float* yr = y + ((t0 + qi) * H + h) * P;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = tx * 4 + e;
      if (p < P) yr[p] = acc[i][e];
    }
    if (tx == 0) pref[(t0 + qi) * H + h] = expf(cum[qi]);
  }
}

template <typename TX, typename TB>
cudaError_t launch_typed(const void* x, const float* dt, const float* A, const void* Bm,
                         const void* Cm, float* y, float* S, float* decay, float* pref, int B,
                         int T, int H, int P, int G, int N, int Q, cudaStream_t stream) {
  const int bytes = (tile_floats() + 2 * round4(Q)) * (int)sizeof(float);
  auto kern = ssd_chunk_fwd_simt_kernel<TX, TB>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((Q + BQ - 1) / BQ + 1, H, B * (T / Q));
  kern<<<grid, THREADS, bytes, stream>>>(static_cast<const TX*>(x), dt, A,
                                         static_cast<const TB*>(Bm), static_cast<const TB*>(Cm),
                                         y, S, decay, pref, T, H, P, G, N, Q);
  return cudaGetLastError();
}

}  // namespace simt

// ---------------------------------------------------------------------------
// wgmma_bf16: TMA + wgmma on the tensor cores, C·Bᵀ shared by a slab of heads
// ---------------------------------------------------------------------------
namespace tc {

using namespace hopper;

constexpr int BR = 128;          // rows per row CTA: two warpgroups x 64
constexpr int BKEY = 64;         // keys per tile
constexpr int PANEL = 64;        // bf16 per 128-byte swizzled row (one TMA box row)
constexpr int KT = 4;            // key tiles of a chunk at most (Q <= 256)
constexpr int STAGES = 4;        // x ring depth (64-key tiles)
constexpr int THREADS = 256;     // two warpgroups; thread 0 also issues the TMA loads
constexpr int TILE_BYTES = BKEY * PANEL * 2;          // one 64-row x 64-column box: 8 KB
constexpr uint32_t TILE_UNITS = TILE_BYTES / 16;      // ... in 16-byte descriptor units
constexpr uint32_t C_PANEL_UNITS = BR * PANEL * 2 / 16;
constexpr uint32_t KSTEP_MN_UNITS = 16 * PANEL * 2 / 16;   // 16 rows of an MN-major operand

struct Smem {
  __nv_bfloat16 c[2][BR * PANEL];        // C rows, two 64-column panels (state CTA:
                                         // two 64 x 64 fp32 transpose tiles)
  __nv_bfloat16 b[KT][2][BKEY * PANEL];  // B keys: per 64-key tile, two 64-column panels
  __nv_bfloat16 x[STAGES][BKEY * PANEL]; // the x ring: one head's 64-key tile a stage
  uint64_t cb_full;                      // C and B have landed
  uint64_t full[STAGES];
  uint64_t empty[STAGES];
};
// cum and dt of the slab's heads follow Smem: [slab][QS] fp32 each
constexpr int SMEM_FIXED = (static_cast<int>(sizeof(Smem)) + 15) / 16 * 16;
constexpr int SMEM_LIMIT = 232448;       // dynamic shared memory a block can use (227 KB)

// (v0, v1) as three bf16 pairs, hi + mid + lo == v exactly unless a term underflows
__device__ __forceinline__ void split3(float v0, float v1, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  hi = pack_bf16(v0, v1);
  const float2 h = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi));
  const float r0 = v0 - h.x, r1 = v1 - h.y;             // exact
  mid = pack_bf16(r0, r1);
  const float2 m = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&mid));
  lo = pack_bf16(r0 - m.x, r1 - m.y);                   // exact, then exact in bf16
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void bar_wg(int wg) {   // the 128 threads of warpgroup wg
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// grid: (group x slab, batch x chunk, role).  blockIdx.z == 0 is the state
// CTA, blockIdx.z == r > 0 the row CTA of rows 128 (nqt - r) .. +127: the
// card starts the CTAs in that order, the heaviest first.
__global__ void __launch_bounds__(THREADS, 1)
ssd_chunk_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                           const __grid_constant__ CUtensorMap bmap,
                           const __grid_constant__ CUtensorMap cmap,
                           const float* __restrict__ dt, const float* __restrict__ A,
                           float* __restrict__ y, float* __restrict__ S,
                           float* __restrict__ decay, float* __restrict__ pref, int H, int P,
                           int G, int N, int Q, int slab, int QS) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  const uint32_t pad = (1024u - (smem_u32(smem_raw) & 1023u)) & 1023u;
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw + pad);
  // [slab][QS] each; a head's row QS = round64(Q) + 2 floats apart, so the
  // lanes of the prefix scan (one a head) hit different banks
  float* cum = reinterpret_cast<float*>(smem_raw + pad + SMEM_FIXED);
  float* dts = cum + slab * QS;                                         // dt, or w

  const int tid = threadIdx.x;
  const int nqt = (Q + BR - 1) / BR;
  const bool state_cta = blockIdx.z == 0;
  const int i0 = state_cta ? 0 : (nqt - static_cast<int>(blockIdx.z)) * BR;
  const int slabs = H / G / slab;
  const int g = blockIdx.x / slabs;
  const int h0 = g * (H / G) + (blockIdx.x % slabs) * slab;
  const int bc = blockIdx.y;
  const long long t0 = (long long)bc * Q;              // first row of the chunk
  // positions this CTA reads: rows and keys below min(Q, i0 + 128); key tiles
  const int need = state_cta ? Q : min(Q, i0 + BR);
  const int n_kt = (need + BKEY - 1) / BKEY;
  const int n_panels = N > PANEL ? 2 : 1;               // C and B panels with columns < N
  const int total = slab * n_kt;                         // x tiles: (head, key tile) in order

  if (tid == 0) {
    mbar_init(&sm.cb_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], THREADS / 32);   // every warp releases the stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (n_panels == 1 && !state_cta) {
    // N <= 64: C·Bᵀ still runs all 8 column steps (straight-line code, so the
    // accumulators stay in place across its wgmmas), over zeroed second panels
    uint4* zc = reinterpret_cast<uint4*>(sm.c[1]);
    for (int i = tid; i < BR * PANEL * 2 / 16; i += THREADS) zc[i] = make_uint4(0, 0, 0, 0);
    for (int kt = 0; kt < n_kt; ++kt) {
      uint4* zb = reinterpret_cast<uint4*>(sm.b[kt][1]);
      for (int i = tid; i < TILE_BYTES / 16; i += THREADS) zb[i] = make_uint4(0, 0, 0, 0);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // generic writes -> wgmma
  }
  __syncthreads();

  auto issue_x = [&](int u) {
    const int s = u % STAGES;
    mbar_expect_tx(&sm.full[s], TILE_BYTES);
    tma_load_4d(sm.x[s], &xmap, &sm.full[s], 0, h0 + u / n_kt, (u % n_kt) * BKEY, bc);
  };
  if (tid == 0) {
    const int c_bytes = state_cta ? 0 : n_panels * BR * PANEL * 2;
    mbar_expect_tx(&sm.cb_full, c_bytes + n_kt * n_panels * TILE_BYTES);
    for (int p = 0; p < n_panels; ++p) {
      if (!state_cta) tma_load_4d(sm.c[p], &cmap, &sm.cb_full, p * PANEL, g, i0, bc);
      for (int kt = 0; kt < n_kt; ++kt)
        tma_load_4d(sm.b[kt][p], &bmap, &sm.cb_full, p * PANEL, g, kt * BKEY, bc);
    }
    for (int u = 0; u < min(STAGES, total); ++u) issue_x(u);
  }

  // dt of the slab's heads, coalesced along the heads, then the log-decay
  // prefix: one lane per head, the plain version's sequential adds
  for (int base = 0; base < need * slab; base += 8 * THREADS) {   // 8 loads in flight
    float v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int idx = base + tid + THREADS * k;
      v[k] = idx < need * slab ? dt[(t0 + idx / slab) * H + h0 + idx % slab] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int idx = base + tid + THREADS * k;
      if (idx < need * slab) dts[(idx % slab) * QS + idx / slab] = v[k];
    }
  }
  __syncthreads();
  if (tid < slab) {
    const float a = A[h0 + tid];
    float* c = cum + tid * QS;
    float* d = dts + tid * QS;
    float acc = 0.f;
#pragma unroll 8
    for (int i = 0; i < need; ++i) {
      acc = __fadd_rn(acc, __fmul_rn(d[i], a));
      c[i] = acc;
    }
    for (int i = need; i < n_kt * BKEY; ++i) {   // zeros past Q: never inf or NaN
      c[i] = 0.f;
      d[i] = 0.f;
    }
  }
  __syncthreads();
  if (state_cta) {
    // decay, and w_j = exp(cum_Q − cum_j)·dt_j (0 past Q) in place of dt
    if (tid < slab) decay[(long long)bc * H + h0 + tid] = expf(cum[tid * QS + Q - 1]);
    for (int idx = tid; idx < slab * QS; idx += THREADS) {
      const int hl = idx / QS, j = idx - hl * QS;
      dts[idx] = j < Q ? expf(__fsub_rn(cum[hl * QS + Q - 1], cum[idx])) * dts[idx] : 0.f;
    }
  } else {
    const int rows = need - i0;
    for (int idx = tid; idx < rows * slab; idx += THREADS) {
      const int r = idx / slab, hl = idx - r * slab;
      pref[(t0 + i0 + r) * H + h0 + hl] = expf(cum[hl * QS + i0 + r]);
    }
  }
  __syncthreads();

  const int wg = tid / 128, lt = tid % 128;
  const int warp = lt / 32, lane = lt % 32;
  const int gq = lane / 4, t = lane % 4;

  // release stage s of tile u (one arrival a warp, once all its lanes are
  // done with it); thread 0 then refills it with tile u + STAGES
  auto release = [&](int u) {
    const int s = u % STAGES;
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[s]);
    if (tid == 0 && u + STAGES < total) {
      mbar_wait(&sm.empty[s], (u / STAGES) & 1);
      issue_x(u + STAGES);
    }
  };

  if (!state_cta) {
    // ---- row CTA: y for rows rw0 .. rw0 + 63 of this warpgroup ----------------
    const int rw0 = i0 + 64 * wg;
    const int n_need = min(n_kt, rw0 / BKEY + 1);        // key tiles at or below the diagonal
    const int qa = rw0 + 16 * warp + gq, qb = qa + 8;    // the thread's two rows
    const bool ragged = rw0 + 63 >= Q;                   // rows past Q in this warpgroup

    // S = C·Bᵀ for every key tile, kept in registers: straight-line code, so
    // the accumulators stay in place (tiles past this warpgroup's diagonal
    // read smem no load wrote; their S is never used)
    float sc[KT][32];
    mbar_wait(&sm.cb_full, 0);
    const uint32_t c_lo = desc_lo(sm.c[0] + wg * 64 * PANEL, 16);
    wgmma_fence();
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      const uint32_t b_lo = desc_lo(sm.b[kt][0], 16);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)     // 16 columns of N: 32 bytes; 4 per panel
        wgmma_ss_n64(sc[kt], desc(c_lo + (kk / 4) * C_PANEL_UNITS + (kk % 4) * 2),
                     desc(b_lo + (kk / 4) * TILE_UNITS + (kk % 4) * 2), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) fence_regs<32>(sc[kt]);

    int u = 0;
    for (int hl = 0; hl < slab; ++hl) {
      const int h = h0 + hl;
      const float* ch = cum + hl * QS;
      const float* dh = dts + hl * QS;
      const float cum_a = qa < Q ? ch[qa] : 0.f, cum_b = qb < Q ? ch[qb] : 0.f;
      float acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
      fence_regs<32>(acc);           // zeroed before any wgmma.fence, never after
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        if (kt < n_kt) {
          const int s = u % STAGES;
          mbar_wait(&sm.full[s], (u / STAGES) & 1);
          if (kt < n_need) {
            const bool masked = ragged || kt == rw0 / BKEY;   // the diagonal tile, rows past Q
            const uint32_t x_lo = desc_lo(sm.x[s], TILE_BYTES);
            // two halves of 32 keys: the second half's M is formed while the
            // first half's products run on the tensor cores
            uint32_t a[2][2][3][4];                            // [half][16-key step][term][reg]
#pragma unroll
            for (int half = 0; half < 2; ++half) {
#pragma unroll
              for (int kq = 0; kq < 2; ++kq) {
#pragma unroll
                for (int hh = 0; hh < 2; ++hh) {
                  const int jj = 4 * half + 2 * kq + hh;       // 8-key column group 0..7
                  const int j = kt * BKEY + 8 * jj + 2 * t;    // the thread's keys j, j + 1
                  const float2 cj = *reinterpret_cast<const float2*>(ch + j);
                  const float2 dj = *reinterpret_cast<const float2*>(dh + j);
                  float ma[2], mb[2];
#pragma unroll
                  for (int e = 0; e < 2; ++e) {
                    const float cje = e ? cj.y : cj.x, dje = e ? dj.y : dj.x;
                    const float sa = sc[kt][4 * jj + e], sb = sc[kt][4 * jj + 2 + e];
                    if (masked) {
                      ma[e] = j + e <= qa && qa < Q ? sa * expf(__fsub_rn(cum_a, cje)) * dje : 0.f;
                      mb[e] = j + e <= qb && qb < Q ? sb * expf(__fsub_rn(cum_b, cje)) * dje : 0.f;
                    } else {
                      ma[e] = sa * expf(__fsub_rn(cum_a, cje)) * dje;
                      mb[e] = sb * expf(__fsub_rn(cum_b, cje)) * dje;
                    }
                  }
                  uint32_t(&ak)[3][4] = a[half][kq];
                  split3(ma[0], ma[1], ak[0][2 * hh], ak[1][2 * hh], ak[2][2 * hh]);
                  split3(mb[0], mb[1], ak[0][2 * hh + 1], ak[1][2 * hh + 1], ak[2][2 * hh + 1]);
                }
              }
              fence_regs_u32<24>(&a[half][0][0][0]);   // the A terms exist before the fence
              wgmma_fence();
#pragma unroll
              for (int kq = 0; kq < 2; ++kq) {
                const uint64_t dx = desc(x_lo + (2 * half + kq) * KSTEP_MN_UNITS);
                wgmma_rs_n64(acc, a[half][kq][2], dx);   // lo, mid, hi: the small terms first
                wgmma_rs_n64(acc, a[half][kq][1], dx);
                wgmma_rs_n64(acc, a[half][kq][0], dx);
              }
              wgmma_commit();
            }
            wgmma_wait_all();
            fence_regs<32>(acc);
          }
          release(u);
          ++u;
        }
      }
      // y rows qa, qb < Q: lanes t, t^1 swap halves, so each stores 4 columns of one row
      float* yh = y + (long long)h * P;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const bool odd = t & 1;
        const float s0 = odd ? acc[4 * jj] : acc[4 * jj + 2];
        const float s1 = odd ? acc[4 * jj + 1] : acc[4 * jj + 3];
        const float r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
        const float r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
        const int row = odd ? qb : qa;
        const int col = 8 * jj + 2 * (t & ~1);
        if (row < Q && col < P) {
          const float4 v = odd ? make_float4(r0, r1, acc[4 * jj + 2], acc[4 * jj + 3])
                               : make_float4(acc[4 * jj], acc[4 * jj + 1], r0, r1);
          *reinterpret_cast<float4*>(yh + (t0 + row) * H * P + col) = v;
        }
      }
    }
  } else {
    // ---- state CTA: Sᵀ[p][n] = Σ_j (w_j x_j[p]) B_j[n], n in this warpgroup's half ---
    const int n0 = 64 * wg;
    const bool active = n0 < N;
    float* tile = reinterpret_cast<float*>(sm.c[0]) + wg * 64 * 64;   // [n][p], XOR-swizzled
    mbar_wait(&sm.cb_full, 0);
    int u = 0;
    for (int hl = 0; hl < slab; ++hl) {
      const int h = h0 + hl;
      const float* wh = dts + hl * QS;
      float acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
      fence_regs<32>(acc);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = u % STAGES;
        mbar_wait(&sm.full[s], (u / STAGES) & 1);
        if (active) {
          const uint32_t xs = smem_u32(sm.x[s]);
          const uint32_t b_lo = desc_lo(sm.b[kt][wg], TILE_BYTES);
          uint32_t a[2][2][3][4];                              // [half][16-key step][term][reg]
#pragma unroll
          for (int half = 0; half < 2; ++half) {
#pragma unroll
            for (int kq = 0; kq < 2; ++kq) {
              const int kk = 2 * half + kq;
              // (w∘x)ᵀ rows p = 16 warp + gq (+8), keys 16 kk + 2t (+1, +8, +9): matrix
              // q of ldmatrix.trans is x's keys 16 kk + 8 (q/2) .., columns 16 warp + 8 (q%2) ..
              const int q = lane / 8, r = lane % 8;
              const int jrow = 16 * kk + 8 * (q / 2) + r;
              const int chunk = 2 * warp + (q % 2);
              uint32_t xr[4];
              ldmatrix_x4_trans(xr, xs + jrow * 128 + ((chunk ^ (jrow & 7)) << 4));
#pragma unroll
              for (int reg = 0; reg < 4; ++reg) {
                const float2 xv = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(&xr[reg]));
                const float2 wv = *reinterpret_cast<const float2*>(
                    wh + kt * BKEY + 16 * kk + 8 * (reg / 2) + 2 * t);
                split3(wv.x * xv.x, wv.y * xv.y, a[half][kq][0][reg], a[half][kq][1][reg],
                       a[half][kq][2][reg]);
              }
            }
            fence_regs_u32<24>(&a[half][0][0][0]);
            wgmma_fence();
#pragma unroll
            for (int kq = 0; kq < 2; ++kq) {
              const uint64_t db = desc(b_lo + (2 * half + kq) * KSTEP_MN_UNITS);
              wgmma_rs_n64(acc, a[half][kq][2], db);
              wgmma_rs_n64(acc, a[half][kq][1], db);
              wgmma_rs_n64(acc, a[half][kq][0], db);
            }
            wgmma_commit();
          }
          wgmma_wait_all();
          fence_regs<32>(acc);
        }
        release(u);
        ++u;
      }
      if (active) {
        // the fragment (rows p, columns n) into tile[n][p]: float4 chunk c of row n
        // at c ^ (2 ((n >> 1) & 3)), so a warp's stores and reads are conflict-free
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int n = 8 * jj + 2 * t + (e & 1);
            const int p = 16 * warp + gq + 8 * (e >> 1);
            tile[n * 64 + 4 * ((p >> 2) ^ (2 * ((n >> 1) & 3))) + (p & 3)] = acc[4 * jj + e];
          }
        bar_wg(wg);
        float* Sh = S + ((long long)bc * H + h) * N * P;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int idx = lt + 128 * k;
          const int n = idx / 16, c = idx % 16;
          if (n0 + n < N && 4 * c < P)
            *reinterpret_cast<float4*>(Sh + (long long)(n0 + n) * P + 4 * c) =
                *reinterpret_cast<const float4*>(tile + n * 64 + 4 * (c ^ (2 * ((n >> 1) & 3))));
        }
        bar_wg(wg);
      }
    }
  }
}

// (inner, mid, Q, B*nc) bf16 with strides (inner, mid*inner, Q*mid*inner)
// elements, boxes of 64 x 1 x rows x 1
CUresult make_map(EncodeTiled encode, CUtensorMap* map, const void* base, int inner, int mid,
                  int Q, int BNC, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)inner, (cuuint64_t)mid, (cuuint64_t)Q,
                              (cuuint64_t)BNC};
  const cuuint64_t strides[3] = {(cuuint64_t)inner * 2, (cuuint64_t)mid * inner * 2,
                                 (cuuint64_t)Q * mid * inner * 2};
  const cuuint32_t box[4] = {PANEL, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

int launch(const void* x, const float* dt, const float* A, const void* Bm, const void* Cm,
           float* y, float* S, float* decay, float* pref, int B, int T, int H, int P, int G,
           int N, int Q, int slab, cudaStream_t stream) {
  if (Q > KT * BKEY || N > 2 * PANEL || P > PANEL || N % 8 || P % 8 || slab < 1 ||
      (H / G) % slab)
    return static_cast<int>(cudaErrorInvalidValue);
  const int QS = (Q + BKEY - 1) / BKEY * BKEY + 2;
  const int bytes = 1024 + SMEM_FIXED + 2 * slab * QS * static_cast<int>(sizeof(float));
  if (bytes > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return ERR_BASE;
  const int BNC = B * (T / Q);
  CUtensorMap xm, bm, cm;
  CUresult r = make_map(encode, &xm, x, P, H, Q, BNC, BKEY);
  if (r == CUDA_SUCCESS) r = make_map(encode, &bm, Bm, N, G, Q, BNC, BKEY);
  if (r == CUDA_SUCCESS) r = make_map(encode, &cm, Cm, N, G, Q, BNC, BR);
  if (r != CUDA_SUCCESS) return ERR_BASE + static_cast<int>(r);
  auto kern = ssd_chunk_fwd_wgmma_kernel;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(G * (H / G / slab), BNC, (Q + BR - 1) / BR + 1);
  kern<<<grid, THREADS, bytes, stream>>>(xm, bm, cm, dt, A, y, S, decay, pref, H, P, G, N, Q,
                                         slab, QS);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

extern "C" {

// x: (B, T, H, P) fp32 or bf16; dt: (B, T, H) fp32; A: (H,) fp32; Bm, Cm:
// (B, T, G, N) of one type, fp32 or bf16; all contiguous.  Outputs, fp32:
// y (B, T, H, P), S (B, T/Q, H, N, P), decay (B, T/Q, H), pref (B, T, H).
// Needs T % Q == 0, H % G == 0 (checked by the wrapper).  `instance`: 0
// simt_fp32 (P <= 64, N <= 128, Q <= 8192, any types), 1 wgmma_bf16 (bf16 x,
// B and C; N <= 128 and P <= 64, both multiples of 8; Q <= 256; 16-byte
// aligned bases; `slab` heads per CTA, a divisor of H/G).  Returns a
// cudaError_t, or a code past it (see *_error_string).
int ssd_chunk_fwd_launch(const void* x, const void* dt, const void* A, const void* Bm,
                         const void* Cm, void* y, void* S, void* decay, void* pref, int B, int T,
                         int H, int P, int G, int N, int Q, int x_bf16, int bc_bf16, int instance,
                         int slab, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  float *yf = static_cast<float*>(y), *Sf = static_cast<float*>(S);
  float *df = static_cast<float*>(decay), *pf = static_cast<float*>(pref);
  if (instance == 1) {
    if (!x_bf16 || !bc_bf16) return static_cast<int>(cudaErrorInvalidValue);
    return tc::launch(x, dtf, Af, Bm, Cm, yf, Sf, df, pf, B, T, H, P, G, N, Q, slab, st);
  }
  if (instance != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (x_bf16 && bc_bf16)
    return simt::launch_typed<__nv_bfloat16, __nv_bfloat16>(x, dtf, Af, Bm, Cm, yf, Sf, df, pf, B,
                                                            T, H, P, G, N, Q, st);
  if (x_bf16)
    return simt::launch_typed<__nv_bfloat16, float>(x, dtf, Af, Bm, Cm, yf, Sf, df, pf, B, T, H,
                                                    P, G, N, Q, st);
  if (bc_bf16)
    return simt::launch_typed<float, __nv_bfloat16>(x, dtf, Af, Bm, Cm, yf, Sf, df, pf, B, T, H,
                                                    P, G, N, Q, st);
  return simt::launch_typed<float, float>(x, dtf, Af, Bm, Cm, yf, Sf, df, pf, B, T, H, P, G, N,
                                          Q, st);
}

const char* ssd_chunk_fwd_error_string(int err) {
  static thread_local char buf[96];
  if (err == hopper::ERR_BASE) return "cuTensorMapEncodeTiled not found in libcuda.so.1";
  if (err > hopper::ERR_BASE) {
    snprintf(buf, sizeof(buf), "cuTensorMapEncodeTiled failed with CUresult %d",
             err - hopper::ERR_BASE);
    return buf;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
