// Mamba2 SSD intra-chunk forward: per (batch, chunk, head)
//   cum     = cumsum(dt·A)                                (inclusive, fp32)
//   y_intra = Σ_{j<=i} (C_i·B_j) · exp(cum_i − cum_j) · dt_j · x_j
//   S       = Σ_j exp(cum_Q − cum_j) · dt_j · B_j ⊗ x_j     (the chunk's state)
//   decay   = exp(cum_Q),  pref = exp(cum)
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_chunk/kernel.py
// (ssd_chunk_fwd / _ssd_kernel), which holds one (chunk, head) in VMEM per
// grid step and forms the Q x Q matrix M whole.  Here the intra-chunk output
// is causal attention with a decay in place of the softmax (C the queries, B
// the keys, dt·x the values, no running max, no normaliser), so it keeps
// flash_attention_fwd.cu's structure: one CTA per (64 rows of a chunk, head,
// batch x chunk), 64-key tiles j <= i staged in shared memory as fp32 (C and
// B transposed, so a thread's 4 rows or keys are one float4), 256 threads
// each computing a 4x4 block of C·B by fp32 FFMA over N, the decay and dt
// applied in registers and the product p written to shared memory, then a
// 4 x (P/16) block of p·x accumulated in registers.  Key tiles above the
// diagonal are skipped; inside the diagonal tile, and past the chunk's end
// when Q is not a multiple of 64, entries are selected to 0, never
// multiplied by a mask, so exp of a positive exponent is never formed.
//
// One more CTA per (chunk, head, batch) - blockIdx.x == Q/64 rounded up -
// sums the state S over all Q positions in a fixed order (no atomics: the
// same bits every run) and writes decay.  Head h reads group h / (H/G).
//
// Rounding follows the plain version (ref.py): dt·A is rounded to fp32 and
// summed in order, one add at a time, as torch.cumsum does along a
// non-innermost dim on the card (__fmul_rn / __fadd_rn keep nvcc from
// fusing them into an FMA); cum_i − cum_j is an fp32 difference, then expf;
// (C·B)·decay·dt in that order; w = exp(cum_Q − cum_j)·dt, then w·B, then the
// sum with x.
//
// Shared memory: C 34.8 KB + B 34.8 KB + x 16.4 KB + p 17.4 KB, plus cum and
// dt of the chunk (8 bytes per position): 105 KB at Q = 256, dynamic, so
// two CTAs fit on an SM.
//
// Bound: fp32 operations on CUDA cores (67 TFLOP/s on an H100 SXM): per
// (batch, chunk, head) Q(Q+1)/2 causal pairs x (N + P) x 2 plus the state's
// Q·N·P·2 - 16.8 MFLOP at Q 256, N 128, P 64.  bf16 tensor cores (wgmma fed
// by TMA) are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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
ssd_chunk_fwd_kernel(const TX* __restrict__ x, const float* __restrict__ dt,
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
  auto kern = ssd_chunk_fwd_kernel<TX, TB>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((Q + BQ - 1) / BQ + 1, H, B * (T / Q));
  kern<<<grid, THREADS, bytes, stream>>>(static_cast<const TX*>(x), dt, A,
                                         static_cast<const TB*>(Bm), static_cast<const TB*>(Cm),
                                         y, S, decay, pref, T, H, P, G, N, Q);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (B, T, H, P) fp32 or bf16; dt: (B, T, H) fp32; A: (H,) fp32; Bm, Cm:
// (B, T, G, N) of one type, fp32 or bf16; all contiguous.  Outputs, fp32:
// y (B, T, H, P), S (B, T/Q, H, N, P), decay (B, T/Q, H), pref (B, T, H).
// Needs T % Q == 0, H % G == 0, P <= 64, N <= 128, Q <= 8192 (checked by the
// wrapper).  Returns a cudaError_t (0 = the launch was accepted).
int ssd_chunk_fwd_launch(const void* x, const void* dt, const void* A, const void* Bm,
                         const void* Cm, void* y, void* S, void* decay, void* pref, int B, int T,
                         int H, int P, int G, int N, int Q, int x_bf16, int bc_bf16,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  float *yf = static_cast<float*>(y), *Sf = static_cast<float*>(S);
  float *df = static_cast<float*>(decay), *pf = static_cast<float*>(pref);
  if (x_bf16 && bc_bf16)
    return launch_typed<__nv_bfloat16, __nv_bfloat16>(x, dtf, Af, Bm, Cm, yf, Sf, df, pf, B, T,
                                                      H, P, G, N, Q, st);
  if (x_bf16)
    return launch_typed<__nv_bfloat16, float>(x, dtf, Af, Bm, Cm, yf, Sf, df, pf, B, T, H, P, G,
                                              N, Q, st);
  if (bc_bf16)
    return launch_typed<float, __nv_bfloat16>(x, dtf, Af, Bm, Cm, yf, Sf, df, pf, B, T, H, P, G,
                                              N, Q, st);
  return launch_typed<float, float>(x, dtf, Af, Bm, Cm, yf, Sf, df, pf, B, T, H, P, G, N, Q, st);
}

const char* ssd_chunk_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
