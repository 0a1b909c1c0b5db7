// FlashAttention-2 forward: causal / sliding-window / GQA, online softmax in fp32.
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
// a loop inside the CTA and the running state lives in registers: one CTA per
// (64 query rows, query head, batch), KV head = head / (Hq / Hkv).
//
// Per KV tile of 64 keys: K and V are staged in shared memory as fp32 (K
// transposed, so a thread's 4 keys are one float4), the 64x64 score tile is
// computed by 256 threads, each a 4x4 register block (fp32 FFMA over Dh),
// the row max / sum are reduced over the 16 threads that share a row with
// warp shuffles, p is written to shared memory (transposed), and each thread
// accumulates a 4 x (DH/16) block of p·v in registers.  Head dims up to 64
// use the DH=64 instance, up to 128 the DH=128 one (the tail columns are
// zero-filled, so any Dh <= 128 works).  KV tiles wholly above the causal
// diagonal or wholly outside the window are skipped: every row of the query
// tile then sees at least one real key before or inside the tiles that are
// walked, and a masked tile met first (p = exp(0) = 1) is wiped by
// alpha = exp(-1e30 - m) = 0 once a real key arrives, as in the TPU kernel.
//
// Shared memory at DH=128: Q 34.8 KB + K 34.8 KB + V 32.8 KB + P 17.4 KB =
// 120 KB, above the 48 KB static limit, so it is dynamic and the kernel's
// limit is raised with cudaFuncSetAttribute.  One CTA per SM fits.
//
// Bound: fp32 operations on CUDA cores (67 TFLOP/s on an H100 SXM): 4·B·Hq·
// Tq·Tk·Dh for the full square, half of it under the causal mask.  The bf16
// tensor-core path (wgmma fed by TMA, 989 TFLOP/s) is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;         // query rows per CTA
constexpr int BK = 64;         // keys per KV tile
constexpr int THREADS = 256;   // 16 x 16: ty owns 4 rows, tx 4 score columns
constexpr int PAD = 4;         // keeps float4 alignment, spreads transposed stores
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <int DH>
constexpr int smem_floats() {
  return DH * (BQ + PAD) + DH * (BK + PAD) + BK * DH + BK * (BQ + PAD);
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
flash_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
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
  const T* qb = q + (long long)b * Tq * q_row_stride + (long long)h * dh;
  const T* kb = k + (long long)b * Tk * k_row_stride + (long long)hk * dh;
  const T* vb = v + (long long)b * Tk * k_row_stride + (long long)hk * dh;

  // q tile, scaled in q's type (rounded) and widened to fp32
  for (int i = tid; i < BQ * DH; i += THREADS) {
    const int r = i / DH, d = i % DH;
    float val = 0.f;
    if (q0 + r < Tq && d < dh)
      val = to_f32(from_f32<T>(to_f32(qb[(q0 + r) * q_row_stride + d]) * scale));
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
        kv = to_f32(kb[(k0 + r) * k_row_stride + d]);
        vv = to_f32(vb[(k0 + r) * k_row_stride + d]);
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

  T* ob = out + (long long)b * Tq * q_row_stride + (long long)h * dh;
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
        if (d < dh) ob[r * q_row_stride + d] = from_f32<T>(acc[i][g * 4 + e] / denom);
      }
  }
}

template <typename T, int DH>
cudaError_t launch_typed(const void* q, const void* k, const void* v, void* out, int B, int Tq,
                         int Tk, int Hq, int Hkv, int dh, float scale, int causal, int window,
                         cudaStream_t stream) {
  constexpr int bytes = smem_floats<DH>() * (int)sizeof(float);
  auto kern = flash_attention_fwd_kernel<T, DH>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + BQ - 1) / BQ, Hq, B);
  kern<<<grid, THREADS, bytes, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                         static_cast<const T*>(v), static_cast<T*>(out), Tq, Tk,
                                         Hq, Hkv, dh, scale, causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dh(const void* q, const void* k, const void* v, void* out, int B, int Tq,
                      int Tk, int Hq, int Hkv, int dh, float scale, int causal, int window,
                      cudaStream_t stream) {
  if (dh <= 64)
    return launch_typed<T, 64>(q, k, v, out, B, Tq, Tk, Hq, Hkv, dh, scale, causal, window, stream);
  return launch_typed<T, 128>(q, k, v, out, B, Tq, Tk, Hq, Hkv, dh, scale, causal, window, stream);
}

}  // namespace

extern "C" {

// q: (B, Tq, Hq, dh), k/v: (B, Tk, Hkv, dh), out: (B, Tq, Hq, dh), all
// contiguous and of one type; dh <= 128; Hq a multiple of Hkv; window <= 0
// means none; scale already rounded to q's type.  Returns a cudaError_t.
int flash_attention_fwd_launch(const void* q, const void* k, const void* v, void* out, int B,
                               int Tq, int Tk, int Hq, int Hkv, int dh, float scale, int causal,
                               int window, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_dh<__nv_bfloat16>(q, k, v, out, B, Tq, Tk, Hq, Hkv, dh, scale, causal, window, st);
  return launch_dh<float>(q, k, v, out, B, Tq, Tk, Hq, Hkv, dh, scale, causal, window, st);
}

const char* flash_attention_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
