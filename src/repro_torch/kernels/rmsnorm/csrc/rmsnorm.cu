// Fused RMSNorm over the last dimension: y = (x * rsqrt(mean(x^2) + eps)) * scale.
//
// Replaces the Pallas TPU kernel repro/kernels/rmsnorm/kernel.py (rmsnorm /
// _rmsnorm_kernel): same function - fp32 statistics whatever the input type,
// the normalised row cast to x's type before the multiply by scale
// (kernel.py:23) - but one CTA per row instead of 256-row VMEM blocks.
//
// Design: 256 threads stride over the row's D columns (D = 3584 in Qwen2-7B
// is not a power of two, so the tail is simply the loop bound), sum x^2 in
// fp32, reduce with warp shuffles and one shared-memory pass, then read the
// row again (it is 7-14 KB, still in L1/L2) to write y.  Rows are
// independent, so nothing crosses CTAs and no row needs padding.
//
// Bound: bytes - read x once, write y once (scale is 7 KB, shared by every
// row), at 3.35 TB/s on an H100 SXM; the arithmetic is ~4 operations per
// element.  Vectorised 16-byte loads are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// TX: x's type; TS: scale's type; TO: the output type (the promoted type of
// x and scale, as the model's rms_norm returns).
template <typename TX, typename TS, typename TO>
__global__ void __launch_bounds__(THREADS)
rmsnorm_kernel(const TX* __restrict__ x, const TS* __restrict__ scale, TO* __restrict__ out,
               int d, float eps) {
  __shared__ float partial[THREADS / 32];
  __shared__ float inv_rms;
  const long long row = blockIdx.x;
  const TX* xr = x + row * d;
  TO* orow = out + row * d;

  float ss = 0.f;
  for (int c = threadIdx.x; c < d; c += THREADS) {
    const float v = to_f32(xr[c]);
    ss += v * v;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float t = lane < THREADS / 32 ? partial[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) t += __shfl_xor_sync(0xffffffffu, t, off);
    if (lane == 0) inv_rms = rsqrtf(t / (float)d + eps);
  }
  __syncthreads();
  const float r = inv_rms;
  for (int c = threadIdx.x; c < d; c += THREADS) {
    // normalise in fp32, round to x's type, then multiply by scale
    const float y = to_f32(from_f32<TX>(to_f32(xr[c]) * r));
    orow[c] = from_f32<TO>(y * to_f32(scale[c]));
  }
}

template <typename TX, typename TS, typename TO>
cudaError_t launch_typed(const void* x, const void* s, void* out, int rows, int d, float eps,
                         cudaStream_t stream) {
  rmsnorm_kernel<TX, TS, TO><<<rows, THREADS, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TS*>(s), static_cast<TO*>(out), d, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (rows, d) contiguous; scale: (d,); out: (rows, d) in the promoted type.
// Returns a cudaError_t (0 = the launch was accepted).
int rmsnorm_launch(const void* x, const void* scale, void* out, int rows, int d, float eps,
                   int x_bf16, int s_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16 && s_bf16)
    return launch_typed<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16>(x, scale, out, rows, d, eps, st);
  if (x_bf16)
    return launch_typed<__nv_bfloat16, float, float>(x, scale, out, rows, d, eps, st);
  if (s_bf16)
    return launch_typed<float, __nv_bfloat16, float>(x, scale, out, rows, d, eps, st);
  return launch_typed<float, float, float>(x, scale, out, rows, d, eps, st);
}

const char* rmsnorm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
