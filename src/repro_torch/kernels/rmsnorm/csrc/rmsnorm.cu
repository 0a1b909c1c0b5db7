// Fused RMSNorm over the last dimension: y = (x * rsqrt(mean(x^2) + eps)) * scale.
//
// Replaces the Pallas TPU kernel repro/kernels/rmsnorm/kernel.py (rmsnorm /
// _rmsnorm_kernel): same function - fp32 statistics whatever the input type,
// the normalised row cast to x's type before the multiply by scale
// (kernel.py:23), the output in the promoted type of x and scale - but one
// warp per row instead of 256-row VMEM blocks.
//
// Bound: bytes - read x once, write y once (scale is 7 KB, shared by every
// row), at 3.35 TB/s on an H100 SXM; the arithmetic is ~4 operations per
// element.  So the design moves each byte once, in 16-byte vectors:
// * one warp per row, several rows (warps) per CTA, and a grid of as many
//   CTAs as fit on the card at once, each warp walking rows with a grid
//   stride;
// * the "regs" instances keep a whole row in registers between the sum of
//   squares and the write (at most NV 16-byte vectors of x a lane: a row of
//   3584 bf16 is 448 vectors, 14 a lane), so x is read from memory once; the
//   warp loads its scale vectors into registers once and reuses them for
//   every row it handles; the reduction is five warp shuffles - no shared
//   memory, no __syncthreads;
// * rows wider than a warp's register budget (x and scale together at most
//   512 bytes a lane, kernel.py:rms_instance) take the "stream" instance:
//   the same warp per row with 16-byte loads, x read a second time for the
//   write (mostly from L2);
// * widths that are not a multiple of the vector, or bases that are not
//   16-byte aligned, take the scalar instance of the stream kernel.
// Which instance runs is a function of (x type, scale type, D, alignment)
// alone, chosen by the wrapper.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;              // rows in flight per CTA
constexpr int THREADS = 32 * WARPS;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// N consecutive elements moved as one access (up to 16 bytes; 32 as two)
template <typename T, int N>
struct alignas(sizeof(T) * N >= 16 ? 16 : sizeof(T) * N) Pack {
  T v[N];
};

// The same, held as 32-bit words (a bf16 pair to a word), so that a row in
// registers takes one register per 4 bytes: as separate 16-bit values ptxas
// gives each bf16 a register of its own, which doubles a row's registers.
template <typename T, int N>
struct alignas(sizeof(T) * N >= 16 ? 16 : sizeof(T) * N) Words {
  unsigned w[N * sizeof(T) / 4];
};

// element e of a word array as fp32
template <typename T> __device__ __forceinline__ float get(const unsigned* w, int e);
template <> __device__ __forceinline__ float get<float>(const unsigned* w, int e) {
  return __uint_as_float(w[e]);
}
template <> __device__ __forceinline__ float get<__nv_bfloat16>(const unsigned* w, int e) {
  return __uint_as_float(e & 1 ? w[e >> 1] & 0xffff0000u : w[e >> 1] << 16);
}
// The same value from an instruction the compiler may neither merge with
// another nor hoist out of a loop.  The sum of squares widens x this way and
// the write with get, so the compiler does not keep a row of widened floats
// alive across the row's reduction; the write widens the scale this way, so
// the scale stays packed in registers, not widened and hoisted out of the
// row loop.  Either would double the registers a row takes.
template <typename T> __device__ __forceinline__ float get_opaque(const unsigned* w, int e);
template <> __device__ __forceinline__ float get_opaque<float>(const unsigned* w, int e) {
  return __uint_as_float(w[e]);
}
template <> __device__ __forceinline__ float get_opaque<__nv_bfloat16>(const unsigned* w, int e) {
  unsigned r;
  if (e & 1)
    asm volatile("and.b32 %0, %1, 0xffff0000;" : "=r"(r) : "r"(w[e >> 1]));
  else
    asm volatile("shl.b32 %0, %1, 16;" : "=r"(r) : "r"(w[e >> 1]));
  return __uint_as_float(r);
}
// elements e and e+1 (e even) of a word array from fp32
template <typename T> __device__ __forceinline__ void put2(unsigned* w, int e, float a, float b);
template <> __device__ __forceinline__ void put2<float>(unsigned* w, int e, float a, float b) {
  w[e] = __float_as_uint(a);
  w[e + 1] = __float_as_uint(b);
}
template <> __device__ __forceinline__ void put2<__nv_bfloat16>(unsigned* w, int e, float a,
                                                               float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  w[e >> 1] = *reinterpret_cast<const unsigned*>(&h);
}
// v rounded to T and back
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// One warp per row, the row held in registers: at most NV 16-byte vectors
// of x a lane (vector v = lane + 32*i).  d is a multiple of the vector.
template <typename TX, typename TS, typename TO, int NV>
__global__ void __launch_bounds__(THREADS)
rmsnorm_regs_kernel(const TX* __restrict__ x, const TS* __restrict__ scale, TO* __restrict__ out,
                    int rows, int d, float eps) {
  constexpr int VEC = 16 / sizeof(TX);
  using XW = Words<TX, VEC>;
  using SW = Words<TS, VEC>;
  using OW = Words<TO, VEC>;
  const int lane = threadIdx.x % 32;
  const int nvec = d / VEC;
  SW sv[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int v = lane + 32 * i;
    if (v < nvec) sv[i] = reinterpret_cast<const SW*>(scale)[v];
  }
  for (long long row = (long long)blockIdx.x * WARPS + threadIdx.x / 32; row < rows;
       row += (long long)gridDim.x * WARPS) {
    const XW* xr = reinterpret_cast<const XW*>(x + row * d);
    XW xv[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int v = lane + 32 * i;
      if (v < nvec) xv[i] = xr[v];
    }
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (lane + 32 * i < nvec) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float f = get_opaque<TX>(xv[i].w, e);
          ss += f * f;
        }
      }
    }
    const float r = rsqrtf(warp_sum(ss) / (float)d + eps);
    OW* orow = reinterpret_cast<OW*>(out + row * d);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int v = lane + 32 * i;
      if (v < nvec) {
        // normalise in fp32, round to x's type, then multiply by scale
        OW o;
#pragma unroll
        for (int e = 0; e < VEC; e += 2)
          put2<TO>(o.w, e, round_to<TX>(get<TX>(xv[i].w, e) * r) * get_opaque<TS>(sv[i].w, e),
                   round_to<TX>(get<TX>(xv[i].w, e + 1) * r) * get_opaque<TS>(sv[i].w, e + 1));
        orow[v] = o;
      }
    }
  }
}

// One warp per row, any width: VEC elements an access (16 bytes, or 1
// element for the scalar instance), x read twice - the sum of squares, then
// the write.  d is a multiple of VEC.
template <typename TX, typename TS, typename TO, int VEC>
__global__ void __launch_bounds__(THREADS)
rmsnorm_stream_kernel(const TX* __restrict__ x, const TS* __restrict__ scale,
                      TO* __restrict__ out, int rows, int d, float eps) {
  using XP = Pack<TX, VEC>;
  using SP = Pack<TS, VEC>;
  using OP = Pack<TO, VEC>;
  const int lane = threadIdx.x % 32;
  const int nvec = d / VEC;
  for (long long row = (long long)blockIdx.x * WARPS + threadIdx.x / 32; row < rows;
       row += (long long)gridDim.x * WARPS) {
    const XP* xr = reinterpret_cast<const XP*>(x + row * d);
    float ss = 0.f;
    for (int v = lane; v < nvec; v += 32) {
      const XP xv = xr[v];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float f = to_f32(xv.v[e]);
        ss += f * f;
      }
    }
    const float r = rsqrtf(warp_sum(ss) / (float)d + eps);
    OP* orow = reinterpret_cast<OP*>(out + row * d);
    for (int v = lane; v < nvec; v += 32) {
      const XP xv = xr[v];
      const SP sv = reinterpret_cast<const SP*>(scale)[v];
      OP o;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        o.v[e] = from_f32<TO>(round_to<TX>(to_f32(xv.v[e]) * r) * to_f32(sv.v[e]));
      orow[v] = o;
    }
  }
}

// as many CTAs of KERNEL as fit on the card at once, at most one row a warp
template <auto KERNEL>
int grid_for(int rows) {
  static int resident = 0;      // CTAs of this kernel the card holds at once
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, KERNEL, THREADS, 0);
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int need = (rows + WARPS - 1) / WARPS;
  return need < resident ? need : resident;
}

template <auto KERNEL, typename TX, typename TS, typename TO>
cudaError_t launch(const void* x, const void* s, void* out, int rows, int d, float eps,
                   cudaStream_t stream) {
  KERNEL<<<grid_for<KERNEL>(rows), THREADS, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TS*>(s), static_cast<TO*>(out), rows, d, eps);
  return cudaGetLastError();
}

// instance: 0 = scalar, 1 = stream (16-byte vectors), 2 / 3 / 4 = regs with
// NV = 4 / 8 / 16 vectors a lane (kernel.py:INSTANCES)
template <typename TX, typename TS, typename TO>
cudaError_t launch_instance(int instance, const void* x, const void* s, void* out, int rows,
                            int d, float eps, cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(TX);
  switch (instance) {
    case 0:
      return launch<rmsnorm_stream_kernel<TX, TS, TO, 1>, TX, TS, TO>(x, s, out, rows, d, eps, st);
    case 1:
      return launch<rmsnorm_stream_kernel<TX, TS, TO, VEC>, TX, TS, TO>(x, s, out, rows, d, eps,
                                                                        st);
    case 2:
      return launch<rmsnorm_regs_kernel<TX, TS, TO, 4>, TX, TS, TO>(x, s, out, rows, d, eps, st);
    case 3:
      return launch<rmsnorm_regs_kernel<TX, TS, TO, 8>, TX, TS, TO>(x, s, out, rows, d, eps, st);
    case 4:
      return launch<rmsnorm_regs_kernel<TX, TS, TO, 16>, TX, TS, TO>(x, s, out, rows, d, eps, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x: (rows, d) contiguous; scale: (d,); out: (rows, d) in the promoted type;
// ``instance`` as in launch_instance (the wrapper has checked that d and the
// bases suit it).  Returns a cudaError_t (0 = the launch was accepted).
int rmsnorm_launch(const void* x, const void* scale, void* out, int rows, int d, float eps,
                   int x_bf16, int s_bf16, int instance, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16 && s_bf16)
    return launch_instance<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16>(instance, x, scale, out,
                                                                        rows, d, eps, st);
  if (x_bf16)
    return launch_instance<__nv_bfloat16, float, float>(instance, x, scale, out, rows, d, eps, st);
  if (s_bf16)
    return launch_instance<float, __nv_bfloat16, float>(instance, x, scale, out, rows, d, eps, st);
  return launch_instance<float, float, float>(instance, x, scale, out, rows, d, eps, st);
}

const char* rmsnorm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
