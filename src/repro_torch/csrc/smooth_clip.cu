// Smooth clipping (paper Definition 2) for Hopper, in two passes over a
// flat (tiles, 8192) plane:
//
//   sumsq        (_sumsq_kernel)        per-tile sum of squares -> (tiles,)
//   scale        (_scale_kernel)        y = x * f_row
//   scale_noise  (_scale_noise_kernel)  y = x * f_row + sigma * z
//
// Replace the Pallas TPU kernels of src/repro/kernels/smooth_clip.py.  The
// wrapper (src/repro_torch/kernels/ops.py) combines a row's partials with
// one sum, a square root and the correctly rounded quotient
// f = tau / (tau + ||x||) between the passes, as the reference's wrapper
// does with jnp.sum.  The plane may stack rows (agents, or samples): the
// factor operand holds one f32 per row and broadcasts over the row's
// tiles_per_row tiles, the Pallas kernel's scalar generalised to the rows
// the port clips in one launch.  At f = 1 scale_noise is the DP
// perturbation g + sigma * z, bit for bit.
//
// Each computes what the plain versions of src/repro_torch/kernels/ref.py
// (clip_sumsq, clip_scale_ref) compute, bit for bit: every f32 step is a
// round-to-nearest intrinsic, so nvcc contracts nothing into an FMA.  The
// sum of squares has a fixed order: thread t of 1024 sums the squares of
// elements 8t..8t+7 in sequence, then a halving tree adds partial i + half
// onto partial i (shared memory down to 32 partials, then warp shuffles,
// which add lane i + off onto lane i: the same pairs).
//
// What bounds them on an H100: memory bandwidth.  sumsq reads 4 B (f32)
// or 2 B (bf16) per element and writes 4 B a tile; scale reads and writes
// the element (8 B in f32), scale_noise also reads the noise (12 B).  A
// thread moves 8 consecutive elements with 16-byte accesses (two of f32,
// one of bf16); the arithmetic is one or three operations an element.
// sumsq takes one CTA of 1024 threads a tile (its tree needs the whole
// tile in one CTA); scale takes four CTAs of 256 threads a tile.
//
// Interface: plain C, loaded with ctypes.  Pointers are device addresses of
// contiguous, 16-byte aligned buffers; bf16 != 0 reads and writes bf16
// planes (noise in the plane's dtype), else f32; factors and partials are
// f32.  The stream is the caller's cudaStream_t.  Each entry point returns
// cudaGetLastError() after its launch, or cudaErrorInvalidValue for
// arguments it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 8 * 1024;           // kernels/flatten.TILE
constexpr int kVec = 8;                   // elements a thread
constexpr int kSumThreads = kTile / kVec;  // 1024 partials a tile
constexpr int kScaleThreads = 256;
constexpr int kScaleCtas = kTile / (kVec * kScaleThreads);  // 4 a tile
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void load8(const float* p, float v[kVec]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// bf16 -> f32 is exact: the bf16 bits are the f32's high half
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[kVec]) {
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void store8(float* p, const float v[kVec]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float v[kVec]) {
  uint4 o;
  o.x = bf16_bits(v[0]) | (bf16_bits(v[1]) << 16);
  o.y = bf16_bits(v[2]) | (bf16_bits(v[3]) << 16);
  o.z = bf16_bits(v[4]) | (bf16_bits(v[5]) << 16);
  o.w = bf16_bits(v[6]) | (bf16_bits(v[7]) << 16);
  *reinterpret_cast<uint4*>(p) = o;
}

template <typename T>
__global__ void __launch_bounds__(kSumThreads)
sumsq_kernel(const T* __restrict__ x, float* __restrict__ out) {
  __shared__ float part[kSumThreads];
  const int t = threadIdx.x;
  float v[kVec];
  load8(x + (int64_t)blockIdx.x * kTile + kVec * t, v);
  float s = __fmul_rn(v[0], v[0]);
#pragma unroll
  for (int j = 1; j < kVec; ++j) s = __fadd_rn(s, __fmul_rn(v[j], v[j]));
  part[t] = s;
  __syncthreads();
  for (int half = kSumThreads / 2; half >= 32; half >>= 1) {
    if (t < half) part[t] = __fadd_rn(part[t], part[t + half]);
    __syncthreads();
  }
  if (t < 32) {
    float p = part[t];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      p = __fadd_rn(p, __shfl_down_sync(kFull, p, off));
    }
    if (t == 0) out[blockIdx.x] = p;
  }
}

template <typename T, bool kNoise>
__global__ void __launch_bounds__(kScaleThreads)
scale_kernel(const T* __restrict__ x, const float* __restrict__ factor,
             const T* __restrict__ noise, float sigma, T* __restrict__ out,
             int64_t tiles_per_row) {
  const int64_t tile = blockIdx.x / kScaleCtas;
  const float f = __ldg(factor + tile / tiles_per_row);
  const int64_t at = tile * kTile +
                     (int64_t)(blockIdx.x % kScaleCtas) * kScaleThreads * kVec +
                     kVec * threadIdx.x;
  float v[kVec];
  load8(x + at, v);
  if (kNoise) {
    float z[kVec];
    load8(noise + at, z);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      v[j] = __fadd_rn(__fmul_rn(v[j], f), __fmul_rn(sigma, z[j]));
    }
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) v[j] = __fmul_rn(v[j], f);
  }
  store8(out + at, v);
}

template <typename T>
int launch_scale(const void* x, const void* factor, int64_t tiles_per_row,
                 const void* noise, float sigma, void* out, int64_t tiles,
                 cudaStream_t stream) {
  const int64_t blocks = tiles * kScaleCtas;
  if (noise == nullptr) {
    scale_kernel<T, false><<<(unsigned)blocks, kScaleThreads, 0, stream>>>(
        (const T*)x, (const float*)factor, nullptr, 0.0f, (T*)out,
        tiles_per_row);
  } else {
    scale_kernel<T, true><<<(unsigned)blocks, kScaleThreads, 0, stream>>>(
        (const T*)x, (const float*)factor, (const T*)noise, sigma, (T*)out,
        tiles_per_row);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int clip_sumsq(const void* x, int bf16, void* out, int64_t tiles,
                          void* stream) {
  if (tiles < 1 || tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    sumsq_kernel<__nv_bfloat16><<<(unsigned)tiles, kSumThreads, 0, s>>>(
        (const __nv_bfloat16*)x, (float*)out);
  } else {
    sumsq_kernel<float><<<(unsigned)tiles, kSumThreads, 0, s>>>(
        (const float*)x, (float*)out);
  }
  return (int)cudaGetLastError();
}

// noise == nullptr launches scale, else scale_noise
extern "C" int clip_scale(const void* x, int bf16, const void* factor,
                          int64_t tiles_per_row, const void* noise,
                          float sigma, void* out, int64_t tiles,
                          void* stream) {
  if (tiles < 1 || tiles_per_row < 1 || tiles % tiles_per_row != 0 ||
      tiles > 0x7fffffff / kScaleCtas) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    return launch_scale<__nv_bfloat16>(x, factor, tiles_per_row, noise, sigma,
                                       out, tiles, s);
  }
  return launch_scale<float>(x, factor, tiles_per_row, noise, sigma, out,
                             tiles, s);
}
