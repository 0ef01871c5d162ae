// Bit-packed wire codecs for Hopper: top-k and QSGD pack / unpack over
// 2048-element windows.
//
// Replace the Pallas TPU kernels of src/repro/kernels/wire_pack.py:
//
//   topk_pack    (_topk_pack_kernel)    bisection threshold, first k
//                                       survivors by index, compacted to
//                                       bf16 values + u16 window indices
//   topk_unpack  (_topk_unpack_kernel)  scatter k (value, index) pairs
//                                       into a zero window
//   qsgd_pack    (_qsgd_pack_kernel)    per-window norm, stochastic level
//                                       codes with a sign bit, OR-packed
//                                       into 32-bit words, plus a scale
//   qsgd_unpack  (_qsgd_unpack_kernel)  sign * code * scale
//
// Each computes what the plain versions of
// src/repro_torch/kernels/ref.py compute, bit for bit: every f32 step is a
// round-to-nearest intrinsic in the reference's order, so nvcc contracts
// nothing into an FMA.  The TPU kernels compact and scatter with one-hot
// matmuls because a TPU has no scatter; here survivors are ranked with a
// warp ballot and written directly, and unpack scatters into shared memory.
//
// What bounds them on an H100.  By bytes, the packs read 4 B (top-k) or
// 8 B (qsgd: values and noise) per element and the unpacks write 4 B per
// element; every kernel moves under 10 B per element.  topk_pack also does
// 24 compare-and-count sweeps of its window, about 50 integer operations
// per element, so at small sizes it is bound by the latency of one warp's
// sweeps rather than by either rate.  The designs:
//   * topk_pack: one warp per window, 64 values in registers per lane
//     (lane l of step s holds element 32 s + l, so loads coalesce); the
//     counts are warp reductions, no barrier and no shared memory.
//   * topk_unpack: one CTA per window; the window is built in shared
//     memory and stored with 16-byte writes.
//   * qsgd_pack: one CTA of 256 threads per window, 8 consecutive elements
//     a thread (two 16-byte loads); the sum of squares has a fixed order (8
//     sequential per thread, then a shared-memory halving tree) that
//     qsgd_sumsq in ref.py repeats; one thread builds one word from the
//     fields in shared memory.
//   * qsgd_unpack: one thread per element.
//
// Interface: plain C, loaded with ctypes.  Pointers are device addresses of
// contiguous buffers (16-byte aligned where read or written as vectors);
// the stream is the caller's cudaStream_t.  Each entry point returns
// cudaGetLastError() after its launch, or cudaErrorInvalidValue for
// arguments it does not take.  Indices are int16 on the PyTorch side (u16
// bit patterns, all below 2048) and code words int32 (u32 bit patterns).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 2048;            // wire_formats.PACK_BLOCK
constexpr int kIters = 24;              // wire_formats.N_BISECT_ITERS
constexpr int kPerLane = kBlock / 32;   // values a lane holds in topk_pack
constexpr int kPackWarps = 2;           // windows per CTA in topk_pack
constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  }
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__global__ void __launch_bounds__(32 * kPackWarps)
topk_pack_kernel(const float* __restrict__ rows,
                 __nv_bfloat16* __restrict__ vals,
                 uint16_t* __restrict__ idx, int64_t nb, int k) {
  const int lane = threadIdx.x & 31;
  const int64_t w = (int64_t)blockIdx.x * kPackWarps + (threadIdx.x >> 5);
  if (w >= nb) return;  // the whole warp leaves together
  const float* row = rows + w * kBlock;
  float x[kPerLane];
  float hi = 0.0f;
#pragma unroll
  for (int s = 0; s < kPerLane; ++s) {
    x[s] = __ldg(row + 32 * s + lane);
    hi = fmaxf(hi, fabsf(x[s]));
  }
  hi = warp_max(hi);
  // bisection: every lane holds the same lo / hi after each warp count
  float lo = 0.0f;
  for (int it = 0; it < kIters; ++it) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    int cnt = 0;
#pragma unroll
    for (int s = 0; s < kPerLane; ++s) cnt += fabsf(x[s]) >= mid;
    if (warp_sum(cnt) >= k) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  // compaction in index order: rank = survivors at lower indices
  const unsigned below = (1u << lane) - 1u;
  __nv_bfloat16* v_out = vals + w * k;
  uint16_t* i_out = idx + w * k;
  int base = 0;
#pragma unroll
  for (int s = 0; s < kPerLane; ++s) {
    const bool keep = fabsf(x[s]) >= lo;
    const unsigned ballot = __ballot_sync(kFull, keep);
    const int rank = base + __popc(ballot & below);
    if (keep && rank < k) {
      v_out[rank] = __float2bfloat16_rn(x[s]);
      i_out[rank] = (uint16_t)(32 * s + lane);
    }
    base += __popc(ballot);
  }
}

__global__ void __launch_bounds__(kThreads)
topk_unpack_kernel(const __nv_bfloat16* __restrict__ vals,
                   const uint16_t* __restrict__ idx, float* __restrict__ out,
                   int k) {
  __shared__ __align__(16) float win[kBlock];
  const int64_t w = blockIdx.x;
  for (int i = threadIdx.x; i < kBlock; i += kThreads) win[i] = 0.0f;
  __syncthreads();
  const __nv_bfloat16* v = vals + w * k;
  const uint16_t* ix = idx + w * k;
  // packed indices are distinct, so no two threads write one slot; the
  // add onto +0 is the reference's scatter-add (it turns -0 into +0)
  for (int r = threadIdx.x; r < k; r += kThreads) {
    const int j = __ldg(ix + r);
    if (j < kBlock) win[j] = __fadd_rn(0.0f, __bfloat162float(v[r]));
  }
  __syncthreads();
  const float4* src = reinterpret_cast<const float4*>(win);
  float4* dst = reinterpret_cast<float4*>(out + w * kBlock);
  for (int i = threadIdx.x; i < kBlock / 4; i += kThreads) dst[i] = src[i];
}

__global__ void __launch_bounds__(kThreads)
qsgd_pack_kernel(const float* __restrict__ rows,
                 const float* __restrict__ noise,
                 uint32_t* __restrict__ words_out,
                 float* __restrict__ scale_out, int levels, int bits, int epw,
                 int nwords, float denom) {
  __shared__ float part[kThreads];
  __shared__ uint32_t field[kBlock];
  const int64_t w = blockIdx.x;
  const int t = threadIdx.x;
  const float4* xv = reinterpret_cast<const float4*>(rows + w * kBlock) + 2 * t;
  const float4* uv =
      reinterpret_cast<const float4*>(noise + w * kBlock) + 2 * t;
  const float4 x0 = __ldg(xv), x1 = __ldg(xv + 1);
  const float4 u0 = __ldg(uv), u1 = __ldg(uv + 1);
  const float x[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
  const float u[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
  float s = __fmul_rn(x[0], x[0]);
#pragma unroll
  for (int j = 1; j < 8; ++j) s = __fadd_rn(s, __fmul_rn(x[j], x[j]));
  part[t] = s;
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half >>= 1) {
    if (t < half) part[t] = __fadd_rn(part[t], part[t + half]);
    __syncthreads();
  }
  // 1e-30 as the reference rounds it: a double, then to f32
  const float norm = __fadd_rn(__fsqrt_rn(part[0]), (float)1e-30);
  const float lv = (float)levels;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float y = __fmul_rn(__fdiv_rn(fabsf(x[j]), norm), lv);
    const float lo = floorf(y);
    const float code = __fadd_rn(lo, u[j] < __fsub_rn(y, lo) ? 1.0f : 0.0f);
    field[8 * t + j] = (uint32_t)code | ((x[j] < 0.0f ? 1u : 0u) << (bits - 1));
  }
  __syncthreads();
  for (int i = t; i < nwords; i += kThreads) {
    uint32_t word = 0;
    for (int e = 0; e < epw; ++e) {
      const int el = i * epw + e;
      if (el < kBlock) word |= field[el] << (bits * e);
    }
    words_out[w * nwords + i] = word;
  }
  if (t == 0) scale_out[w] = __fdiv_rn(norm, denom);
}

__global__ void __launch_bounds__(kThreads)
qsgd_unpack_kernel(const uint32_t* __restrict__ words,
                   const float* __restrict__ scale, float* __restrict__ out,
                   int64_t n, int bits, int epw, int nwords) {
  const uint32_t field_mask = (1u << bits) - 1u;
  const uint32_t mag_mask = (1u << (bits - 1)) - 1u;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    const int64_t w = i / kBlock;
    const int el = (int)(i % kBlock);
    const uint32_t word = __ldg(words + w * nwords + el / epw);
    const uint32_t f = (word >> (bits * (el % epw))) & field_mask;
    const float code = (float)(f & mag_mask);
    const float sgn = __fsub_rn(1.0f, __fmul_rn(2.0f, (float)(f >> (bits - 1))));
    out[i] = __fmul_rn(__fmul_rn(sgn, code), __ldg(scale + w));
  }
}

inline bool qsgd_layout_ok(int bits, int epw, int nwords) {
  return bits >= 2 && bits <= 16 && epw == 32 / bits &&
         nwords == (kBlock + epw - 1) / epw;
}

}  // namespace

extern "C" int topk_pack(const void* rows, void* vals, void* idx, int64_t nb,
                         int k, void* stream) {
  if (nb < 1 || k < 1 || k > kBlock) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (nb + kPackWarps - 1) / kPackWarps;
  topk_pack_kernel<<<(unsigned)blocks, 32 * kPackWarps, 0,
                     (cudaStream_t)stream>>>(
      (const float*)rows, (__nv_bfloat16*)vals, (uint16_t*)idx, nb, k);
  return (int)cudaGetLastError();
}

extern "C" int topk_unpack(const void* vals, const void* idx, void* out,
                           int64_t nb, int k, void* stream) {
  if (nb < 1 || k < 1 || k > kBlock) return (int)cudaErrorInvalidValue;
  topk_unpack_kernel<<<(unsigned)nb, kThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)vals, (const uint16_t*)idx, (float*)out, k);
  return (int)cudaGetLastError();
}

extern "C" int qsgd_pack(const void* rows, const void* noise, void* words,
                         void* scale, int64_t nb, int levels, int bits,
                         int epw, int nwords, float denom, void* stream) {
  if (nb < 1 || levels < 1 || !qsgd_layout_ok(bits, epw, nwords)) {
    return (int)cudaErrorInvalidValue;
  }
  qsgd_pack_kernel<<<(unsigned)nb, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)rows, (const float*)noise, (uint32_t*)words,
      (float*)scale, levels, bits, epw, nwords, denom);
  return (int)cudaGetLastError();
}

extern "C" int qsgd_unpack(const void* words, const void* scale, void* out,
                           int64_t nb, int bits, int epw, int nwords,
                           void* stream) {
  if (nb < 1 || !qsgd_layout_ok(bits, epw, nwords)) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t n = nb * kBlock;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  qsgd_unpack_kernel<<<(unsigned)blocks, kThreads, 0,
                       (cudaStream_t)stream>>>(
      (const uint32_t*)words, (const float*)scale, (float*)out, n, bits, epw,
      nwords);
  return (int)cudaGetLastError();
}
