// Per-window magnitude top-k for Hopper: keep the k largest |x| of each
// 2048-element window, write +0.0 elsewhere.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/block_topk.py
// (block_topk / _block_topk_kernel), the dense form of the block_top_k
// compressor (src/repro/core/compression.py:157).  It keeps exactly k: the
// elements strictly above the k-th largest magnitude, then, among those
// equal to it, the first ones in index order until k are kept.  That is
// jax.lax.top_k's set, with ties to the lower index, and the set of the
// stable sort in src/repro_torch/kernels/ref.py::block_topk_ref, so the
// output is bitwise the plain version's.  (The TPU kernel keeps every
// element >= a bisection threshold on the values, so it keeps more than k
// on exact ties; its own oracle keeps k.)  A kept -0.0 stays -0.0.  NaN
// magnitudes are out of contract.
//
// Selection.  |x| is ordered as the uint32 key bits(x) & 0x7fffffff (bf16
// inputs are widened to f32 first, which is exact and keeps the order).
// A 31-step bisection on the integer key finds the largest T with
// count(key >= T) >= k, which is the k-th largest key itself; the count of
// keys above it falls out of the same steps.  Each step is a block-wide
// count: 8 compares a thread, a warp sum, one partial a warp in shared
// memory (two buffers, so one barrier a step suffices).  The ties at T get
// their rank in index order from an exclusive prefix of per-thread tie
// counts: a warp scan by shuffles, then the warp totals.
//
// What bounds it on an H100: bytes, at about 8 B an element in f32 (4 in
// bf16) against ~70 integer operations an element (31 compare-and-count
// steps); at small sizes the 31 dependent block-wide steps, one barrier
// each, set the time.  One CTA of 256 threads a window; a thread holds 8
// consecutive elements in registers (16-byte loads and stores).
//
// Interface: plain C, loaded with ctypes.  x and out are device addresses
// of contiguous, 16-byte aligned (nb, 2048) buffers of f32 (bf16 == 0) or
// bf16; the stream is the caller's cudaStream_t.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// arguments it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 2048;            // wire_formats.PACK_BLOCK
constexpr int kVec = 8;
constexpr int kThreads = kBlock / kVec;  // 256
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// the raw 32-bit words of 8 elements, and their f32 magnitudes as keys
__device__ __forceinline__ void load8(const float* p, uint32_t raw[kVec],
                                      uint32_t key[kVec]) {
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
  const uint4 b = __ldg(reinterpret_cast<const uint4*>(p) + 1);
  raw[0] = a.x; raw[1] = a.y; raw[2] = a.z; raw[3] = a.w;
  raw[4] = b.x; raw[5] = b.y; raw[6] = b.z; raw[7] = b.w;
#pragma unroll
  for (int j = 0; j < kVec; ++j) key[j] = raw[j] & 0x7fffffffu;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      uint32_t raw[kVec],
                                      uint32_t key[kVec]) {
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    raw[2 * i] = w[i] & 0xffffu;
    raw[2 * i + 1] = w[i] >> 16;
  }
#pragma unroll
  for (int j = 0; j < kVec; ++j) key[j] = (raw[j] << 16) & 0x7fffffffu;
}

__device__ __forceinline__ void store8(float* p, const uint32_t o[kVec]) {
  reinterpret_cast<uint4*>(p)[0] = make_uint4(o[0], o[1], o[2], o[3]);
  reinterpret_cast<uint4*>(p)[1] = make_uint4(o[4], o[5], o[6], o[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p,
                                       const uint32_t o[kVec]) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(o[0] | (o[1] << 16), o[2] | (o[3] << 16),
                 o[4] | (o[5] << 16), o[6] | (o[7] << 16));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
block_topk_kernel(const T* __restrict__ x, T* __restrict__ out, int k) {
  __shared__ int part[2][kWarps];
  __shared__ int warp_ties[kWarps];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t at = (int64_t)blockIdx.x * kBlock + kVec * t;
  uint32_t raw[kVec], key[kVec];
  load8(x + at, raw, key);

  // invariant: count(key >= lo) >= k > count(key >= hi) = above
  uint32_t lo = 0u, hi = 0x80000000u;
  int above = 0;
  for (int it = 0; it < 31; ++it) {
    const uint32_t mid = lo + ((hi - lo) >> 1);
    int c = 0;
#pragma unroll
    for (int j = 0; j < kVec; ++j) c += key[j] >= mid;
    c = warp_sum(c);
    if (lane == 0) part[it & 1][warp] = c;
    __syncthreads();
    int total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += part[it & 1][w];
    if (total >= k) {
      lo = mid;
    } else {
      hi = mid;
      above = total;
    }
  }
  // hi == lo + 1: lo is the k-th largest key, `above` keys exceed it, and
  // the first k - above keys equal to it (in index order) are kept
  const int need = k - above;
  int ties = 0;
#pragma unroll
  for (int j = 0; j < kVec; ++j) ties += key[j] == lo;
  int incl = ties;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int n = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += n;
  }
  if (lane == 31) warp_ties[warp] = incl;
  __syncthreads();
  int rank = incl - ties;
  for (int w = 0; w < warp; ++w) rank += warp_ties[w];
  uint32_t o[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    bool keep = key[j] > lo;
    if (key[j] == lo) {
      keep = rank < need;
      ++rank;
    }
    o[j] = keep ? raw[j] : 0u;
  }
  store8(out + at, o);
}

}  // namespace

extern "C" int block_topk(const void* x, int bf16, void* out, int64_t nb,
                          int k, void* stream) {
  if (nb < 1 || nb > 0x7fffffff || k < 1 || k > kBlock) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    block_topk_kernel<__nv_bfloat16><<<(unsigned)nb, kThreads, 0, s>>>(
        (const __nv_bfloat16*)x, (__nv_bfloat16*)out, k);
  } else {
    block_topk_kernel<float><<<(unsigned)nb, kThreads, 0, s>>>(
        (const float*)x, (float*)out, k);
  }
  return (int)cudaGetLastError();
}
