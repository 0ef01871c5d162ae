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
// Selection: the radix select of radix_select.cuh, which finds the k-th
// largest magnitude a digit at a time from 256-bin histograms, one barrier
// a pass, and stops early once every key that shares the digits found so
// far is kept (in f32 Gaussian windows usually after two or three passes).
// So a window takes at most 6 barriers in f32 (one to start, one a pass,
// one for the ties) and 4 in bf16, against the 32 of a 31-step bisection
// on the key with a block-wide count a step.  When the last pass still
// leaves more ties at the k-th key than fit, they get their rank in index
// order from a block-wide exclusive prefix of per-thread tie counts.
//
// What bounds it on an H100: bytes, at 8 B an element in f32 (4 in bf16),
// against ~15 integer operations an element; at a few hundred windows the
// launch and the passes' latency (atomics, a barrier, a scan) set the
// time.  One CTA of 256 threads a window; a thread holds 8 consecutive
// elements in registers (16-byte loads and stores).  One warp a window
// (64 keys a lane) was slower on the MLP's few hundred windows, its 64
// shared atomics a lane a pass one chain; so were 512 threads of 4
// elements.  ptxas: 48 registers, 8 (f32) and 12 (bf16) bytes of spill
// stores, 3,104 bytes of shared memory.
//
// Interface: plain C, loaded with ctypes.  x and out are device addresses
// of contiguous, 16-byte aligned (nb, 2048) buffers of f32 (bf16 == 0) or
// bf16; the stream is the caller's cudaStream_t.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// arguments it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "radix_select.cuh"

namespace {

using radix_select::kBins;
using radix_select::kBlock;
using radix_select::kThreads;
using radix_select::kVec;
using radix_select::kWarps;
using radix_select::Key;
using radix_select::warp_incl_scan;

// the raw bits of 8 consecutive elements (bf16 in the low 16 bits)
__device__ __forceinline__ void load8(const float* p, uint32_t raw[kVec]) {
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
  const uint4 b = __ldg(reinterpret_cast<const uint4*>(p) + 1);
  raw[0] = a.x; raw[1] = a.y; raw[2] = a.z; raw[3] = a.w;
  raw[4] = b.x; raw[5] = b.y; raw[6] = b.z; raw[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      uint32_t raw[kVec]) {
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    raw[2 * i] = w[i] & 0xffffu;
    raw[2 * i + 1] = w[i] >> 16;
  }
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
  using KT = Key<T>;
  __shared__ int4 hist4[3][kBins / 4];
  __shared__ int warp_ties[kWarps];
  int* hist = reinterpret_cast<int*>(hist4);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t at = (int64_t)blockIdx.x * kBlock + kVec * t;
  hist[t] = 0;           // the histograms of passes 0 and 1; pass 0
  hist[kBins + t] = 0;   // clears pass 2's
  uint32_t raw[kVec];
  load8(x + at, raw);
  __syncthreads();

  // the k-th largest key, a digit at a time; once eq == krem every key
  // that shares the prefix is kept, and the lower digits are not needed
  const radix_select::Found f = radix_select::select<T>(raw, k, hist4, t,
                                                        lane);
  const uint32_t prefix = f.prefix;
  const int krem = f.krem, eq = f.eq, low = f.low;
  // k - krem keys have a prefix above `prefix`; the first krem (>= 1) of
  // the eq that share it, in index order, are kept.  The branch is the
  // same in every thread.
  uint32_t o[kVec];
  if (eq == krem) {
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      o[j] = (KT::key(raw[j]) >> low) >= prefix ? raw[j] : 0u;
  } else {
    // every pass ran: prefix is the k-th largest key itself
    const uint32_t kth = prefix;
    int ties = 0;
#pragma unroll
    for (int j = 0; j < kVec; ++j) ties += KT::key(raw[j]) == kth;
    const int incl = warp_incl_scan(ties, lane);
    if (lane == 31) warp_ties[warp] = incl;
    __syncthreads();
    int rank = incl - ties;
    for (int w = 0; w < warp; ++w) rank += warp_ties[w];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const uint32_t key = KT::key(raw[j]);
      bool keep = key > kth;
      if (key == kth) {
        keep = rank < krem;
        ++rank;
      }
      o[j] = keep ? raw[j] : 0u;
    }
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
