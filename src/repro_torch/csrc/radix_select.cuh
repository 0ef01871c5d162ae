// The k-th largest magnitude of a 2048-element window, found by one CTA of
// 256 threads with a radix select: shared by block_topk.cu (keep the k
// largest) and wire_pack.cu's topk_pack (the bisection threshold, which is
// a function of the window's largest and k-th largest magnitudes alone).
//
// |x| is ordered as the integer key bits(x) & 0x7fffffff (f32) or bits(x) &
// 0x7fff (bf16).  The k-th largest key is found a digit at a time, most
// significant first (f32: bits 30-23, 22-15, 14-7, 6-0; bf16: 14-7, 6-0).
// In each pass every thread adds the digits of its keys that match the
// digits found so far into a 256-bin histogram in shared memory
// (shared-memory atomics); after one __syncthreads every warp reads the
// whole histogram and finds, by a warp prefix over the bins from the top (a
// lane sums 8 bins, then a shuffle scan), the bin where the count reaches
// the rank still sought; the counts above it are keys known to be larger.  The passes stop early once every key that shares the
// digits found so far is wanted (in f32 Gaussian windows usually after two
// or three): at most one barrier a pass.  Three histograms in turn let a
// pass clear the one of two passes later without a second barrier.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace radix_select {

constexpr int kBlock = 2048;             // wire_formats.PACK_BLOCK
constexpr int kVec = 8;                  // consecutive elements a thread
constexpr int kThreads = kBlock / kVec;  // 256
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;               // == kThreads: a bin a thread
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct Key;

template <>
struct Key<float> {
  static constexpr int kPasses = 4;
  static constexpr int kTop = 31;   // key bits
  // digit `pass`: bits [shift, shift + width)
  __host__ __device__ static constexpr int shift(int pass) {
    return pass == 0 ? 23 : pass == 1 ? 15 : pass == 2 ? 7 : 0;
  }
  __host__ __device__ static constexpr int width(int pass) {
    return pass == 3 ? 7 : 8;
  }
  __device__ static uint32_t key(uint32_t raw) { return raw & 0x7fffffffu; }
};

template <>
struct Key<__nv_bfloat16> {
  static constexpr int kPasses = 2;
  static constexpr int kTop = 15;
  __host__ __device__ static constexpr int shift(int pass) {
    return pass == 0 ? 7 : 0;
  }
  __host__ __device__ static constexpr int width(int pass) {
    return pass == 0 ? 8 : 7;
  }
  __device__ static uint32_t key(uint32_t raw) { return raw & 0x7fffu; }
};

__device__ __forceinline__ int warp_incl_scan(int v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int n = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += n;
  }
  return v;
}

// What the select found, the same in every thread: `prefix` holds the
// digits found (the key's bits from `low` up), `krem` the rank still
// sought among the keys that share them (k - krem keys have a larger
// prefix), `eq` how many keys share them.  eq == krem: the passes stopped
// because every key that shares the prefix is wanted, and the k-th largest
// key is the smallest of them; else every pass ran and `prefix` is the
// k-th largest key itself.
struct Found {
  uint32_t prefix;
  int krem, eq, low;
};

// The k-th largest key (1 <= k <= 2048) of the CTA's raw elements, kVec a
// thread (bf16 in the low 16 bits).  hist4 is [3][kBins / 4] in shared
// memory; the caller zeroes the first two histograms (hist[t] and
// hist[kBins + t] in thread t) and passes a __syncthreads before the call.
template <typename T>
__device__ __forceinline__ Found select(const uint32_t (&raw)[kVec], int k,
                                        int4 (*hist4)[kBins / 4], int t,
                                        int lane) {
  using KT = Key<T>;
  int* hist = reinterpret_cast<int*>(hist4);
  uint32_t prefix = 0u;
  int krem = k, eq = 0, low = KT::kTop;
#pragma unroll
  for (int pass = 0; pass < KT::kPasses; ++pass) {
    const int shift = KT::shift(pass);
    const int high = shift + KT::width(pass);
    const uint32_t mask = (1u << KT::width(pass)) - 1u;
    int* hb = hist + (pass % 3) * kBins;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const uint32_t key = KT::key(raw[j]);
      if (high >= KT::kTop || (key >> high) == prefix) {
        atomicAdd(hb + ((key >> shift) & mask), 1);
      }
    }
    __syncthreads();
    // every reader of pass - 1's histogram passed the barrier above
    hist[((pass + 2) % 3) * kBins + t] = 0;
    // this lane's bins, from the top: 255 - 8 lane - v
    const int4 lo = hist4[pass % 3][(kBins - 8 - 8 * lane) / 4];
    const int4 hi = hist4[pass % 3][(kBins - 4 - 8 * lane) / 4];
    const int c[8] = {hi.w, hi.z, hi.y, hi.x, lo.w, lo.z, lo.y, lo.x};
    int sum = 0;
#pragma unroll
    for (int v = 0; v < 8; ++v) sum += c[v];
    const int incl = warp_incl_scan(sum, lane);
    const int excl = incl - sum;
    const unsigned hit = __ballot_sync(kFull, excl < krem && krem <= incl);
    const int src = __ffs(hit) - 1;
    int digit = 0, run = excl, cnt = 0;
    bool found = false;
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      if (!found && run + c[v] >= krem) {
        digit = kBins - 1 - 8 * lane - v;
        cnt = c[v];
        found = true;
      } else if (!found) {
        run += c[v];
      }
    }
    digit = __shfl_sync(kFull, digit, src);
    run = __shfl_sync(kFull, run, src);
    eq = __shfl_sync(kFull, cnt, src);
    krem -= run;
    prefix = (prefix << KT::width(pass)) | (uint32_t)digit;
    low = shift;
    if (eq == krem) break;
  }
  return Found{prefix, krem, eq, low};
}

}  // namespace radix_select
