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
// topk_pack's threshold.  The bisection (wire_formats.bisect_threshold)
// starts from lo = 0, hi = max |x| and takes N_BISECT_ITERS steps of mid =
// 0.5 (lo + hi), lo = mid where count(|x| >= mid) >= k, else hi = mid.
// That count is >= k exactly when mid <= a_k, the k-th largest magnitude
// counted with multiplicity (if mid <= a_k the k largest are all >= mid;
// if mid > a_k at most the k - 1 above a_k are).  So the final lo is a
// function of max |x| and a_k alone, and the kernel finds a_k with the
// radix select of radix_select.cuh (a digit at a time, one barrier a pass,
// an early stop; then the smallest key of the last bucket), the max beside
// it at no extra barrier, and runs the 24 steps on two scalars: no count
// sweeps, bitwise the plain version's lo.  The first k elements with |x|
// >= lo, in index order, take their rank from a block-wide exclusive
// prefix (warp ballots and scans, then the warps' totals).
//
// What bounds them on an H100.  By bytes, the packs read 4 B (top-k) or
// 8 B (qsgd: values and noise) per element and the unpacks write 4 B per
// element; every kernel moves under 10 B per element.  At the wire's few
// hundred windows the launch and the latency of a CTA's loads, barriers
// and scans set the time.  The designs:
//   * topk_pack: one CTA of 256 threads per window, 8 consecutive elements
//     a thread in registers (two 16-byte loads); 3 to 7 barriers a window
//     (one to start, one a digit pass, typically 2 or 3 on Gaussian
//     windows, one for the bucket's minimum after an early stop, one for
//     the compaction's prefix), against 24 count sweeps of one warp before.
//     On the MLP's 280 windows the select takes about half the time, the
//     launch, loads and compaction a third, the bisection a tenth
//     (PERF.md section 6).
//   * topk_unpack: one CTA of 256 threads per window, at most 8 slots a
//     thread; the slots' loads go out before the zero-fill (two 16-byte
//     stores a thread) and its barrier, the window is built in shared
//     memory and stored with 16-byte writes.  It takes any u16 index, as
//     the reference's scatter-add does: one at or past 2048 is dropped,
//     duplicates are summed in slot order.  The barrier is a
//     __syncthreads_or of "an index is not above the previous slot's";
//     only a window whose indices are not strictly increasing (never one
//     topk_pack emits) takes the ordered path: each thread walks all k
//     slots for its own 8 elements.
//   * qsgd_pack: one CTA of 256 threads per window, 8 consecutive elements
//     a thread (two 16-byte loads); the sum of squares has a fixed order (8
//     sequential per thread, then a halving tree adding partial i + half
//     onto partial i) that qsgd_sumsq in ref.py repeats.  The tree takes
//     one barrier: its levels 128, 64 and 32 pair warp w with warps w + 4,
//     w + 2 and w + 1 lane by lane, so after the partials are stored every
//     warp reads the 8 of its lane (l + 32 j, conflict-free), adds them in
//     the tree's order, then runs levels 16 ... 1 as shuffles; each warp
//     holds the norm with no second barrier.  The fields go into words in
//     registers where a thread owns whole words (epw = 32 / bits divides
//     8: one word a thread at 7 levels, stored directly) or half a word
//     (epw 16: a shuffle joins two threads' halves); only epw 10, 6, 5 and
//     3 pass them through shared memory, behind a second barrier.
//   * qsgd_unpack: one CTA of 256 threads per window, no shared memory and
//     no barrier; thread t decodes the runs 4t ... 4t + 3 and 1024 + 4t
//     ... 1024 + 4t + 3 (a quarter word at epw 16, half a word at 8, a
//     word at 4, a uint2 at 2, one or two words at 10, 6, 5 and 3), loads
//     the window's scale once and stores float4 t and t + 256, so a warp's
//     stores are coalesced 512-byte runs: 8t ... 8t + 7 a thread (two
//     float4s 32 bytes apart) took 30.8 us to store 2^24 zeros on an
//     H100 against 22.8 (tools/unpack_ablate.py's floors).  One template
//     instance per epw, so every division by it is by a constant.
//
// Interface: plain C, loaded with ctypes.  Pointers are device addresses of
// contiguous buffers (16-byte aligned where read or written as vectors);
// the stream is the caller's cudaStream_t.  Each entry point returns
// cudaGetLastError() after its launch, or cudaErrorInvalidValue for
// arguments it does not take.  Indices are int16 on the PyTorch side (u16
// bit patterns; topk_pack emits them strictly increasing, below 2048) and
// code words int32 (u32 bit patterns).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "radix_select.cuh"

namespace {

constexpr int kBlock = 2048;            // wire_formats.PACK_BLOCK
constexpr int kIters = 24;              // wire_formats.N_BISECT_ITERS
constexpr int kThreads = 256;
constexpr int kSlots = kBlock / kThreads;   // topk_unpack's slots a thread
constexpr unsigned kFull = 0xffffffffu;
static_assert(kThreads == radix_select::kThreads, "one CTA a window");

__global__ void __launch_bounds__(kThreads)
topk_pack_kernel(const float* __restrict__ rows,
                 __nv_bfloat16* __restrict__ vals,
                 uint16_t* __restrict__ idx, int k) {
  using radix_select::kBins;
  using radix_select::kVec;
  using radix_select::kWarps;
  using KT = radix_select::Key<float>;
  __shared__ int4 hist4[3][kBins / 4];
  __shared__ uint32_t warp_max[kWarps];
  __shared__ uint32_t warp_min[kWarps];
  __shared__ int warp_keep[kWarps];
  int* hist = reinterpret_cast<int*>(hist4);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t w = blockIdx.x;
  hist[t] = 0;           // the select's first two histograms
  hist[kBins + t] = 0;
  const uint4* src = reinterpret_cast<const uint4*>(rows + w * kBlock) + 2 * t;
  const uint4 a = __ldg(src), b = __ldg(src + 1);
  const uint32_t raw[kVec] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  // the largest key, published at the select's first barrier
  uint32_t top = 0u;
#pragma unroll
  for (int j = 0; j < kVec; ++j) top = max(top, KT::key(raw[j]));
  top = __reduce_max_sync(kFull, top);
  if (lane == 0) warp_max[warp] = top;
  __syncthreads();

  const radix_select::Found f =
      radix_select::select<float>(raw, k, hist4, t, lane);
  uint32_t kth = f.prefix;   // every pass ran: the digits are the whole key
  if (f.eq == f.krem && f.low > 0) {
    // an early stop: the k-th largest key is the smallest of the bucket
    // (the keys that share the prefix), all of which rank within k
    uint32_t m = 0xffffffffu;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const uint32_t key = KT::key(raw[j]);
      if ((key >> f.low) == f.prefix) m = min(m, key);
    }
    m = __reduce_min_sync(kFull, m);
    if (lane == 0) warp_min[warp] = m;
    __syncthreads();
    kth = warp_min[0];
#pragma unroll
    for (int i = 1; i < kWarps; ++i) kth = min(kth, warp_min[i]);
  }
  top = warp_max[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) top = max(top, warp_max[i]);

  // the bisection on two scalars: count(|x| >= mid) >= k iff mid <= a_k
  const float a_k = __uint_as_float(kth);
  float lo = 0.0f, hi = __uint_as_float(top);
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    if (mid <= a_k) {
      lo = mid;
    } else {
      hi = mid;
    }
  }

  // compaction in index order: rank = survivors at lower indices
  bool keep[kVec];
  int cnt = 0;
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    keep[j] = __uint_as_float(KT::key(raw[j])) >= lo;
    cnt += keep[j];
  }
  const int incl = radix_select::warp_incl_scan(cnt, lane);
  if (lane == 31) warp_keep[warp] = incl;
  __syncthreads();
  int rank = incl - cnt;
  for (int i = 0; i < warp; ++i) rank += warp_keep[i];
  __nv_bfloat16* v_out = vals + w * k;
  uint16_t* i_out = idx + w * k;
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    if (keep[j] && rank < k) {
      v_out[rank] = __float2bfloat16_rn(__uint_as_float(raw[j]));
      i_out[rank] = (uint16_t)(kVec * t + j);
    }
    rank += keep[j];
  }
}

__global__ void __launch_bounds__(kThreads)
topk_unpack_kernel(const __nv_bfloat16* __restrict__ vals,
                   const uint16_t* __restrict__ idx, float* __restrict__ out,
                   int k) {
  __shared__ __align__(16) float win[kBlock];
  const int t = threadIdx.x;
  const int64_t w = blockIdx.x;
  const uint16_t* ix = idx + w * k;
  const uint16_t* vb = reinterpret_cast<const uint16_t*>(vals) + w * k;
  // the loads of the thread's slots t + 256 i first: their latency hides
  // behind the zero-fill and the barrier; a slot past k reads as index
  // kBlock (dropped).  Each slot's index is compared with the previous
  // slot's (a shuffle from the lane below): strictly increasing indices
  // are distinct.
  uint32_t j[kSlots], v[kSlots], prev[kSlots];
  const int lane = t & 31;
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const int r = t + i * kThreads;
    j[i] = kBlock;
    v[i] = 0u;
    prev[i] = 0u;
    if (r < k) {
      j[i] = __ldg(ix + r);
      v[i] = __ldg(vb + r);
      // slot r - 1 is the lane below's, or the warp below's last lane's
      if (lane == 0 && r > 0) prev[i] = __ldg(ix + r - 1);
    }
  }
  bool unordered = false;
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const int r = t + i * kThreads;
    const uint32_t below = __shfl_up_sync(kFull, j[i], 1);
    if (lane > 0) prev[i] = below;
    if (r > 0 && r < k) unordered |= prev[i] >= j[i];
  }
  float4* win4 = reinterpret_cast<float4*>(win);
  float4* dst = reinterpret_cast<float4*>(out + w * kBlock);
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  win4[t] = zero;
  win4[t + kThreads] = zero;
  if (!__syncthreads_or(unordered)) {
    // distinct indices (every window topk_pack emits): no two slots write
    // one element; the add onto +0 is the reference's scatter-add (it
    // turns -0 into +0); an index at or past kBlock is dropped
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      if (j[i] < kBlock) {
        win[j[i]] = __fadd_rn(0.0f, __uint_as_float(v[i] << 16));
      }
    }
    __syncthreads();
    dst[t] = win4[t];
    dst[t + kThreads] = win4[t + kThreads];
    return;
  }
  // a repeated or decreasing index somewhere in the window: the slots go
  // to shared memory as (index << 16 | bf16 bits), and thread t walks all k
  // in slot order, adding those for its elements 8t ... 8t + 7 onto +0, so
  // duplicates sum in the plain version's order; slow, but no path of the
  // port sends such a window
  uint32_t* pair = reinterpret_cast<uint32_t*>(win);
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const int r = t + i * kThreads;
    if (r < k) pair[r] = (j[i] << 16) | v[i];
  }
  __syncthreads();
  // every sum starts at +0 and so is never -0: adding +0 to it is exact,
  // which keeps the 8 sums in registers (a select, no indexed store)
  float acc[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int r = 0; r < k; ++r) {
    const uint32_t p = pair[r];
    // index >> 3 is the owner: an index past kBlock has none
    const bool mine = (p >> 19) == (uint32_t)t;
    const uint32_t at = (p >> 16) & 7u;
    const float x = __uint_as_float(p << 16);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      acc[e] = __fadd_rn(acc[e], mine && at == (uint32_t)e ? x : 0.0f);
    }
  }
  dst[2 * t] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  dst[2 * t + 1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
}

// EPW: elements a word where a thread builds its words in registers (8, 4
// or 2: 8 / EPW whole words a thread; 16: half a word), 0 for any other
// epw (through shared memory).
template <int EPW>
__global__ void __launch_bounds__(kThreads)
qsgd_pack_kernel(const float* __restrict__ rows,
                 const float* __restrict__ noise,
                 uint32_t* __restrict__ words_out,
                 float* __restrict__ scale_out, int levels, int bits, int epw,
                 int nwords, float denom) {
  static_assert(kThreads == 256 && kBlock == 8 * kThreads,
                "8 elements a thread; the tree's first three levels pair "
                "the 8 warps");
  __shared__ float part[kThreads];
  const int64_t w = blockIdx.x;
  const int t = threadIdx.x, lane = t & 31;
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
  // levels 128, 64, 32 of the tree for lane l's column: p_j = part[l + 32j]
  // -> ((p0 + p4) + (p2 + p6)) + ((p1 + p5) + (p3 + p7)); then 16 ... 1
  const float* p = part + lane;
  float sum = __fadd_rn(__fadd_rn(__fadd_rn(p[0], p[128]),
                                  __fadd_rn(p[64], p[192])),
                        __fadd_rn(__fadd_rn(p[32], p[160]),
                                  __fadd_rn(p[96], p[224])));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sum = __fadd_rn(sum, __shfl_down_sync(kFull, sum, off));
  }
  sum = __shfl_sync(kFull, sum, 0);
  // 1e-30 as the reference rounds it: a double, then to f32
  const float norm = __fadd_rn(__fsqrt_rn(sum), (float)1e-30);
  const float lv = (float)levels;
  uint32_t f[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float y = __fmul_rn(__fdiv_rn(fabsf(x[j]), norm), lv);
    const float lo = floorf(y);
    const float code = __fadd_rn(lo, u[j] < __fsub_rn(y, lo) ? 1.0f : 0.0f);
    f[j] = (uint32_t)code | ((x[j] < 0.0f ? 1u : 0u) << (bits - 1));
  }
  uint32_t* out = words_out + w * nwords;
  if constexpr (EPW == 8 || EPW == 4 || EPW == 2) {
    // words 8t / EPW ... of the window: the thread's own
    constexpr int kPer = 8 / EPW;
    uint32_t wd[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      wd[k] = 0u;
#pragma unroll
      for (int e = 0; e < EPW; ++e) wd[k] |= f[k * EPW + e] << (bits * e);
    }
    if constexpr (kPer == 1) {
      out[t] = wd[0];
    } else if constexpr (kPer == 2) {
      reinterpret_cast<uint2*>(out)[t] = make_uint2(wd[0], wd[1]);
    } else {
      reinterpret_cast<uint4*>(out)[t] =
          make_uint4(wd[0], wd[1], wd[2], wd[3]);
    }
  } else if constexpr (EPW == 16) {
    // word t / 2: the even thread's fields low, the odd thread's high
    uint32_t half = 0u;
#pragma unroll
    for (int e = 0; e < 8; ++e) half |= f[e] << (bits * e);
    const uint32_t high = __shfl_down_sync(kFull, half, 1);
    if ((t & 1) == 0) out[t >> 1] = half | (high << (bits * 8));
  } else {
    __shared__ __align__(16) uint32_t field[kBlock];
    uint4* mine = reinterpret_cast<uint4*>(field) + 2 * t;
    mine[0] = make_uint4(f[0], f[1], f[2], f[3]);
    mine[1] = make_uint4(f[4], f[5], f[6], f[7]);
    __syncthreads();
    for (int i = t; i < nwords; i += kThreads) {
      uint32_t word = 0;
      for (int e = 0; e < epw; ++e) {
        const int el = i * epw + e;
        if (el < kBlock) word |= field[el] << (bits * e);
      }
      out[i] = word;
    }
  }
  if (t == 0) scale_out[w] = __fdiv_rn(norm, denom);
}

// EPW: fields a word, 32 / bits; every division by it is by a constant.
// Thread t decodes and stores float4 t and t + 256 of its window, the runs
// of elements 4t ... 4t + 3 and 1024 + 4t ... 1024 + 4t + 3, so each of a
// warp's two stores is one coalesced 512-byte run.
template <int EPW>
__global__ void __launch_bounds__(kThreads)
qsgd_unpack_kernel(const uint32_t* __restrict__ words,
                   const float* __restrict__ scale, float* __restrict__ out,
                   int bits, int nwords) {
  static_assert(kBlock == 8 * kThreads, "two runs of 4 elements a thread");
  const int64_t w = blockIdx.x;
  const int t = threadIdx.x;
  const uint32_t* row = words + w * nwords;
  const float sc = __ldg(scale + w);
  uint32_t f[2][4];   // each run's fields shifted to bit 0, unmasked
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const int e0 = 4 * t + (kBlock / 2) * g;   // the run's first element
    if constexpr (EPW == 2) {          // words e0 / 2, e0 / 2 + 1: a uint2
      const uint2 wd = __ldg(reinterpret_cast<const uint2*>(row + e0 / 2));
      f[g][0] = wd.x;
      f[g][1] = wd.x >> bits;
      f[g][2] = wd.y;
      f[g][3] = wd.y >> bits;
    } else if constexpr (EPW % 4 == 0) {   // 16, 8, 4: within one word
      const uint32_t wd = __ldg(row + e0 / EPW) >> (bits * (e0 % EPW));
#pragma unroll
      for (int e = 0; e < 4; ++e) f[g][e] = wd >> (bits * e);
    } else {   // 10, 6, 5, 3: the run straddles one or two words
      const int first = e0 / EPW;
      const int s = e0 - first * EPW;   // element e0's field in `first`
      const uint32_t lo = __ldg(row + first);
      const uint32_t hi = s + 3 >= EPW ? __ldg(row + first + 1) : 0u;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = s + e;
        f[g][e] = p < EPW ? lo >> (bits * p) : hi >> (bits * (p - EPW));
      }
    }
  }
  // the plain version's steps in its order: code, sign, (sgn * code) * scale
  const uint32_t field_mask = (1u << bits) - 1u;
  const uint32_t mag_mask = (1u << (bits - 1)) - 1u;
  float4* dst = reinterpret_cast<float4*>(out + w * kBlock);
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    float y[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t fe = f[g][e] & field_mask;
      const float code = (float)(fe & mag_mask);
      const float sgn =
          __fsub_rn(1.0f, __fmul_rn(2.0f, (float)(fe >> (bits - 1))));
      y[e] = __fmul_rn(__fmul_rn(sgn, code), sc);
    }
    dst[t + kThreads * g] = make_float4(y[0], y[1], y[2], y[3]);
  }
}

inline bool qsgd_layout_ok(int bits, int epw, int nwords) {
  return bits >= 2 && bits <= 16 && epw == 32 / bits &&
         nwords == (kBlock + epw - 1) / epw;
}

}  // namespace

extern "C" int topk_pack(const void* rows, void* vals, void* idx, int64_t nb,
                         int k, void* stream) {
  if (nb < 1 || nb > 0x7fffffff || k < 1 || k > kBlock) {
    return (int)cudaErrorInvalidValue;
  }
  topk_pack_kernel<<<(unsigned)nb, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)rows, (__nv_bfloat16*)vals, (uint16_t*)idx, k);
  return (int)cudaGetLastError();
}

extern "C" int topk_unpack(const void* vals, const void* idx, void* out,
                           int64_t nb, int k, void* stream) {
  if (nb < 1 || nb > 0x7fffffff || k < 1 || k > kBlock) {
    return (int)cudaErrorInvalidValue;
  }
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
  const float* x = (const float*)rows;
  const float* u = (const float*)noise;
  uint32_t* wd = (uint32_t*)words;
  float* sc = (float*)scale;
  cudaStream_t s = (cudaStream_t)stream;
  switch (epw) {
    case 8:
      qsgd_pack_kernel<8><<<(unsigned)nb, kThreads, 0, s>>>(
          x, u, wd, sc, levels, bits, epw, nwords, denom);
      break;
    case 4:
      qsgd_pack_kernel<4><<<(unsigned)nb, kThreads, 0, s>>>(
          x, u, wd, sc, levels, bits, epw, nwords, denom);
      break;
    case 2:
      qsgd_pack_kernel<2><<<(unsigned)nb, kThreads, 0, s>>>(
          x, u, wd, sc, levels, bits, epw, nwords, denom);
      break;
    case 16:
      qsgd_pack_kernel<16><<<(unsigned)nb, kThreads, 0, s>>>(
          x, u, wd, sc, levels, bits, epw, nwords, denom);
      break;
    default:
      qsgd_pack_kernel<0><<<(unsigned)nb, kThreads, 0, s>>>(
          x, u, wd, sc, levels, bits, epw, nwords, denom);
  }
  return (int)cudaGetLastError();
}

extern "C" int qsgd_unpack(const void* words, const void* scale, void* out,
                           int64_t nb, int bits, int epw, int nwords,
                           void* stream) {
  if (nb < 1 || nb > 0x7fffffff || !qsgd_layout_ok(bits, epw, nwords)) {
    return (int)cudaErrorInvalidValue;
  }
  const uint32_t* wd = (const uint32_t*)words;
  const float* sc = (const float*)scale;
  float* y = (float*)out;
  const unsigned grid = (unsigned)nb;   // one CTA a window
  cudaStream_t s = (cudaStream_t)stream;
  switch (epw) {
    case 16:
      qsgd_unpack_kernel<16><<<grid, kThreads, 0, s>>>(
          wd, sc, y, bits, nwords);
      break;
    case 10:
      qsgd_unpack_kernel<10><<<grid, kThreads, 0, s>>>(
          wd, sc, y, bits, nwords);
      break;
    case 8:
      qsgd_unpack_kernel<8><<<grid, kThreads, 0, s>>>(
          wd, sc, y, bits, nwords);
      break;
    case 6:
      qsgd_unpack_kernel<6><<<grid, kThreads, 0, s>>>(
          wd, sc, y, bits, nwords);
      break;
    case 5:
      qsgd_unpack_kernel<5><<<grid, kThreads, 0, s>>>(
          wd, sc, y, bits, nwords);
      break;
    case 4:
      qsgd_unpack_kernel<4><<<grid, kThreads, 0, s>>>(
          wd, sc, y, bits, nwords);
      break;
    case 3:
      qsgd_unpack_kernel<3><<<grid, kThreads, 0, s>>>(
          wd, sc, y, bits, nwords);
      break;
    default:
      qsgd_unpack_kernel<2><<<grid, kThreads, 0, s>>>(
          wd, sc, y, bits, nwords);
  }
  return (int)cudaGetLastError();
}
