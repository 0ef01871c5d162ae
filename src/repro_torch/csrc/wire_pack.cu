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
//   * topk_unpack: one CTA per window; the window is built in shared
//     memory and stored with 16-byte writes.
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

#include "radix_select.cuh"

namespace {

constexpr int kBlock = 2048;            // wire_formats.PACK_BLOCK
constexpr int kIters = 24;              // wire_formats.N_BISECT_ITERS
constexpr int kThreads = 256;
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
  if (nb < 1 || nb > 0x7fffffff || k < 1 || k > kBlock) {
    return (int)cudaErrorInvalidValue;
  }
  topk_pack_kernel<<<(unsigned)nb, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)rows, (__nv_bfloat16*)vals, (uint16_t*)idx, k);
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
