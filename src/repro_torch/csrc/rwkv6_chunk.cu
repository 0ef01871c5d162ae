// RWKV6 (Finch) chunked linear-attention scan for Hopper (sm_90a), on the
// tensor cores.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv6_chunk.py::
// rwkv6_chunk (pallas_call at :90, body _kernel at :42-78).  Per (b, h)
// pair it walks the S / 16 chunks in order, the (N, N) f32 state kept on
// chip across chunks, and in each chunk computes, with la the chunk-local
// inclusive cumsum of log w and la_prev = la - lw:
//
//   rq   = r * exp(la_prev)       kk = k * exp(-la)
//   kend = k * exp(la_end - la)
//   o    = tril_{-1}(rq kk^T) v + (sum_n r u k) v + rq S
//   S   <- S * exp(la_end)^T + kend^T v
//
// which is what src/repro_torch/kernels/ref.py::rwkv6_chunk_ref computes.
// r, k and v are bf16 (the serving path's dense outputs) or f32; log w, u
// and the state are f32.  The chunk of 16 is structurally one 16-row block
// of ssd_chunk.cu (r ~ C, k ~ B, v ~ xh, with a per-channel decay), and the
// kernel reuses that design and its helpers (mma_sm90.cuh).
//
// What bounds it on an H100.  At the serving path's (B, S, H, N) = (4,
// 512, 64, 64) with bf16 r, k, v it must move about 126 MB (r, k, v 8.4 MB
// each, log w 33.6 MB, o 33.6 MB, the state in and out 4.2 MB each): 37.6
// us at 3.35 TB/s, against ~2.6 GFLOP, 15.8 us as three TF32 passes on the
// tensor cores, so the bytes bound it.  In practice the chain of latencies
// of one CTA walking 32 chunks in order sets the time: the serving shape's
// 256 CTAs fill the card once at 2 an SM, 8 warps an SM.  On an NVIDIA
// H100 80GB HBM3 at 700 W it takes 93.0 us there (2.5x the bound), 108.8
// with f32 r, k, v, and 512.9 at 2 x 4096 tokens, whose 128 CTAs leave one
// an SM (chip_smoke.py, tools/kernel_ab.py).
//
// Design.  One CTA owns one (b, h) pair and all N value columns, N' / 16
// warps for the instance width N' (16, 32 or 64): r, k and log w are read
// once and every exp is done once.  Warp w owns the columns j in [16 w, 16
// w + 16) of o and the rows j of the state kept transposed, S^T[j][n], in
// its mma accumulator fragments all along the sequence.  In that layout
// the accumulators are, unchanged, the B operand of rq S (depth n, columns
// j), so the state never goes through shared memory.  Per chunk:
//
//   1. elementwise, shared by the warps (f32): la in sequence order (one
//      thread runs a column pair down the 16 rows: bitwise the plain
//      version's sequential f32 adds), rq, kk, kend with expf, the u-bonus
//      terms p = r u k and the decay exp(la_end); each written to shared
//      memory as its two bf16 parts (hi + lo, 16 significant bits), and v
//      too when it is f32;
//   2. per warp, on the tensor cores (mma.sync.m16n8k16, bf16 parts, f32
//      accumulation): M = rq kk^T (16 x 16, K = N', hi.hi + hi.lo +
//      lo.hi), of which only the strictly lower entries are kept: kk
//      reaches e^80, so an entry above the diagonal may overflow where the
//      reference's multiply-then-mask would give NaN, and where the
//      reference is finite the two agree; its diagonal set to the bonus
//      sum_n p (p times a vector of ones, hi + lo); then o = M v (M's
//      accumulators are, pair by pair, the A fragment of the product; v
//      exact in bf16, or split too and all four products of the parts
//      taken) + rq S (hi.hi + hi.lo + lo.hi, S split from its
//      accumulators), stored from the fragments;
//      then S^T <- S^T diag(exp(la_end)) + v^T kend (the v fragments of M v
//      are also, reordered, the A fragment of v^T; kend hi + lo).
//
// Precision.  The plain version is f32 throughout and the gate is 1e-4
// normwise; the plan above, emulated on the CPU
// (tests/test_torch_rwkv6.py), stays within 1.5e-5 normwise of the
// reference's jnp chunked form in every tested case, bf16 and f32 r, k, v,
// log w at the clamp (-5) included, whether or not the tensor cores flush
// bf16 subnormals (the second part of rq falls below bf16's smallest
// normal only where |r| e^-75 is, which moves o by nothing visible).
//
// Loads and barriers.  Shared memory holds three stages of a chunk's r, k,
// v and log w, filled with cp.async two chunks ahead, and two buffers of
// the elementwise results.  One __syncthreads a chunk: after it, a warp
// runs the products of chunk c from buffer c % 2, then the elementwise part
// of chunk c + 1 into the other buffer (whose last reader, chunk c - 1,
// finished before the barrier).  Tiles are [16][N'] with their 16-byte
// chunks XOR-swizzled by row, so the ldmatrix loads are free of bank
// conflicts.  N is rounded up to N'; the padded channels are zero-filled
// (r = k = 0 and log w = 0 keep those state rows at zero: decay e^0 = 1,
// outer product 0; v = 0 gives columns of o and of the state that are 0 and
// are never written back).  Rows that are not 16-byte multiples load
// element by element.  At N' = 64: 128 threads and 64,000 B of shared
// memory (90,624 B with f32 r, k, v), 2 CTAs an SM.
// ptxas (tools/kernel_ab.py --ptxas): 250 registers and no spill at the
// serving instance (bf16, N' = 64); 252 with f32 r, k, v; 168 with 12
// bytes of spill stores at N' = 32; 147 (bf16) and 166 (f32) at N' = 16.
//
// Interface: plain C, loaded with ctypes.  Pointers are device addresses
// of contiguous buffers; the stream is the caller's cudaStream_t.  The
// entry point returns cudaErrorInvalidValue for shapes it does not take (N
// outside [1, 64], S not a positive multiple of 16), else
// cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

using namespace mma_sm90;

constexpr int kC = 16;          // chunk length: kernels/ref.py RWKV_CHUNK
constexpr uint32_t kOnes = 0x3f803f80u;   // a bf16 pair (1, 1)

// shared-memory planes of the elementwise buffer, [16][NW] bf16 each
enum Plane { kRqHi, kRqLo, kKkHi, kKkLo, kKeHi, kKeLo, kPHi, kPLo, kVHi, kVLo };

template <typename T, int NW>
struct Cfg {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int kWarps = NW / 16;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kStages = 3;
  static constexpr int kE = 16 / (int)sizeof(T);     // elements a 16-B chunk
  static constexpr int kCpr = NW / kE;               // chunks a row of r / k / v
  static constexpr int kRaw = kC * NW * (int)sizeof(T);   // bytes of r, k or v
  static constexpr int kStage = 3 * kRaw + kC * NW * 4;   // r, k, v, log w
  static constexpr int kPlane = kC * NW * 2;
  static constexpr int kPlanes = kF32 ? 10 : 8;
  static constexpr int kBuf = kPlanes * kPlane + NW * 4;  // planes, decay
  static constexpr int kBufOff = kStages * kStage;
  static constexpr int kSmem = kBufOff + 2 * kBuf;
};

// element offset of (t, n) in a [16][NW] tile of 16-byte chunks of E
// elements, swizzled by row
template <int NW, int E>
__device__ __forceinline__ int off(int t, int n) {
  return swz<NW / E>(t, n / E) * E + n % E;
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <typename T, int NW>
__global__ void __launch_bounds__(Cfg<T, NW>::kThreads)
rwkv6_chunk_kernel(const T* __restrict__ r, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ logw,
                   const float* __restrict__ u, const float* __restrict__ s0,
                   float* __restrict__ o, float* __restrict__ s_fin, int S,
                   int H, int N, int vec_rkv, int vec_w) {
  using K = Cfg<T, NW>;
  constexpr int kNt = NW / 8;     // state column tiles (n)
  constexpr int kNk = NW / 16;    // k16 steps over n
  constexpr int kPairs = NW / 2;  // column pairs of the elementwise part
  extern __shared__ float4 smem4[];
  char* sm = reinterpret_cast<char*>(smem4);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r4 = lane >> 2, q = lane & 3;
  const int j0 = 16 * warp;                 // this warp's columns of o
  const int n0 = 2 * (tid % kPairs);        // elementwise: columns n0, n0 + 1
  const int rg = tid / kPairs;              // and rows 4 rg .. 4 rg + 3
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int64_t stride_t = (int64_t)H * N;
  const int64_t row0 = ((int64_t)b * S * H + h) * N;   // (b, t = 0, h, 0)
  const int64_t state0 = (int64_t)bh * N * N;

  // chunk ci's r, k, v and log w into stage st
  auto copy_chunk = [&](int ci, int st) {
    char* base = sm + st * K::kStage;
    const int64_t c0 = row0 + (int64_t)ci * kC * stride_t;
    if (vec_rkv) {
      for (int it = tid; it < 3 * kC * K::kCpr; it += K::kThreads) {
        const int m = it / (kC * K::kCpr), rem = it % (kC * K::kCpr);
        const int t = rem / K::kCpr, ch = rem % K::kCpr;
        const int bytes = ch * K::kE < N ? 16 : 0;
        const T* src = (m == 0 ? r : m == 1 ? k : v) + c0 + t * stride_t +
                       ch * K::kE;
        T* dst = reinterpret_cast<T*>(base + m * K::kRaw);
        cp_async16(dst + swz<K::kCpr>(t, ch) * K::kE, bytes ? src : r, bytes);
      }
    } else {
      for (int it = tid; it < 3 * kC * NW; it += K::kThreads) {
        const int m = it / (kC * NW), rem = it % (kC * NW);
        const int t = rem / NW, n = rem % NW;
        const T* src = (m == 0 ? r : m == 1 ? k : v) + c0 + t * stride_t + n;
        T* dst = reinterpret_cast<T*>(base + m * K::kRaw) + off<NW, K::kE>(t, n);
        if (K::kF32) {
          cp_async4(dst, n < N ? static_cast<const void*>(src) : r,
                    n < N ? 4 : 0);
        } else {
          *dst = n < N ? src[0] : T(0.0f);
        }
      }
    }
    float* ws = reinterpret_cast<float*>(base + 3 * K::kRaw);
    if (vec_w) {
      constexpr int kCprW = NW / 4;
      for (int it = tid; it < kC * kCprW; it += K::kThreads) {
        const int t = it / kCprW, ch = it % kCprW;
        const int bytes = ch * 4 < N ? 16 : 0;
        cp_async16(ws + swz<kCprW>(t, ch) * 4,
                   bytes ? logw + c0 + t * stride_t + ch * 4 : logw, bytes);
      }
    } else {
      for (int it = tid; it < kC * NW; it += K::kThreads) {
        const int t = it / NW, n = it % NW;
        cp_async4(ws + off<NW, 4>(t, n),
                  n < N ? logw + c0 + t * stride_t + n : logw, n < N ? 4 : 0);
      }
    }
    cp_async_commit();
  };

  // u at this thread's elementwise columns (0 in the padding)
  const float2 uu = make_float2(n0 < N ? u[(int64_t)h * N + n0] : 0.0f,
                                n0 + 1 < N ? u[(int64_t)h * N + n0 + 1] : 0.0f);

  // the elementwise part of the chunk in stage st, into buffer bi
  auto elementwise = [&](int st, int bi) {
    const char* base = sm + st * K::kStage;
    const T* rs = reinterpret_cast<const T*>(base);
    const T* ks = reinterpret_cast<const T*>(base + K::kRaw);
    const T* vs = reinterpret_cast<const T*>(base + 2 * K::kRaw);
    const float* ws = reinterpret_cast<const float*>(base + 3 * K::kRaw);
    char* buf = sm + K::kBufOff + bi * K::kBuf;
    uint32_t* pl = reinterpret_cast<uint32_t*>(buf);   // bf16 pairs
    float* dec = reinterpret_cast<float*>(buf + K::kPlanes * K::kPlane);
    // la down the chunk in sequence order, as the plain version adds
    float2 acc = make_float2(0.0f, 0.0f);
    for (int t = 0; t < 4 * rg; ++t) {
      const float2 w = load2(ws + off<NW, 4>(t, n0));
      acc.x = acc.x + w.x;
      acc.y = acc.y + w.y;
    }
    float2 la[4], lw[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      lw[i] = load2(ws + off<NW, 4>(4 * rg + i, n0));
      acc.x = acc.x + lw[i].x;
      acc.y = acc.y + lw[i].y;
      la[i] = acc;
    }
    for (int t = 4 * rg + 4; t < kC; ++t) {
      const float2 w = load2(ws + off<NW, 4>(t, n0));
      acc.x = acc.x + w.x;
      acc.y = acc.y + w.y;
    }
    const float2 le = acc;   // la_end
    if (rg == 0) {
      dec[n0] = expf(le.x);
      dec[n0 + 1] = expf(le.y);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = 4 * rg + i;
      const float2 rr = load2(rs + off<NW, K::kE>(t, n0));
      const float2 kv = load2(ks + off<NW, K::kE>(t, n0));
      const float rq0 = rr.x * expf(la[i].x - lw[i].x);
      const float rq1 = rr.y * expf(la[i].y - lw[i].y);
      const float kk0 = kv.x * expf(-la[i].x);
      const float kk1 = kv.y * expf(-la[i].y);
      const float ke0 = kv.x * expf(le.x - la[i].x);
      const float ke1 = kv.y * expf(le.y - la[i].y);
      const float p0 = rr.x * uu.x * kv.x;
      const float p1 = rr.y * uu.y * kv.y;
      const int wd = off<NW, 8>(t, n0) / 2;   // word of (t, n0) in a plane
      constexpr int kWords = K::kPlane / 4;
      split2(rq0, rq1, pl[kRqHi * kWords + wd], pl[kRqLo * kWords + wd]);
      split2(kk0, kk1, pl[kKkHi * kWords + wd], pl[kKkLo * kWords + wd]);
      split2(ke0, ke1, pl[kKeHi * kWords + wd], pl[kKeLo * kWords + wd]);
      split2(p0, p1, pl[kPHi * kWords + wd], pl[kPLo * kWords + wd]);
      if (K::kF32) {
        const float2 vv = load2(vs + off<NW, K::kE>(t, n0));
        split2(vv.x, vv.y, pl[kVHi * kWords + wd], pl[kVLo * kWords + wd]);
      }
    }
  };

  const int n_chunks = S / kC;
  copy_chunk(0, 0);
  if (n_chunks > 1) {
    copy_chunk(1, 1);
  } else {
    cp_async_commit();   // an empty group keeps the count of the wait below
  }

  // the state S^T: st[nt] is the accumulator fragment of rows (value
  // columns) j0 + r4 (+ 8), columns (key channels) 8 nt + 2 q (+ 1)
  float st[kNt][4];
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = j0 + r4 + 8 * (e >> 1), n = 8 * nt + 2 * q + (e & 1);
      st[nt][e] = (j < N && n < N) ? s0[state0 + (int64_t)n * N + j] : 0.0f;
    }
  }

  cp_async_wait_group<1>();
  __syncthreads();
  elementwise(0, 0);

  for (int ci = 0; ci < n_chunks; ++ci) {
    cp_async_wait_all();
    __syncthreads();   // chunk ci's buffer and chunk ci + 1's tiles are in
    if (ci + 2 < n_chunks) copy_chunk(ci + 2, (ci + 2) % K::kStages);

    const char* buf = sm + K::kBufOff + (ci & 1) * K::kBuf;
    auto plane = [&](int p) {
      return reinterpret_cast<const __nv_bfloat16*>(buf + p * K::kPlane);
    };
    const __nv_bfloat16* v_hi =
        K::kF32 ? plane(kVHi)
                : reinterpret_cast<const __nv_bfloat16*>(
                      sm + (ci % K::kStages) * K::kStage + 2 * K::kRaw);

    // M = rq kk^T and the bonus sum_n p, a k16 step over n at a time; rq's
    // fragments also feed o = rq S (the state fragments are its B operands)
    float mk[2][4] = {}, bo[4] = {}, ya[2][4] = {};
#pragma unroll
    for (int kn = 0; kn < kNk; ++kn) {
      uint32_t ah[4], al[4], bh[4], bl[4];
      ldsm_a<NW>(ah, plane(kRqHi), 16 * kn, lane);
      ldsm_a<NW>(al, plane(kRqLo), 16 * kn, lane);
      ldsm_b_rows<NW>(bh, plane(kKkHi), 16 * kn, lane);
      ldsm_b_rows<NW>(bl, plane(kKkLo), 16 * kn, lane);
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        mma_bf16(mk[f], al, bh[2 * f], bh[2 * f + 1]);
        mma_bf16(mk[f], ah, bl[2 * f], bl[2 * f + 1]);
        mma_bf16(mk[f], ah, bh[2 * f], bh[2 * f + 1]);
      }
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        uint32_t sh0, sl0, sh1, sl1;
        split2(st[2 * kn][2 * f], st[2 * kn][2 * f + 1], sh0, sl0);
        split2(st[2 * kn + 1][2 * f], st[2 * kn + 1][2 * f + 1], sh1, sl1);
        mma_bf16(ya[f], al, sh0, sh1);
        mma_bf16(ya[f], ah, sl0, sl1);
        mma_bf16(ya[f], ah, sh0, sh1);
      }
      uint32_t ph[4], pq[4];
      ldsm_a<NW>(ph, plane(kPHi), 16 * kn, lane);
      ldsm_a<NW>(pq, plane(kPLo), 16 * kn, lane);
      mma_bf16(bo, pq, kOnes, kOnes);
      mma_bf16(bo, ph, kOnes, kOnes);
    }

    // M's strictly lower entries, the bonus on its diagonal; its two 16 x
    // 8 halves are, pair by pair, the A fragment of M v
    const int t0 = r4, t1 = r4 + 8;
    float m[2][4];
#pragma unroll
    for (int f = 0; f < 2; ++f) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = 8 * f + 2 * q + (e & 1), t = e < 2 ? t0 : t1;
        m[f][e] = s < t ? mk[f][e] : s == t ? bo[e] : 0.0f;
      }
    }
    uint32_t mh[4], ml[4];
    split2(m[0][0], m[0][1], mh[0], ml[0]);   // (t0, 2q..)
    split2(m[0][2], m[0][3], mh[1], ml[1]);   // (t1, 2q..)
    split2(m[1][0], m[1][1], mh[2], ml[2]);   // (t0, 8 + 2q..)
    split2(m[1][2], m[1][3], mh[3], ml[3]);   // (t1, 8 + 2q..)
    uint32_t vh[4], vl[4] = {};
    ldsm_b_cols<NW>(vh, v_hi, j0, lane);
    if (K::kF32) ldsm_b_cols<NW>(vl, plane(kVLo), j0, lane);
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      if (K::kF32) {
        mma_bf16(ya[f], ml, vl[2 * f], vl[2 * f + 1]);
        mma_bf16(ya[f], mh, vl[2 * f], vl[2 * f + 1]);
      }
      mma_bf16(ya[f], ml, vh[2 * f], vh[2 * f + 1]);
      mma_bf16(ya[f], mh, vh[2 * f], vh[2 * f + 1]);
    }

    // store rows t0, t1 of the chunk, columns j0 + 8 f + 2 q (+ 1)
    const int64_t c0 = row0 + (int64_t)ci * kC * stride_t;
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      const int j = j0 + 8 * f + 2 * q;
      float* o0 = o + c0 + t0 * stride_t + j;
      float* o1 = o0 + 8 * stride_t;
      if ((N & 1) == 0) {
        if (j < N) {
          *reinterpret_cast<float2*>(o0) = make_float2(ya[f][0], ya[f][1]);
          *reinterpret_cast<float2*>(o1) = make_float2(ya[f][2], ya[f][3]);
        }
      } else {
        if (j < N) {
          o0[0] = ya[f][0];
          o1[0] = ya[f][2];
        }
        if (j + 1 < N) {
          o0[1] = ya[f][1];
          o1[1] = ya[f][3];
        }
      }
    }

    // S^T <- S^T diag(exp(la_end)) + v^T kend: v^T's A fragment is the v
    // fragments of M v reordered
    const float* dec =
        reinterpret_cast<const float*>(buf + K::kPlanes * K::kPlane);
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt) {
      const float2 d = load2(dec + 8 * nt + 2 * q);
      st[nt][0] *= d.x;
      st[nt][1] *= d.y;
      st[nt][2] *= d.x;
      st[nt][3] *= d.y;
    }
    const uint32_t va[4] = {vh[0], vh[2], vh[1], vh[3]};
    const uint32_t vb[4] = {vl[0], vl[2], vl[1], vl[3]};
#pragma unroll
    for (int np = 0; np < kNt / 2; ++np) {
      uint32_t kh[4], kl[4];
      ldsm_b_cols<NW>(kh, plane(kKeHi), 16 * np, lane);
      ldsm_b_cols<NW>(kl, plane(kKeLo), 16 * np, lane);
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        mma_bf16(st[2 * np + f], va, kl[2 * f], kl[2 * f + 1]);
        if (K::kF32) mma_bf16(st[2 * np + f], vb, kh[2 * f], kh[2 * f + 1]);
        mma_bf16(st[2 * np + f], va, kh[2 * f], kh[2 * f + 1]);
      }
    }

    if (ci + 1 < n_chunks) elementwise((ci + 1) % K::kStages, (ci + 1) & 1);
  }

#pragma unroll
  for (int nt = 0; nt < kNt; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = j0 + r4 + 8 * (e >> 1), n = 8 * nt + 2 * q + (e & 1);
      if (j < N && n < N) s_fin[state0 + (int64_t)n * N + j] = st[nt][e];
    }
  }
}

template <typename T, int NW>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const float* logw, const float* u, const float* s0,
                   float* o, float* s_fin, int B, int S, int H, int N,
                   cudaStream_t stream) {
  using K = Cfg<T, NW>;
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec_rkv = (N * (int)sizeof(T)) % 16 == 0 && aligned(r) &&
                      aligned(k) && aligned(v);
  const int vec_w = N % 4 == 0 && aligned(logw);
  // above 48 KB of shared memory a kernel must opt in (on each device)
  const cudaError_t err = cudaFuncSetAttribute(
      rwkv6_chunk_kernel<T, NW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      K::kSmem);
  if (err != cudaSuccess) return err;
  rwkv6_chunk_kernel<T, NW><<<B * H, K::kThreads, K::kSmem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), logw, u, s0, o, s_fin, S, H, N, vec_rkv,
      vec_w);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_width(const void* r, const void* k, const void* v,
                     const float* logw, const float* u, const float* s0,
                     float* o, float* s_fin, int B, int S, int H, int N,
                     cudaStream_t stream) {
  if (N <= 16)
    return launch<T, 16>(r, k, v, logw, u, s0, o, s_fin, B, S, H, N, stream);
  if (N <= 32)
    return launch<T, 32>(r, k, v, logw, u, s0, o, s_fin, B, S, H, N, stream);
  return launch<T, 64>(r, k, v, logw, u, s0, o, s_fin, B, S, H, N, stream);
}

}  // namespace

extern "C" {

// r, k, v: (B, S, H, N) bf16 (rkv_bf16 = 1) or f32; logw: (B, S, H, N)
// f32; u: (H, N) f32; s0: (B, H, N, N) f32.  Writes o (B, S, H, N) and
// s_fin (B, H, N, N), both f32.  1 <= N <= 64.
int rwkv6_chunk(const void* r, const void* k, const void* v,
                const float* logw, const float* u, const float* s0, float* o,
                float* s_fin, int B, int S, int H, int N, int rkv_bf16,
                cudaStream_t stream) {
  if (B < 1 || H < 1 || S < kC || S % kC != 0 || N < 1 || N > 64) {
    return cudaErrorInvalidValue;
  }
  if (rkv_bf16) {
    return by_width<__nv_bfloat16>(r, k, v, logw, u, s0, o, s_fin, B, S, H,
                                   N, stream);
  }
  return by_width<float>(r, k, v, logw, u, s0, o, s_fin, B, S, H, N, stream);
}

}  // extern "C"
