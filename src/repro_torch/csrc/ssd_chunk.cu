// Mamba2 SSD chunked scan for Hopper (sm_90a), on the tensor cores.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_chunk.py::ssd_chunk
// (pallas_call at :78, body _kernel at :29-66).  Per (b, h) pair it walks
// the S / 64 chunks in order, the (P, N) f32 state kept on chip across
// chunks, and in each chunk computes, with la the chunk-local inclusive
// cumsum of the per-step log-decay dla (one scalar per step and head):
//
//   M    = (C B^T) * exp(la_t - la_s) [t >= s]           (C, C)
//   y    = M xh + exp(la_t) * (C h^T)                     (C, P)
//   h   <- exp(la_end) h + (xh * exp(la_end - la))^T B    (P, N)
//
// which is what src/repro_torch/kernels/ref.py::ssd_chunk_ref computes.
// xh (dt-scaled inputs), dla and the state are f32; B and C are bf16 (the
// serving path's activations) or f32.
//
// What bounds it on an H100.  At the serving path's (B, S, H, P, N) = (4,
// 512, 112, 64, 64) it must move about 133 MB (xh and y 58.7 MB each, the
// state in and out 7.3 MB each, dla and the bf16 B / C under 1 MB): 39.8
// us at 3.35 TB/s.  Its ~4.8 GFLOP of products take ~29 us even as three
// TF32 passes at 495 TFLOP/s, so the bytes bound it.  In practice the
// instructions it executes with 16 warps an SM bound it, not the tensor
// pipe or the bytes: on an NVIDIA H100 80GB HBM3 at 700 W, cutting M xh
// with everything that feeds it saves a quarter of its time, and each of
// its other parts (the bf16 splits, the decay's exps, the state update)
// 5-11 % (tools/ssd_ablate.py).
// ptxas: 128 registers and 28 bytes of spill stores at the serving
// instance (bf16, P' = N' = 64).
//
// Products.  All four run on the tensor cores as mma.sync.m16n8k16 with
// bf16 operands and f32 accumulation (the copy, fragment-load, mma and
// split helpers are in mma_sm90.cuh, shared with rwkv6_chunk.cu).  mma.sync takes the 16 x 8 tiles
// that the small (P, N) instances need, and since the bytes and not the
// tensor rate bound the kernel, wgmma's wider tiles would buy nothing
// here.  bf16 rather than TF32: on this card an m16n8k8 TF32 mma.sync
// takes as long as an m16n8k16 bf16 one, at half the depth
// (tools/mma_bench.py), and three of the four products have an operand
// that is exact in bf16, where two bf16 parts of the other take two
// instructions a k16 step against four in TF32.  Precision: the plain
// version is f32 throughout and the gate is 1e-4 normwise, so no f32
// operand is rounded once to bf16; it is split into bf16 parts (cvt.rn)
// whose sum carries 16 or 24 of its bits:
//   - C h^T and (xh * kend)^T B have one operand that is exact in bf16 on
//     the serving path (B and C are bf16 activations); the f32 one is
//     split into hi = bf16(a) and lo = bf16(a - hi), two products.  With
//     f32 B / C that operand is split too and hi.hi + hi.lo + lo.hi are
//     taken (three products).  C B^T is one product (bf16 B / C), or those
//     three.
//   - M xh has two f32 operands; its error would dominate the output, so
//     both are split in three parts (a1 + a2 + a3, 24 significant bits)
//     and the six products of order up to 2^-16 are taken (as many
//     instructions as three TF32 passes, hi.hi + hi.lo + lo.hi).
// Emulated on the CPU (tests/test_torch_ssd.py) this scheme is within
// ~1e-5 normwise of the f32 reference at every tested shape.  The cumsum
// runs in f32 in sequence order over the whole chunk, one lane adding the
// 64 steps one after another, as XLA and the plain version do, so la is
// bitwise theirs.  exp(la_t - la_s) is used only for t >= s, where la_t -
// la_s <= 0 (dla <= 0): the masked entries are set to 0.  The decay of M
// uses __expf (relative error ~1e-6 at |la_t - la_s| <= 32); the other
// exps use expf.
//
// Design.  One CTA owns two heads of one batch row and walks their chunks
// in order; the two share B and C.  Within a chunk it walks four blocks
// of 16 rows in order, the state passed from block to block: for rows t
// of block g (la[-1] = 0),
//
//   y_t = exp(la_t - la[16 g - 1]) C_t h_g^T + sum_{s in g, s <= t} M_ts xh_s
//   h_{g+1} = exp(la[16 g + 15] - la[16 g - 1]) h_g
//             + sum_{s in g} exp(la[16 g + 15] - la_s) xh_s^T B_s,
//
// which is the chunk's recurrence with the same la, so only the four
// diagonal 16 x 16 tiles of M are formed, not its whole lower triangle
// (10 such tiles), while C h^T and the state update keep their size.  A
// head has P' / 16 warps, P' the instance's head width; warp w of a head
// owns the columns p in [16 w, 16 w + 16) of y and the rows p of the
// state, which lives in its mma accumulator fragments all along the
// sequence.  Those fragments are also, unchanged, the B operand of C h^T,
// so the state never goes through shared memory.  Each warp forms the
// diagonal tiles of C B^T itself; the C fragments of a tile's two 16 x 8
// halves are, pair by pair, the A fragment of M xh, so M never leaves
// registers.  y is formed 16 rows at a time (8 accumulator registers) and
// stored straight from the fragments.
//
// Loads.  Shared memory holds two stages of everything a chunk reads,
// filled with cp.async one chunk ahead while the current chunk computes:
// B and C (bf16, 16 KB the pair at N' = 64), dla of both heads, and each
// warp's own 64 x 16 slice of xh (4 KB).  Rows of B / C are stored in
// 16-byte chunks XOR-swizzled by row, so the ldmatrix loads of the
// products are free of bank conflicts.  One __syncthreads a chunk.  At
// P' = N' = 64: 256 threads and 105,600 B of shared memory, 2 CTAs an SM,
// so the serving shape's 224 CTAs (448 heads) are resident in one wave on
// 132 SMs (f32 B / C: 138,368 B, 1 CTA an SM).
//
// (P, N) instances.  P and N are each rounded up to a width of 16, 32 or
// 64; operands are zero-padded on chip (cp.async zero-fill), and zeros in
// B, C, xh and h0 add exact zeros to every sum.  Loads use 16-byte
// cp.async where P (xh) or N (B, C) and the strides allow, else 4-byte
// cp.async (xh) or plain loads (B, C).
//
// Interface: plain C, loaded with ctypes.  Pointers are device addresses;
// xh, dla, h0, y and h_fin are contiguous; B and C have unit stride on N.
// The stream is the caller's cudaStream_t.  The entry point returns
// cudaErrorInvalidValue for shapes it does not take (P or N outside [1,
// 64], S not a positive multiple of 64), else cudaGetLastError() after
// its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

using namespace mma_sm90;

constexpr int kC = 64;   // chunk length: kernels/ref.py SSD_CHUNK

template <typename T, int PW, int NW>
struct Cfg {
  static constexpr int kHeads = 2;                 // heads a CTA
  static constexpr int kHeadWarps = PW / 16;       // warps a head
  static constexpr int kWarps = kHeads * kHeadWarps;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kE = 16 / (int)sizeof(T);   // elements a 16-B chunk
  static constexpr int kCpr = NW / kE;             // chunks a row of B / C
  static constexpr int kMat = kC * NW;             // elements of B or C
  static constexpr int kBcBytes = 2 * kMat * (int)sizeof(T);   // a stage
  static constexpr int kDlaOff = 2 * kBcBytes;            // [2][heads][64]
  static constexpr int kXhOff = kDlaOff + 2 * kHeads * kC * 4;
  static constexpr int kXhWarp = 2 * kC * 16;      // floats: [2][64][16]
  static constexpr int kLaWarp = 3 * kC + 4;   // floats: la, cin, kend, dec
  static constexpr int kLaOff = kXhOff + kWarps * kXhWarp * 4;
  static constexpr int kSmem = kLaOff + kWarps * kLaWarp * 4;
  static constexpr int kMinBlocks = sizeof(T) == 2 ? 2 : 1;
};

// element offset of (t, p) in a warp's [64][16] f32 xh slice (4 chunks a
// row, swizzled by row pairs: the fragment reads are at most 2-way)
__device__ __forceinline__ int xoff(int t, int p) {
  return (t * 4 + ((p >> 2) ^ ((t >> 1) & 3))) * 4 + (p & 3);
}

// The swizzle repeats every 16 rows (swz<CPR>(16 g + t, c) = 16 g CPR +
// swz<CPR>(t, c)), so the helpers below take the tile pointer already
// offset to the 16-row block and form only the lanes' part of the address,
// which does not change from block to block.
//
// A operand (16 rows x 16 deep) of a B / C tile: the block's rows, depth
// n0..  bf16: one ldmatrix.x4; f32: float2 reads split into hi / lo pairs
template <int NW>
__device__ __forceinline__ void load_a(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                       const __nv_bfloat16* m, int n0, int lane) {
  ldsm_a<NW>(hi, m, n0, lane);
  (void)lo;
}

template <int NW>
__device__ __forceinline__ void load_a(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                       const float* m, int n0, int lane) {
  constexpr int kCpr = NW / 4;
  const int r = lane >> 2, q = lane & 3;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int t = r + 8 * (k & 1);
    const int n = n0 + 2 * q + 8 * (k >> 1);
    const float2 v = *reinterpret_cast<const float2*>(
        m + swz<kCpr>(t, n >> 2) * 4 + (n & 3));
    split2(v.x, v.y, hi[k], lo[k]);
  }
}

// B operands (16 deep x 8 columns) of C B^T for the block's rows 0.. and
// 8.. of B, depth n0..: {b0, b1} of the first, then of the second
template <int NW>
__device__ __forceinline__ void load_b_rows(uint32_t (&hi)[4],
                                            uint32_t (&lo)[4],
                                            const __nv_bfloat16* m, int n0,
                                            int lane) {
  ldsm_b_rows<NW>(hi, m, n0, lane);
  (void)lo;
}

template <int NW>
__device__ __forceinline__ void load_b_rows(uint32_t (&hi)[4],
                                            uint32_t (&lo)[4], const float* m,
                                            int n0, int lane) {
  constexpr int kCpr = NW / 4;
  const int r = lane >> 2, q = lane & 3;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int s = r + 8 * (k >> 1);
    const int n = n0 + 2 * q + 8 * (k & 1);
    const float2 v = *reinterpret_cast<const float2*>(
        m + swz<kCpr>(s, n >> 2) * 4 + (n & 3));
    split2(v.x, v.y, hi[k], lo[k]);
  }
}

// B operands (16 deep in t x 8 columns in n) of the state update for the
// column tiles n0.. and n0 + 8.., depth the block's rows: B read down its
// columns
template <int NW>
__device__ __forceinline__ void load_b_cols(uint32_t (&hi)[4],
                                            uint32_t (&lo)[4],
                                            const __nv_bfloat16* m, int n0,
                                            int lane) {
  ldsm_b_cols<NW>(hi, m, n0, lane);
  (void)lo;
}

template <int NW>
__device__ __forceinline__ void load_b_cols(uint32_t (&hi)[4],
                                            uint32_t (&lo)[4], const float* m,
                                            int n0, int lane) {
  constexpr int kCpr = NW / 4;
  const int r = lane >> 2, q = lane & 3;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int t = 2 * q + 8 * (k & 1);
    const int n = n0 + r + 8 * (k >> 1);
    const float v0 = m[swz<kCpr>(t, n >> 2) * 4 + (n & 3)];
    const float v1 = m[swz<kCpr>(t + 1, n >> 2) * 4 + (n & 3)];
    split2(v0, v1, hi[k], lo[k]);
  }
}

// d += a b with a f32 (split into hi / lo) and b bf16-exact (kSplitB
// false: lo of b unused) or f32 (kSplitB: hi.hi + hi.lo + lo.hi)
template <bool kSplitB>
__device__ __forceinline__ void mma_split(float (&d)[4],
                                          const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4],
                                          uint32_t bh0, uint32_t bh1,
                                          uint32_t bl0, uint32_t bl1) {
  mma_bf16(d, al, bh0, bh1);
  if (kSplitB) mma_bf16(d, ah, bl0, bl1);
  mma_bf16(d, ah, bh0, bh1);
}

template <typename T, int PW, int NW>
__global__ void __launch_bounds__(Cfg<T, PW, NW>::kThreads,
                                  Cfg<T, PW, NW>::kMinBlocks)
ssd_chunk_kernel(const float* __restrict__ xh, const T* __restrict__ bm,
                 const T* __restrict__ cm, const float* __restrict__ dla,
                 const float* __restrict__ h0, float* __restrict__ y,
                 float* __restrict__ h_fin, int S, int H, int P, int N,
                 int64_t bc_sb, int64_t bc_st, int vec_x, int vec_bc) {
  using K = Cfg<T, PW, NW>;
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int kNt = NW / 8;     // state column tiles
  constexpr int kNk = NW / 16;    // k16 steps over N
  constexpr int kBlockUnroll = kF32 ? 1 : 2;
  extern __shared__ float4 smem4[];
  char* sm = reinterpret_cast<char*>(smem4);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r = lane >> 2, q = lane & 3;
  const int heads = (H + K::kHeads - 1) / K::kHeads;
  const int b = blockIdx.x / heads;
  const int hw = warp / K::kHeadWarps;               // this warp's head
  const int h = (blockIdx.x % heads) * K::kHeads + hw;
  const bool active = h < H;   // an odd H leaves the last CTA one head
  const int pw0 = 16 * (warp % K::kHeadWarps);   // its columns of y, rows of h
  const int64_t stride_t = (int64_t)H * P;                   // xh, y
  const int64_t x0 = ((int64_t)b * S * H + h) * P;           // (b, 0, h, 0)
  const int64_t d0 = (int64_t)b * S * H + h;                 // (b, 0, h)
  const int64_t state0 = ((int64_t)b * H + h) * P * N;
  const T* bm_b = bm + (int64_t)b * bc_sb;
  const T* cm_b = cm + (int64_t)b * bc_sb;
  float* dla_s = reinterpret_cast<float*>(sm + K::kDlaOff);
  float* xs = reinterpret_cast<float*>(sm + K::kXhOff) + warp * K::kXhWarp;
  // la, and with g(t) = t / 16 the row block of t and la[-1] = 0:
  float* la = reinterpret_cast<float*>(sm + K::kLaOff) + warp * K::kLaWarp;
  float* cin = la + kC;      // exp(la[t] - la[16 g - 1])
  float* kend = cin + kC;    // exp(la[16 g + 15] - la[t])
  float* dec = kend + kC;    // dec[g] = exp(la[16 g + 15] - la[16 g - 1])

  // chunk ci's B, C and dla into stage st, this warp's xh slice too
  auto copy_chunk = [&](int ci, int st) {
    const int64_t t_first = (int64_t)ci * kC;
    T* bc = reinterpret_cast<T*>(sm + st * K::kBcBytes);
    if (vec_bc) {
      // 16-byte chunk ch of the rows tid / kCpr + k kRowStep of [B; C]
      constexpr int kRowStep = K::kThreads / K::kCpr;
      const int ch = tid % K::kCpr;
      const int bytes = ch * K::kE < N ? 16 : 0;
      const T* bsrc = bm_b + t_first * bc_st + ch * K::kE;
      const T* csrc = cm_b + t_first * bc_st + ch * K::kE;
#pragma unroll
      for (int k = 0; k < 2 * kC / kRowStep; ++k) {
        const int row = tid / K::kCpr + k * kRowStep;
        const int m = row / kC, t = row % kC;
        cp_async16(bc + m * K::kMat + swz<K::kCpr>(t, ch) * K::kE,
                   bytes ? (m ? csrc : bsrc) + t * bc_st : bm, bytes);
      }
    } else {
      for (int it = tid; it < 2 * kC * NW; it += K::kThreads) {
        const int m = it / (kC * NW);
        const int rem = it - m * kC * NW;
        const int t = rem / NW, n = rem - t * NW;
        const T* src = (m ? cm_b : bm_b) + (t_first + t) * bc_st + n;
        T v;
        if (n < N) {
          v = src[0];
        } else {
          v = T(0.0f);
        }
        bc[m * K::kMat + swz<K::kCpr>(t, n / K::kE) * K::kE + n % K::kE] = v;
      }
    }
    if (active) {
      float* xd = xs + st * kC * 16;
      if (pw0 == 0) {   // the head's first warp loads its dla
        for (int t = lane; t < kC; t += 32) {
          cp_async4(dla_s + (st * K::kHeads + hw) * kC + t,
                    dla + d0 + (t_first + t) * H, 4);
        }
      }
      if (vec_x) {
        const int ch = lane & 3, p = pw0 + 4 * ch;
        const int bytes = p < P ? 16 : 0;
        const float* xsrc = xh + x0 + t_first * stride_t + p;
#pragma unroll
        for (int k = 0; k < kC / 8; ++k) {
          const int t = (lane >> 2) + 8 * k;
          cp_async16(xd + xoff(t, 4 * ch), bytes ? xsrc + t * stride_t : xh,
                     bytes);
        }
      } else {
        for (int it = lane; it < kC * 16; it += 32) {
          const int t = it >> 4, pp = it & 15, p = pw0 + pp;
          const int bytes = p < P ? 4 : 0;
          cp_async4(xd + xoff(t, pp),
                    bytes ? xh + x0 + (t_first + t) * stride_t + p : xh,
                    bytes);
        }
      }
    }
    cp_async_commit();
  };

  copy_chunk(0, 0);

  // the state: st[nt] is the accumulator fragment of rows pw0 + r (+ 8),
  // columns 8 nt + 2 q (+ 1)
  float st[kNt][4];
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int p = pw0 + r + 8 * (k >> 1), n = 8 * nt + 2 * q + (k & 1);
      st[nt][k] = (active && p < P && n < N)
                      ? h0[state0 + (int64_t)p * N + n] : 0.0f;
    }
  }

  const int n_chunks = S / kC;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int sc = ci & 1;
    const int64_t t_first = (int64_t)ci * kC;
    cp_async_wait_all();
    __syncthreads();   // chunk ci landed; every warp is done with ci - 1
    if (ci + 1 < n_chunks) copy_chunk(ci + 1, sc ^ 1);
    if (!active) continue;

    // la in sequence order, then its exps (this warp's copy)
    const float* dl = dla_s + (sc * K::kHeads + hw) * kC;
    if (lane == 0) {   // 16 steps at a time from float4 reads
      float acc = 0.0f;
#pragma unroll
      for (int t16 = 0; t16 < kC; t16 += 16) {
        float v[16];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 d = reinterpret_cast<const float4*>(dl + t16)[u];
          v[4 * u] = d.x;
          v[4 * u + 1] = d.y;
          v[4 * u + 2] = d.z;
          v[4 * u + 3] = d.w;
        }
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          acc = (t16 == 0 && u == 0) ? v[0] : acc + v[u];
          v[u] = acc;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          reinterpret_cast<float4*>(la + t16)[u] =
              make_float4(v[4 * u], v[4 * u + 1], v[4 * u + 2], v[4 * u + 3]);
        }
      }
    }
    __syncwarp();
    for (int t = lane; t < kC; t += 32) {
      const int g0 = t & ~15;
      const float base = g0 ? la[g0 - 1] : 0.0f;
      cin[t] = expf(la[t] - base);
      kend[t] = expf(la[g0 + 15] - la[t]);
      if (t < 4) dec[t] = expf(la[16 * t + 15] - (t ? la[16 * t - 1] : 0.0f));
    }
    __syncwarp();

    const T* bs = reinterpret_cast<const T*>(sm + sc * K::kBcBytes);
    const T* cs = bs + K::kMat;
    const float* xc = xs + sc * kC * 16;   // xh[t][pw0 + p], p < 16

    // the chunk's four 16-row blocks g in order, the state h at the start
    // of block g in st.  Unrolled by two with bf16 B / C (the next block's
    // C B^T and M xh overlap this one's tail: 6 % faster at the serving
    // shape); not with f32 B / C, where that measured 2 % slower.
#pragma unroll(kBlockUnroll)
    for (int g = 0; g < 4; ++g) {
      const int g0 = 16 * g;
      const T* bg = bs + g0 * NW;     // the block's rows of B, C and xh
      const T* cg = cs + g0 * NW;
      const float* xg = xc + g0 * 16;
      // C's rows g0.. as the A operand, a k16 step over N at a time, for
      // both y = C h^T (the state fragments are the B operands) and C B^T
      // on the block's diagonal 16 x 16 tile (two 16 x 8 halves)
      float ya[2][4] = {};
      float cb[2][4] = {};
#pragma unroll
      for (int kn = 0; kn < kNk; ++kn) {
        uint32_t ach[4], acl[4];
        load_a<NW>(ach, acl, cg, 16 * kn, lane);
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          uint32_t bh0, bl0, bh1, bl1;
          split2(st[2 * kn][2 * f], st[2 * kn][2 * f + 1], bh0, bl0);
          split2(st[2 * kn + 1][2 * f], st[2 * kn + 1][2 * f + 1], bh1, bl1);
          mma_bf16(ya[f], ach, bl0, bl1);
          if (kF32) mma_bf16(ya[f], acl, bh0, bh1);
          mma_bf16(ya[f], ach, bh0, bh1);
        }
        uint32_t bh[4], bl[4];
        load_b_rows<NW>(bh, bl, bg, 16 * kn, lane);
        if (kF32) {
          mma_bf16(cb[0], ach, bl[0], bl[1]);
          mma_bf16(cb[0], acl, bh[0], bh[1]);
          mma_bf16(cb[1], ach, bl[2], bl[3]);
          mma_bf16(cb[1], acl, bh[2], bh[3]);
        }
        mma_bf16(cb[0], ach, bh[0], bh[1]);
        mma_bf16(cb[1], ach, bh[2], bh[3]);
      }
      // y = exp(la_t - la[g0 - 1]) (C h^T)
      const int t0 = g0 + r, t1 = t0 + 8;
      const float c0 = cin[t0], c1 = cin[t1];
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        ya[f][0] *= c0;
        ya[f][1] *= c0;
        ya[f][2] *= c1;
        ya[f][3] *= c1;
      }

      // y += M xh on the diagonal tile, M = (C B^T) * decay: the C
      // fragments of its halves are, pair by pair, the bf16 A fragment of M
      const float lt0 = la[t0], lt1 = la[t1];
      float m[2][4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int s0 = g0 + 8 * jj + 2 * q, s1 = s0 + 1;
        const float ls0 = la[s0], ls1 = la[s1];
        m[jj][0] = s0 <= t0 ? cb[jj][0] * __expf(lt0 - ls0) : 0.0f;
        m[jj][1] = s1 <= t0 ? cb[jj][1] * __expf(lt0 - ls1) : 0.0f;
        m[jj][2] = s0 <= t1 ? cb[jj][2] * __expf(lt1 - ls0) : 0.0f;
        m[jj][3] = s1 <= t1 ? cb[jj][3] * __expf(lt1 - ls1) : 0.0f;
      }
      uint32_t a1[4], a2[4], a3[4];
      split3(m[0][0], m[0][1], a1[0], a2[0], a3[0]);   // (r, 2q..)
      split3(m[0][2], m[0][3], a1[1], a2[1], a3[1]);   // (r + 8, 2q..)
      split3(m[1][0], m[1][1], a1[2], a2[2], a3[2]);   // (r, 8 + 2q..)
      split3(m[1][2], m[1][3], a1[3], a2[3], a3[3]);   // (r + 8, 8 + 2q..)
      const int sa = 2 * q;   // block rows of the B fragments' depth
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        // xh rows sa, sa + 1 (b0) and sa + 8, sa + 9 (b1), column r + 8 f
        const int pc = r + 8 * f;
        uint32_t b1[2], b2[2], b3[2];
        split3(xg[xoff(sa, pc)], xg[xoff(sa + 1, pc)], b1[0], b2[0], b3[0]);
        split3(xg[xoff(sa + 8, pc)], xg[xoff(sa + 9, pc)], b1[1], b2[1],
               b3[1]);
        mma_bf16(ya[f], a3, b1[0], b1[1]);
        mma_bf16(ya[f], a1, b3[0], b3[1]);
        mma_bf16(ya[f], a2, b2[0], b2[1]);
        mma_bf16(ya[f], a2, b1[0], b1[1]);
        mma_bf16(ya[f], a1, b2[0], b2[1]);
        mma_bf16(ya[f], a1, b1[0], b1[1]);
      }

      // store rows t0, t1, columns pw0 + 8 f + 2 q (+ 1)
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        const int p = pw0 + 8 * f + 2 * q;
        float* y0 = y + x0 + (t_first + t0) * stride_t + p;
        float* y1 = y0 + 8 * stride_t;
        if ((P & 1) == 0) {
          if (p < P) {
            *reinterpret_cast<float2*>(y0) = make_float2(ya[f][0], ya[f][1]);
            *reinterpret_cast<float2*>(y1) = make_float2(ya[f][2], ya[f][3]);
          }
        } else {
          if (p < P) {
            y0[0] = ya[f][0];
            y1[0] = ya[f][2];
          }
          if (p + 1 < P) {
            y0[1] = ya[f][1];
            y1[1] = ya[f][3];
          }
        }
      }

      // h <- dec[g] h + (xh * kend)^T B over the block's 16 rows t
      const float d = dec[g];
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
        for (int k = 0; k < 4; ++k) st[nt][k] *= d;
      // A (rows p = r, r + 8; depth t = sa, sa + 1, sa + 8, sa + 9)
      const float* kg = kend + g0 + sa;
      const float k00 = kg[0], k01 = kg[1], k10 = kg[8], k11 = kg[9];
      uint32_t ah[4], al[4];
      split2(xg[xoff(sa, r)] * k00, xg[xoff(sa + 1, r)] * k01, ah[0], al[0]);
      split2(xg[xoff(sa, r + 8)] * k00, xg[xoff(sa + 1, r + 8)] * k01, ah[1],
             al[1]);
      split2(xg[xoff(sa + 8, r)] * k10, xg[xoff(sa + 9, r)] * k11, ah[2],
             al[2]);
      split2(xg[xoff(sa + 8, r + 8)] * k10, xg[xoff(sa + 9, r + 8)] * k11,
             ah[3], al[3]);
#pragma unroll
      for (int np = 0; np < kNt / 2; ++np) {
        uint32_t bh[4], bl[4];
        load_b_cols<NW>(bh, bl, bg, 16 * np, lane);
        mma_split<kF32>(st[2 * np], ah, al, bh[0], bh[1], bl[0], bl[1]);
        mma_split<kF32>(st[2 * np + 1], ah, al, bh[2], bh[3], bl[2], bl[3]);
      }
    }
  }

  if (!active) return;
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int p = pw0 + r + 8 * (k >> 1), n = 8 * nt + 2 * q + (k & 1);
      if (p < P && n < N) h_fin[state0 + (int64_t)p * N + n] = st[nt][k];
    }
  }
}

template <typename T, int PW, int NW>
cudaError_t launch(const float* xh, const void* bm, const void* cm,
                   const float* dla, const float* h0, float* y, float* h_fin,
                   int B, int S, int H, int P, int N, int64_t bc_sb,
                   int64_t bc_st, cudaStream_t stream) {
  using K = Cfg<T, PW, NW>;
  constexpr int64_t kEl = sizeof(T);
  const int vec_x = P % 4 == 0 && reinterpret_cast<uintptr_t>(xh) % 16 == 0;
  const int vec_bc = (N * kEl) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(bm) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(cm) % 16 == 0 &&
                     (bc_sb * kEl) % 16 == 0 && (bc_st * kEl) % 16 == 0;
  // above 48 KB of shared memory a kernel must opt in (on each device)
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel<T, PW, NW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, K::kSmem);
  if (err != cudaSuccess) return err;
  const int grid = B * ((H + K::kHeads - 1) / K::kHeads);
  ssd_chunk_kernel<T, PW, NW><<<grid, K::kThreads, K::kSmem, stream>>>(
      xh, static_cast<const T*>(bm), static_cast<const T*>(cm), dla, h0, y,
      h_fin, S, H, P, N, bc_sb, bc_st, vec_x, vec_bc);
  return cudaGetLastError();
}

template <typename T, int PW>
cudaError_t by_state_width(const float* xh, const void* bm, const void* cm,
                           const float* dla, const float* h0, float* y,
                           float* h_fin, int B, int S, int H, int P, int N,
                           int64_t bc_sb, int64_t bc_st, cudaStream_t s) {
  if (N <= 16)
    return launch<T, PW, 16>(xh, bm, cm, dla, h0, y, h_fin, B, S, H, P, N,
                             bc_sb, bc_st, s);
  if (N <= 32)
    return launch<T, PW, 32>(xh, bm, cm, dla, h0, y, h_fin, B, S, H, P, N,
                             bc_sb, bc_st, s);
  return launch<T, PW, 64>(xh, bm, cm, dla, h0, y, h_fin, B, S, H, P, N,
                           bc_sb, bc_st, s);
}

template <typename T>
cudaError_t by_widths(const float* xh, const void* bm, const void* cm,
                      const float* dla, const float* h0, float* y,
                      float* h_fin, int B, int S, int H, int P, int N,
                      int64_t bc_sb, int64_t bc_st, cudaStream_t s) {
  if (P <= 16)
    return by_state_width<T, 16>(xh, bm, cm, dla, h0, y, h_fin, B, S, H, P,
                                 N, bc_sb, bc_st, s);
  if (P <= 32)
    return by_state_width<T, 32>(xh, bm, cm, dla, h0, y, h_fin, B, S, H, P,
                                 N, bc_sb, bc_st, s);
  return by_state_width<T, 64>(xh, bm, cm, dla, h0, y, h_fin, B, S, H, P, N,
                               bc_sb, bc_st, s);
}

}  // namespace

extern "C" {

// xh: (B, S, H, P) f32; bm, cm: (B, S, N) bf16 (bc_bf16 = 1) or f32, unit
// stride on N, batch stride bc_sb and time stride bc_st (in elements, the
// same for both); dla: (B, S, H) f32; h0: (B, H, P, N) f32.  Writes y
// (B, S, H, P) and h_fin (B, H, P, N), both f32.  1 <= P, N <= 64.
int ssd_chunk(const float* xh, const void* bm, const void* cm,
              const float* dla, const float* h0, float* y, float* h_fin,
              int B, int S, int H, int P, int N, long long bc_sb,
              long long bc_st, int bc_bf16, cudaStream_t stream) {
  if (B < 1 || H < 1 || S < kC || S % kC != 0 || P < 1 || P > 64 || N < 1 ||
      N > 64) {
    return cudaErrorInvalidValue;
  }
  if (bc_bf16) {
    return by_widths<__nv_bfloat16>(xh, bm, cm, dla, h0, y, h_fin, B, S, H,
                                    P, N, bc_sb, bc_st, stream);
  }
  return by_widths<float>(xh, bm, cm, dla, h0, y, h_fin, B, S, H, P, N,
                          bc_sb, bc_st, stream);
}

}  // extern "C"
