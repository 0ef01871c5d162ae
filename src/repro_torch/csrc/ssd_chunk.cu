// Mamba2 SSD chunked scan for Hopper (sm_90a).
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
// serving path's activations) or f32; all arithmetic is f32, with expf
// (not __expf).  The cumsum runs in f32 in sequence order, one thread
// adding the 64 steps one after another, as XLA and the plain version do.
// exp(la_t - la_s) is formed only for t >= s, where la_t - la_s <= 0 (dla
// <= 0): the masked entries are set to 0 and their exponent is never
// computed.
//
// What bounds it on an H100.  At the serving path's (B, S, H, P, N) = (4,
// 512, 112, 64, 64) it moves about 134 MB (xh and y 59 MB each, the state
// in and out 7 MB each, dla and bf16 B / C under 1 MB each) and does about
// 4.8 GFLOP (per (b, h, chunk): the lower triangle of M xh, C h^T and the
// state update, each ~2 C P N; C B^T once per (b, chunk)): the f32 rate
// (67 TFLOP/s outside the tensor cores) bounds it, at about twice the
// bytes' time.  This first version is simple: plain f32 FMAs, no tensor
// cores (wgmma), no TMA, no prefetch of the next chunk, and C B^T formed
// again by every head.
//
// Design.  The TPU walks its sequential grid axis over chunks with the
// state in VMEM scratch; here one CTA of 256 threads owns one (b, h) pair
// and loops over the chunks itself, the state in shared memory.  The four
// (64 x 64 x 64) products of a chunk are register-tiled: each thread owns
// a 4 x 4 tile of the output, and each step of the inner dimension reads
// one float4 of each operand from shared memory for 16 FMAs.  For that,
// every operand whose rows are the output's rows is kept transposed in
// shared memory (C^T, B^T, M^T, and the state as h^T (N, P)), with rows
// padded to 68 floats to soften the bank conflicts of the transposing
// stores.  Tiles of M wholly above the diagonal are not computed, and the
// M xh loop of a thread stops at its last row.  The kernel reads xh
// (B, S, H, P) and dla (B, S, H) in place, without the reference's
// (BH, NC, C, .) transposes, and B / C (B, S, N) with the caller's batch
// and time strides (in the model they are column slices of one
// activation), without the reference's broadcast over heads.
//
// Interface: plain C, loaded with ctypes.  Pointers are device addresses;
// xh, dla, h0, y and h_fin are contiguous; B and C have unit stride on N.
// The stream is the caller's cudaStream_t.  The entry point returns
// cudaErrorInvalidValue for shapes it does not take (P or N not 64, S not
// a positive multiple of 64), else cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 64;          // chunk length: kernels/ref.py SSD_CHUNK
constexpr int kP = 64;          // head dim the kernel is built for
constexpr int kN = 64;          // state dim the kernel is built for
constexpr int kThreads = 256;   // 16 x 16 threads, a 4 x 4 tile each
constexpr int kLd = 68;         // padded row of a transposed buffer

// shared memory, in floats
constexpr int kCt = 0;                      // C^T   (N, C) padded
constexpr int kBt = kCt + kN * kLd;         // B^T   (N, C) padded; M^T later
constexpr int kBn = kBt + kN * kLd;         // B     (C, N), then B * kend
constexpr int kXh = kBn + kC * kN;          // xh    (C, P)
constexpr int kHt = kXh + kC * kP;          // h^T   (N, P) padded
constexpr int kLa = kHt + kN * kLd;         // la    (C,)
constexpr int kCin = kLa + kC;              // exp(la)
constexpr int kKend = kCin + kC;            // exp(la_end - la)
constexpr int kFloats = kKend + kC;
constexpr int kSmemBytes = kFloats * 4;

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(p[0]);
}

// acc[i][j] += sum_k a[k * lda + r0 + i] * b[k * ldb + c0 + j], k < kk
__device__ __forceinline__ void tile_fma(float (&acc)[4][4], const float* a,
                                         int lda, int r0, const float* b,
                                         int ldb, int c0, int kk) {
#pragma unroll 4
  for (int k = 0; k < kk; ++k) {
    const float4 av = *reinterpret_cast<const float4*>(a + k * lda + r0);
    const float4 bv = *reinterpret_cast<const float4*>(b + k * ldb + c0);
    const float ar[4] = {av.x, av.y, av.z, av.w};
    const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
ssd_chunk_kernel(const float* __restrict__ xh, const T* __restrict__ bm,
                 const T* __restrict__ cm, const float* __restrict__ dla,
                 const float* __restrict__ h0, float* __restrict__ y,
                 float* __restrict__ h_fin, int S, int H, int64_t bc_sb,
                 int64_t bc_st) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* ct = sm + kCt;
  float* bt = sm + kBt;   // B^T, then M^T
  float* bn = sm + kBn;
  float* xs = sm + kXh;
  float* ht = sm + kHt;
  float* la = sm + kLa;
  float* cin = sm + kCin;
  float* kend = sm + kKend;

  const int tid = threadIdx.x;
  const int r0 = (tid / 16) * 4;   // this thread's output rows
  const int c0 = (tid % 16) * 4;   // and columns
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int64_t stride_t = (int64_t)H * kP;                  // xh, y
  const int64_t x0 = ((int64_t)b * S * H + h) * kP;          // (b, 0, h, 0)
  const int64_t d0 = (int64_t)b * S * H + h;                 // (b, 0, h)
  const int64_t state0 = (int64_t)bh * kP * kN;
  const T* bm_b = bm + (int64_t)b * bc_sb;
  const T* cm_b = cm + (int64_t)b * bc_sb;

  // the state, transposed: ht[n][p] = h0[p][n]
  for (int idx = tid; idx < kP * kN; idx += kThreads) {
    const int p = idx / kN, n = idx % kN;
    ht[n * kLd + p] = h0[state0 + idx];
  }

  const int n_chunks = S / kC;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int t_first = ci * kC;
    // 1. the chunk's tiles: C^T, B^T and B from one read each, xh, dla
    for (int idx = tid; idx < kC * kN; idx += kThreads) {
      const int t = idx / kN, n = idx % kN;
      const int64_t off = (int64_t)(t_first + t) * bc_st + n;
      const float bv = load_f32(bm_b + off);
      ct[n * kLd + t] = load_f32(cm_b + off);
      bt[n * kLd + t] = bv;
      bn[idx] = bv;
    }
    for (int idx = tid; idx < kC * kP / 4; idx += kThreads) {
      const int t = idx / (kP / 4), q = idx % (kP / 4);
      reinterpret_cast<float4*>(xs)[idx] = __ldg(reinterpret_cast<const float4*>(
          xh + x0 + (int64_t)(t_first + t) * stride_t) + q);
    }
    if (tid < kC) la[tid] = __ldg(dla + d0 + (int64_t)(t_first + tid) * H);
    __syncthreads();

    // 2. warp 0: the inclusive cumsum, in sequence, then its exps; every
    // thread: its tile of C B^T unless it lies wholly above the diagonal
    if (tid < 32) {
      if (tid == 0) {
        float acc = 0.0f;
        for (int t = 0; t < kC; ++t) {
          acc += la[t];
          la[t] = acc;
        }
      }
      __syncwarp();
      const float la_end = la[kC - 1];
      for (int t = tid; t < kC; t += 32) {
        cin[t] = expf(la[t]);
        kend[t] = expf(la_end - la[t]);
      }
    }
    float cb[4][4];
    zero(cb);
    const bool lower = c0 <= r0;   // tile rows t = r0.., columns s = c0..
    if (lower) tile_fma(cb, ct, kLd, r0, bt, kLd, c0, kN);
    __syncthreads();

    // 3. M^T over B^T (its last reader is done), masked without forming
    // the positive exponents; B scaled by exp(la_end - la) for step 5
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = r0 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = c0 + j;
        bt[s * kLd + t] = (lower && s <= t) ? cb[i][j] * expf(la[t] - la[s])
                                            : 0.0f;
      }
    }
    for (int idx = tid; idx < kC * kN; idx += kThreads) {
      bn[idx] *= kend[idx / kN];
    }
    __syncthreads();

    // 4. y = M xh + exp(la_t) (C h^T) for rows t = r0.., columns p = c0..
    {
      float intra[4][4], inter[4][4];
      zero(intra);
      zero(inter);
      tile_fma(intra, bt, kLd, r0, xs, kP, c0, r0 + 4);   // M[t][s] = 0, s > t
      tile_fma(inter, ct, kLd, r0, ht, kLd, c0, kN);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ci_t = cin[r0 + i];
        float4 out;
        out.x = intra[i][0] + ci_t * inter[i][0];
        out.y = intra[i][1] + ci_t * inter[i][1];
        out.z = intra[i][2] + ci_t * inter[i][2];
        out.w = intra[i][3] + ci_t * inter[i][3];
        *reinterpret_cast<float4*>(
            y + x0 + (int64_t)(t_first + r0 + i) * stride_t + c0) = out;
      }
    }
    __syncthreads();   // every read of the old state is done

    // 5. h^T <- exp(la_end) h^T + (B * kend)^T xh for rows n = r0..,
    // columns p = c0..
    {
      float outer[4][4];
      zero(outer);
      tile_fma(outer, bn, kN, r0, xs, kP, c0, kC);
      const float decay = expf(la[kC - 1]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float* hv = ht + (r0 + i) * kLd + c0 + j;
          *hv = *hv * decay + outer[i][j];
        }
      }
    }
    __syncthreads();
  }

  for (int idx = tid; idx < kP * kN; idx += kThreads) {
    const int p = idx / kN, n = idx % kN;
    h_fin[state0 + idx] = ht[n * kLd + p];
  }
}

template <typename T>
cudaError_t launch(const float* xh, const void* bm, const void* cm,
                   const float* dla, const float* h0, float* y, float* h_fin,
                   int B, int S, int H, int64_t bc_sb, int64_t bc_st,
                   cudaStream_t stream) {
  // above 48 KB of shared memory a kernel must opt in (on each device)
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return err;
  ssd_chunk_kernel<T><<<B * H, kThreads, kSmemBytes, stream>>>(
      xh, static_cast<const T*>(bm), static_cast<const T*>(cm), dla, h0, y,
      h_fin, S, H, bc_sb, bc_st);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// xh: (B, S, H, P) f32; bm, cm: (B, S, N) bf16 (bc_bf16 = 1) or f32, unit
// stride on N, batch stride bc_sb and time stride bc_st (in elements, the
// same for both); dla: (B, S, H) f32; h0: (B, H, P, N) f32.  Writes y
// (B, S, H, P) and h_fin (B, H, P, N), both f32.
int ssd_chunk(const float* xh, const void* bm, const void* cm,
              const float* dla, const float* h0, float* y, float* h_fin,
              int B, int S, int H, int P, int N, long long bc_sb,
              long long bc_st, int bc_bf16, cudaStream_t stream) {
  if (B < 1 || H < 1 || S < kC || S % kC != 0 || P != kP || N != kN) {
    return cudaErrorInvalidValue;
  }
  if (bc_bf16) {
    return launch<__nv_bfloat16>(xh, bm, cm, dla, h0, y, h_fin, B, S, H,
                                 bc_sb, bc_st, stream);
  }
  return launch<float>(xh, bm, cm, dla, h0, y, h_fin, B, S, H, bc_sb, bc_st,
                       stream);
}

}  // extern "C"
