// RWKV6 (Finch) chunked linear-attention scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv6_chunk.py::
// rwkv6_chunk (pallas_call at :90, body _kernel at :40-79).  Per (b, h)
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
// and the state are f32; all arithmetic is f32, with expf (not __expf).
// Only the strictly-lower (t > s) entries of rq kk^T are computed: kk
// reaches e^80, so a masked entry may overflow where the reference's
// multiply-then-mask would turn it into a NaN; where the reference is
// finite the two agree.
//
// What bounds it on an H100.  It reads 14 B per (b, s, h, n) element (r, k,
// v in bf16, log w in f32) and writes 4 B of o, plus the state in and out;
// it does about 4 N^2 + 4 N C flops per element of one (b, h) chunk row
// (the (C, N) x (N, N) products rq S and kend^T v dominate).  At the
// serving path's (4, 512, 64, 64) that is about 126 MB against 2.6 GFLOP:
// the f32 rate (67 TFLOP/s outside the tensor cores) bounds it, by a
// little.  This first version is simple: plain f32 FMAs from shared memory,
// no tensor cores (wgmma) and no prefetch of the next chunk.
//
// Design.  The TPU walks its sequential grid axis over chunks with the
// state in VMEM scratch; here one CTA of 256 threads owns one (b, h) pair
// and a tile of COLS value columns (blockIdx.y), and loops over the chunks
// itself with its state columns in shared memory.  Column j of S and of o
// depends only on v[:, j], so the column tiles are independent; N = 64
// splits into two tiles of 32, which doubles the CTAs (B*H = 256 pairs on
// the serving path, 128 at 2 x 4096 tokens, against 132 SMs) at the cost of
// reading r, k and log w twice (from L2).  Each thread owns one column and
// C / G output rows and N / G state rows of it, so the products read the
// state once per column and r-side operands as warp broadcasts.  The
// kernel reads the (B, S, H, N) layout in place, without the reference's
// (BH, NC, C, N) transposes.
//
// Interface: plain C, loaded with ctypes.  Pointers are device addresses
// of contiguous buffers; the stream is the caller's cudaStream_t.  The
// entry point returns cudaErrorInvalidValue for shapes it does not take
// (N not in {16, 32, 64}, S not a positive multiple of 16), else
// cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 16;          // chunk length: kernels/ref.py RWKV_CHUNK
constexpr int kThreads = 256;
// CTAs an SM must hold: caps the registers at 64 a thread (ptxas gives
// the bf16 N = 64 instantiation 80 uncapped, which fits 3 CTAs an SM), so
// the serving path's 512 CTAs run in one wave of 132 x 4 instead of 1.3
// waves of 132 x 3.  tools/rwkv6_regcap_ab.py times it against the
// uncapped build.
constexpr int kMinCtas = 4;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(p[0]);
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads, kMinCtas)
rwkv6_chunk_kernel(const T* __restrict__ r, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ logw,
                   const float* __restrict__ u, const float* __restrict__ s0,
                   float* __restrict__ o, float* __restrict__ s_fin, int S,
                   int H) {
  constexpr int COLS = N < 32 ? N : 32;  // value columns of this CTA
  constexpr int G = kThreads / COLS;     // row groups
  constexpr int TR = kC / G;             // o rows of a thread
  constexpr int NR = N / G;              // state rows of a thread
  constexpr int NP = N + 1;              // padded stride: qk reads columns
  static_assert(TR * G == kC && NR * G == N, "unsupported head dim");
  static_assert(N + kC <= kThreads, "too few threads");

  __shared__ float s_sh[N][COLS];
  __shared__ float r_sh[kC][N];
  __shared__ float k_sh[kC][N];
  __shared__ float lw_sh[kC][N];
  __shared__ float la_sh[kC][N];
  __shared__ float rq_sh[kC][NP];
  __shared__ float kk_sh[kC][NP];
  __shared__ float kend_sh[kC][N];
  __shared__ float v_sh[kC][COLS];
  __shared__ float qk_sh[kC][kC + 1];
  __shared__ float bonus_sh[kC];
  __shared__ float decay_sh[N];
  __shared__ float u_sh[N];

  const int tid = threadIdx.x;
  const int jj = tid % COLS;
  const int g = tid / COLS;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int j0 = blockIdx.y * COLS;
  const int64_t stride_t = (int64_t)H * N;
  const int64_t row0 = ((int64_t)b * S * H + h) * N;  // (b, t = 0, h, 0)
  const int64_t state0 = (int64_t)bh * N * N;

  for (int idx = tid; idx < N * COLS; idx += kThreads) {
    const int n = idx / COLS, j = idx % COLS;
    s_sh[n][j] = s0[state0 + (int64_t)n * N + j0 + j];
  }
  for (int n = tid; n < N; n += kThreads) u_sh[n] = u[(int64_t)h * N + n];

  const int n_chunks = S / kC;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int64_t chunk0 = row0 + (int64_t)ci * kC * stride_t;
    // 1. the chunk's tiles, upcast to f32 (v: this CTA's columns only)
    for (int idx = tid; idx < kC * N; idx += kThreads) {
      const int t = idx / N, n = idx % N;
      const int64_t off = chunk0 + t * stride_t + n;
      r_sh[t][n] = load_f32(r + off);
      k_sh[t][n] = load_f32(k + off);
      lw_sh[t][n] = __ldg(logw + off);
    }
    for (int idx = tid; idx < kC * COLS; idx += kThreads) {
      const int t = idx / COLS, j = idx % COLS;
      v_sh[t][j] = load_f32(v + chunk0 + t * stride_t + j0 + j);
    }
    __syncthreads();

    // 2. inclusive cumsum of log w down each channel; the chunk's decay
    for (int n = tid; n < N; n += kThreads) {
      float acc = 0.0f;
#pragma unroll
      for (int t = 0; t < kC; ++t) {
        acc += lw_sh[t][n];
        la_sh[t][n] = acc;
      }
      decay_sh[n] = expf(acc);
    }
    // the u bonus sum_n r u k of each row: one warp a row, lanes over n
    for (int t = warp; t < kC; t += kThreads / 32) {
      float part = 0.0f;
      for (int n = lane; n < N; n += 32) part += r_sh[t][n] * u_sh[n] * k_sh[t][n];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        part += __shfl_xor_sync(kFull, part, off);
      }
      if (lane == 0) bonus_sh[t] = part;
    }
    __syncthreads();

    // 3. the factorised decays
    for (int idx = tid; idx < kC * N; idx += kThreads) {
      const int t = idx / N, n = idx % N;
      const float la = la_sh[t][n];
      const float kv = k_sh[t][n];
      rq_sh[t][n] = r_sh[t][n] * expf(la - lw_sh[t][n]);
      kk_sh[t][n] = kv * expf(-la);
      kend_sh[t][n] = kv * expf(la_sh[kC - 1][n] - la);
    }
    __syncthreads();

    // 4. the strictly-lower part of rq kk^T; masked entries are 0, never
    // formed
    for (int idx = tid; idx < kC * kC; idx += kThreads) {
      const int t = idx / kC, s = idx % kC;
      float acc = 0.0f;
      if (s < t) {
#pragma unroll 16
        for (int n = 0; n < N; ++n) acc += rq_sh[t][n] * kk_sh[s][n];
      }
      qk_sh[t][s] = acc;
    }
    __syncthreads();

    // 5. o = (intra + bonus v) + rq S for this thread's rows and column
    {
      float inter[TR];
#pragma unroll
      for (int i = 0; i < TR; ++i) inter[i] = 0.0f;
#pragma unroll 8
      for (int n = 0; n < N; ++n) {
        const float sv = s_sh[n][jj];
#pragma unroll
        for (int i = 0; i < TR; ++i) inter[i] += rq_sh[g + G * i][n] * sv;
      }
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const int t = g + G * i;
        float intra = 0.0f;
        for (int s = 0; s < t; ++s) intra += qk_sh[t][s] * v_sh[s][jj];
        intra += bonus_sh[t] * v_sh[t][jj];
        o[chunk0 + t * stride_t + j0 + jj] = intra + inter[i];
      }
    }
    __syncthreads();  // every read of the old state is done

    // 6. S <- S * exp(la_end) + kend^T v on this thread's rows and column
    {
      float vj[kC];
#pragma unroll
      for (int t = 0; t < kC; ++t) vj[t] = v_sh[t][jj];
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const int n = g + G * i;
        float outer = 0.0f;
#pragma unroll
        for (int t = 0; t < kC; ++t) outer += kend_sh[t][n] * vj[t];
        s_sh[n][jj] = s_sh[n][jj] * decay_sh[n] + outer;
      }
    }
    __syncthreads();
  }

  for (int idx = tid; idx < N * COLS; idx += kThreads) {
    const int n = idx / COLS, j = idx % COLS;
    s_fin[state0 + (int64_t)n * N + j0 + j] = s_sh[n][j];
  }
}

template <typename T, int N>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const float* logw, const float* u, const float* s0,
                   float* o, float* s_fin, int B, int S, int H,
                   cudaStream_t stream) {
  constexpr int cols = N < 32 ? N : 32;
  const dim3 grid(B * H, N / cols);
  rwkv6_chunk_kernel<T, N><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), logw, u, s0, o, s_fin, S, H);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* r, const void* k, const void* v,
                     const float* logw, const float* u, const float* s0,
                     float* o, float* s_fin, int B, int S, int H, int N,
                     cudaStream_t stream) {
  switch (N) {
    case 16: return launch<T, 16>(r, k, v, logw, u, s0, o, s_fin, B, S, H, stream);
    case 32: return launch<T, 32>(r, k, v, logw, u, s0, o, s_fin, B, S, H, stream);
    case 64: return launch<T, 64>(r, k, v, logw, u, s0, o, s_fin, B, S, H, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// r, k, v: (B, S, H, N) bf16 (rkv_bf16 = 1) or f32; logw: (B, S, H, N)
// f32; u: (H, N) f32; s0: (B, H, N, N) f32.  Writes o (B, S, H, N) and
// s_fin (B, H, N, N), both f32.
int rwkv6_chunk(const void* r, const void* k, const void* v,
                const float* logw, const float* u, const float* s0, float* o,
                float* s_fin, int B, int S, int H, int N, int rkv_bf16,
                cudaStream_t stream) {
  if (B < 1 || H < 1 || S < kC || S % kC != 0) return cudaErrorInvalidValue;
  if (rkv_bf16) {
    return dispatch<__nv_bfloat16>(r, k, v, logw, u, s0, o, s_fin, B, S, H,
                                   N, stream);
  }
  return dispatch<float>(r, k, v, logw, u, s0, o, s_fin, B, S, H, N, stream);
}

}  // extern "C"
