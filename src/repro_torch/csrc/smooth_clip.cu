// Smooth clipping (paper Definition 2) for Hopper over a flat (tiles, 8192)
// plane that stacks rows (agents, or samples) of tiles_per_row tiles, and
// the DP perturbation of the clipped samples' mean:
//
//   clip         (clip_cluster_kernel,  y = x * f_row (+ sigma * z), with
//                 clip_kernel)          f_row = tau / (tau + ||row||), in
//                                       one launch
//   mean_noise   (mean_noise_kernel)    y[g] = mean_s x[g, s] (+ sigma * z[g])
//   sumsq        (sumsq_kernel)         per-tile sum of squares -> (tiles,)
//   scale        (scale_kernel)         y = x * f_row
//   scale_noise  (scale_kernel<noise>)  y = x * f_row + sigma * z
//
// Replace the Pallas TPU kernels of src/repro/kernels/smooth_clip.py
// (sumsq :41, scale :69, scale with noise :77); clip replaces sumsq, the
// jnp combine between the passes (src/repro/kernels/ops.py:59-61) and
// scale together.  The Pallas kernel's scalar factor is generalised to one
// f32 a row.  At f = 1 scale_noise is the DP perturbation g + sigma * z,
// bit for bit.  mean_noise has no Pallas counterpart: the reference takes
// the sample mean (clipped_grad_accumulate, src/repro/core/clipping.py:
// 101-104) and adds the noise (src/repro/core/porter.py:137-145,
// src/repro/core/baselines.py:65-74) in plain jnp.  It takes the clipped
// per-sample plane and forms each group's sample mean, and the noise when
// given, in one pass; every per-sample clipped mean of the port runs it.
//
// Each computes what the plain versions of src/repro_torch/kernels/ref.py
// (clip_sumsq, smooth_factors, clip_scale_ref, dp_mean_noise_ref) compute,
// bit for bit: every f32 step is a round-to-nearest intrinsic, so nvcc
// contracts nothing into an FMA.  A tile's sum of squares has a fixed
// order: partial t of 1024 sums the squares of elements 8t..8t+7 in
// sequence, then a halving tree adds partial i + half onto partial i (the
// last five levels by warp shuffles, which add lane i + off onto lane i:
// the same pairs).  A row's sum of its T partials: lane l of one warp adds
// partials l, l + 32, ... in sequence, then the shuffle tree; then
// __fsqrt_rn, __fadd_rn(tau, .) and __fdiv_rn(tau, .).  mean_noise adds
// the b samples of an element in sample order onto +0.0, multiplies by
// RN(1 / b) (what XLA makes of the reference's jitted acc / b) and adds
// RN(sigma * z).  A batch taken in chunks of samples (the port's per-sample
// gradients at LM size) runs it once a chunk: each chunk adds onto the
// running sum the last one wrote, and only the last multiplies by
// RN(1 / b) of the whole batch and adds the noise, so the chunked mean is
// the same additions in the same order as the one-shot mean, bit for bit.
//
// What bounds them on an H100.  At the training path's planes (the MLP's
// 10 x 7 tiles, 2.3 MB in f32) the launch: sumsq and scale each take
// ~3 us against bounds of 0.68 and 1.37, and the plain combine between
// them five more launches.  clip is one launch, on one of two routes
// chosen from the shape:
//
// - cluster (rows of at most 8 tiles: every plane of the training path):
//   one CTA a tile and one thread block cluster a row.  A CTA loads its
//   tile into registers, stages it in shared memory for the sum's layout,
//   sums it, meets its row at the cluster's hardware barrier, reads the
//   row's sums from its peers' shared memory, forms the factor and scales
//   the tile from its registers: the plane is read once (8 B an element in
//   f32), with no grid-wide barrier and no round trip through L2.
// - cooperative (longer rows, such as 2^24 elements in one row): one
//   persistent cooperative launch.  CTAs take contiguous runs of tiles and
//   sum them, all CTAs meet at one grid-wide barrier
//   (cooperative_groups::this_grid().sync()), each forms its rows' factors
//   from the partials in L2 (every CTA the same bits, so no second
//   barrier) and scales its tiles, reading them again (12 B an element).
//   Keeping a CTA's tiles in shared memory between the passes (fetched by
//   the Tensor Memory Accelerator's bulk copy) was built first and was no
//   faster on the planes that fit, so it is not kept.
//
// mean_noise is a streaming reduction with no product: its bound is the
// bytes, the b clipped samples read once and the noise and the mean
// written once (22.9 MB at PORTER-DP's 10 agents x 8 samples x 7 tiles in
// f32, 6.85 us), and at those planes the launch.  It replaces the eager
// route between the clip and the perturbed gradient (the unpack of the
// clipped plane, a sum and a division a leaf, the re-pack into a plane of
// another layout, a ones factor, scale_noise: ~11 launches and ~39 MB).
// A thread owns 8 consecutive elements of one output tile and issues the
// loads of kMeanBatch samples (16-byte ld.global.nc vectors, consecutive
// threads on consecutive addresses) and of z before its first add, so a
// whole DP plane is in flight at once; b is a runtime argument, taken in
// unrolled batches with the add order fixed.  The CTA is the largest of
// 256, 128, 64, 32 threads that still gives every SM a CTA, so a single
// model's gradient (DP-SGD: one group) fills the card too.
//
// A partial's 8 consecutive elements go to one thread (the sum's order
// fixes that layout; from shared memory its two 16-byte halves are read in
// an order that keeps the banks free of conflicts); the scale is
// elementwise, so it reads and stores whole 16-byte vectors with
// consecutive threads on consecutive addresses.  The sumsq / scale pair
// and scale_noise stay for callers of the passes alone (sumsq: one CTA of
// 1024 threads a tile; scale: four CTAs of 256 a tile).
//
// Interface: plain C, loaded with ctypes.  Pointers are device addresses of
// contiguous, 16-byte aligned buffers; bf16 != 0 reads and writes bf16
// planes (noise in the plane's dtype; mean_noise reads bf16 samples and
// takes f32 noise and writes f32), else f32; factors and partials are
// f32.  The stream is the caller's cudaStream_t.  Each entry point returns
// cudaGetLastError() after its launch, or cudaErrorInvalidValue for
// arguments it does not take; clip's cooperative route returns
// cudaErrorNotSupported where the card cannot launch cooperatively (and
// an occupancy of 0 as an error), and it never falls back to the pair.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kTile = 8 * 1024;           // kernels/flatten.TILE
constexpr int kVec = 8;                   // elements a thread
constexpr int kSumThreads = kTile / kVec;  // 1024 partials a tile
constexpr int kScaleThreads = 256;
constexpr int kScaleCtas = kTile / (kVec * kScaleThreads);  // 4 a tile
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void load8(const float* p, float v[kVec]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// bf16 -> f32 is exact: the bf16 bits are the f32's high half
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[kVec]) {
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void store8(float* p, const float v[kVec]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float v[kVec]) {
  uint4 o;
  o.x = bf16_bits(v[0]) | (bf16_bits(v[1]) << 16);
  o.y = bf16_bits(v[2]) | (bf16_bits(v[3]) << 16);
  o.z = bf16_bits(v[4]) | (bf16_bits(v[5]) << 16);
  o.w = bf16_bits(v[6]) | (bf16_bits(v[7]) << 16);
  *reinterpret_cast<uint4*>(p) = o;
}

template <typename T>
__global__ void __launch_bounds__(kSumThreads)
sumsq_kernel(const T* __restrict__ x, float* __restrict__ out) {
  __shared__ float part[kSumThreads];
  const int t = threadIdx.x;
  float v[kVec];
  load8(x + (int64_t)blockIdx.x * kTile + kVec * t, v);
  float s = __fmul_rn(v[0], v[0]);
#pragma unroll
  for (int j = 1; j < kVec; ++j) s = __fadd_rn(s, __fmul_rn(v[j], v[j]));
  part[t] = s;
  __syncthreads();
  for (int half = kSumThreads / 2; half >= 32; half >>= 1) {
    if (t < half) part[t] = __fadd_rn(part[t], part[t + half]);
    __syncthreads();
  }
  if (t < 32) {
    float p = part[t];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      p = __fadd_rn(p, __shfl_down_sync(kFull, p, off));
    }
    if (t == 0) out[blockIdx.x] = p;
  }
}

template <typename T, bool kNoise>
__global__ void __launch_bounds__(kScaleThreads)
scale_kernel(const T* __restrict__ x, const float* __restrict__ factor,
             const T* __restrict__ noise, float sigma, T* __restrict__ out,
             int64_t tiles_per_row) {
  const int64_t tile = blockIdx.x / kScaleCtas;
  const float f = __ldg(factor + tile / tiles_per_row);
  const int64_t at = tile * kTile +
                     (int64_t)(blockIdx.x % kScaleCtas) * kScaleThreads * kVec +
                     kVec * threadIdx.x;
  float v[kVec];
  load8(x + at, v);
  if (kNoise) {
    float z[kVec];
    load8(noise + at, z);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      v[j] = __fadd_rn(__fmul_rn(v[j], f), __fmul_rn(sigma, z[j]));
    }
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) v[j] = __fmul_rn(v[j], f);
  }
  store8(out + at, v);
}

template <typename T>
int launch_scale(const void* x, const void* factor, int64_t tiles_per_row,
                 const void* noise, float sigma, void* out, int64_t tiles,
                 cudaStream_t stream) {
  const int64_t blocks = tiles * kScaleCtas;
  if (noise == nullptr) {
    scale_kernel<T, false><<<(unsigned)blocks, kScaleThreads, 0, stream>>>(
        (const T*)x, (const float*)factor, nullptr, 0.0f, (T*)out,
        tiles_per_row);
  } else {
    scale_kernel<T, true><<<(unsigned)blocks, kScaleThreads, 0, stream>>>(
        (const T*)x, (const float*)factor, (const T*)noise, sigma, (T*)out,
        tiles_per_row);
  }
  return (int)cudaGetLastError();
}

// ---- mean_noise: the DP perturbation of the sample mean ----------------

constexpr int kMeanBatch = 8;        // samples whose loads are in flight
constexpr int kMeanThreads = 256;    // the largest CTA; halved to fill SMs
constexpr int kTileVecs = kTile / kVec;   // 1024 vectors of 8 a tile

// Vector v (8 elements) of the (groups * T, kTile) output: output tile
// o = v / 1024 is tile t of group g (o = g * T + t), and sample s of the
// group is input tile (g * b + s) * T + t.  The sum runs in sample order
// from acc[o] where acc is given (a running sum over earlier chunks of
// samples), else from +0.0.  kOut picks what is written: kSum the raw sum
// (a chunk that is not the last), kMean RN(RN(sum) * inv_b), kMeanNoise
// RN(RN(sum) * inv_b) + RN(sigma * z); inv_b is RN(1 / b_total), b_total
// every sample of the batch, not the chunk's b.  kBatch samples' loads
// are issued before their adds (kMeanBatch, or 1 for a one-sample chunk,
// whose kernel then keeps no registers for the other seven and fits more
// CTAs on an SM); the adds run in sample order either way.
constexpr int kSum = 0, kMean = 1, kMeanNoise = 2;

template <typename T, int kOut, int kBatch>
__global__ void __launch_bounds__(kMeanThreads)
mean_noise_kernel(const T* __restrict__ x, const float* __restrict__ noise,
                  const float* __restrict__ acc_in, float inv_b, float sigma,
                  float* __restrict__ out, int64_t tiles_per_row, int b) {
  const int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t o = v / kTileVecs;
  const int64_t e = (v % kTileVecs) * kVec;
  // groups * b * tiles_per_row < 2^31 (the launcher checks it), so the
  // tile's group and place divide in 32 bits, not in a 64-bit routine
  const uint32_t g = (uint32_t)o / (uint32_t)tiles_per_row;
  const uint32_t t = (uint32_t)o - g * (uint32_t)tiles_per_row;
  const T* src = x + ((int64_t)g * b * tiles_per_row + t) * kTile + e;
  const int64_t step = tiles_per_row * kTile;   // one sample further on
  float z[kVec], acc[kVec];
  if (kOut == kMeanNoise) load8(noise + o * kTile + e, z);
  if (acc_in != nullptr) {
    load8(acc_in + o * kTile + e, acc);
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc[j] = 0.0f;
  }
  for (int s0 = 0; s0 < b; s0 += kBatch) {
    float xs[kBatch][kVec];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (s0 + i < b) load8(src + i * step, xs[i]);
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (s0 + i < b) {
#pragma unroll
        for (int j = 0; j < kVec; ++j) acc[j] = __fadd_rn(acc[j], xs[i][j]);
      }
    }
    src += kBatch * step;
  }
  if (kOut != kSum) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      acc[j] = kOut == kMeanNoise ? __fadd_rn(__fmul_rn(acc[j], inv_b),
                                              __fmul_rn(sigma, z[j]))
                                  : __fmul_rn(acc[j], inv_b);
    }
  }
  store8(out + o * kTile + e, acc);
}

// The CTA size for `vecs` vectors: the largest of 256, 128, 64, 32
// threads that still gives every SM at least one CTA.
cudaError_t mean_noise_threads(int64_t vecs, int* threads) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  int n = kMeanThreads;
  while (n > 32 && vecs / n < sms) n /= 2;
  *threads = n;
  return cudaSuccess;
}

template <typename T, int kOut>
void launch_mean_noise_out(unsigned blocks, int threads, cudaStream_t stream,
                           const T* x, const float* noise,
                           const float* acc_in, float inv_b, float sigma,
                           float* out, int64_t tiles_per_row, int b) {
  if (b == 1) {
    mean_noise_kernel<T, kOut, 1><<<blocks, threads, 0, stream>>>(
        x, noise, acc_in, inv_b, sigma, out, tiles_per_row, b);
  } else {
    mean_noise_kernel<T, kOut, kMeanBatch><<<blocks, threads, 0, stream>>>(
        x, noise, acc_in, inv_b, sigma, out, tiles_per_row, b);
  }
}

template <typename T>
int launch_mean_noise(const void* x, const void* noise, const void* acc,
                      int finish, float sigma, void* out, int64_t groups,
                      int64_t b, int64_t b_total, int64_t tiles_per_row,
                      cudaStream_t stream) {
  const int64_t vecs = groups * tiles_per_row * kTileVecs;
  int threads = 0;
  const cudaError_t e = mean_noise_threads(vecs, &threads);
  if (e != cudaSuccess) return (int)e;
  if (vecs / threads > 0x7fffffff) return (int)cudaErrorInvalidValue;
  // RN(1 / b_total) in f32: the host's IEEE division, correctly rounded
  const float inv_b = 1.0f / (float)b_total;
  const unsigned blocks = (unsigned)(vecs / threads);
  const T* xs = (const T*)x;
  const float* acc_in = (const float*)acc;
  if (!finish) {
    launch_mean_noise_out<T, kSum>(blocks, threads, stream, xs, nullptr,
                                   acc_in, inv_b, 0.0f, (float*)out,
                                   tiles_per_row, (int)b);
  } else if (noise != nullptr) {
    launch_mean_noise_out<T, kMeanNoise>(blocks, threads, stream, xs,
                                         (const float*)noise, acc_in, inv_b,
                                         sigma, (float*)out, tiles_per_row,
                                         (int)b);
  } else {
    launch_mean_noise_out<T, kMean>(blocks, threads, stream, xs, nullptr,
                                    acc_in, inv_b, 0.0f, (float*)out,
                                    tiles_per_row, (int)b);
  }
  return (int)cudaGetLastError();
}

// ---- clip: the fused kernel --------------------------------------------

constexpr int kClipThreads = 512;           // two partials of 8 a thread
constexpr int kClipWarps = kClipThreads / 32;
constexpr int kHalf = kTile / 2;            // partial t + 512 starts here

template <typename T>
__host__ __device__ constexpr int tile_bytes() { return kTile * (int)sizeof(T); }

__device__ __forceinline__ float sq8(const float v[kVec]) {
  float s = __fmul_rn(v[0], v[0]);
#pragma unroll
  for (int j = 1; j < kVec; ++j) s = __fadd_rn(s, __fmul_rn(v[j], v[j]));
  return s;
}

// elements 8u..8u+7 of a tile in shared memory.  In f32 they are the
// 16-byte slots 2u and 2u + 1; the 8 threads of a quarter-warp read them
// in the order that puts each read on its own banks, then swap back.
__device__ __forceinline__ void load8_shared(const float* tile, int u,
                                             float v[kVec]) {
  const float4* q = reinterpret_cast<const float4*>(tile) + 2 * u;
  const int sel = (u >> 2) & 1;
  float4 a = q[sel], b = q[sel ^ 1];
  if (sel) {
    const float4 t = a;
    a = b;
    b = t;
  }
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void unpack_bf16(uint4 a, float v[kVec]) {
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void load8_shared(const __nv_bfloat16* tile, int u,
                                             float v[kVec]) {
  unpack_bf16(reinterpret_cast<const uint4*>(tile)[u], v);
}

// y = x * f (+ sigma * z) on one 16-byte vector of the plane's dtype (the
// first argument only picks the overload)
template <bool kNoise>
__device__ __forceinline__ uint4 scale16(float, uint4 x, uint4 z, float f,
                                         float sigma) {
  uint32_t w[4] = {x.x, x.y, x.z, x.w};
  const uint32_t n[4] = {z.x, z.y, z.z, z.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float y = __fmul_rn(__uint_as_float(w[i]), f);
    if (kNoise) y = __fadd_rn(y, __fmul_rn(sigma, __uint_as_float(n[i])));
    w[i] = __float_as_uint(y);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <bool kNoise>
__device__ __forceinline__ uint4 scale16(__nv_bfloat16, uint4 x, uint4 z,
                                         float f, float sigma) {
  float v[kVec], n[kVec];
  unpack_bf16(x, v);
  if (kNoise) unpack_bf16(z, n);
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    v[j] = __fmul_rn(v[j], f);
    if (kNoise) v[j] = __fadd_rn(v[j], __fmul_rn(sigma, n[j]));
  }
  return make_uint4(bf16_bits(v[0]) | (bf16_bits(v[1]) << 16),
                    bf16_bits(v[2]) | (bf16_bits(v[3]) << 16),
                    bf16_bits(v[4]) | (bf16_bits(v[5]) << 16),
                    bf16_bits(v[6]) | (bf16_bits(v[7]) << 16));
}

// The rest of a tile's tree in warp 0, from its 512 first-level partials
// in shared memory: levels 256 ... 32 add partials of one lane (lane l
// holds l + 32j), then the shuffles; lane 0 gets the tile's sum.
__device__ __forceinline__ float tile_tree(const float* r, int lane) {
  static_assert(kClipWarps == 16, "the tree below is written for 16");
  float c[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) c[j] = r[lane + 32 * j];
#pragma unroll
  for (int j = 0; j < 8; ++j) c[j] = __fadd_rn(c[j], c[j + 8]);
#pragma unroll
  for (int j = 0; j < 4; ++j) c[j] = __fadd_rn(c[j], c[j + 4]);
  c[0] = __fadd_rn(c[0], c[2]);
  c[1] = __fadd_rn(c[1], c[3]);
  float p = __fadd_rn(c[0], c[1]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    p = __fadd_rn(p, __shfl_down_sync(kFull, p, off));
  }
  return p;
}

// A row's factor in one warp from its lanes' sums (lane l: partials l,
// l + 32, ... in sequence from +0.0): the shuffle tree, then
// tau / (tau + sqrt(sum)); lane 0 gets it.
__device__ __forceinline__ float row_factor(float s, float tau) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s = __fadd_rn(s, __shfl_down_sync(kFull, s, off));
  }
  return __fdiv_rn(tau, __fadd_rn(tau, __fsqrt_rn(s)));
}

// Rows of more than kMaxCluster tiles: one persistent cooperative launch.
// CTA b takes the tiles [t0, t1), per_cta of them (fewer in the last CTA),
// sums them, meets every CTA at one grid-wide barrier, forms its rows'
// factors from the partials in L2 and scales its tiles, reading them again.
template <typename T, bool kNoise>
__global__ void __launch_bounds__(kClipThreads, 2)
clip_kernel(const T* __restrict__ x, const T* __restrict__ noise,
            float sigma, float tau, T* __restrict__ out,
            float* __restrict__ partials, float* __restrict__ factors,
            int64_t tiles, int64_t tiles_per_row, int64_t per_cta) {
  constexpr int kVecs = tile_bytes<T>() / 16;   // 16-byte vectors a tile
  __shared__ float red[2 * kClipThreads];
  __shared__ float fac[kClipWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t t0 = (int64_t)blockIdx.x * per_cta;
  const int64_t t1 = min(t0 + per_cta, tiles);

  // pass 1: every tile's partial, in the sumsq kernel's order
  for (int64_t t = t0; t < t1; ++t) {
    float a[kVec], b[kVec];
    load8(x + t * kTile + kVec * tid, a);
    load8(x + t * kTile + kHalf + kVec * tid, b);
    // partials t and t + 512 of the tile's 1024, and the tree's first
    // level; tiles alternate between two sets, so warp 0 may still read
    // this set while the others write the next (the next barrier orders
    // the one after)
    float* r = red + ((t - t0) & 1) * kClipThreads;
    r[tid] = __fadd_rn(sq8(a), sq8(b));
    __syncthreads();
    if (warp == 0) {
      const float p = tile_tree(r, lane);
      if (lane == 0) partials[t] = p;
    }
  }

  cooperative_groups::this_grid().sync();

  // pass 2: the factors of this CTA's rows, kClipWarps at a time (one a
  // warp; every CTA forms the same bits, so no second barrier), then the
  // scale of their tiles
  const int64_t r0 = t0 / tiles_per_row, r1 = (t1 - 1) / tiles_per_row;
  for (int64_t rg = r0; rg <= r1; rg += kClipWarps) {
    const int64_t row = rg + warp;
    if (row <= r1) {
      // lane l: partials l, l + 32, ... in sequence (+0.0 past the row's
      // end, exact on a sum of squares), then the shuffle tree
      const float* p = partials + row * tiles_per_row;
      float s = 0.0f;
      for (int64_t base = lane; base < tiles_per_row; base += 32 * 8) {
        float q[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int64_t at = base + 32 * j;
          q[j] = at < tiles_per_row ? __ldcg(p + at) : 0.0f;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) s = __fadd_rn(s, q[j]);
      }
      const float f = row_factor(s, tau);
      if (lane == 0) {
        fac[warp] = f;
        const int64_t first = row * tiles_per_row;
        if (t0 <= first && first < t1) factors[row] = f;
      }
    }
    __syncthreads();
    const int64_t lo = max(t0, rg * tiles_per_row);
    const int64_t hi = min(t1, (rg + kClipWarps) * tiles_per_row);
    for (int64_t t = lo; t < hi; ++t) {
      const float f = fac[t / tiles_per_row - rg];
      const uint4* src = reinterpret_cast<const uint4*>(x + t * kTile);
      const uint4* zs = reinterpret_cast<const uint4*>(noise + t * kTile);
      uint4* dst = reinterpret_cast<uint4*>(out + t * kTile);
#pragma unroll
      for (int m = 0; m < kVecs / kClipThreads; ++m) {
        const int at = tid + m * kClipThreads;
        const uint4 v = __ldg(src + at);
        const uint4 z = kNoise ? __ldg(zs + at) : v;
        dst[at] = scale16<kNoise>(T(), v, z, f, sigma);
      }
    }
    __syncthreads();
  }
}

// Rows of at most kMaxCluster tiles: one CTA a tile, one thread block
// cluster a row.  Each CTA loads its tile into registers (16-byte vectors
// t, t + 512, ... a thread, coalesced), stages it in shared memory for the
// sum's layout, sums it and leaves the sum in its shared memory, and meets
// its row at the cluster's hardware barrier; warp 0 of each CTA reads the
// row's sums from its peers' shared memory (lane l the sum of tile l, in
// the row order above) and forms the factor, and the CTA scales the tile
// from its registers.  No grid-wide barrier, no round trip through L2,
// and no co-residency needed beyond the cluster.
constexpr int kMaxCluster = 8;   // the portable cluster size

template <typename T>
constexpr size_t cluster_smem() {
  return (size_t)tile_bytes<T>() + kClipThreads * 4 + 8;
}

template <typename T, bool kNoise>
__global__ void __launch_bounds__(kClipThreads, 3)
clip_cluster_kernel(const T* __restrict__ x, const T* __restrict__ noise,
                    float sigma, float tau, T* __restrict__ out,
                    float* __restrict__ partials,
                    float* __restrict__ factors, int tiles_per_row) {
  constexpr int kHeld = tile_bytes<T>() / 16 / kClipThreads;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t t = blockIdx.x;
  T* staged = reinterpret_cast<T*>(smem);
  float* red = reinterpret_cast<float*>(smem + tile_bytes<T>());
  float* mine = red + kClipThreads;   // this tile's sum, read by the row
  float* fac = mine + 1;
  const uint4* src = reinterpret_cast<const uint4*>(x + t * kTile);
  uint4 v[kHeld];
#pragma unroll
  for (int m = 0; m < kHeld; ++m) v[m] = __ldg(src + tid + m * kClipThreads);
#pragma unroll
  for (int m = 0; m < kHeld; ++m) {
    reinterpret_cast<uint4*>(staged)[tid + m * kClipThreads] = v[m];
  }
  __syncthreads();
  float a[kVec], b[kVec];
  load8_shared(staged, tid, a);
  load8_shared(staged + kHalf, tid, b);
  red[tid] = __fadd_rn(sq8(a), sq8(b));
  __syncthreads();
  if (warp == 0) {
    const float p = tile_tree(red, lane);
    if (lane == 0) {
      *mine = p;
      partials[t] = p;
    }
  }
  cooperative_groups::cluster_group row = cooperative_groups::this_cluster();
  row.sync();
  if (warp == 0) {
    const float s = lane < tiles_per_row
        ? __fadd_rn(0.0f, *row.map_shared_rank(mine, lane)) : 0.0f;
    const float f = row_factor(s, tau);
    if (lane == 0) {
      *fac = f;
      if (row.block_rank() == 0) factors[t / tiles_per_row] = f;
    }
  }
  __syncthreads();
  // done with the peers' shared memory: arrive now, wait before exiting
  // (a CTA's shared memory must outlive its peers' reads)
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  const float f = *fac;
  const uint4* zs = reinterpret_cast<const uint4*>(noise + t * kTile);
  uint4* dst = reinterpret_cast<uint4*>(out + t * kTile);
#pragma unroll
  for (int m = 0; m < kHeld; ++m) {
    const int at = tid + m * kClipThreads;
    const uint4 z = kNoise ? __ldg(zs + at) : v[m];
    dst[at] = scale16<kNoise>(T(), v[m], z, f, sigma);
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The launch shape of one clip: the route, the grid and the tiles a CTA.
// Rows of at most kMaxCluster tiles take the cluster route (one CTA a
// tile); longer ones the cooperative launch, at the occupancy's grid
// capped at the tile count.
struct ClipPlan {
  int cluster;
  int64_t grid, per_cta;
};

// How many of the cooperative kernel's CTAs fit on the device at once
// (CTAs an SM times the SMs), asked once a device; an error where the card
// cannot launch cooperatively or fits none.
template <typename T, bool kNoise>
cudaError_t clip_grid_most(int64_t* most) {
  static std::mutex lock;
  static int64_t cached[16] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 16) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> guard(lock);
  if (cached[dev] == 0) {
    int coop = 0, sms = 0, per_sm = 0;
    if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                    dev)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, clip_kernel<T, kNoise>, kClipThreads, 0)) !=
            cudaSuccess) {
      return e;
    }
    if (!coop) return cudaErrorNotSupported;
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    cached[dev] = (int64_t)per_sm * sms;
  }
  *most = cached[dev];
  return cudaSuccess;
}

template <typename T, bool kNoise>
cudaError_t clip_plan_of(int64_t tiles, int64_t tiles_per_row,
                         ClipPlan* plan) {
  if (tiles_per_row <= kMaxCluster) {
    *plan = {1, tiles, 1};
    return cudaSuccess;
  }
  int64_t most = 0;
  const cudaError_t e = clip_grid_most<T, kNoise>(&most);
  if (e != cudaSuccess) return e;
  const int64_t per_cta = (tiles + most - 1) / most;
  *plan = {0, (tiles + per_cta - 1) / per_cta, per_cta};
  return cudaSuccess;
}

template <typename T, bool kNoise>
int launch_clip(const void* x, const void* noise, float sigma, float tau,
                void* out, void* partials, void* factors, int64_t tiles,
                int64_t tiles_per_row, cudaStream_t stream) {
  ClipPlan plan;
  cudaError_t e = clip_plan_of<T, kNoise>(tiles, tiles_per_row, &plan);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)plan.grid);
  cfg.blockDim = dim3(kClipThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (plan.cluster) {
    cfg.dynamicSmemBytes = cluster_smem<T>();
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)tiles_per_row;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    e = cudaLaunchKernelEx(&cfg, clip_cluster_kernel<T, kNoise>,
                           (const T*)x, (const T*)noise, sigma, tau, (T*)out,
                           (float*)partials, (float*)factors,
                           (int)tiles_per_row);
  } else {
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    e = cudaLaunchKernelEx(&cfg, clip_kernel<T, kNoise>, (const T*)x,
                           (const T*)noise, sigma, tau, (T*)out,
                           (float*)partials, (float*)factors, tiles,
                           tiles_per_row, plan.per_cta);
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
cudaError_t clip_plan_dt(int noisy, int64_t tiles, int64_t tiles_per_row,
                         ClipPlan* p) {
  return noisy ? clip_plan_of<T, true>(tiles, tiles_per_row, p)
               : clip_plan_of<T, false>(tiles, tiles_per_row, p);
}

template <typename T>
int launch_clip_dt(const void* x, const void* noise, float sigma, float tau,
                   void* out, void* partials, void* factors, int64_t tiles,
                   int64_t tiles_per_row, cudaStream_t s) {
  return noise == nullptr
      ? launch_clip<T, false>(x, noise, sigma, tau, out, partials, factors,
                              tiles, tiles_per_row, s)
      : launch_clip<T, true>(x, noise, sigma, tau, out, partials, factors,
                             tiles, tiles_per_row, s);
}

}  // namespace

extern "C" int clip_sumsq(const void* x, int bf16, void* out, int64_t tiles,
                          void* stream) {
  if (tiles < 1 || tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    sumsq_kernel<__nv_bfloat16><<<(unsigned)tiles, kSumThreads, 0, s>>>(
        (const __nv_bfloat16*)x, (float*)out);
  } else {
    sumsq_kernel<float><<<(unsigned)tiles, kSumThreads, 0, s>>>(
        (const float*)x, (float*)out);
  }
  return (int)cudaGetLastError();
}

// noise == nullptr launches scale, else scale_noise
extern "C" int clip_scale(const void* x, int bf16, const void* factor,
                          int64_t tiles_per_row, const void* noise,
                          float sigma, void* out, int64_t tiles,
                          void* stream) {
  if (tiles < 1 || tiles_per_row < 1 || tiles % tiles_per_row != 0 ||
      tiles > 0x7fffffff / kScaleCtas) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    return launch_scale<__nv_bfloat16>(x, factor, tiles_per_row, noise, sigma,
                                       out, tiles, s);
  }
  return launch_scale<float>(x, factor, tiles_per_row, noise, sigma, out,
                             tiles, s);
}

// The route clip_fused takes for a plane of `tiles` tiles, rows of
// tiles_per_row: plan[0] 1 cluster / 0 cooperative, plan[1] the grid,
// plan[2] the tiles a CTA.  Launches nothing.
extern "C" int clip_plan(int bf16, int noisy, int64_t tiles,
                         int64_t tiles_per_row, int64_t* plan) {
  if (tiles < 1 || tiles > 0x7fffffff || tiles_per_row < 1 ||
      tiles % tiles_per_row != 0) {
    return (int)cudaErrorInvalidValue;
  }
  ClipPlan p;
  const cudaError_t e =
      bf16 ? clip_plan_dt<__nv_bfloat16>(noisy, tiles, tiles_per_row, &p)
           : clip_plan_dt<float>(noisy, tiles, tiles_per_row, &p);
  if (e != cudaSuccess) return (int)e;
  plan[0] = p.cluster;
  plan[1] = p.grid;
  plan[2] = p.per_cta;
  return 0;
}

// The smooth clip in one launch: out = x * f_row (+ sigma * noise where
// noise != nullptr), with the partials (tiles,) and the factors
// (tiles / tiles_per_row,) written on the way.
extern "C" int clip_fused(const void* x, int bf16, const void* noise,
                          float sigma, float tau, void* out, void* partials,
                          void* factors, int64_t tiles,
                          int64_t tiles_per_row, void* stream) {
  if (tiles < 1 || tiles > 0x7fffffff || tiles_per_row < 1 ||
      tiles % tiles_per_row != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? launch_clip_dt<__nv_bfloat16>(x, noise, sigma, tau, out,
                                              partials, factors, tiles,
                                              tiles_per_row, s)
              : launch_clip_dt<float>(x, noise, sigma, tau, out, partials,
                                      factors, tiles, tiles_per_row, s);
}

// The DP perturbation of the sample mean: x holds groups * b rows of
// tiles_per_row tiles (group g's sample s is row g * b + s), noise, acc
// and out groups rows (f32).  The sum over the b samples starts from acc
// where acc is not null (the running sum of earlier chunks), else from
// +0.0.  finish == 0 writes that sum; else out[g] = sum * RN(1 / b_total)
// + sigma * noise[g], or the mean alone where noise is null.  noise goes
// with finish only.
extern "C" int clip_mean_noise(const void* x, int bf16, const void* noise,
                               const void* acc, int finish, float sigma,
                               void* out, int64_t groups, int64_t b,
                               int64_t b_total, int64_t tiles_per_row,
                               void* stream) {
  if (groups < 1 || b < 1 || b_total < b || tiles_per_row < 1 ||
      groups > 0x7fffffff || b_total > 0x7fffffff ||
      tiles_per_row > 0x7fffffff ||
      groups * b > 0x7fffffff / tiles_per_row ||
      (noise != nullptr && !finish)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? launch_mean_noise<__nv_bfloat16>(x, noise, acc, finish, sigma,
                                                 out, groups, b, b_total,
                                                 tiles_per_row, s)
              : launch_mean_noise<float>(x, noise, acc, finish, sigma, out,
                                         groups, b, b_total, tiles_per_row,
                                         s);
}
