// Fused PORTER error-feedback updates (Algorithm 1 lines 11-14) for Hopper.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/ef_update.py:
//   ef_track_f32  <- ef_track (_track_kernel):  q += c; m += wc;
//                    v = ((v + gamma*(m - q)) + g) - gp
//   ef_step_f32   <- ef_step  (_step_kernel):   q += c; m += wc;
//                    x = (x + gamma*(m - q)) - eta*v
//
// What bounds it on an H100: memory bandwidth.  Per element ef_track reads
// 7 f32 planes and writes 3 (40 B for 7 flops), ef_step reads 6 and writes
// 3 (36 B for 6 flops) -- about 0.2 flop per byte against the card's ~20
// (67 TFLOP/s f32 over 3.35 TB/s).  The design therefore makes exactly one
// pass over the planes: every operand is read once with 16-byte loads,
// nothing intermediate touches device memory, and each output is written
// once.  A grid-stride loop keeps the grid a small multiple of the SM count
// whatever the plane size.
//
// Bit-exact arithmetic: every add, subtract and multiply is an explicit
// round-to-nearest intrinsic, so the compiler cannot contract
// v + gamma*(m - q) into an FMA, and the result equals the plain PyTorch
// version (src/repro_torch/kernels/ref.py) bit for bit, in the reference's
// order of operations.
//
// Interface: plain C, loaded with ctypes.  Pointers are device addresses of
// contiguous f32 buffers of n elements (outputs distinct from inputs); the
// stream is the caller's cudaStream_t.  Each function returns
// cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

struct Track {
  float gamma;
  __device__ __forceinline__ void operator()(float q, float m, float v,
                                             float c, float wc, float g,
                                             float gp, float& qo, float& mo,
                                             float& vo) const {
    qo = __fadd_rn(q, c);
    mo = __fadd_rn(m, wc);
    vo = __fsub_rn(
        __fadd_rn(__fadd_rn(v, __fmul_rn(gamma, __fsub_rn(mo, qo))), g), gp);
  }
};

struct Step {
  float gamma, eta;
  __device__ __forceinline__ void operator()(float q, float m, float x,
                                             float c, float wc, float v,
                                             float& qo, float& mo,
                                             float& xo) const {
    qo = __fadd_rn(q, c);
    mo = __fadd_rn(m, wc);
    xo = __fsub_rn(__fadd_rn(x, __fmul_rn(gamma, __fsub_rn(mo, qo))),
                   __fmul_rn(eta, v));
  }
};

__global__ void __launch_bounds__(kThreads)
track_kernel(const float* __restrict__ q, const float* __restrict__ m,
             const float* __restrict__ v, const float* __restrict__ c,
             const float* __restrict__ wc, const float* __restrict__ g,
             const float* __restrict__ gp, float* __restrict__ qo,
             float* __restrict__ mo, float* __restrict__ vo, Track op,
             int64_t n, bool vec) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t done = 0;
  if (vec) {
    const int64_t n4 = n / 4;
    for (int64_t j = i; j < n4; j += stride) {
      const float4 a = reinterpret_cast<const float4*>(q)[j];
      const float4 b = reinterpret_cast<const float4*>(m)[j];
      const float4 s = reinterpret_cast<const float4*>(v)[j];
      const float4 d = reinterpret_cast<const float4*>(c)[j];
      const float4 e = reinterpret_cast<const float4*>(wc)[j];
      const float4 f = reinterpret_cast<const float4*>(g)[j];
      const float4 h = reinterpret_cast<const float4*>(gp)[j];
      float4 oq, om, ov;
      op(a.x, b.x, s.x, d.x, e.x, f.x, h.x, oq.x, om.x, ov.x);
      op(a.y, b.y, s.y, d.y, e.y, f.y, h.y, oq.y, om.y, ov.y);
      op(a.z, b.z, s.z, d.z, e.z, f.z, h.z, oq.z, om.z, ov.z);
      op(a.w, b.w, s.w, d.w, e.w, f.w, h.w, oq.w, om.w, ov.w);
      reinterpret_cast<float4*>(qo)[j] = oq;
      reinterpret_cast<float4*>(mo)[j] = om;
      reinterpret_cast<float4*>(vo)[j] = ov;
    }
    done = n4 * 4;
  }
  for (int64_t j = done + i; j < n; j += stride) {
    op(q[j], m[j], v[j], c[j], wc[j], g[j], gp[j], qo[j], mo[j], vo[j]);
  }
}

__global__ void __launch_bounds__(kThreads)
step_kernel(const float* __restrict__ q, const float* __restrict__ m,
            const float* __restrict__ x, const float* __restrict__ c,
            const float* __restrict__ wc, const float* __restrict__ v,
            float* __restrict__ qo, float* __restrict__ mo,
            float* __restrict__ xo, Step op, int64_t n, bool vec) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t done = 0;
  if (vec) {
    const int64_t n4 = n / 4;
    for (int64_t j = i; j < n4; j += stride) {
      const float4 a = reinterpret_cast<const float4*>(q)[j];
      const float4 b = reinterpret_cast<const float4*>(m)[j];
      const float4 s = reinterpret_cast<const float4*>(x)[j];
      const float4 d = reinterpret_cast<const float4*>(c)[j];
      const float4 e = reinterpret_cast<const float4*>(wc)[j];
      const float4 f = reinterpret_cast<const float4*>(v)[j];
      float4 oq, om, ox;
      op(a.x, b.x, s.x, d.x, e.x, f.x, oq.x, om.x, ox.x);
      op(a.y, b.y, s.y, d.y, e.y, f.y, oq.y, om.y, ox.y);
      op(a.z, b.z, s.z, d.z, e.z, f.z, oq.z, om.z, ox.z);
      op(a.w, b.w, s.w, d.w, e.w, f.w, oq.w, om.w, ox.w);
      reinterpret_cast<float4*>(qo)[j] = oq;
      reinterpret_cast<float4*>(mo)[j] = om;
      reinterpret_cast<float4*>(xo)[j] = ox;
    }
    done = n4 * 4;
  }
  for (int64_t j = done + i; j < n; j += stride) {
    op(q[j], m[j], x[j], c[j], wc[j], v[j], qo[j], mo[j], xo[j]);
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

inline int blocks_for(int64_t n) {
  const int64_t work = (n + 3) / 4;
  int64_t b = (work + kThreads - 1) / kThreads;
  if (b > kMaxBlocks) b = kMaxBlocks;
  return b < 1 ? 1 : (int)b;
}

}  // namespace

extern "C" int ef_track_f32(const void* q, const void* m, const void* v,
                            const void* c, const void* wc, const void* g,
                            const void* gp, void* qo, void* mo, void* vo,
                            float gamma, int64_t n, void* stream) {
  const void* ptrs[] = {q, m, v, c, wc, g, gp, qo, mo, vo};
  bool vec = true;
  for (const void* p : ptrs) vec = vec && aligned16(p);
  track_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)m, (const float*)v, (const float*)c,
      (const float*)wc, (const float*)g, (const float*)gp, (float*)qo,
      (float*)mo, (float*)vo, Track{gamma}, n, vec);
  return (int)cudaGetLastError();
}

extern "C" int ef_step_f32(const void* q, const void* m, const void* x,
                           const void* c, const void* wc, const void* v,
                           void* qo, void* mo, void* xo, float gamma,
                           float eta, int64_t n, void* stream) {
  const void* ptrs[] = {q, m, x, c, wc, v, qo, mo, xo};
  bool vec = true;
  for (const void* p : ptrs) vec = vec && aligned16(p);
  step_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)m, (const float*)x, (const float*)c,
      (const float*)wc, (const float*)v, (float*)qo, (float*)mo, (float*)xo,
      Step{gamma, eta}, n, vec);
  return (int)cudaGetLastError();
}
