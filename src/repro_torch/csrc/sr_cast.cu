// Stochastic-rounding cast f32 -> bf16 for Hopper.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/sr_cast.py
// (sr_cast / _sr_kernel):
//
//   bf16_bits(x) = high16( bits(x) + (r & 0xFFFF) )      (mod 2^32)
//
// with r a random word per element, drawn outside the kernel and passed in
// as an operand, so the kernel and its plain PyTorch version
// (src/repro_torch/kernels/ref.py::sr_cast_ref) round identically on the
// same bits.  The random words are int32 here (the reference's u32 words,
// same bit patterns); only their low 16 bits are read.
//
// What bounds it on an H100: memory bandwidth.  Per element it reads 4 B of
// f32 and 4 B of bits and writes 2 B of bf16 (10 B) for one integer add and
// one shift.  So it is one grid-stride pass with 16-byte accesses: a thread
// takes 8 elements per iteration (two 16 B loads of f32, two of bits, one
// 16 B store of bf16), with a scalar tail for what is left or unaligned.
// The rounding of one element, sr_one, lives in sr_round.cuh, which the ef
// kernels (ef_update.cu) include for the same rounding as their epilogue.
//
// Interface: plain C, loaded with ctypes.  x, bits and out are device
// addresses of contiguous buffers of n elements; the stream is the caller's
// cudaStream_t.  Returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sr_round.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;
constexpr int kVec = 8;

__global__ void __launch_bounds__(kThreads)
sr_kernel(const float* __restrict__ x, const uint32_t* __restrict__ bits,
          uint16_t* __restrict__ out, int64_t n, bool vec) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t done = 0;
  if (vec) {
    const int64_t nv = n / kVec;
    for (int64_t j = i; j < nv; j += stride) {
      const float4* xs = reinterpret_cast<const float4*>(x) + 2 * j;
      const uint4* bs = reinterpret_cast<const uint4*>(bits) + 2 * j;
      const float4 x0 = __ldg(xs), x1 = __ldg(xs + 1);
      const uint4 b0 = __ldg(bs), b1 = __ldg(bs + 1);
      uint4 o;
      o.x = sr_one(x0.x, b0.x) | ((uint32_t)sr_one(x0.y, b0.y) << 16);
      o.y = sr_one(x0.z, b0.z) | ((uint32_t)sr_one(x0.w, b0.w) << 16);
      o.z = sr_one(x1.x, b1.x) | ((uint32_t)sr_one(x1.y, b1.y) << 16);
      o.w = sr_one(x1.z, b1.z) | ((uint32_t)sr_one(x1.w, b1.w) << 16);
      reinterpret_cast<uint4*>(out)[j] = o;
    }
    done = nv * kVec;
  }
  for (int64_t j = done + i; j < n; j += stride) {
    out[j] = sr_one(x[j], bits[j]);
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" int sr_cast(const void* x, const void* bits, void* out, int64_t n,
                       void* stream) {
  const bool vec = aligned16(x) && aligned16(bits) && aligned16(out);
  const int64_t work = (n + kVec - 1) / kVec;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  sr_kernel<<<(int)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const uint32_t*)bits, (uint16_t*)out, n, vec);
  return (int)cudaGetLastError();
}
