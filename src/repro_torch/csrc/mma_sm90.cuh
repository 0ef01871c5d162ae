// Tensor-core and copy helpers shared by the chunked-scan kernels for
// Hopper (sm_90a): ssd_chunk.cu and rwkv6_chunk.cu.
//
//   - cp.async copies into shared memory (16 or 4 bytes, zero-filled
//     beyond `bytes`), their commit and wait;
//   - ldmatrix loads of bf16 fragments, plain and transposed, and the
//     fragment loads of 16-row bf16 tiles stored [16][NW] with their 16-byte
//     chunks XOR-swizzled by row (swz), so that the 8 rows one ldmatrix
//     reads fall in 8 distinct bank groups;
//   - mma.sync.m16n8k16 with bf16 operands and f32 accumulation;
//   - f32 values as two or three bf16 parts (cvt.rn) whose sum carries 16
//     or 24 of their significant bits, for products whose operands are f32.
//
// Fragment layouts are those of the PTX ISA for m16n8k16 (row.col): lane
// = 4 r + q holds A rows r and r + 8, depth 2 q (+ 1) and 2 q + 8 (+ 1);
// B depth 2 q (+ 1) and 2 q + 8 (+ 1), column r; the accumulator rows r and
// r + 8, columns 2 q (+ 1).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mma_sm90 {

// chunk index of (row t, chunk ch) in a tile of CPR 16-byte chunks a row,
// XOR-swizzled so that 8 rows of one column chunk fall in 8 distinct 16-B
// bank groups
template <int CPR>
__device__ __forceinline__ int swz(int t, int ch) {
  constexpr int kRpw = CPR >= 8 ? 1 : 8 / CPR;   // rows a 128-B window
  constexpr int kXm = CPR >= 8 ? 7 : CPR - 1;
  return t * CPR + (ch ^ ((t / kRpw) & kXm));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row))
      : "memory");
}

// d += a b: m16n8k16, bf16 operands, f32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) as a bf16 pair hi (x0 in the low half) and the pair of the
// residuals lo: hi + lo carries 16 significant bits of each
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// (x0, x1) as three bf16 pairs a1 + a2 + a3: 24 significant bits of each
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& a1,
                                       uint32_t& a2, uint32_t& a3) {
  const __nv_bfloat162 h1 = __floats2bfloat162_rn(x0, x1);
  const float2 f1 = __bfloat1622float2(h1);
  const float r0 = x0 - f1.x, r1 = x1 - f1.y;
  const __nv_bfloat162 h2 = __floats2bfloat162_rn(r0, r1);
  const float2 f2 = __bfloat1622float2(h2);
  a1 = bits(h1);
  a2 = bits(h2);
  a3 = bits(__floats2bfloat162_rn(r0 - f2.x, r1 - f2.y));
}

// Fragment loads of a 16-row bf16 tile m stored [16][NW], chunks swizzled
// by swz<NW / 8>.  The swizzle repeats every 16 rows, so m may point at any
// 16-row block of a taller tile.
//
// A operand (16 rows x 16 deep): the rows, depth n0..n0 + 15
template <int NW>
__device__ __forceinline__ void ldsm_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* m, int n0,
                                       int lane) {
  constexpr int kCpr = NW / 8;
  const int t = (lane & 7) + 8 * ((lane >> 3) & 1);
  ldsm_x4(a, m + swz<kCpr>(t, (n0 >> 3) + (lane >> 4)) * 8);
}

// B operands (16 deep x 8 columns) of X m^T, the columns m's rows 0..7 and
// 8..15, depth n0..: {b0, b1} of the first, then of the second
template <int NW>
__device__ __forceinline__ void ldsm_b_rows(uint32_t (&b)[4],
                                            const __nv_bfloat16* m, int n0,
                                            int lane) {
  constexpr int kCpr = NW / 8;
  const int s = (lane & 7) + 8 * (lane >> 4);
  ldsm_x4(b, m + swz<kCpr>(s, (n0 >> 3) + ((lane >> 3) & 1)) * 8);
}

// B operands (16 deep in the rows x 8 columns) of X m for the column tiles
// n0.. and n0 + 8..: m read down its columns.  The same registers, in the
// order {b[0], b[2], b[1], b[3]}, are the A operand of m^T restricted to
// the columns n0..n0 + 15 (16 rows of m^T x 16 deep).
template <int NW>
__device__ __forceinline__ void ldsm_b_cols(uint32_t (&b)[4],
                                            const __nv_bfloat16* m, int n0,
                                            int lane) {
  constexpr int kCpr = NW / 8;
  const int t = (lane & 7) + 8 * ((lane >> 3) & 1);
  ldsm_x4_t(b, m + swz<kCpr>(t, (n0 >> 3) + (lane >> 4)) * 8);
}

}  // namespace mma_sm90
