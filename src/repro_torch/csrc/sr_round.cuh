// Stochastic rounding f32 -> bf16 of one element, shared by sr_cast.cu (the
// standalone cast) and ef_update.cu (the same rounding as the epilogue of
// the fused EF updates), so both compute one function by construction:
//
//   bf16_bits(x) = high16( bits(x) + (r & 0xFFFF) )      (mod 2^32)
//
// r is a random word drawn outside the kernel (int32 on the PyTorch side,
// the reference's u32 bit patterns); only its low 16 bits are read.
// Unsigned 32-bit arithmetic wraps mod 2^32 as the reference's uint32 does.

#pragma once

#include <stdint.h>

__device__ __forceinline__ uint16_t sr_one(float x, uint32_t r) {
  return (uint16_t)((__float_as_uint(x) + (r & 0xFFFFu)) >> 16);
}
