// K4's arithmetic shared by its three routes (`int8_conv.cu`,
// `int8_conv_stem.cu`, `int8_conv_wgmma.cuh`): the mma.sync int8 product and
// the epilogue in lfdtpu's order, each step rounded to float32 on its own
// (__fmul_rn / __fadd_rn: no FMA contraction), so that every route equals
// the plain version bit for bit.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The epilogue of two adjacent channels up to the requant:
// f = f32(acc) * mult + bias; f + identity where a residual is added (add 1:
// identity(1) holds an int8's two values, times res_scale; add 2:
// identity(2) is the shortcut's float32); ReLU when relu or the launch has a
// residual (rk). The residual is read only where it is added, after the
// affine step, so each route keeps its registers as if written out.
template <class Identity>
__device__ __forceinline__ float2 epilogue_f(int a0, int a1, float2 mult, float2 bias, int add,
                                             int rk, float res_scale, int relu,
                                             Identity identity) {
  float v0 = __fadd_rn(__fmul_rn(__int2float_rn(a0), mult.x), bias.x);
  float v1 = __fadd_rn(__fmul_rn(__int2float_rn(a1), mult.y), bias.y);
  if (add == 1) {
    const float2 r = identity(1);
    v0 = __fadd_rn(v0, __fmul_rn(r.x, res_scale));
    v1 = __fadd_rn(v1, __fmul_rn(r.y, res_scale));
  } else if (add == 2) {
    const float2 r = identity(2);
    v0 = __fadd_rn(v0, r.x);
    v1 = __fadd_rn(v1, r.y);
  }
  if (relu || rk) {
    v0 = fmaxf(v0, 0.0f);
    v1 = fmaxf(v1, 0.0f);
  }
  return make_float2(v0, v1);
}

// requant(v) = clip(round_half_even(v * inv), -127, 127) as the bits of a
// float whose low byte is the int8 result: clip, then round half to even by
// adding 1.5 * 2^23 (the float then has an ulp of 1, and its low byte is the
// integer's two's complement). Equal to the plain version's requant for
// every finite v; no float-to-int conversion (a quarter-rate instruction).
__device__ __forceinline__ uint32_t requant_bits(float v, float inv) {
  const float s = fminf(fmaxf(__fmul_rn(v, inv), -127.0f), 127.0f);
  return __float_as_uint(__fadd_rn(s, 12582912.0f));
}

// two requantized channels as the int8 pair of one 16-bit store
__device__ __forceinline__ unsigned short requant_pair(float2 v, float inv) {
  return static_cast<unsigned short>(
      __byte_perm(requant_bits(v.x, inv), requant_bits(v.y, inv), 0x0040));
}

// an int8 as a float, exactly, with no int-to-float conversion
__device__ __forceinline__ float s8_to_float(int r) {
  return __fsub_rn(__int_as_float(0x4B400000 + r), 12582912.0f);
}

}  // namespace
