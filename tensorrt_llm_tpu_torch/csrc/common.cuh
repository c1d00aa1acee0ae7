// Shared device helpers for the port's Hopper kernels: bf16 and int8
// conversion, int4 nibble extraction, the fused epilogue activations, the
// m16n8k16 bf16 tensor-core MMA (mma.sync, f32 accumulate), the m16n8k32
// s8 one (s32 accumulate), 16-byte cp.async copies and ldmatrix.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tllm {

typedef __nv_bfloat16 bf16;

// activation codes shared with ops/w4a16_gemm.py
enum Act { ACT_NONE = 0, ACT_SILU = 1, ACT_GELU = 2, ACT_RELU = 3, ACT_RELU2 = 4 };

template <int ACT>
__device__ __forceinline__ float activate(float v) {
  if (ACT == ACT_SILU) return v / (1.0f + expf(-v));
  if (ACT == ACT_GELU) {
    // tanh approximation, as jax.nn.gelu(approximate=True)
    const float c = 0.7978845608028654f;  // sqrt(2/pi)
    return 0.5f * v * (1.0f + tanhf(c * (v + 0.044715f * v * v * v)));
  }
  if (ACT == ACT_RELU) return v > 0.f ? v : 0.f;
  if (ACT == ACT_RELU2) { float r = v > 0.f ? v : 0.f; return r * r; }
  return v;
}

// the same activations chosen at run time (epilogues of K12-K14)
__device__ __forceinline__ float activate_rt(int act, float v) {
  switch (act) {
    case ACT_SILU: return activate<ACT_SILU>(v);
    case ACT_GELU: return activate<ACT_GELU>(v);
    case ACT_RELU: return activate<ACT_RELU>(v);
    case ACT_RELU2: return activate<ACT_RELU2>(v);
    default: return v;
  }
}

// signed low / high nibble of byte u (0..255)
__device__ __forceinline__ int nib_lo(uint32_t u) { return ((int)(u << 28)) >> 28; }
__device__ __forceinline__ int nib_hi(uint32_t u) { return ((int)(u << 24)) >> 28; }

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // .x = lo (low 16 bits)
  return *reinterpret_cast<uint32_t*>(&p);
}

// An e4m3 (float8_e4m3fn) page element: one byte, no scale.
struct e4m3 {
  uint8_t bits;
};

// The two e4m3 values in bytes k and k + 1 of w (k 0 or 2) as fp16x2, low
// byte in the low half, exactly: every e4m3 value, subnormals included, is
// an fp16 value (sm_89+: one cvt)
__device__ __forceinline__ uint32_t e4m3x2_to_f16x2(uint32_t w, int k) {
  uint32_t d;
  asm("cvt.rn.f16x2.e4m3x2 %0, %1;\n"
      : "=r"(d)
      : "h"((unsigned short)(w >> (8 * k))));
  return d;
}

// The same as bf16x2, exactly (fp16 -> f32 -> bf16: e4m3's 4 significant
// bits and its exponent range fit bf16)
__device__ __forceinline__ uint32_t e4m3x2_to_bf16x2(uint32_t w, int k) {
  const uint32_t h = e4m3x2_to_f16x2(w, k);
  float lo, hi;
  asm("{\n.reg .b16 f16lo, f16hi;\nmov.b32 {f16lo, f16hi}, %2;\n"
      "cvt.f32.f16 %0, f16lo;\ncvt.f32.f16 %1, f16hi;\n}\n"
      : "=f"(lo), "=f"(hi)
      : "r"(h));
  return pack_bf16x2(lo, hi);
}

__device__ __forceinline__ void bf16x8_to_float(const uint4& v, float* f) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 t = __bfloat1622float2(p[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// D = A(16x16, row) * B(16x8, col) + D, bf16 inputs, f32 accumulators.
// Fragment layout (g = lane / 4, t = lane % 4):
//   a[0]: row g,   k 2t..2t+1    a[1]: row g+8, k 2t..2t+1
//   a[2]: row g,   k 2t+8..+9    a[3]: row g+8, k 2t+8..+9
//   b[0]: k 2t..2t+1, n g        b[1]: k 2t+8..+9, n g
//   d[0..1]: row g, n 2t..2t+1   d[2..3]: row g+8, n 2t..2t+1
__device__ __forceinline__ void mma_bf16_16816(float* d, const uint32_t* a,
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void int8x8_to_float(const uint2& v, float* f) {
  const int8_t* p = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = (float)p[i];
}

// D = A(16x32, row) * B(32x8, col) + D, s8 inputs, s32 accumulators.
// Fragment layout (g = lane / 4, t = lane % 4), four int8 per register:
//   a[0]: row g,   k 4t..4t+3     a[1]: row g+8, k 4t..4t+3
//   a[2]: row g,   k 4t+16..+19   a[3]: row g+8, k 4t+16..+19
//   b[0]: k 4t..4t+3, n g         b[1]: k 4t+16..+19, n g
//   d[0..1]: row g, n 2t..2t+1    d[2..3]: row g+8, n 2t..2t+1
__device__ __forceinline__ void mma_s8_16832(int* d, const uint32_t* a,
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16-byte global -> shared copy, asynchronous (cp.async.cg, L2 only).
// With `pred` false nothing is read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 b16 matrices from shared memory, transposed: lanes 8i..8i+7
// give the row addresses of matrix i; register i of lane l holds elements
// (2 * (l % 4), l / 4) and (2 * (l % 4) + 1, l / 4) of matrix i -- the mma
// B fragment of a row-major [k][n] tile.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const bf16* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

}  // namespace tllm
