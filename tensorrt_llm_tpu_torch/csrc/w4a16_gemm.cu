// K1 w4a16_gemm: act(x @ ((q - z) * s) + b) for general M (prefill).
//
// Replaces the TPU kernels tensorrt_llm_tpu/ops/w4a16_gemm.py
// `_w4a16_kernel_tiled` (the prefill-M path) and, by repacking at load time,
// `_w4a16_kernel` (2-D K-paired packing) and `_w4a16_kernel_ramp` (same math
// under another DMA schedule).
//
// What bounds it on the H100: at prefill M (256..512 rows) a TinyLlama or
// Llama-3-8B projection does 2*M*N*K operations against K*N/2 weight bytes,
// i.e. M*4 operations per weight byte -- above the card's ~295 op/byte
// ridge only from M ~ 74 on, so prefill shapes are bound by tensor-core
// operations, decode shapes (K2) by weight bytes.
//
// Design: one 128-thread block owns a 64x64 output tile (four warps, 32x32
// each) and walks K one scale group at a time in 32-deep steps.  The x tile
// is staged in shared memory as bf16; the int4 nibbles of the tiled packing
// ([N/BN, K/2, BN], one packed byte = two consecutive K rows of one column)
// are expanded to exact bf16 integers in shared memory, stored
// column-major so that one packed byte becomes one 32-bit B-fragment pair.
// Products run on the tensor cores (mma.sync m16n8k16 bf16, f32
// accumulate) into a per-group partial; the group scale multiplies the
// partial on the accumulator (the scale never touches the weight tile),
// and zero points enter as the rank-1 term rowsum(x_g) * s * z.  Bias and
// activation are fused into the epilogue.  No cp.async/TMA pipelining and
// no wgmma yet: simple first, fast in a later change.
#include "common.cuh"

namespace tllm {
namespace {

constexpr int BM = 64;
constexpr int BNT = 64;
constexpr int BK = 32;
constexpr int LDS = BK + 8;  // padded row stride (bf16) of the smem tiles

template <int ACT, bool HAS_Z, bool HAS_B>
__global__ void __launch_bounds__(128) w4a16_gemm_kernel(
    const bf16* __restrict__ x, const int8_t* __restrict__ qw,
    const bf16* __restrict__ scales, const bf16* __restrict__ zeros,
    const float* __restrict__ bias, bf16* __restrict__ out, int M, int N,
    int K, int G, int block_n) {
  __shared__ __align__(16) bf16 xs[BM][LDS];
  __shared__ __align__(16) bf16 ws[BNT][LDS];  // [n][k]
  __shared__ float xsum[BM];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BNT;
  const int8_t* qtile = qw + (size_t)(n0 / block_n) * (K / 2) * block_n +
                        (n0 % block_n);

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int n_groups = K / G;
  for (int gi = 0; gi < n_groups; ++gi) {
    float part[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
    if (HAS_Z && tid < BM) xsum[tid] = 0.f;

    for (int k0 = gi * G; k0 < (gi + 1) * G; k0 += BK) {
      // x tile: 64 rows x 32 bf16, 16 bytes per thread per pass
      for (int i = tid; i < BM * BK / 8; i += 128) {
        const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (m0 + r < M)
          v = *reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * K + k0 + c);
        *reinterpret_cast<uint4*>(&xs[r][c]) = v;
      }
      // weight tile: 16 packed rows x 64 columns, 8 bytes per thread
      {
        const int pr = tid >> 3, c8 = (tid & 7) * 8;
        const uint2 v = *reinterpret_cast<const uint2*>(
            qtile + (size_t)(k0 / 2 + pr) * block_n + c8);
        const uint32_t w2[2] = {v.x, v.y};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint32_t u = (w2[j >> 2] >> (8 * (j & 3))) & 0xFFu;
          *reinterpret_cast<uint32_t*>(&ws[c8 + j][2 * pr]) =
              pack_bf16x2((float)nib_lo(u), (float)nib_hi(u));
        }
      }
      __syncthreads();
      if (HAS_Z && tid < BM) {
        float s = 0.f;
#pragma unroll
        for (int c = 0; c < BK; ++c) s += __bfloat162float(xs[tid][c]);
        xsum[tid] += s;
      }
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const int rb = wm * 32 + mi * 16;
          a[mi][0] = ld_u32(&xs[rb + g][kk + 2 * t]);
          a[mi][1] = ld_u32(&xs[rb + g + 8][kk + 2 * t]);
          a[mi][2] = ld_u32(&xs[rb + g][kk + 2 * t + 8]);
          a[mi][3] = ld_u32(&xs[rb + g + 8][kk + 2 * t + 8]);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int col = wn * 32 + ni * 8 + g;
          const uint32_t b0 = ld_u32(&ws[col][kk + 2 * t]);
          const uint32_t b1 = ld_u32(&ws[col][kk + 2 * t + 8]);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) mma_bf16_16816(part[mi][ni], a[mi], b0, b1);
        }
      }
      __syncthreads();
    }
    // group epilogue: scale on the accumulator, zero points as rank-1 term
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + wn * 32 + ni * 8 + 2 * t;
      const float s0 = __bfloat162float(scales[(size_t)gi * N + col]);
      const float s1 = __bfloat162float(scales[(size_t)gi * N + col + 1]);
      float zs0 = 0.f, zs1 = 0.f;
      if (HAS_Z) {
        zs0 = s0 * __bfloat162float(zeros[(size_t)gi * N + col]);
        zs1 = s1 * __bfloat162float(zeros[(size_t)gi * N + col + 1]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        float* a = acc[mi][ni];
        const float* p = part[mi][ni];
        a[0] += p[0] * s0;
        a[1] += p[1] * s1;
        a[2] += p[2] * s0;
        a[3] += p[3] * s1;
        if (HAS_Z) {
          const int r0 = wm * 32 + mi * 16 + g;
          a[0] -= xsum[r0] * zs0;
          a[1] -= xsum[r0] * zs1;
          a[2] -= xsum[r0 + 8] * zs0;
          a[3] -= xsum[r0 + 8] * zs1;
        }
      }
    }
    if (HAS_Z) __syncthreads();  // xsum is reset by the next group
  }

  // fused epilogue: bias + activation, bf16 out
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + wn * 32 + ni * 8 + 2 * t;
      const float b0 = HAS_B ? bias[col] : 0.f;
      const float b1 = HAS_B ? bias[col + 1] : 0.f;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = m0 + wm * 32 + mi * 16 + g + hh * 8;
        if (row < M) {
          const float v0 = activate<ACT>(acc[mi][ni][2 * hh] + b0);
          const float v1 = activate<ACT>(acc[mi][ni][2 * hh + 1] + b1);
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * N + col) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
}

template <int ACT>
void launch_act(const bf16* x, const int8_t* qw, const bf16* s, const bf16* z,
                const float* b, bf16* out, int M, int N, int K, int G, int bn,
                cudaStream_t st) {
  dim3 grid(N / BNT, (M + BM - 1) / BM);
  if (z && b)
    w4a16_gemm_kernel<ACT, true, true><<<grid, 128, 0, st>>>(x, qw, s, z, b, out, M, N, K, G, bn);
  else if (z)
    w4a16_gemm_kernel<ACT, true, false><<<grid, 128, 0, st>>>(x, qw, s, z, b, out, M, N, K, G, bn);
  else if (b)
    w4a16_gemm_kernel<ACT, false, true><<<grid, 128, 0, st>>>(x, qw, s, z, b, out, M, N, K, G, bn);
  else
    w4a16_gemm_kernel<ACT, false, false><<<grid, 128, 0, st>>>(x, qw, s, z, b, out, M, N, K, G, bn);
}

}  // namespace
}  // namespace tllm

// Shapes are checked by the Python wrapper: N % 64 == 0, block_n % 64 == 0,
// K % 32 == 0, G % 32 == 0, contiguous operands.
extern "C" int tllm_w4a16_gemm(const void* x, const void* qweight,
                               const void* scales, const void* zeros,
                               const void* bias, void* out, int M, int N,
                               int K, int group, int block_n, int act,
                               void* stream) {
  using namespace tllm;
  const bf16* xp = static_cast<const bf16*>(x);
  const int8_t* qp = static_cast<const int8_t*>(qweight);
  const bf16* sp = static_cast<const bf16*>(scales);
  const bf16* zp = static_cast<const bf16*>(zeros);
  const float* bp = static_cast<const float*>(bias);
  bf16* op = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (act) {
    case ACT_SILU: launch_act<ACT_SILU>(xp, qp, sp, zp, bp, op, M, N, K, group, block_n, st); break;
    case ACT_GELU: launch_act<ACT_GELU>(xp, qp, sp, zp, bp, op, M, N, K, group, block_n, st); break;
    case ACT_RELU: launch_act<ACT_RELU>(xp, qp, sp, zp, bp, op, M, N, K, group, block_n, st); break;
    case ACT_RELU2: launch_act<ACT_RELU2>(xp, qp, sp, zp, bp, op, M, N, K, group, block_n, st); break;
    default: launch_act<ACT_NONE>(xp, qp, sp, zp, bp, op, M, N, K, group, block_n, st); break;
  }
  return (int)cudaGetLastError();
}
