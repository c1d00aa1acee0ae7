// K8 w4a8_gemm: act(s_act[m] * sum_g [s_g * (xq_g @ q_g) - rowsum(xq_g) *
// s_g * z_g] + b): int4 weights times dynamic per-token int8 activations.
//
// Replaces the TPU kernel tensorrt_llm_tpu/ops/w4a16_gemm.py
// `_w4a8_kernel_tiled` (int8 x int8 -> int32 on the MXU, group scales on
// the accumulator, the per-token scale in the epilogue).
//
// What bounds it on the H100: at decode M (a few rows) the int4 weight and
// its f32 scales and zeros, read once: bytes over 3.35 TB/s.  At prefill M
// (256..512 rows) 2*M*N*K int8 operations over the 1,979 TOPS int8
// tensor-core peak: with the int4 weight plus f32 scales and zeros at g128
// (0.5625 bytes per weight) a projection does ~3.6*M operations per weight
// byte, above the int8 ridge (~590 op/byte) from M ~ 166 on.
//
// Design: K1's tile loop with integer products.  One 128-thread block owns
// a 64x64 output tile (four warps, 32x32 each) and walks K one scale group
// at a time in 64-deep steps.  The xq tile is staged in shared memory as
// int8; the int4 nibbles are sign-extended to int8 in shared memory, stored
// column-major so that four consecutive K of one column form one 32-bit B
// fragment.  Both packings are read as stored:
// * tiled [N/BN, K/2, BN]: a packed byte holds two consecutive K rows of
//   one column, and the step's 64 K rows are x[:, k0 .. k0 + 64];
// * K-paired [K/2, N] (`pack_group`, a multiple of 64 dividing K): packed
//   row k0/2 + r holds K row c*Gp + p0 + r (low nibble) and c*Gp + Gp/2 +
//   p0 + r (high) for the step's pack group c and offset p0, so the step's
//   shared K index r < 32 is the low nibble against x[:, c*Gp + p0 + r] and
//   32 + r the high one against x[:, c*Gp + Gp/2 + p0 + r].  The integer
//   sums of a scale group do not depend on the order of its K rows, so the
//   result is the same as from the tiled packing.  Columns past N (K-paired:
//   any N % 16 == 0) read as zeros and are not stored.  Products run on the s8 tensor cores
// (mma.sync m16n8k32, s32 accumulate) into a per-group integer partial,
// exact within the group; the f32 group scale multiplies the partial on
// the accumulator, zero points enter as the rank-1 term rowsum(xq_g) * s *
// z with the int32 row sums taken by dp4a, and the f32 accumulator carries
// across groups as in the Pallas kernel.  The epilogue scales each row by
// s_act (rows past M are never stored, so padding never meets a scale),
// adds the bias and applies the activation.  No cp.async/TMA pipelining
// and no wgmma yet: simple first, fast in a later change.
#include "common.cuh"

namespace tllm {
namespace {

constexpr int BM = 64;
constexpr int BNT = 64;
constexpr int BK = 64;
constexpr int LDS = BK + 16;  // padded row stride (bytes) of the smem tiles

// KP: the K-paired packing (pack group Gp), else the tiled one.  A
// template argument: as run-time branches the tiled path's steps ran
// 13-35% slower.
template <int ACT, bool HAS_Z, bool HAS_B, bool KP>
__global__ void __launch_bounds__(128) w4a8_gemm_kernel(
    const int8_t* __restrict__ xq, const float* __restrict__ s_act,
    const int8_t* __restrict__ qw, const float* __restrict__ scales,
    const float* __restrict__ zeros, const float* __restrict__ bias,
    bf16* __restrict__ out, int M, int N, int K, int G, int block_n,
    int Gp) {
  __shared__ __align__(16) int8_t xs[BM][LDS];
  __shared__ __align__(16) int8_t ws[BNT][LDS];  // [n][k]
  __shared__ int xsum[BM];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BNT;
  // the block's columns of the packing, and its row stride
  const int8_t* qtile =
      KP ? qw + n0
         : qw + (size_t)(n0 / block_n) * (K / 2) * block_n + (n0 % block_n);
  const int wstride = KP ? N : block_n;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int n_groups = K / G;
  for (int gi = 0; gi < n_groups; ++gi) {
    int part[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0;
    if (HAS_Z && tid < BM) xsum[tid] = 0;

    for (int k0 = gi * G; k0 < (gi + 1) * G; k0 += BK) {
      // x columns of the step's shared K 0..31 and 32..63
      int xk0 = k0, xk1 = k0 + 32;
      if (KP) {
        xk0 = k0 / Gp * Gp + (k0 % Gp) / 2;
        xk1 = xk0 + Gp / 2;
      }
      // xq tile: 64 rows x 64 int8, 16 bytes per thread per pass
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int i = tid + p * 128;
        const int r = i >> 2, c = (i & 3) * 16;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (m0 + r < M)
          v = *reinterpret_cast<const uint4*>(
              xq + (size_t)(m0 + r) * K +
              (KP ? (c < 32 ? xk0 + c : xk1 + c - 32) : k0 + c));
        *reinterpret_cast<uint4*>(&xs[r][c]) = v;
      }
      // weight tile: 32 packed rows x 64 columns, 16 bytes per thread
      {
        const int pr = tid >> 2, c16 = (tid & 3) * 16;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (!KP || n0 + c16 < N)
          v = *reinterpret_cast<const uint4*>(
              qtile + (size_t)(k0 / 2 + pr) * wstride + c16);
        const uint32_t w4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const uint32_t u = (w4[j >> 2] >> (8 * (j & 3))) & 0xFFu;
          const uint32_t lo = (uint32_t)nib_lo(u) & 0xFFu;
          const uint32_t hi = (uint32_t)nib_hi(u) & 0xFFu;
          if (KP) {
            ws[c16 + j][pr] = (int8_t)lo;
            ws[c16 + j][32 + pr] = (int8_t)hi;
          } else {
            *reinterpret_cast<uint16_t*>(&ws[c16 + j][2 * pr]) =
                (uint16_t)(lo | (hi << 8));
          }
        }
      }
      __syncthreads();
      if (HAS_Z && tid < BM) {
        int s = 0;
#pragma unroll
        for (int c = 0; c < BK; c += 4)
          s = __dp4a(*reinterpret_cast<const int*>(&xs[tid][c]), 0x01010101, s);
        xsum[tid] += s;
      }
#pragma unroll
      for (int kk = 0; kk < BK; kk += 32) {
        uint32_t a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const int rb = wm * 32 + mi * 16;
          a[mi][0] = *reinterpret_cast<const uint32_t*>(&xs[rb + g][kk + 4 * t]);
          a[mi][1] = *reinterpret_cast<const uint32_t*>(&xs[rb + g + 8][kk + 4 * t]);
          a[mi][2] = *reinterpret_cast<const uint32_t*>(&xs[rb + g][kk + 16 + 4 * t]);
          a[mi][3] = *reinterpret_cast<const uint32_t*>(&xs[rb + g + 8][kk + 16 + 4 * t]);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int col = wn * 32 + ni * 8 + g;
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(&ws[col][kk + 4 * t]);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(&ws[col][kk + 16 + 4 * t]);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) mma_s8_16832(part[mi][ni], a[mi], b0, b1);
        }
      }
      __syncthreads();
    }
    // group epilogue: f32 scale on the exact integer partial, zero points
    // as the rank-1 term, in the Pallas kernel's order
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + wn * 32 + ni * 8 + 2 * t;
      if (KP && col >= N) continue;  // N % 16 == 0: col + 1 < N as well
      const float s0 = scales[(size_t)gi * N + col];
      const float s1 = scales[(size_t)gi * N + col + 1];
      float zs0 = 0.f, zs1 = 0.f;
      if (HAS_Z) {
        zs0 = s0 * zeros[(size_t)gi * N + col];
        zs1 = s1 * zeros[(size_t)gi * N + col + 1];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        float* a = acc[mi][ni];
        const int* p = part[mi][ni];
        a[0] += (float)p[0] * s0;
        a[1] += (float)p[1] * s1;
        a[2] += (float)p[2] * s0;
        a[3] += (float)p[3] * s1;
        if (HAS_Z) {
          const int r0 = wm * 32 + mi * 16 + g;
          a[0] -= (float)xsum[r0] * zs0;
          a[1] -= (float)xsum[r0] * zs1;
          a[2] -= (float)xsum[r0 + 8] * zs0;
          a[3] -= (float)xsum[r0 + 8] * zs1;
        }
      }
    }
    if (HAS_Z) __syncthreads();  // xsum is reset by the next group
  }

  // epilogue: per-token scale, bias, activation, bf16 out
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + wn * 32 + ni * 8 + 2 * t;
      if (KP && col >= N) continue;
      const float b0 = HAS_B ? bias[col] : 0.f;
      const float b1 = HAS_B ? bias[col + 1] : 0.f;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = m0 + wm * 32 + mi * 16 + g + hh * 8;
        if (row < M) {
          const float sa = s_act[row];
          const float v0 = activate<ACT>(acc[mi][ni][2 * hh] * sa + b0);
          const float v1 = activate<ACT>(acc[mi][ni][2 * hh + 1] * sa + b1);
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * N + col) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
}

template <int ACT, bool KP>
void launch_kp(const int8_t* x, const float* sa, const int8_t* qw,
               const float* s, const float* z, const float* b, bf16* out,
               int M, int N, int K, int G, int bn, int gp, cudaStream_t st) {
  dim3 grid((N + BNT - 1) / BNT, (M + BM - 1) / BM);
  if (z && b)
    w4a8_gemm_kernel<ACT, true, true, KP><<<grid, 128, 0, st>>>(x, sa, qw, s, z, b, out, M, N, K, G, bn, gp);
  else if (z)
    w4a8_gemm_kernel<ACT, true, false, KP><<<grid, 128, 0, st>>>(x, sa, qw, s, z, b, out, M, N, K, G, bn, gp);
  else if (b)
    w4a8_gemm_kernel<ACT, false, true, KP><<<grid, 128, 0, st>>>(x, sa, qw, s, z, b, out, M, N, K, G, bn, gp);
  else
    w4a8_gemm_kernel<ACT, false, false, KP><<<grid, 128, 0, st>>>(x, sa, qw, s, z, b, out, M, N, K, G, bn, gp);
}

template <int ACT>
void launch_act(const int8_t* x, const float* sa, const int8_t* qw,
                const float* s, const float* z, const float* b, bf16* out,
                int M, int N, int K, int G, int bn, int gp, cudaStream_t st) {
  if (gp)
    launch_kp<ACT, true>(x, sa, qw, s, z, b, out, M, N, K, G, bn, gp, st);
  else
    launch_kp<ACT, false>(x, sa, qw, s, z, b, out, M, N, K, G, bn, gp, st);
}

}  // namespace
}  // namespace tllm

// Shapes are checked by the Python wrapper: K % 64 == 0, G % 64 == 0,
// contiguous operands, and either the tiled packing (pack_group 0,
// block_n % 64 == 0 dividing N) or the K-paired one (N % 16 == 0,
// pack_group % 64 == 0 dividing G).
extern "C" int tllm_w4a8_gemm(const void* xq, const void* s_act,
                              const void* qweight, const void* scales,
                              const void* zeros, const void* bias, void* out,
                              int M, int N, int K, int group, int block_n,
                              int pack_group, int act, void* stream) {
  using namespace tllm;
  const int8_t* xp = static_cast<const int8_t*>(xq);
  const float* ap = static_cast<const float*>(s_act);
  const int8_t* qp = static_cast<const int8_t*>(qweight);
  const float* sp = static_cast<const float*>(scales);
  const float* zp = static_cast<const float*>(zeros);
  const float* bp = static_cast<const float*>(bias);
  bf16* op = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (act) {
    case ACT_SILU: launch_act<ACT_SILU>(xp, ap, qp, sp, zp, bp, op, M, N, K, group, block_n, pack_group, st); break;
    case ACT_GELU: launch_act<ACT_GELU>(xp, ap, qp, sp, zp, bp, op, M, N, K, group, block_n, pack_group, st); break;
    case ACT_RELU: launch_act<ACT_RELU>(xp, ap, qp, sp, zp, bp, op, M, N, K, group, block_n, pack_group, st); break;
    case ACT_RELU2: launch_act<ACT_RELU2>(xp, ap, qp, sp, zp, bp, op, M, N, K, group, block_n, pack_group, st); break;
    default: launch_act<ACT_NONE>(xp, ap, qp, sp, zp, bp, op, M, N, K, group, block_n, pack_group, st); break;
  }
  return (int)cudaGetLastError();
}
