// K12 w4a16_kpaired: act(x @ ((q - z) * s) + b) from the 2-D K-paired
// packing [K/2, N], any M.
//
// Replaces the TPU kernel tensorrt_llm_tpu/ops/w4a16_gemm.py
// `_w4a16_kernel`, which runs where a weight's N has no 128-multiple
// column tile (GPT-OSS-20B o_proj, N = 2880; Moonlight and DeepSeek-V3.2
// kv_a, N = 576).
//
// Layout: within each pack group of Gp rows (`pack_group_for`: the scale
// group, or up to 256 rows per channel), byte [c*Gp/2 + r, n] holds row
// c*Gp + r in its low nibble and row c*Gp + Gp/2 + r in its high nibble.
// So the two nibbles of one byte pair with two different K offsets of x.
//
// What bounds it on the H100: at decode M the K*N/2 weight bytes (2*M*N*K
// operations are far below the ~295 op/byte ridge); at a 256-row prefill
// chunk the tensor-core operations.
//
// Design: K1's tile loop (128 threads, a 64x64 output tile, four warps of
// 32x32 on mma.sync m16n8k16, f32 accumulators) over "virtual" 32-deep K
// steps: 16 packed rows p0..p0+15 of a pack group give the 16 low-nibble
// rows c*Gp + p0.. and the 16 high-nibble rows c*Gp + Gp/2 + p0..; the x
// tile in shared memory holds the matching two 16-column segments of x
// side by side, so the MMA sums the right pairs without any repack.  Rows
// of the K-paired layout are N contiguous bytes, so each thread loads 8
// neighbouring columns (coalesced along N); column tiles past N are masked
// at 8-column granularity, so any N % 16 == 0 works (2880 = 45 x 64, 576
// = 9 x 64).  The zero point folds into the weight ((q - z) is an exact
// small integer in bf16), the group scale multiplies the per-group f32
// partial on the accumulator, bias and activation are fused.  Decode
// shapes have few column tiles, so K is split over gridDim.z blocks of
// `kslice` rows (the `block_k` tactic); each writes an f32 partial and a
// second pass sums the splits and applies bias and activation.  No
// cp.async/TMA pipelining and no wgmma yet: simple first.
#include "common.cuh"

namespace tllm {
namespace {

constexpr int KP_BM = 64;
constexpr int KP_BN = 64;
constexpr int KP_VK = 32;           // virtual K step: 16 low + 16 high rows
constexpr int KP_LDS = KP_VK + 8;   // padded row stride (bf16)

__global__ void __launch_bounds__(128) w4a16_kpaired_kernel(
    const bf16* __restrict__ x, const int8_t* __restrict__ qw,
    const bf16* __restrict__ scales, const bf16* __restrict__ zeros,
    const float* __restrict__ bias, float* __restrict__ ws,
    bf16* __restrict__ out, int M, int N, int K, int G, int Gp, int act,
    int kslice) {
  __shared__ __align__(16) bf16 xs[KP_BM][KP_LDS];
  __shared__ __align__(16) bf16 wsm[KP_BN][KP_LDS];  // [n][virtual k]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * KP_BM;
  const int n0 = blockIdx.x * KP_BN;
  const int k_begin = blockIdx.z * kslice;
  const int k_end = k_begin + kslice;
  const bool per_channel = G >= K;
  const int Gh = Gp / 2;
  // weight loader: packed row pr of the step, 8 columns from c8
  const int pr = tid >> 3, c8 = (tid & 7) * 8;
  const bool wcol_ok = n0 + c8 < N;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int c0 = k_begin; c0 < k_end; c0 += Gp) {
    const int srow = per_channel ? 0 : c0 / G;
    float zc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) zc[j] = 0.f;
    if (zeros != nullptr && wcol_ok)
      bf16x8_to_float(*reinterpret_cast<const uint4*>(
                          zeros + (size_t)srow * N + n0 + c8), zc);
    float part[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;

    for (int p0 = 0; p0 < Gh; p0 += 16) {
      // x: 64 rows x (low segment, high segment) x 16 columns
      for (int i = tid; i < KP_BM * 4; i += 128) {
        const int r = i >> 2, seg = (i >> 1) & 1, c = (i & 1) * 8;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (m0 + r < M)
          v = *reinterpret_cast<const uint4*>(
              x + (size_t)(m0 + r) * K + c0 + seg * Gh + p0 + c);
        *reinterpret_cast<uint4*>(&xs[r][seg * 16 + c]) = v;
      }
      // weights: 16 packed rows x 64 columns, 8 bytes per thread
      {
        uint2 v = make_uint2(0, 0);
        if (wcol_ok)
          v = *reinterpret_cast<const uint2*>(
              qw + (size_t)(c0 / 2 + p0 + pr) * N + n0 + c8);
        const uint32_t w2[2] = {v.x, v.y};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint32_t u = (w2[j >> 2] >> (8 * (j & 3))) & 0xFFu;
          wsm[c8 + j][pr] = __float2bfloat16((float)nib_lo(u) - zc[j]);
          wsm[c8 + j][16 + pr] = __float2bfloat16((float)nib_hi(u) - zc[j]);
        }
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KP_VK; kk += 16) {
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
          const uint32_t b0 = ld_u32(&wsm[col][kk + 2 * t]);
          const uint32_t b1 = ld_u32(&wsm[col][kk + 2 * t + 8]);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) mma_bf16_16816(part[mi][ni], a[mi], b0, b1);
        }
      }
      __syncthreads();
    }
    // the group scale on the accumulator
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + wn * 32 + ni * 8 + 2 * t;
      float s0 = 0.f, s1 = 0.f;
      if (col < N) {
        s0 = __bfloat162float(scales[(size_t)srow * N + col]);
        s1 = __bfloat162float(scales[(size_t)srow * N + col + 1]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        acc[mi][ni][0] += part[mi][ni][0] * s0;
        acc[mi][ni][1] += part[mi][ni][1] * s1;
        acc[mi][ni][2] += part[mi][ni][2] * s0;
        acc[mi][ni][3] += part[mi][ni][3] * s1;
      }
    }
  }

  // epilogue: the f32 partial of this K slice, or bias + activation
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + wn * 32 + ni * 8 + 2 * t;
      if (col >= N) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = m0 + wm * 32 + mi * 16 + g + hh * 8;
        if (row >= M) continue;
        const float v0 = acc[mi][ni][2 * hh], v1 = acc[mi][ni][2 * hh + 1];
        if (ws != nullptr) {
          *reinterpret_cast<float2*>(
              ws + ((size_t)blockIdx.z * M + row) * N + col) = make_float2(v0, v1);
        } else {
          const float b0 = bias != nullptr ? bias[col] : 0.f;
          const float b1 = bias != nullptr ? bias[col + 1] : 0.f;
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * N + col) =
              __floats2bfloat162_rn(activate_rt(act, v0 + b0),
                                    activate_rt(act, v1 + b1));
        }
      }
    }
  }
}

// sum of the K slices' f32 partials, bias, activation, bf16 out
__global__ void kpaired_combine_kernel(const float* __restrict__ ws,
                                       const float* __restrict__ bias,
                                       bf16* __restrict__ out, int M, int N,
                                       int split, int act) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M * N) return;
  float v = 0.f;
  for (int s = 0; s < split; ++s) v += ws[(size_t)s * M * N + i];
  if (bias != nullptr) v += bias[i % N];
  out[i] = __float2bfloat16(activate_rt(act, v));
}

}  // namespace
}  // namespace tllm

// The wrapper guarantees: N % 16 == 0, Gp % 32 == 0, K % Gp == 0, split
// divides K into slices that are whole pack groups, contiguous operands,
// and a workspace of split * M * N floats when split > 1.
extern "C" int tllm_w4a16_kpaired(const void* x, const void* qweight,
                                  const void* scales, const void* zeros,
                                  const void* bias, void* workspace,
                                  void* out, int M, int N, int K, int group,
                                  int pack_group, int act, int split,
                                  void* stream) {
  using namespace tllm;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ws = split > 1 ? static_cast<float*>(workspace) : nullptr;
  dim3 grid((N + KP_BN - 1) / KP_BN, (M + KP_BM - 1) / KP_BM, split);
  w4a16_kpaired_kernel<<<grid, 128, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<const int8_t*>(qweight),
      static_cast<const bf16*>(scales), static_cast<const bf16*>(zeros),
      static_cast<const float*>(bias), ws, static_cast<bf16*>(out), M, N, K,
      group, pack_group, act, K / split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return (int)err;
  const int n = M * N;
  kpaired_combine_kernel<<<(n + 255) / 256, 256, 0, st>>>(
      ws, static_cast<const float*>(bias), static_cast<bf16*>(out), M, N,
      split, act);
  return (int)cudaGetLastError();
}
