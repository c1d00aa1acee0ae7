// K5 moe_gmm: grouped W4A16 GEMM for MoE experts,
//   out[i] = xs[i] @ ((q[g(i)] - z[g(i)]) * s[g(i)]),  f32 out,
// with the rows of xs sorted by expert and group_sizes[E] on the device.
//
// Replaces the TPU kernel tensorrt_llm_tpu/ops/moe_w4a16.py `_gmm_kernel`
// (and, at K % 128 != 0 such as GPT-OSS's K = 2880, the XLA ragged_dot
// fallback the JAX package takes there).
//
// What bounds it on the H100: at decode (16 rows over <= 16 experts) each
// touched expert's int4 weight is streamed once -- bytes; at a 1024-row
// prefill chunk every expert is touched and each row does 2*N*K operations
// -- close to the ridge (GPT-OSS gate_up: 265 MB vs 34 GFLOP).
//
// Design.  A prologue kernel (one thread; E and the work-unit count are
// small), launched once per MoE layer for both of its products, turns
// group_sizes into the JAX package's work units
// (`make_group_metadata`): the M axis is cut into 64-row tiles and each
// (expert, m-tile) overlap is one unit with a row range [lo, hi) in its
// tile; W = m_tiles + E - 1 units is a static bound, so the host never
// reads group_sizes.  The main kernel's grid is (N/64, W): a 128-thread
// block reads its unit, exits if the range is empty, and otherwise runs
// K1's tile loop (64x64 output tile, four warps of 32x32, 32-deep steps of
// mma.sync m16n8k16 bf16 with f32 accumulate, int4 nibbles expanded to
// exact bf16 integers in shared memory) over rows [lo, hi) of the tile
// against its expert's weights.  Each scale group's f32 partial is scaled
// on the accumulator and zeros enter as the rank-1 term rowsum(x_g)*s*z.
// On the TPU the units of one m-tile run in order and add into one output
// block; here each unit writes only its own rows, so no two blocks touch
// the same output and the sum is deterministic without atomics.
#include "common.cuh"

namespace tllm {
namespace {

constexpr int TM = 64;   // rows of a tile (and of the metadata's m-tiles)
constexpr int BNT = 64;
constexpr int BK = 32;
constexpr int LDS = BK + 8;

// meta rows, as make_group_metadata: m-tile, group, lo, hi, first
__global__ void moe_gmm_meta_kernel(const int* __restrict__ group_sizes,
                                    int* __restrict__ meta, int E,
                                    int m_tiles, int W) {
  if (threadIdx.x != 0 || blockIdx.x != 0) return;
  int w = 0, start = 0, prev_mt = -1;
  for (int g = 0; g < E; ++g) {
    const int size = group_sizes[g];
    const int end = start + size;
    if (size > 0) {
      const int ft = start / TM, lt = (end - 1) / TM;
      for (int mt = ft; mt <= lt && w < W; ++mt, ++w) {
        const int lo = start - mt * TM, hi = end - mt * TM;
        meta[0 * W + w] = mt;
        meta[1 * W + w] = g;
        meta[2 * W + w] = lo > 0 ? lo : 0;
        meta[3 * W + w] = hi < TM ? hi : TM;
        meta[4 * W + w] = (w == 0 || mt != prev_mt) ? 1 : 0;
        prev_mt = mt;
      }
    }
    start = end;
  }
  for (; w < W; ++w) {  // padding units: empty row range
    meta[0 * W + w] = m_tiles - 1;
    meta[1 * W + w] = E - 1;
    meta[2 * W + w] = 0;
    meta[3 * W + w] = 0;
    meta[4 * W + w] = 0;
  }
}

template <bool HAS_Z>
__global__ void __launch_bounds__(128) moe_gmm_kernel(
    const bf16* __restrict__ x, const int8_t* __restrict__ qw,
    const float* __restrict__ scales, const float* __restrict__ zeros,
    const int* __restrict__ meta, float* __restrict__ out, int M, int N,
    int K, int G, int block_n, int W) {
  __shared__ __align__(16) bf16 xs[TM][LDS];
  __shared__ __align__(16) bf16 ws[BNT][LDS];  // [n][k]
  __shared__ float xsum[TM];

  const int unit = blockIdx.y;
  const int mt = meta[unit];
  const int e = meta[W + unit];
  const int lo = meta[2 * W + unit];
  const int hi = meta[3 * W + unit];
  if (lo >= hi) return;  // whole block: padding unit or empty overlap

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = mt * TM;
  const int n0 = blockIdx.x * BNT;
  const size_t expert_bytes = (size_t)N * (K / 2);
  const int8_t* qtile = qw + (size_t)e * expert_bytes +
                        (size_t)(n0 / block_n) * (K / 2) * block_n +
                        (n0 % block_n);
  const int n_groups = K / G;
  const float* sc = scales + (size_t)e * n_groups * N;
  const float* zp = HAS_Z ? zeros + (size_t)e * n_groups * N : nullptr;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  for (int gi = 0; gi < n_groups; ++gi) {
    float part[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) part[i][j][c] = 0.f;
    if (HAS_Z && tid < TM) xsum[tid] = 0.f;

    for (int k0 = gi * G; k0 < (gi + 1) * G; k0 += BK) {
      // x tile: only this unit's rows [lo, hi); the rest are zero
      for (int i = tid; i < TM * BK / 8; i += 128) {
        const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (r >= lo && r < hi && m0 + r < M)
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
      if (HAS_Z && tid < TM) {
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
    // group epilogue: f32 scale on the accumulator, zeros as rank-1 term
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + wn * 32 + ni * 8 + 2 * t;
      const float2 s = *reinterpret_cast<const float2*>(sc + (size_t)gi * N + col);
      float zs0 = 0.f, zs1 = 0.f;
      if (HAS_Z) {
        const float2 z = *reinterpret_cast<const float2*>(zp + (size_t)gi * N + col);
        zs0 = s.x * z.x;
        zs1 = s.y * z.y;
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        float* a = acc[mi][ni];
        const float* p = part[mi][ni];
        a[0] += p[0] * s.x;
        a[1] += p[1] * s.y;
        a[2] += p[2] * s.x;
        a[3] += p[3] * s.y;
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

  // f32 out, this unit's rows only
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + wn * 32 + ni * 8 + 2 * t;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = wm * 32 + mi * 16 + g + hh * 8;
        if (r >= lo && r < hi && m0 + r < M)
          *reinterpret_cast<float2*>(out + (size_t)(m0 + r) * N + col) =
              make_float2(acc[mi][ni][2 * hh], acc[mi][ni][2 * hh + 1]);
      }
    }
  }
}

}  // namespace
}  // namespace tllm

// The work units of M expert-sorted rows: meta is int32 [5, W] with
// W = ceil(M / 64) + E - 1.  One launch serves every product of a layer
// that shares group_sizes (gate_up and down).
extern "C" int tllm_moe_gmm_units(const void* group_sizes, void* meta, int M,
                                  int E, void* stream) {
  using namespace tllm;
  const int m_tiles = (M + TM - 1) / TM;
  moe_gmm_meta_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(group_sizes), static_cast<int*>(meta), E,
      m_tiles, m_tiles + E - 1);
  return (int)cudaGetLastError();
}

// Shapes are checked by the Python wrapper: N % 64 == 0, block_n % 64 == 0,
// K % 32 == 0, G % 32 == 0, contiguous operands; meta comes from
// tllm_moe_gmm_units for the same M and E.
extern "C" int tllm_moe_gmm(const void* x, const void* qweight,
                            const void* scales, const void* zeros,
                            const void* meta, void* out, int M, int N, int K,
                            int group, int E, int block_n, void* stream) {
  using namespace tllm;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int W = (M + TM - 1) / TM + E - 1;
  const int* mp = static_cast<const int*>(meta);
  dim3 grid(N / BNT, W);
  const bf16* xp = static_cast<const bf16*>(x);
  const int8_t* qp = static_cast<const int8_t*>(qweight);
  const float* sp = static_cast<const float*>(scales);
  const float* zp = static_cast<const float*>(zeros);
  float* op = static_cast<float*>(out);
  if (zp)
    moe_gmm_kernel<true><<<grid, 128, 0, st>>>(xp, qp, sp, zp, mp, op, M, N, K, group, block_n, W);
  else
    moe_gmm_kernel<false><<<grid, 128, 0, st>>>(xp, qp, sp, zp, mp, op, M, N, K, group, block_n, W);
  return (int)cudaGetLastError();
}
