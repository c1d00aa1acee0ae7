// K14 w4a16_fused_mlp: a whole gated MLP in one launch,
//   out = down(act(x @ gate + b_g) * (x @ up + b_u)) + b_down,
// with W4A16 gate/up/down weights in the tiled packing.
//
// Replaces the TPU kernel tensorrt_llm_tpu/ops/w4a16_fused.py
// `_fused_mlp_kernel` (one pallas_call over all three weight streams).
// Layouts are the JAX op's: gu [2I/BN, K/2, BN] with the gate columns
// first ([gate | up]), scales [K/G, 2I]; down [K/BNd, I/2, BNd], scales
// [I/G, K]; bf16 scales and zeros, f32 biases.
//
// What bounds it on the H100: at decode M the (K*2I + I*K)/2 weight bytes.
//
// Design: a cooperative launch (every block co-resident, grid <= the
// occupancy limit) of 128-thread blocks running K1's 64x64 mma.sync tile
// loop in three phases separated by grid barriers:
//   A. items (M block, 64-column tile j): gate tile j and up tile I/64 + j
//      share every x fragment; h = act(g + b_g) * (u + b_u), with g and u
//      the f32 accumulators (not rounded), rounded once to bf16 into a
//      global workspace h [M, I] (1.8 MB at M 64, I 14336: L2-resident);
//   B. items (M block, 64-column down tile, K slice k2 of I / n_k2 rows):
//      h @ down into f32 partials [n_k2, M, K] (the TPU's sequential k-split
//      n_k2 becomes parallel work, so decode M fills the card);
//   C. the partials summed, b_down added, bf16 out.
// Phase B may read h only after every phase-A tile is written, hence the
// barrier: each block's thread 0 fences and adds one to a global counter,
// then waits for gridDim.x (then 2 * gridDim.x) arrivals.  The zero point
// folds into the weight ((q - z) is an exact small integer in bf16); the
// group scale multiplies the per-group f32 partial on the accumulator.
// With a non-null `stats`, each block records the global timer when it
// arrives at and leaves each barrier (what the barrier costs).  No TMA or
// wgmma yet.
#include "common.cuh"

namespace tllm {
namespace {

constexpr int FM_BM = 64;
constexpr int FM_BN = 64;
constexpr int FM_BK = 32;
constexpr int FM_LDS = FM_BK + 8;
constexpr int FM_THREADS = 128;

struct FusedParams {
  const bf16* x;
  const int8_t* gu_q;
  const bf16* gu_s;
  const bf16* gu_z;
  const float* gu_b;
  const int8_t* d_q;
  const bf16* d_s;
  const bf16* d_z;
  const float* d_b;
  bf16* h;                 // [M, I]
  float* part;             // [n_k2, M, K]
  unsigned* bar;           // zeroed before the launch
  unsigned long long* stats;  // [grid, 4] or null
  bf16* out;               // [M, K]
  int M, K, I, Ga, Gd, bn_a, bn_d, n_k2, act;
};

struct Smem {
  bf16 xs[FM_BM][FM_LDS];
  bf16 w[2][FM_BN][FM_LDS];   // [n][k]
};

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ void grid_barrier(unsigned* bar, unsigned target,
                             unsigned long long* stats, int slot) {
  __syncthreads();
  if (threadIdx.x == 0) {
    if (stats) stats[blockIdx.x * 4 + slot] = global_ns();
    __threadfence();
    atomicAdd(bar, 1u);
    while (atomicAdd(bar, 0u) < target) __nanosleep(64);
    __threadfence();
    if (stats) stats[blockIdx.x * 4 + slot + 1] = global_ns();
  }
  __syncthreads();
}

// acc[w] += A[m0:m0+64, k_begin:k_end] @ ((q_w - z_w) * s_w)[:, 64 columns]
// for NW weight tiles that share the A fragments.  A is row-major with
// `lda` columns and `rows` valid rows; wq[w] points at the tile's first
// column inside its [Kdim/2, block_n] block, col[w] is that column's index
// in the scale rows of `ldn` columns.
template <int NW>
__device__ void tile_product(const bf16* A, int lda, int rows,
                             int m0, int k_begin, int k_end, int Kdim,
                             const int8_t* const (&wq)[NW], int block_n,
                             const bf16* __restrict__ sc,
                             const bf16* __restrict__ zc, int ldn,
                             const int (&col)[NW], int G, Smem& sm,
                             float (&acc)[NW][2][4][4]) {
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, t = lane & 3;
  const int pr = tid >> 3, c8 = (tid & 7) * 8;
  const bool per_channel = G >= Kdim;
  const int GL = per_channel ? k_end - k_begin : G;
  for (int g0 = k_begin; g0 < k_end; g0 += GL) {
    const int srow = per_channel ? 0 : g0 / G;
    float z[NW][8];
#pragma unroll
    for (int w = 0; w < NW; ++w) {
#pragma unroll
      for (int j = 0; j < 8; ++j) z[w][j] = 0.f;
      if (zc != nullptr)
        bf16x8_to_float(*reinterpret_cast<const uint4*>(
                            zc + (size_t)srow * ldn + col[w] + c8), z[w]);
    }
    float part[NW][2][4][4];
#pragma unroll
    for (int w = 0; w < NW; ++w)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[w][i][j][e] = 0.f;
    for (int k0 = g0; k0 < g0 + GL; k0 += FM_BK) {
      for (int i = tid; i < FM_BM * FM_BK / 8; i += FM_THREADS) {
        const int r = i / (FM_BK / 8), c = (i % (FM_BK / 8)) * 8;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (m0 + r < rows)   // L2 only: h was written by other blocks
          v = __ldcg(reinterpret_cast<const uint4*>(
              A + (size_t)(m0 + r) * lda + k0 + c));
        *reinterpret_cast<uint4*>(&sm.xs[r][c]) = v;
      }
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const uint2 v = *reinterpret_cast<const uint2*>(
            wq[w] + (size_t)(k0 / 2 + pr) * block_n + c8);
        const uint32_t w2[2] = {v.x, v.y};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint32_t u = (w2[j >> 2] >> (8 * (j & 3))) & 0xFFu;
          *reinterpret_cast<uint32_t*>(&sm.w[w][c8 + j][2 * pr]) =
              pack_bf16x2((float)nib_lo(u) - z[w][j],
                          (float)nib_hi(u) - z[w][j]);
        }
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < FM_BK; kk += 16) {
        uint32_t a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const int rb = wm * 32 + mi * 16;
          a[mi][0] = ld_u32(&sm.xs[rb + g][kk + 2 * t]);
          a[mi][1] = ld_u32(&sm.xs[rb + g + 8][kk + 2 * t]);
          a[mi][2] = ld_u32(&sm.xs[rb + g][kk + 2 * t + 8]);
          a[mi][3] = ld_u32(&sm.xs[rb + g + 8][kk + 2 * t + 8]);
        }
#pragma unroll
        for (int w = 0; w < NW; ++w)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            const int cc = wn * 32 + ni * 8 + g;
            const uint32_t b0 = ld_u32(&sm.w[w][cc][kk + 2 * t]);
            const uint32_t b1 = ld_u32(&sm.w[w][cc][kk + 2 * t + 8]);
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
              mma_bf16_16816(part[w][mi][ni], a[mi], b0, b1);
          }
      }
      __syncthreads();
    }
#pragma unroll
    for (int w = 0; w < NW; ++w)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int cc = col[w] + wn * 32 + ni * 8 + 2 * t;
        const float s0 = __bfloat162float(sc[(size_t)srow * ldn + cc]);
        const float s1 = __bfloat162float(sc[(size_t)srow * ldn + cc + 1]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          acc[w][mi][ni][0] += part[w][mi][ni][0] * s0;
          acc[w][mi][ni][1] += part[w][mi][ni][1] * s1;
          acc[w][mi][ni][2] += part[w][mi][ni][2] * s0;
          acc[w][mi][ni][3] += part[w][mi][ni][3] * s1;
        }
      }
  }
}

template <int NW>
__device__ __forceinline__ void zero_acc(float (&acc)[NW][2][4][4]) {
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[w][i][j][e] = 0.f;
}

__global__ void __launch_bounds__(FM_THREADS) w4a16_fused_mlp_kernel(
    FusedParams p) {
  __shared__ __align__(16) Smem sm;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, t = lane & 3;
  const int n_mb = (p.M + FM_BM - 1) / FM_BM;
  const int I = p.I, K = p.K;

  // phase A: h = act(x @ gate + b_g) * (x @ up + b_u), bf16
  const int TA = I / FM_BN;
  for (int item = blockIdx.x; item < n_mb * TA; item += gridDim.x) {
    const int m0 = (item / TA) * FM_BM;
    const int gcol = (item % TA) * FM_BN;
    const int col[2] = {gcol, I + gcol};
    const int8_t* const wq[2] = {
        p.gu_q + (size_t)(col[0] / p.bn_a) * (K / 2) * p.bn_a + col[0] % p.bn_a,
        p.gu_q + (size_t)(col[1] / p.bn_a) * (K / 2) * p.bn_a + col[1] % p.bn_a};
    float acc[2][2][4][4];
    zero_acc<2>(acc);
    tile_product<2>(p.x, K, p.M, m0, 0, K, K, wq, p.bn_a, p.gu_s, p.gu_z,
                    2 * I, col, p.Ga, sm, acc);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int c = gcol + wn * 32 + ni * 8 + 2 * t;
        float gb[2] = {0.f, 0.f}, ub[2] = {0.f, 0.f};
        if (p.gu_b != nullptr) {
          gb[0] = p.gu_b[c];
          gb[1] = p.gu_b[c + 1];
          ub[0] = p.gu_b[I + c];
          ub[1] = p.gu_b[I + c + 1];
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = m0 + wm * 32 + mi * 16 + g + hh * 8;
          if (row >= p.M) continue;
          const float h0 = activate_rt(p.act, acc[0][mi][ni][2 * hh] + gb[0]) *
                           (acc[1][mi][ni][2 * hh] + ub[0]);
          const float h1 = activate_rt(p.act, acc[0][mi][ni][2 * hh + 1] + gb[1]) *
                           (acc[1][mi][ni][2 * hh + 1] + ub[1]);
          *reinterpret_cast<__nv_bfloat162*>(p.h + (size_t)row * I + c) =
              __floats2bfloat162_rn(h0, h1);
        }
      }
  }
  grid_barrier(p.bar, gridDim.x, p.stats, 0);

  // phase B: f32 partials of h @ down over n_k2 slices of I
  const int TB = K / FM_BN;
  const int slice = I / p.n_k2;
  for (int item = blockIdx.x; item < n_mb * TB * p.n_k2; item += gridDim.x) {
    const int k2 = item % p.n_k2;
    const int rest = item / p.n_k2;
    const int m0 = (rest / TB) * FM_BM;
    const int dcol = (rest % TB) * FM_BN;
    const int col[1] = {dcol};
    const int8_t* const wq[1] = {
        p.d_q + (size_t)(dcol / p.bn_d) * (I / 2) * p.bn_d + dcol % p.bn_d};
    float acc[1][2][4][4];
    zero_acc<1>(acc);
    tile_product<1>(p.h, I, p.M, m0, k2 * slice, (k2 + 1) * slice, I, wq,
                    p.bn_d, p.d_s, p.d_z, K, col, p.Gd, sm, acc);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int c = dcol + wn * 32 + ni * 8 + 2 * t;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = m0 + wm * 32 + mi * 16 + g + hh * 8;
          if (row < p.M)
            *reinterpret_cast<float2*>(
                p.part + ((size_t)k2 * p.M + row) * K + c) =
                make_float2(acc[0][mi][ni][2 * hh], acc[0][mi][ni][2 * hh + 1]);
        }
      }
  }
  grid_barrier(p.bar, 2 * gridDim.x, p.stats, 2);

  // phase C: sum the slices, add b_down, bf16 out
  const int total = p.M * K;
  for (int i = blockIdx.x * FM_THREADS + threadIdx.x; i < total;
       i += gridDim.x * FM_THREADS) {
    float v = 0.f;
    for (int k2 = 0; k2 < p.n_k2; ++k2)
      v += __ldcg(p.part + (size_t)k2 * total + i);
    if (p.d_b != nullptr) v += p.d_b[i % K];
    p.out[i] = __float2bfloat16(v);
  }
}

}  // namespace
}  // namespace tllm

// The wrapper guarantees: K % 64 == 0, I % 64 == 0, block_n and
// down_block_n multiples of 64, both groups multiples of 32 dividing
// their K (or per channel), (I / n_k2) a multiple of the down group,
// contiguous operands, h [M, I] bf16, part [n_k2, M, K] f32, one barrier
// word.  `grid_out` receives the number of blocks launched.
extern "C" int tllm_w4a16_fused_mlp(
    const void* x, const void* gu_q, const void* gu_s, const void* gu_z,
    const void* gu_b, const void* d_q, const void* d_s, const void* d_z,
    const void* d_b, void* h, void* part, void* bar, void* stats, void* out,
    int M, int K, int I, int gu_group, int down_group, int gu_block_n,
    int down_block_n, int n_k2, int act, int n_sms, int* grid_out,
    void* stream) {
  using namespace tllm;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FusedParams p;
  p.x = static_cast<const bf16*>(x);
  p.gu_q = static_cast<const int8_t*>(gu_q);
  p.gu_s = static_cast<const bf16*>(gu_s);
  p.gu_z = static_cast<const bf16*>(gu_z);
  p.gu_b = static_cast<const float*>(gu_b);
  p.d_q = static_cast<const int8_t*>(d_q);
  p.d_s = static_cast<const bf16*>(d_s);
  p.d_z = static_cast<const bf16*>(d_z);
  p.d_b = static_cast<const float*>(d_b);
  p.h = static_cast<bf16*>(h);
  p.part = static_cast<float*>(part);
  p.bar = static_cast<unsigned*>(bar);
  p.stats = static_cast<unsigned long long*>(stats);
  p.out = static_cast<bf16*>(out);
  p.M = M;
  p.K = K;
  p.I = I;
  p.Ga = gu_group;
  p.Gd = down_group;
  p.bn_a = gu_block_n;
  p.bn_d = down_block_n;
  p.n_k2 = n_k2;
  p.act = act;
  int per_sm = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, w4a16_fused_mlp_kernel, FM_THREADS, 0);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int n_mb = (M + FM_BM - 1) / FM_BM;
  const int items_a = n_mb * (I / FM_BN);
  const int items_b = n_mb * (K / FM_BN) * n_k2;
  int grid = per_sm * n_sms;
  const int most = items_a > items_b ? items_a : items_b;
  if (grid > most) grid = most;
  *grid_out = grid;
  e = cudaMemsetAsync(bar, 0, sizeof(unsigned), st);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel((const void*)w4a16_fused_mlp_kernel,
                                  dim3(grid), dim3(FM_THREADS), args, 0, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
