// K13 w4a16_ramp: act(x @ ((q - z) * s) + b) from the tiled packing
// [N/BN, K/2, BN], one M block of at most 256 rows, K % 1024 == 0, under a
// ramp schedule of K slabs.
//
// Replaces the TPU kernel tensorrt_llm_tpu/ops/w4a16_gemm.py
// `_w4a16_kernel_ramp` (reached through `w4a16_matmul(variant="ramp")`,
// from a call or a tuned tactic).  The ramp is a schedule, not a new
// function: the weights of each column tile are cut into 1024-row slabs
// and streamed in steps of `slabs[s]` slabs (`ramp_schedule`: the first
// step one slab, so the only cold copy of the call is small, then steps of
// four).
//
// What bounds it on the H100: the K*N/2 weight bytes at decode M; the
// tensor-core operations at a 256-row chunk.
//
// Design: a persistent kernel, one 128-thread block per SM (at most one per
// 32-column tile).  Each block walks a flat sequence of (column tile,
// step) in storage order, its tiles j = blockIdx.x, + gridDim.x, ...  A
// two-stage cp.async ring holds one step each (up to four 16 KB slabs of
// 512 packed rows x 32 columns); while a step is computed the next one is
// in flight, whether it belongs to the same column tile or to the next, so
// the stream never drains at a tile boundary.  The four warps own 8
// columns each and all M rows (MI 16-row fragments, M <= 256); the B
// fragments are built straight from the packed bytes in shared memory (one
// byte holds rows 2r and 2r + 1 of a column: exactly one bf16 pair), with
// the zero point folded in ((q - z) is an exact small integer in bf16).
// x is not staged: at M = 256 and K = 4096 it is 2 MB, more than shared
// memory, so the A fragments come from L2/L1 with 32-bit loads.  Per scale
// group the f32 partial is scaled on the accumulator; bias and activation
// are fused into the store.  With 32-column tiles the grid keeps all 132
// SMs busy only where N >= 4224; smaller N runs on N/32 blocks (the
// occupancy is recorded, K is not split: that would make it K2).
#include "common.cuh"

namespace tllm {
namespace {

constexpr int RP_COLS = 32;
constexpr int RP_SLAB = 1024;                 // K rows per slab
constexpr int RP_SLAB_ROWS = RP_SLAB / 2;     // packed rows per slab
constexpr int RP_MAX_STEP = 4;                // slabs per ring stage
constexpr int RP_STAGE = RP_MAX_STEP * RP_SLAB_ROWS * RP_COLS;  // 64 KB
constexpr int RP_MAX_STEPS = 64;
constexpr int RP_THREADS = 128;

struct RampSchedule {
  int n;
  int slabs[RP_MAX_STEPS];
  int first[RP_MAX_STEPS];   // first slab of each step
};

__device__ __forceinline__ uint32_t ldg_u32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

template <int MI>
__global__ void __launch_bounds__(RP_THREADS, 1) w4a16_ramp_kernel(
    const bf16* __restrict__ x, const int8_t* __restrict__ qw,
    const bf16* __restrict__ scales, const bf16* __restrict__ zeros,
    const float* __restrict__ bias, bf16* __restrict__ out, int M, int N,
    int K, int G, int block_n, int act, RampSchedule sch) {
  extern __shared__ __align__(16) int8_t ring[];   // [2][RP_STAGE]
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int S = sch.n;
  const int n_tiles = N / RP_COLS;
  const int my_tiles =
      (n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int n_items = my_tiles * S;
  const bool per_channel = G >= K;
  const int GL = per_channel ? RP_SLAB : G;    // rows between scale flushes

  // cp.async of one (tile, step) into ring stage item & 1
  auto issue = [&](int item) {
    const int j = (int)blockIdx.x + (item / S) * (int)gridDim.x;
    const int s = item % S;
    const int col0 = j * RP_COLS;
    const int8_t* src = qw + (size_t)(col0 / block_n) * (K / 2) * block_n +
                        (col0 % block_n) +
                        (size_t)sch.first[s] * RP_SLAB_ROWS * block_n;
    int8_t* dst = ring + (item & 1) * RP_STAGE;
    const int pieces = sch.slabs[s] * RP_SLAB_ROWS * 2;   // 16 bytes each
    for (int i = tid; i < pieces; i += RP_THREADS) {
      const int r = i >> 1, h = (i & 1) * 16;
      cp_async16(dst + r * RP_COLS + h, src + (size_t)r * block_n + h, true);
    }
    cp_async_commit();
  };

  if (n_items > 0) issue(0);
  float acc[MI][4];
  const int bcol = warp * 8 + g;        // this lane's B column in the tile
  for (int it = 0; it < n_items; ++it) {
    if (it + 1 < n_items)
      issue(it + 1);
    else
      cp_async_commit();                // keep the group count uniform
    cp_async_wait<1>();
    __syncthreads();
    const int j = (int)blockIdx.x + (it / S) * (int)gridDim.x;
    const int s = it % S;
    const int col0 = j * RP_COLS;
    const int8_t* stage = ring + (it & 1) * RP_STAGE;
    if (s == 0) {
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][e] = 0.f;
    }
    const int kb = sch.first[s] * RP_SLAB;
    const int ke = kb + sch.slabs[s] * RP_SLAB;
    for (int g0 = kb; g0 < ke; g0 += GL) {
      const int srow = per_channel ? 0 : g0 / G;
      const float zc = zeros != nullptr
          ? __bfloat162float(zeros[(size_t)srow * N + col0 + bcol]) : 0.f;
      float part[MI][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mi][e] = 0.f;
#pragma unroll 2
      for (int k = g0; k < g0 + GL; k += 16) {
        const int pr = (k - kb) / 2 + t;   // packed row within the stage
        const uint32_t u0 = (uint8_t)stage[pr * RP_COLS + bcol];
        const uint32_t u1 = (uint8_t)stage[(pr + 4) * RP_COLS + bcol];
        const uint32_t b0 = pack_bf16x2((float)nib_lo(u0) - zc,
                                        (float)nib_hi(u0) - zc);
        const uint32_t b1 = pack_bf16x2((float)nib_lo(u1) - zc,
                                        (float)nib_hi(u1) - zc);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          const int r0 = mi * 16 + g;
          const bf16* xr0 = x + (size_t)r0 * K + k + 2 * t;
          const bf16* xr1 = xr0 + (size_t)8 * K;
          uint32_t a[4];
          a[0] = r0 < M ? ldg_u32(xr0) : 0u;
          a[1] = r0 + 8 < M ? ldg_u32(xr1) : 0u;
          a[2] = r0 < M ? ldg_u32(xr0 + 8) : 0u;
          a[3] = r0 + 8 < M ? ldg_u32(xr1 + 8) : 0u;
          mma_bf16_16816(part[mi], a, b0, b1);
        }
      }
      const int c = col0 + warp * 8 + 2 * t;
      const float s0 = __bfloat162float(scales[(size_t)srow * N + c]);
      const float s1 = __bfloat162float(scales[(size_t)srow * N + c + 1]);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        acc[mi][0] += part[mi][0] * s0;
        acc[mi][1] += part[mi][1] * s1;
        acc[mi][2] += part[mi][2] * s0;
        acc[mi][3] += part[mi][3] * s1;
      }
    }
    if (s == S - 1) {
      const int c = col0 + warp * 8 + 2 * t;
      const float b0 = bias != nullptr ? bias[c] : 0.f;
      const float b1 = bias != nullptr ? bias[c + 1] : 0.f;
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = mi * 16 + g + hh * 8;
          if (row < M)
            *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * N + c) =
                __floats2bfloat162_rn(activate_rt(act, acc[mi][2 * hh] + b0),
                                      activate_rt(act, acc[mi][2 * hh + 1] + b1));
        }
    }
    __syncthreads();   // stage it & 1 is refilled by the next iteration's issue
  }
  cp_async_wait<0>();
}

template <int MI>
int launch(const bf16* x, const int8_t* qw, const bf16* s, const bf16* z,
           const float* b, bf16* out, int M, int N, int K, int G, int bn,
           int act, const RampSchedule& sch, int n_sms, cudaStream_t st) {
  const int smem = 2 * RP_STAGE;
  cudaError_t e = cudaFuncSetAttribute(
      w4a16_ramp_kernel<MI>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int n_tiles = N / RP_COLS;
  const int grid = n_tiles < n_sms ? n_tiles : n_sms;
  w4a16_ramp_kernel<MI><<<grid, RP_THREADS, smem, st>>>(
      x, qw, s, z, b, out, M, N, K, G, bn, act, sch);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace tllm

// The wrapper guarantees: M <= 256, K % 1024 == 0, the pack group divides
// 1024, block_n % 64 == 0, the schedule covers K / 1024 slabs in at most
// 64 steps of 1..4 slabs, contiguous operands.
extern "C" int tllm_w4a16_ramp(const void* x, const void* qweight,
                               const void* scales, const void* zeros,
                               const void* bias, void* out, int M, int N,
                               int K, int group, int block_n, int act,
                               const int* schedule, int n_steps, int n_sms,
                               void* stream) {
  using namespace tllm;
  RampSchedule sch;
  sch.n = n_steps;
  int first = 0;
  for (int i = 0; i < n_steps; ++i) {
    sch.slabs[i] = schedule[i];
    sch.first[i] = first;
    first += schedule[i];
  }
  const bf16* xp = static_cast<const bf16*>(x);
  const int8_t* qp = static_cast<const int8_t*>(qweight);
  const bf16* sp = static_cast<const bf16*>(scales);
  const bf16* zp = static_cast<const bf16*>(zeros);
  const float* bp = static_cast<const float*>(bias);
  bf16* op = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 16) return launch<1>(xp, qp, sp, zp, bp, op, M, N, K, group, block_n, act, sch, n_sms, st);
  if (M <= 32) return launch<2>(xp, qp, sp, zp, bp, op, M, N, K, group, block_n, act, sch, n_sms, st);
  if (M <= 64) return launch<4>(xp, qp, sp, zp, bp, op, M, N, K, group, block_n, act, sch, n_sms, st);
  if (M <= 128) return launch<8>(xp, qp, sp, zp, bp, op, M, N, K, group, block_n, act, sch, n_sms, st);
  return launch<16>(xp, qp, sp, zp, bp, op, M, N, K, group, block_n, act, sch, n_sms, st);
}
