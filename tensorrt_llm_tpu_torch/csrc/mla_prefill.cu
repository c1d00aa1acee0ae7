// K10 mla_prefill: absorbed Multi-head Latent Attention for one
// sequence's prefill chunk.  T query tokens at positions q_offset.., H
// heads of L + R channels each, attend the sequence's paged latents
// (prefix + chunk, already written) causally.  Out: [T, H, L] bf16.
//
// Replaces the TPU kernel tensorrt_llm_tpu/ops/mla_pallas.py
// `_mla_prefill_kernel` (L = 512, L + R = 576).
//
// What bounds it on the H100: tensor-core operations.  A chunk of T tokens
// against S cached tokens does ~2 * T * H * S * (576 + 512) operations
// (halved by the causal edge) over S * 1,152 latent bytes: at T = 256 and
// H = 128 that is tens of thousands of operations per byte.
//
// Design (the block routine is mla_common.cuh): rows are (token, head)
// pairs, row = token * H + head, as the TPU kernel stacks TQ tokens x H
// heads into one MXU row block; one 128-thread block per 16 rows.  At
// H >= 16 the 16 rows of a block belong to one token, so every block has one
// causal edge: latent tiles past the block's last position (min(kv_len,
// q_offset + token + 1)) are never loaded, the `q_end` skip of the TPU
// kernel.  Each row also masks kv_pos < kv_len and kv_pos <= q_pos.  The
// 64-token tiles stream through a two-stage cp.async ring; S = Q K^T and
// O += P V (V = the tile's first 512 channels) run on mma.sync with the
// [16, 512] f32 accumulator split by columns over the 4 warps.  No split
// of the latents is needed: T * H / 16 row blocks (2,048 at T = 256, H =
// 128) fill the card.  A latent row is read once per row block that
// reaches it, mostly from L2.  Scores are scaled in f32 after the dot, as
// in the TPU kernel; P is rounded to bf16 for P V.  No TMA, no wgmma yet.
#include "mla_common.cuh"

namespace tllm {
namespace {

using mla::ROWS;
using mla::THREADS;
using mla::WARPS;

template <int L, int DK>
__global__ void __launch_bounds__(THREADS) mla_prefill_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ pool,
    const int* __restrict__ table, bf16* __restrict__ out, int T, int H,
    int BS, int MB, int kv_len, int q_offset, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int R = T * H;
  const int row0 = blockIdx.x * ROWS;
  const int nrows = min(ROWS, R - row0);
  kv_len = min(kv_len, MB * BS);
  // exclusive key limit of a row: causal edge and kv_len
  auto limit = [&](int r) {
    return r < nrows ? min(kv_len, q_offset + (row0 + r) / H + 1) : 0;
  };
  const int end = limit(nrows - 1);   // the block's last row sees furthest
  float o[L / 32][4], m_r[2], l_r[2];
  mla::attend<L, DK>(q + (size_t)row0 * DK, nrows, pool, table, BS, 0, end,
                     limit(g), limit(g + 8), scale, smem, o, m_r, l_r);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = g + 8 * hh;
    if (r >= nrows) continue;
    const float inv = l_r[hh] > 0.f ? 1.f / l_r[hh] : 1.f;
    bf16* orow = out + (size_t)(row0 + r) * L;
#pragma unroll
    for (int n = 0; n < L / 32; ++n) {
      const int c = warp * (L / WARPS) + n * 8 + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(orow + c) = __floats2bfloat162_rn(
          o[n][2 * hh] * inv, o[n][2 * hh + 1] * inv);
    }
  }
}

template <int L, int DK>
int launch(const bf16* q, const bf16* pool, const int* table, bf16* out,
           int T, int H, int BS, int MB, int kv_len, int q_offset,
           float scale, cudaStream_t st) {
  constexpr size_t smem = mla::Smem<DK>::total;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        mla_prefill_kernel<L, DK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  dim3 grid((T * H + ROWS - 1) / ROWS);
  mla_prefill_kernel<L, DK><<<grid, THREADS, smem, st>>>(
      q, pool, table, out, T, H, BS, MB, kv_len, q_offset, scale);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace tllm

// q [T, H, DK] bf16, pool [NB, 1, BS, DK] bf16, table [MB] int32, out
// [T, H, L] bf16; kv_len counts the prefix plus the chunk.  Built for
// (L, DK) = (512, 576).
extern "C" int tllm_mla_prefill(const void* q, const void* pool,
                                const void* table, void* out, int T, int H,
                                int L, int DK, int BS, int MB, int kv_len,
                                int q_offset, float scale, void* stream) {
  if (L != 512 || DK != 576) return (int)cudaErrorInvalidValue;
  return tllm::launch<512, 576>(
      static_cast<const tllm::bf16*>(q), static_cast<const tllm::bf16*>(pool),
      static_cast<const int*>(table), static_cast<tllm::bf16*>(out), T, H, BS,
      MB, kv_len, q_offset, scale, static_cast<cudaStream_t>(stream));
}
