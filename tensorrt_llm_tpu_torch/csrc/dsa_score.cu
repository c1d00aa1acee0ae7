// K11 dsa_score: DeepSeek V3.2's lightning-indexer scores at decode,
//   score[b, s] = sum_h w[b, h] * relu(q[b, h] . k[s])
// for every slot s of each sequence's block table, NEG_INF (the f32
// minimum) at and past kv_lens[b].  q [B, 64, 128] bf16, w [B, 64] f32,
// indexer keys [NB, 1, BS, 128] bf16 in a paged pool; out [B, MB * BS] f32.
//
// Replaces the TPU kernel tensorrt_llm_tpu/ops/dsa.py `_dsa_score_kernel`.
// Its 8-row broadcast output block is a Mosaic layout limit and is not
// ported: the output is one f32 row per sequence.  The top-k that follows
// stays a library call (`torch.sort` in `dsa_decode_select`), as
// `lax.top_k` stays in XLA on the TPU.
//
// What bounds it on the H100: the key bytes.  Per token it reads 256 bytes
// and does 2 * 64 * 128 operations, 64 per byte, below the bf16 ridge of
// ~295.
//
// Design: one 128-thread block per (sequence, 128 tokens), two 64-token
// tiles.  Each warp owns 16 of the 64 heads and keeps their q as mma A
// fragments in registers, loaded once per block.  A tile of keys [64, 128]
// is staged in shared memory (16-byte loads through the block table), the
// [64 heads, 64 tokens] logits run on mma.sync m16n8k16 (f32 accumulate),
// then relu, times w[b, h] and a column sum over the heads: the two rows
// of a thread, then the 8 row groups of the warp by shuffles, then the 4
// warps through shared memory.  Tiles wholly past kv_len are not loaded;
// their slots, and slots past kv_len in a partial tile, get NEG_INF.  No
// TMA or wgmma yet.
#include <math.h>

#include "common.cuh"

namespace tllm {
namespace {

constexpr int DS_TILE = 64;
constexpr int DS_TILES = 2;      // tiles per block
constexpr int DS_THREADS = 128;
constexpr float DS_NEG_INF = -3.4028234663852886e38f;

template <int HI, int DI>
__global__ void __launch_bounds__(DS_THREADS) dsa_score_kernel(
    const bf16* __restrict__ q, const float* __restrict__ w,
    const bf16* __restrict__ pool, const int* __restrict__ tables,
    const int* __restrict__ kv_lens, float* __restrict__ out, int BS,
    int MB) {
  static_assert(HI == 16 * (DS_THREADS / 32) && DI % 16 == 0, "K11 shape");
  constexpr int LD = DI + 8;
  __shared__ __align__(16) bf16 ks[DS_TILE][LD];
  __shared__ float red[DS_THREADS / 32][DS_TILE];
  const int b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int S = MB * BS;
  const int kv_len = min(kv_lens[b], S);
  const int* table = tables + (size_t)b * MB;
  float* orow = out + (size_t)b * S;

  // this warp's 16 heads as A fragments, and their weights
  const bf16* qb = q + ((size_t)b * HI + warp * 16 + g) * DI + 2 * t;
  uint32_t qa[DI / 16][4];
#pragma unroll
  for (int kk = 0; kk < DI / 16; ++kk) {
    qa[kk][0] = ld_u32(qb + kk * 16);
    qa[kk][1] = ld_u32(qb + 8 * DI + kk * 16);
    qa[kk][2] = ld_u32(qb + kk * 16 + 8);
    qa[kk][3] = ld_u32(qb + 8 * DI + kk * 16 + 8);
  }
  const float w0 = w[(size_t)b * HI + warp * 16 + g];
  const float w1 = w[(size_t)b * HI + warp * 16 + g + 8];

  for (int tile = 0; tile < DS_TILES; ++tile) {
    const int s0 = (blockIdx.x * DS_TILES + tile) * DS_TILE;
    if (s0 >= S) break;
    if (s0 >= kv_len) {          // uniform over the block
      if (tid < DS_TILE && s0 + tid < S) orow[s0 + tid] = DS_NEG_INF;
      continue;
    }
    for (int i = tid; i < DS_TILE * DI / 8; i += DS_THREADS) {
      const int r = i / (DI / 8), c = (i % (DI / 8)) * 8;
      const int pos = s0 + r;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (pos < kv_len)
        v = *reinterpret_cast<const uint4*>(
            pool + ((size_t)table[pos / BS] * BS + pos % BS) * DI + c);
      *reinterpret_cast<uint4*>(&ks[r][c]) = v;
    }
    __syncthreads();

    float s[DS_TILE / 8][4];
#pragma unroll
    for (int ni = 0; ni < DS_TILE / 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[ni][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DI / 16; ++kk)
#pragma unroll
      for (int ni = 0; ni < DS_TILE / 8; ++ni) {
        const bf16* kr = &ks[ni * 8 + g][kk * 16 + 2 * t];
        mma_bf16_16816(s[ni], qa[kk], ld_u32(kr), ld_u32(kr + 8));
      }

    // relu, weight, sum over this warp's 16 heads
#pragma unroll
    for (int ni = 0; ni < DS_TILE / 8; ++ni)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = fmaxf(s[ni][e], 0.f) * w0 + fmaxf(s[ni][2 + e], 0.f) * w1;
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (g == 0) red[warp][ni * 8 + 2 * t + e] = v;
      }
    __syncthreads();
    if (tid < DS_TILE) {
      const int pos = s0 + tid;
      float v = 0.f;
#pragma unroll
      for (int k = 0; k < DS_THREADS / 32; ++k) v += red[k][tid];
      if (pos < S) orow[pos] = pos < kv_len ? v : DS_NEG_INF;
    }
    __syncthreads();
  }
}

}  // namespace
}  // namespace tllm

// q [B, Hi, Di] bf16, w [B, Hi] f32 (pre-scaled), pool [NB, 1, BS, Di]
// bf16, tables [B, MB] int32, kv_lens [B] int32, out [B, MB * BS] f32.
// Built for (Hi, Di) = (64, 128).
extern "C" int tllm_dsa_score(const void* q, const void* w, const void* pool,
                              const void* tables, const void* kv_lens,
                              void* out, int B, int Hi, int Di, int BS,
                              int MB, void* stream) {
  using namespace tllm;
  if (Hi != 64 || Di != 128) return (int)cudaErrorInvalidValue;
  const int per_block = DS_TILE * DS_TILES;
  dim3 grid((MB * BS + per_block - 1) / per_block, B);
  dsa_score_kernel<64, 128><<<grid, DS_THREADS, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const float*>(w),
      static_cast<const bf16*>(pool), static_cast<const int*>(tables),
      static_cast<const int*>(kv_lens), static_cast<float*>(out), BS, MB);
  return (int)cudaGetLastError();
}
