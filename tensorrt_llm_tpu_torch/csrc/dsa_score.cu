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
// ~295.  At the served rows (a few MB of keys) the bound is about a
// microsecond, so the kernel's fixed path (launch, the first loads, the
// epilogue) is what it can shorten.
//
// Design (sm_90a: TMA, mbarriers, wgmma, warp specialisation):
//
// * A block owns `tiles_per_block` 64-token tiles of one sequence's table
//   (`dsa_score_plan` in ops/dsa.py sizes it from the table width so that
//   B x blocks fill the card); tiles wholly past kv_len are never loaded,
//   their slots get NEG_INF.
// * The 64 indexer heads are exactly wgmma's M: Q [64, 128] (16 KB) is
//   loaded once by TMA (two boxes of 64 channels, 128-byte swizzle) and is
//   the shared-memory A operand of S = Q K^T on wgmma m64n64k16 SS.
// * A producer warp streams key tiles [64 tokens, 128 channels], the
//   K-major B operand as stored, by TMA into a ring of four stages with
//   complete_tx mbarriers: K3/K4's tensor maps over the pool viewed as
//   [NB * BS, 128] (boxes of gcd(BS, 64) rows x 64 channels, so BS % 8 ==
//   0).  It reads the block-table entries of 32 page runs at a time, one a
//   lane, ahead of their tiles, so that no tile's copies wait on a table
//   read.  The runs of a tile past the sequence's last page are not
//   loaded: their columns hold stale keys, and every column's sum reads
//   only its own token, which the mask then replaces by NEG_INF.
// * One consumer warpgroup: per tile eight wgmmas, then relu, times
//   w[b, h] and the sum over the 64 heads: the thread's two rows, the 8
//   row groups of a warp by shuffles, the four warps through shared memory
//   (double-buffered, one named barrier a tile), in a fixed order, so a
//   second call gives the same bits.  The loads of the next tiles run
//   under this tile's products and epilogue.
#include <math.h>

#include "sm90.cuh"

namespace tllm {
namespace {

using namespace sm90;

constexpr int DS_HI = 64;                      // indexer heads (wgmma's M)
constexpr int DS_DI = 128;                     // channels
constexpr int DS_TILE = PAGED_TILE;            // tokens a tile
constexpr int DS_BOXES = DS_DI / 64;           // boxes of 64 channels
constexpr int DS_TILE_BYTES = DS_BOXES * PAGED_BOX;   // 16 KB
constexpr int DS_STAGES = 4;
constexpr int DS_CWARPS = 4;                   // one consumer warpgroup
constexpr int DS_THREADS = DS_CWARPS * 32 + 32;   // + a producer warp
constexpr float DS_NEG_INF = -3.4028234663852886e38f;
// shared memory, from a 1 KB aligned base: Q [64, 128] bf16 (16 KB), the
// ring, the head sums [2][4 warps][64] f32, the barriers
constexpr int DS_Q = 0;
constexpr int DS_RING = DS_Q + DS_TILE_BYTES;
constexpr int DS_RED = DS_RING + DS_STAGES * DS_TILE_BYTES;
constexpr int DS_BARS = DS_RED + 2 * DS_CWARPS * DS_TILE * 4;
constexpr int DS_SMEM = DS_BARS + (2 * DS_STAGES + 1) * 8 + 1024;
static_assert(2 * DS_SMEM <= 232448, "two K11 blocks an SM");

struct DsParams {
  const float* w;
  const int* tables;
  const int* kv_lens;
  float* out;
  int BS, BR, MB, tiles_per_block;
};

__global__ void __launch_bounds__(DS_THREADS) dsa_score_kernel(
    const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap kmap, const DsParams p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + DS_BARS);
  uint64_t* empty = full + DS_STAGES;
  uint64_t* qbar = empty + DS_STAGES;

  const int b = blockIdx.y;
  const int S = p.MB * p.BS;
  const int kv_len = max(0, min(p.kv_lens[b], S));
  const int t0 = blockIdx.x * p.tiles_per_block;
  const int t1 = min(t0 + p.tiles_per_block, (S + DS_TILE - 1) / DS_TILE);
  const int t_live = min(t1, (kv_len + DS_TILE - 1) / DS_TILE);
  float* orow = p.out + (size_t)b * S;
  // the slots of the tiles wholly past kv_len: NEG_INF, never loaded
  for (int i = max(t0, t_live) * DS_TILE + threadIdx.x;
       i < min(t1 * DS_TILE, S); i += DS_THREADS)
    orow[i] = DS_NEG_INF;
  const int n = t_live - t0;
  if (n <= 0) return;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < DS_STAGES; ++s) {
      mbar_init(&full[s], 32);          // the producer's lanes
      mbar_init(&empty[s], DS_CWARPS);  // the consumer warps
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == DS_CWARPS) {
    // ------------------------------------------------------ producer ---
    if (lane == 0) {
      mbar_expect_tx(qbar, DS_TILE_BYTES);
      for (int c = 0; c < DS_BOXES; ++c)
        tma_load_2d(base + DS_Q + c * PAGED_BOX, &qmap, c * 64, b * DS_HI,
                    qbar);
    }
    const int R = p.BR, n_runs = DS_TILE / R;
    // runs from tok_end on lie past the sequence's last page
    const int tok_end = min(((kv_len - 1) / p.BS + 1) * p.BS, S);
    const int* table = p.tables + (size_t)b * p.MB;
    // the pool row of the block's run `run` (-1: not loaded), 32 runs at
    // a time, one a lane
    auto run_row = [&](int run) -> int {
      const int tok = t0 * DS_TILE + run * R;
      return tok < tok_end ? table[tok / p.BS] * p.BS + tok % p.BS : -1;
    };
    int my_row = run_row(lane);
    for (int i = 0; i < n; ++i) {
      const int slot = i % DS_STAGES, run0 = i * n_runs;
      if (run0 % 32 == 0 && i > 0) my_row = run_row(run0 + lane);
      const int mine = __shfl_sync(0xffffffffu, my_row, (run0 + lane) & 31);
      const int n_ld =
          __popc(__ballot_sync(0xffffffffu, lane < n_runs && mine >= 0));
      mbar_wait(&empty[slot], ((i / DS_STAGES) & 1) ^ 1);
      if (lane == 0) mbar_expect_tx(&full[slot], n_ld * R * 128 * DS_BOXES);
      __syncwarp();
      uint8_t* st = base + DS_RING + slot * DS_TILE_BYTES;
      for (int r = 0; r < n_ld; ++r) {
        const int row = __shfl_sync(0xffffffffu, my_row, (run0 + r) & 31);
        if (lane < DS_BOXES)
          tma_load_2d(st + lane * PAGED_BOX + r * R * 128, &kmap, lane * 64,
                      row, &full[slot]);
      }
      if (lane != 0) mbar_arrive(&full[slot]);
    }
    return;
  }

  // ------------------------------------------------------- consumers ---
  const int g = lane >> 2, t = lane & 3;
  // this thread's heads 16 warp + g and + 8, and their weights
  const float w0 = p.w[(size_t)b * DS_HI + 16 * warp + g];
  const float w1 = p.w[(size_t)b * DS_HI + 16 * warp + g + 8];
  float* red = reinterpret_cast<float*>(base + DS_RED);
  const uint32_t q_s = smem_u32(base + DS_Q);
  const uint32_t ring_s = smem_u32(base + DS_RING);
  mbar_wait(qbar, 0);
  for (int i = 0; i < n; ++i) {
    const int slot = i % DS_STAGES;
    mbar_wait(&full[slot], (i / DS_STAGES) & 1);
    // S = Q K^T: 64 heads x 64 tokens over 128 channels, 8 k16 steps
    float s[DS_TILE / 2];
    const uint32_t st_s = ring_s + slot * DS_TILE_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DS_DI / 16; ++kk) {
      const int off = (kk >> 2) * PAGED_BOX + (kk & 3) * 32;
      WgmmaSS<64>::mma(s, desc_b128(q_s + off), desc_b128(st_s + off),
                       kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    keep_all(s);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);

    // relu, times the head's weight, summed over the warp's 16 heads:
    // s[4j + e] is head g, token 8j + 2t + e; s[4j + 2 + e] head g + 8
    float* rb = red + ((i & 1) * DS_CWARPS + warp) * DS_TILE;
#pragma unroll
    for (int j = 0; j < DS_TILE / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = fmaxf(s[4 * j + e], 0.f) * w0 +
                  fmaxf(s[4 * j + 2 + e], 0.f) * w1;
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (g == 0) rb[8 * j + 2 * t + e] = v;
      }
    // the four warps' sums (buffer i & 1: the barrier of tile i + 1 keeps
    // tile i + 2's writes behind every read of tile i)
    named_sync(1, DS_CWARPS * 32);
    if (threadIdx.x < DS_TILE) {
      const int pos = (t0 + i) * DS_TILE + threadIdx.x;
      const float* rr = red + (i & 1) * DS_CWARPS * DS_TILE + threadIdx.x;
      const float v = ((rr[0] + rr[DS_TILE]) + rr[2 * DS_TILE]) +
                      rr[3 * DS_TILE];
      if (pos < S) orow[pos] = pos < kv_len ? v : DS_NEG_INF;
    }
  }
}

}  // namespace
}  // namespace tllm

// q [B, Hi, Di] bf16, w [B, Hi] f32 (pre-scaled), pool [NB, 1, BS, Di]
// bf16 (q and the pool 16-byte aligned), tables [B, MB] int32, kv_lens [B]
// int32, out [B, MB * BS] f32; BS % 8 == 0; a block takes tiles_per_block
// 64-token tiles of one sequence (`dsa_score_plan`).  Built for (Hi, Di) =
// (64, 128).
extern "C" int tllm_dsa_score(const void* q, const void* w, const void* pool,
                              const void* tables, const void* kv_lens,
                              void* out, int B, int Hi, int Di, int NB,
                              int BS, int MB, int tiles_per_block,
                              void* stream) {
  using namespace tllm;
  using namespace tllm::sm90;
  if (Hi != DS_HI || Di != DS_DI || BS % 8 || tiles_per_block < 1)
    return (int)cudaErrorInvalidValue;
  CUtensorMap qmap, kmap;
  int e = tensor_map_2d(&qmap, q, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, DS_DI,
                        (uint64_t)B * DS_HI, DS_DI * 2, 64, DS_HI,
                        CU_TENSOR_MAP_SWIZZLE_128B);
  if (e) return e;
  e = tensor_map_2d(&kmap, pool, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, DS_DI,
                    (uint64_t)NB * BS, DS_DI * 2, 64, paged_box_rows(BS),
                    CU_TENSOR_MAP_SWIZZLE_128B);
  if (e) return e;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t ce = cudaFuncSetAttribute(
        dsa_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        DS_SMEM);
    if (ce != cudaSuccess) return (int)ce;
    attr_set = true;
  }
  DsParams p;
  p.w = static_cast<const float*>(w);
  p.tables = static_cast<const int*>(tables);
  p.kv_lens = static_cast<const int*>(kv_lens);
  p.out = static_cast<float*>(out);
  p.BS = BS;
  p.BR = paged_box_rows(BS);
  p.MB = MB;
  p.tiles_per_block = tiles_per_block;
  const int tiles = (MB * BS + DS_TILE - 1) / DS_TILE;
  dim3 grid((tiles + tiles_per_block - 1) / tiles_per_block, B);
  dsa_score_kernel<<<grid, DS_THREADS, DS_SMEM,
                     static_cast<cudaStream_t>(stream)>>>(qmap, kmap, p);
  return (int)cudaGetLastError();
}
