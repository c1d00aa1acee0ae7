// K10 mla_prefill: absorbed Multi-head Latent Attention for one
// sequence's prefill chunk.  T query tokens at positions q_offset.., H
// heads of L + R = 576 channels each (q_nope absorbed through W_uk, then
// the roped q_pe), attend the sequence's paged latents [NB, 1, BS, 576]
// (prefix + chunk, already written) causally: keys are all 576 channels of
// a latent row, values its first L = 512.  Out: [T, H, 512] bf16.
//
// Replaces the TPU kernel tensorrt_llm_tpu/ops/mla_pallas.py
// `_mla_prefill_kernel`: the f32 scores are scaled after the dot, masked
// by kv_pos <= q_pos and kv_pos < kv_len, and P is rounded to bf16 for
// P V.
//
// What bounds it on the H100: tensor-core operations.  A chunk does
// 2 * H * (576 + 512) operations per (token, visible latent) pair over
// 1,152 latent bytes per cached token: at DeepSeek-V3's 128 heads, T 256
// at q_offset 256, 27.4 GFLOP, a 27.7 us bound; at Moonlight's 16 heads
// 3.4 GFLOP.
//
// Design (sm_90a: TMA, mbarriers, wgmma, warp specialisation):
//
// * Rows are stacked as in the TPU kernel, row = token * H + head, 64 rows
//   a block (wgmma's M).  At H 128 a block is half of one token's heads,
//   at H 16 four tokens.  Latent tiles past the causal edge of the block's
//   last row are never loaded (the TPU kernel's `q_end` skip).
// * The Q block [64, 576] bf16 is loaded once by TMA (nine boxes of 64
//   channels, 128-byte swizzle; rows past T * H read as TMA's zeros) and is
//   the shared-memory A operand of S = Q K^T.  A 64-token latent tile is
//   nine boxes of [64 tokens, 64 channels] filled by TMA per page run (a
//   tensor map over the pool viewed as [NB * BS, 576], boxes of
//   gcd(BS, 64) rows); the same staged tile is the K-major B operand of S
//   and, its first eight boxes, the MN-major B operand of P V (wgmma's
//   transpose bit): no second copy.  Tokens of the last tile that lie in
//   no page of the sequence are zeroed by the producer (a stale bf16 NaN
//   times P = 0 would poison the sum).
// * The [64, 512] f32 accumulator is 256 registers a thread in one
//   warpgroup, so two consumer warpgroups each own 256 value columns (128
//   registers).  S is computed once per tile: warpgroup w takes tiles w,
//   w + 2, ... of the block's range.  Before its tile i it takes the other
//   warpgroup's P_{i-1} and row statistics from shared memory and runs
//   P_{i-1} V_{i-1} on its columns, which frees that stage; then S_i and
//   the online softmax of tile i (f32, base-2 exponentials) from the
//   running max m_{i-1} the other warpgroup handed over; then it
//   writes P_i (bf16, 128-byte swizzle) and (m_i, rescale alpha_i) for the
//   other warpgroup, signals it with a named barrier, and issues
//   P_i V_i on its own columns with P from registers.  The two
//   warpgroups' tensor work interleaves: one's softmax runs under the
//   other's products.  Each keeps the row sum of its own tiles, rescaled by
//   every tile's alpha; the two sums add at the end.  No accumulator is
//   read while a wgmma is in flight: a softmax run under P V made ptxas
//   serialize every wgmma (C7514).  The consumers take the producer
//   warpgroup's registers (setmaxnreg 40 / 232).
// * One producer warp: Q first, then each tile's page runs, the lanes
//   reading the block table in parallel, into a two-stage ring with
//   complete_tx mbarriers; a stage is freed when both warpgroups' P V on
//   it retired.
// * Shared memory, 227 KB a block at most: Q 72 KB + two 72 KB stages
//   (216 KB), P 8 KB, row statistics 1.5 KB, barriers, and 1 KB to align
//   the base for the 128-byte swizzle (static_assert below).  One block an
//   SM.
// * Filling the card: blocks x splits cover the 132 SMs where the latent
//   range has the tiles (`mla_prefill_plan` in ops/mla.py).  With several
//   splits, each (block, split) writes its unnormalised partial (max, sum,
//   512 f32 sums) and a second pass merges the splits and normalises, as
//   K9 does; splits past a block's causal edge do nothing.
#include <math.h>

#include "sm90.cuh"

namespace tllm {
namespace {

using namespace sm90;

constexpr int MP_L = 512;                    // value channels
constexpr int MP_NJ = MP_L / 2 / 8;          // 8-column groups a warpgroup
constexpr int MP_DK = 576;                   // key channels (L + R)
constexpr int MP_ROWS = 64;                  // stacked query rows a block
constexpr int MP_TILE = PAGED_TILE;          // latent tokens a tile
constexpr int MP_BOXES = MP_DK / 64;         // boxes of 64 channels (128 B)
constexpr int MP_BOX = PAGED_BOX;            // one box of 64 rows: 8 KB
constexpr int MP_TILE_BYTES = MP_BOXES * MP_BOX;   // 72 KB
constexpr int MP_STAGES = 2;
constexpr int MP_THREADS = 3 * 128;          // two consumer warpgroups + producer
// shared memory, from a 1 KB aligned base
constexpr int MP_Q = 0;
constexpr int MP_RING = MP_Q + MP_TILE_BYTES;
constexpr int MP_P = MP_RING + MP_STAGES * MP_TILE_BYTES;  // [64 x 64] bf16
constexpr int MP_STATS = MP_P + MP_ROWS * 128;  // alpha, max, sum: [2][64] f32
constexpr int MP_BARS = MP_STATS + 3 * 2 * MP_ROWS * 4;
constexpr int MP_SMEM = MP_BARS + (2 * MP_STAGES + 1) * 8 + 1024;
static_assert(MP_SMEM <= 232448, "K10's shared memory exceeds a block's");
// named barriers (0 is __syncthreads): 1 + w "P ready for warpgroup w",
// 3 + w warpgroup w's own, 5 both warpgroups
constexpr int BAR_P = 1, BAR_WG = 3, BAR_ALL = 5;

__global__ void __launch_bounds__(MP_THREADS, 1) mla_prefill_sm90_kernel(
    const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap kvmap, const int* __restrict__ table,
    bf16* __restrict__ out, float* __restrict__ ws, int T, int H, int BS,
    int BR, int MB, int kv_len, int q_offset, float scale, int n_blocks,
    int n_splits, int split_tiles) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + MP_BARS);
  uint64_t* empty = full + MP_STAGES;
  uint64_t* qbar = empty + MP_STAGES;

  // the latest rows first: they see the most latents
  const int b = n_blocks - 1 - (int)blockIdx.x / n_splits;
  const int split = (int)blockIdx.x % n_splits;
  const int R = T * H;
  const int row0 = b * MP_ROWS;
  const int last_row = min(row0 + MP_ROWS, R) - 1;
  const int kv_end = min(kv_len, q_offset + last_row / H + 1);
  const int t_all = (kv_end + MP_TILE - 1) / MP_TILE;
  const int t_begin = split * split_tiles;
  const int t_end = min(t_all, t_begin + split_tiles);
  if (t_begin >= t_end) return;   // past the block's causal edge

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < MP_STAGES; ++s) {
      mbar_init(&full[s], 32);    // the producer's lanes
      mbar_init(&empty[s], 8);    // the warps of both warpgroups
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {
    // ------------------------------------------------------ producer ---
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp != 8) return;
    if (lane == 0) {
      mbar_expect_tx(qbar, MP_TILE_BYTES);
      for (int c = 0; c < MP_BOXES; ++c)
        tma_load_2d(base + MP_Q + c * MP_BOX, &qmap, c * 64, row0, qbar);
    }
    const int tok_end = min(((kv_len - 1) / BS + 1) * BS, MB * BS);
    for (int tile = t_begin; tile < t_end; ++tile) {
      const int k = tile - t_begin, slot = k % MP_STAGES;
      tma_paged_tile(base + MP_RING + slot * MP_TILE_BYTES, &kvmap, &kvmap,
                     1, MP_BOXES, table, 1, 0, BS, BR, tile * MP_TILE,
                     tok_end, &full[slot], &empty[slot],
                     ((k / MP_STAGES) & 1) ^ 1, lane);
    }
    return;
  }

  // ------------------------------------------------------- consumers ---
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = warp >> 2, wl = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  float* alpha_sm = reinterpret_cast<float*>(base + MP_STATS);
  float* max_sm = alpha_sm + 2 * MP_ROWS;
  float* sum_sm = max_sm + 2 * MP_ROWS;
  const uint32_t q_s = smem_u32(base + MP_Q);
  const uint32_t ring_s = smem_u32(base + MP_RING);
  const uint32_t p_s = smem_u32(base + MP_P);
  // this thread's rows (wgmma rows 16 wl + g and + 8), and the exclusive
  // key limit of each: its causal edge and kv_len (0 past the last row)
  int rl[2], lim[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    rl[hh] = wl * 16 + g + hh * 8;
    const int r = row0 + rl[hh];
    lim[hh] = r < R ? min(kv_len, q_offset + r / H + 1) : 0;
  }
  // the V columns of this warpgroup: boxes 4 wg .. 4 wg + 3 of a stage
  auto v_desc = [&](int slot, int kk) {
    return desc_mn128(ring_s + slot * MP_TILE_BYTES + 4 * wg * MP_BOX +
                          kk * 16 * 128,
                      MP_BOX);
  };

  constexpr float LOG2E = 1.4426950408889634f;
  const float sl2 = scale * LOG2E;
  float o[MP_L / 4];
#pragma unroll
  for (int i = 0; i < MP_L / 4; ++i) o[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};   // running max, base 2
  float l_w[2] = {0.f, 0.f};   // the sum over this warpgroup's own tiles
  uint32_t pa[MP_TILE / 16][4];
  mbar_wait(qbar, 0);

  // the other warpgroup's tile i: wait for its P and row statistics,
  // rescale O and the row sum, run P V on this warpgroup's columns and
  // free this warpgroup's use of the tile's stage
  auto take_other = [&](int i) {
    named_sync(BAR_P + wg, 256);
    const int sb = (i & 1) * MP_ROWS;
    float a[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      a[hh] = alpha_sm[sb + rl[hh]];
      m_run[hh] = max_sm[sb + rl[hh]];
      l_w[hh] *= a[hh];
    }
#pragma unroll
    for (int j = 0; j < MP_NJ; ++j) {
      o[4 * j] *= a[0];
      o[4 * j + 1] *= a[0];
      o[4 * j + 2] *= a[1];
      o[4 * j + 3] *= a[1];
    }
    keep_all(o);
    wgmma_fence();
    const int slot = (i - t_begin) % MP_STAGES;
#pragma unroll
    for (int kk = 0; kk < MP_TILE / 16; ++kk)
      WgmmaSS<256>::mma<1>(o, desc_b128(p_s + kk * 32), v_desc(slot, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    keep_all(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);
  };

  for (int i = t_begin + wg; i < t_end; i += 2) {
    const int k = i - t_begin, slot = k % MP_STAGES;
    // the other warpgroup's tile i - 1 first: its stage is freed without
    // waiting for tile i, so tile i + 1 loads sooner (with two stages the
    // blocks wait on latent tiles more than on anything else)
    const bool prev = i > t_begin;
    if (prev) take_other(i - 1);
    mbar_wait(&full[slot], (k / MP_STAGES) & 1);
    // S = Q K^T: 64 rows x 64 tokens over 576 channels, 36 k16 steps
    float s[MP_TILE / 2];
    const uint32_t st_s = ring_s + slot * MP_TILE_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < MP_DK / 16; ++kk) {
      const int off = (kk >> 2) * MP_BOX + (kk & 3) * 32;
      WgmmaSS<64>::mma(s, desc_b128(q_s + off), desc_b128(st_s + off),
                       kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    keep_all(s);

    // scale, mask and the online softmax of both rows: s[4j + e] is row
    // g, token 8j + 2t + e; s[4j + 2 + e] row g + 8
    const int s0 = i * MP_TILE;
    float alpha[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < MP_TILE / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kvp = s0 + 8 * j + 2 * t + e;
          float& v = s[4 * j + 2 * hh + e];
          v = kvp < lim[hh] ? v * sl2 : -INFINITY;
          mx = fmaxf(mx, v);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[hh], mx);
      const float msub = m_new == -INFINITY ? 0.f : m_new;
      alpha[hh] = exp2f(m_run[hh] - msub);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < MP_TILE / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& v = s[4 * j + 2 * hh + e];
          v = exp2f(v - msub);
          rs += v;
        }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l_w[hh] = l_w[hh] * alpha[hh] + rs;
      m_run[hh] = m_new;
    }
    // P as bf16 A fragments of the k16 steps (tokens 16kk..16kk+15)
#pragma unroll
    for (int kk = 0; kk < MP_TILE / 16; ++kk) {
      const float* a = s + 8 * kk;
      pa[kk][0] = pack_bf16x2(a[0], a[1]);
      pa[kk][1] = pack_bf16x2(a[2], a[3]);
      pa[kk][2] = pack_bf16x2(a[4], a[5]);
      pa[kk][3] = pack_bf16x2(a[6], a[7]);
    }
    // every warp's P_{i-1} V has read the P buffer
    if (prev) named_sync(BAR_WG + wg, 128);
    // hand P_i, m_i and alpha_i to the other warpgroup.  P [64 rows][64
    // tokens] bf16 in the 128-byte swizzle: the 16-byte chunk c of row r
    // at chunk c ^ (r & 7)
    {
      uint8_t* pb = base + MP_P;
#pragma unroll
      for (int kk = 0; kk < MP_TILE / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = rl[e & 1], c = 2 * kk + (e >> 1);
          *reinterpret_cast<uint32_t*>(pb + (r >> 3) * 1024 + (r & 7) * 128 +
                                       ((c ^ (r & 7)) << 4) + 4 * t) =
              pa[kk][e];
        }
      const int sb = (i & 1) * MP_ROWS;
      if (t == 0) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          alpha_sm[sb + rl[hh]] = alpha[hh];
          max_sm[sb + rl[hh]] = m_run[hh];
        }
      }
      fence_proxy_async();
      named_arrive(BAR_P + (1 - wg), 256);
    }
    // O = O * alpha_i + P_i V_i on this warpgroup's columns
#pragma unroll
    for (int j = 0; j < MP_NJ; ++j) {
      o[4 * j] *= alpha[0];
      o[4 * j + 1] *= alpha[0];
      o[4 * j + 2] *= alpha[1];
      o[4 * j + 3] *= alpha[1];
    }
    keep_all(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < MP_TILE / 16; ++kk)
      Wgmma<256>::mma<1>(o, pa[kk], v_desc(slot, kk));
    wgmma_commit();
    wgmma_wait<0>();
    keep_all(o);
    keep_all(pa);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);
  }
  // the range's last tile, when it is the other warpgroup's
  if (((t_end - 1 - t_begin) & 1) != wg) take_other(t_end - 1);

  // both warpgroups hold every row's final max; the row sum is the sum of
  // their two partial sums
  if (t == 0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) sum_sm[wg * MP_ROWS + rl[hh]] = l_w[hh];
  }
  named_sync(BAR_ALL, 256);
  float l_r[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    l_r[hh] = l_w[hh] + sum_sm[(1 - wg) * MP_ROWS + rl[hh]];

  // o[4j + 0, 1] row g, o[4j + 2, 3] row g + 8, at column 256 wg + 8j + 2t
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row0 + rl[hh];
    if (r >= R) continue;
    if (n_splits == 1) {
      const float inv = l_r[hh] > 0.f ? 1.f / l_r[hh] : 1.f;
      bf16* orow = out + (size_t)r * MP_L + 256 * wg + 2 * t;
#pragma unroll
      for (int j = 0; j < MP_NJ; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
            __floats2bfloat162_rn(o[4 * j + 2 * hh] * inv,
                                  o[4 * j + 2 * hh + 1] * inv);
    } else {
      // partial record of (split, row): 512 unnormalised sums, and
      // (max, sum) after all n_splits * R records
      float* orow = ws + ((size_t)split * R + r) * MP_L + 256 * wg + 2 * t;
#pragma unroll
      for (int j = 0; j < MP_NJ; ++j)
        *reinterpret_cast<float2*>(orow + 8 * j) =
            make_float2(o[4 * j + 2 * hh], o[4 * j + 2 * hh + 1]);
      if (wg == 0 && t == 0)
        *reinterpret_cast<float2*>(
            ws + (size_t)n_splits * R * MP_L + 2 * ((size_t)split * R + r)) =
            make_float2(m_run[hh], l_r[hh]);
    }
  }
}

// one block per row: merge the splits that reached it, normalise
__global__ void __launch_bounds__(128) mla_prefill_combine_kernel(
    const float* __restrict__ ws, bf16* __restrict__ out, int T, int H,
    int kv_len, int q_offset, int n_splits, int split_tiles) {
  const int r = blockIdx.x, R = T * H;
  const int last_row = min((r / MP_ROWS + 1) * MP_ROWS, R) - 1;
  const int kv_end = min(kv_len, q_offset + last_row / H + 1);
  const int t_all = (kv_end + MP_TILE - 1) / MP_TILE;
  const int n = min(n_splits, (t_all + split_tiles - 1) / split_tiles);
  const float2* ml = reinterpret_cast<const float2*>(
      ws + (size_t)n_splits * R * MP_L);
  float M = -INFINITY;
  for (int s = 0; s < n; ++s) M = fmaxf(M, ml[(size_t)s * R + r].x);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  float den = 0.f;
  const int c = 4 * threadIdx.x;
  for (int s = 0; s < n; ++s) {
    const float2 v = ml[(size_t)s * R + r];
    const float w = v.x == -INFINITY ? 0.f : exp2f(v.x - M);
    den += v.y * w;
    const float4 x = *reinterpret_cast<const float4*>(
        ws + ((size_t)s * R + r) * MP_L + c);
    acc.x += x.x * w;
    acc.y += x.y * w;
    acc.z += x.z * w;
    acc.w += x.w * w;
  }
  const float inv = den > 0.f ? 1.f / den : 1.f;
  __nv_bfloat162* o =
      reinterpret_cast<__nv_bfloat162*>(out + (size_t)r * MP_L + c);
  o[0] = __floats2bfloat162_rn(acc.x * inv, acc.y * inv);
  o[1] = __floats2bfloat162_rn(acc.z * inv, acc.w * inv);
}

}  // namespace
}  // namespace tllm

// q [T, H, 576] bf16, pool [NB, 1, BS, 576] bf16 (16-byte aligned), table
// [MB] int32, workspace n_splits * T * H * 514 floats when n_splits > 1,
// out [T, H, 512] bf16; kv_len counts the prefix plus the chunk (at most
// MB * BS); BS % 8 == 0; the splits (`mla_prefill_plan`) cut each block's
// latent range into runs of split_len tokens, a multiple of 64.  Built for
// (L, DK) = (512, 576).
extern "C" int tllm_mla_prefill(const void* q, const void* pool,
                                const void* table, void* workspace, void* out,
                                int T, int H, int L, int DK, int NB, int BS,
                                int MB, int kv_len, int q_offset, float scale,
                                int n_splits, int split_len, void* stream) {
  using namespace tllm;
  using namespace tllm::sm90;
  if (L != MP_L || DK != MP_DK || BS % 8 || n_splits < 1 ||
      split_len % MP_TILE || kv_len < 1 || kv_len > MB * BS)
    return (int)cudaErrorInvalidValue;
  const int R = T * H;
  CUtensorMap qmap, kvmap;
  int e = tensor_map_2d(&qmap, q, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, MP_DK, R,
                        (uint64_t)MP_DK * 2, 64, MP_ROWS,
                        CU_TENSOR_MAP_SWIZZLE_128B);
  if (e) return e;
  const int BR = paged_box_rows(BS);
  e = tensor_map_2d(&kvmap, pool, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, MP_DK,
                    (uint64_t)NB * BS, (uint64_t)MP_DK * 2, 64, BR,
                    CU_TENSOR_MAP_SWIZZLE_128B);
  if (e) return e;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t ce = cudaFuncSetAttribute(
        mla_prefill_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        MP_SMEM);
    if (ce != cudaSuccess) return (int)ce;
    attr_set = true;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_blocks = (R + MP_ROWS - 1) / MP_ROWS;
  const int split_tiles = split_len / MP_TILE;
  mla_prefill_sm90_kernel<<<n_blocks * n_splits, MP_THREADS, MP_SMEM, st>>>(
      qmap, kvmap, static_cast<const int*>(table), static_cast<bf16*>(out),
      static_cast<float*>(workspace), T, H, BS, BR, MB, kv_len, q_offset,
      scale, n_blocks, n_splits, split_tiles);
  if (n_splits > 1)
    mla_prefill_combine_kernel<<<R, MP_L / 4, 0, st>>>(
        static_cast<const float*>(workspace), static_cast<bf16*>(out), T, H,
        kv_len, q_offset, n_splits, split_tiles);
  return (int)cudaGetLastError();
}
