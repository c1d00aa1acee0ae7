// K10 mla_prefill and K9 mla_decode: absorbed Multi-head Latent Attention
// over a paged latent pool [NB, 1, BS, 576] (one "head" shared by every
// query head): keys are all 576 channels of a latent row (the RMS-normed
// c_kv of L = 512, then the roped k_pe), values its first 512.  Queries
// have H heads of 576 channels (q_nope absorbed through W_uk, then the
// roped q_pe).  Out: [rows, H, 512] bf16.
//
// * K10 (prefill): T query tokens of one sequence at positions
//   q_offset.., attending causally (kv_pos <= q_pos, kv_pos < kv_len).
//   Replaces the TPU kernel tensorrt_llm_tpu/ops/mla_pallas.py
//   `_mla_prefill_kernel`.
// * K9 (decode): one query token per sequence, attending every latent
//   before kv_lens[b] (on the device, clamped to the table's MB * BS).
//   Replaces `_mla_decode_kernel` of the same file.
// Both scale the f32 scores after the dot and round P to bf16 for P V.
// (The Pallas decode kernel rounds q * scale to bf16 first; the plain
// version scales in f32, and that rounding is not copied.)
//
// What bounds them on the H100.  Per (query row, visible latent) they do
// 2 * (576 + 512) operations over 1,152 latent bytes per cached token.
// K10 is bound by tensor-core operations: at DeepSeek-V3's 128 heads, T
// 256 at q_offset 256, 27.4 GFLOP, a 27.7 us bound.  K9 reads each latent
// row for only H rows: at Moonlight's 16 heads ~30 operations a byte, at
// V3's 128 ~242, both under the bf16 ridge of ~295, so the latent bytes
// bound it (a 64-row block padded from 16 heads does ~121 a byte).
//
// Design (sm_90a: TMA, mbarriers, wgmma, warp specialisation, clusters):
//
// * A block owns 64 query rows (wgmma's M).  K10 stacks rows as in the TPU
//   kernel, row = token * H + head: at H 128 a block is half of one
//   token's heads, at H 16 four tokens; latent tiles past the causal edge
//   of the block's last row are never loaded (the TPU kernel's `q_end`
//   skip).  K9's block is heads h0 .. h0 + 63 of one sequence, so at
//   H 128 a latent row is read twice (two head blocks) and at H 16 the
//   rows past the 16 heads are zeros.
// * The Q block [64, 576] bf16 is loaded once by TMA (nine boxes of 64
//   channels, 128-byte swizzle): K10 from a map over [T * H, 576] (rows
//   past T * H read as TMA's zeros), K9 from a map over [B, H, 576] (rows
//   past H read as zeros).  It is the shared-memory A operand of S = Q K^T.
//   A 64-token latent tile is nine boxes of [64 tokens, 64 channels]
//   filled by TMA per page run (a tensor map over the pool viewed as
//   [NB * BS, 576], boxes of gcd(BS, 64) rows); the same staged tile is
//   the K-major B operand of S and, its first eight boxes, the MN-major B
//   operand of P V (wgmma's transpose bit): no second copy.  Tokens of
//   the last tile that lie in no page of the sequence read as zeros (a
//   stale bf16 NaN times P = 0 would poison the sum): their boxes are read
//   out of the map's bounds, which TMA fills with zeros.
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
// * Splits.  K10: blocks x splits cover the 132 SMs where the latent range
//   has the tiles (`mla_prefill_plan` in ops/mla.py); with several splits
//   each (block, split) writes its unnormalised partial (max, sum, 512 f32
//   sums) and a second pass merges them and normalises; splits past a
//   block's causal edge do nothing.  K9: one launch.  The splits of one
//   (sequence, head block) are one thread block cluster (at most 16 blocks,
//   `mla_decode_plan`); the splits past kv_lens[b] exit at once, freeing
//   their SMs; the live ones each leave their partial [rows, 512] and
//   (max, sum) in their own shared memory, over Q and the ring, and each
//   merges a share of the outputs in split order over distributed shared
//   memory and normalises: no workspace, no counter, no second pass, and a
//   second call gives the same bits.  With one live split the block
//   normalises and stores.
#include <math.h>

#include "sm90.cuh"

namespace tllm {
namespace {

using namespace sm90;

constexpr int MP_L = 512;                    // value channels
constexpr int MP_NJ = MP_L / 2 / 8;          // 8-column groups a warpgroup
constexpr int MP_DK = 576;                   // key channels (L + R)
constexpr int MP_ROWS = 64;                  // query rows a block
constexpr int MP_TILE = PAGED_TILE;          // latent tokens a tile
constexpr int MP_BOXES = MP_DK / 64;         // boxes of 64 channels (128 B)
constexpr int MP_BOX = PAGED_BOX;            // one box of 64 rows: 8 KB
constexpr int MP_TILE_BYTES = MP_BOXES * MP_BOX;   // 72 KB
constexpr int MP_STAGES = 2;
constexpr int MP_THREADS = 3 * 128;          // two consumer warpgroups + producer
constexpr int MP_CT = 2 * 128;               // consumer threads
// shared memory, from a 1 KB aligned base
constexpr int MP_Q = 0;
constexpr int MP_RING = MP_Q + MP_TILE_BYTES;
constexpr int MP_P = MP_RING + MP_STAGES * MP_TILE_BYTES;  // [64 x 64] bf16
constexpr int MP_STATS = MP_P + MP_ROWS * 128;  // alpha, max, sum: [2][64] f32
constexpr int MP_BARS = MP_STATS + 3 * 2 * MP_ROWS * 4;
constexpr int MP_SMEM = MP_BARS + (2 * MP_STAGES + 1) * 8 + 1024;
static_assert(MP_SMEM <= 232448, "K9/K10's shared memory exceeds a block's");
// K9's split merge: a live split's unnormalised partial [64 rows][512] f32
// (rows MD_LD floats apart: the 8 row groups of a warp's stores fall in
// distinct banks), then its (max, sum) a row, over Q and the ring once
// every product retired
constexpr int MD_LD = MP_L + 4;
constexpr int MD_PART = 0;
constexpr int MD_ML = MD_PART + MP_ROWS * MD_LD * 4;
static_assert(MD_ML + MP_ROWS * 8 <= MP_P, "K9's partials fit over the ring");
constexpr int MD_MAX_SPLITS = 16;   // blocks of a (non-portable) cluster
// named barriers (0 is __syncthreads): 1 + w "P ready for warpgroup w",
// 3 + w warpgroup w's own, 5 both warpgroups
constexpr int BAR_P = 1, BAR_WG = 3, BAR_ALL = 5;

struct MpParams {
  const int* table;     // K10: the sequence's [MB]; K9: [B, MB]
  const int* kv_lens;   // K9: [B], on the device
  bf16* out;
  float* ws;            // K10's partials when n_splits > 1
  int T, H, BS, BR, MB, kv_len, q_offset;
  float scale;
  int n_blocks, n_splits, split_tiles;
};

template <bool DEC>
__global__ void __launch_bounds__(MP_THREADS, 1) mla_sm90_kernel(
    const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap kvmap, const MpParams p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + MP_BARS);
  uint64_t* empty = full + MP_STAGES;
  uint64_t* qbar = empty + MP_STAGES;

  // The block's rows, its latent tiles [t_begin, t_end) and the output.
  // K10: row block b of the stacked rows (row = token * H + head), the
  // latest first (they see the most latents), up to the causal edge of its
  // last row.  K9: heads h0 .. h0 + 63 of sequence `seq` (rows counted
  // within the sequence), every latent before kv_lens[seq].
  const int H = p.H;
  int split, row0, R, kv_len, t_begin, t_end, n_live = 1, seq = 0;
  const int* table = p.table;
  if constexpr (DEC) {
    split = blockIdx.x;
    row0 = blockIdx.y * MP_ROWS;
    seq = blockIdx.z;
    R = H;
    // tokens past the table's MB pages do not exist (the plain version's
    // gather ends there too); never read the table out of bounds
    kv_len = min(p.kv_lens[seq], p.MB * p.BS);
    table += (size_t)seq * p.MB;
    const int t_all = kv_len > 0 ? (kv_len + MP_TILE - 1) / MP_TILE : 0;
    n_live = (t_all + p.split_tiles - 1) / p.split_tiles;
    t_begin = split * p.split_tiles;
    t_end = min(t_all, t_begin + p.split_tiles);
  } else {
    const int b = p.n_blocks - 1 - (int)blockIdx.x / p.n_splits;
    split = blockIdx.x % p.n_splits;
    R = p.T * H;
    row0 = b * MP_ROWS;
    kv_len = p.kv_len;
    const int last_row = min(row0 + MP_ROWS, R) - 1;
    const int kv_end = min(kv_len, p.q_offset + last_row / H + 1);
    t_begin = split * p.split_tiles;
    t_end = min((kv_end + MP_TILE - 1) / MP_TILE, t_begin + p.split_tiles);
  }
  bf16* out = p.out + (DEC ? (size_t)seq * H * MP_L : 0);
  if (t_begin >= t_end) {
    // K9 with no cached token (decode always counts the new one): zeros,
    // where the plain version averages V
    if (DEC && n_live == 0 && split == 0)
      for (int i = threadIdx.x; i < min(MP_ROWS, R - row0) * MP_L;
           i += MP_THREADS)
        out[(size_t)row0 * MP_L + i] = __float2bfloat16(0.f);
    // K10: past the block's causal edge.  K9: a split past kv_len, whose
    // shared memory no block reads; the cluster barriers wait only for
    // threads that have not exited, so its SM is free at once
    return;
  }
  // K9 merges its live splits over the cluster's shared memory
  const bool merge = DEC && n_live > 1;
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
    if (warp == 8) {
      if (lane == 0) {
        mbar_expect_tx(qbar, MP_TILE_BYTES);
        for (int c = 0; c < MP_BOXES; ++c) {
          if constexpr (DEC)
            tma_load_3d(base + MP_Q + c * MP_BOX, &qmap, c * 64, row0, seq,
                        qbar);
          else
            tma_load_2d(base + MP_Q + c * MP_BOX, &qmap, c * 64, row0, qbar);
        }
      }
      const int tok_end = min(((kv_len - 1) / p.BS + 1) * p.BS, p.MB * p.BS);
      for (int tile = t_begin; tile < t_end; ++tile) {
        const int k = tile - t_begin, slot = k % MP_STAGES;
        tma_paged_tile(base + MP_RING + slot * MP_TILE_BYTES, &kvmap, &kvmap,
                       1, MP_BOXES, table, 1, 0, p.BS, p.BR, tile * MP_TILE,
                       tok_end, &full[slot], &empty[slot],
                       ((k / MP_STAGES) & 1) ^ 1, lane);
      }
    }
    if (!merge) return;
  } else {
    // ----------------------------------------------------- consumers ---
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
    // key limit of each: K10 its causal edge and kv_len, K9 kv_len (0 past
    // the last row)
    int rl[2], lim[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      rl[hh] = wl * 16 + g + hh * 8;
      const int r = row0 + rl[hh];
      lim[hh] = r >= R ? 0 : DEC ? kv_len : min(kv_len, p.q_offset + r / H + 1);
    }
    // the V columns of this warpgroup: boxes 4 wg .. 4 wg + 3 of a stage
    auto v_desc = [&](int slot, int kk) {
      return desc_mn128(ring_s + slot * MP_TILE_BYTES + 4 * wg * MP_BOX +
                            kk * 16 * 128,
                        MP_BOX);
    };

    constexpr float LOG2E = 1.4426950408889634f;
    const float sl2 = p.scale * LOG2E;
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
        WgmmaSS<256>::mma<1>(o, desc_b128(p_s + kk * 32), v_desc(slot, kk),
                             1);
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
            *reinterpret_cast<uint32_t*>(pb + (r >> 3) * 1024 +
                                         (r & 7) * 128 +
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

    // both warpgroups hold every row's final max; the row sum is the sum
    // of their two partial sums.  Past this barrier no product reads Q or
    // the ring any more.
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
    const bool whole = DEC ? n_live == 1 : p.n_splits == 1;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = row0 + rl[hh];
      if (r >= R) continue;
      if (whole) {
        const float inv = l_r[hh] > 0.f ? 1.f / l_r[hh] : 1.f;
        bf16* orow = out + (size_t)r * MP_L + 256 * wg + 2 * t;
#pragma unroll
        for (int j = 0; j < MP_NJ; ++j)
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
              __floats2bfloat162_rn(o[4 * j + 2 * hh] * inv,
                                    o[4 * j + 2 * hh + 1] * inv);
      } else if (DEC) {
        // K9: this split's partial of the row, and (max, sum), in shared
        // memory for the cluster's merge
        float* prow = reinterpret_cast<float*>(base + MD_PART) +
                      rl[hh] * MD_LD + 256 * wg + 2 * t;
#pragma unroll
        for (int j = 0; j < MP_NJ; ++j)
          *reinterpret_cast<float2*>(prow + 8 * j) =
              make_float2(o[4 * j + 2 * hh], o[4 * j + 2 * hh + 1]);
        if (wg == 0 && t == 0)
          *reinterpret_cast<float2*>(base + MD_ML + rl[hh] * 8) =
              make_float2(m_run[hh], l_r[hh]);
      } else {
        // K10: partial record of (split, row): 512 unnormalised sums, and
        // (max, sum) after all n_splits * R records
        float* orow =
            p.ws + ((size_t)split * R + r) * MP_L + 256 * wg + 2 * t;
#pragma unroll
        for (int j = 0; j < MP_NJ; ++j)
          *reinterpret_cast<float2*>(orow + 8 * j) =
              make_float2(o[4 * j + 2 * hh], o[4 * j + 2 * hh + 1]);
        if (wg == 0 && t == 0)
          *reinterpret_cast<float2*>(
              p.ws + (size_t)p.n_splits * R * MP_L +
              2 * ((size_t)split * R + r)) = make_float2(m_run[hh], l_r[hh]);
      }
    }
    if (!merge) return;
  }

  if constexpr (DEC) {
    // ------------------------------------ K9: the cluster's split merge ---
    // (merge: every thread of every live split is here.)  The block of
    // cluster rank `split` takes the 4-column units split, split + n_live,
    // ... (in units of the consumer threads) of the rows, weighs each live
    // split's partial by 2^(max - M) in split order, and normalises
    cluster_sync();
    if (warp < 8) {
      const int rows = min(MP_ROWS, R - row0);
      const uint32_t part_s = smem_u32(base + MD_PART);
      const uint32_t ml_s = smem_u32(base + MD_ML);
      for (int u = split * MP_CT + threadIdx.x; u < rows * (MP_L / 4);
           u += n_live * MP_CT) {
        const int rl = u / (MP_L / 4), c = (u % (MP_L / 4)) * 4;
        float M = -INFINITY;
#pragma unroll 4
        for (int s = 0; s < n_live; ++s)
          M = fmaxf(M, ld_dsmem_f32(ml_s + rl * 8, s));
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        float den = 0.f;
#pragma unroll 4
        for (int s = 0; s < n_live; ++s) {
          const float2 ml = ld_dsmem_f32x2(ml_s + rl * 8, s);
          const float4 x = ld_dsmem_f32x4(part_s + (rl * MD_LD + c) * 4, s);
          const float w = ml.x == -INFINITY ? 0.f : exp2f(ml.x - M);
          den += ml.y * w;
          acc.x += x.x * w;
          acc.y += x.y * w;
          acc.z += x.z * w;
          acc.w += x.w * w;
        }
        const float inv = den > 0.f ? 1.f / den : 1.f;
        __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(
            out + (size_t)(row0 + rl) * MP_L + c);
        o2[0] = __floats2bfloat162_rn(acc.x * inv, acc.y * inv);
        o2[1] = __floats2bfloat162_rn(acc.z * inv, acc.w * inv);
      }
    }
    // every partial stays in shared memory until the whole cluster read it
    cluster_sync();
  }
}

// K10, one block per row: merge the splits that reached it, normalise
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

// the pool as [NB * BS, 576] rows, boxes of gcd(BS, 64) rows x 64 channels
int latent_map(CUtensorMap* kvmap, const void* pool, int NB, int BS) {
  return tensor_map_2d(kvmap, pool, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, MP_DK,
                       (uint64_t)NB * BS, (uint64_t)MP_DK * 2, 64,
                       paged_box_rows(BS), CU_TENSOR_MAP_SWIZZLE_128B);
}

template <bool DEC>
int set_smem_attrs() {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t ce = cudaFuncSetAttribute(
        mla_sm90_kernel<DEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        MP_SMEM);
    if (ce == cudaSuccess && DEC)   // clusters of up to 16 splits
      ce = cudaFuncSetAttribute(
          mla_sm90_kernel<DEC>,
          cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (ce != cudaSuccess) return (int)ce;
    attr_set = true;
  }
  return 0;
}

}  // namespace
}  // namespace tllm

// K10.  q [T, H, 576] bf16, pool [NB, 1, BS, 576] bf16 (16-byte aligned),
// table [MB] int32, workspace n_splits * T * H * 514 floats when
// n_splits > 1, out [T, H, 512] bf16; kv_len counts the prefix plus the
// chunk (at most MB * BS); BS % 8 == 0; the splits (`mla_prefill_plan`)
// cut each block's latent range into runs of split_len tokens, a multiple
// of 64.  Built for (L, DK) = (512, 576).
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
  if ((e = latent_map(&kvmap, pool, NB, BS))) return e;
  if ((e = set_smem_attrs<false>())) return e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  MpParams p = {};
  p.table = static_cast<const int*>(table);
  p.out = static_cast<bf16*>(out);
  p.ws = static_cast<float*>(workspace);
  p.T = T;
  p.H = H;
  p.BS = BS;
  p.BR = paged_box_rows(BS);
  p.MB = MB;
  p.kv_len = kv_len;
  p.q_offset = q_offset;
  p.scale = scale;
  p.n_blocks = (R + MP_ROWS - 1) / MP_ROWS;
  p.n_splits = n_splits;
  p.split_tiles = split_len / MP_TILE;
  mla_sm90_kernel<false><<<p.n_blocks * n_splits, MP_THREADS, MP_SMEM, st>>>(
      qmap, kvmap, p);
  if (n_splits > 1)
    mla_prefill_combine_kernel<<<R, MP_L / 4, 0, st>>>(
        static_cast<const float*>(workspace), static_cast<bf16*>(out), T, H,
        kv_len, q_offset, n_splits, p.split_tiles);
  return (int)cudaGetLastError();
}

// K9.  q [B, H, 576] bf16, pool [NB, 1, BS, 576] bf16 (both 16-byte
// aligned), tables [B, MB] int32, kv_lens [B] int32 (including the new
// token), out [B, H, 512] bf16; BS % 8 == 0; `mla_decode_plan`'s splits:
// 1 <= n_splits <= 16 runs of split_len tokens (a multiple of 64) that
// cover the table's MB * BS tokens, each starting inside it.  One launch:
// grid (n_splits, head blocks, B), the splits of a (sequence, head block)
// one cluster.  Built for (L, DK) = (512, 576).
extern "C" int tllm_mla_decode(const void* q, const void* pool,
                               const void* tables, const void* kv_lens,
                               void* out, int B, int H, int L, int DK, int NB,
                               int BS, int MB, float scale, int n_splits,
                               int split_len, void* stream) {
  using namespace tllm;
  using namespace tllm::sm90;
  if (L != MP_L || DK != MP_DK || BS % 8 || n_splits < 1 ||
      n_splits > MD_MAX_SPLITS || split_len < MP_TILE ||
      split_len % MP_TILE || (long long)n_splits * split_len < MB * BS ||
      (long long)(n_splits - 1) * split_len >= (long long)MB * BS)
    return (int)cudaErrorInvalidValue;
  // Q as [B, H, 576]: a box of 64 heads reads the heads past H as zeros
  CUtensorMap qmap, kvmap;
  const uint64_t qdims[3] = {(uint64_t)MP_DK, (uint64_t)H, (uint64_t)B};
  const uint64_t qstrides[2] = {(uint64_t)MP_DK * 2, (uint64_t)H * MP_DK * 2};
  const uint32_t qbox[3] = {64, MP_ROWS, 1};
  int e = tensor_map(&qmap, q, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, qdims,
                     qstrides, qbox, CU_TENSOR_MAP_SWIZZLE_128B);
  if (e) return e;
  if ((e = latent_map(&kvmap, pool, NB, BS))) return e;
  if ((e = set_smem_attrs<true>())) return e;
  MpParams p = {};
  p.table = static_cast<const int*>(tables);
  p.kv_lens = static_cast<const int*>(kv_lens);
  p.out = static_cast<bf16*>(out);
  p.H = H;
  p.BS = BS;
  p.BR = paged_box_rows(BS);
  p.MB = MB;
  p.scale = scale;
  p.n_splits = n_splits;
  p.split_tiles = split_len / MP_TILE;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_splits, (H + MP_ROWS - 1) / MP_ROWS, B);
  cfg.blockDim = dim3(MP_THREADS);
  cfg.dynamicSmemBytes = MP_SMEM;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = n_splits > 1 ? 1 : 0;
  const cudaError_t ce =
      cudaLaunchKernelEx(&cfg, mla_sm90_kernel<true>, qmap, kvmap, p);
  if (ce != cudaSuccess) return (int)ce;
  return (int)cudaGetLastError();
}
