// K3 flash_prefill, its e4m3 instance flash_prefill_fp8, and K7
// flash_prefill_int8: one sequence's chunk of T query tokens, at positions
// q_offset.., attends its paged KV (prefix + chunk, already written)
// through the sequence's block table: bf16 pools [NB, Hkv, BS, D] (K3),
// e4m3 (float8_e4m3fn) pools of that shape with no scales (K3 over FP8
// pages: the TPU kernels take them as they are, the page upcast to bf16
// exactly before the products), or int8 pools with f32 per-(token, head)
// scale pools [NB, Hkv, BS] (K7).
//
// Replaces the TPU kernels tensorrt_llm_tpu/ops/flash_prefill.py
// `_flash_prefill_kernel` (D % 128 == 0) and `_flash_prefill_kernel_packed`
// (D < 128 over the TPU's lane-packed page view), here one kernel over the
// logical head-major pools, and `_flash_prefill_kernel_int8`: for int8
// pages the K scale multiplies the logits, the V scale the probabilities
// before they are rounded to bf16 for P V (the row sums stay unscaled);
// causal mask, sliding window, logit cap (tanh) and sinks (a per-head
// logit that joins the softmax denominator once), at D 64, 128 and 256,
// with GQA (any group).
//
// What bounds it on the H100: tensor-core operations once the chunk reaches
// a few hundred tokens (~4*T*S*Hq*D against S*Hkv*(2D + 8) bytes of KV),
// the KV bytes for short chunks and windows.  At Llama-3-8B's widths (32/8
// heads, D 128), T 256 at q_offset 256: 1.6 GFLOP, a 1.6 us bound.
//
// Design (sm_90a: TMA and bulk copies, mbarriers, wgmma, warp
// specialisation).  The page type is a template parameter: bf16 (K3),
// e4m3 (K3's FP8 instance) or int8_t (K7).  The two 1-byte page types take
// one path (bulk copies, a conversion to bf16 tiles); only int8 pages carry
// scales.
//
// * Rows are stacked as in the TPU kernel: row = token * G + head of the
//   G = Hq/Hkv query heads of one KV head, so every page read serves all G
//   heads.  A block is 64 rows of one KV head: grid (ceil(T*G / 64),
//   Hkv), one block an SM (~131 KB of shared memory at D 128).  Llama-3-8B
//   at T 256: 16 x 8 = 128 blocks; at T 17: 2 x 8 = 16 blocks, each
//   walking the whole prefix.  Within a block two consumer warpgroups
//   take alternate KV tiles, each with its own online softmax, and merge
//   at the end: a single warpgroup an SM left every dependent instruction
//   of the conversion and the softmax at its full latency (one warp a
//   scheduler) on the H100.
// * Producer warp, 1-byte pages: each lane reads the block-table entry of
//   one page run of the tile and copies it by cp.async.bulk -- BS x D
//   contiguous bytes of the block's KV head in the head-major pool (2 KB
//   at BS 16, D 128), and for int8 its BS f32 scales -- into a ring of
//   64-token stages with complete_tx mbarriers (the expected bytes count
//   the scales only where there are any).  The copies of the next stages
//   are in flight while the consumers compute.  Scales past kv_len read as
//   zero (the stage holds the rest of the last page), so that stale int8
//   bytes add nothing; e4m3 tokens past kv_len are converted to zeros (a
//   stale byte may be a NaN code, and NaN times P = 0 is NaN).
// * Producer warp, bf16 pages: TMA tensor maps over the pools viewed as
//   [NB * Hkv * BS, D] load each run of gcd(BS, 64) tokens of one KV head's
//   page as boxes of 64 channels in the 128-byte swizzle that wgmma reads
//   (pages of a multiple of 8 tokens: a box must fill whole 8-row swizzle
//   atoms).  No conversion, so no per-warpgroup tiles: the ring takes that
//   room (six stages at D 128, eight at D 64, against four for int8).
//   Tokens of the last tile in no page of the sequence read as zeros (a
//   stale bf16 NaN times P = 0 would poison the sum): their boxes are read
//   out of the maps' bounds, which TMA fills with zeros.
// * Consumer warpgroup, per 64-token tile: for 1-byte pages, converts the
//   K and V tiles to bf16 in shared memory (exact for |q| <= 127 and for
//   every e4m3 value: cvt to fp16x2, then f32, then bf16), in the
//   64-byte swizzle that wgmma reads without bank conflicts, and frees the
//   stage (bf16 pages are read in the stage itself, freed after P V); runs
//   S = Q K^T on wgmma (Q as the register A operand, loaded once; the K
//   tile K-major as B); applies the softmax scale, the K scale, the cap and
//   the masks and keeps an online softmax in f32 (base-2 exponentials);
//   multiplies P by the V scale, rounds it to bf16 and runs O += P V with
//   P as the register A operand and the V tile as B, read through wgmma's
//   transpose bit (MN-major: no element-wise transpose).
// * KV tiles wholly past the causal edge of the block's last row, or
//   wholly before the sliding window of its first row, are skipped.
// * D 256: Q as registers (64 a thread) and all of O (128) would pass the
//   232 registers a consumer gets, so the two warpgroups split O's columns
//   instead of the tiles: both take every tile, each computes the whole S
//   (the same softmax in both) and its 128 columns of P V, and no merge is
//   left at the end.  1-byte pages are converted once, by both warpgroups,
//   into one pair of bf16 tiles; a stage is freed by the eight warps.
#include <math.h>

#include <type_traits>

#include "sm90.cuh"

namespace tllm {
namespace {

using namespace sm90;

constexpr int FP_ROWS = 64;    // stacked query rows per block
constexpr int FP_TK = PAGED_TILE;   // KV tokens per tile
constexpr int FP_WG = 2;       // consumer warpgroups, on alternate tiles
// + a producer warpgroup, one warp of which works: a whole warpgroup can
// hand its registers to the consumers (setmaxnreg 40 / 232), which hold
// Q, O, S and P (~185 a thread) where ptxas would cap them at 168
constexpr int FP_THREADS = FP_WG * 128 + 128;

template <int D, typename KV>
struct FpCfg {
  // 1-byte pages (int8, e4m3): bulk copies, converted to bf16 tiles
  static constexpr bool B1 = sizeof(KV) == 1;
  // int8 pages carry f32 scales; e4m3 pages none
  static constexpr bool SC = std::is_same<KV, int8_t>::value;
  // D 256: the warpgroups split O's columns (OD each) and share every tile
  static constexpr bool COLS = D == 256;
  static constexpr int OD = COLS ? D / FP_WG : D;
  // ring stages (with COLS both warpgroups read each stage in order, so
  // any count keeps a waiter within one phase of its barrier)
  static constexpr int STAGES = B1 ? 4 : (D == 64 ? 8 : D == 128 ? 6 : 3);
  // warps that free a stage
  static constexpr int FREERS = COLS ? FP_WG * 4 : 4;
  static constexpr int BOX = FP_TK * 64;            // 32 bf16 of 64 tokens
  static constexpr int TILE16 = D / 32 * BOX;       // a bf16 tile
  static constexpr int KV_BYTES = FP_TK * D * (int)sizeof(KV);
  // K and V, and for int8 their scales
  static constexpr int STAGE = 2 * KV_BYTES + (SC ? 2 * FP_TK * 4 : 0);
  // 1-byte pages: a warpgroup's bf16 K and V tiles and the room of their
  // scales (which the merge also uses)
  static constexpr int WG_BYTES = B1 ? 2 * TILE16 + 2 * FP_TK * 4 : 0;
  // those of each warpgroup, the ring, its barriers, and slack to align
  // the base to 1 KB
  static constexpr int TILE_SETS = COLS ? 1 : FP_WG;
  static constexpr int SMEM =
      TILE_SETS * WG_BYTES + STAGES * STAGE + 2 * STAGES * 8 + 1024;
  static_assert(SMEM <= 232448, "flash prefill's shared memory");
};

// Two int8 values of w (bytes k and k + 1) as bf16x2, exactly: each byte,
// biased by 128, becomes the low mantissa byte of 2^23 (0x4B000000), and
// subtracting 2^23 + 128 leaves the signed value; no conversion unit, and
// the bytes stay in a register (a byte-wise view of the word would make
// the compiler load each byte from shared memory on its own)
__device__ __forceinline__ uint32_t int8x2_to_bf16x2(uint32_t u, int k) {
  const float lo =
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + k)) - 8388736.f;
  const float hi =
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541 + k)) - 8388736.f;
  return pack_bf16x2(lo, hi);
}

// 16 int8 values to 16 bf16 (exact)
__device__ __forceinline__ void int8x16_to_bf16(uint4 v, uint4& lo,
                                                uint4& hi) {
  const uint32_t u0 = v.x ^ 0x80808080u, u1 = v.y ^ 0x80808080u;
  const uint32_t u2 = v.z ^ 0x80808080u, u3 = v.w ^ 0x80808080u;
  lo = make_uint4(int8x2_to_bf16x2(u0, 0), int8x2_to_bf16x2(u0, 2),
                  int8x2_to_bf16x2(u1, 0), int8x2_to_bf16x2(u1, 2));
  hi = make_uint4(int8x2_to_bf16x2(u2, 0), int8x2_to_bf16x2(u2, 2),
                  int8x2_to_bf16x2(u3, 0), int8x2_to_bf16x2(u3, 2));
}

// 16 e4m3 values to 16 bf16 (exact)
__device__ __forceinline__ void e4m3x16_to_bf16(uint4 v, uint4& lo,
                                                uint4& hi) {
  lo = make_uint4(e4m3x2_to_bf16x2(v.x, 0), e4m3x2_to_bf16x2(v.x, 2),
                  e4m3x2_to_bf16x2(v.y, 0), e4m3x2_to_bf16x2(v.y, 2));
  hi = make_uint4(e4m3x2_to_bf16x2(v.z, 0), e4m3x2_to_bf16x2(v.z, 2),
                  e4m3x2_to_bf16x2(v.w, 0), e4m3x2_to_bf16x2(v.w, 2));
}

// kmap / vmap: the bf16 pools' tensor maps (boxes of BR rows); unused for
// 1-byte pages, which take kc / vc (and for int8 their scales)
template <int D, typename KV>
__global__ void __launch_bounds__(FP_THREADS, 1) flash_prefill_sm90_kernel(
    const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const bf16* __restrict__ q,
    const KV* __restrict__ kc, const KV* __restrict__ vc,
    const float* __restrict__ k_sc, const float* __restrict__ v_sc,
    const int* __restrict__ block_table, const float* __restrict__ sinks,
    bf16* __restrict__ out, int T, int Hq, int Hkv, int BS, int BR, int MB,
    int kv_len, int q_offset, float scale, int window, float cap) {
  using C = FpCfg<D, KV>;
  constexpr int FP_STAGES = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  // offsets of the shared array itself, so that the compiler keeps its
  // address space (shared, not generic, loads and stores)
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring = base + C::TILE_SETS * C::WG_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + FP_STAGES * C::STAGE);
  uint64_t* empty = full + FP_STAGES;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int G = Hq / Hkv;
  const int h = blockIdx.y;
  const int R = T * G;
  const int row0 = blockIdx.x * FP_ROWS;
  // the tiles this block needs: up to the causal edge of its last row,
  // from the window of its first
  const int last_row = min(row0 + FP_ROWS, R) - 1;
  const int kv_end = min(kv_len, q_offset + last_row / G + 1);
  const int kv_begin =
      window > 0 ? max(0, q_offset + row0 / G - window + 1) : 0;
  const int t_begin = kv_begin / FP_TK;
  const int t_end = kv_end > 0 ? (kv_end + FP_TK - 1) / FP_TK : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < FP_STAGES; ++s) {
      mbar_init(&full[s], 32);    // the producer's lanes
      mbar_init(&empty[s], C::FREERS);   // the warps that used it
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= FP_WG * 4) {
    // ------------------------------------------------------ producer ---
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp != FP_WG * 4) return;
    if constexpr (!C::B1) {
      const int tok_end = min(((kv_len - 1) / BS + 1) * BS, MB * BS);
      for (int tile = t_begin; tile < t_end; ++tile) {
        const int i = tile - t_begin, slot = i % FP_STAGES;
        tma_paged_tile(ring + slot * C::STAGE, &kmap, &vmap, 2, D / 64,
                       block_table, Hkv, h, BS, BR, tile * FP_TK, tok_end,
                       &full[slot], &empty[slot],
                       ((i / FP_STAGES) & 1) ^ 1, lane);
      }
      return;
    }
    // A tile is runs of tokens that lie in one page each, up to the page
    // of the last token below kv_len (whole pages: their bytes exist).
    // Lane r copies run r: K and V and, for int8 when BS % 4 == 0, their
    // scales; the lanes read their table entries in parallel, before
    // waiting for the slot, so a tile costs one global load's latency at
    // most.
    const bool bulk_sc = C::SC && BS % 4 == 0;
    const int tok_end = min(((kv_len - 1) / BS + 1) * BS, MB * BS);
    int slot = 0;
    uint32_t phase = 0;
    for (int tile = t_begin; tile < t_end; ++tile) {
      const int s0 = tile * FP_TK;
      const int end = min(s0 + FP_TK, tok_end);
      const int p0 = s0 / BS;
      const int n_runs = end > s0 ? (end - 1) / BS - p0 + 1 : 0;
      int ra[2], rb[2], page[2];
      uint32_t bytes = 0;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int r = lane + 32 * k;
        ra[k] = rb[k] = page[k] = 0;
        if (r < n_runs) {
          ra[k] = max(s0, (p0 + r) * BS);
          rb[k] = min(end, (p0 + r + 1) * BS);
          page[k] = block_table[p0 + r];
          bytes += (rb[k] - ra[k]) *
                   (2 * D * (int)sizeof(KV) + (bulk_sc ? 8 : 0));
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        bytes += __shfl_xor_sync(0xffffffffu, bytes, o);
      mbar_wait(&empty[slot], phase ^ 1);
      uint8_t* stage = ring + slot * C::STAGE;
      float* sk = reinterpret_cast<float*>(stage + 2 * C::KV_BYTES);
      if (lane == 0) mbar_expect_tx(&full[slot], bytes);
      __syncwarp();
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        if (lane + 32 * k >= n_runs) continue;
        const int run = rb[k] - ra[k];
        const size_t row = (size_t)(page[k] * Hkv + h) * BS + ra[k] % BS;
        const int dst = (ra[k] - s0) * D * (int)sizeof(KV);
        bulk_load(stage + dst, kc + row * D, run * D * sizeof(KV), &full[slot]);
        bulk_load(stage + C::KV_BYTES + dst, vc + row * D,
                  run * D * sizeof(KV), &full[slot]);
        if (bulk_sc) {
          bulk_load(sk + (ra[k] - s0), k_sc + row, run * 4, &full[slot]);
          bulk_load(sk + FP_TK + (ra[k] - s0), v_sc + row, run * 4,
                    &full[slot]);
        }
      }
      if (C::SC && !bulk_sc) {
        // scales one token a lane (rows of BS * 4 bytes need not be
        // 16-byte aligned)
        for (int j = lane; j < FP_TK; j += 32) {
          const int pos = s0 + j;
          float a = 0.f, b = 0.f;
          if (pos < end) {
            const size_t row =
                (size_t)(block_table[pos / BS] * Hkv + h) * BS + pos % BS;
            a = k_sc[row];
            b = v_sc[row];
          }
          sk[j] = a;
          sk[FP_TK + j] = b;
        }
      }
      if (lane != 0) mbar_arrive(&full[slot]);
      if (++slot == FP_STAGES) {
        slot = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // ------------------------------------------------------- consumers ---
  // Both warpgroups hold the block's 64 rows; warpgroup w takes the tiles
  // t_begin + w, + w + 2, ..., so that two warps share each scheduler and
  // hide each other's latency, and merges at the end (below).
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = warp >> 2, wl = warp & 3;
  const int tid = threadIdx.x & 127;
  const int g = lane >> 2, t = lane & 3;
  constexpr bool COLS = C::COLS;
  constexpr int OD = C::OD;   // O's columns this warpgroup owns
  // the 1-byte path's conversion: this warpgroup's own tiles, or with COLS
  // one pair for both (barrier 1 among the 256 consumer threads)
  const int cv_bar = COLS ? 1 : 1 + wg, cv_n = COLS ? FP_WG * 128 : 128;
  const int cv_tid = COLS ? (int)threadIdx.x : tid;
  uint8_t* kb = base + (COLS ? 0 : wg) * C::WG_BYTES;   // bf16 K tile
  uint8_t* vb = kb + C::TILE16;            // bf16 V tile, likewise
  float* ksc = reinterpret_cast<float*>(vb + C::TILE16);
  float* vsc = ksc + FP_TK;
  // this thread's two rows (wgmma rows 16 * wl + g and + 8)
  int rows[2], qpos[2], qoff[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row0 + wl * 16 + g + hh * 8;
    rows[hh] = r;
    const int tok = r / G, hq = h * G + r % G;
    qpos[hh] = q_offset + tok;
    qoff[hh] = (tok * Hq + hq) * D;
  }
  // Q as the A operand of every S wgmma, for the whole head dim
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int hh = j & 1;
      const int d = kk * 16 + 2 * t + (j >> 1) * 8;
      qa[kk][j] = rows[hh] < R ? ld_u32(q + qoff[hh] + d) : 0u;
    }

  constexpr float LOG2E = 1.4426950408889634f;
  float o[OD / 2];
#pragma unroll
  for (int i = 0; i < OD / 2; ++i) o[i] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY};   // running max, base 2
  float l_r[2] = {0.f, 0.f};
  uint32_t pa[FP_TK / 16][4];
  const uint32_t kb_s = smem_u32(kb), vb_s = smem_u32(vb);

  for (int i = COLS ? 0 : wg; t_begin + i < t_end; i += COLS ? 1 : FP_WG) {
    const int s0 = (t_begin + i) * FP_TK;
    const int slot = i % FP_STAGES;
    mbar_wait(&full[slot], (i / FP_STAGES) & 1);
    const uint8_t* stage = ring + slot * C::STAGE;
    if constexpr (C::B1) {
      // the previous tile's wgmmas have read the bf16 tiles in every warp
      named_sync(cv_bar, cv_n);
      // 1-byte [token][D] -> bf16 boxes of 32 values, 64-byte rows, the
      // 16-byte chunk c of row r at chunk c ^ ((r >> 1) & 3)
#pragma unroll
      for (int kv = 0; kv < 2; ++kv) {
        const uint8_t* src = stage + kv * C::KV_BYTES;
        uint8_t* dst = kv ? vb : kb;
#pragma unroll
        for (int i = cv_tid; i < FP_TK * D / 16; i += cv_n) {
          const int tok = i / (D / 16), c = i % (D / 16);
          const uint4 w =
              *reinterpret_cast<const uint4*>(src + tok * D + 16 * c);
          uint4 lo, hi;
          if constexpr (C::SC) {
            int8x16_to_bf16(w, lo, hi);
          } else {
            e4m3x16_to_bf16(w, lo, hi);
            if (s0 + tok >= kv_len) lo = hi = make_uint4(0, 0, 0, 0);
          }
          uint8_t* row = dst + (c >> 1) * C::BOX + tok * 64;
          const int sw = (tok >> 1) & 3, c0 = 2 * (c & 1);
          *reinterpret_cast<uint4*>(row + 16 * (c0 ^ sw)) = lo;
          *reinterpret_cast<uint4*>(row + 16 * ((c0 + 1) ^ sw)) = hi;
        }
      }
      if constexpr (C::SC) {
        // the tile's scales; zero past kv_len, where the stage holds the
        // rest of the last page (or nothing)
        const float* sc =
            reinterpret_cast<const float*>(stage + 2 * C::KV_BYTES);
        if (cv_tid < 2 * FP_TK) {
          const float v =
              s0 + (cv_tid & (FP_TK - 1)) < kv_len ? sc[cv_tid] : 0.f;
          if (cv_tid < FP_TK) ksc[cv_tid] = v;
          else vsc[cv_tid - FP_TK] = v;
        }
      }
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);
      named_sync(cv_bar, cv_n);
    }
    // bf16 pages: the stage's K and V, as TMA left them
    const uint32_t ks_s = smem_u32(stage), vs_s = ks_s + C::KV_BYTES;

    // S = Q K^T: 64 rows x 64 tokens, D / 16 k16 steps
    float s[FP_TK / 2];
#pragma unroll
    for (int i = 0; i < FP_TK / 2; ++i) s[i] = 0.f;
    keep_all(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      if constexpr (C::B1)
        Wgmma<FP_TK>::mma(
            s, qa[kk], desc_b64(kb_s + (kk >> 1) * C::BOX + 32 * (kk & 1)));
      else
        Wgmma<FP_TK>::mma(s, qa[kk], desc_b128(ks_s + (kk >> 2) * PAGED_BOX +
                                              32 * (kk & 3)));
    }
    wgmma_commit();
    wgmma_wait<0>();
    keep_all(s);

    // scale, K scale, cap, mask; the online softmax of both rows.
    // s[4j + e] is row g, token 8j + 2t + e; s[4j + 2 + e] row g + 8
    float alpha[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < FP_TK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kt = 8 * j + 2 * t + e, kvp = s0 + kt;
          float v = s[4 * j + 2 * hh + e] * scale;
          if constexpr (C::SC) v *= ksc[kt];
          if (cap > 0.f) v = cap * tanhf(v / cap);
          const bool ok = rows[hh] < R && kvp <= qpos[hh] && kvp < kv_len &&
                          (window <= 0 || kvp > qpos[hh] - window);
          v = ok ? v * LOG2E : -INFINITY;
          s[4 * j + 2 * hh + e] = v;
          mx = fmaxf(mx, v);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[hh], mx);
      const float msub = m_new == -INFINITY ? 0.f : m_new;
      alpha[hh] = exp2f(m_r[hh] - msub);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < FP_TK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(s[4 * j + 2 * hh + e] - msub);
          s[4 * j + 2 * hh + e] = p;
          rs += p;
        }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l_r[hh] = l_r[hh] * alpha[hh] + rs;
      m_r[hh] = m_new;
    }
#pragma unroll
    for (int j = 0; j < OD / 8; ++j) {
      o[4 * j] *= alpha[0];
      o[4 * j + 1] *= alpha[0];
      o[4 * j + 2] *= alpha[1];
      o[4 * j + 3] *= alpha[1];
    }
    // P times the V scale of its token, as bf16 A fragments of the k16
    // steps (tokens 16kk..16kk+15): the S accumulators of chunks 2kk, 2kk+1
#pragma unroll
    for (int kk = 0; kk < FP_TK / 16; ++kk) {
      float v0 = 1.f, v1 = 1.f, v2 = 1.f, v3 = 1.f;
      if constexpr (C::SC) {
        v0 = vsc[16 * kk + 2 * t];
        v1 = vsc[16 * kk + 2 * t + 1];
        v2 = vsc[16 * kk + 8 + 2 * t];
        v3 = vsc[16 * kk + 9 + 2 * t];
      }
      const float* a = s + 8 * kk;
      pa[kk][0] = pack_bf16x2(a[0] * v0, a[1] * v1);
      pa[kk][1] = pack_bf16x2(a[2] * v0, a[3] * v1);
      pa[kk][2] = pack_bf16x2(a[4] * v2, a[5] * v3);
      pa[kk][3] = pack_bf16x2(a[6] * v2, a[7] * v3);
    }
    // O += P V: V [token][d] is MN-major for this product (N = d); with
    // COLS this warpgroup's columns wg * OD.. (boxes of 32 channels for the
    // converted tiles, of 64 in the stage)
    const int col0 = COLS ? wg * OD : 0;
    keep_all(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < FP_TK / 16; ++kk) {
      if constexpr (C::B1)
        Wgmma<OD>::template mma<1>(
            o, pa[kk],
            desc_mn64(vb_s + (col0 / 32) * C::BOX + kk * 16 * 64, C::BOX));
      else
        Wgmma<OD>::template mma<1>(
            o, pa[kk],
            desc_mn128(vs_s + (col0 / 64) * PAGED_BOX + kk * 16 * 128,
                       PAGED_BOX));
    }
    wgmma_commit();
    wgmma_wait<0>();
    keep_all(o);
#pragma unroll
    for (int kk = 0; kk < FP_TK / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) keep(pa[kk][j]);
    if constexpr (!C::B1) {
      // both products have read the stage
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);
    }
  }

  // Merge: warpgroup 1 leaves its running max, sum and O in its own tiles'
  // space (row-indexed max and sum; O by thread), or for bf16 pages in the
  // ring once both warpgroups are done with it, warpgroup 0 rescales both
  // to the common max, adds, and writes the output.  With COLS each
  // warpgroup holds the whole softmax of its own columns: nothing to merge.
  if constexpr (!COLS) {
    float* om = reinterpret_cast<float*>(C::B1 ? base + C::WG_BYTES : ring);
    float* ml = om + 128 * (D / 2);                             // max, sum
    static_assert(COLS || 128 * (D / 2) * 4 + 2 * FP_ROWS * 4 <=
                              (C::B1 ? C::WG_BYTES : FP_STAGES * C::STAGE),
                  "the merge fits its space");
    if constexpr (!C::B1) named_sync(3, FP_WG * 128);
    if (wg == 1) {
#pragma unroll
      for (int j = 0; j < D / 2; ++j) om[j * 128 + tid] = o[j];
      if (t == 0) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int rl = wl * 16 + g + hh * 8;
          ml[rl] = m_r[hh];
          ml[FP_ROWS + rl] = l_r[hh];
        }
      }
    }
    named_sync(3, FP_WG * 128);
    if (wg == 1) return;
    float a0[2], a1[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int rl = wl * 16 + g + hh * 8;
      const float m1 = ml[rl], l1 = ml[FP_ROWS + rl];
      const float m = fmaxf(m_r[hh], m1);
      const float mm = m == -INFINITY ? 0.f : m;
      a0[hh] = exp2f(m_r[hh] - mm);
      a1[hh] = exp2f(m1 - mm);
      l_r[hh] = l_r[hh] * a0[hh] + l1 * a1[hh];
      m_r[hh] = m;
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[4 * j + e] = o[4 * j + e] * a0[e >> 1] +
                       om[(4 * j + e) * 128 + tid] * a1[e >> 1];
  }

  // O / l (the sink joins l once), bf16 pairs: o[4j + 0, 1] row g,
  // o[4j + 2, 3] row g + 8, at d = col0 + 8j + 2t
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (rows[hh] >= R) continue;
    float l = l_r[hh];
    if (sinks != nullptr) {
      const int hq = h * G + rows[hh] % G;
      l += exp2f(sinks[hq] * LOG2E - m_r[hh]);
    }
    const float inv = l > 0.f ? 1.f / l : 1.f;
    const int col0 = COLS ? wg * OD : 0;
#pragma unroll
    for (int j = 0; j < OD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + qoff[hh] + col0 + 8 * j +
                                         2 * t) =
          __floats2bfloat162_rn(o[4 * j + 2 * hh] * inv,
                                o[4 * j + 2 * hh + 1] * inv);
  }
}

template <int D, typename KV>
int launch_d(const void* q, const void* k, const void* k_sc, const void* v,
             const void* v_sc, const void* block_table, const void* sinks,
             void* out, int T, int Hq, int Hkv, int NB, int BS, int MB,
             int kv_len, int q_offset, float scale, int window, float cap,
             cudaStream_t st) {
  using C = FpCfg<D, KV>;
  auto kernel = flash_prefill_sm90_kernel<D, KV>;
  CUtensorMap kmap = {}, vmap = {};
  int BR = 0;
  if constexpr (!C::B1) {
    // [NB * Hkv * BS, D] rows, boxes of BR rows x 64 channels
    BR = paged_box_rows(BS);
    const uint64_t rows = (uint64_t)NB * Hkv * BS;
    int e = tensor_map_2d(&kmap, k, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, D, rows,
                          (uint64_t)D * 2, 64, BR, CU_TENSOR_MAP_SWIZZLE_128B);
    if (e) return e;
    e = tensor_map_2d(&vmap, v, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, D, rows,
                      (uint64_t)D * 2, 64, BR, CU_TENSOR_MAP_SWIZZLE_128B);
    if (e) return e;
  }
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int G = Hq / Hkv;
  dim3 grid((T * G + FP_ROWS - 1) / FP_ROWS, Hkv);
  kernel<<<grid, FP_THREADS, C::SMEM, st>>>(
      kmap, vmap, static_cast<const bf16*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), static_cast<const float*>(k_sc),
      static_cast<const float*>(v_sc), static_cast<const int*>(block_table),
      static_cast<const float*>(sinks), static_cast<bf16*>(out), T, Hq, Hkv,
      BS, BR, MB, kv_len, q_offset, scale, window, cap);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace tllm

// q/out [T, Hq, D] bf16, int8 pools [NB, Hkv, BS, D] (16-byte aligned) with
// f32 scale pools [NB, Hkv, BS] indexed by the same block ids,
// block_table [MB] int32, sinks [Hq] f32 or null; D 64, 128 or 256, Hq %
// Hkv == 0.  window <= 0 and cap <= 0 mean "off".
extern "C" int tllm_flash_prefill_int8(
    const void* q, const void* k_data, const void* k_scale,
    const void* v_data, const void* v_scale, const void* block_table,
    const void* sinks, void* out, int T, int Hq, int Hkv, int D, int BS,
    int MB, int kv_len, int q_offset, float scale, int window, float cap,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return tllm::launch_d<64, int8_t>(q, k_data, k_scale, v_data, v_scale,
                                      block_table, sinks, out, T, Hq, Hkv, 0,
                                      BS, MB, kv_len, q_offset, scale, window,
                                      cap, st);
  if (D == 128)
    return tllm::launch_d<128, int8_t>(q, k_data, k_scale, v_data, v_scale,
                                       block_table, sinks, out, T, Hq, Hkv, 0,
                                       BS, MB, kv_len, q_offset, scale,
                                       window, cap, st);
  if (D == 256)
    return tllm::launch_d<256, int8_t>(q, k_data, k_scale, v_data, v_scale,
                                       block_table, sinks, out, T, Hq, Hkv, 0,
                                       BS, MB, kv_len, q_offset, scale,
                                       window, cap, st);
  return (int)cudaErrorInvalidValue;
}

// q/out [T, Hq, D] bf16, bf16 pools [NB, Hkv, BS, D] (16-byte aligned),
// block_table [MB] int32, sinks [Hq] f32 or null; D 64, 128 or 256, Hq %
// Hkv == 0, BS % 8 == 0.  window <= 0 and cap <= 0 mean "off".
extern "C" int tllm_flash_prefill(const void* q, const void* k_cache,
                                  const void* v_cache, const void* block_table,
                                  const void* sinks, void* out, int T, int Hq,
                                  int Hkv, int D, int NB, int BS, int MB,
                                  int kv_len, int q_offset, float scale,
                                  int window, float cap, void* stream) {
  if (BS % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return tllm::launch_d<64, tllm::bf16>(
        q, k_cache, nullptr, v_cache, nullptr, block_table, sinks, out, T, Hq,
        Hkv, NB, BS, MB, kv_len, q_offset, scale, window, cap, st);
  if (D == 128)
    return tllm::launch_d<128, tllm::bf16>(
        q, k_cache, nullptr, v_cache, nullptr, block_table, sinks, out, T, Hq,
        Hkv, NB, BS, MB, kv_len, q_offset, scale, window, cap, st);
  if (D == 256)
    return tllm::launch_d<256, tllm::bf16>(
        q, k_cache, nullptr, v_cache, nullptr, block_table, sinks, out, T, Hq,
        Hkv, NB, BS, MB, kv_len, q_offset, scale, window, cap, st);
  return (int)cudaErrorInvalidValue;
}

// q/out [T, Hq, D] bf16, e4m3 pools [NB, Hkv, BS, D] (16-byte aligned, no
// scales), block_table [MB] int32, sinks [Hq] f32 or null; D 64, 128 or
// 256, Hq % Hkv == 0.  window <= 0 and cap <= 0 mean "off".
extern "C" int tllm_flash_prefill_fp8(const void* q, const void* k_cache,
                                      const void* v_cache,
                                      const void* block_table,
                                      const void* sinks, void* out, int T,
                                      int Hq, int Hkv, int D, int BS, int MB,
                                      int kv_len, int q_offset, float scale,
                                      int window, float cap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return tllm::launch_d<64, tllm::e4m3>(
        q, k_cache, nullptr, v_cache, nullptr, block_table, sinks, out, T,
        Hq, Hkv, 0, BS, MB, kv_len, q_offset, scale, window, cap, st);
  if (D == 128)
    return tllm::launch_d<128, tllm::e4m3>(
        q, k_cache, nullptr, v_cache, nullptr, block_table, sinks, out, T,
        Hq, Hkv, 0, BS, MB, kv_len, q_offset, scale, window, cap, st);
  if (D == 256)
    return tllm::launch_d<256, tllm::e4m3>(
        q, k_cache, nullptr, v_cache, nullptr, block_table, sinks, out, T,
        Hq, Hkv, 0, BS, MB, kv_len, q_offset, scale, window, cap, st);
  return (int)cudaErrorInvalidValue;
}
