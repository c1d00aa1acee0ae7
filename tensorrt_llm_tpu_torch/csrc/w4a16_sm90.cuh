// Hopper mainloop of the W4A16 GEMMs K12 (`w4a16_kpaired.cu`, 2-D K-paired
// packing), K13 (`w4a16_ramp.cu`, tiled packing) and K1 (`w4a16_gemm.cu`,
// tiled packing, with its own configuration bits PRE_*, below):
// act(x @ ((q - z) * s) + b), bf16 x, int4 q, bf16 scales and zeros, f32
// accumulation, bf16 out.  K5 (`moe_gmm.cu`) is its GROUPED layout: the
// tiled packing of a stack of experts, f32 scales, work units from a
// device-built list, f32 out (see `GROUPED` below).  K8 (`w4a8_gemm.cu`)
// is its s8 instantiation, a kernel of its own on the same ring, tiles,
// work units and combine pass.
//
// What bounds the products on the H100: the K*N/2 weight bytes at decode
// (M <= 16: 2*M ops per weight byte, far below the ~295 op/byte ridge), the
// tensor-core operations at a 256-row prefill chunk.
//
// Design (sm_90a: TMA, mbarriers, wgmma):
//
// * Swapped operands.  The kernel computes out^T = W^T x^T with
//   wgmma.mma_async m64nNk16 in its RS form: the dequantized weight tile,
//   64 output columns x 16 K, is the register A operand; the token tile is
//   the shared-memory B operand (x [M, K] row-major is K-major).  The
//   tokens are wgmma's N: a call of M rows runs a token tile NTOK of 8, 16,
//   32, 64 or 128 (the smallest >= M, and M blocks of 128 above;
//   `sm90_tiles` in ops/w4a16_gemm.py), so decode pays 8 token columns,
//   not 64 rows.  A 256-token tile (128 accumulator registers a thread,
//   five ring stages) ran M 256 slower on the H100 than two M blocks of
//   128, so 128 is the largest.
// * Column permutation instead of a transposed epilogue.  A row 16w + g +
//   8h of warp w holds output column 16w + 2g + h.  Then one ldmatrix.x4
//   .trans of the packed bytes gives each lane, in one 32-bit register per
//   k16 step, exactly the 8 nibbles of its A fragment (columns 2g and
//   2g + 1), and the accumulator fragment holds output pairs (c, c + 1) of
//   two tokens: the epilogue stores bf16x2 words, eight lanes of a warp
//   covering one 32-byte sector of a row.  The stores are sector-complete
//   without staging through shared memory, so there is none.
// * A ring of STAGES stages of 64 K rows each (32 packed rows x 64 columns
//   of weights per consumer warpgroup, and two 32-column boxes of x), filled
//   by TMA (cp.async.bulk.tensor with complete_tx mbarriers) from one
//   producer thread while the consumer warpgroups run the stages before
//   it: the copies of the next STAGES - 1 stages are in flight while one
//   runs on the tensor cores.  TMA's out-of-bounds fill gives the zero
//   token rows past M and the zero columns past N.  Both packings are 2-D
//   byte arrays to TMA: the tiled [N/BN, K/2, BN] as (N/BN)*(K/2) rows of
//   BN bytes, the K-paired [K/2, N] as K/2 rows of N bytes.  All boxes are
//   64 bytes wide with the 64-byte swizzle, which keeps the ldmatrix reads
//   and wgmma's B reads free of bank conflicts.
// * K-paired steps.  Packed row c*Gp/2 + p holds K rows c*Gp + p (low
//   nibble) and c*Gp + Gp/2 + p (high).  A stage is 32 packed rows of one
//   pack group (Gp % 64 == 0): its x boxes are the matching 32 columns of
//   both halves, x[:, c*Gp + p0 ..] and x[:, c*Gp + Gp/2 + p0 ..], and the
//   low nibbles of 16 packed rows are one k16 step against the first box,
//   the high nibbles the next against the second.  At Gp 32 a stage is two
//   whole pack groups, 64 contiguous K rows as in the tiled packing: the
//   boxes are x[:, 64s ..] and x[:, 64s + 32 ..], and the low and high
//   nibbles of 16 packed rows are the two k16 steps of one box.  No repack.
// * Group scales.  A stage carries the scale (and zero) row of its group,
//   or at G 32, where the group changes after the stage's first 32 K rows,
//   the two rows of its two groups, each dequantizing its two k16 steps.
// * Dequantization in registers, exact.  The bytes are XORed with 0x88
//   (two's-complement nibble q becomes q + 8), a lop3 (or, for the tiled
//   pairing, a prmt and a lop3) places two nibbles under the bf16 pattern
//   0x4300 (128.0), giving 136 + q exactly; one bf16x2 FMA subtracts
//   136 + z (exact: small integers) and one multiplies by the bf16 scale,
//   rounding once.  So the kernel's weight is bit for bit the plain
//   version's bf16((q - z) * s) (`w4a16_matmul_plain`); only the f32
//   summation order differs.  Scaling a per-group f32 partial instead would
//   double the accumulator registers.
// * Work units fill the card.  A unit is (M block, column tile, K slice);
//   the K slices come from the caller (K12: `block_k`, K13: the ramp
//   schedule).  A persistent grid walks the units (u = block, + grid, ...),
//   the ring running on across unit boundaries.  With one slice a unit
//   writes bf16 out with bias and activation; with several, each writes its
//   f32 partial to ws[slice], and a second pass (`combine_kernel`) sums the
//   slices in K order and applies bias and activation.  No atomics: the sum
//   is bitwise repeatable.
// * x is the shared operand.  At 128 tokens a block owns 128 columns
//   (two consumer warpgroups sharing each x stage): at M 256, K 2048 (x 1
//   MB), TinyLlama gate_up's 88 column tiles read 88 MB of x from L2
//   instead of the 176 MB of 64-column tiles, ~9 us at ~10 TB/s against
//   the 11.9 us operation bound.  At most 64 tokens one warpgroup of 64
//   columns per block, two or three blocks per SM: x is then at most 0.5
//   KB per K step, and the small wgmmas run in up to four independent accumulator
//   chains (`Cfg::NACC`).
// * Tensor maps are encoded on the host (cuTensorMapEncodeTiled, resolved
//   through cudaGetDriverEntryPoint: no -lcuda) and cached by (pointer,
//   shape, box), so a weight's map is encoded once and an activation's
//   whenever the caching allocator hands out a new buffer.
// * The combine pass is a programmatic dependent launch
//   (griddepcontrol): it is scheduled while the mainloop runs and waits for
//   its completion on the device, so the second launch costs no gap.
#pragma once

#include <type_traits>

#include "sm90.cuh"

namespace tllm {
namespace sm90 {

constexpr int STAGE_K = 64;      // K rows per ring stage
constexpr int STAGE_PR = 32;     // packed rows per ring stage
constexpr int WG_COLS = 64;      // output columns per consumer warpgroup
constexpr int W_BOX = STAGE_PR * WG_COLS;   // 2 KB of weights per warpgroup
constexpr int MAX_SLICES = 128;

// K1's configuration bits (template argument PRE; K12 and K13 run PRE 0).
// PRE_K1, at every token tile: any G % 32 == 0 (two scale rows a stage
// whenever G % 64 != 0, the second picked per stage), the producer's
// offsets and scale group advanced per unit and stage instead of divided
// out each stage, shared (not generic) loads of the scale rows, and the
// activation chosen once per epilogue, not per stored value.  At 128
// tokens, the prefill mechanisms, each timed with and without it by
// `chip_smoke.py` (`w4a16_gemm.py::K1_VARIANTS`): X128 stages x as one box
// of 64 K (128-byte rows, 128-byte swizzle) instead of two boxes of 32;
// REGS makes the producer a whole warpgroup that gives registers to the
// consumers (setmaxnreg), which then run two accumulator chains; WG3 runs
// three consumer warpgroups (192 columns a block), which `k1_plan` picks
// where its units fill the card in fewer rounds.
enum { PRE_K1 = 1, PRE_X128 = 2, PRE_REGS = 4, PRE_WG3 = 8 };

// SB: bytes of a scale (2: bf16; 4: K5's f32)
template <int NTOK, int PRE = 0, int SB = 2>
struct Cfg {
  static constexpr bool X128 = (PRE & PRE_X128) != 0;
  static constexpr bool REGS = (PRE & PRE_REGS) != 0;
  // consumer warpgroups: one up to 64 tokens, two at 128 (three with WG3)
  static constexpr int NWG = NTOK >= 128 ? ((PRE & PRE_WG3) ? 3 : 2) : 1;
  static constexpr int COLS = NWG * WG_COLS;
  // + one producer warp (a whole warpgroup with REGS)
  static constexpr int THREADS = NWG * 128 + (REGS ? 128 : 32);
  // blocks an SM holds: three up to 32 tokens, two at 64, one from 128
  static constexpr int MIN_BLOCKS = NTOK <= 32 ? 3 : (NWG == 1 ? 2 : 1);
  // independent accumulator sets, k16 step i into set i % NACC: the
  // wgmmas of one set form a dependent chain, so at small token tiles,
  // where each wgmma is short, four chains keep the tensor pipe busy (at
  // 128 tokens a second set of 64 registers made ptxas spill, unless the
  // producer hands registers over: REGS)
  static constexpr int NACC =
      NTOK <= 32 ? 4 : (NTOK == 64 ? 2 : (NTOK == 128 && REGS && NWG == 2 ? 2 : 1));
  // registers a consumer thread takes from the producer warpgroup (REGS):
  // 65,536 less the producer's 128 x 40, over the consumers
  static constexpr int CONSUMER_REGS = NWG == 2 ? 232 : 152;
  static constexpr int X_BOX = NTOK * 64;            // 32 bf16 x NTOK rows
  static constexpr int SZ_BOX = COLS * SB;           // one scale row
  // weights, x, then room for two scale rows and two zero rows (G 32);
  // a multiple of 1 KB, so that every stage keeps its boxes on their
  // swizzle patterns (the second rows fit in the rounding at every tile)
  static constexpr int STAGE_BYTES =
      (NWG * W_BOX + 2 * X_BOX + 4 * SZ_BOX + 1023) / 1024 * 1024;
  // up to 32 tokens three blocks share an SM with ~70 KB of ring each
  // (17 stages of 2 KB of weights at 8 tokens), at 64 two with ~100 KB
  // (9 stages), so that ~200 KB of ring an SM is in flight at decode; 10
  // stages at 128 tokens, one block an SM
  static constexpr int STAGES_FIT =
      (MIN_BLOCKS == 3 ? 70 * 1024 : MIN_BLOCKS == 2 ? 100 * 1024 : 215 * 1024) /
      STAGE_BYTES;
  static constexpr int STAGES = STAGES_FIT < 24 ? STAGES_FIT : 24;
  // the ring, its barriers, and slack to align the base to 1 KB
  static constexpr int SMEM = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;
};

// K slices of the units, in stages of STAGE_K rows, in K order
struct Slices {
  int n;
  int start[MAX_SLICES + 1];
};

struct Params {
  const void* scales;
  const void* zeros;
  const float* bias;
  float* ws;          // [n slices, M, N] f32 partials (n > 1)
  bf16* out;          // [M, N]
  // GROUPED: the unit list (`tllm_moe_gmm_units`: a header row (count,
  // ntok, bound), then (expert, first row, rows) per unit) and f32 out
  const int* units;
  float* outf;
  int M, N, K, G;
  int Gp;             // K-paired: pack group (K rows)
  int bn;             // tiled: column tile of the packing
  int act;
  int n_mb, n_ct;     // M blocks, column tiles
  Slices sl;
};

// ----------------------------------------------------------- dequant ---
// (v & 0x000F000F) | 0x43004300: nibbles at bits 0 and 16 under 128.0
__device__ __forceinline__ uint32_t magic2(uint32_t v) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n"
      : "=r"(d)
      : "r"(v), "r"(0x000F000Fu), "r"(0x43004300u));
  return d;
}
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t s) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(s));
  return d;
}
// The low nibbles of bytes 0 and 2 of v as bf16x2 136 + q, exactly: one
// lop3 keeps bits 0-2 and 16-18, inverts bits 3 and 19 (two's complement q
// becomes q + 8) and sets the bf16 pattern of 128.0 in each half (K2's and
// K14's A operand)
__device__ __forceinline__ uint32_t nib2_136(uint32_t v) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0x6A;\n"
      : "=r"(d)
      : "r"(v), "r"(0x000F000Fu), "r"(0x43084308u));
  return d;
}
__device__ __forceinline__ uint32_t bf2_fma(uint32_t a, uint32_t b,
                                            uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}
// (136 + q) - (136 + z) exactly, then times s, rounded once to bf16
__device__ __forceinline__ uint32_t deq2(uint32_t h, uint32_t nz,
                                         uint32_t s) {
  return bf2_fma(bf2_fma(h, 0x3F803F80u, nz), s, 0x80008000u);
}
// the same with an f32 scale (K5): the two bf16 integers 136 + q widened
// to f32, (136 + q) - (136 + z) exact, times s in f32, then one rounding
// to bf16 -- bit for bit bf16(f32((q - z) * s)), the plain version's
// weight
__device__ __forceinline__ uint32_t deqf(uint32_t h, float zf, float s) {
  const float lo = __uint_as_float(h << 16);
  const float hi = __uint_as_float(h & 0xFFFF0000u);
  return pack_bf16x2(__fmul_rn(__fsub_rn(lo, zf), s),
                     __fmul_rn(__fsub_rn(hi, zf), s));
}

// ------------------------------------------------------------- kernel ---
// Stage s of the ring: [NWG weight boxes of 2 KB][x: two boxes of 32 K, or
// one of 64 K with X128][the scale rows][the zero rows] of the stage's
// group (two rows when the group changes inside the stage, else one of two
// slots), each swizzled box aligned to its pattern; the full and empty
// barriers follow the ring.
// LAYOUT: TILED, KPAIRED_SPLIT (pack groups of 64 rows or more),
// KPAIRED_32 (pack groups of 32 rows) or GROUPED (K5: the tiled packing of
// E experts, [E, N/BN, K/2, BN] as E*(N/BN)*(K/2) rows of BN bytes, an
// expert a row offset; f32 scales [E*(K/G), N]; a work unit is an entry
// of the device-built list, (expert, first row, rows <= NTOK), times a
// column tile, over the whole K; tokens past the unit's rows belong to
// the next expert or lie past M and are not stored)
enum { TILED = 0, KPAIRED_SPLIT = 1, KPAIRED_32 = 2, GROUPED = 3 };
__host__ __device__ constexpr int scale_bytes(int layout) {
  return layout == GROUPED ? 4 : 2;
}

template <int NTOK, int LAYOUT, int PRE = 0>
__global__ void __launch_bounds__(Cfg<NTOK, PRE>::THREADS,
                                  Cfg<NTOK, PRE>::MIN_BLOCKS)
    w4a16_sm90_kernel(const __grid_constant__ CUtensorMap wmap,
                      const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap smap,
                      const __grid_constant__ CUtensorMap zmap,
                      const __grid_constant__ Params p) {
  using C = Cfg<NTOK, PRE, scale_bytes(LAYOUT)>;
  constexpr bool K1 = (PRE & PRE_K1) != 0;
  // K5 runs with PRE_K1 (its reach: any G % 32 == 0, K % 32 == 0)
  constexpr bool GR = LAYOUT == GROUPED;
  static_assert(!GR || PRE == PRE_K1, "K5 runs the K1 bits");
  static_assert(!(PRE & ~PRE_K1) || (LAYOUT == TILED && NTOK == 128),
                "prefill mechanisms are K1's, at 128 tokens");
  extern __shared__ uint8_t smem_raw[];
  // K1 offsets the shared array itself, so that the compiler keeps its
  // address space (shared loads of the scale rows, not generic ones)
  uint8_t* ring =
      K1 ? smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023)
         : reinterpret_cast<uint8_t*>(
               (reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
               ~(uintptr_t)1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + C::STAGES * C::STAGE_BYTES);
  uint64_t* empty = full + C::STAGES;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], C::NWG * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the combine pass may be scheduled now; it waits for this grid's
  // completion (griddepcontrol.wait) before it reads the partials
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  const int n_tiles = p.n_mb * p.n_ct;
  // GROUPED: (list entry, column tile) items, the entry count read on the
  // device (the host knows only its bound)
  const int n_units = GR ? p.units[0] * p.n_ct : n_tiles * p.sl.n;
  // K-paired at Gp >= 64: a stage's low and high nibbles meet x segments
  // Gp/2 apart; else (tiled, K-paired at Gp 32) its 64 K rows are
  // contiguous.  Both are template arguments: as run-time selects in the
  // issue of every wgmma they cost GPT-OSS o_proj 10-16%.
  constexpr bool KPAIRED = LAYOUT == KPAIRED_SPLIT || LAYOUT == KPAIRED_32;
  constexpr bool split = LAYOUT == KPAIRED_SPLIT;
  const int spg = split ? p.Gp / 2 / STAGE_PR : 1;   // stages per pack group
  const bool has_zeros = p.zeros != nullptr;
  const bool per_channel = p.G >= p.K;
  // scale rows a stage: two when its halves may lie in two groups (G 32;
  // for K1 any G that is not a multiple of 64)
  const int nsz = (K1 ? (!per_channel && p.G % STAGE_K) : p.G == 32) ? 2 : 1;
  auto group_of = [&](int st) {
    return per_channel ? 0 : (split ? st / spg * p.Gp : st * STAGE_K) / p.G;
  };

  if (warp >= C::NWG * 4) {
    // ------------------------------------------------------ producer ---
    if constexpr (C::REGS) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    }
    if (warp != C::NWG * 4 || lane != 0) return;
    int slot = 0;
    uint32_t phase = 0;
    for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
      int s, m0, col0, expert = 0;
      if constexpr (GR) {
        const int* ent = p.units + 3 * (1 + u / p.n_ct);
        s = 0;
        expert = ent[0];
        m0 = ent[1];
        col0 = (u % p.n_ct) * C::COLS;
      } else {
        s = u / n_tiles;
        const int tile = u % n_tiles;
        m0 = (tile / p.n_ct) * NTOK;
        col0 = (tile % p.n_ct) * C::COLS;
      }
      // the expert's first scale row (GROUPED)
      const int grp_base = GR ? expert * (per_channel ? 1 : p.K / p.G) : 0;
      // K1: the unit's weight boxes and scale group, advanced stage by
      // stage without the divisions (each a long dependent chain on the
      // one issuing thread)
      int wxk[C::NWG], wyk[C::NWG], grp_k = 0, rem_k = 0;
      if constexpr (K1) {
#pragma unroll
        for (int wg = 0; wg < C::NWG; ++wg) {
          const int cw = col0 + wg * WG_COLS;
          wxk[wg] = cw % p.bn;
          wyk[wg] = (expert * (p.N / p.bn) + cw / p.bn) * (p.K / 2);
        }
        if (!per_channel) {
          const int k0 = p.sl.start[s] * STAGE_K;
          grp_k = k0 / p.G;
          rem_k = k0 - grp_k * p.G;
        }
      }
      for (int st = p.sl.start[s]; st < p.sl.start[s + 1]; ++st) {
        mbar_wait(&empty[slot], phase ^ 1);
        mbar_expect_tx(&full[slot], C::NWG * W_BOX + 2 * C::X_BOX +
                                        (has_zeros ? 2 : 1) * nsz * C::SZ_BOX);
        uint8_t* stage = ring + slot * C::STAGE_BYTES;
        int kx0, kx1;
        if (split) {
          const int c = st / spg, p0 = (st % spg) * STAGE_PR;
          kx0 = c * p.Gp + p0;
          kx1 = kx0 + p.Gp / 2;
        } else {
          kx0 = st * STAGE_K;
          kx1 = kx0 + STAGE_K / 2;
        }
#pragma unroll
        for (int wg = 0; wg < C::NWG; ++wg) {
          const int cw = col0 + wg * WG_COLS;
          int wx, wy;
          if (KPAIRED) {
            wx = cw;
            wy = st * STAGE_PR;
          } else if (K1) {
            wx = wxk[wg];
            wy = wyk[wg] + st * STAGE_PR;
          } else {
            wx = cw % p.bn;
            wy = (cw / p.bn) * (p.K / 2) + st * STAGE_PR;
          }
          tma_load_2d(stage + wg * W_BOX, &wmap, wx, wy, &full[slot]);
        }
        uint8_t* xs = stage + C::NWG * W_BOX;
        if constexpr (C::X128) {
          tma_load_2d(xs, &xmap, kx0, m0, &full[slot]);
        } else {
          tma_load_2d(xs, &xmap, kx0, m0, &full[slot]);
          tma_load_2d(xs + C::X_BOX, &xmap, kx1, m0, &full[slot]);
        }
        const int grp = grp_base + (K1 ? grp_k : group_of(st));
        tma_load_2d(xs + 2 * C::X_BOX, &smap, col0, grp, &full[slot]);
        if (has_zeros)
          tma_load_2d(xs + 2 * C::X_BOX + 2 * C::SZ_BOX, &zmap, col0, grp,
                      &full[slot]);
        if (K1 && !per_channel) {
          for (rem_k += STAGE_K; rem_k >= p.G; rem_k -= p.G) ++grp_k;
        }
        if (++slot == C::STAGES) {
          slot = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ------------------------------------------------------ consumers ---
  if constexpr (C::REGS) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::CONSUMER_REGS)
                 : "memory");
  }
  const int wg = warp >> 2, wl = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  // ldmatrix row of this lane: matrix i = lane / 8 covers 8 packed rows;
  // tiled rows 8i + (0,4,1,5,2,6,3,7)[j] (a lane then holds rows t and
  // t + 4: K 2t..2t+1 and 2t+8..2t+9 of a k16 step), K-paired rows 8i + j
  const int mi = lane >> 3, mj = lane & 7;
  const int lrow = 8 * mi + (KPAIRED ? mj : ((mj >> 1) + 4 * (mj & 1)));
  const uint32_t lds_off =
      wg * W_BOX + lrow * 64 + 16 * (wl ^ ((lrow >> 1) & 3));
  float acc[C::NACC][NTOK / 2];
  uint32_t a0[4][4], a1[4][4];
  int slot = 0;              // the next stage to load, and its parity
  uint32_t phase = 0;
  int krem = 0;
  for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
    int s, m0, ct, rows = 0;
    if constexpr (GR) {
      const int* ent = p.units + 3 * (1 + u / p.n_ct);
      s = 0;
      m0 = ent[1];
      rows = ent[2];
      ct = u % p.n_ct;
    } else {
      s = u / n_tiles;
      const int tile = u % n_tiles;
      m0 = (tile / p.n_ct) * NTOK;
      ct = tile % p.n_ct;
    }
    const int c = ct * C::COLS + wg * WG_COLS + wl * 16 + 2 * g;
    const bool col_ok = c < p.N;
#pragma unroll
    for (int k = 0; k < C::NACC; ++k)
#pragma unroll
      for (int i = 0; i < NTOK / 2; ++i) acc[k][i] = 0.f;
    // The stage loop, in the order that lets a warpgroup dequantize stage
    // i + 1 while the tensor cores run stage i: start stage i's wgmmas
    // (`mma`), `load` stage i + 1 into the other register set, `retire`
    // stage i (wait, release its slot), start stage i + 1.  No wgmma starts
    // while one is in flight that began before its A registers were
    // written, which ptxas would otherwise answer by serializing every
    // wgmma.
    auto load = [&](uint32_t (&a)[4][4], int st) -> int {
      const int my = slot;
      mbar_wait(&full[slot], phase);
      uint8_t* stage = ring + slot * C::STAGE_BYTES;
      uint32_t r[4];
      ldmatrix_x4_trans(r, reinterpret_cast<const bf16*>(stage + lds_off));
      // this lane's columns' scale and zero of scale row `row` of the
      // stage: pairs (s_c, s_c), (s_c+1, s_c+1) and -(136 + z) likewise
      const uint8_t* sz = stage + C::NWG * W_BOX + 2 * C::X_BOX +
                          scale_bytes(LAYOUT) * (wg * WG_COLS + wl * 16 + 2 * g);
      if constexpr (GR) {
        // f32 scales: s_c, s_c+1 and 136 + z likewise (`deqf`)
        float s0, s1, z0 = 136.f, z1 = 136.f;
        auto scale_row_f = [&](int row) {
          const float2 sv =
              *reinterpret_cast<const float2*>(sz + row * C::SZ_BOX);
          s0 = sv.x;
          s1 = sv.y;
          if (has_zeros) {
            const float2 zv =
                *reinterpret_cast<const float2*>(sz + (2 + row) * C::SZ_BOX);
            z0 = 136.f + zv.x;
            z1 = 136.f + zv.y;
          }
        };
        scale_row_f(0);
        int row2 = 1;
        if (nsz == 2) {
          row2 = krem + 32 >= p.G ? 1 : 0;
          for (krem += STAGE_K; krem >= p.G; krem -= p.G) {
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (i == 2 && nsz == 2) scale_row_f(row2);
          const uint32_t ri = r[i] ^ 0x88888888u;
          const uint32_t hs = ri >> 4;
          a[i][0] = deqf(magic2(prmt(ri, hs, 0x0400)), z0, s0);
          a[i][1] = deqf(magic2(prmt(ri, hs, 0x0501)), z1, s1);
          a[i][2] = deqf(magic2(prmt(ri, hs, 0x0602)), z0, s0);
          a[i][3] = deqf(magic2(prmt(ri, hs, 0x0703)), z1, s1);
        }
        if (++slot == C::STAGES) {
          slot = 0;
          phase ^= 1;
        }
        return my;
      }
      uint32_t sA, sB, zA, zB;
      auto scale_row = [&](int row) {
        const uint32_t s2 =
            *reinterpret_cast<const uint32_t*>(sz + row * C::SZ_BOX);
        zA = zB = 0xC308C308u;   // -136, no zeros
        if (has_zeros) {
          const __nv_bfloat162 zz = *reinterpret_cast<const __nv_bfloat162*>(
              sz + (2 + row) * C::SZ_BOX);
          const float z0 = -(136.f + __low2float(zz));
          const float z1 = -(136.f + __high2float(zz));
          zA = pack_bf16x2(z0, z0);
          zB = pack_bf16x2(z1, z1);
        }
        sA = prmt(s2, 0, 0x1010);
        sB = prmt(s2, 0, 0x3232);
      };
      scale_row(0);
      // the row of the stage's second half: the next at G 32; for K1 the
      // next only where a group ends at its middle (`krem`: the stage's K
      // offset into its group, kept stage by stage)
      int row2 = 1;
      if (K1 && nsz == 2) {
        row2 = krem + 32 >= p.G ? 1 : 0;
        for (krem += STAGE_K; krem >= p.G; krem -= p.G) {
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) r[i] ^= 0x88888888u;
      if (KPAIRED) {
        // k16 steps: low nibbles of rows 0-15, high nibbles of rows 0-15,
        // then the same for rows 16-31 (at G 32 the second group's)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          if (q == 1 && nsz == 2) scale_row(1);
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) {
            const int sh = 4 * hi;
            uint32_t* f = a[2 * q + hi];
            f[0] = deq2(magic2(r[2 * q] >> sh), zA, sA);
            f[1] = deq2(magic2(r[2 * q] >> (sh + 8)), zB, sB);
            f[2] = deq2(magic2(r[2 * q + 1] >> sh), zA, sA);
            f[3] = deq2(magic2(r[2 * q + 1] >> (sh + 8)), zB, sB);
          }
        }
      } else {
        // k16 step i from register i: byte j holds K 2t, 2t+1 (j = 0, 1)
        // or 2t+8, 2t+9 (j = 2, 3) of column 2g (j even) or 2g + 1; steps
        // 2 and 3 are the second half's, of another group at G 32
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (i == 2 && nsz == 2) scale_row(row2);
          const uint32_t hs = r[i] >> 4;
          a[i][0] = deq2(magic2(prmt(r[i], hs, 0x0400)), zA, sA);
          a[i][1] = deq2(magic2(prmt(r[i], hs, 0x0501)), zB, sB);
          a[i][2] = deq2(magic2(prmt(r[i], hs, 0x0602)), zA, sA);
          a[i][3] = deq2(magic2(prmt(r[i], hs, 0x0703)), zB, sB);
        }
      }
      if (++slot == C::STAGES) {
        slot = 0;
        phase ^= 1;
      }
      return my;
    };
    auto mma = [&](uint32_t (&a)[4][4], int sl) {
      // k16 step i reads x box (split ? i % 2 : i / 2) at column offset
      // 16 * (split ? i / 2 : i % 2); with X128 the one box at 16 * i
      const uint32_t xb = smem_u32(ring + sl * C::STAGE_BYTES + C::NWG * W_BOX);
#pragma unroll
      for (int k = 0; k < C::NACC; ++k) keep_all(acc[k]);
      keep_all(a);
      wgmma_fence();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint64_t desc;
        if constexpr (C::X128) {
          desc = desc_b128(xb + 32 * i);
        } else {
          const int box = split ? (i & 1) : (i >> 1);
          const int half = split ? (i >> 1) : (i & 1);
          desc = desc_b64(xb + box * C::X_BOX + 32 * half);
        }
        Wgmma<NTOK>::mma(acc[i % C::NACC], a[i], desc);
      }
      wgmma_commit();
    };
    auto retire = [&](uint32_t (&a)[4][4], int sl) {
      wgmma_wait<0>();
      keep_all(a);
#pragma unroll
      for (int k = 0; k < C::NACC; ++k) keep_all(acc[k]);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[sl]);
    };
    const int st_end = p.sl.start[s + 1];
    int st = p.sl.start[s];
    if (K1 && nsz == 2) krem = st * STAGE_K % p.G;
    int cur = load(a0, st);
    for (; st < st_end; st += 2) {
      mma(a0, cur);
      const int nx = st + 1 < st_end ? load(a1, st + 1) : -1;
      retire(a0, cur);
      if (nx < 0) break;
      mma(a1, nx);
      cur = st + 2 < st_end ? load(a0, st + 2) : -1;
      retire(a1, nx);
    }
#pragma unroll
    for (int k = 1; k < C::NACC; ++k)
#pragma unroll
      for (int i = 0; i < NTOK / 2; ++i) acc[0][i] += acc[k][i];
    // epilogue: lane holds columns (c, c + 1) of tokens 8j + 2t (+1)
    if (!col_ok) continue;
    if constexpr (GR) {
      // f32 out, the unit's rows only: each row of an expert is stored by
      // exactly one unit, so no two blocks write the same value
#pragma unroll
      for (int j = 0; j < NTOK / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int tk = 8 * j + 2 * t + h;
          if (tk < rows)
            *reinterpret_cast<float2*>(p.outf + (size_t)(m0 + tk) * p.N + c) =
                make_float2(acc[0][4 * j + h], acc[0][4 * j + 2 + h]);
        }
      continue;
    }
    const bool direct = p.sl.n == 1;
    if constexpr (K1) {
      // the activation chosen once, outside the loop over the values (a
      // run-time switch in every store made the epilogue a large part of
      // a unit's time at 128 tokens on the H100)
      auto store = [&](auto act_c) {
        constexpr int ACT = decltype(act_c)::value;
        float b0 = 0.f, b1 = 0.f;
        if (direct && p.bias != nullptr) {
          b0 = p.bias[c];
          b1 = p.bias[c + 1];
        }
#pragma unroll
        for (int j = 0; j < NTOK / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = m0 + 8 * j + 2 * t + h;
            if (m >= p.M) continue;
            const float v0 = acc[0][4 * j + h], v1 = acc[0][4 * j + 2 + h];
            if (direct) {
              *reinterpret_cast<__nv_bfloat162*>(p.out + (size_t)m * p.N + c) =
                  __floats2bfloat162_rn(activate<ACT>(v0 + b0),
                                        activate<ACT>(v1 + b1));
            } else {
              *reinterpret_cast<float2*>(p.ws + ((size_t)s * p.M + m) * p.N +
                                         c) = make_float2(v0, v1);
            }
          }
      };
      switch (direct ? p.act : ACT_NONE) {
        case ACT_SILU: store(std::integral_constant<int, ACT_SILU>()); break;
        case ACT_GELU: store(std::integral_constant<int, ACT_GELU>()); break;
        case ACT_RELU: store(std::integral_constant<int, ACT_RELU>()); break;
        case ACT_RELU2: store(std::integral_constant<int, ACT_RELU2>()); break;
        default: store(std::integral_constant<int, ACT_NONE>()); break;
      }
      continue;
    }
    float b0 = 0.f, b1 = 0.f;
    if (direct && p.bias != nullptr) {
      b0 = p.bias[c];
      b1 = p.bias[c + 1];
    }
#pragma unroll
    for (int j = 0; j < NTOK / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + 8 * j + 2 * t + h;
        if (m >= p.M) continue;
        const float v0 = acc[0][4 * j + h], v1 = acc[0][4 * j + 2 + h];
        if (direct) {
          *reinterpret_cast<__nv_bfloat162*>(p.out + (size_t)m * p.N + c) =
              __floats2bfloat162_rn(activate_rt(p.act, v0 + b0),
                                    activate_rt(p.act, v1 + b1));
        } else {
          *reinterpret_cast<float2*>(p.ws + ((size_t)s * p.M + m) * p.N + c) =
              make_float2(v0, v1);
        }
      }
    }
  }
}

// Second pass: out = act(sum over the K slices of ws, in K order, times
// row_scale[m] (K8's per-token activation scale, else none), + bias)
static __global__ void combine_kernel(const float* __restrict__ ws,
                               const float* __restrict__ row_scale,
                               const float* __restrict__ bias,
                               bf16* __restrict__ out, int M, int N, int n,
                               int act) {
  // launched as a programmatic dependent of the mainloop: wait until it
  // has completed and its partials are visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 2;
  const size_t MN = (size_t)M * N;
  if (i >= MN) return;
  float2 v = make_float2(0.f, 0.f);
  for (int s = 0; s < n; ++s) {
    const float2 w = *reinterpret_cast<const float2*>(ws + s * MN + i);
    v.x += w.x;
    v.y += w.y;
  }
  if (row_scale != nullptr) {   // N is even: i and i + 1 share a row
    const float r = row_scale[i / N];
    v.x *= r;
    v.y *= r;
  }
  if (bias != nullptr) {
    v.x += bias[i % N];
    v.y += bias[i % N + 1];
  }
  *reinterpret_cast<__nv_bfloat162*>(out + i) =
      __floats2bfloat162_rn(activate_rt(act, v.x), activate_rt(act, v.y));
}

// --------------------------------------------------------------- host ---
// The combine pass as a programmatic dependent launch: its launch overlaps
// the mainloop's tail instead of following it
inline int launch_combine(const float* ws, const float* row_scale,
                          const float* bias, bf16* out, int M, int N,
                          int n_slices, int act, cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(((size_t)M * N / 2 + 255) / 256));
  cfg.blockDim = dim3(256);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, combine_kernel, ws, row_scale, bias,
                                 out, M, N, n_slices, act);
}

template <int NTOK, int LAYOUT, int PRE>
int launch_ntok(const CUtensorMap& wmap, const CUtensorMap& xmap,
                const CUtensorMap& smap, const CUtensorMap& zmap,
                const Params& p, int grid, cudaStream_t st) {
  using C = Cfg<NTOK, PRE, scale_bytes(LAYOUT)>;
  auto kernel = w4a16_sm90_kernel<NTOK, LAYOUT, PRE>;
  static bool attr_set = false;   // set once per instantiation
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  kernel<<<grid, C::THREADS, C::SMEM, st>>>(wmap, xmap, smap, zmap, p);
  return (int)cudaGetLastError();
}

// K1's configuration at 128 tokens (`K1_VARIANTS` in ops/w4a16_gemm.py):
// 0 the K13 mainloop (with PRE_K1's repairs), 1 X128, 2 X128 + REGS, 3 the
// same with three consumer warpgroups (WG3)
constexpr int K1_PRE[4] = {PRE_K1, PRE_K1 | PRE_X128,
                           PRE_K1 | PRE_X128 | PRE_REGS,
                           PRE_K1 | PRE_X128 | PRE_REGS | PRE_WG3};
constexpr int K1_NVAR = 4;

template <int LAYOUT, int PRE128>
int launch_layout(const CUtensorMap& wmap, const CUtensorMap& xmap,
                  const CUtensorMap& smap, const CUtensorMap& zmap,
                  const Params& p, int ntok, int grid, cudaStream_t st) {
  // below 128 tokens K1 runs the K13 configuration (with PRE_K1's repairs)
  constexpr int PRE = PRE128 & PRE_K1;
  switch (ntok) {
    case 8: return launch_ntok<8, LAYOUT, PRE>(wmap, xmap, smap, zmap, p, grid, st);
    case 16: return launch_ntok<16, LAYOUT, PRE>(wmap, xmap, smap, zmap, p, grid, st);
    case 32: return launch_ntok<32, LAYOUT, PRE>(wmap, xmap, smap, zmap, p, grid, st);
    case 64: return launch_ntok<64, LAYOUT, PRE>(wmap, xmap, smap, zmap, p, grid, st);
    case 128: return launch_ntok<128, LAYOUT, PRE128>(wmap, xmap, smap, zmap, p, grid, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The whole call: tensor maps, the mainloop over `grid` persistent blocks
// and the combine pass when K is cut into more than one slice.  The
// wrapper guarantees: ntok in {8, ..., 128}; M blocks of ntok tokens, n_mb * ntok >= M; n_ct * cols >= N; slices cover
// ceil(K / 64) stages (K-paired: whole pack groups, Gp % 64 == 0 or Gp ==
// 32); G % 64 == 0, G == 32 or G == K (K1: any G % 32 == 0 and K % 32 ==
// 0, the x columns past K read as zeros); N % 16 == 0; a workspace of
// n_slices * M * N floats when n_slices > 1; contiguous operands.
// KIND: 0 tiled (K13), 1 K-paired (K12), 2 tiled K1 with its
// configuration `k1_variant` at 128 tokens.
template <int KIND>
int launch(const void* x, const void* qweight,
                  const void* scales, const void* zeros, const void* bias,
                  void* workspace, void* out, int M, int N, int K, int G,
                  int Gp, int bn, int act, int ntok, int n_mb, int n_ct,
                  const int* slice_start, int n_slices, int grid,
                  int k1_variant, void* stream) {
  if (n_slices < 1 || n_slices > MAX_SLICES) return (int)cudaErrorInvalidValue;
  if (KIND == 2 && (k1_variant < 0 || k1_variant >= K1_NVAR))
    return (int)cudaErrorInvalidValue;
  const bool kpaired = KIND == 1;
  const int pre = KIND == 2 && ntok == 128 ? K1_PRE[k1_variant] : 0;
  Params p;
  p.scales = scales;
  p.zeros = zeros;
  p.units = nullptr;
  p.outf = nullptr;
  p.bias = static_cast<const float*>(bias);
  p.ws = static_cast<float*>(workspace);
  p.out = static_cast<bf16*>(out);
  p.M = M;
  p.N = N;
  p.K = K;
  p.G = G;
  p.Gp = Gp;
  p.bn = bn;
  p.act = act;
  p.n_mb = n_mb;
  p.n_ct = n_ct;
  p.sl.n = n_slices;
  for (int i = 0; i <= n_slices; ++i) p.sl.start[i] = slice_start[i];
  CUtensorMap wmap, xmap;
  int e = kpaired
      ? tensor_map_2d(&wmap, qweight, CU_TENSOR_MAP_DATA_TYPE_UINT8, N,
                      K / 2, N, WG_COLS, STAGE_PR)
      : tensor_map_2d(&wmap, qweight, CU_TENSOR_MAP_DATA_TYPE_UINT8, bn,
                      (uint64_t)(N / bn) * (K / 2), bn, WG_COLS, STAGE_PR);
  if (e) return e;
  // x [M, K] bf16: boxes of 32 K x ntok tokens (64-byte swizzle), or with
  // X128 of 64 K (128-byte swizzle)
  if (pre & PRE_X128) {
    e = tensor_map_2d(&xmap, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, K, M,
                      (uint64_t)K * 2, 64, ntok, CU_TENSOR_MAP_SWIZZLE_128B);
  } else {
    e = tensor_map_2d(&xmap, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, K, M,
                      (uint64_t)K * 2, 32, ntok);
  }
  if (e) return e;
  // scale and zero rows [K/G, N] bf16: the block's columns of one row a
  // box, of two rows where a stage's halves may lie in two groups
  CUtensorMap smap, zmap;
  const int cols = ntok >= 128 ? ((pre & PRE_WG3) ? 3 : 2) * WG_COLS : WG_COLS;
  const int rows = (KIND == 2 ? (G < K && G % STAGE_K) : G == 32) ? 2 : 1;
  e = tensor_map_2d(&smap, scales, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, N,
                    K / G, (uint64_t)N * 2, cols, rows,
                    CU_TENSOR_MAP_SWIZZLE_NONE);
  if (e) return e;
  zmap = smap;
  if (zeros != nullptr) {
    e = tensor_map_2d(&zmap, zeros, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, N,
                      K / G, (uint64_t)N * 2, cols, rows,
                      CU_TENSOR_MAP_SWIZZLE_NONE);
    if (e) return e;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (KIND == 1) {
    e = Gp == 32 ? launch_layout<KPAIRED_32, 0>(wmap, xmap, smap, zmap, p, ntok,
                                                grid, st)
                 : launch_layout<KPAIRED_SPLIT, 0>(wmap, xmap, smap, zmap, p,
                                                   ntok, grid, st);
  } else if constexpr (KIND == 0) {
    e = launch_layout<TILED, 0>(wmap, xmap, smap, zmap, p, ntok, grid, st);
  } else {
    switch (k1_variant) {
      case 0: e = launch_layout<TILED, K1_PRE[0]>(wmap, xmap, smap, zmap, p, ntok, grid, st); break;
      case 1: e = launch_layout<TILED, K1_PRE[1]>(wmap, xmap, smap, zmap, p, ntok, grid, st); break;
      case 2: e = launch_layout<TILED, K1_PRE[2]>(wmap, xmap, smap, zmap, p, ntok, grid, st); break;
      default: e = launch_layout<TILED, K1_PRE[3]>(wmap, xmap, smap, zmap, p, ntok, grid, st); break;
    }
  }
  if (e || n_slices == 1) return e;
  return launch_combine(p.ws, nullptr, p.bias, p.out, M, N, n_slices, act, st);
}

}  // namespace sm90
}  // namespace tllm
