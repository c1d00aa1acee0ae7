// K8 w4a8_gemm: act(s_act[m] * sum_g [s_g * (xq_g @ q_g) - rowsum(xq_g) *
// s_g * z_g] + b): int4 weights times dynamic per-token int8 activations.
//
// Replaces the TPU kernel tensorrt_llm_tpu/ops/w4a16_gemm.py
// `_w4a8_kernel_tiled` (int8 x int8 -> int32 on the MXU, group scales on
// the accumulator, the per-token scale in the epilogue).
//
// What bounds it on the H100: at decode M (a few rows) the int4 weight and
// its f32 scales and zeros, read once: bytes over 3.35 TB/s.  At prefill M
// (256..512 rows) 2*M*N*K int8 operations over the 1,979 TOPS int8
// tensor-core peak.
//
// Design: the s8 instantiation of the shared Hopper mainloop
// (`w4a16_sm90.cuh`): a ring of 64-K stages filled by TMA from a producer
// warp, consumer warpgroups on wgmma, persistent work units of (M block,
// column tile, K slice), the K slices summed in K order by the mainloop's
// PDL combine pass.
// * Swapped operands.  wgmma m64nNk32.s32.s8.s8 in its RS form: the int4
//   weight tile, 64 output columns x 32 K, is the register A operand; the
//   int8 token tile is the K-major shared-memory B operand (xq [M, K]
//   row-major is K-major, as 8-bit wgmma requires).  Tokens come in tiles
//   NTOK of 8..128 (M blocks of 128 above), with 128 columns a block (two
//   consumer warpgroups) at 128 tokens, 64 below.
// * The weight in registers.  One ldmatrix.x4.trans of a stage's 32
//   packed rows gives each lane, for its output columns 2g and 2g + 1 (the
//   mainloop's column permutation), 16 bytes; two masks and prmts place
//   each nibble in the high half of a byte, 16 q as an s8 (exact: the
//   products are 16 times the integer ones, divided out with the scale).
//   Both packings are read as stored: tiled [N/BN, K/2, BN] (32 packed rows
//   are 64 consecutive K rows, two k32 steps, read in row order), and
//   K-paired [K/2, N] at pack group Gp % 64 == 0 (a stage is 32 packed rows
//   of one pack group: its low nibbles are one k32 step against x[:, c*Gp +
//   p0 ..], its high nibbles the next against x[:, c*Gp + Gp/2 + p0 ..];
//   the ldmatrix rows are permuted so that a lane holds four consecutive
//   rows).  Columns past N (K-paired: any N % 16 == 0) read as zeros and
//   are not stored.
// * x a stage: tiled, one box of 64 K x NTOK tokens in the 64-byte swizzle
//   (a k32 step is half a row, as a k16 step of the bf16 mainloop);
//   K-paired, the two 32-K segments as two boxes in the 32-byte swizzle
//   (one k32 step a row).
// * Exact integer partials per scale group.  A group's products go to
//   int32 accumulators (two chains up to 32 tokens), the first product
//   of a group overwriting them (scale-d 0); after the group's last stage
//   retires, each lane scales its partial by the f32 group scale onto the
//   f32 accumulator, and zero points enter as the rank-1 term
//   rowsum(xq_g) * s_g * z_g, as in the JAX kernel (a group longer than
//   FLUSH_K rows is scaled in parts of FLUSH_K, so that each partial
//   converts to f32 exactly).  The int32 row sums
//   come from the x stage in shared memory (dp4a: thread i of a consumer
//   warpgroup sums token i's 64 bytes a stage in one register; at the
//   group's end the sums go through a shared buffer, one per group parity,
//   to the lanes that hold the tokens, behind one named barrier of the
//   warpgroup; per-lane sums of every token a lane holds cost 32 registers
//   at 128 tokens and made ptxas spill).  A partial is read only once its
//   wgmmas retired and before the next group's first wgmma is issued, so
//   no register of a wgmma in flight is touched.  (Holding a copy aside
//   and scaling it while the next group's wgmmas ran was no faster on the
//   H100: at 128 tokens the epilogue's instructions, not the tensor cores,
//   bound a stage.)
// * K slices fill the card (`ops/w4a16_gemm.py::w4a8_plan`): at decode
//   Llama-3-8B down has 64 column tiles and a K-paired N 80 weight 2; a
//   unit's slice may end inside a scale group (its partial is scaled at
//   the slice's end, which is exact in the integers).  s_act, the bias and
//   the activation are applied once: in the epilogue of a one-slice call,
//   else by the combine pass after the K-ordered sum.
#include "w4a16_sm90.cuh"

namespace tllm {
namespace sm90 {
namespace {

constexpr int W4A8_CONSUMER_REGS = 232;   // with the producer warpgroup

template <int NTOK>
struct Cfg8 {
  static constexpr int NWG = NTOK >= 128 ? 2 : 1;
  static constexpr int COLS = NWG * WG_COLS;
  // at 128 tokens a consumer thread holds 64 f32 sums and 64 int32
  // partials: the producer is a whole warpgroup that hands its registers
  // to the consumers (setmaxnreg, as K1's REGS configuration), else
  // ptxas's cap of 168 made it spill
  static constexpr bool REGS = NTOK >= 128;
  static constexpr int THREADS = NWG * 128 + (REGS ? 128 : 32);
  static constexpr int MIN_BLOCKS = NTOK <= 32 ? 3 : (NWG == 1 ? 2 : 1);
  // int32 accumulator chains: the two k32 steps of a stage in two sets
  // up to 32 tokens, where each wgmma is short
  static constexpr int NACC = NTOK <= 32 ? 2 : 1;
  static constexpr int X_BOX = NTOK * 32;   // 32 int8 x NTOK rows (half x)
  static constexpr int SZ_BOX = COLS * 4;   // one f32 scale row
  // weights, two x boxes, the scale row, the zero row; a multiple of 1 KB
  static constexpr int STAGE_BYTES =
      (NWG * W_BOX + 2 * X_BOX + 2 * SZ_BOX + 1023) / 1024 * 1024;
  static constexpr int STAGES_FIT =
      (MIN_BLOCKS == 3 ? 70 * 1024 : MIN_BLOCKS == 2 ? 100 * 1024 : 215 * 1024) /
      STAGE_BYTES;
  static constexpr int STAGES = STAGES_FIT < 24 ? STAGES_FIT : 24;
  // the ring, its barriers, the row-sum buffers (two per warpgroup), and
  // slack to align the base to 1 KB
  static constexpr int SMEM =
      STAGES * STAGE_BYTES + 2 * STAGES * 8 + NWG * 2 * NTOK * 4 + 1024;
};

struct Params8 {
  const float* s_act;   // [M] per-token activation scales
  const float* bias;
  float* ws;            // [n slices, M, N] f32 partials (n > 1)
  bf16* out;            // [M, N]
  int M, N, K, G;
  int Gp;               // K-paired: pack group (K rows)
  int bn;               // tiled: column tile of the packing
  int act;
  int n_mb, n_ct;
  Slices sl;
};

// A partial covers at most FLUSH_K rows of K, so |16 q x| sums to at most
// 256 * 16 * 8 * 127 < 2^22 and converts to f32 exactly
constexpr int FLUSH_K = 256;

template <int NTOK, bool KP, bool HAS_Z>
__global__ void __launch_bounds__(Cfg8<NTOK>::THREADS, Cfg8<NTOK>::MIN_BLOCKS)
    w4a8_sm90_kernel(const __grid_constant__ CUtensorMap wmap,
                     const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap smap,
                     const __grid_constant__ CUtensorMap zmap,
                     const __grid_constant__ Params8 p) {
  using C = Cfg8<NTOK>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + C::STAGES * C::STAGE_BYTES);
  uint64_t* empty = full + C::STAGES;
  float* rs_buf = reinterpret_cast<float*>(empty + C::STAGES);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], C::NWG * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  const int n_tiles = p.n_mb * p.n_ct;
  const int n_units = n_tiles * p.sl.n;
  const int spg = KP ? p.Gp / STAGE_K : 1;   // stages per pack group
  const bool per_channel = p.G >= p.K;
  const int sgr = p.G / STAGE_K;             // stages per scale group
  // stages per partial: a scale group, or FLUSH_K rows of a longer one
  // (its partials scaled by the same s, each exactly converted)
  const int sfl = (p.G < FLUSH_K ? p.G : FLUSH_K) / STAGE_K;

  if (warp >= C::NWG * 4) {
    // -------------------------------------------------------- producer ---
    if constexpr (C::REGS) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    }
    if (warp != C::NWG * 4 || lane != 0) return;
    int slot = 0;
    uint32_t phase = 0;
    for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
      const int s = u / n_tiles, tile = u % n_tiles;
      const int m0 = (tile / p.n_ct) * NTOK;
      const int col0 = (tile % p.n_ct) * C::COLS;
      const int st0 = p.sl.start[s], st1 = p.sl.start[s + 1];
      // the unit's weight boxes, x offsets and scale group, set once and
      // advanced stage by stage (a division by a run-time value in every
      // stage is a long dependent chain on the one issuing thread)
      int wx[C::NWG], wy[C::NWG];
#pragma unroll
      for (int wg = 0; wg < C::NWG; ++wg) {
        const int cw = col0 + wg * WG_COLS;
        wx[wg] = KP ? cw : cw % p.bn;
        wy[wg] = (KP ? 0 : (cw / p.bn) * (p.K / 2)) + st0 * STAGE_PR;
      }
      int grp = per_channel ? 0 : st0 / sgr;
      int grp_left = per_channel ? st1 - st0 : sgr - st0 % sgr;
      int kc = KP ? st0 / spg : 0, kin = KP ? st0 % spg : 0;
      for (int st = st0; st < st1; ++st) {
        mbar_wait(&empty[slot], phase ^ 1);
        mbar_expect_tx(&full[slot], C::NWG * W_BOX + 2 * C::X_BOX +
                                        (HAS_Z ? 2 : 1) * C::SZ_BOX);
        uint8_t* stage = ring + slot * C::STAGE_BYTES;
        // K-paired: pack group kc, its stage kin; else 64 contiguous K
        const int kx0 = KP ? kc * p.Gp + kin * STAGE_PR : st * STAGE_K;
        const int kx1 = kx0 + (KP ? p.Gp / 2 : STAGE_K / 2);
#pragma unroll
        for (int wg = 0; wg < C::NWG; ++wg) {
          tma_load_2d(stage + wg * W_BOX, &wmap, wx[wg], wy[wg], &full[slot]);
          wy[wg] += STAGE_PR;
        }
        uint8_t* xs = stage + C::NWG * W_BOX;
        tma_load_2d(xs, &xmap, kx0, m0, &full[slot]);
        if (KP) tma_load_2d(xs + C::X_BOX, &xmap, kx1, m0, &full[slot]);
        // a stage lies in one scale group (G % 64 == 0)
        tma_load_2d(xs + 2 * C::X_BOX, &smap, col0, grp, &full[slot]);
        if (HAS_Z)
          tma_load_2d(xs + 2 * C::X_BOX + C::SZ_BOX, &zmap, col0, grp,
                      &full[slot]);
        if (--grp_left == 0) {
          ++grp;
          grp_left = sgr;
        }
        if (KP && ++kin == spg) {
          kin = 0;
          ++kc;
        }
        if (++slot == C::STAGES) {
          slot = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ------------------------------------------------------- consumers ---
  if constexpr (C::REGS) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(W4A8_CONSUMER_REGS)
                 : "memory");
  }
  const int wg = warp >> 2, wl = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  // ldmatrix row of this lane (matrix i = lane / 8): tiled rows in order
  // (a lane then holds rows 8i + 2t, 8i + 2t + 1: K 16i + 4t .. + 3);
  // K-paired rows permuted so that matrices 0 and 1 give a lane rows 4t,
  // 4t + 1 and 4t + 2, 4t + 3 (matrices 2 and 3 the same 16 rows on)
  const int mi = lane >> 3, mj = lane & 7;
  const int lrow = KP ? 16 * (mi >> 1) + 2 * mj - (mj & 1) + 2 * (mi & 1)
                      : 8 * mi + mj;
  const uint32_t lds_off =
      wg * W_BOX + lrow * 64 + 16 * (wl ^ ((lrow >> 1) & 3));
  const int tw = threadIdx.x & 127;   // thread of the warpgroup: its token
  float acc[NTOK / 2];
  int part[C::NACC][NTOK / 2];
  int rsum = 0;                // HAS_Z: token tw's row sum in the group
  int rs_par = 0;              // the group's row-sum buffer
  uint32_t a0[2][4], a1[2][4];
  int slot = 0;
  uint32_t phase = 0;
  for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
    const int s = u / n_tiles, tile = u % n_tiles;
    const int m0 = (tile / p.n_ct) * NTOK;
    const int c = (tile % p.n_ct) * C::COLS + wg * WG_COLS + wl * 16 + 2 * g;
    const bool col_ok = c < p.N;
#pragma unroll
    for (int i = 0; i < NTOK / 2; ++i) acc[i] = 0.f;
    float2 sc = make_float2(0.f, 0.f), zc = make_float2(0.f, 0.f);
    // wait for the next stage and turn its weight bytes into the A
    // fragments of its two k32 steps
    auto load = [&](uint32_t (&a)[2][4]) -> int {
      const int my = slot;
      mbar_wait(&full[slot], phase);
      uint32_t r[4];
      ldmatrix_x4_trans(
          r, reinterpret_cast<const bf16*>(ring + slot * C::STAGE_BYTES + lds_off));
      uint32_t lo[4], hi[4];   // low / high nibbles in the bytes' high halves
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        lo[i] = (r[i] << 4) & 0xF0F0F0F0u;
        hi[i] = r[i] & 0xF0F0F0F0u;
      }
      if (KP) {
        // step 0: low nibbles of rows 4t..4t+3 (and 16 + ...), step 1 high
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const uint32_t* v = q ? hi : lo;
          a[q][0] = prmt(v[0], v[1], 0x6420);
          a[q][1] = prmt(v[0], v[1], 0x7531);
          a[q][2] = prmt(v[2], v[3], 0x6420);
          a[q][3] = prmt(v[2], v[3], 0x7531);
        }
      } else {
        // byte j of r[i]: K 16i + 4t + 2(j / 2) (low nibble) and + 1
        // (high) of column 2g (j even) or 2g + 1
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          a[q][0] = prmt(lo[2 * q], hi[2 * q], 0x6240);
          a[q][1] = prmt(lo[2 * q], hi[2 * q], 0x7351);
          a[q][2] = prmt(lo[2 * q + 1], hi[2 * q + 1], 0x6240);
          a[q][3] = prmt(lo[2 * q + 1], hi[2 * q + 1], 0x7351);
        }
      }
      if (++slot == C::STAGES) {
        slot = 0;
        phase ^= 1;
      }
      return my;
    };
    // issue the stage's two k32 steps; the first stage of a group
    // overwrites the partials
    auto mma = [&](uint32_t (&a)[2][4], int sl, bool first) {
      const uint32_t xb = smem_u32(ring + sl * C::STAGE_BYTES + C::NWG * W_BOX);
#pragma unroll
      for (int k = 0; k < C::NACC; ++k) keep_all(part[k]);
      keep_all(a);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 2; ++j)
        WgmmaS8<NTOK>::mma(part[j % C::NACC], a[j],
                           KP ? desc_b32(xb + j * C::X_BOX) : desc_b64(xb + 32 * j),
                           first && j < C::NACC ? 0 : 1);
      wgmma_commit();
    };
    // while the stage's wgmmas run: its row sums and its scale row
    auto side = [&](int sl, bool last) {
      const uint8_t* stage = ring + sl * C::STAGE_BYTES;
      const uint8_t* xs = stage + C::NWG * W_BOX;
      if (HAS_Z && tw < NTOK) {
        int r4[4] = {0, 0, 0, 0};   // four chains, not one of 16 dp4a
        // token tw's 64 bytes: its 32-byte row of each box, or its 64-byte
        // row of the one box (a swizzle only permutes 16-byte chunks within
        // a row)
#pragma unroll
        for (int b = 0; b < 2; ++b)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint4 v = *reinterpret_cast<const uint4*>(
                xs + (KP ? b * C::X_BOX + tw * 32 + 16 * h
                         : tw * 64 + 32 * b + 16 * h));
            r4[2 * b + h] = __dp4a((int)v.x, 0x01010101, r4[2 * b + h]);
            r4[2 * b + h] = __dp4a((int)v.y, 0x01010101, r4[2 * b + h]);
            r4[2 * b + h] = __dp4a((int)v.z, 0x01010101, r4[2 * b + h]);
            r4[2 * b + h] = __dp4a((int)v.w, 0x01010101, r4[2 * b + h]);
          }
        rsum += (r4[0] + r4[1]) + (r4[2] + r4[3]);
      }
      if (last) {
        const int off = 4 * (wg * WG_COLS + wl * 16 + 2 * g);
        sc = *reinterpret_cast<const float2*>(xs + 2 * C::X_BOX + off);
        if (HAS_Z)
          zc = *reinterpret_cast<const float2*>(xs + 2 * C::X_BOX + C::SZ_BOX +
                                                off);
      }
    };
    auto retire = [&](uint32_t (&a)[2][4], int sl) {
      wgmma_wait<0>();
      keep_all(a);
#pragma unroll
      for (int k = 0; k < C::NACC; ++k) keep_all(part[k]);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[sl]);
    };
    // the retired partial onto the f32 accumulator
    auto group_end = [&]() {
      const float s0 = sc.x * 0.0625f, s1 = sc.y * 0.0625f;   // 16 q
      const float sz0 = sc.x * zc.x, sz1 = sc.y * zc.y;
      float* rb = rs_buf + (wg * 2 + rs_par) * NTOK;
      if (HAS_Z) {
        // the buffer of this parity was last read a group ago, before the
        // barrier of the group between; converted once by its owner (a
        // conversion per lane and token runs at a quarter of the FP32
        // rate)
        if (tw < NTOK) rb[tw] = (float)rsum;
        rsum = 0;
        rs_par ^= 1;
        named_sync(1 + wg, 128);
      }
#pragma unroll
      for (int j = 0; j < NTOK / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int v0 = part[0][4 * j + h], v1 = part[0][4 * j + 2 + h];
          if (C::NACC == 2) {
            v0 += part[C::NACC - 1][4 * j + h];
            v1 += part[C::NACC - 1][4 * j + 2 + h];
          }
          float a0_ = fmaf(__int2float_rn(v0), s0, acc[4 * j + h]);
          float a1_ = fmaf(__int2float_rn(v1), s1, acc[4 * j + 2 + h]);
          if (HAS_Z) {
            const float rs = rb[8 * j + 2 * t + h];
            a0_ = fmaf(-rs, sz0, a0_);
            a1_ = fmaf(-rs, sz1, a1_);
          }
          acc[4 * j + h] = a0_;
          acc[4 * j + 2 + h] = a1_;
        }
    };
    const int st_end = p.sl.start[s + 1];
    int st = p.sl.start[s];
    // the last stage of a partial (a scale group, or FLUSH_K rows of a
    // longer one) or of the unit's slice: a count of the partial's stages
    // left, set once a unit (no division a stage)
    int left = sfl - st % sfl;
    auto last_of = [&](int k) {
      if (k + 1 == st_end) return true;
      if (--left) return false;
      left = sfl;
      return true;
    };
    bool first = true;
    int cur = load(a0);
    for (; st < st_end; st += 2) {
      bool last = last_of(st);
      mma(a0, cur, first);
      side(cur, last);
      const int nx = st + 1 < st_end ? load(a1) : -1;
      retire(a0, cur);
      if (last) group_end();
      first = last;
      if (nx < 0) break;
      last = last_of(st + 1);
      mma(a1, nx, first);
      side(nx, last);
      cur = st + 2 < st_end ? load(a0) : -1;
      retire(a1, nx);
      if (last) group_end();
      first = last;
    }
    // epilogue: lane holds columns (c, c + 1) of tokens 8j + 2t (+1)
    if (!col_ok) continue;
    if (p.sl.n > 1) {
#pragma unroll
      for (int j = 0; j < NTOK / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + 8 * j + 2 * t + h;
          if (m < p.M)
            *reinterpret_cast<float2*>(p.ws + ((size_t)s * p.M + m) * p.N + c) =
                make_float2(acc[4 * j + h], acc[4 * j + 2 + h]);
        }
      continue;
    }
    // one slice: s_act, bias and the activation here, the activation
    // chosen once, not per stored value
    auto store = [&](auto act_c) {
      constexpr int ACT = decltype(act_c)::value;
      float b0 = 0.f, b1 = 0.f;
      if (p.bias != nullptr) {
        b0 = p.bias[c];
        b1 = p.bias[c + 1];
      }
#pragma unroll
      for (int j = 0; j < NTOK / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + 8 * j + 2 * t + h;
          if (m >= p.M) continue;
          const float sa = p.s_act[m];
          *reinterpret_cast<__nv_bfloat162*>(p.out + (size_t)m * p.N + c) =
              __floats2bfloat162_rn(activate<ACT>(acc[4 * j + h] * sa + b0),
                                    activate<ACT>(acc[4 * j + 2 + h] * sa + b1));
        }
    };
    switch (p.act) {
      case ACT_SILU: store(std::integral_constant<int, ACT_SILU>()); break;
      case ACT_GELU: store(std::integral_constant<int, ACT_GELU>()); break;
      case ACT_RELU: store(std::integral_constant<int, ACT_RELU>()); break;
      case ACT_RELU2: store(std::integral_constant<int, ACT_RELU2>()); break;
      default: store(std::integral_constant<int, ACT_NONE>()); break;
    }
  }
}

template <int NTOK, bool KP, bool HAS_Z>
int launch8(const CUtensorMap& wmap, const CUtensorMap& xmap,
            const CUtensorMap& smap, const CUtensorMap& zmap,
            const Params8& p, int grid, cudaStream_t st) {
  using C = Cfg8<NTOK>;
  auto kernel = w4a8_sm90_kernel<NTOK, KP, HAS_Z>;
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

template <bool KP, bool HAS_Z>
int launch8_ntok(const CUtensorMap& wmap, const CUtensorMap& xmap,
                 const CUtensorMap& smap, const CUtensorMap& zmap,
                 const Params8& p, int ntok, int grid, cudaStream_t st) {
  switch (ntok) {
    case 8: return launch8<8, KP, HAS_Z>(wmap, xmap, smap, zmap, p, grid, st);
    case 16: return launch8<16, KP, HAS_Z>(wmap, xmap, smap, zmap, p, grid, st);
    case 32: return launch8<32, KP, HAS_Z>(wmap, xmap, smap, zmap, p, grid, st);
    case 64: return launch8<64, KP, HAS_Z>(wmap, xmap, smap, zmap, p, grid, st);
    case 128: return launch8<128, KP, HAS_Z>(wmap, xmap, smap, zmap, p, grid, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace sm90
}  // namespace tllm

// The wrapper (`ops/w4a16_gemm.py::w4a8_gemm`) guarantees: K % 64 == 0, G
// % 64 == 0 (or one group), contiguous 16-byte aligned operands, and
// either the tiled packing (pack_group 0, block_n % 64 == 0 dividing N) or
// the K-paired one (N % 16 == 0, pack_group % 64 == 0 dividing G, or K
// for one group); ntok in {8, ..., 128} with n_mb M blocks and n_ct
// column tiles (64 columns, 128 at ntok 128) covering M and N; slices of
// whole 64-row stages covering K; a workspace of n_slices * M * N floats
// when n_slices > 1.
extern "C" int tllm_w4a8_gemm(const void* xq, const void* s_act,
                              const void* qweight, const void* scales,
                              const void* zeros, const void* bias,
                              void* workspace, void* out, int M, int N, int K,
                              int group, int block_n, int pack_group, int act,
                              int ntok, int n_mb, int n_ct,
                              const int* slice_start, int n_slices, int grid,
                              void* stream) {
  using namespace tllm::sm90;
  if (n_slices < 1 || n_slices > MAX_SLICES) return (int)cudaErrorInvalidValue;
  Params8 p = {};
  p.s_act = static_cast<const float*>(s_act);
  p.bias = static_cast<const float*>(bias);
  p.ws = static_cast<float*>(workspace);
  p.out = static_cast<tllm::bf16*>(out);
  p.M = M;
  p.N = N;
  p.K = K;
  p.G = group;
  p.Gp = pack_group;
  p.bn = block_n;
  p.act = n_slices == 1 ? act : tllm::ACT_NONE;
  p.n_mb = n_mb;
  p.n_ct = n_ct;
  p.sl.n = n_slices;
  for (int i = 0; i <= n_slices; ++i) p.sl.start[i] = slice_start[i];
  const bool kp = pack_group != 0;
  CUtensorMap wmap, xmap, smap, zmap;
  int e = kp ? tensor_map_2d(&wmap, qweight, CU_TENSOR_MAP_DATA_TYPE_UINT8, N,
                             K / 2, N, WG_COLS, STAGE_PR)
             : tensor_map_2d(&wmap, qweight, CU_TENSOR_MAP_DATA_TYPE_UINT8,
                             block_n, (uint64_t)(N / block_n) * (K / 2),
                             block_n, WG_COLS, STAGE_PR);
  if (e) return e;
  // xq [M, K] int8: K-paired, boxes of 32 K x ntok tokens in the 32-byte
  // swizzle; tiled, one box of 64 K in the 64-byte swizzle
  e = kp ? tensor_map_2d(&xmap, xq, CU_TENSOR_MAP_DATA_TYPE_UINT8, K, M, K,
                         32, ntok, CU_TENSOR_MAP_SWIZZLE_32B)
         : tensor_map_2d(&xmap, xq, CU_TENSOR_MAP_DATA_TYPE_UINT8, K, M, K,
                         64, ntok, CU_TENSOR_MAP_SWIZZLE_64B);
  if (e) return e;
  const int cols = ntok >= 128 ? 2 * WG_COLS : WG_COLS;
  const int n_groups = group < K ? K / group : 1;
  e = tensor_map_2d(&smap, scales, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, N,
                    n_groups, (uint64_t)N * 4, cols, 1,
                    CU_TENSOR_MAP_SWIZZLE_NONE);
  if (e) return e;
  zmap = smap;
  if (zeros != nullptr) {
    e = tensor_map_2d(&zmap, zeros, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, N,
                      n_groups, (uint64_t)N * 4, cols, 1,
                      CU_TENSOR_MAP_SWIZZLE_NONE);
    if (e) return e;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool z = zeros != nullptr;
  if (kp)
    e = z ? launch8_ntok<true, true>(wmap, xmap, smap, zmap, p, ntok, grid, st)
          : launch8_ntok<true, false>(wmap, xmap, smap, zmap, p, ntok, grid, st);
  else
    e = z ? launch8_ntok<false, true>(wmap, xmap, smap, zmap, p, ntok, grid, st)
          : launch8_ntok<false, false>(wmap, xmap, smap, zmap, p, ntok, grid, st);
  if (e || n_slices == 1) return e;
  return launch_combine(p.ws, p.s_act, p.bias, p.out, M, N, n_slices, act, st);
}
