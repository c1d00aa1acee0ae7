// K14 w4a16_fused_mlp: a whole gated MLP in one launch,
//   out = down(act(x @ gate + b_g) * (x @ up + b_u)) + b_down,
// with W4A16 gate/up/down weights in the tiled packing.
//
// Replaces the TPU kernel tensorrt_llm_tpu/ops/w4a16_fused.py
// `_fused_mlp_kernel` (one pallas_call over all three weight streams, the
// next phase's first block riding the previous one's prologue).  Layouts
// are the JAX op's: gu [2I/BN, K/2, BN] with the gate columns first
// ([gate | up]), scales [K/G, 2I]; down [K/BNd, I/2, BNd], scales [I/G, K];
// bf16 scales and zeros, f32 biases.
//
// What bounds it on the H100: at decode the (K*2I + I*K)/2 weight bytes
// over 3.35 TB/s (2*M operations a weight byte, far below the ~295
// op/byte ridge); at a 200-token chunk the tensor work.  Reaching the
// bytes bound takes megabytes in flight across the card and few
// instructions per byte, with the grid-wide dependency (phase B needs all
// of h) costing as little of the stream as possible.
//
// Design (sm_90a: TMA, bulk copies, mbarriers, clusters, mma.sync):
//
// * One cooperative launch of a persistent grid of thread block clusters
//   (up to 16 blocks), every block co-resident; one device operation a
//   call (no memset, no combine pass).  A block is four consumer warps and
//   one producer warp.
// * Phase A items are (M block, CT gate columns with the same CT up
//   columns, K slice of whole scale groups); phase B items (M block, CT
//   down columns, I slice).  The SA (SB) slices of one item are SA blocks
//   of one cluster (a cluster runs C / SA items at once), so a 4-token
//   decode call has items for every SM in both phases.  Items are walked
//   in rounds, the M block fastest, so that clusters running at once share
//   a weight tile in L2 at prefill.  `fused_mlp_plan` (ops/w4a16_fused.py)
//   picks the token tile, CT, the cluster and SA, SB.
// * The producer warp streams the weights in the tiled packing's storage
//   order by TMA (one box a weight and stage, 64 * CTW bytes wide, in the
//   swizzle of that width) into a ring of eight 4 KB mbarrier stages
//   (phase A: 2 KB of gate and 2 KB of up rows a stage; phase B: 4 KB of
//   down rows), and each item's x (h) rows, scale rows and zero rows by
//   bulk copies into one of two side slots.  It runs ahead across items
//   and phases: the down weights do not depend on h, so the first ring's
//   worth of phase-B stages is in flight while the block's consumers
//   finish phase A and wait at the grid barrier (the Hopper form of the
//   TPU kernel's prologue ride).  Only the h rows wait: the producer starts
//   them after it has seen the barrier's release.
// * Consumers: K2's form for every token tile (8, 16 or 32 tokens a
//   block, a template argument).  mma.sync m16n8k16 with the weight as the
//   16-row A operand (one ldmatrix.x4.trans of the swizzled stage, one lop3
//   a register: 136 + q exactly) and x^T as B; gate and up share every x
//   fragment.  Each item's x rows are permuted once in shared memory (in
//   the pass that takes their row sums) so that a token tile's B fragment
//   is one 8-byte load.  Each scale group's f32 partial is scaled as the
//   TPU kernel does (partial * s_g), the 136 offset and zero points leave
//   through the x row sums.  A stage's k16 steps are straight-line code
//   where a scale group is whole stages (G a multiple of 2 * SR rows, as
//   the served G 128 is): a branch between steps kept the compiler from
//   overlapping their loads and products.  A warp keeps at least four
//   independent accumulator chains.
// * Slices merge in slice order over distributed shared memory: each
//   block leaves its f32 partial in one of two shared buffers and signals
//   every cluster block's `rdy` mbarrier (release.cluster); after the next
//   round's products (so the hand-over is hidden) each block waits for its
//   own `rdy` (acquire.cluster), sums its share of the outputs over the
//   slices in order, applies the epilogue (phase A: bias, act(g) * u
//   rounded once to bf16 into the h workspace; phase B: bias, bf16 out),
//   and signals `fre` so the buffer may be written again.  The producer
//   warp takes no part, so it never stalls on a merge.  No atomics on
//   data: a second call gives the same bits.
// * The grid barrier between the phases lives in a per-device buffer: a
//   generation word and two arrival counters, one for even and one for odd
//   generations.  Each block adds one to its launch's counter
//   (atom.acq_rel.gpu) and the producers wait for it to reach the grid
//   with ld.acquire.gpu; the last block to arrive zeroes the other counter
//   for the next launch and advances the generation.  No host write, no
//   memset.  Writers of h run fence.proxy.async.global before arriving,
//   since the h rows are read back by bulk copies (the async proxy).
// * With a non-null `stats`, each block records the global timer (ns,
//   FM_NSTAT slots, 0 where a block had no item): its start, its first x
//   rows in shared memory, the end of its last phase-A stage, its arrival
//   at the grid barrier, the release seen by its producer, its first h
//   rows in shared memory, the end of its last phase-B stage, its end.
// * Shared memory is addressed from the `__shared__` array by offsets
//   (a base realigned through an integer address compiled every access to
//   a generic load).
#include <algorithm>
#include <type_traits>

#include "w4a16_sm90.cuh"

namespace tllm {
namespace {

using namespace sm90;

constexpr int FM_CWARPS = 4;                      // consumer warps
constexpr int FM_CTHREADS = FM_CWARPS * 32;
constexpr int FM_THREADS = FM_CTHREADS + 32;      // + a producer warp
constexpr int FM_STAGE = 4096;                    // ring stage bytes
constexpr int FM_NST = 8;                         // ring stages
constexpr int FM_RING = FM_STAGE * FM_NST;
constexpr int FM_MAX_SMEM = 232448;
constexpr int FM_NSTAT = 8;  // timestamps a block records with `stats`
// the grid barrier's words (each on its own 128-byte line): the
// generation, and the arrival counters of even and odd generations
constexpr int FM_GEN = 0;
constexpr int FM_COUNT = 32;

struct FmLayout {
  int slot, x, sc, zs, xsum, ps, ps_bytes, bars, total;
};

// shared memory of a block: the ring at the 1 KB-aligned base; two side
// slots, each x (or h) [mt][xp] bf16 then `nsc` scale rows and as many zero
// rows of ct bf16; the x row sums [ngs][mt] f32; two partial buffers of
// [2][mt][ct] f32; the barriers.  ops/w4a16_fused.py `fused_mlp_smem`
// mirrors it.
__host__ __device__ inline FmLayout fm_layout(int ct, int mt, int xp,
                                              int nsc, int ngs, bool zeros) {
  FmLayout L;
  L.x = 0;
  L.sc = mt * xp * 2;
  L.zs = L.sc + nsc * ct * 2;
  L.slot = ((zeros ? L.zs + nsc * ct * 2 : L.zs) + 15) & ~15;
  int o = FM_RING + 2 * L.slot;
  L.xsum = o;
  o += ngs * mt * 4;
  o = (o + 15) & ~15;
  L.ps = o;
  L.ps_bytes = 2 * mt * ct * 4;
  o += 2 * L.ps_bytes;
  L.bars = o;
  o += (2 * FM_NST + 8) * 8 + 16;
  L.total = o + 1024;   // slack to align the base
  return L;
}

struct FmParams {
  const bf16* x;
  const bf16* gs;     // gate|up scales, zeros, bias
  const bf16* gz;
  const float* gb;
  const bf16* ds;     // down scales, zeros, bias
  const bf16* dz;
  const float* db;
  bf16* h;            // [M, I] workspace
  bf16* out;          // [M, K]
  unsigned* bar;      // [FM_GEN], [FM_COUNT + 32 * (generation & 1)]
  unsigned long long* stats;   // [grid][FM_NSTAT] or null
  int M, K, I, act;
  int GA, GB;         // K (I) rows of a scale group (128 or 64 per channel)
  int sa_row, sb_row; // elements between scale rows (0: per channel)
  int bn_a, bn_d;
  int C, SA, SB;      // cluster size, slices of phase A and B
  int n_mb;           // M blocks
  int xp, nsc, ngs;   // side slot layout (fm_layout)
};

// one work item of a phase: M block, column tile, K (I) slice
struct FmItem {
  int m0, rows, tile, k0, klen, g0, ngs;
};

__device__ __forceinline__ FmItem fm_item(const FmParams& p, int phase,
                                          int mt, int it, int s, int S) {
  FmItem f;
  const int mb = it % p.n_mb;
  f.tile = it / p.n_mb;
  f.m0 = mb * mt;
  f.rows = min(mt, p.M - f.m0);
  const int G = phase == 0 ? p.GA : p.GB;
  const int ng = (phase == 0 ? p.K : p.I) / G;
  f.g0 = s * ng / S;
  const int g1 = (s + 1) * ng / S;
  f.ngs = g1 - f.g0;
  f.k0 = f.g0 * G;
  f.klen = f.ngs * G;
  return f;
}

struct FmPhase {
  int S, items, lanes, rounds, lane, s;
};

__device__ __forceinline__ FmPhase fm_phase(const FmParams& p, int phase,
                                            int ct, int n_cl, int cid,
                                            int rank) {
  FmPhase f;
  f.S = phase == 0 ? p.SA : p.SB;
  const int per = p.C / f.S;   // items a cluster runs at once
  f.items = p.n_mb * ((phase == 0 ? p.I : p.K) / ct);
  f.lanes = n_cl * per;
  f.rounds = (f.items + f.lanes - 1) / f.lanes;
  f.lane = cid * per + rank / f.S;
  f.s = rank % f.S;
  return f;
}

// CTW: 16-column tiles a consumer warp owns per weight (a block: CT = 64 *
// CTW columns); NTT: 8-token tiles (M block 8 * NTT rows)
template <int CTW, int NTT>
__global__ void __launch_bounds__(FM_THREADS, NTT == 1 ? 3 : 2)
    w4a16_fused_mlp_kernel(const __grid_constant__ CUtensorMap amap,
                           const __grid_constant__ CUtensorMap bmap,
                           const FmParams p) {
  constexpr int CT = 64 * CTW;
  constexpr int MT = 8 * NTT;
  // the 1 KB-aligned base as an offset into the shared array, so that the
  // compiler keeps every access a shared-memory one (LDS, not a generic
  // LD through a cast integer address)
  extern __shared__ __align__(1024) uint8_t fm_smem_raw[];
  uint8_t* sm = fm_smem_raw + ((1024 - (smem_u32(fm_smem_raw) & 1023)) & 1023);
  const bool has_z = p.gz != nullptr || p.dz != nullptr;
  const FmLayout L = fm_layout(CT, MT, p.xp, p.nsc, p.ngs, has_z);
  uint8_t* ring = sm;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L.bars);
  uint64_t* empty = full + FM_NST;
  uint64_t* sfull = empty + FM_NST;
  uint64_t* sempty = sfull + 2;
  uint64_t* rdy = sempty + 2;
  uint64_t* fre = rdy + 2;
  unsigned* gen0_s = reinterpret_cast<unsigned*>(fre + 2);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int C = p.C;
  const int cid = blockIdx.x / C, rank = blockIdx.x % C;
  const int n_cl = gridDim.x / C;
  unsigned long long* stats =
      p.stats ? p.stats + (size_t)blockIdx.x * FM_NSTAT : nullptr;

  if (tid == 0) {
    for (int i = 0; i < FM_NST; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], FM_CWARPS);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&sfull[i], 1);
      mbar_init(&sempty[i], FM_CWARPS);
      mbar_init(&rdy[i], C);
      mbar_init(&fre[i], C);
    }
    // the generation before this launch's barrier: read before this
    // block's consumers can arrive
    *gen0_s = ld_acquire_gpu(p.bar + FM_GEN);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (stats) {
      stats[0] = global_ns();
      for (int i = 1; i < FM_NSTAT; ++i) stats[i] = 0;
    }
  }
  __syncthreads();
  cluster_sync();   // every block's barriers exist before any remote arrive
  const unsigned gen0 = *gen0_s;
  // this launch's arrival counter (zeroed by the previous launch)
  unsigned* count = p.bar + FM_COUNT + 32 * (gen0 & 1);

  // ------------------------------------------------------- producer ---
  if (warp == FM_CWARPS) {
    int n = 0, q = 0;           // ring stages and side items started
    int nB0 = -1, qB0 = -1;     // the first phase-B stage and side item
    bool passed = false;
    int n_pend = 0;             // phase-B items whose h rows wait
    FmItem pend[2];
    int pend_slot[2];
    // the h rows of a phase-B item into its side slot (lane m: row m)
    auto load_h = [&](const FmItem& f, int slot) {
      uint8_t* xs = sm + FM_RING + slot * L.slot + L.x;
      uint64_t* bar = &sfull[slot];
      for (int m = lane; m < f.rows; m += 32)
        bulk_load(xs + (size_t)m * p.xp * 2,
                  p.h + (size_t)(f.m0 + m) * p.I + f.k0, f.klen * 2, bar);
    };
    auto pass_barrier = [&]() {
      if (lane == 0) {
        while (ld_acquire_gpu(count) < gridDim.x) __nanosleep(32);
        if (stats) stats[4] = global_ns();
      }
      __syncwarp();
      fence_proxy_async_global();
      passed = true;
      for (int i = 0; i < n_pend; ++i) load_h(pend[i], pend_slot[i]);
      n_pend = 0;
    };
    for (int phase = 0; phase < 2; ++phase) {
      const FmPhase ph = fm_phase(p, phase, CT, n_cl, cid, rank);
      const CUtensorMap* map = phase == 0 ? &amap : &bmap;
      const int SR = (phase == 0 ? 32 : 64) / CTW;   // packed rows a box
      const int nw = phase == 0 ? 2 : 1;              // weights a stage
      for (int r = 0; r < ph.rounds; ++r) {
        const int it = r * ph.lanes + ph.lane;
        if (it >= ph.items) continue;
        const FmItem f = fm_item(p, phase, MT, it, ph.s, ph.S);
        // the side slot: x (h) rows, scale and zero rows
        const int slot = q & 1;
        if (!passed && qB0 >= 0 && q - 2 >= qB0) pass_barrier();
        if (q >= 2) {
          if (lane == 0) mbar_wait(&sempty[slot], ((q >> 1) - 1) & 1);
          __syncwarp();
        }
        const bf16* sc = phase == 0 ? p.gs : p.ds;
        const bf16* zc = phase == 0 ? p.gz : p.dz;
        const int srow = phase == 0 ? p.sa_row : p.sb_row;
        const uint32_t bytes =
            (uint32_t)(f.rows * f.klen * 2 +
                       f.ngs * nw * CT * 2 * (zc != nullptr ? 2 : 1));
        uint8_t* side = sm + FM_RING + slot * L.slot;
        if (lane == 0) mbar_expect_tx(&sfull[slot], bytes);
        __syncwarp();
        for (int i = lane; i < f.ngs * nw; i += 32) {
          const int gi = i / nw, w = i - gi * nw;
          const int col = f.tile * CT + w * p.I;
          const size_t off = (size_t)(f.g0 + gi) * srow + col;
          bulk_load(side + L.sc + i * CT * 2, sc + off, CT * 2, &sfull[slot]);
          if (zc != nullptr)
            bulk_load(side + L.zs + i * CT * 2, zc + off, CT * 2,
                      &sfull[slot]);
        }
        if (phase == 0) {
          for (int m = lane; m < f.rows; m += 32)
            bulk_load(side + L.x + (size_t)m * p.xp * 2,
                      p.x + (size_t)(f.m0 + m) * p.K + f.k0, f.klen * 2,
                      &sfull[slot]);
        } else {
          if (qB0 < 0) qB0 = q;
          if (passed) {
            load_h(f, slot);
          } else {
            pend[n_pend] = f;
            pend_slot[n_pend++] = slot;
          }
        }
        ++q;
        // the weight stages
        if (phase == 1 && nB0 < 0) nB0 = n;
        const int rows = f.klen / 2;
        const int n_st = (rows + SR - 1) / SR;
        const int ld = phase == 0 ? p.K / 2 : p.I / 2;
        const int bn = phase == 0 ? p.bn_a : p.bn_d;
        for (int st = 0; st < n_st; ++st) {
          // a ring slot freed only by a phase-B stage needs h first
          if (!passed && nB0 >= 0 && n - FM_NST >= nB0) pass_barrier();
          if (lane == 0) {
            const int rs = n % FM_NST;
            if (n >= FM_NST) mbar_wait(&empty[rs], ((n / FM_NST) - 1) & 1);
            mbar_expect_tx(&full[rs], FM_STAGE);
            uint8_t* dst = ring + rs * FM_STAGE;
            for (int w = 0; w < nw; ++w) {
              const int col = f.tile * CT + w * p.I;
              const int row = (col / bn) * ld + f.k0 / 2 + st * SR;
              tma_load_2d(dst + w * SR * 64 * CTW, map, col % bn, row,
                          &full[rs]);
            }
          }
          __syncwarp();
          ++n;
        }
      }
    }
    if (!passed) pass_barrier();
    return;
  }

  // ------------------------------------------------------ consumers ---
  const int g = lane >> 2, t = lane & 3;
  // this lane's ldmatrix row (K2's): matrix mi = lane / 8 is (column tile
  // jj, k16 step kk) of an x4 group; rows (0,4,1,5,2,6,3,7)[j] of the
  // 8-row matrix, so that a lane holds packed rows t and t + 4
  const int mi = lane >> 3, mj = lane & 7;
  const int jj = CTW == 1 ? 0 : (mi & 1);
  const int kk = CTW == 1 ? mi : (mi >> 1);
  const int lrow_in = (mj >> 1) + 4 * (mj & 1);
  const int colb = 16 * CTW * warp + 16 * jj;   // the stage's column
  constexpr int KPL = 4 / CTW;   // k16 steps an ldmatrix.x4
  float* xsum = reinterpret_cast<float*>(sm + L.xsum);

  int n = 0, q = 0, rr = 0;   // ring stages, side items, merge rounds
  // A round's merge: wait for every cluster block's partial (`rdy`), sum
  // this block's share of the item's outputs over the slices in slice
  // order, apply the epilogue, then free the buffer (`fre`).  It runs
  // after the next round's products, so the hand-over is hidden.
  struct FmMerge {
    FmItem f;
    int phase, S, s, first, rr;
    bool valid;
  };
  FmMerge pm;
  pm.rr = -1;
  auto merge = [&](const FmMerge& m) {
    const int b = m.rr & 1;
    mbar_wait_cluster(&rdy[b], (m.rr >> 1) & 1);
    if (m.valid) {
      const FmItem& f = m.f;
      const uint32_t ps_addr = smem_u32(sm + L.ps + b * L.ps_bytes);
      for (int e = m.s * FM_CTHREADS + tid; e < MT * CT / 2;
           e += m.S * FM_CTHREADS) {
        const int mr = e / (CT / 2), col = 2 * (e - mr * (CT / 2));
        if (mr >= f.rows) continue;
        const int gcol = f.tile * CT + col;
        const uint32_t a0 = ps_addr + 4 * (mr * CT + col);
        float2 v = make_float2(0.f, 0.f);
        if (m.phase == 0) {
          float2 uvv = make_float2(0.f, 0.f);
          for (int j = 0; j < m.S; ++j) {
            const float2 gv = ld_dsmem_f32x2(a0, m.first + j);
            const float2 uv = ld_dsmem_f32x2(a0 + 4 * MT * CT, m.first + j);
            v.x += gv.x;
            v.y += gv.y;
            uvv.x += uv.x;
            uvv.y += uv.y;
          }
          if (p.gb != nullptr) {
            v.x += p.gb[gcol];
            v.y += p.gb[gcol + 1];
            uvv.x += p.gb[p.I + gcol];
            uvv.y += p.gb[p.I + gcol + 1];
          }
          *reinterpret_cast<uint32_t*>(p.h + (size_t)(f.m0 + mr) * p.I +
                                       gcol) =
              pack_bf16x2(activate_rt(p.act, v.x) * uvv.x,
                          activate_rt(p.act, v.y) * uvv.y);
        } else {
          for (int j = 0; j < m.S; ++j) {
            const float2 dv = ld_dsmem_f32x2(a0, m.first + j);
            v.x += dv.x;
            v.y += dv.y;
          }
          if (p.db != nullptr) {
            v.x += p.db[gcol];
            v.y += p.db[gcol + 1];
          }
          *reinterpret_cast<uint32_t*>(p.out + (size_t)(f.m0 + mr) * p.K +
                                       gcol) = pack_bf16x2(v.x, v.y);
        }
      }
    }
    named_sync(1, FM_CTHREADS);
    if (tid < C) mbar_arrive_cluster(&fre[b], tid);
  };
  for (int phase = 0; phase < 2; ++phase) {
    const FmPhase ph = fm_phase(p, phase, CT, n_cl, cid, rank);
    for (int r = 0; r < ph.rounds; ++r) {
      const int it = r * ph.lanes + ph.lane;
      const bool valid = it < ph.items;
      FmItem f = {};
      const int b = rr & 1, u = rr >> 1;
      float* ps = reinterpret_cast<float*>(sm + L.ps + b * L.ps_bytes);
      // the slices' partials of this round: [weight][MT][CT]
      auto run = [&](auto nw_tag) {
        constexpr int NW = decltype(nw_tag)::value;
        constexpr int SR = (NW == 2 ? 32 : 64) / CTW;
        constexpr int HALF = SR * 64 * CTW;   // one weight's bytes a stage
        constexpr int KPS = SR / 8;   // k16 steps a stage
        const int slot = q & 1;
        const uint8_t* side = sm + FM_RING + slot * L.slot;
        bf16* xs = reinterpret_cast<bf16*>(const_cast<uint8_t*>(side) + L.x);
        const bf16* sc = reinterpret_cast<const bf16*>(side + L.sc);
        const bf16* zs = reinterpret_cast<const bf16*>(side + L.zs);
        const bool hz = (phase == 0 ? p.gz : p.dz) != nullptr;
        const int G = phase == 0 ? p.GA : p.GB;
        mbar_wait(&sfull[slot], (q >> 1) & 1);
        if (tid == 0 && stats && stats[phase ? 5 : 1] == 0)
          stats[phase ? 5 : 1] = global_ns();
        // One pass over the staged x (h) rows: the row sums per scale
        // group (four lanes a (group, row)), and each 16-value chunk put
        // in the order of the mma's B fragment, so that a k16 step reads
        // a token tile's (b0, b1) with one 8-byte load: positions 4t..4t+3
        // hold x[2t], x[2t + 8], x[2t + 1], x[2t + 9]
        for (int i0 = 0; i0 < f.ngs * MT; i0 += FM_CTHREADS / 4) {
          const int i = i0 + warp * 8 + (lane >> 2);
          float a = 0.f;
          const int gi = i / MT, m = i - gi * MT;
          if (i < f.ngs * MT) {
            bf16* xr = xs + m * p.xp + gi * G;
            for (int c = lane & 3; c < G / 16; c += 4) {
              uint4* q2 = reinterpret_cast<uint4*>(xr + 16 * c);
              const uint4 lo = q2[0], hi = q2[1];
              float v[8];
              bf16x8_to_float(lo, v);
              a += ((v[0] + v[1]) + (v[2] + v[3])) +
                   ((v[4] + v[5]) + (v[6] + v[7]));
              bf16x8_to_float(hi, v);
              a += ((v[0] + v[1]) + (v[2] + v[3])) +
                   ((v[4] + v[5]) + (v[6] + v[7]));
              q2[0] = make_uint4(prmt(lo.x, hi.x, 0x5410),
                                 prmt(lo.x, hi.x, 0x7632),
                                 prmt(lo.y, hi.y, 0x5410),
                                 prmt(lo.y, hi.y, 0x7632));
              q2[1] = make_uint4(prmt(lo.z, hi.z, 0x5410),
                                 prmt(lo.z, hi.z, 0x7632),
                                 prmt(lo.w, hi.w, 0x5410),
                                 prmt(lo.w, hi.w, 0x7632));
            }
          }
          a += __shfl_xor_sync(0xffffffffu, a, 1);
          a += __shfl_xor_sync(0xffffffffu, a, 2);
          if ((lane & 3) == 0 && i < f.ngs * MT) xsum[gi * MT + m] = a;
        }
        // generic writes to the slot before the producer's next bulk copy
        // into it (the async proxy)
        fence_proxy_async();
        named_sync(1, FM_CTHREADS);

        // NCH independent mma chains a (weight, column tile, token tile):
        // consecutive k16 steps of a stage alternate between them, so a
        // warp keeps at least four products in flight
        constexpr int NCH = NW * CTW * NTT >= 4 ? 1 : 4 / (NW * CTW * NTT);
        float acc[NW][CTW][NTT][4], part[NCH][NW][CTW][NTT][4];
#pragma unroll
        for (int w = 0; w < NW; ++w)
#pragma unroll
          for (int j = 0; j < CTW; ++j)
#pragma unroll
            for (int tt = 0; tt < NTT; ++tt)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                acc[w][j][tt][e] = 0.f;
#pragma unroll
                for (int c = 0; c < NCH; ++c) part[c][w][j][tt][e] = 0.f;
              }
        const int kpg = G / 16;   // k16 steps a scale group
        // stages a scale group, where it is whole stages (then its slices
        // have no partial stage), else 0
        const int spg = kpg % KPS == 0 ? kpg / KPS : 0;
        int kin = 0, gi = 0;
        // acc = partial * s_g + acc, minus sum(x_g) * s_g * (136 + z_g),
        // the partial summed over the chains in order
        auto flush = [&]() {
#pragma unroll
          for (int w = 0; w < NW; ++w)
#pragma unroll
            for (int j = 0; j < CTW; ++j) {
              const int cl = (gi * NW + w) * CT + 16 * CTW * warp + 16 * j +
                             2 * g;
              const float2 sv = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(sc + cl));
              float z0 = 136.f, z1 = 136.f;
              if (hz) {
                const float2 zv = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(zs + cl));
                z0 += zv.x;
                z1 += zv.y;
              }
              const float sz0 = sv.x * z0, sz1 = sv.y * z1;
#pragma unroll
              for (int tt = 0; tt < NTT; ++tt) {
                float* a = acc[w][j][tt];
                float qv[4];
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  qv[e] = part[0][w][j][tt][e];
#pragma unroll
                  for (int c = 1; c < NCH; ++c) qv[e] += part[c][w][j][tt][e];
#pragma unroll
                  for (int c = 0; c < NCH; ++c) part[c][w][j][tt][e] = 0.f;
                }
                const float2 xv = *reinterpret_cast<const float2*>(
                    xsum + gi * MT + 8 * tt + 2 * t);
                a[0] = fmaf(qv[0], sv.x, a[0]) - xv.x * sz0;
                a[1] = fmaf(qv[1], sv.x, a[1]) - xv.y * sz0;
                a[2] = fmaf(qv[2], sv.y, a[2]) - xv.x * sz1;
                a[3] = fmaf(qv[3], sv.y, a[3]) - xv.y * sz1;
              }
            }
        };
        // one k16 step: B from the permuted x (K2's pairing to the nibble
        // order), A from each weight's column tiles; with `chk`, the step
        // ends the scale group when it is the group's last
        auto kstep = [&](const uint32_t (&r)[NW][4], int uu, int kl, int c,
                         bool chk) {
          uint32_t b0[NTT], b1[NTT];
#pragma unroll
          for (int tt = 0; tt < NTT; ++tt) {
            const uint2 bb = *reinterpret_cast<const uint2*>(
                xs + (g + 8 * tt) * p.xp + kl + 4 * t);
            b0[tt] = bb.x;
            b1[tt] = bb.y;
          }
#pragma unroll
          for (int w = 0; w < NW; ++w)
#pragma unroll
            for (int j = 0; j < CTW; ++j) {
              const uint32_t v = r[w][CTW == 1 ? uu : 2 * uu + j];
              uint32_t a[4];
              a[0] = nib2_136(v);
              a[1] = nib2_136(v >> 8);
              a[2] = nib2_136(v >> 4);
              a[3] = nib2_136(v >> 12);
#pragma unroll
              for (int tt = 0; tt < NTT; ++tt)
                mma_bf16_16816(part[c][w][j][tt], a, b0[tt], b1[tt]);
            }
          if (chk && ++kin == kpg) {
            flush();
            kin = 0;
            ++gi;
          }
        };
        auto lds_off = [&](int q4) {
          const int lrow = 8 * (q4 * KPL + kk) + lrow_in;
          // a box row is 64 * CTW bytes in the 64 * CTW-byte swizzle
          if (CTW == 2) return lrow * 128 + 16 * ((colb >> 4) ^ (lrow & 7));
          return lrow * 64 + 16 * ((colb >> 4) ^ ((lrow >> 1) & 3));
        };
        const int rows = f.klen / 2;
        const int n_st = (rows + SR - 1) / SR;
        for (int st = 0; st < n_st; ++st, ++n) {
          const int rs = n % FM_NST;
          mbar_wait(&full[rs], (n / FM_NST) & 1);
          const uint8_t* stage = ring + rs * FM_STAGE;
          const int nv = min(KPS, (rows - st * SR) / 8);   // k16 steps
          if (nv == KPS) {
            uint32_t rg[KPS / KPL][NW][4];
#pragma unroll
            for (int q4 = 0; q4 < KPS / KPL; ++q4)
#pragma unroll
              for (int w = 0; w < NW; ++w)
                ldmatrix_x4_trans(rg[q4][w], reinterpret_cast<const bf16*>(
                                      stage + w * HALF + lds_off(q4)));
            if (spg) {
              // straight-line k16 steps (a branch between them would keep
              // the compiler from overlapping their loads and products);
              // the scale group ends at a stage boundary
#pragma unroll
              for (int q4 = 0; q4 < KPS / KPL; ++q4)
#pragma unroll
                for (int uu = 0; uu < KPL; ++uu)
                  kstep(rg[q4], uu, 16 * (st * KPS + q4 * KPL + uu),
                        (q4 * KPL + uu) % NCH, false);
              if (++kin == spg) {
                flush();
                kin = 0;
                ++gi;
              }
            } else {
#pragma unroll
              for (int q4 = 0; q4 < KPS / KPL; ++q4)
#pragma unroll
                for (int uu = 0; uu < KPL; ++uu)
                  kstep(rg[q4], uu, 16 * (st * KPS + q4 * KPL + uu),
                        (q4 * KPL + uu) % NCH, true);
            }
          } else {
            for (int q4 = 0; q4 * KPL < nv; ++q4) {
              uint32_t rg[NW][4];
#pragma unroll
              for (int w = 0; w < NW; ++w)
                ldmatrix_x4_trans(rg[w], reinterpret_cast<const bf16*>(
                                             stage + w * HALF +
                                             lds_off(q4)));
#pragma unroll
              for (int uu = 0; uu < KPL; ++uu)
                if (q4 * KPL + uu < nv)
                  kstep(rg, uu, 16 * (st * KPS + q4 * KPL + uu), 0,
                        true);
            }
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[rs]);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&sempty[slot]);
        if (tid == 0 && stats) stats[phase ? 6 : 2] = global_ns();
        ++q;
        // the partial of this slice: lane columns (cl, cl + 1) of each
        // tile, tokens 2t, 2t + 1 of each token tile: acc (0, 2), (1, 3)
        if (rr >= 2) mbar_wait_cluster(&fre[b], (u - 1) & 1);
#pragma unroll
        for (int w = 0; w < NW; ++w)
#pragma unroll
          for (int j = 0; j < CTW; ++j)
#pragma unroll
            for (int tt = 0; tt < NTT; ++tt) {
              const int col = 16 * CTW * warp + 16 * j + 2 * g;
              const int m0 = 8 * tt + 2 * t;
              float* pw = ps + w * MT * CT;
              *reinterpret_cast<float2*>(pw + m0 * CT + col) =
                  make_float2(acc[w][j][tt][0], acc[w][j][tt][2]);
              *reinterpret_cast<float2*>(pw + (m0 + 1) * CT + col) =
                  make_float2(acc[w][j][tt][1], acc[w][j][tt][3]);
            }
      };
      if (valid) {
        f = fm_item(p, phase, MT, it, ph.s, ph.S);
        if (phase == 0)
          run(std::integral_constant<int, 2>());
        else
          run(std::integral_constant<int, 1>());
      } else if (rr >= 2) {
        mbar_wait_cluster(&fre[b], (u - 1) & 1);
      }
      // hand the partials over: every cluster block's `rdy` (the arrive
      // releases what this block's consumers wrote before the named
      // barrier); then merge the previous round
      named_sync(1, FM_CTHREADS);
      if (tid < C) mbar_arrive_cluster(&rdy[b], tid);
      if (pm.rr >= 0) merge(pm);
      pm.f = f;
      pm.phase = phase;
      pm.S = ph.S;
      pm.s = ph.s;
      pm.first = (rank / ph.S) * ph.S;
      pm.rr = rr;
      pm.valid = valid;
      ++rr;
    }
    if (pm.rr >= 0) {   // the phase's last round
      merge(pm);
      pm.rr = -1;
    }
    if (phase == 0) {
      // h is written (by bulk copies read back): the grid barrier
      fence_proxy_async_global();
      named_sync(1, FM_CTHREADS);
      if (tid == 0) {
        if (stats) stats[3] = global_ns();
        // the last arrival zeroes the next launch's counter and advances
        // the generation (every block read it before arriving)
        if (atom_add_acq_rel_gpu(count, 1u) == gridDim.x - 1) {
          st_relaxed_gpu(p.bar + FM_COUNT + 32 * ((gen0 + 1u) & 1), 0u);
          st_relaxed_gpu(p.bar + FM_GEN, gen0 + 1u);
        }
      }
    }
  }
  // no block leaves while another may still read its partials
  for (int k = rr >= 2 ? rr - 2 : 0; k < rr; ++k)
    mbar_wait_cluster(&fre[k & 1], (k >> 1) & 1);
  if (tid == 0 && stats) stats[7] = global_ns();
}

template <int CTW, int NTT>
struct FmLaunch {
  static int prepare() {
    static int err = -1;
    if (err < 0) {
      auto kernel = w4a16_fused_mlp_kernel<CTW, NTT>;
      cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, FM_MAX_SMEM);
      if (e == cudaSuccess)   // clusters of up to 16 blocks
        e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      err = (int)e;
    }
    return err;
  }
  static void config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr,
                     int C, int grid, int smem, cudaStream_t st) {
    cfg = {};
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(FM_THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    attr[1].id = cudaLaunchAttributeCooperative;
    attr[1].val.cooperative = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 2;
  }
  // clusters of C blocks the card runs at once at `smem` bytes a block
  static int clusters(int C, int smem, int* out) {
    int e = prepare();
    if (e) return e;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[2];
    config(cfg, attr, C, C, smem, 0);
    cfg.numAttrs = 1;
    return (int)cudaOccupancyMaxActiveClusters(
        out, w4a16_fused_mlp_kernel<CTW, NTT>, &cfg);
  }
  static int launch(const CUtensorMap& amap, const CUtensorMap& bmap,
                    const FmParams& p, int grid, int smem, cudaStream_t st) {
    int e = prepare();
    if (e) return e;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[2];
    config(cfg, attr, p.C, grid, smem, st);
    return (int)cudaLaunchKernelEx(&cfg, w4a16_fused_mlp_kernel<CTW, NTT>,
                                   amap, bmap, p);
  }
};

}  // namespace
}  // namespace tllm

#define TLLM_FM_DISPATCH(CALL)                                      \
  switch (ctw * 8 + ntt) {                                          \
    case 8 + 1: return tllm::FmLaunch<1, 1>::CALL;                  \
    case 8 + 2: return tllm::FmLaunch<1, 2>::CALL;                  \
    case 8 + 4: return tllm::FmLaunch<1, 4>::CALL;                  \
    case 16 + 1: return tllm::FmLaunch<2, 1>::CALL;                 \
    case 16 + 2: return tllm::FmLaunch<2, 2>::CALL;                 \
    case 16 + 4: return tllm::FmLaunch<2, 4>::CALL;                 \
    default: return (int)cudaErrorInvalidValue;                     \
  }

// Clusters of `cluster` blocks of the (ctw, ntt) instance the card runs at
// once with `smem` bytes of shared memory a block (the co-resident bound
// of the cooperative launch).
extern "C" int tllm_w4a16_fused_mlp_clusters(int ctw, int ntt, int cluster,
                                             int smem, int* out) {
  TLLM_FM_DISPATCH(clusters(cluster, smem, out))
}

// The wrapper (`fused_mlp_launch`) guarantees: K, I multiples of 64 * ctw
// and of 64, block_n and down_block_n multiples of 64 * ctw, gu_group and
// down_group (the rows a scale row covers, 128 or 64 per channel, with
// *_row_stride 0) multiples of 32 dividing K and I, sa and sb dividing
// cluster <= 16, each at most the groups of its K, h [M, I] bf16, a
// barrier buffer of 128 words that is zero before the first launch and is
// used by one launch at a time, grid = clusters x cluster within the
// co-resident bound, x and the packed weights 16-byte aligned.
extern "C" int tllm_w4a16_fused_mlp(
    const void* x, const void* gu_q, const void* gu_s, const void* gu_z,
    const void* gu_b, const void* d_q, const void* d_s, const void* d_z,
    const void* d_b, void* h, void* bar, void* stats, void* out, int M,
    int K, int I, int gu_group, int down_group, int gu_row_stride,
    int down_row_stride, int gu_block_n, int down_block_n, int act, int ctw,
    int ntt, int cluster, int sa, int sb, int grid, void* stream) {
  using namespace tllm;
  using namespace tllm::sm90;
  FmParams p;
  p.x = static_cast<const bf16*>(x);
  p.gs = static_cast<const bf16*>(gu_s);
  p.gz = static_cast<const bf16*>(gu_z);
  p.gb = static_cast<const float*>(gu_b);
  p.ds = static_cast<const bf16*>(d_s);
  p.dz = static_cast<const bf16*>(d_z);
  p.db = static_cast<const float*>(d_b);
  p.h = static_cast<bf16*>(h);
  p.out = static_cast<bf16*>(out);
  p.bar = static_cast<unsigned*>(bar);
  p.stats = static_cast<unsigned long long*>(stats);
  p.M = M;
  p.K = K;
  p.I = I;
  p.act = act;
  p.GA = gu_group;
  p.GB = down_group;
  p.sa_row = gu_row_stride;
  p.sb_row = down_row_stride;
  p.bn_a = gu_block_n;
  p.bn_d = down_block_n;
  p.C = cluster;
  p.SA = sa;
  p.SB = sb;
  const int mt = 8 * ntt, ct = 64 * ctw;
  p.n_mb = (M + mt - 1) / mt;
  const int ngsa = (K / gu_group + sa - 1) / sa;
  const int ngsb = (I / down_group + sb - 1) / sb;
  const int ksm = std::max(ngsa * gu_group, ngsb * down_group);
  p.xp = ksm + 16;   // 8-byte B loads of 8 rows: conflict-free
  p.nsc = std::max(2 * ngsa, ngsb);
  p.ngs = std::max(ngsa, ngsb);
  const int smem =
      fm_layout(ct, mt, p.xp, p.nsc, p.ngs, gu_z != nullptr || d_z != nullptr)
          .total;
  if (smem > FM_MAX_SMEM || grid < cluster || grid % cluster)
    return (int)cudaErrorInvalidValue;
  CUtensorMap amap, bmap;
  // one box a weight and stage, 64 * ctw bytes wide, in the swizzle of
  // its width
  const CUtensorMapSwizzle swz =
      ctw == 2 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  int e = tensor_map_2d(&amap, gu_q, CU_TENSOR_MAP_DATA_TYPE_UINT8,
                        (uint64_t)gu_block_n,
                        (uint64_t)(2 * I / gu_block_n) * (K / 2),
                        (uint64_t)gu_block_n, 64 * ctw, 32 / ctw, swz);
  if (e) return e;
  e = tensor_map_2d(&bmap, d_q, CU_TENSOR_MAP_DATA_TYPE_UINT8,
                    (uint64_t)down_block_n,
                    (uint64_t)(K / down_block_n) * (I / 2),
                    (uint64_t)down_block_n, 64 * ctw, 64 / ctw, swz);
  if (e) return e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  TLLM_FM_DISPATCH(launch(amap, bmap, p, grid, smem, st))
}

// Shared memory bytes a block of this plan takes (the layout above), for
// the host's plan to check against its mirror.
extern "C" int tllm_w4a16_fused_mlp_smem(int ctw, int ntt, int K, int I,
                                         int gu_group, int down_group,
                                         int sa, int sb, int zeros) {
  const int ngsa = (K / gu_group + sa - 1) / sa;
  const int ngsb = (I / down_group + sb - 1) / sb;
  const int ksm = ngsa * gu_group > ngsb * down_group ? ngsa * gu_group
                                                      : ngsb * down_group;
  const int nsc = 2 * ngsa > ngsb ? 2 * ngsa : ngsb;
  const int ngs = ngsa > ngsb ? ngsa : ngsb;
  return tllm::fm_layout(64 * ctw, 8 * ntt, ksm + 16, nsc, ngs, zeros != 0)
      .total;
}
