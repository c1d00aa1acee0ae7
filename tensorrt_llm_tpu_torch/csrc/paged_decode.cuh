// K4 paged_decode, its e4m3 instance paged_decode_fp8, and K6
// paged_decode_int8: one new query token per sequence attends its paged
// KV.
//
// Replaces the TPU kernels tensorrt_llm_tpu/ops/paged_attention.py
// `_paged_decode_kernel` (D % 128 == 0), `_paged_decode_kernel_packed`
// (D < 128 over the TPU lane-packed page view) -- over bf16 pages, and
// over e4m3 (float8_e4m3fn) pages with no scales, which the TPU kernels
// take as they are and upcast exactly -- and, as K6,
// `_paged_decode_kernel_int8` (int8 pages with f32 per-(token, head)
// scales).  Here they are one kernel, templated on the head dim (64, 128,
// 256), the GQA group padded to a power of two (1, 2, 4, 8, 16; the real
// group Hq / Hkv, any of 1..16, is a launch argument, and the padded rows
// are zeros that are never stored) and the page type (bf16, e4m3, int8),
// over the logical head-major pools [NB, Hkv, BS, D].
//
// What bounds it on the H100: KV bytes.  Each (sequence, KV head) reads
// kv_len K and V rows (2 * D bytes each in bf16; D bytes in e4m3, plus a
// 4-byte scale in int8) and does 4 * G * D operations per token, a few operations
// per byte: the least time is the KV bytes over 3.35 TB/s.  At decode
// sizes the latency of a few dependent steps (copy, scores, softmax, P V,
// merge) matters as much, so the design keeps that chain short.
//
// Design (sm_90a: bulk async copies, mbarriers, mma.sync):
//
// * Split-KV.  A block owns one (sequence, KV head, split) and walks
//   64-token tiles of its split, as the TPU kernel walks tiles of whole
//   pages.  `decode_plan` in ops/paged_attention.py sizes the splits from
//   the table width, the window and B x Hkv (kv_lens stay on the device);
//   a split past its sequence's kv_len (or wholly before its window) exits
//   at once.
// * A producer warp streams the tiles into a ring of stages with
//   complete_tx mbarriers, several tiles ahead.  It reads the block-table
//   entries of 32 runs of gcd(BS, 64) tokens (each inside one page) at a
//   time, one a lane, before their tiles, so that a tile's copies never
//   wait on a table read.  bf16 pages come by TMA (K3's tensor maps:
//   boxes of a run's rows x 64 channels in the 128-byte swizzle, so that
//   the fragment reads below are free of bank conflicts; the runs past the
//   split are zeroed, as a stale bf16 NaN times P = 0 would poison P V):
//   pages of a multiple of 8 tokens.  1-byte pages come by cp.async.bulk,
//   each lane one run's K rows, V rows and (int8) f32 scales, contiguous
//   in the head-major pool: pages of a multiple of 4 tokens.  Stale int8
//   bytes are finite; a stale e4m3 byte may be a NaN code, so the V values
//   of tokens outside the split are zeroed as they are converted.
// * Tiles are 64 tokens, or 32 for bf16 pages at D 256 (a 64-token stage
//   of K and V would be 64 KB, and the ring must keep one stage a warp).
// * Four consumer warps take alternate tiles, each with its own online
//   softmax, merged once at the end: a tile's chain (scores, max, P V)
//   runs in one warp with no block barrier, and four tiles are in flight
//   at once.  On a tile a warp runs S = q K^T and O += P V on the tensor
//   cores (mma.sync m16n8k16, f32 accumulation): the G query heads are the
//   16-row A operand (padded with zeros: a lane holds head g, and at a
//   padded group of 16 also head g + 8), q loaded once as registers, the
//   K rows the B operand (16-byte reads); one max and one rescale per tile
//   and head, as the TPU kernel; P, from the score accumulators, is the A
//   operand of P V and the V rows its B operand (bf16: ldmatrix.trans of
//   the swizzled tile; int8: byte pairs of two token rows).  The tensor
//   cores keep the math off the CUDA cores, where eight heads a KV head
//   would cost as many FMAs as the card can run against HBM.  bf16
//   pages run in bf16 (q times the scale and P rounded to bf16, the TPU
//   kernel's operands); 1-byte pages run in fp16, into which int8
//   converts exactly by one byte permute and one subtraction, and e4m3 by
//   one cvt (for int8 q times the scale and P times the V scale rounded
//   to fp16, the K scale on the logit; for e4m3 q itself, exact in fp16,
//   the scale on the logit, since e4m3 K values reach +-448).
// * Merge inside the launch.  With one active split the block normalises
//   (adding the sinks, once) and stores.  With several, each writes its
//   (max, sum, unnormalised output) per head; the last block of the
//   (sequence, KV head) to finish -- a counter, which it resets -- merges
//   them in split order, adds the sinks once and stores: one launch, and
//   a second call gives the same bits.
//
// This header holds the kernel and its launchers; each page type's entry
// point is its own source (paged_decode.cu, paged_decode_fp8.cu,
// paged_decode_int8.cu), so that the three sets of 15 instances (3 head
// dims x 5 padded groups) compile in parallel.
#pragma once

#include <cuda_fp16.h>
#include <math.h>

#include <type_traits>

#include "sm90.cuh"

namespace tllm {
namespace {

using namespace sm90;

constexpr int PD_CWARPS = 4;                       // consumer warps
constexpr int PD_CT = PD_CWARPS * 32;              // consumer threads
constexpr int PD_THREADS = PD_CT + 32;             // + a producer warp

template <int D, int G, typename KV>
struct PdCfg {
  // 1-byte pages (int8, e4m3): bulk copies, fp16 products
  static constexpr bool I8 = sizeof(KV) == 1;
  // int8 pages carry f32 scales; e4m3 pages none
  static constexpr bool SC = std::is_same<KV, int8_t>::value;
  static constexpr int ES = (int)sizeof(KV);
  // tokens a tile: 32 for bf16 pages at D 256, where four 64-token stages
  // of K and V would not fit
  static constexpr int TT = (!I8 && D == 256) ? 32 : 64;
  // rows of q a lane holds: head g, and at a padded group of 16 head g + 8
  static constexpr int RH = G > 8 ? 2 : 1;
  // bf16: K then V as TMA boxes of [TT tokens, 64 channels] in the 128-byte
  // swizzle (as K3 loads them); 1-byte: K rows, V rows (as paged), then
  // for int8 the K and V scales
  static constexpr int BOX = TT * 128;
  static constexpr int KV_BYTES = TT * D * ES;
  static constexpr int SC_BYTES = SC ? 2 * TT * 4 : 0;
  static constexpr int STAGE = (2 * KV_BYTES + SC_BYTES + 1023) / 1024 * 1024;
  // one or two stages a consumer warp (tile i in stage i % STAGES, warp
  // i % 4: a stage always serves the same warp, so no waiter can be two
  // phases ahead of its barrier), two where they fit in ~100 KB
  static constexpr int STAGES = 8 * STAGE <= 100 * 1024 ? 8 : 4;
  static constexpr int RING = STAGES * STAGE;
  // the four warps' (max, sum, output) per head, over the ring at the end
  static constexpr int MERGE = PD_CWARPS * (G * D + 2 * G) * 4;
  static_assert(MERGE <= RING, "merge room");
  static constexpr int BARS = RING;
  static constexpr int SMEM = BARS + 2 * STAGES * 8 + 16 + 1024;
  static_assert(SMEM <= 232448, "paged decode's shared memory");
};

// The scores' token order: lane g of an 8-token n-tile reads the K row of
// token pi(g) (0, 4, 1, 5, 2, 6, 3, 7), so that the two token rows of a
// quarter warp sit in opposite halves of the 128-byte swizzle (no bank
// conflict); score column c of the n-tile is then token pi(c), and P V
// reads its V rows in the same order
__device__ __forceinline__ int pd_pi(int j) { return ((j & 1) << 2) | (j >> 1); }

struct PdParams {
  const bf16* q;
  const void* kc;
  const void* vc;
  const float* ks;
  const float* vs;
  const int* tables;
  const int* kv_lens;
  const float* sinks;
  float* ws;
  int* counters;
  bf16* out;
  int Hkv, G, BS, BR, MB, window, n_splits, split_len;
  float scale, cap;
};

// D = A(16x16) * B(16x8) + D with fp16 inputs, f32 accumulators (the
// fragment layout of mma_bf16_16816)
__device__ __forceinline__ void mma_f16_16816(float* d, const uint32_t* a,
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <bool F16>
__device__ __forceinline__ void mma16816(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  if constexpr (F16) mma_f16_16816(d, a, b0, b1);
  else mma_bf16_16816(d, a, b0, b1);
}
template <bool F16>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (F16) {
    __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  } else {
    return pack_bf16x2(lo, hi);
  }
}
// fp16x2 of (1024 + u) minus 1152: u - 128, exactly
__device__ __forceinline__ uint32_t f16_unbias(uint32_t h) {
  uint32_t d;
  asm("sub.rn.f16x2 %0, %1, %2;\n" : "=r"(d) : "r"(h), "r"(0x64806480u));
  return d;
}
// int8 values bytes (k, k + 1) of w as fp16x2, exactly: each byte, biased
// by 128, becomes the low mantissa byte of 1024.0 (0x6400)
__device__ __forceinline__ uint32_t i8x2_f16(uint32_t w, int k) {
  return f16_unbias(__byte_perm(w ^ 0x80808080u, 0x64646464u,
                                k == 0 ? 0x5140 : 0x7362));
}
// bytes (k, k + 1) of a 1-byte page word as fp16x2, exactly
template <bool SC>
__device__ __forceinline__ uint32_t b1x2_f16(uint32_t w, int k) {
  if constexpr (SC) return i8x2_f16(w, k);
  else return e4m3x2_to_f16x2(w, k);
}
// byte j of two e4m3 words (two tokens of one channel) as fp16x2, exactly
__device__ __forceinline__ uint32_t e4m3pair_f16(uint32_t a, uint32_t b,
                                                 int j) {
  return e4m3x2_to_f16x2(__byte_perm(a, b, j | ((j + 4) << 4)), 0);
}
// byte j of two int8 words (two tokens of one channel) as fp16x2, exactly
__device__ __forceinline__ uint32_t i8pair_f16(uint32_t a, uint32_t b,
                                               int j) {
  const uint32_t t = __byte_perm(a ^ 0x80808080u, b ^ 0x80808080u,
                                 0x0400 + j + (j << 8));
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n"
      : "=r"(d)
      : "r"(t), "r"(0x00FF00FFu), "r"(0x64006400u));
  return f16_unbias(d);
}

template <int D, int G, typename KV>
__global__ void __launch_bounds__(PD_THREADS)
    paged_decode_kernel(const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap,
                        const PdParams p) {
  using C = PdCfg<D, G, KV>;
  constexpr bool I8 = C::I8;   // 1-byte pages
  constexpr bool SC = C::SC;   // with scales (int8)
  constexpr int ES = C::ES;
  constexpr int TT = C::TT;    // tokens a tile
  constexpr int RH = C::RH;    // q rows a lane: head g (and g + 8)
  constexpr int NN = TT / 8;   // n-tiles of S a tile
  constexpr int NK = TT / 16;  // k16 steps of P V a tile
  constexpr int NQ = D / 8;                // q registers a lane (and O tiles)
  extern __shared__ uint8_t pd_smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(pd_smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + C::BARS);
  uint64_t* empty = full + C::STAGES;
  int* flag = reinterpret_cast<int*>(empty + C::STAGES);

  const int h = blockIdx.y, b = blockIdx.z;
  const int Gr = p.G;   // the real group (<= G)
  const int Hq = p.Hkv * Gr;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int L = p.split_len;

  // tokens past the table's MB pages do not exist (the plain version's
  // gather ends there too); never read the table out of bounds
  const int kv_len = min(p.kv_lens[b], p.MB * p.BS);
  const int lo = p.window > 0 ? max(0, kv_len - p.window) : 0;
  const int s_lo = lo / L, s_hi = (kv_len + L - 1) / L;
  // the grid's x runs over the splits from the window's first (at most the
  // plan's bound of them)
  const int split = s_lo + blockIdx.x;
  bf16* out = p.out + ((size_t)b * Hq + h * Gr) * D;
  if (split >= s_hi) {
    // no token at all (kv_len 0, which decode never passes: kv_lens count
    // the new token): zeros, where the plain version averages V
    if (s_hi <= s_lo && blockIdx.x == 0)
      for (int i = tid; i < Gr * D; i += PD_THREADS)
        out[i] = __float2bfloat16(0.f);
    return;
  }
  const int n_act = s_hi - s_lo;
  const int t_begin = max(split * L, lo);
  const int t_end = min((split + 1) * L, kv_len);
  const int tile0 = t_begin / TT;
  const int n_tiles = (t_end + TT - 1) / TT - tile0;

  // The producer reads the pool row of the split's runs 32 at a time (one
  // a lane), ahead of their tiles, so that no tile's copies wait on a table
  // read; a run not to be copied reads as -1 (bf16: those at or past the
  // split's end; int8: also those before its start)
  auto run_row = [&](int run) -> long long {
    const int tok = tile0 * TT + run * p.BR;
    if (tok >= t_end || (I8 && tok + p.BR <= t_begin)) return -1;
    return ((long long)p.tables[(size_t)b * p.MB + tok / p.BS] * p.Hkv + h) *
               p.BS + tok % p.BS;
  };
  long long my_row = warp == PD_CWARPS ? run_row(lane) : -1;
  if (tid == 0) {
    for (int i = 0; i < C::STAGES; ++i) {
      mbar_init(&full[i], I8 ? 1 : 32);   // bf16: the producer's lanes
      mbar_init(&empty[i], 1);            // the warp that consumed it
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // ------------------------------------------------------- producer ---
  if (warp == PD_CWARPS) {
    const int R = p.BR, n_runs = TT / R;
    constexpr int NB = I8 ? 0 : 2 * (D / 64);   // bf16 boxes a run: K, V
    const uint8_t* kc = static_cast<const uint8_t*>(p.kc);
    const uint8_t* vc = static_cast<const uint8_t*>(p.vc);
    for (int i = 0; i < n_tiles; ++i) {
      const int slot = i % C::STAGES;
      const int run0 = i * n_runs;   // the tile's first run of the split
      if (run0 % 32 == 0 && i > 0) my_row = run_row(run0 + lane);
      uint8_t* st = sm + slot * C::STAGE;
      const uint32_t ep = ((i / C::STAGES) & 1) ^ 1;
      if constexpr (!I8) {
        // TMA boxes of each loaded run (a prefix of the tile); the rest of
        // the tile zeroed
        const long long mine = __shfl_sync(0xffffffffu, my_row,
                                           (run0 + lane) & 31);
        const int n_ld =
            __popc(__ballot_sync(0xffffffffu, lane < n_runs && mine >= 0));
        mbar_wait(&empty[slot], ep);
        if (lane == 0) mbar_expect_tx(&full[slot], n_ld * R * 128 * NB);
        __syncwarp();
        for (int r = 0; r < n_ld; ++r) {
          const long long row = __shfl_sync(0xffffffffu, my_row,
                                            (run0 + r) & 31);
          if (lane < NB)
            tma_load_2d(st + lane * C::BOX + r * R * 128,
                        lane < NB / 2 ? &kmap : &vmap, (lane % (NB / 2)) * 64,
                        (int)row, &full[slot]);
        }
        if (n_ld < n_runs) {
          const int per_box = (TT - n_ld * R) * 8;   // 16-byte chunks
          for (int c = lane; c < NB * per_box; c += 32)
            *reinterpret_cast<uint4*>(st + (c / per_box) * C::BOX +
                                      n_ld * R * 128 + (c % per_box) * 16) =
                make_uint4(0, 0, 0, 0);
        }
        if (lane != 0) mbar_arrive(&full[slot]);
      } else {
        // 1-byte pages: each live run's K rows, V rows and (int8) scales
        // by bulk copies (stale bytes past the runs meet P = 0: int8 ones
        // are finite, e4m3 V values there are zeroed by the consumers; the
        // scales of tokens outside the split are never read)
        const long long mine = __shfl_sync(0xffffffffu, my_row,
                                           (run0 + lane) & 31);
        const bool ld = lane < n_runs && mine >= 0;
        const int n_ld = __popc(__ballot_sync(0xffffffffu, ld));
        const uint32_t run_bytes = R * D;
        mbar_wait(&empty[slot], ep);
        if (lane == 0)
          mbar_expect_tx(&full[slot], n_ld * R * (2 * D + (SC ? 8 : 0)));
        __syncwarp();
        if (ld) {
          const size_t row = (size_t)mine;
          bulk_load(st + lane * run_bytes, kc + row * D, run_bytes,
                    &full[slot]);
          bulk_load(st + C::KV_BYTES + lane * run_bytes, vc + row * D,
                    run_bytes, &full[slot]);
          if constexpr (SC) {
            uint8_t* sc = st + 2 * C::KV_BYTES;
            bulk_load(sc + lane * R * 4, p.ks + row, R * 4, &full[slot]);
            bulk_load(sc + TT * 4 + lane * R * 4, p.vs + row, R * 4,
                      &full[slot]);
          }
        }
      }
    }
    return;
  }

  // ------------------------------------------------------ consumers ---
  const int g = lane >> 2, t = lane & 3;
  // q of head g + 8 hh (zero past the real group) times the scale, as this
  // lane's A fragments: register i holds channels ch(i), ch(i) + 1; k16
  // step i / 2 takes registers 2s (A[0], A[1] for row g + 8) and 2s + 1
  // (A[2], A[3]) against the K row's registers read the same way (bf16: 8
  // channels of each 32 a lane; int8: 16 of each 64)
  auto ch = [&](int i) {
    return I8 ? (i / 8) * 64 + 16 * t + 2 * (i % 8)
              : (i / 4) * 32 + 8 * t + 2 * (i % 4);
  };
  // e4m3 pages take q as it is (a bf16 value is an fp16 one in fp16's
  // normal range) and the scale on the f32 scores: their K values reach
  // +-448, where q * scale rounded to fp16 would move a logit by ~0.1
  constexpr bool Q_RAW = I8 && !SC;
  const float q_scale = Q_RAW ? 1.f : p.scale;
  uint32_t qa[RH][NQ];
#pragma unroll
  for (int hh = 0; hh < RH; ++hh)
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      float2 v = make_float2(0.f, 0.f);
      if (g + 8 * hh < Gr)
        v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            p.q + ((size_t)b * Hq + h * Gr + g + 8 * hh) * D + ch(i)));
      qa[hh][i] = pack2<I8>(v.x * q_scale, v.y * q_scale);
    }
  // A fragment rows g + 8 (A[1], A[3]): head g + 8 at a group of 16, else 0
  auto qhi = [&](int i) -> uint32_t {
    if constexpr (RH == 2) return qa[RH - 1][i];
    else return 0u;
  };
  float o[NQ][4];
#pragma unroll
  for (int i = 0; i < NQ; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_run[RH], l_part[RH];
#pragma unroll
  for (int hh = 0; hh < RH; ++hh) {
    m_run[hh] = -INFINITY;
    l_part[hh] = 0.f;
  }

  for (int i = warp; i < n_tiles; i += PD_CWARPS) {
    const int slot = i % C::STAGES;
    const int s0 = (tile0 + i) * TT;
    const int v0 = max(t_begin, s0) - s0, v1 = min(t_end, s0 + TT) - s0;
    mbar_wait(&full[slot], (i / C::STAGES) & 1);
    const uint8_t* st = sm + slot * C::STAGE;
    const uint8_t* vt = st + C::KV_BYTES;
    const float* ksc = reinterpret_cast<const float*>(st + 2 * C::KV_BYTES);
    const float* vsc = ksc + TT;

    // S = q K^T: n-tile n is tokens 8n..8n+7, this lane's scores tokens
    // 8n + pi(2t), 8n + pi(2t + 1) of head g (sf[n][0..1]) and g + 8
    // (sf[n][2..3])
    float sf[NN][4];
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      sf[n][0] = sf[n][1] = sf[n][2] = sf[n][3] = 0.f;
      const int tk = 8 * n + pd_pi(g);
      if constexpr (I8) {
        const uint8_t* kr = st + tk * D;
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          const uint4 w = *reinterpret_cast<const uint4*>(kr + c * 64 + 16 * t);
          const uint32_t ww[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const uint32_t a[4] = {qa[0][8 * c + 2 * s], qhi(8 * c + 2 * s),
                                   qa[0][8 * c + 2 * s + 1],
                                   qhi(8 * c + 2 * s + 1)};
            mma16816<true>(sf[n], a, b1x2_f16<SC>(ww[s], 0),
                           b1x2_f16<SC>(ww[s], 2));
          }
        }
      } else {
#pragma unroll
        for (int c = 0; c < D / 32; ++c) {
          // channels 32c + 8t .. + 7: box (32c + 8t) / 64, 16-byte chunk
          // ((32c + 8t) % 64) / 8, swizzled by the token row
          const int cb = 32 * c + 8 * t;
          const uint4 w = *reinterpret_cast<const uint4*>(
              st + (cb >> 6) * C::BOX + tk * 128 +
              16 * (((cb & 63) >> 3) ^ (tk & 7)));
          const uint32_t a0[4] = {qa[0][4 * c], qhi(4 * c), qa[0][4 * c + 1],
                                  qhi(4 * c + 1)};
          const uint32_t a1[4] = {qa[0][4 * c + 2], qhi(4 * c + 2),
                                  qa[0][4 * c + 3], qhi(4 * c + 3)};
          mma16816<false>(sf[n], a0, w.x, w.y);
          mma16816<false>(sf[n], a1, w.z, w.w);
        }
      }
    }
    // the K scale, the cap and the masks; one max per tile and head
    float alpha[RH];
    uint32_t pa[NK][4];   // P as the A operand of the tile's k16 steps
#pragma unroll
    for (int hh = 0; hh < RH; ++hh) {
      float mt = -INFINITY;
#pragma unroll
      for (int n = 0; n < NN; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int tok = 8 * n + pd_pi(2 * t + e);
          float sc = sf[n][2 * hh + e];
          if (SC) sc *= ksc[tok];
          if (Q_RAW) sc *= p.scale;
          if (p.cap > 0.f) sc = p.cap * tanhf(sc / p.cap);
          sc = tok >= v0 && tok < v1 ? sc : -INFINITY;
          sf[n][2 * hh + e] = sc;
          mt = fmaxf(mt, sc);
        }
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float m_new = fmaxf(m_run[hh], mt);
      alpha[hh] = m_new == -INFINITY ? 1.f : __expf(m_run[hh] - m_new);
      float ls = 0.f;
#pragma unroll
      for (int n = 0; n < NN; ++n) {
        float pe[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = sf[n][2 * hh + e];
          pe[e] = x == -INFINITY ? 0.f : __expf(x - m_new);
          ls += pe[e];
          if (SC && pe[e] > 0.f) pe[e] *= vsc[8 * n + pd_pi(2 * t + e)];
        }
        // A[0] / A[2]: row g, tokens 0-7 / 8-15 of the k16 step; A[1] /
        // A[3] row g + 8
        pa[n / 2][(n & 1) * 2 + hh] = pack2<I8>(pe[0], pe[1]);
      }
      l_part[hh] = l_part[hh] * alpha[hh] + ls;
      m_run[hh] = m_new;
    }
    if constexpr (RH == 1) {
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) pa[kk][1] = pa[kk][3] = 0u;
    }
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      if constexpr (RH == 2) {
        o[j][2] *= alpha[RH - 1];
        o[j][3] *= alpha[RH - 1];
      }
    }
    // O += P V over the tile's k16 steps (16 tokens each; K index 8h + c
    // is token 16kk + 8h + pi(c))
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      if constexpr (I8) {
        const int ta = 16 * kk + pd_pi(2 * t), tb = 16 * kk + pd_pi(2 * t + 1);
        const uint8_t* v0r = vt + ta * D + 4 * g;
        const uint8_t* v1r = vt + tb * D + 4 * g;
        // e4m3: the V values of tokens outside [v0, v1) as zeros (this
        // lane's B registers hold tokens ta, tb, then ta + 8, tb + 8)
        uint32_t mlo = 0xffffffffu, mhi = 0xffffffffu;
        if constexpr (!SC) {
          auto in = [&](int tk) { return tk >= v0 && tk < v1; };
          mlo = (in(ta) ? 0xffffu : 0u) | (in(tb) ? 0xffff0000u : 0u);
          mhi = (in(ta + 8) ? 0xffffu : 0u) | (in(tb + 8) ? 0xffff0000u : 0u);
        }
#pragma unroll
        for (int c = 0; c < D / 32; ++c) {
          const uint32_t wa = *reinterpret_cast<const uint32_t*>(v0r + c * 32);
          const uint32_t wb = *reinterpret_cast<const uint32_t*>(v1r + c * 32);
          const uint32_t wc = *reinterpret_cast<const uint32_t*>(v0r + 8 * D + c * 32);
          const uint32_t wd = *reinterpret_cast<const uint32_t*>(v1r + 8 * D + c * 32);
#pragma unroll
          for (int jn = 0; jn < 4; ++jn) {
            if constexpr (SC)
              mma16816<true>(o[4 * c + jn], pa[kk], i8pair_f16(wa, wb, jn),
                             i8pair_f16(wc, wd, jn));
            else
              mma16816<true>(o[4 * c + jn], pa[kk],
                             e4m3pair_f16(wa, wb, jn) & mlo,
                             e4m3pair_f16(wc, wd, jn) & mhi);
          }
        }
      } else {
        // ldmatrix.x4.trans: matrix mi = tokens 16kk + 8 (mi & 1) + pi(row)
        // x channels 16c + 8 (mi >> 1) .. + 7 (a 16-byte chunk, swizzled)
        const int mi = lane >> 3;
        const int tk = 16 * kk + (mi & 1) * 8 + pd_pi(lane & 7);
#pragma unroll
        for (int c = 0; c < D / 16; ++c) {
          const int cb = 16 * c + 8 * (mi >> 1);
          uint32_t r[4];
          ldmatrix_x4_trans(r, reinterpret_cast<const bf16*>(
                                   vt + (cb >> 6) * C::BOX + tk * 128 +
                                   16 * (((cb & 63) >> 3) ^ (tk & 7))));
          mma16816<false>(o[2 * c], pa[kk], r[0], r[1]);
          mma16816<false>(o[2 * c + 1], pa[kk], r[2], r[3]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);
  }

  // ------------------------------------------------- merge the warps ---
#pragma unroll
  for (int hh = 0; hh < RH; ++hh) {
    l_part[hh] += __shfl_xor_sync(0xffffffffu, l_part[hh], 1);
    l_part[hh] += __shfl_xor_sync(0xffffffffu, l_part[hh], 2);
  }
  constexpr int WREC = G * D + 2 * G;   // a warp's (m, l, O[G][D])
  float* red = reinterpret_cast<float*>(sm);
  named_sync(1, PD_CT);   // every tile consumed: the ring is free
#pragma unroll
  for (int hh = 0; hh < RH; ++hh) {
    const int gh = g + 8 * hh;
    if (gh < Gr) {
      float* r = red + warp * WREC;
      if (t == 0) {
        r[gh] = m_run[hh];
        r[G + gh] = l_part[hh];
      }
      float* ro = r + 2 * G + gh * D;
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        // O tile j, columns 2t and 2t + 1: channels as P V read them
        const int c0 = I8 ? (j / 4) * 32 + 8 * t + (j % 4) : 8 * j + 2 * t;
        const int c1 = I8 ? c0 + 4 : c0 + 1;
        ro[c0] = o[j][2 * hh];
        ro[c1] = o[j][2 * hh + 1];
      }
    }
  }
  named_sync(1, PD_CT);
  // the block's (max, sum, output) of head gg, channel d
  auto merged = [&](int gg, int d, float& M, float& Lsum, float& A) {
    M = -INFINITY;
#pragma unroll
    for (int w = 0; w < PD_CWARPS; ++w) M = fmaxf(M, red[w * WREC + gg]);
    Lsum = 0.f;
    A = 0.f;
#pragma unroll
    for (int w = 0; w < PD_CWARPS; ++w) {
      const float mw = red[w * WREC + gg];
      const float wt = mw == -INFINITY ? 0.f : __expf(mw - M);
      Lsum += red[w * WREC + G + gg] * wt;
      A += red[w * WREC + 2 * G + gg * D + d] * wt;
    }
  };

  const float* sinks = p.sinks ? p.sinks + h * Gr : nullptr;
  if (n_act == 1) {
    for (int i = tid; i < Gr * D; i += PD_CT) {
      const int gg = i / D;
      float M, Lsum, A;
      merged(gg, i % D, M, Lsum, A);
      if (sinks) {
        const float Mx = fmaxf(M, sinks[gg]);
        const float w = M == -INFINITY ? 0.f : __expf(M - Mx);
        Lsum = Lsum * w + __expf(sinks[gg] - Mx);
        A *= w;
      }
      out[i] = __float2bfloat16(Lsum > 0.f ? A / Lsum : 0.f);
    }
    return;
  }
  // this split's record per head: (max, sum, output[D]); the last block of
  // the (sequence, KV head) merges the active splits in order
  const size_t bh = (size_t)b * p.Hkv + h;
  float* rec = p.ws + bh * p.n_splits * Gr * (D + 2);
  for (int i = tid; i < Gr * D; i += PD_CT) {
    const int gg = i / D, d = i % D;
    float M, Lsum, A;
    merged(gg, d, M, Lsum, A);
    float* r = rec + ((size_t)split * Gr + gg) * (D + 2);
    r[2 + d] = A;
    if (d == 0) {
      r[0] = M;
      r[1] = Lsum;
    }
  }
  __threadfence();
  named_sync(1, PD_CT);
  if (tid == 0) *flag = atomicAdd(&p.counters[bh], 1) == n_act - 1;
  named_sync(1, PD_CT);
  if (!*flag) return;
  __threadfence();
  for (int i = tid; i < Gr * D; i += PD_CT) {
    const int gg = i / D, d = i % D;
    float M = -INFINITY;
    for (int sl = s_lo; sl < s_hi; ++sl)
      M = fmaxf(M, __ldcg(rec + ((size_t)sl * Gr + gg) * (D + 2)));
    if (sinks) M = fmaxf(M, sinks[gg]);
    float Lsum = 0.f, A = 0.f;
    for (int sl = s_lo; sl < s_hi; ++sl) {
      const float* r = rec + ((size_t)sl * Gr + gg) * (D + 2);
      const float ms = __ldcg(r);
      const float w = ms == -INFINITY ? 0.f : __expf(ms - M);
      Lsum += __ldcg(r + 1) * w;
      A += __ldcg(r + 2 + d) * w;
    }
    if (sinks) Lsum += __expf(sinks[gg] - M);
    out[i] = __float2bfloat16(Lsum > 0.f ? A / Lsum : 0.f);
  }
  if (tid == 0) p.counters[bh] = 0;
}

template <int D, int G, typename KV>
int launch_dg(PdParams p, int B, int NB, int grid_x, cudaStream_t st) {
  using C = PdCfg<D, G, KV>;
  CUtensorMap kmap = {}, vmap = {};
  if constexpr (!C::I8) {
    // [NB * Hkv * BS, D] rows, boxes of BR rows x 64 channels
    const uint64_t rows = (uint64_t)NB * p.Hkv * p.BS;
    p.BR = min(p.BR, C::TT);
    int e = tensor_map_2d(&kmap, p.kc, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, D,
                          rows, (uint64_t)D * 2, 64, p.BR,
                          CU_TENSOR_MAP_SWIZZLE_128B);
    if (e) return e;
    e = tensor_map_2d(&vmap, p.vc, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, D, rows,
                      (uint64_t)D * 2, 64, p.BR, CU_TENSOR_MAP_SWIZZLE_128B);
    if (e) return e;
  }
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel<D, G, KV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  dim3 grid(grid_x, p.Hkv, B);
  paged_decode_kernel<D, G, KV><<<grid, PD_THREADS, C::SMEM, st>>>(kmap, vmap,
                                                                    p);
  return (int)cudaGetLastError();
}

template <typename KV>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* tables, const void* kv_lens,
           const void* sinks, void* workspace, void* counters, void* out,
           int B, int Hq, int Hkv, int D, int NB, int BS, int MB, float scale,
           int window, float cap, int n_splits, int split_len, int grid_x,
           void* stream) {
  PdParams p;
  p.q = static_cast<const bf16*>(q);
  p.kc = k;
  p.vc = v;
  p.ks = static_cast<const float*>(ks);
  p.vs = static_cast<const float*>(vs);
  p.tables = static_cast<const int*>(tables);
  p.kv_lens = static_cast<const int*>(kv_lens);
  p.sinks = static_cast<const float*>(sinks);
  p.ws = static_cast<float*>(workspace);
  p.counters = static_cast<int*>(counters);
  p.out = static_cast<bf16*>(out);
  p.Hkv = Hkv;
  p.BS = BS;
  p.BR = paged_box_rows(BS);   // capped at the tile in launch_dg
  p.MB = MB;
  p.window = window;
  p.n_splits = n_splits;
  p.split_len = split_len;
  p.scale = scale;
  p.cap = cap;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Hkv <= 0 || Hq % Hkv) return (int)cudaErrorInvalidValue;
  p.G = Hq / Hkv;
  // the group padded to a power of two: rows past the real group are zeros
#define TLLM_PD(DD, GG)                                   \
  if (D == DD && p.G <= GG && (GG == 1 || p.G > GG / 2)) \
    return launch_dg<DD, GG, KV>(p, B, NB, grid_x, st);
#define TLLM_PD_D(DD) \
  TLLM_PD(DD, 1) TLLM_PD(DD, 2) TLLM_PD(DD, 4) TLLM_PD(DD, 8) TLLM_PD(DD, 16)
  TLLM_PD_D(64) TLLM_PD_D(128) TLLM_PD_D(256)
#undef TLLM_PD_D
#undef TLLM_PD
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace tllm
