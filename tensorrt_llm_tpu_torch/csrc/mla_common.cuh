// The block routine of K9 mla_decode: 16 query rows of absorbed MLA (keys
// L + R channels, values the first L channels of the same latent rows)
// against a range of one sequence's paged latents, with an online softmax.
// See mla_decode.cu for what the kernel replaces and what bounds it (K10,
// the prefill, runs its own Hopper design: mla_prefill_sm90.cu).
//
// Layout of one 128-thread block (4 warps):
//   * the 16 query rows [16, L+R] bf16 are staged in shared memory once;
//   * latent tiles of 64 tokens [64, L+R] bf16 (72 KB) stream through a
//     two-stage cp.async ring, so the next tile loads while this one
//     computes (dynamic shared memory, ~170 KB in all);
//   * S = Q K^T: warp w computes the 16 rows x its 16 tokens over all L+R
//     channels (mma.sync m16n8k16), scales in f32, masks, and writes them to
//     shared memory;
//   * every warp then reads the whole 16 x 64 score tile and runs the same
//     online softmax for all 16 rows (identical arithmetic in every warp,
//     so the running max and sum agree), and packs P as bf16;
//   * O += P V with V the first L channels of the SAME tile: the 512-wide
//     f32 accumulator is split by columns, warp w owning L/4 of them
//     (L = 512: 16 n-tiles, 64 f32 per thread), the V fragments loaded with
//     ldmatrix.trans straight from the row-major tile.
// Rows past the block's valid rows and tokens outside a row's limit are
// masked to -inf; tokens past the range are zero-filled by cp.async, so no
// stale shared memory reaches an MMA.
#pragma once

#include <math.h>

#include "common.cuh"

namespace tllm {
namespace mla {

constexpr int ROWS = 16;     // query rows per block (one m16 tile)
constexpr int TILE = 64;     // latent tokens per stage
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;

template <int DK>
struct Smem {
  static constexpr int LD = DK + 8;     // padded bf16 row: conflict-free
  static constexpr int SLD = TILE + 4;  // f32 score row
  static constexpr size_t kv = 2 * TILE * LD * sizeof(bf16);
  static constexpr size_t q = ROWS * LD * sizeof(bf16);
  static constexpr size_t s = ROWS * SLD * sizeof(float);
  static constexpr size_t total = kv + q + s;
};

// qblk: the block's 16 rows, row-major [rows, DK] (rows >= nrows unused);
// table: the sequence's block table; tokens [begin, end) are attended,
// begin a multiple of TILE; lim0 / lim1: exclusive token limit of this
// thread's rows g and g + 8 (<= end; 0 for an invalid row).  Returns the
// unnormalised accumulator o (columns warp * L/4 + n * 8 + 2t + {0, 1} of
// rows g and g + 8), the running max m_r and sum l_r of rows g and g + 8.
template <int L, int DK>
__device__ __forceinline__ void attend(
    const bf16* __restrict__ qblk, int nrows, const bf16* __restrict__ pool,
    const int* __restrict__ table, int BS, int begin, int end, int lim0,
    int lim1, float scale, unsigned char* smem, float (&o)[L / 32][4],
    float (&m_r)[2], float (&l_r)[2]) {
  constexpr int LD = Smem<DK>::LD, SLD = Smem<DK>::SLD;
  constexpr int CH = DK / 8;            // 16-byte chunks per latent row
  constexpr int NT = L / (WARPS * 8);   // n-tiles of a warp's columns
  static_assert(DK % 16 == 0 && L % 64 == 0 && L <= DK, "MLA widths");
  bf16* kv = reinterpret_cast<bf16*>(smem);
  bf16* qs = kv + 2 * TILE * LD;
  float* ss = reinterpret_cast<float*>(qs + ROWS * LD);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;

  for (int i = tid; i < ROWS * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < nrows) v = *reinterpret_cast<const uint4*>(qblk + (size_t)r * DK + c);
    *reinterpret_cast<uint4*>(qs + r * LD + c) = v;
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  m_r[0] = m_r[1] = -INFINITY;
  l_r[0] = l_r[1] = 0.f;

  const int t0 = begin / TILE, t1 = (end + TILE - 1) / TILE;
  auto stage = [&](int tile, int buf) {
    bf16* dst = kv + buf * TILE * LD;
    const int s0 = tile * TILE;
    for (int i = tid; i < TILE * CH; i += THREADS) {
      const int r = i / CH, c = (i % CH) * 8;
      const int pos = s0 + r;
      const bool ok = pos < end;
      const bf16* src = pool;
      if (ok) src = pool + ((size_t)table[pos / BS] * BS + pos % BS) * DK + c;
      cp_async16(dst + r * LD + c, src, ok);
    }
    cp_async_commit();
  };

  if (t0 < t1) stage(t0, 0);
  for (int tile = t0; tile < t1; ++tile) {
    const int buf = (tile - t0) & 1;
    if (tile + 1 < t1) {
      stage(tile + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* ks = kv + buf * TILE * LD;
    const int s0 = tile * TILE;

    // S = Q K^T for this warp's 16 tokens
    float s[2][4];
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[ni][e] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < DK / 16; ++kk) {
      uint32_t a[4];
      const bf16* q0 = qs + g * LD + kk * 16 + 2 * t;
      a[0] = ld_u32(q0);
      a[1] = ld_u32(q0 + 8 * LD);
      a[2] = ld_u32(q0 + 8);
      a[3] = ld_u32(q0 + 8 * LD + 8);
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
        const bf16* kr = ks + (warp * 16 + ni * 8 + g) * LD + kk * 16 + 2 * t;
        mma_bf16_16816(s[ni], a, ld_u32(kr), ld_u32(kr + 8));
      }
    }
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = warp * 16 + ni * 8 + 2 * t + e;
        const int pos = s0 + col;
        ss[g * SLD + col] = pos < lim0 ? s[ni][e] * scale : -INFINITY;
        ss[(g + 8) * SLD + col] = pos < lim1 ? s[ni][2 + e] * scale : -INFINITY;
      }
    __syncthreads();

    // online softmax of rows g and g + 8 over the 64 tokens; p[hh][4kk + j]
    // is column 16kk + 2t + (j & 1) + 8 (j >> 1), the A fragment order
    float p[2][16];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float* row = ss + (g + 8 * hh) * SLD;
      float mx = -INFINITY;
#pragma unroll
      for (int kk = 0; kk < TILE / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float v = row[kk * 16 + 2 * t + (j & 1) + 8 * (j >> 1)];
          p[hh][kk * 4 + j] = v;
          mx = fmaxf(mx, v);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[hh], mx);
      const float msub = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m_r[hh] - msub);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        p[hh][j] = expf(p[hh][j] - msub);
        rs += p[hh][j];
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l_r[hh] = l_r[hh] * alpha + rs;
      m_r[hh] = m_new;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        o[n][2 * hh] *= alpha;
        o[n][2 * hh + 1] *= alpha;
      }
    }

    // O += P V over this warp's L/4 columns, V = the tile's first L channels
    const int mi = lane >> 3, rr = lane & 7;
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16x2(p[0][kk * 4 + 0], p[0][kk * 4 + 1]);
      a[1] = pack_bf16x2(p[1][kk * 4 + 0], p[1][kk * 4 + 1]);
      a[2] = pack_bf16x2(p[0][kk * 4 + 2], p[0][kk * 4 + 3]);
      a[3] = pack_bf16x2(p[1][kk * 4 + 2], p[1][kk * 4 + 3]);
      const bf16* vrow = ks + (kk * 16 + (mi & 1) * 8 + rr) * LD +
                         warp * (L / WARPS) + (mi >> 1) * 8;
#pragma unroll
      for (int jj = 0; jj < NT / 2; ++jj) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vrow + jj * 16);
        mma_bf16_16816(o[2 * jj], a, b[0], b[1]);
        mma_bf16_16816(o[2 * jj + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();
  }
}

}  // namespace mla
}  // namespace tllm
