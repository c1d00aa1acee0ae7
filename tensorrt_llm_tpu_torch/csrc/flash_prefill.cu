// K3 flash_prefill: one sequence's chunk of T query tokens, at positions
// q_offset.., attends its paged bf16 KV (prefix + chunk, already written).
//
// Replaces the TPU kernels tensorrt_llm_tpu/ops/flash_prefill.py
// `_flash_prefill_kernel` (D % 128 == 0) and `_flash_prefill_kernel_packed`
// (D < 128 over the TPU lane-packed page view).  Here they are one kernel,
// templated on the head dim (64, 128), over the logical head-major pools
// [NB, Hkv, BS, D].  (K7, the INT8-page kernel, runs on its own warp-
// specialised wgmma design in `flash_prefill_sm90.cu`; K3 is to move onto
// it next.)
//
// What bounds it on the H100: tensor-core operations.  A chunk of T tokens
// against S cached tokens does ~4*T*S*Hq*D operations (halved by the causal
// edge) and reads the KV pages of S tokens once per KV head, which is far
// above the ~295 op/byte ridge once T reaches a few hundred rows; short
// chunks and sliding windows fall below it and are bound by the KV bytes.
//
// Design: one 128-thread block per (64 query rows, KV head).  The rows
// stack the head's G = Hq/Hkv query heads with the chunk's tokens (row =
// token * G + head), as the TPU kernel stacks them into one MXU row block,
// so every K/V page read serves all G heads.  The block walks the block
// table 64 KV tokens at a time: the K tile is staged row-major and the V
// tile transposed in shared memory, S = Q K^T and O += P V run on the
// tensor cores (mma.sync m16n8k16 bf16), and each warp keeps an online
// softmax (running max and sum in f32) for its 16 rows.  KV tiles past the
// causal edge of the block's last row, or wholly before the sliding window
// of its first row, are skipped.  logit_cap (tanh) and sinks (a per-head
// logit that joins the softmax denominator once) are applied as in the TPU
// kernel.  No TMA, no wgmma, no warp specialisation yet.
#include <math.h>

#include "common.cuh"

namespace tllm {
namespace {

constexpr int FP_ROWS = 64;  // query rows per block (16 per warp)
constexpr int FP_KV = 64;    // KV tokens per tile

template <int D>
__global__ void __launch_bounds__(128) flash_prefill_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ kc,
    const bf16* __restrict__ vc, const int* __restrict__ block_table,
    const float* __restrict__ sinks, bf16* __restrict__ out, int T, int Hq,
    int Hkv, int BS, int MB, int kv_len, int q_offset, float scale,
    int window, float cap) {
  __shared__ __align__(16) bf16 ks[FP_KV][D + 8];
  __shared__ __align__(16) bf16 vt[D][FP_KV + 8];

  const int G = Hq / Hkv;
  const int h = blockIdx.y;
  const int R = T * G;
  const int row0 = blockIdx.x * FP_ROWS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;

  // this thread's two rows (mma rows g and g + 8 of the warp's 16)
  int rows[2], qpos[2], qoff[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row0 + warp * 16 + g + hh * 8;
    rows[hh] = r;
    const int tok = r / G, hq = h * G + r % G;
    qpos[hh] = q_offset + tok;
    qoff[hh] = (tok * Hq + hq) * D;
  }

  // Q fragments for the whole head dim, kept in registers
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int hh = j & 1;
      const int d = kk * 16 + 2 * t + (j >> 1) * 8;
      qa[kk][j] = rows[hh] < R ? ld_u32(q + qoff[hh] + d) : 0u;
    }
  }

  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY};
  float l_r[2] = {0.f, 0.f};

  const int last_row = min(row0 + FP_ROWS, R) - 1;
  const int kv_end = min(kv_len, q_offset + last_row / G + 1);
  int kv_begin = 0;
  if (window > 0) kv_begin = max(0, q_offset + row0 / G - window + 1);
  const int tile_end = (kv_end + FP_KV - 1) / FP_KV;

  for (int tile = kv_begin / FP_KV; tile < tile_end; ++tile) {
    const int s0 = tile * FP_KV;
    for (int i = tid; i < FP_KV * D / 8; i += 128) {
      const int tok = i / (D / 8), c = (i % (D / 8)) * 8;
      const int pos = s0 + tok;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (pos < kv_len && pos / BS < MB) {
        const int page = block_table[pos / BS];
        const size_t base = ((size_t)(page * Hkv + h) * BS + pos % BS) * D + c;
        kv = *reinterpret_cast<const uint4*>(kc + base);
        vv = *reinterpret_cast<const uint4*>(vc + base);
      }
      *reinterpret_cast<uint4*>(&ks[tok][c]) = kv;
      const bf16* ve = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) vt[c + j][tok] = ve[j];
    }
    __syncthreads();

    float s[FP_KV / 8][4];
#pragma unroll
    for (int ni = 0; ni < FP_KV / 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[ni][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int ni = 0; ni < FP_KV / 8; ++ni) {
        const uint32_t b0 = ld_u32(&ks[ni * 8 + g][kk * 16 + 2 * t]);
        const uint32_t b1 = ld_u32(&ks[ni * 8 + g][kk * 16 + 2 * t + 8]);
        mma_bf16_16816(s[ni], qa[kk], b0, b1);
      }
    }

    // scale, cap, mask; then the online softmax update for both rows
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = -INFINITY;
#pragma unroll
      for (int ni = 0; ni < FP_KV / 8; ++ni) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kvp = s0 + ni * 8 + 2 * t + e;
          float v = s[ni][2 * hh + e] * scale;
          if (cap > 0.f) v = cap * tanhf(v / cap);
          const bool ok = rows[hh] < R && kvp <= qpos[hh] && kvp < kv_len &&
                          (window <= 0 || kvp > qpos[hh] - window);
          v = ok ? v : -INFINITY;
          s[ni][2 * hh + e] = v;
          mx = fmaxf(mx, v);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[hh], mx);
      const float msub = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m_r[hh] - msub);
      float rs = 0.f;
#pragma unroll
      for (int ni = 0; ni < FP_KV / 8; ++ni) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = expf(s[ni][2 * hh + e] - msub);
          s[ni][2 * hh + e] = p;
          rs += p;
        }
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l_r[hh] = l_r[hh] * alpha + rs;
      m_r[hh] = m_new;
#pragma unroll
      for (int di = 0; di < D / 8; ++di) {
        o[di][2 * hh] *= alpha;
        o[di][2 * hh + 1] *= alpha;
      }
    }

    // O += P V, P re-packed from the S accumulators as bf16 A fragments
#pragma unroll
    for (int kk = 0; kk < FP_KV / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int di = 0; di < D / 8; ++di) {
        const uint32_t b0 = ld_u32(&vt[di * 8 + g][kk * 16 + 2 * t]);
        const uint32_t b1 = ld_u32(&vt[di * 8 + g][kk * 16 + 2 * t + 8]);
        mma_bf16_16816(o[di], pa, b0, b1);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (rows[hh] >= R) continue;
    float l = l_r[hh];
    if (sinks != nullptr) {
      const int hq = h * G + rows[hh] % G;
      l += expf(sinks[hq] - m_r[hh]);
    }
    const float inv = l > 0.f ? 1.f / l : 1.f;
#pragma unroll
    for (int di = 0; di < D / 8; ++di) {
      *reinterpret_cast<__nv_bfloat162*>(out + qoff[hh] + di * 8 + 2 * t) =
          __floats2bfloat162_rn(o[di][2 * hh] * inv, o[di][2 * hh + 1] * inv);
    }
  }
}

int launch(const void* q, const void* k, const void* v,
           const void* block_table, const void* sinks, void* out, int T,
           int Hq, int Hkv, int D, int BS, int MB, int kv_len, int q_offset,
           float scale, int window, float cap, void* stream) {
  const int G = Hq / Hkv;
  dim3 grid((T * G + FP_ROWS - 1) / FP_ROWS, Hkv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const int* bt = static_cast<const int*>(block_table);
  const float* sk = static_cast<const float*>(sinks);
  bf16* op = static_cast<bf16*>(out);
  if (D == 64)
    flash_prefill_kernel<64><<<grid, 128, 0, st>>>(qp, kp, vp, bt, sk, op, T, Hq, Hkv, BS, MB, kv_len, q_offset, scale, window, cap);
  else if (D == 128)
    flash_prefill_kernel<128><<<grid, 128, 0, st>>>(qp, kp, vp, bt, sk, op, T, Hq, Hkv, BS, MB, kv_len, q_offset, scale, window, cap);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace tllm

// q/out [T, Hq, D], pools [NB, Hkv, BS, D] bf16, block_table [MB] int32,
// sinks [Hq] f32 or null.  window <= 0 and cap <= 0 mean "off".
extern "C" int tllm_flash_prefill(const void* q, const void* k_cache,
                                  const void* v_cache, const void* block_table,
                                  const void* sinks, void* out, int T, int Hq,
                                  int Hkv, int D, int BS, int MB, int kv_len,
                                  int q_offset, float scale, int window,
                                  float cap, void* stream) {
  return tllm::launch(q, k_cache, v_cache, block_table, sinks, out, T, Hq,
                      Hkv, D, BS, MB, kv_len, q_offset, scale, window, cap,
                      stream);
}
