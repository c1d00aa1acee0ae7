// K9 mla_decode: absorbed Multi-head Latent Attention decode.  Each
// sequence's one new query token, H heads of L + R channels (q_nope
// absorbed through W_uk, then the roped q_pe), attends its paged latent
// pool [NB, 1, BS, L + R]: MQA of H heads over one shared latent "head",
// with V the first L channels of the same rows.  Out: [B, H, L] bf16.
//
// Replaces the TPU kernel tensorrt_llm_tpu/ops/mla_pallas.py
// `_mla_decode_kernel` (L = 512, L + R = 576 on DeepSeek V2/V3 and
// Moonlight; the TPU pads the row to 640 lanes, the port keeps 576).
//
// What bounds it on the H100: per cached token it reads one 1,152-byte
// latent row and does 2 * H * (576 + 512) operations.  At H = 128 that is
// ~242 operations per byte, near the card's bf16 ridge of ~295, so the
// products run on the tensor cores (mma.sync m16n8k16); at H = 16 (30 per
// byte) the bytes bound it.
//
// Design (the block routine is mla_common.cuh): one 128-thread block per
// (sequence, 16-head row block, KV split), the split-KV of K4.  A block
// streams its split's 64-token latent tiles through a two-stage cp.async
// ring, computes S = Q K^T on the tensor cores, keeps an online softmax,
// and accumulates O += P V with the [16, 512] f32 accumulator split by
// columns over the 4 warps -- where the TPU kernel keeps [H, L] in a VMEM
// scratch.  Each block writes its unnormalised partial (max, sum, 512
// sums); a second pass merges the splits and normalises.  At H = 128 a
// latent row is read once per 16-head block (8 times, mostly from L2).
// The scores are scaled in f32 after the dot, as the plain version
// (`mla_decode_plain`, the JAX package's XLA reference) scales q in f32;
// the Pallas kernel rounds q * scale to bf16 first, which is not copied.
// P is rounded to bf16 for P V, as in the Pallas kernel.  Splits past
// kv_len do nothing.  No TMA, no wgmma yet.
#include "mla_common.cuh"

namespace tllm {
namespace {

using mla::ROWS;
using mla::THREADS;
using mla::WARPS;

template <int L, int DK>
__global__ void __launch_bounds__(THREADS) mla_decode_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ pool,
    const int* __restrict__ tables, const int* __restrict__ kv_lens,
    float* __restrict__ ws, int H, int BS, int MB, float scale, int n_splits,
    int split_len) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int split = blockIdx.x, hb = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  // tokens past the table's MB pages do not exist (the plain version's
  // gather ends there too); never read the table out of bounds
  const int kv_len = min(kv_lens[b], MB * BS);
  const int begin = split * split_len;
  const int end = min(kv_len, begin + split_len);
  const int h0 = hb * ROWS;
  const int nrows = min(ROWS, H - h0);
  float o[L / 32][4], m_r[2], l_r[2];
  mla::attend<L, DK>(q + ((size_t)b * H + h0) * DK, nrows, pool,
                     tables + (size_t)b * MB, BS, begin, end,
                     g < nrows ? end : 0, g + 8 < nrows ? end : 0, scale,
                     smem, o, m_r, l_r);
  // partial record of (b, h, split): [max, sum, L unnormalised sums]
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = g + 8 * hh;
    if (r >= nrows) continue;
    float* rec = ws + (((size_t)b * H + h0 + r) * n_splits + split) * (L + 2);
    if (warp == 0 && t == 0) {
      rec[0] = m_r[hh];
      rec[1] = l_r[hh];
    }
#pragma unroll
    for (int n = 0; n < L / 32; ++n) {
      const int c = warp * (L / WARPS) + n * 8 + 2 * t;
      rec[2 + c] = o[n][2 * hh];
      rec[3 + c] = o[n][2 * hh + 1];
    }
  }
}

// one block per (sequence, head): merge the splits and normalise
template <int L>
__global__ void mla_decode_combine_kernel(const float* __restrict__ ws,
                                          bf16* __restrict__ out,
                                          int n_splits) {
  const int bh = blockIdx.x;
  const float* rec0 = ws + (size_t)bh * n_splits * (L + 2);
  float M = -INFINITY;
  for (int s = 0; s < n_splits; ++s) M = fmaxf(M, rec0[s * (L + 2)]);
  for (int c = threadIdx.x; c < L; c += blockDim.x) {
    float Lsum = 0.f, A = 0.f;
    for (int s = 0; s < n_splits; ++s) {
      const float* rec = rec0 + s * (L + 2);
      const float w = rec[0] == -INFINITY ? 0.f : expf(rec[0] - M);
      Lsum += rec[1] * w;
      A += rec[2 + c] * w;
    }
    out[(size_t)bh * L + c] = __float2bfloat16(Lsum > 0.f ? A / Lsum : 0.f);
  }
}

template <int L, int DK>
int launch(const bf16* q, const bf16* pool, const int* tables,
           const int* kv_lens, float* ws, bf16* out, int B, int H, int BS,
           int MB, float scale, int n_splits, int split_len,
           cudaStream_t st) {
  constexpr size_t smem = mla::Smem<DK>::total;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        mla_decode_kernel<L, DK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  dim3 grid(n_splits, (H + ROWS - 1) / ROWS, B);
  mla_decode_kernel<L, DK><<<grid, THREADS, smem, st>>>(
      q, pool, tables, kv_lens, ws, H, BS, MB, scale, n_splits, split_len);
  mla_decode_combine_kernel<L><<<B * H, 128, 0, st>>>(ws, out, n_splits);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace tllm

// q [B, H, DK] bf16, pool [NB, 1, BS, DK] bf16, tables [B, MB] int32,
// kv_lens [B] int32 (including the new token), workspace
// B * H * n_splits * (L + 2) floats, out [B, H, L] bf16.  Built for
// (L, DK) = (512, 576).
extern "C" int tllm_mla_decode(const void* q, const void* pool,
                               const void* tables, const void* kv_lens,
                               void* workspace, void* out, int B, int H,
                               int L, int DK, int BS, int MB, float scale,
                               int n_splits, int split_len, void* stream) {
  if (L != 512 || DK != 576) return (int)cudaErrorInvalidValue;
  return tllm::launch<512, 576>(
      static_cast<const tllm::bf16*>(q), static_cast<const tllm::bf16*>(pool),
      static_cast<const int*>(tables), static_cast<const int*>(kv_lens),
      static_cast<float*>(workspace), static_cast<tllm::bf16*>(out), B, H, BS,
      MB, scale, n_splits, split_len, static_cast<cudaStream_t>(stream));
}
