// K4 paged_decode and K6 paged_decode_int8: one new query token per
// sequence attends its paged KV.
//
// Replaces the TPU kernels tensorrt_llm_tpu/ops/paged_attention.py
// `_paged_decode_kernel` (D % 128 == 0), `_paged_decode_kernel_packed`
// (D < 128 over the TPU lane-packed page view) and, as K6,
// `_paged_decode_kernel_int8` (int8 pages with f32 per-(token, head)
// scales).  Here they are one kernel, templated on the head dim (64, 128),
// the GQA group size and the page type (bf16, int8), over the logical
// head-major pools [NB, Hkv, BS, D].
//
// What bounds it on the H100: KV bytes.  Each (sequence, KV head) reads
// kv_len K and V rows (2 * D bytes each in bf16; D bytes plus a 4-byte
// scale in int8) and does ~4 * G * D operations per token, a few
// operations per byte: the least time is the KV bytes over 3.35 TB/s, so
// an int8 pool halves it.
//
// Design: split-KV ("flash decoding").  A 128-thread block owns one
// (sequence, KV head, KV split); splits are added until the blocks fill
// the 132 SMs, so a batch of 4 sequences x 4 KV heads still spreads over
// the card.  Within a block, D/8 threads cover one token's K or V row, 8
// elements each (16-byte loads in bf16, 8-byte in int8), so a warp reads
// 2..4 tokens per step; every page read serves all G query heads of the KV
// head.  Each thread keeps an online softmax (running max, sum and output
// slice, f32) per query head; the token groups are merged in shared memory
// and each block writes its unnormalised partial.  A second pass merges
// the splits, adds the sinks to the denominator once and normalises.
// Tokens past kv_len, and before the sliding window, are never read;
// logit_cap is applied to the scores as in the TPU kernel.  int8 pages are
// never dequantized as a tile: as in the TPU kernel, each token's K scale
// multiplies its logit and its V scale its probability.  The scales are
// read through the block table inside the kernel (the TPU version
// pre-gathers them in XLA only because Mosaic rejects the in-kernel
// sublane-to-lane reshape).
#include <math.h>

#include "common.cuh"

namespace tllm {
namespace {

constexpr int PD_THREADS = 128;

// 8 consecutive K or V elements of one token row as floats
__device__ __forceinline__ void load8(const bf16* p, float* f) {
  bf16x8_to_float(*reinterpret_cast<const uint4*>(p), f);
}
__device__ __forceinline__ void load8(const int8_t* p, float* f) {
  int8x8_to_float(*reinterpret_cast<const uint2*>(p), f);
}

// KV = bf16 (K4) or int8_t (K6, with f32 scale pools ks/vs [NB, Hkv, BS])
template <int D, int G, typename KV>
__global__ void __launch_bounds__(PD_THREADS) paged_decode_kernel(
    const bf16* __restrict__ q, const KV* __restrict__ kc,
    const KV* __restrict__ vc, const float* __restrict__ ks,
    const float* __restrict__ vs, const int* __restrict__ tables,
    const int* __restrict__ kv_lens, float* __restrict__ ws, int Hkv,
    int BS, int MB, float scale, int window, float cap, int n_splits,
    int split_len) {
  constexpr bool SCALED = sizeof(KV) == 1;   // int8 pages
  constexpr int LPT = D / 8;                 // threads per token row
  constexpr int TPW = 32 / LPT;              // tokens per warp step
  constexpr int NSUB = (PD_THREADS / 32) * TPW;  // token streams per block
  __shared__ float sm_m[NSUB][G];
  __shared__ float sm_l[NSUB][G];
  __shared__ float sm_acc[NSUB][G][D];

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int Hq = Hkv * G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = lane / LPT, dl = lane % LPT;
  const int stream_id = warp * TPW + sub;

  // tokens past the table's MB pages do not exist (the plain version's
  // gather ends there too); never read the table out of bounds
  const int kv_len = min(kv_lens[b], MB * BS);
  int begin = split * split_len;
  if (window > 0) begin = max(begin, kv_len - window);
  const int end = min(kv_len, (split + 1) * split_len);

  float qv[G][8];
#pragma unroll
  for (int gg = 0; gg < G; ++gg) {
    const uint4 v = *reinterpret_cast<const uint4*>(
        q + ((size_t)b * Hq + h * G + gg) * D + dl * 8);
    bf16x8_to_float(v, qv[gg]);
#pragma unroll
    for (int i = 0; i < 8; ++i) qv[gg][i] *= scale;
  }
  float m[G], l[G], acc[G][8];
#pragma unroll
  for (int gg = 0; gg < G; ++gg) {
    m[gg] = -INFINITY;
    l[gg] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[gg][i] = 0.f;
  }

  const int* table = tables + (size_t)b * MB;
  // every lane of a warp runs the same trip count (the shuffles below need
  // the whole warp); a lane past `end` computes on zeros and keeps its state
  for (int pos0 = begin + warp * TPW; pos0 < end; pos0 += NSUB) {
    const int pos = pos0 + sub;
    const bool valid = pos < end;
    float kf[8], vf[8];
    float k_scale = 1.f, v_scale = 1.f;
    if (valid) {
      const int page = table[pos / BS];
      const size_t row = (size_t)(page * Hkv + h) * BS + pos % BS;
      load8(kc + row * D + dl * 8, kf);
      load8(vc + row * D + dl * 8, vf);
      if (SCALED) {
        k_scale = ks[row];
        v_scale = vs[row];
      }
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) kf[i] = vf[i] = 0.f;
    }
#pragma unroll
    for (int gg = 0; gg < G; ++gg) {
      float sc = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) sc = fmaf(qv[gg][i], kf[i], sc);
#pragma unroll
      for (int off = LPT / 2; off > 0; off >>= 1)
        sc += __shfl_xor_sync(0xffffffffu, sc, off);
      if (!valid) continue;
      if (SCALED) sc *= k_scale;
      if (cap > 0.f) sc = cap * tanhf(sc / cap);
      const float m_new = fmaxf(m[gg], sc);
      const float alpha = expf(m[gg] - m_new);
      const float p = expf(sc - m_new);
      l[gg] = l[gg] * alpha + p;
      const float pv = SCALED ? p * v_scale : p;
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[gg][i] = fmaf(pv, vf[i], acc[gg][i] * alpha);
      m[gg] = m_new;
    }
  }

#pragma unroll
  for (int gg = 0; gg < G; ++gg) {
    if (dl == 0) {
      sm_m[stream_id][gg] = m[gg];
      sm_l[stream_id][gg] = l[gg];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) sm_acc[stream_id][gg][dl * 8 + i] = acc[gg][i];
  }
  __syncthreads();

  // merge the token streams; write this split's unnormalised partial
  const size_t row_base = ((size_t)b * Hq + h * G) * n_splits + split;
  for (int i = tid; i < G * D; i += PD_THREADS) {
    const int gg = i / D, d = i % D;
    float M = -INFINITY;
#pragma unroll
    for (int s = 0; s < NSUB; ++s) M = fmaxf(M, sm_m[s][gg]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int s = 0; s < NSUB; ++s) {
      const float w = sm_m[s][gg] == -INFINITY ? 0.f : expf(sm_m[s][gg] - M);
      L += sm_l[s][gg] * w;
      A += sm_acc[s][gg][d] * w;
    }
    const size_t row = row_base + (size_t)gg * n_splits;  // (b, hq, split)
    float* rec = ws + row * (D + 2);
    rec[2 + d] = A;
    if (d == 0) {
      rec[0] = M;
      rec[1] = L;
    }
  }
}

// one block per (sequence, query head): merge splits, add sinks, normalise
template <int D>
__global__ void paged_decode_combine_kernel(const float* __restrict__ ws,
                                            const float* __restrict__ sinks,
                                            bf16* __restrict__ out, int Hq,
                                            int n_splits) {
  const int bh = blockIdx.x, d = threadIdx.x;
  const float* rec0 = ws + (size_t)bh * n_splits * (D + 2);
  float M = -INFINITY;
  for (int s = 0; s < n_splits; ++s) M = fmaxf(M, rec0[s * (D + 2)]);
  float sink = 0.f;
  if (sinks != nullptr) {
    sink = sinks[bh % Hq];
    M = fmaxf(M, sink);
  }
  float L = 0.f, A = 0.f;
  for (int s = 0; s < n_splits; ++s) {
    const float* rec = rec0 + s * (D + 2);
    const float w = rec[0] == -INFINITY ? 0.f : expf(rec[0] - M);
    L += rec[1] * w;
    A += rec[2 + d] * w;
  }
  if (sinks != nullptr) L += expf(sink - M);
  out[(size_t)bh * D + d] = __float2bfloat16(L > 0.f ? A / L : 0.f);
}

template <int D, int G, typename KV>
void launch_dg(const bf16* q, const KV* k, const KV* v, const float* ks,
               const float* vs, const int* t, const int* lens,
               const float* sinks, float* ws, bf16* out, int B, int Hkv,
               int BS, int MB, float scale, int window, float cap,
               int n_splits, int split_len, cudaStream_t st) {
  dim3 grid(n_splits, Hkv, B);
  paged_decode_kernel<D, G, KV><<<grid, PD_THREADS, 0, st>>>(
      q, k, v, ks, vs, t, lens, ws, Hkv, BS, MB, scale, window, cap,
      n_splits, split_len);
  paged_decode_combine_kernel<D><<<B * Hkv * G, D, 0, st>>>(ws, sinks, out,
                                                            Hkv * G, n_splits);
}

template <typename KV>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* tables, const void* kv_lens,
           const void* sinks, void* workspace, void* out, int B, int Hq,
           int Hkv, int D, int BS, int MB, float scale, int window, float cap,
           int n_splits, int split_len, void* stream) {
  const bf16* qp = static_cast<const bf16*>(q);
  const KV* kp = static_cast<const KV*>(k);
  const KV* vp = static_cast<const KV*>(v);
  const float* ksp = static_cast<const float*>(ks);
  const float* vsp = static_cast<const float*>(vs);
  const int* tp = static_cast<const int*>(tables);
  const int* lp = static_cast<const int*>(kv_lens);
  const float* sk = static_cast<const float*>(sinks);
  float* wsp = static_cast<float*>(workspace);
  bf16* op = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TLLM_PD(DD, GG)                                                     \
  if (D == DD && Hq == Hkv * GG) {                                          \
    launch_dg<DD, GG, KV>(qp, kp, vp, ksp, vsp, tp, lp, sk, wsp, op, B,     \
                          Hkv, BS, MB, scale, window, cap, n_splits,       \
                          split_len, st);                                  \
    return (int)cudaGetLastError();                                         \
  }
  TLLM_PD(64, 1) TLLM_PD(64, 2) TLLM_PD(64, 4) TLLM_PD(64, 8)
  TLLM_PD(128, 1) TLLM_PD(128, 2) TLLM_PD(128, 4) TLLM_PD(128, 8)
#undef TLLM_PD
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace tllm

// q/out [B, Hq, D], pools [NB, Hkv, BS, D] bf16, tables [B, MB] int32,
// kv_lens [B] int32 (including the new token), sinks [Hq] f32 or null,
// workspace B * Hq * n_splits * (D + 2) floats.
extern "C" int tllm_paged_decode(const void* q, const void* k_cache,
                                 const void* v_cache, const void* tables,
                                 const void* kv_lens, const void* sinks,
                                 void* workspace, void* out, int B, int Hq,
                                 int Hkv, int D, int BS, int MB, float scale,
                                 int window, float cap, int n_splits,
                                 int split_len, void* stream) {
  return tllm::launch<tllm::bf16>(q, k_cache, v_cache, nullptr, nullptr,
                                  tables, kv_lens, sinks, workspace, out, B,
                                  Hq, Hkv, D, BS, MB, scale, window, cap,
                                  n_splits, split_len, stream);
}

// The same over int8 pools [NB, Hkv, BS, D] with f32 scale pools
// [NB, Hkv, BS] indexed by the same block ids.
extern "C" int tllm_paged_decode_int8(
    const void* q, const void* k_data, const void* k_scale,
    const void* v_data, const void* v_scale, const void* tables,
    const void* kv_lens, const void* sinks, void* workspace, void* out, int B,
    int Hq, int Hkv, int D, int BS, int MB, float scale, int window,
    float cap, int n_splits, int split_len, void* stream) {
  return tllm::launch<int8_t>(q, k_data, v_data, k_scale, v_scale, tables,
                              kv_lens, sinks, workspace, out, B, Hq, Hkv, D,
                              BS, MB, scale, window, cap, n_splits, split_len,
                              stream);
}
