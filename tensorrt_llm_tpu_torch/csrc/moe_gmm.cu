// K5 moe_gmm: grouped W4A16 GEMM for MoE experts,
//   out[i] = xs[i] @ ((q[g(i)] - z[g(i)]) * s[g(i)]),  f32 out,
// with the rows of xs sorted by expert and group_sizes[E] on the device.
//
// Replaces the TPU kernel tensorrt_llm_tpu/ops/moe_w4a16.py `_gmm_kernel`
// (and, at K % 128 != 0 such as GPT-OSS's K = 2880, the XLA ragged_dot
// fallback the JAX package takes there).
//
// What bounds it on the H100: at decode (16-32 rows over up to 256
// experts, 1-3 rows an expert) each touched expert's int4 weight is
// streamed once -- bytes; at a 1024-2048-row prefill chunk every expert is
// touched and each row does 2*N*K operations -- close to the ridge.
//
// Design: the GROUPED layout of the shared Hopper mainloop
// (`w4a16_sm90.cuh`: TMA ring fed by a producer warp, wgmma with the
// register-dequantized weight as A and the tokens as N, persistent grid).
// * Units per expert.  A prologue kernel, launched once per MoE layer for
//   both of its products, cuts each hit expert's rows into tiles of NTOK
//   tokens and writes the list (expert, first row, rows) and its length.
//   The list has the static bound ceil(M / NTOK) + min(E, M), so the host
//   reads nothing back; NTOK (8..128, wgmma's N) comes from the host-known
//   M and E (`ops/moe_w4a16.py::gmm_plan`), so decode pays 8 token
//   columns for 1-3 rows instead of a 64-row tile.
// * A persistent grid walks (unit, column tile) items from the list; the
//   count is read on the device and no empty block is launched past the
//   grid the SMs hold.  A unit's tile may run past its expert's rows: those
//   token columns belong to the next expert (or lie past M, TMA's zero
//   fill) and are not stored, so x needs no masking.
// * One tensor map over all experts: the weights [E, N/BN, K/2, BN] are
//   E*(N/BN)*(K/2) rows of BN bytes, an expert a row offset; the f32
//   scales (zeros) [E, K/G, N] are E*(K/G) rows of N.
// * Exact dequantization with f32 scales (`deqf`): the weight is bit for
//   bit the plain version's bf16((q - z) * s), so the kernel needs one
//   accumulator set (scaling an f32 partial per group instead would need
//   a second set and a per-group epilogue).
// * Each (unit, column tile) writes its rows of f32 out once: no atomics,
//   no K slices (the smallest decode case, GPT-OSS down at E 32 with 14
//   experts hit, already has 14 x 45 items).
#include "w4a16_sm90.cuh"

namespace tllm {
namespace {

constexpr int UNITS_THREADS = 256;

// The unit list of M expert-sorted rows: units[0..2] = (count, ntok,
// bound), then units[3 (1 + i) ..] = (expert, first row, rows) for unit i
// < count, in expert order, and zeros up to `bound` entries.  A block-wide
// scan over the experts, UNITS_THREADS at a time.
__global__ void __launch_bounds__(UNITS_THREADS) moe_gmm_units_kernel(
    const int* __restrict__ group_sizes, int* __restrict__ units, int M,
    int E, int ntok, int bound) {
  __shared__ int s_units[UNITS_THREADS], s_rows[UNITS_THREADS];
  __shared__ int carry[2];
  const int tid = threadIdx.x;
  if (tid == 0) carry[0] = carry[1] = 0;
  __syncthreads();
  for (int e0 = 0; e0 < E; e0 += UNITS_THREADS) {
    const int e = e0 + tid;
    const int size = e < E ? group_sizes[e] : 0;
    const int nu = (size + ntok - 1) / ntok;
    s_units[tid] = nu;
    s_rows[tid] = size;
    __syncthreads();
    for (int off = 1; off < UNITS_THREADS; off <<= 1) {
      const int a = tid >= off ? s_units[tid - off] : 0;
      const int b = tid >= off ? s_rows[tid - off] : 0;
      __syncthreads();
      s_units[tid] += a;
      s_rows[tid] += b;
      __syncthreads();
    }
    const int u0 = carry[0] + s_units[tid] - nu;
    const int r0 = carry[1] + s_rows[tid] - size;
    for (int i = 0; i < nu; ++i) {
      const int w = u0 + i, r = r0 + i * ntok;
      int n = size - i * ntok;
      n = n < ntok ? n : ntok;
      n = n < M - r ? n : M - r;   // rows past M are not the product's
      n = n > 0 ? n : 0;
      if (w < bound) {
        units[3 * (1 + w)] = e;
        units[3 * (1 + w) + 1] = r;
        units[3 * (1 + w) + 2] = n;
      }
    }
    __syncthreads();
    if (tid == UNITS_THREADS - 1) {
      carry[0] += s_units[tid];
      carry[1] += s_rows[tid];
    }
    __syncthreads();
  }
  // the count (each hit expert's rows, all within M for a routed batch),
  // and zeroed entries up to the bound
  int count = carry[0] < bound ? carry[0] : bound;
  for (int w = count + tid; w < bound; w += UNITS_THREADS) {
    units[3 * (1 + w)] = 0;
    units[3 * (1 + w) + 1] = 0;
    units[3 * (1 + w) + 2] = 0;
  }
  if (tid == 0) {
    units[0] = count;
    units[1] = ntok;
    units[2] = bound;
  }
}

}  // namespace
}  // namespace tllm

// The unit list of M expert-sorted rows over E experts at token tile
// `ntok`: int32 [bound + 1, 3] (`moe_gmm_units_kernel`).  One launch serves
// every product of a layer that shares group_sizes (gate_up and down).
extern "C" int tllm_moe_gmm_units(const void* group_sizes, void* units, int M,
                                  int E, int ntok, int bound, void* stream) {
  using namespace tllm;
  moe_gmm_units_kernel<<<1, UNITS_THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(group_sizes), static_cast<int*>(units), M, E,
      ntok, bound);
  return (int)cudaGetLastError();
}

// Shapes are checked by the Python wrapper (`ops/moe_w4a16.py::moe_gmm`):
// BN % 64 == 0 dividing N, K % 32 == 0, G % 32 == 0, contiguous operands,
// 16-byte aligned; units from tllm_moe_gmm_units for the same M, E and
// ntok; n_ct column tiles of 64 columns (128 at ntok 128) cover N; `grid`
// persistent blocks.
extern "C" int tllm_moe_gmm(const void* x, const void* qweight,
                            const void* scales, const void* zeros,
                            const void* units, void* out, int M, int N, int K,
                            int group, int E, int block_n, int ntok, int n_ct,
                            int grid, void* stream) {
  using namespace tllm::sm90;
  Params p = {};
  p.scales = scales;
  p.zeros = zeros;
  p.units = static_cast<const int*>(units);
  p.outf = static_cast<float*>(out);
  p.M = M;
  p.N = N;
  p.K = K;
  p.G = group;
  p.bn = block_n;
  p.n_mb = 1;
  p.n_ct = n_ct;
  p.sl.n = 1;
  p.sl.start[0] = 0;
  p.sl.start[1] = (K + STAGE_K - 1) / STAGE_K;
  const int n_groups = group < K ? K / group : 1;
  CUtensorMap wmap, xmap, smap, zmap;
  int e = tensor_map_2d(&wmap, qweight, CU_TENSOR_MAP_DATA_TYPE_UINT8, block_n,
                        (uint64_t)E * (N / block_n) * (K / 2), block_n,
                        WG_COLS, STAGE_PR);
  if (e) return e;
  e = tensor_map_2d(&xmap, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, K, M,
                    (uint64_t)K * 2, 32, ntok);
  if (e) return e;
  // the block's columns of one f32 scale row a box, of two where a group
  // may end in the middle of a stage (G % 64 != 0)
  const int cols = ntok >= 128 ? 2 * WG_COLS : WG_COLS;
  const int rows = (group < K && group % STAGE_K) ? 2 : 1;
  e = tensor_map_2d(&smap, scales, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, N,
                    (uint64_t)E * n_groups, (uint64_t)N * 4, cols, rows,
                    CU_TENSOR_MAP_SWIZZLE_NONE);
  if (e) return e;
  zmap = smap;
  if (zeros != nullptr) {
    e = tensor_map_2d(&zmap, zeros, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, N,
                      (uint64_t)E * n_groups, (uint64_t)N * 4, cols, rows,
                      CU_TENSOR_MAP_SWIZZLE_NONE);
    if (e) return e;
  }
  return launch_layout<GROUPED, PRE_K1>(wmap, xmap, smap, zmap, p, ntok, grid,
                                        static_cast<cudaStream_t>(stream));
}
