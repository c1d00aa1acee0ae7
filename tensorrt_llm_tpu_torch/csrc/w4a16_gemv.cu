// K2 w4a16_gemv: act(x @ ((q - z) * s) + b) for small M (decode, M <= 16).
//
// Replaces the TPU kernel tensorrt_llm_tpu/ops/w4a16_gemm.py
// `_w4a16_kernel_stream` (one M block, whole-K x resident, weights
// streamed), which serves decode on the TPU through the autotuned tactic.
//
// What bounds it on the H100: the int4 weight bytes.  A decode projection
// reads K*N/2 weight bytes once and does only 2*M*N*K operations (M <= 16),
// far below the ~295 op/byte ridge, so the least time is K*N/2 bytes over
// 3.35 TB/s.  The FMAs run on the CUDA cores (no 64-row tensor-core tile
// is wasted on 1..16 rows); at M = 16 the f32 FMA rate, not HBM, can
// become the limit.
//
// Design: a 256-thread block owns 64 output columns and one K slice.  Each
// thread streams 16-byte loads of the tiled packing (16 columns x 2 K rows
// per load; four threads cover one 64-byte row segment, so loads are
// contiguous), dequantizes the nibbles in registers ((q - z) * s in f32)
// and accumulates in f32 for up to 8 rows of x, which sit in shared memory
// as f32.  Partial sums are reduced across the warp with shuffles, then
// across warps in shared memory.  When the N/64 column blocks are too few to
// fill the 132 SMs, K is split over more blocks (split-K); every block
// writes its f32 partial to a workspace, and a second pass sums the splits
// and applies bias and activation.  More than 8 rows run as a further grid
// dimension over the same weights.
#include "common.cuh"

namespace tllm {
namespace {

constexpr int GV_THREADS = 256;
constexpr int GV_COLS = 64;  // columns per block: 4 threads x 16 columns

template <int MT, bool HAS_Z>
__global__ void __launch_bounds__(GV_THREADS) w4a16_gemv_kernel(
    const bf16* __restrict__ x, const int8_t* __restrict__ qw,
    const bf16* __restrict__ scales, const bf16* __restrict__ zeros,
    float* __restrict__ ws, int M, int N, int K, int G, int block_n, int KS) {
  extern __shared__ float xs[];  // [MT][KS]
  __shared__ float red[GV_THREADS / 32][4][MT][16];

  const int tid = threadIdx.x;
  const int ln = tid & 3;   // which 16-column segment
  const int lk = tid >> 2;  // which packed row (0..63) of each 64-row step
  const int lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * GV_COLS;
  const int col0 = n0 + ln * 16;
  const int k_begin = blockIdx.y * KS;
  const int k_end = min(K, k_begin + KS);
  const int klen = k_end - k_begin;
  const int m_base = blockIdx.z * MT;

  for (int i = tid; i < MT * klen; i += GV_THREADS) {
    const int m = i / klen, k = i - m * klen;
    xs[m * KS + k] = (m_base + m < M)
                         ? __bfloat162float(x[(size_t)(m_base + m) * K + k_begin + k])
                         : 0.f;
  }
  __syncthreads();

  float acc[MT][16];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 16; ++c) acc[m][c] = 0.f;

  const int8_t* qcol = qw + (size_t)(n0 / block_n) * (K / 2) * block_n +
                       (n0 % block_n) + ln * 16;
  int cur_g = -1;
  float s[16], z[16];
  for (int r = k_begin / 2 + lk; r < k_end / 2; r += GV_THREADS / 4) {
    const int gi = (2 * r) / G;
    if (gi != cur_g) {
      cur_g = gi;
      const uint4* sp = reinterpret_cast<const uint4*>(scales + (size_t)gi * N + col0);
      bf16x8_to_float(sp[0], s);
      bf16x8_to_float(sp[1], s + 8);
      if (HAS_Z) {
        const uint4* zp = reinterpret_cast<const uint4*>(zeros + (size_t)gi * N + col0);
        bf16x8_to_float(zp[0], z);
        bf16x8_to_float(zp[1], z + 8);
      }
    }
    const uint4 v = *reinterpret_cast<const uint4*>(qcol + (size_t)r * block_n);
    const uint32_t w4[4] = {v.x, v.y, v.z, v.w};
    const int kl = 2 * r - k_begin;
    float2 xv[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m)
      xv[m] = *reinterpret_cast<const float2*>(&xs[m * KS + kl]);
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const uint32_t u = (w4[c >> 2] >> (8 * (c & 3))) & 0xFFu;
      float wl = (float)nib_lo(u), wh = (float)nib_hi(u);
      if (HAS_Z) { wl -= z[c]; wh -= z[c]; }
      wl *= s[c];
      wh *= s[c];
#pragma unroll
      for (int m = 0; m < MT; ++m)
        acc[m][c] = fmaf(xv[m].y, wh, fmaf(xv[m].x, wl, acc[m][c]));
    }
  }

  // reduce the 8 row-threads of a warp that share a column segment
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      float a = acc[m][c];
      a += __shfl_xor_sync(0xffffffffu, a, 4);
      a += __shfl_xor_sync(0xffffffffu, a, 8);
      a += __shfl_xor_sync(0xffffffffu, a, 16);
      acc[m][c] = a;
    }
  if (lane < 4) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < 16; ++c) red[warp][ln][m][c] = acc[m][c];
  }
  __syncthreads();
  for (int i = tid; i < MT * GV_COLS; i += GV_THREADS) {
    const int m = i / GV_COLS, col = i % GV_COLS;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < GV_THREADS / 32; ++w) sum += red[w][col >> 4][m][col & 15];
    if (m_base + m < M)
      ws[((size_t)blockIdx.y * M + m_base + m) * N + n0 + col] = sum;
  }
}

template <int ACT, bool HAS_B>
__global__ void gemv_combine_kernel(const float* __restrict__ ws,
                                    const float* __restrict__ bias,
                                    bf16* __restrict__ out, int M, int N,
                                    int split) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M * N) return;
  float v = 0.f;
  for (int sidx = 0; sidx < split; ++sidx) v += ws[(size_t)sidx * M * N + i];
  if (HAS_B) v += bias[i % N];
  out[i] = __float2bfloat16(activate<ACT>(v));
}

template <int MT>
void launch_main(const bf16* x, const int8_t* qw, const bf16* s, const bf16* z,
                 float* ws, int M, int N, int K, int G, int bn, int split,
                 cudaStream_t st) {
  const int KS = (K + split - 1) / split;
  dim3 grid(N / GV_COLS, split, (M + MT - 1) / MT);
  const size_t smem = sizeof(float) * MT * KS;
  if (z) {
    cudaFuncSetAttribute(w4a16_gemv_kernel<MT, true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    w4a16_gemv_kernel<MT, true><<<grid, GV_THREADS, smem, st>>>(x, qw, s, z, ws, M, N, K, G, bn, KS);
  } else {
    cudaFuncSetAttribute(w4a16_gemv_kernel<MT, false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    w4a16_gemv_kernel<MT, false><<<grid, GV_THREADS, smem, st>>>(x, qw, s, z, ws, M, N, K, G, bn, KS);
  }
}

template <int ACT>
void launch_combine(const float* ws, const float* b, bf16* out, int M, int N,
                    int split, cudaStream_t st) {
  const int n = M * N;
  if (b)
    gemv_combine_kernel<ACT, true><<<(n + 255) / 256, 256, 0, st>>>(ws, b, out, M, N, split);
  else
    gemv_combine_kernel<ACT, false><<<(n + 255) / 256, 256, 0, st>>>(ws, b, out, M, N, split);
}

}  // namespace
}  // namespace tllm

// The wrapper guarantees: M <= 16, N % 64 == 0, block_n % 64 == 0,
// split divides K into slices whose length is a multiple of the group size
// G (G % 16 == 0), workspace holds split * M * N floats.
extern "C" int tllm_w4a16_gemv(const void* x, const void* qweight,
                               const void* scales, const void* zeros,
                               const void* bias, void* workspace, void* out,
                               int M, int N, int K, int group, int block_n,
                               int act, int split, void* stream) {
  using namespace tllm;
  const bf16* xp = static_cast<const bf16*>(x);
  const int8_t* qp = static_cast<const int8_t*>(qweight);
  const bf16* sp = static_cast<const bf16*>(scales);
  const bf16* zp = static_cast<const bf16*>(zeros);
  const float* bp = static_cast<const float*>(bias);
  float* wsp = static_cast<float*>(workspace);
  bf16* op = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 1) launch_main<1>(xp, qp, sp, zp, wsp, M, N, K, group, block_n, split, st);
  else if (M <= 2) launch_main<2>(xp, qp, sp, zp, wsp, M, N, K, group, block_n, split, st);
  else if (M <= 4) launch_main<4>(xp, qp, sp, zp, wsp, M, N, K, group, block_n, split, st);
  else launch_main<8>(xp, qp, sp, zp, wsp, M, N, K, group, block_n, split, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  switch (act) {
    case ACT_SILU: launch_combine<ACT_SILU>(wsp, bp, op, M, N, split, st); break;
    case ACT_GELU: launch_combine<ACT_GELU>(wsp, bp, op, M, N, split, st); break;
    case ACT_RELU: launch_combine<ACT_RELU>(wsp, bp, op, M, N, split, st); break;
    case ACT_RELU2: launch_combine<ACT_RELU2>(wsp, bp, op, M, N, split, st); break;
    default: launch_combine<ACT_NONE>(wsp, bp, op, M, N, split, st); break;
  }
  return (int)cudaGetLastError();
}
