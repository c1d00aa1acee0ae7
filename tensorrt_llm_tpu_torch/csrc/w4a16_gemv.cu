// K2 w4a16_gemv: act(x @ ((q - z) * s) + b) for small M (decode, M <= 16).
//
// Replaces the TPU kernel tensorrt_llm_tpu/ops/w4a16_gemm.py
// `_w4a16_kernel_stream` (one M block, whole-K x resident, the weight
// streamed in HBM storage order through lookahead slab DMAs), which serves
// decode on the TPU through the autotuned tactic.
//
// What bounds it on the H100: the int4 weight bytes.  A decode projection
// reads K*N/2 weight bytes once and does 2*M*N*K operations (M <= 16), far
// below the ~295 op/byte ridge, so the least time is K*N/2 bytes over
// 3.35 TB/s.  Reaching it takes ~3 MB in flight across the card (~25 KB an
// SM at ~1 us of latency) and few instructions per byte.
//
// Design (sm_90a: TMA, mbarriers, mma.sync):
//
// * A block owns CT = 64, 128 or 256 output columns of one BN tile and one
//   K slice of whole scale groups (`gemv_plan` in ops/w4a16_gemm.py picks
//   CT and the slice count from the shape: enough blocks for every SM,
//   each carrying about the same weight bytes).  In the tiled packing
//   [N/BN, K/2, BN] the slice's packed rows of those columns are one run of
//   rows x BN bytes; a producer warp streams them in storage order, 4 KB a
//   stage (64 / ctw packed rows of the CT columns), by TMA (boxes of 64
//   bytes in the 64-byte swizzle, the 2-D view of `w4a16_sm90.cuh`) into a
//   ring of eight mbarrier-tracked stages, 32 KB in flight a block, and
//   two or three blocks share an SM.
// * x [M, K] of the slice (M rows padded to 8 or 16 with zeros) and the
//   slice's scale (and zero) rows are staged once in shared memory by
//   cp.async while the first weight stages arrive.
// * Tensor cores on exact operands: mma.sync m16n8k16 with the weight as
//   the 16-row A operand (16 output columns) and x^T as B (8 tokens; two
//   B tiles at M 9-16).  A byte of the tiled packing is the k-pair of one
//   column, so one ldmatrix.x4.trans of the swizzled stage gives a lane, in
//   one register a k16 step, the bytes of packed rows t and t + 4 of its
//   two columns (the mainloop's column permutation: row g + 8h of a
//   16-row tile is column 2g + h).  One lop3 puts the same nibble of the
//   two rows under the bf16 pattern of 128, inverting its sign bit: 136 + q
//   exactly, so each A register costs a shift and a lop3, and a k16 step's
//   x^T registers are paired to the same K order by two prmts.  No f32
//   math per weight.
// * Group scales as in the TPU kernel: each scale group's f32 partial is
//   its own accumulator set, then acc = partial * s_g + acc; the weights'
//   offset of 136 and the zero points enter as acc -= sum(x_g) * s_g *
//   (136 + z_g), the row sums taken once from the staged x.
// * One launch, deterministic.  With one slice a block applies bias and
//   activation and stores bf16.  With several, the slices of a column tile
//   are one thread block cluster (up to 16): each block leaves its f32
//   partial in shared memory and the blocks sum them in slice order over
//   distributed shared memory, each a share of the outputs, then apply
//   bias and activation: no workspace, counter or second pass, and a second
//   call gives the same bits.
// * Host cost: the shared-memory attribute is set once per instantiation;
//   the weight's tensor map is encoded once and cached.

// prmt and nib2_136: the mainloop's byte permute and K2's 136 + q
#include "w4a16_sm90.cuh"

namespace tllm {
namespace {

using namespace sm90;

constexpr int GV_CWARPS = 4;                      // consumer warps
constexpr int GV_THREADS = GV_CWARPS * 32 + 32;   // + a producer warp
constexpr int GV_STAGE = 4096;   // bytes a stage: 64 / ctw packed rows x CT
constexpr int GV_RING = 32768;   // ring bytes a block: eight stages
constexpr int GV_MAX_SMEM = 232448;

struct GvLayout {
  int xs, sc, zs, xsum, bars, total;
};

// shared memory of a block: the ring at the 1 KB-aligned base, then x
// [MT][ksm + 8] bf16 (the pitch keeps the B-fragment reads conflict-free),
// the scale and zero rows [ngs][CT] bf16, the x row sums [ngs][MT] f32,
// the full and empty barriers
__host__ __device__ inline GvLayout gv_layout(int ctw, int mt, int ksm,
                                              int ngs) {
  GvLayout L;
  int o = GV_RING;
  L.xs = o;
  o += mt * (ksm + 8) * 2;
  L.sc = o;
  o += ngs * 64 * ctw * 2;
  L.zs = o;
  o += ngs * 64 * ctw * 2;
  L.xsum = o;
  o += ngs * mt * 4;
  o = (o + 15) & ~15;
  L.bars = o;
  o += 2 * (GV_RING / GV_STAGE) * 8 + 16;
  L.total = o + 1024;   // slack to align the base
  return L;
}

struct GvParams {
  const bf16* x;
  const bf16* scales;
  const bf16* zeros;
  const float* bias;
  bf16* out;
  int M, N, K, G, BN, act, S, ng, ksm;
};

// CTW: 16-column tiles a consumer warp owns (block: CT = 64 * CTW columns);
// NTT: 8-token tiles (M <= 8: 1, else 2)
template <int CTW, int NTT>
__global__ void __launch_bounds__(GV_THREADS)
    w4a16_gemv_kernel(const __grid_constant__ CUtensorMap wmap,
                      const GvParams p) {
  constexpr int SR = 64 / CTW;               // packed rows a stage
  constexpr int BOXB = SR * 64;              // bytes of a 64-column box
  constexpr int SB = GV_STAGE;               // bytes a stage (CTW boxes)
  constexpr int STAGES = GV_RING / SB;
  constexpr int KPS = SR / 8;                // k16 steps a stage
  constexpr int MT = 8 * NTT;
  constexpr int CT = 64 * CTW;
  constexpr int KPL = 4 / CTW;               // k16 steps an ldmatrix.x4
  extern __shared__ uint8_t gv_smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(gv_smem_raw) + 1023) & ~uintptr_t(1023));
  const int ngs = (p.ng + p.S - 1) / p.S;
  const GvLayout L = gv_layout(CTW, MT, p.ksm, ngs);
  uint8_t* ring = sm;
  bf16* xs = reinterpret_cast<bf16*>(sm + L.xs);
  const bf16* sc = reinterpret_cast<const bf16*>(sm + L.sc);
  const bf16* zs = reinterpret_cast<const bf16*>(sm + L.zs);
  float* xsum = reinterpret_cast<float*>(sm + L.xsum);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L.bars);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ct = blockIdx.x, s = blockIdx.y;
  const int n0 = ct * CT;
  const int g0 = s * p.ng / p.S, g1 = (s + 1) * p.ng / p.S;
  const int k0 = g0 * p.G, klen = (g1 - g0) * p.G;
  const int rows = klen / 2;
  const int n_st = (rows + SR - 1) / SR;

  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], GV_CWARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // ------------------------------------------------------- producer ---
  if (warp == GV_CWARPS) {
    if (lane == 0) {
      const int cb = n0 % p.BN;
      const int row0 = (n0 / p.BN) * (p.K / 2) + k0 / 2;
      for (int st = 0; st < n_st; ++st) {
        const int slot = st % STAGES;
        if (st >= STAGES) mbar_wait(&empty[slot], ((st / STAGES) - 1) & 1);
        mbar_expect_tx(&full[slot], SB);
#pragma unroll
        for (int b = 0; b < CTW; ++b)
          tma_load_2d(ring + slot * SB + b * BOXB, &wmap, cb + 64 * b,
                      row0 + st * SR, &full[slot]);
      }
    }
    __syncwarp();
    if (p.S > 1) {   // the cluster's two barriers of the slice merge
      cluster_sync();
      cluster_sync();
    }
    return;
  }

  // ------------------------------------------------------ consumers ---
  // stage x, the scale and the zero rows of the slice (rows of x past M
  // are zero-filled)
  const int xp = p.ksm + 8;   // x pitch, elements
  {
    const int xch = klen / 8;
    for (int i = tid; i < MT * xch; i += GV_CWARPS * 32) {
      const int m = i / xch, c = i - m * xch;
      const bool ok = m < p.M;
      cp_async16(xs + m * xp + 8 * c,
                 p.x + (size_t)(ok ? m : 0) * p.K + k0 + 8 * c, ok);
    }
    constexpr int cch = CT / 8;
    for (int i = tid; i < (g1 - g0) * cch; i += GV_CWARPS * 32) {
      const int gi = i / cch, c = i - gi * cch;
      const size_t off = (size_t)(g0 + gi) * p.N + n0 + 8 * c;
      cp_async16(sm + L.sc + (gi * CT + 8 * c) * 2, p.scales + off, true);
      if (p.zeros)
        cp_async16(sm + L.zs + (gi * CT + 8 * c) * 2, p.zeros + off, true);
    }
    cp_async_commit();
    cp_async_wait<0>();
  }
  named_sync(1, GV_CWARPS * 32);
  const bool has_z = p.zeros != nullptr;
  // the row sums of x per scale group: the weights enter the products as
  // 136 + q, so every group's partial carries 136 * sum(x_g) (and the zero
  // point's sum(x_g) * z), taken off at the group's flush
  for (int i = tid; i < (g1 - g0) * MT; i += GV_CWARPS * 32) {
    const int gi = i / MT, m = i - gi * MT;
    const __nv_bfloat162* xr =
        reinterpret_cast<const __nv_bfloat162*>(xs + m * xp + gi * p.G);
    float a0 = 0.f, a1 = 0.f;
    for (int k = 0; k < p.G / 2; ++k) {
      const float2 v = __bfloat1622float2(xr[k]);
      a0 += v.x;
      a1 += v.y;
    }
    xsum[gi * MT + m] = a0 + a1;
  }
  named_sync(1, GV_CWARPS * 32);

  const int g = lane >> 2, t = lane & 3;
  // this lane's ldmatrix row: matrix mi = lane / 8 is (column tile jj,
  // k16 step kk) of an x4 group; rows (0,4,1,5,2,6,3,7)[j] of the 8-row
  // matrix, so that a lane holds packed rows t and t + 4
  const int mi = lane >> 3, mj = lane & 7;
  const int jj = CTW == 1 ? 0 : (CTW == 2 ? (mi & 1) : mi);
  const int kk = CTW == 1 ? mi : (CTW == 2 ? (mi >> 1) : 0);
  const int lrow_in = (mj >> 1) + 4 * (mj & 1);
  const int colb = 16 * CTW * warp + 16 * jj;   // block column of the matrix
  const int box = colb >> 6, chunk = (colb >> 4) & 3;

  float acc[CTW][NTT][4], part[CTW][NTT][4];
#pragma unroll
  for (int j = 0; j < CTW; ++j)
#pragma unroll
    for (int tt = 0; tt < NTT; ++tt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][tt][e] = part[j][tt][e] = 0.f;

  const int kpg = p.G / 16;   // k16 steps a scale group
  int kin = 0, gi = 0;
  // acc = partial * s_g + acc, minus sum(x_g) * s_g * (136 + z_g); a fresh
  // partial
  auto flush = [&]() {
#pragma unroll
    for (int j = 0; j < CTW; ++j) {
      const int cl = 16 * CTW * warp + 16 * j + 2 * g;
      const float2 sv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(sc + gi * CT + cl));
      float z0 = 136.f, z1 = 136.f;
      if (has_z) {
        const float2 zv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(zs + gi * CT + cl));
        z0 += zv.x;
        z1 += zv.y;
      }
      const float sz0 = sv.x * z0, sz1 = sv.y * z1;
#pragma unroll
      for (int tt = 0; tt < NTT; ++tt) {
        float* a = acc[j][tt];
        float* q = part[j][tt];
        const float2 xv = *reinterpret_cast<const float2*>(
            xsum + gi * MT + 8 * tt + 2 * t);
        a[0] = fmaf(q[0], sv.x, a[0]) - xv.x * sz0;
        a[1] = fmaf(q[1], sv.x, a[1]) - xv.y * sz0;
        a[2] = fmaf(q[2], sv.y, a[2]) - xv.x * sz1;
        a[3] = fmaf(q[3], sv.y, a[3]) - xv.y * sz1;
        q[0] = q[1] = q[2] = q[3] = 0.f;
      }
    }
  };
  // one k16 step: B from x (mma K 2t, 2t+1 are x's K 2t, 2t + 8 and mma K
  // 2t + 8, 2t + 9 are K 2t + 1, 2t + 9: the nibble order of the A
  // fragments below), A from each column tile's ldmatrix register
  auto kstep = [&](const uint32_t (&r)[4], int u, int kl) {
    uint32_t b0[NTT], b1[NTT];
#pragma unroll
    for (int tt = 0; tt < NTT; ++tt) {
      const bf16* xr = xs + (g + 8 * tt) * xp + kl + 2 * t;
      const uint32_t w0 = ld_u32(xr), w1 = ld_u32(xr + 8);
      b0[tt] = prmt(w0, w1, 0x5410);
      b1[tt] = prmt(w0, w1, 0x7632);
    }
#pragma unroll
    for (int j = 0; j < CTW; ++j) {
      // byte 0 / 2: K 2t / 2t + 8 of column 2g (A row g), bytes 1 / 3 of
      // column 2g + 1 (A row g + 8); low nibbles K even, high K odd
      const uint32_t v = r[CTW == 1 ? u : (CTW == 2 ? 2 * u + j : j)];
      uint32_t a[4];
      a[0] = nib2_136(v);
      a[1] = nib2_136(v >> 8);
      a[2] = nib2_136(v >> 4);
      a[3] = nib2_136(v >> 12);
#pragma unroll
      for (int tt = 0; tt < NTT; ++tt)
        mma_bf16_16816(part[j][tt], a, b0[tt], b1[tt]);
    }
    if (++kin == kpg) {
      flush();
      kin = 0;
      ++gi;
    }
  };
  auto lds_off = [&](int q4) {
    const int lrow = 8 * (q4 * KPL + kk) + lrow_in;
    return box * BOXB + lrow * 64 + 16 * (chunk ^ ((lrow >> 1) & 3));
  };

  for (int st = 0; st < n_st; ++st) {
    const int slot = st % STAGES;
    mbar_wait(&full[slot], (st / STAGES) & 1);
    const uint8_t* stage = ring + slot * SB;
    const int valid = min(KPS, (rows - st * SR) / 8);   // k16 steps
    if (valid == KPS) {
      // a whole stage (two ldmatrix.x4 a warp): straight-line code the
      // compiler can schedule
      uint32_t r[KPS / KPL][4];
#pragma unroll
      for (int q4 = 0; q4 < KPS / KPL; ++q4)
        ldmatrix_x4_trans(r[q4], reinterpret_cast<const bf16*>(
                                     stage + lds_off(q4)));
#pragma unroll
      for (int q4 = 0; q4 < KPS / KPL; ++q4)
#pragma unroll
        for (int u = 0; u < KPL; ++u)
          kstep(r[q4], u, 16 * (st * KPS + q4 * KPL + u));
    } else {
      for (int q4 = 0; q4 * KPL < valid; ++q4) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, reinterpret_cast<const bf16*>(
                                 stage + lds_off(q4)));
#pragma unroll
        for (int u = 0; u < KPL; ++u)
          if (q4 * KPL + u < valid) kstep(r, u, 16 * (st * KPS + q4 * KPL + u));
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);
  }

  // ------------------------------------------------------- epilogue ---
  // lane: columns (cl, cl + 1) of each of its tiles, tokens 2t, 2t + 1 of
  // each token tile: acc (0, 2) and (1, 3)
  auto store = [&](int j, int tt, float v00, float v01, float v10,
                   float v11) {
    const int col = n0 + 16 * CTW * warp + 16 * j + 2 * g;
    const int m0 = 8 * tt + 2 * t;
    float b0 = 0.f, b1 = 0.f;
    if (p.bias) {
      b0 = p.bias[col];
      b1 = p.bias[col + 1];
    }
    if (m0 < p.M)
      *reinterpret_cast<uint32_t*>(p.out + (size_t)m0 * p.N + col) =
          pack_bf16x2(activate_rt(p.act, v00 + b0),
                      activate_rt(p.act, v10 + b1));
    if (m0 + 1 < p.M)
      *reinterpret_cast<uint32_t*>(p.out + (size_t)(m0 + 1) * p.N + col) =
          pack_bf16x2(activate_rt(p.act, v01 + b0),
                      activate_rt(p.act, v11 + b1));
  };
  if (p.S == 1) {
#pragma unroll
    for (int j = 0; j < CTW; ++j)
#pragma unroll
      for (int tt = 0; tt < NTT; ++tt)
        store(j, tt, acc[j][tt][0], acc[j][tt][1], acc[j][tt][2],
              acc[j][tt][3]);
    return;
  }
  // The S slices of a column tile are one thread block cluster: each
  // block leaves its f32 partial [M][CT] in its shared memory (over the
  // ring, every stage consumed), and block r sums elements r, r + S, ...
  // (in units of a block's threads) of all S partials in slice order,
  // reading the others through distributed shared memory; a second cluster
  // barrier keeps every partial alive until it has been read.
  float* ps = reinterpret_cast<float*>(ring);
  named_sync(1, GV_CWARPS * 32);
#pragma unroll
  for (int j = 0; j < CTW; ++j)
#pragma unroll
    for (int tt = 0; tt < NTT; ++tt) {
      const int col = 16 * CTW * warp + 16 * j + 2 * g;
      const int m0 = 8 * tt + 2 * t;
      *reinterpret_cast<float2*>(ps + m0 * CT + col) =
          make_float2(acc[j][tt][0], acc[j][tt][2]);
      *reinterpret_cast<float2*>(ps + (m0 + 1) * CT + col) =
          make_float2(acc[j][tt][1], acc[j][tt][3]);
    }
  cluster_sync();
  const uint32_t ps_addr = smem_u32(ps);
  for (int i = s * (GV_CWARPS * 32) + tid; i < p.M * CT;
       i += p.S * (GV_CWARPS * 32)) {
    float v = 0.f;
    for (int r = 0; r < p.S; ++r) v += ld_dsmem_f32(ps_addr + 4 * i, r);
    const int col = n0 + i % CT;
    if (p.bias) v += p.bias[col];
    p.out[(size_t)(i / CT) * p.N + col] =
        __float2bfloat16(activate_rt(p.act, v));
  }
  cluster_sync();
}

template <int CTW, int NTT>
int launch_gv(const CUtensorMap& wmap, const GvParams& p, int smem,
              cudaStream_t st) {
  auto kernel = w4a16_gemv_kernel<CTW, NTT>;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, GV_MAX_SMEM);
    if (e == cudaSuccess)   // clusters of up to 16 slices
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.N / (64 * CTW), p.S);
  cfg.blockDim = dim3(GV_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = p.S;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.S > 1 ? 1 : 0;
  return (int)cudaLaunchKernelEx(&cfg, kernel, wmap, p);
}

}  // namespace
}  // namespace tllm

// The wrapper guarantees: 1 <= M <= 16, BN % (64 * ctw) == 0, N % BN == 0,
// K % 32 == 0, G % 32 == 0 dividing K, 1 <= slices <= min(K / G, 16), x
// and the packed weight 16-byte aligned.
extern "C" int tllm_w4a16_gemv(const void* x, const void* qweight,
                               const void* scales, const void* zeros,
                               const void* bias, void* out, int M, int N,
                               int K, int group, int block_n, int act,
                               int ctw, int slices, void* stream) {
  using namespace tllm;
  using namespace tllm::sm90;
  GvParams p;
  p.x = static_cast<const bf16*>(x);
  p.scales = static_cast<const bf16*>(scales);
  p.zeros = static_cast<const bf16*>(zeros);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<bf16*>(out);
  p.M = M;
  p.N = N;
  p.K = K;
  p.G = group;
  p.BN = block_n;
  p.act = act;
  p.S = slices;
  p.ng = K / group;
  const int ngs = (p.ng + slices - 1) / slices;
  p.ksm = ngs * group;
  const int mt = M <= 8 ? 8 : 16;
  const int smem = gv_layout(ctw, mt, p.ksm, ngs).total;
  if (smem > GV_MAX_SMEM) return (int)cudaErrorInvalidValue;
  CUtensorMap wmap;
  const int e = tensor_map_2d(&wmap, qweight, CU_TENSOR_MAP_DATA_TYPE_UINT8,
                              (uint64_t)block_n,
                              (uint64_t)(N / block_n) * (K / 2),
                              (uint64_t)block_n, 64, 64 / ctw);
  if (e) return e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TLLM_GV(C)                                                       \
  if (ctw == C)                                                          \
    return M <= 8 ? launch_gv<C, 1>(wmap, p, smem, st)                   \
                  : launch_gv<C, 2>(wmap, p, smem, st);
  TLLM_GV(1) TLLM_GV(2) TLLM_GV(4)
#undef TLLM_GV
  return (int)cudaErrorInvalidValue;
}
