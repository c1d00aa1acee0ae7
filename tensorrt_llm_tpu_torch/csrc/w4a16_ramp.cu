// K13 w4a16_ramp: act(x @ ((q - z) * s) + b) from the tiled packing
// [N/BN, K/2, BN], one M block of at most 256 rows (two token tiles of 128
// on this card), K % 1024 == 0, under a
// ramp schedule of K slabs.
//
// Replaces the TPU kernel tensorrt_llm_tpu/ops/w4a16_gemm.py
// `_w4a16_kernel_ramp` (reached through `w4a16_matmul(variant="ramp")`,
// from a call or a tuned tactic).  The ramp is a schedule, not a new
// function: the TPU kernel walks a flat (column tile, step) sequence, each
// step one manual DMA of `slabs[s]` 1024-row slabs (`ramp_schedule`: the
// first step one slab, so the only cold copy is small, then steps of four).
//
// What bounds it on the H100: the K*N/2 weight bytes at decode; the
// tensor-core operations at a 256-row chunk.
//
// Design: the shared Hopper mainloop (`w4a16_sm90.cuh`: TMA ring, wgmma
// with the register-dequantized weight as A and the token tile as B) on
// the tiled packing, whose byte [j, r, n] holds K rows 2r and 2r + 1 of
// column j*BN + n: a ring stage is 32 packed rows of 64 columns and one
// 64-column span of x.  On this card a ramp step is a work unit's K range:
// the units are the TPU kernel's (column tile, step) pairs, walked by a
// persistent grid whose ring runs on across unit boundaries, so each tile's
// first unit is the one-slab step and no tile restarts the copy stream.
// Each step writes an f32 partial and the combine pass sums the steps in K
// order; a one-step schedule (`ramp_bk0` = K) writes bf16 out directly.
#include "w4a16_sm90.cuh"

// The wrapper (`ops/w4a16_gemm.py::w4a16_ramp`) guarantees what
// `tllm::sm90::launch` states, with slices on 1024-row slab boundaries.
extern "C" int tllm_w4a16_ramp(const void* x, const void* qweight,
                               const void* scales, const void* zeros,
                               const void* bias, void* workspace, void* out,
                               int M, int N, int K, int group, int block_n,
                               int act, int ntok, int n_mb, int n_ct,
                               const int* slice_start, int n_slices, int grid,
                               void* stream) {
  return tllm::sm90::launch<0>(x, qweight, scales, zeros, bias, workspace, out,
                               M, N, K, group, 0, block_n, act, ntok, n_mb,
                               n_ct, slice_start, n_slices, grid, 0, stream);
}
