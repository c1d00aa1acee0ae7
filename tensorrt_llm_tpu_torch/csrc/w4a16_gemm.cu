// K1 w4a16_gemm: act(x @ ((q - z) * s) + b) from the tiled packing
// [N/BN, K/2, BN], any M (prefill chunks, and decode where the tuner picks
// it).
//
// Replaces the TPU kernel tensorrt_llm_tpu/ops/w4a16_gemm.py
// `_w4a16_kernel_tiled`, the JAX package's kernel for a tiled weight at
// any M.  (K12 and K13 replace `_w4a16_kernel` and `_w4a16_kernel_ramp`
// on the same mainloop, each reading its packing as stored.)
//
// What bounds it on the H100: at a prefill chunk (M 128..512 tokens) the
// 2*M*N*K tensor-core operations -- M*4 operations per weight byte, above
// the card's ~295 op/byte ridge from M ~ 74 on; at decode the K*N/2 weight
// bytes.
//
// Design: the shared Hopper mainloop (`w4a16_sm90.cuh`: TMA ring, wgmma
// with the register-dequantized weight as A and the tokens as N), on the
// tiled packing as K13 reads it, under K1's own plan
// (`ops/w4a16_gemm.py::k1_plan`): M blocks of up to 128 tokens, K slices
// of whole 64-row stages, uneven by at most one stage, summed in K order
// by the combine pass; at 128 tokens 128 or 192 columns a block (two or
// three consumer warpgroups).  The column tile and the slice count come
// from a cost model fitted on the H100, which `chip_smoke.py` holds
// within 10% of the fastest choice timed.  K1's own paths in the mainloop
// (the PRE_K1 bits): the epilogue chooses the activation once, not per
// stored value (a run-time switch per value made the epilogue a large
// part of a unit's time at 128 tokens on the H100); the producer advances
// its offsets and scale group per stage instead of dividing them out; the
// scale rows are read with shared loads.  At 128 tokens x is staged as
// one 64-K box (128-byte swizzle) and the producer is a whole warpgroup
// that hands its registers to two accumulator chains (setmaxnreg);
// `chip_smoke.py` times each mechanism with and without it
// (`K1_VARIANTS`).  K1 keeps the reach of its first version: K % 32 == 0
// (a last half stage reads x past K as TMA's zeros, so the weight rows it
// also reads are multiplied by zero) and G % 32 == 0 (two scale rows a
// stage where a group may end at its middle).
#include "w4a16_sm90.cuh"

// The wrapper (`ops/w4a16_gemm.py::w4a16_gemm`) guarantees what
// `tllm::sm90::launch` states for K1; `variant` indexes `K1_PRE`.
extern "C" int tllm_w4a16_gemm(const void* x, const void* qweight,
                               const void* scales, const void* zeros,
                               const void* bias, void* workspace, void* out,
                               int M, int N, int K, int group, int block_n,
                               int act, int ntok, int n_mb, int n_ct,
                               const int* slice_start, int n_slices, int grid,
                               int variant, void* stream) {
  return tllm::sm90::launch<2>(x, qweight, scales, zeros, bias, workspace, out,
                               M, N, K, group, 0, block_n, act, ntok, n_mb,
                               n_ct, slice_start, n_slices, grid, variant,
                               stream);
}
