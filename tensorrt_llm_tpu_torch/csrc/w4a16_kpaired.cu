// K12 w4a16_kpaired: act(x @ ((q - z) * s) + b) from the 2-D K-paired
// packing [K/2, N], any M.
//
// Replaces the TPU kernel tensorrt_llm_tpu/ops/w4a16_gemm.py
// `_w4a16_kernel`, which runs where a weight's N has no 128-multiple
// column tile (GPT-OSS-20B o_proj, N = 2880; Moonlight and DeepSeek-V3.2
// kv_a, N = 576).
//
// Layout: within each pack group of Gp rows (`pack_group_for`: the scale
// group, or up to 256 rows per channel), byte [c*Gp/2 + r, n] holds row
// c*Gp + r in its low nibble and row c*Gp + Gp/2 + r in its high nibble.
//
// What bounds it on the H100: the K*N/2 weight bytes at decode; the
// tensor-core operations at a 256-row prefill chunk.
//
// Design: the shared Hopper mainloop (`w4a16_sm90.cuh`: TMA ring, wgmma
// with the register-dequantized weight as A and the token tile as B) on
// the K-paired packing.  A ring stage is 32 packed rows of one pack group
// and the two matching 32-column boxes of x, x[:, c*Gp + p0 ..] for the low
// nibbles and x[:, c*Gp + Gp/2 + p0 ..] for the high ones, so the pairs are
// summed as stored (Gp % 64 == 0: pack groups 64 to 256; at Gp 32 a stage
// is two whole pack groups over 64 contiguous K rows).  The rows of the
// packing are N contiguous bytes: TMA reads 64-column boxes, and columns
// past N (any N % 16 == 0) read as zeros and are not stored; 2880 = 45 x 64
// and 576 = 9 x 64 have no ragged edge.  A work unit is (M block of up to
// 128 tokens, column tile, K slice of `block_k` rows: whole pack groups);
// more than one slice adds the combine pass over f32 partials.
#include "w4a16_sm90.cuh"

// The wrapper (`ops/w4a16_gemm.py::w4a16_kpaired`) guarantees what
// `tllm::sm90::launch` states.
extern "C" int tllm_w4a16_kpaired(const void* x, const void* qweight,
                                  const void* scales, const void* zeros,
                                  const void* bias, void* workspace,
                                  void* out, int M, int N, int K, int group,
                                  int pack_group, int act, int ntok, int n_mb,
                                  int n_ct, const int* slice_start,
                                  int n_slices, int grid, void* stream) {
  return tllm::sm90::launch<1>(x, qweight, scales, zeros, bias, workspace, out,
                               M, N, K, group, pack_group, 0, act, ntok, n_mb,
                               n_ct, slice_start, n_slices, grid, 0, stream);
}
