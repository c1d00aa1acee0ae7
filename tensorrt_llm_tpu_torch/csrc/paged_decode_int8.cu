// K6 paged_decode_int8 over int8 pages with f32 per-(token, head) scales:
// the entry point of the kernel in paged_decode.cuh.
#include "paged_decode.cuh"

// Over int8 pools [NB, Hkv, BS, D] (BS % 4 == 0) with f32 scale
// pools [NB, Hkv, BS] indexed by the same block ids.
extern "C" int tllm_paged_decode_int8(
    const void* q, const void* k_data, const void* k_scale,
    const void* v_data, const void* v_scale, const void* tables,
    const void* kv_lens, const void* sinks, void* workspace, void* counters,
    void* out, int B, int Hq, int Hkv, int D, int NB, int BS, int MB,
    float scale, int window, float cap, int n_splits, int split_len,
    int grid_x, void* stream) {
  return tllm::launch<int8_t>(q, k_data, v_data, k_scale, v_scale, tables,
                              kv_lens, sinks, workspace, counters, out, B, Hq,
                              Hkv, D, NB, BS, MB, scale, window, cap,
                              n_splits, split_len, grid_x, stream);
}
