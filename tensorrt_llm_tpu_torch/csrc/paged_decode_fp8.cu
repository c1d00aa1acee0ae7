// paged_decode_fp8, K4's instance over e4m3 (float8_e4m3fn) pages: the entry
// point of the kernel in paged_decode.cuh.
#include "paged_decode.cuh"

// Over e4m3 pools [NB, Hkv, BS, D] (BS % 4 == 0, no scales).
extern "C" int tllm_paged_decode_fp8(const void* q, const void* k_cache,
                                     const void* v_cache, const void* tables,
                                     const void* kv_lens, const void* sinks,
                                     void* workspace, void* counters,
                                     void* out, int B, int Hq, int Hkv, int D,
                                     int NB, int BS, int MB, float scale,
                                     int window, float cap, int n_splits,
                                     int split_len, int grid_x,
                                     void* stream) {
  return tllm::launch<tllm::e4m3>(q, k_cache, v_cache, nullptr, nullptr,
                                  tables, kv_lens, sinks, workspace, counters,
                                  out, B, Hq, Hkv, D, NB, BS, MB, scale,
                                  window, cap, n_splits, split_len, grid_x,
                                  stream);
}
