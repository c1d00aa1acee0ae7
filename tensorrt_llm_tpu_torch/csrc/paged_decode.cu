// K4 paged_decode over bf16 pages: the entry point of the kernel in
// paged_decode.cuh (the design and what it replaces are described there).
#include "paged_decode.cuh"

// q/out [B, Hq, D] (D 64, 128 or 256; Hq / Hkv 1..16), pools [NB, Hkv,
// BS, D] bf16 (16-byte aligned; BS % 8 == 0), tables [B, MB] int32,
// kv_lens [B] int32 (including the new token), sinks [Hq] f32 or null,
// workspace B * Hkv * n_splits * Hq/Hkv * (D + 2) floats, counters B * Hkv
// zeroed ints (left zeroed); split_len a multiple of 64, grid_x the most
// splits a sequence's window spans.
extern "C" int tllm_paged_decode(const void* q, const void* k_cache,
                                 const void* v_cache, const void* tables,
                                 const void* kv_lens, const void* sinks,
                                 void* workspace, void* counters, void* out,
                                 int B, int Hq, int Hkv, int D, int NB, int BS,
                                 int MB, float scale, int window, float cap,
                                 int n_splits, int split_len, int grid_x,
                                 void* stream) {
  return tllm::launch<tllm::bf16>(q, k_cache, v_cache, nullptr, nullptr,
                                  tables, kv_lens, sinks, workspace, counters,
                                  out, B, Hq, Hkv, D, NB, BS, MB, scale,
                                  window, cap, n_splits, split_len, grid_x,
                                  stream);
}
