#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port (`tensorrt_llm_tpu_torch`) on one GPU.

    python3 chip_smoke.py            # all phases, one H100

Phases (any failure exits nonzero; nothing is caught and ignored):

1. the card's name and power limit (nvidia-smi);
2. build the fourteen CUDA kernels from `tensorrt_llm_tpu_torch/csrc` and
   print every wgmma ptxas serialized, by source (K5's and K8's checks
   fail on any in their sources), and the `-Xptxas -v` lines (registers,
   spills) of K2's and K4/K6's sources;
3. hold each kernel against its plain PyTorch version on the card at
   TinyLlama-1.1B, Llama-3-8B, GPT-OSS-20B, Mixtral-8x7B, Moonlight-16B-A3B
   and DeepSeek-V3/V3.2 shapes, and time kernel, plain version and one
   library call; one JSON line per kernel and shape (the INT8-KV attention
   kernels on freshly quantized int8 pools, the W4A8 GEMM at Llama-3-8B's
   projections and on K-paired weights of N 80 and 2880, with
   `w4a8_plan`'s K slices within 10% of the fastest count timed; the
   grouped expert GEMM K5 on its device-built unit list, which must equal
   the plain builder's, with `gmm_ntok`'s token tile within 10% of the
   fastest tile timed under uniform and skewed routing; the MLA kernels
   at 16 and 128 heads, the decode K9 called twice and held to the same
   bits, with `mla_decode_plan`'s split within 10% of the fastest split
   timed; the DSA scores K11 at V3.2's indexer (tables of 517 and the
   served 190 pages, B 4 and B 1), called twice and held to the same bits,
   with `dsa_score_plan`'s tiles a block within 10% of the fastest count
   timed; the K-paired GEMM at GPT-OSS o_proj and Moonlight/V3.2
   kv_a, the ramp GEMM at TinyLlama/Llama-3-8B projections, both also at
   the token counts on the edges of their token tiles (1, 5, 17, 255; K12
   also 300 and 600, past one M block) and at group 32, each called twice
   and held to the same bits, with the wrapper's host time per call, and
   `kpaired_block_k`'s K slice within 10% of the fastest one timed; the
   fused gated MLP K14 at TinyLlama/Llama-3-8B MLPs, called twice and
   held to the same bits, with the port's unfused sequence and a cuBLAS
   sequence (two torch.matmul on the dequantized weights) as yardsticks,
   its plan and per-block timestamps (grid barrier, phases), and
   `fused_mlp_plan`'s launch within 10% of the fastest candidate timed; the tiled GEMM K1 at the
   TinyLlama, Llama-3-8B and GPT-OSS projections from 1 to 512 tokens, in
   each of its configurations at two M 256 shapes, and its plan's
   (configuration, K slices) pick within 10% of the fastest choice timed;
   the INT8-KV prefill K7 also at 17 and 256 tokens after a 1024-token
   prefix, the bf16 one K3 at 17; the W4A16 GEMV K2 at every projection
   from 1 to 16 tokens with K1's time beside it, called twice and held to
   the same bits, and `gemv_plan`'s (column tile, K slices) within 10% of
   the fastest choice timed at 4 and 16 tokens; the paged decode K4/K6 at
   every decode row called twice and held to the same bits, with every
   split length timed and `decode_plan`'s within 10% of the fastest; the MLA prefill K10 also at 17 and 256
   tokens after a 1024-token prefix, where its plan splits the latent
   range over blocks: each row names the plan's blocks and splits, and
   the plan's split is held within 10% of the fastest split timed);
4. serve 8 greedy requests with `LLM.generate` on the full-width TinyLlama
   W4A16 model (random weights from a seed); every serve phase builds its
   `LLM` with the default warmup (the W4A16 autotuner prints each shape's
   candidates, device times and winner), resets the launch counters just
   before the run and reads them just after;
5. the same model with a tactic file that sets the ramp variant for every
   tiled shape: K13 three times per layer per forward, greedy tokens equal
   to phase 4's (or differing first at a near-tie); again with the stream
   variant: K2 at every decode step (`serve_stream`);
6. the fused gated MLP op on all 22 TinyLlama MLPs at 4 and 200 rows,
   against each layer's unfused forward, then the same calls under
   torch.profiler: one device operation a call;
7. the same weights at full width and 2 layers on the card and on the CPU
   (plain versions): logits and greedy tokens must agree (the MoE
   cross-checks of phases 10 and 16 force the CPU's routing only at
   bounded near-ties, `_RouteTies`);
8. a short `LLM.generate` run at Llama-3-8B width (2 layers), so that the
   attention kernels run at head dim 128 inside the model;
9. serve the 8 requests on GPT-OSS-20B at full width and depth, W4A16
   group 64 (MoE experts on K5, o_proj K-paired on K12 once per layer per
   forward, sinks, window 128, YaRN);
10. GPT-OSS-20B width at 2 layers (sliding then full) on the card and on
   the CPU: logits and greedy tokens must agree;
11. serve them on Llama-3-8B at full width, 8 layers, W4A8_AWQ group 128
   with an INT8 KV cache (K6/K7 attention, K8 for all four projections);
12. Llama-3-8B W4A8 + INT8 KV at 2 layers on the card and on the CPU:
   logits and greedy tokens must agree;
13. serve them on Moonlight-16B-A3B at full width and depth (27 layers,
   dense MLA on K9/K10, kv_a on K12, 26 MoE layers on K5 with shared
   experts and noaux_tc routing);
14. serve them, plus one 3,000-token prompt (past `index_topk` 2048), on
   DeepSeek-V3.2 widths at 4 layers (DSA: K11 scores every decode step,
   the sparse attention is plain torch; kv_a on K12; layer 3 is a
   256-expert MoE);
15. a short `LLM.generate` at DeepSeek-V3 width (2 dense layers) so that
   K9/K10 run at 128 heads inside the model;
16. Moonlight and V3.2 widths at 2 layers (V3.2 with `index_topk` 128, below
   the prompt) on the card and on the CPU: logits and greedy tokens must
   agree;
17. `checkpoint`: `LLM(model=<HF checkpoint dir>)` on checkpoints the script
   writes with its own safetensors writer (it needs no `safetensors`
   package): TinyLlama-1.1B at full width, 4 layers deep, in two bf16
   shards, W4A16 group 128 at load; the same weights AWQ-packed with zeros,
   taken as stored; Moonlight-16B-A3B widths at 2 layers, W4A16 at load.
   Each is served with the serve mix and a byte-level tokenizer object
   (build seconds, peak device memory and peak host RSS printed with the
   card), every output's text must be the tokenizer's decode of its
   tokens, a streamed text prompt must rebuild the whole one's tokens and
   text, and every loaded buffer must equal the CPU's load of the same
   directory byte for byte; the TinyLlama ones are also cut to 2 layers
   and cross-checked against the CPU as in phase 7;
18. `bench`: the bench CLI's presets (`commands/bench.py` `MODEL_SHAPES`:
   TinyLlama-1.1B, Llama-3-8B, Llama-2-7B, GPT-OSS-20B) at full width and
   the depths of `BENCH_LAYERS`, W4A16, random weights, native KV bookkeeping, served by the
   CLI's `run_throughput` (ISL 128, OSL 128, `ignore_eos`, 32 requests at
   concurrency 32, `max_batch_size` 32) with the overlap pipeline on and
   every decode chunk's dispatch half under
   `torch.cuda.set_sync_debug_mode("error")` (`SyncChecked`), launches
   asserted per layer per forward; TinyLlama and GPT-OSS also on a second
   `LLM` with the pipeline off, the timed runs interleaved off, on, on,
   off, greedy tokens equal (or first differing at a near-tie);
   `run_latency` on TinyLlama; a throughput run with one failing request
   ends and reports it; K3 first at the chunks partial KV reuse gives it
   (1 token after 127, 20 and 45 after 300) and at Llama-2-7B's 128-token
   warmup prompt. Each report is printed beside the card's name and power
   limit. Phase 3 holds K1/K2 at Llama-2-7B's projections and at the
   bench's token counts (32, 2048), and K4 at its batch of 32;
19. `bench_cross`: the Llama-3-8B and Llama-2-7B bench presets' widths at
   2 layers, W4A16, cross-checked against the CPU as in phase 7;
20. `sampling`: the host logits path on Llama-3-8B W4A16 at full width and
   depth with a byte-level tokenizer (random weights): a reference batch;
   a stop string spanning a token boundary in the same batch under fused
   chunks (`decode_steps > 1`), whose tokens must be the reference's cut
   at the match and whose text drops the stop string (or keeps it under
   `include_stop_str_in_output`); penalties, logit bias, bad words,
   min-tokens, no repeated 3-gram, a `logits_processor` (it must get
   tensors on the card) and guided regex, choice and JSON, each output
   token held against the port's plain controls applied on the CPU, in
   f32, to the request's own raw row (the argmax, or within 0.02 of the
   top), top-5 logprobs and prompt logprobs within 1e-3 of the plain
   log-softmax, the last context row equal to the first generation row
   bit for bit, guided outputs parsed; `n=4` sampled twice under fresh
   salts equal, greedy `n=4` equal or first differing at a near-tie; K1/K2
   and K3/K4 launches asserted per layer per forward over these runs; the
   tokens/s of 32 plain requests against the same with one
   repetition-penalty request (recorded, interleaved); then
   `batched_logits_processor` on TinyLlama-1.1B at full depth (its forced
   tokens, tensors on the card, launches per layer per forward);
21. `openai`: Llama-3-8B W4A16 at full width and depth (random weights,
   `ByteTokenizer`) served by the port's `OpenAIServer` on 127.0.0.1:
   every route (health, models, version, clock, metrics, perf metrics,
   traces, health_generate, the embeddings refusal); a greedy completion
   whose text equals `llm.generate`'s, streamed too, its SSE deltas equal
   to the whole text; chat on the fallback template, whole and streamed;
   a forced tool call whose arguments parse as JSON of the tool's schema;
   `/v1/responses`, whole and streamed; the KV events of a shared-prefix
   pair against chain hashes computed here, and `/prefix_match`; a
   release refused with a stream in flight, then release and resume with
   `torch.cuda.memory_allocated` before, between and after (the freed
   bytes printed) and the same greedy tokens after; a dropped stream
   cancelled with its blocks freed.  Then the load generator
   (`commands/benchmark_serving.py`) at the bench mix (ISL 128, OSL 128,
   32 requests at concurrency 32) against the server and the same mix in
   process (`run_throughput`), interleaved HTTP, in process, in process,
   HTTP, output tok/s, TTFT, TPOT and ITL p50/p99 printed beside the
   card; K1, K3 and K4 (K2 where the tuner picks it) asserted per layer
   per forward over the checks and the first HTTP run.  Last,
   `python -m tensorrt_llm_tpu_torch.commands.serve` on a 2-layer
   TinyLlama-width checkpoint in a subprocess: /health, one token-id
   completion, exit 0 on SIGINT;
22. `disagg` (run before `bench`): disaggregated serving, TinyLlama W4A16
   at full width and depth as a context and a generation worker of one
   process behind an `OpenAIDisaggServer` they register with, the serve
   mix in the two-phase, stream_kv and conditional modes (tokens against
   the generation worker's own batch, K3/K4 per worker per layer per
   chunk or step, no K3 on the generation worker for a transferred prompt,
   the context pool empty after each mode), the 600-token prompt's KV
   frames against the context worker's prefill chunks, then the host KV
   tier and a dict connector (`disagg_phase`).

Depth cuts that keep the script in its time limit (widths unchanged): the
bench presets (`BENCH_LAYERS`: Llama-3-8B and Llama-2-7B 4 layers,
TinyLlama and GPT-OSS 8; each model runs at full depth in `sampling` /
`openai`, `serve` and `gptoss`), the W4A8 serve (`LLAMA3_W4A8_LAYERS`
8) and the `checkpoint` phase's TinyLlama (`CKPT_TINYLLAMA_LAYERS` 4).

Arguments pick phases (default: check serve serve_ramp serve_stream
fused_mlp cross llama3 gptoss gptoss_cross llama3_w4a8 llama3_w4a8_cross
deepseek deepseek_v32 deepseek_v3_width deepseek_cross checkpoint sampling
openai disagg bench bench_cross);
`check_moe` runs
only K5's checks, `check_w4a8` only K8's, `check_int8` only K6-K8's,
`check_mla` only K9-K11's (with their plans' checks),
`check_w4a16` only K12-K14's and `check_k1` only K1's; `profile`,
`profile_gptoss`, `profile_llama3_int8`, `profile_deepseek` and
`profile_deepseek_v32`, run only when named, trace a short serve window
with torch.profiler (the DeepSeek ones fail if K9 runs a combine pass);
`cross_breakdown`, run only when named, repeats phase 12 with W4A16
weights and with bf16 KV pools to split its logit gap;
`mla_decode_breakdown`, run only when named, times K9 at 1 to 1,000
tokens on a 4,000-token table and in one split with the pool HBM-cold and
L2-resident; `dsa_cross_breakdown`, run only when named, repeats the V3.2
part of phase 16 at a covering top-k and at 128 and counts where the
card's and the CPU's top-k selections differ; `route_witness`, run only
when named, repeats the GPT-OSS and Moonlight cross-checks without forcing
any routing, with K12 and with K12's calls replaced by its plain version,
and lists where each run's routing flips; `bench_overlap`, run only when
named, times TinyLlama and GPT-OSS with the overlap pipeline off, on, and
on with the dispatch halves sync-checked, 8 runs interleaved a preset;
`gemv_sweep`, run only when named, times every K2 (column tile, K
slices) choice at 112 shapes beside `gemv_plan`'s pick.
`--json PATH` also writes every check and phase summary to PATH.

The last three lines of stdout are the card's name and power limit, the
`kernels` JSON object (one row per TPU kernel body: 16 rows, the D=128
bodies of K3 and K4 served by the same kernels as D=64, on the `openai`
path) and the device JSON object.  Without a CUDA device,
or without the package beside it, the script exits nonzero before printing
any result.  It imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time
import types

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES = 3.35e12       # H100 SXM HBM3, bytes/s
PEAK_BF16 = 989e12         # H100 SXM dense bf16 tensor-core FLOP/s
PEAK_INT8 = 1979e12        # H100 SXM dense int8 tensor-core OP/s
ROT_BYTES = 128 << 20      # rotate operands past the 50 MB L2 when timing

RESULTS = []               # one dict per kernel check
PHASES = {}                # summaries of the other phases, by name
DEVICE = "cuda"

# (K, N) of the QKV, o, gate_up and down projections
GEMM_SHAPES = {"tinyllama": [(2048, 2560), (2048, 2048), (2048, 11264),
                             (5632, 2048)],
               "llama-3-8b": [(4096, 6144), (4096, 4096), (4096, 28672),
                              (14336, 4096)],
               # QKV (o's N = 2880 has no 128-multiple tile: K-paired, on
               # K12, checked in check_w4a16)
               "gpt-oss-20b": [(2880, 5120)],
               # the bench preset (intermediate 11,008; o's (4096, 4096)
               # is Llama-3-8B's)
               "llama-2-7b": [(4096, 12288), (4096, 22016), (11008, 4096)]}
GEMM_GROUP = {"gpt-oss-20b": 64}          # others: 128
# 32: the bench's decode at batch 32; 2048: its warmup's prefill
# (`max_num_tokens` 2048 of 128-token prompts)
GEMM_M = (1, 4, 8, 16, 17, 32, 128, 200, 255, 256, 512, 2048)
# K8's token counts (its path, `serve_llama3_w4a8`, not the bench's)
W4A8_M = (1, 4, 8, 16, 17, 128, 200, 255, 256, 512)
# K1's configurations (`K1_VARIANTS`) timed with and without each prefill
# mechanism at served M 256 shapes, and its (configuration, K slices)
# pick held against every choice at the token counts below
K1_VARIANT_SHAPES = [("gpt-oss-20b", 2880, 5120, 64),
                     ("tinyllama", 2048, 11264, 128)]
K1_CHOICE_M = (17, 128, 256, 512)
K1_SLICE_SLACK = 0.10
# `gemv_plan` (a model of K2's time) must pick a (column tile, K slices)
# within this share of the fastest choice's time at every served tiled
# shape at these token counts
GEMV_PLAN_M = (4, 16)
GEMV_PLAN_SLACK = 0.10
# K1's reach beyond the served shapes: a K % 64 == 32 tail (half a stage)
# and groups that end in the middle of a stage (G 32, G 96), with and
# without zero points, bias and an activation: (K, N, G, M values)
K1_EDGE_SHAPES = [(96, 256, 32, (5, 130)), (288, 128, 96, (3, 129)),
                  (2080, 384, 32, (17, 256))]
# (K, N, E, G) of the expert gate_up and down products
MOE_SHAPES = {"gpt-oss-20b": [(2880, 5760, 32, 64), (2880, 2880, 32, 64)],
              "mixtral-8x7b": [(4096, 28672, 8, 128), (14336, 4096, 8, 128)],
              "moonlight-16b-a3b": [(2048, 2816, 64, 128),
                                    (1408, 2048, 64, 128)],
              "deepseek-v3.2": [(7168, 4096, 256, 128),
                                (2048, 7168, 256, 128)]}
MOE_M = (16, 32, 1024)                    # T x top-k rows
# DeepSeek rows: 4 decode tokens and a 256-token chunk, x top-6 / top-8
MOE_M_BY_MODEL = {"moonlight-16b-a3b": (24, 1536),
                  "deepseek-v3.2": (32, 2048)}
MOE_M_ZEROS = (32, 1024)                  # zero-point experts (off the path)
MOE_ZEROS_MODELS = ("gpt-oss-20b", "mixtral-8x7b")
# `gmm_ntok` (a model of K5's time) must pick a token tile within this
# share of the fastest tile's time at every symmetric check_moe row
GMM_NTOK_SLACK = 0.10
PREFILL_CASES = [
    # model, Hq, Hkv, D, T, q_offset, window, cap, sinks
    ("tinyllama", 32, 4, 64, 256, 256, None, None, False),
    ("tinyllama", 32, 4, 64, 512, 0, None, None, False),
    ("tinyllama", 32, 4, 64, 100, 200, None, None, True),
    ("tinyllama", 32, 4, 64, 100, 200, None, 30.0, False),
    ("tinyllama", 32, 4, 64, 100, 200, 128, None, False),
    ("llama-3-8b", 32, 8, 128, 256, 256, None, None, False),
    ("llama-3-8b", 32, 8, 128, 512, 0, None, None, False),
    ("llama-3-8b", 32, 8, 128, 128, 300, 96, 25.0, True),
    # GPT-OSS-20B as it serves: sinks on every layer, window 128 on the
    # sliding ones, chunks of 256 that start inside and past the window
    ("gpt-oss-20b", 64, 8, 64, 256, 0, 128, None, True),
    ("gpt-oss-20b", 64, 8, 64, 256, 128, 128, None, True),
    ("gpt-oss-20b", 64, 8, 64, 256, 256, None, None, True),
    # a short chunk after a long prefix (one block per KV head walks it)
    ("llama-3-8b", 32, 8, 128, 17, 1024, None, None, False),
]
# the INT8-KV kernels K6/K7 at the D=128 cases above and one D=64 case;
# K7 also at a short and a long chunk after a 1024-token prefix
PREFILL_INT8_CASES = [
    c for c in PREFILL_CASES if c[0] == "llama-3-8b" and c[5] != 1024] + [
    ("tinyllama", 32, 4, 64, 256, 256, None, None, False),
    ("llama-3-8b", 32, 8, 128, 17, 1024, None, None, False),
    ("llama-3-8b", 32, 8, 128, 256, 1024, None, None, False)]
BENCH_DECODE_LENS = [129 + 4 * i for i in range(32)]   # 129 .. 253
DECODE_CASES = [
    # model, Hq, Hkv, D, kv_lens, window, cap, sinks
    ("tinyllama", 32, 4, 64, [81, 150, 400, 664], None, None, False),
    ("tinyllama", 32, 4, 64, [17, 300, 600, 1000, 33, 64, 65, 2000],
     None, None, False),
    ("tinyllama", 32, 4, 64, [81, 150, 400, 664], None, None, True),
    ("tinyllama", 32, 4, 64, [81, 150, 400, 664], None, 30.0, False),
    ("tinyllama", 32, 4, 64, [81, 150, 400, 664], 128, None, False),
    ("llama-3-8b", 32, 8, 128, [320, 400, 1000, 4000], None, None, False),
    ("llama-3-8b", 32, 8, 128, [33, 320], 96, 25.0, True),
    ("gpt-oss-20b", 64, 8, 64, [81, 150, 400, 664], 128, None, True),
    ("gpt-oss-20b", 64, 8, 64, [81, 150, 400, 664], None, None, True),
    # the bench presets' decode at batch 32 (ISL 128, OSL 128), Llama-2-7B
    # with its GQA group of 1
    ("llama-2-7b", 32, 32, 128, BENCH_DECODE_LENS, None, None, False),
    ("llama-2-7b", 32, 32, 128, [33, 320, 1000, 4000], None, None, False),
    ("tinyllama", 32, 4, 64, BENCH_DECODE_LENS, None, None, False),
    ("llama-3-8b", 32, 8, 128, BENCH_DECODE_LENS, None, None, False),
    ("gpt-oss-20b", 64, 8, 64, BENCH_DECODE_LENS, 128, None, True),
    ("gpt-oss-20b", 64, 8, 64, BENCH_DECODE_LENS, None, None, True),
]
DECODE_INT8_CASES = [c for c in DECODE_CASES if c[0] == "llama-3-8b"
                     and c[4] is not BENCH_DECODE_LENS] + [
    ("tinyllama", 32, 4, 64, [81, 150, 400, 664], None, None, False)]
# `decode_plan`'s split length must be within this share of the fastest
# split length's time at every decode row (bf16 and int8 pools)
DECODE_PLAN_SLACK = 0.10
W4A8_MODEL = "llama-3-8b"       # K8's (K, N) come from GEMM_SHAPES
W4A8_KPAIRED_M = (1, 4, 17, 256)  # K8 on a K-paired weight
# `w4a8_plan`'s K slice count (a model of K8's time) must be within this
# share of the fastest count's time at the served projections at these
# token counts and at every W4A8_KPAIRED_M row
W4A8_SLICE_M = (4, 17, 256)
W4A8_SLICE_SLACK = 0.10
# K12: (model, weight, K, N, G) of the K-paired weights on the serve paths
# (N % 128 != 0), and one per-channel case (G = -1)
KPAIRED_SHAPES = [("gpt-oss-20b", "o_proj", 4096, 2880, 64),
                  ("moonlight-16b-a3b", "kv_a", 2048, 576, 128),
                  ("deepseek-v3.2", "kv_a", 7168, 576, 128),
                  ("moonlight-16b-a3b", "kv_a", 2048, 576, -1)]
KPAIRED_M = (1, 4, 16, 256)
KPAIRED_EXTRA_M = (4, 256)      # zero points, bias and silu
# G 32 (two scale rows a ring stage; the JAX package takes group 32) at
# the served widths: K12 at Moonlight kv_a, K13 at TinyLlama qkv
G32_KPAIRED = ("moonlight-16b-a3b", "kv_a", 2048, 576)
G32_RAMP = ("tinyllama", 2048, 2560)
G32_M = (4, 17, 256)
# `kpaired_block_k` (a model of K12's time) must pick a K slice whose time
# is within this share of the fastest slice's at each KPAIRED_SHAPES row
KPAIRED_BK_SLACK = 0.10
# token counts at the edges of K12's and K13's token tiles (8, 16, 32,
# ..., 256) and, for K12, past one 256-row M block
KPAIRED_EDGE_M = (5, 17, 255, 300, 600)
RAMP_EDGE_M = (1, 5, 17, 255)
# K13: the projections with K % 1024 == 0 (model, K, N), decode and a
# 256-token chunk; schedules from ramp_schedule (K 2048: two steps of one
# slab, K 4096: one slab then three) and with ramp_bk0 2048 (K 2048: one
# step of two slabs, K 4096: two steps of two)
RAMP_SHAPES = [("tinyllama", 2048, 2560), ("tinyllama", 2048, 2048),
               ("tinyllama", 2048, 11264), ("llama-3-8b", 4096, 6144),
               ("llama-3-8b", 4096, 4096), ("llama-3-8b", 4096, 28672)]
RAMP_M = (4, 16, 256)
# K14: (model, K, I) gated MLPs
FUSED_SHAPES = [("tinyllama", 2048, 5632), ("llama-3-8b", 4096, 14336)]
FUSED_M = (1, 4, 16, 64, 200)
FUSED_ZEROS_M = (4, 64)         # zero points and biases


def log(*a):
    print(*a, flush=True)


def bound_ms(nbytes, ops, peak_ops=PEAK_BF16):
    tb, to = nbytes / PEAK_BYTES, ops / peak_ops
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def cuda_ms(fn_list, iters):
    """Mean device time of one call, cycling through fn_list (distinct
    operand copies, so weights and KV come from HBM as on the main path).
    A spin kernel holds the stream while the host enqueues every call, so
    the events time the device back to back, not the host's launch rate."""
    import torch
    for f in fn_list[:2]:
        f()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)   # ~20 ms at 1.98 GHz
    t0.record()
    for i in range(iters):
        fn_list[i % len(fn_list)]()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def copies_for(nbytes):
    return max(1, min(64, math.ceil(ROT_BYTES / max(nbytes, 1))))


def record(kernel, shape, err, tol, k_ms, p_ms, lib_ms, b, **extra):
    ok = err <= tol
    row = {"kernel": kernel, "shape": shape, "max_err": err, "tol": tol,
           "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms,
           "bound_ms": b[0], "bound_by": b[1], "ok": ok, **extra}
    RESULTS.append(row)
    log(json.dumps(row))
    if not ok:
        raise AssertionError(f"{kernel} {shape}: max_err {err} > tol {tol}")


# --------------------------------------------------------------- phase 3 ---
def check_gemm(gen, dev):
    import torch
    from tensorrt_llm_tpu_torch.ops import w4a16_gemm as W
    from tensorrt_llm_tpu_torch.quantization import (
        choose_block_n, dequantize_w4_any, pack_w4_tiled, quantize_w4)
    for model, kns in GEMM_SHAPES.items():
        G = GEMM_GROUP.get(model, 128)
        for K, N in kns:
            w = torch.randn((K, N), generator=gen, device=dev) * 0.02
            q, s, _ = quantize_w4(w, G)
            packed = pack_w4_tiled(q, choose_block_n(N))
            s = s.to(torch.bfloat16)
            wq_bytes = packed.numel() + s.numel() * 2
            n_copy = copies_for(wq_bytes)
            ws = [(packed.clone(), s.clone()) for _ in range(n_copy)]
            wdq = dequantize_w4_any(packed, s).to(torch.bfloat16)
            lib_w = [wdq.clone() for _ in range(copies_for(wdq.numel() * 2))]
            del w, q
            cases = [(M, None, False) for M in GEMM_M]
            if (K, N) == (2048, 2560):
                # the fused epilogue and zero points (off the main path)
                cases += [(4, "silu", True), (256, "silu", True)]
            for M, act, extras in cases:
                x = (torch.randn((M, K), generator=gen, device=dev)
                     ).to(torch.bfloat16)
                fn = W.w4a16_gemv if M <= W.GEMV_MAX_M else W.w4a16_gemm
                name = "w4a16_gemv" if M <= W.GEMV_MAX_M else "w4a16_gemm"
                z = b = None
                if extras:
                    z = torch.randint(-8, 8, s.shape, generator=gen,
                                      device=dev).to(torch.bfloat16)
                    b = torch.randn((N,), generator=gen, device=dev)
                out = fn(x, packed, s, z, b, act)
                ref = W.w4a16_matmul_plain(x, packed, s, z, b, act)
                shape = {"model": model, "M": M, "K": K, "N": N, "G": G,
                         "act": act, "zeros_bias": extras}
                if name == "w4a16_gemm":
                    plan = W.k1_plan(M, K, N)
                    shape.update(config=W.K1_VARIANTS[plan["variant"]],
                                 slices=plan["slices"])
                else:
                    plan = W.gemv_plan(M, K, N, G, packed.shape[2])
                    shape.update(cols=plan["cols"], slices=plan["slices"])
                # a second call held to the same bits (both sum their K
                # slices in a fixed order)
                assert torch.equal(out, fn(x, packed, s, z, b, act)), \
                    f"{name} {shape}: second call differs"
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                # the plain version rounds each dequantized weight to bf16
                # (2^-9 relative), the kernel scales the f32 partial; both
                # round the output to bf16: 2% of the largest output
                tol = 2e-2 * ref.float().abs().max().item()
                k_ms = cuda_ms([lambda p=p, sc=sc: fn(x, p, sc, z, b, act)
                                for p, sc in ws], 30)
                p_ms = cuda_ms([lambda: W.w4a16_matmul_plain(
                    x, packed, s, z, b, act)], 5)
                l_ms = (cuda_ms([lambda lw=lw: torch.matmul(x, lw)
                                 for lw in lib_w], 30)
                        if not extras else None)
                # K1 beside K2 at decode: the tuner times both there
                extra = ({"k1_ms": cuda_ms([lambda p=p, sc=sc: W.w4a16_gemm(
                    x, p, sc, z, b, act) for p, sc in ws], 30)}
                    if name == "w4a16_gemv" else {})
                nbytes = M * K * 2 + wq_bytes + M * N * 2
                record(name, shape, err, tol, k_ms, p_ms, l_ms,
                       bound_ms(nbytes, 2 * M * N * K), **extra)
                if name == "w4a16_gemv" and M in GEMV_PLAN_M and not extras:
                    check_gemv_plan(x, ws, G, model)
            del ws, lib_w, wdq
            torch.cuda.empty_cache()
    check_k1_variants(gen, dev)
    check_k1_edges(gen, dev)
    check_k1_choice(gen, dev)


def check_gemv_plan(x, ws, G, model):
    """Time every (column tile, K slices) K2 takes at this shape and M and
    fail if `gemv_plan`'s pick is more than GEMV_PLAN_SLACK slower than the
    fastest."""
    from tensorrt_llm_tpu_torch.ops import w4a16_gemm as W
    M, K = x.shape
    packed = ws[0][0]
    bn = packed.shape[2]
    N = packed.shape[0] * bn
    plan = W.gemv_plan(M, K, N, G, bn)
    times = {c: cuda_ms([lambda p=p, sc=sc, c=c: W.w4a16_gemv(
        x, p, sc, ctw=c[0], slices=c[1]) for p, sc in ws], 20)
        for c in W.gemv_choices(M, K, G, bn)}
    best = min(times, key=times.get)
    pick = (plan["ctw"], plan["slices"])
    ratio = times[pick] / times[best]
    row = {"model": model, "M": M, "K": K, "N": N, "pick": pick,
           "pick_ms": times[pick], "best": best, "best_ms": times[best],
           "ratio": ratio, "choices": len(times),
           "ms": {f"{c}/{d}": t for (c, d), t in times.items()}}
    PHASES.setdefault("gemv_plan", []).append(row)
    log(json.dumps({"gemv_plan": {k: v for k, v in row.items()
                                  if k != "ms"}}))
    assert ratio <= 1 + GEMV_PLAN_SLACK, \
        f"gemv_plan picks {pick} at {row}: {ratio:.3f}x the fastest {best}"


# `gemv_sweep`: K2's column tiles (of 256 columns) at K 4096, and a few
# at other K, for fitting `gemv_plan`'s rule
GEMV_SWEEP_TILES = (8, 16, 24, 32, 40, 48, 56, 64, 72, 80, 86, 96, 104, 112,
                    120, 128, 160)
GEMV_SWEEP_OTHER = ((2048, (8, 44, 86, 112)), (11008, (16, 44, 86)),
                    (14336, (16, 44, 86, 112)))
GEMV_SWEEP_M = (1, 4, 8, 16)


def gemv_sweep(gen, dev):
    """Opt-in: every (column tile, K slices) K2 takes, timed at
    GEMV_SWEEP_TILES x GEMV_SWEEP_M (K 4096, G 128) and at
    GEMV_SWEEP_OTHER, beside `gemv_plan`'s pick; asserts nothing."""
    from tensorrt_llm_tpu_torch.ops import w4a16_gemm as W
    import torch
    rows = []
    shapes = [(4096, t) for t in GEMV_SWEEP_TILES] + [
        (K, t) for K, ts in GEMV_SWEEP_OTHER for t in ts]
    for K, tiles in shapes:
        N = 256 * tiles
        packed, s, ws = _k1_weight_copies(gen, dev, K, N, 128)
        bn = packed.shape[2]
        for M in GEMV_SWEEP_M:
            x = torch.randn((M, K), generator=gen, device=dev).to(
                torch.bfloat16)
            times = {c: cuda_ms([lambda p=p, sc=sc, c=c: W.w4a16_gemv(
                x, p, sc, ctw=c[0], slices=c[1]) for p, sc in ws], 20)
                for c in W.gemv_choices(M, K, 128, bn)}
            plan = W.gemv_plan(M, K, N, 128, bn)
            pick = (plan["ctw"], plan["slices"])
            best = min(times, key=times.get)
            rows.append({"K": K, "N": N, "tiles": tiles, "M": M,
                         "pick": pick, "best": best,
                         "ratio": times[pick] / times[best],
                         "ms": {f"{c}/{d}": t
                                for (c, d), t in times.items()}})
            log(json.dumps({"gemv_sweep": rows[-1]}))
        del packed, s, ws
        torch.cuda.empty_cache()
    PHASES["gemv_sweep"] = rows


def check_k1_edges(gen, dev):
    """K1 at the shapes its first version took that the mainloop needed
    new handling for (K1_EDGE_SHAPES), against the plain version."""
    import torch
    from tensorrt_llm_tpu_torch.ops import w4a16_gemm as W
    for K, N, G, ms in K1_EDGE_SHAPES:
        for sym in (True, False):
            packed, s, z = _w4_weight(gen, dev, K, N, G, kpaired=False,
                                      symmetric=sym)
            b = None if sym else torch.randn((N,), generator=gen, device=dev)
            act = None if sym else "silu"
            for M in ms:
                x = torch.randn((M, K), generator=gen, device=dev).to(
                    torch.bfloat16)
                out = W.w4a16_gemm(x, packed, s, z, b, act)
                ref = W.w4a16_matmul_plain(x, packed, s, z, b, act)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                tol = 2e-2 * ref.float().abs().max().item()
                k_ms = cuda_ms([lambda: W.w4a16_gemm(x, packed, s, z, b, act)],
                               10)
                p_ms = cuda_ms([lambda: W.w4a16_matmul_plain(
                    x, packed, s, z, b, act)], 3)
                plan = W.k1_plan(M, K, N)
                nbytes = (M * K * 2 + packed.numel()
                          + s.numel() * 2 * (1 if sym else 2) + M * N * 2)
                record("w4a16_gemm", {"model": "edge", "M": M, "K": K, "N": N,
                                      "G": G, "zeros_bias": not sym,
                                      "act": act, "slices": plan["slices"],
                                      "config": W.K1_VARIANTS[plan["variant"]]},
                       err, tol, k_ms, p_ms, None,
                       bound_ms(nbytes, 2 * M * N * K))


def _k1_weight_copies(gen, dev, K, N, G):
    """A random tiled W4A16 weight and enough copies of it to rotate past
    the L2 when timing."""
    import torch
    packed, s, _ = _w4_weight(gen, dev, K, N, G, kpaired=False)
    return packed, s, [(packed.clone(), s.clone()) for _ in range(
        copies_for(packed.numel() + s.numel() * 2))]


def check_k1_variants(gen, dev):
    """K1 in each of its configurations (`K1_VARIANTS`: the K13 mainloop,
    then one prefill mechanism added at a time) at served M 256 shapes,
    each with the K slices its plan takes, against the plain version."""
    import torch
    from tensorrt_llm_tpu_torch.ops import w4a16_gemm as W
    from tensorrt_llm_tpu_torch.quantization import dequantize_w4_any
    for model, K, N, G in K1_VARIANT_SHAPES:
        packed, s, ws = _k1_weight_copies(gen, dev, K, N, G)
        wdq = dequantize_w4_any(packed, s).to(torch.bfloat16)
        lib_w = [wdq.clone() for _ in range(copies_for(wdq.numel() * 2))]
        M = 256
        x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
        ref = W.w4a16_matmul_plain(x, packed, s)
        p_ms = cuda_ms([lambda: W.w4a16_matmul_plain(x, packed, s)], 5)
        l_ms = cuda_ms([lambda lw=lw: torch.matmul(x, lw) for lw in lib_w], 30)
        for v, name in enumerate(W.K1_VARIANTS):
            plan = W.k1_plan(M, K, N, variant=v)
            out = W.w4a16_gemm(x, packed, s, variant=v)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            tol = 2e-2 * ref.float().abs().max().item()
            k_ms = cuda_ms([lambda p=p, sc=sc: W.w4a16_gemm(
                x, p, sc, variant=v) for p, sc in ws], 30)
            nbytes = M * K * 2 + packed.numel() + s.numel() * 2 + M * N * 2
            record("w4a16_gemm", {"model": model, "M": M, "K": K, "N": N,
                                  "G": G, "config": name,
                                  "slices": plan["slices"],
                                  "variant_row": True},
                   err, tol, k_ms, p_ms, l_ms,
                   bound_ms(nbytes, 2 * M * N * K))
        del ws, lib_w, wdq
        torch.cuda.empty_cache()


def check_k1_choice(gen, dev):
    """`k1_choice`'s (configuration, K slices) against every choice K1
    can take (`K1_PATH_VARIANTS` x `k1_slice_choices`), each timed at every
    GEMM_SHAPES row and K1_CHOICE_M: the pick must be within
    K1_SLICE_SLACK of the fastest.  The pick comes from a model whose
    costs were fitted on the H100; this check shows when a change to the
    mainloop makes them stale."""
    import torch
    from tensorrt_llm_tpu_torch.ops import w4a16_gemm as W
    rows = []
    for model, kns in GEMM_SHAPES.items():
        G = GEMM_GROUP.get(model, 128)
        for K, N in kns:
            packed, s, ws = _k1_weight_copies(gen, dev, K, N, G)
            for M in K1_CHOICE_M:
                x = torch.randn((M, K), generator=gen, device=dev).to(
                    torch.bfloat16)
                variants = (W.K1_PATH_VARIANTS if M > 64
                            else W.K1_PATH_VARIANTS[:1])
                times = {(v, d): cuda_ms([
                    lambda p=p, sc=sc, v=v, d=d: W.w4a16_gemm(
                        x, p, sc, slices=d, variant=v) for p, sc in ws], 10)
                    for v in variants for d in W.k1_slice_choices(K)}
                pick = W.k1_choice(M, K, N)
                best = min(times, key=times.get)
                rows.append({"model": model, "M": M, "K": K, "N": N,
                             "pick": [W.K1_VARIANTS[pick[0]], pick[1]],
                             "fastest": [W.K1_VARIANTS[best[0]], best[1]],
                             "pick_ms": times[pick], "fastest_ms": times[best],
                             "pick_over_fastest": times[pick] / times[best],
                             "ms": {f"{W.K1_VARIANTS[v]}/{d}": t
                                    for (v, d), t in times.items()}})
                log(json.dumps({k: v for k, v in rows[-1].items()
                                if k != "ms"}))
            del ws
            torch.cuda.empty_cache()
    worst = max(r["pick_over_fastest"] for r in rows)
    PHASES["k1_choice"] = {"phase": "k1_choice", "rows": rows,
                           "worst_pick_over_fastest": worst,
                           "slack": K1_SLICE_SLACK}
    bad = [(r["model"], r["K"], r["N"], r["M"], r["pick"], r["fastest"],
            r["pick_over_fastest"]) for r in rows
           if r["pick_over_fastest"] > 1 + K1_SLICE_SLACK]
    assert not bad, f"k1_choice picks slower than the slack: {bad}"


def _w4_weight(gen, dev, K, N, G, kpaired, symmetric=True):
    """A random [K, N] weight quantized W4A16 (bf16 scales and zeros),
    K-paired or tiled as the model would store it."""
    import torch
    from tensorrt_llm_tpu_torch.quantization import (
        choose_block_n, pack_group_for, pack_w4, pack_w4_tiled, quantize_w4)
    w = torch.randn((K, N), generator=gen, device=dev) * 0.02
    q, s, z = quantize_w4(w, G, symmetric=symmetric)
    packed = (pack_w4(q, pack_group_for(K, s.shape[0])) if kpaired
              else pack_w4_tiled(q, choose_block_n(N)))
    return (packed, s.to(torch.bfloat16),
            None if z is None else z.to(torch.bfloat16))


def host_us(fn, iters=50):
    """Host time of one wrapper call (checks, plan, tensor maps, launch),
    with the stream held by a spin kernel so that no call waits on the
    device."""
    import torch
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)   # ~50 ms at 1.98 GHz
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return dt


def _check_w4_case(name, shape, fn, x, packed, s, z, b, act, lib_w):
    """One W4A16 kernel against `w4a16_matmul_plain`, timed with its
    operands rotated past L2; the library yardstick (torch.matmul on the
    dequantized bf16 weight) only without extras.  A second call must give
    the same bits (the split-K sum has a fixed order), and the wrapper's
    host time per call is recorded beside the device time."""
    import torch
    from tensorrt_llm_tpu_torch.ops import w4a16_gemm as W
    out = fn(x, packed, s, z, b, act)
    again = fn(x, packed, s, z, b, act)
    ref = W.w4a16_matmul_plain(x, packed, s, z, b, act)
    torch.cuda.synchronize()
    assert torch.equal(out, again), f"{name} {shape}: second call differs"
    shape = dict(shape, repeat_bitwise=True,
                 host_us=host_us(lambda: fn(x, packed, s, z, b, act)))
    err = (out.float() - ref.float()).abs().max().item()
    # the plain version rounds each dequantized weight to bf16 (2^-9
    # relative), the kernel scales the f32 partial; both round the output
    # to bf16: 2% of the largest output (check_gemm's tolerance)
    tol = 2e-2 * ref.float().abs().max().item()
    wq_bytes = packed.numel() + s.numel() * 2 * (1 if z is None else 2)
    ws = [(packed.clone(), s.clone(), None if z is None else z.clone())
          for _ in range(copies_for(wq_bytes))]
    k_ms = cuda_ms([lambda p=p, sc=sc, zz=zz: fn(x, p, sc, zz, b, act)
                    for p, sc, zz in ws], 30)
    del ws
    p_ms = cuda_ms([lambda: W.w4a16_matmul_plain(x, packed, s, z, b, act)],
                   5)
    l_ms = (cuda_ms([lambda lw=lw: torch.matmul(x, lw) for lw in lib_w], 30)
            if lib_w is not None and act is None and z is None else None)
    M, K = x.shape
    N = s.shape[1]
    nbytes = (M * K * 2 + wq_bytes + M * N * 2
              + (0 if b is None else N * 4))
    record(name, shape, err, tol, k_ms, p_ms, l_ms,
           bound_ms(nbytes, 2 * M * N * K))


def check_w4a16(gen, dev):
    """K12 (K-paired), K13 (ramp) and K14 (fused gated MLP) against their
    plain versions at the serve paths' shapes."""
    import functools
    import torch
    import torch.nn.functional as Fn
    from tensorrt_llm_tpu_torch.ops import w4a16_fused as FM
    from tensorrt_llm_tpu_torch.ops import w4a16_gemm as W
    from tensorrt_llm_tpu_torch.quantization import dequantize_w4_any

    def lib_weights(packed, s):
        wdq = dequantize_w4_any(packed, s).to(torch.bfloat16)
        return [wdq] + [wdq.clone()
                        for _ in range(copies_for(wdq.numel() * 2) - 1)]

    def rand_x(M, K):
        return torch.randn((M, K), generator=gen, device=dev).to(
            torch.bfloat16)

    for model, what, K, N, G in KPAIRED_SHAPES:
        packed, s, _ = _w4_weight(gen, dev, K, N, G, kpaired=True)
        lib_w = lib_weights(packed, s)
        Gp = W.pack_group_for(K, s.shape[0])
        for M in KPAIRED_M:
            bk = W.kpaired_block_k(M, K, N, Gp)
            _check_w4_case(
                "w4a16_kpaired", {"model": model, "weight": what, "M": M,
                                  "K": K, "N": N, "G": G if G > 0 else K,
                                  "block_k": bk, "zeros_bias": False},
                W.w4a16_kpaired, rand_x(M, K), packed, s, None, None, None,
                lib_w)
        del lib_w
        zpacked, zs, zz = _w4_weight(gen, dev, K, N, G, kpaired=True,
                                     symmetric=False)
        b = torch.randn((N,), generator=gen, device=dev)
        for M in KPAIRED_EXTRA_M:
            _check_w4_case(
                "w4a16_kpaired", {"model": model, "weight": what, "M": M,
                                  "K": K, "N": N, "G": G if G > 0 else K,
                                  "block_k": W.kpaired_block_k(M, K, N, Gp),
                                  "zeros_bias": True, "act": "silu"},
                W.w4a16_kpaired, rand_x(M, K), zpacked, zs, zz, b, "silu",
                None)
        if what == "o_proj" or K == 7168:
            for M in KPAIRED_EDGE_M:
                _check_w4_case(
                    "w4a16_kpaired", {"model": model, "weight": what,
                                      "M": M, "K": K, "N": N,
                                      "G": G if G > 0 else K,
                                      "block_k": W.kpaired_block_k(M, K, N,
                                                                   Gp),
                                      "zeros_bias": False, "edge": True},
                    W.w4a16_kpaired, rand_x(M, K), packed, s, None, None,
                    None, None)
        torch.cuda.empty_cache()

    model, what, K, N = G32_KPAIRED
    for sym in (True, False):
        packed, s, z = _w4_weight(gen, dev, K, N, 32, kpaired=True,
                                  symmetric=sym)
        b = None if sym else torch.randn((N,), generator=gen, device=dev)
        act = None if sym else "silu"
        for M in G32_M:
            _check_w4_case(
                "w4a16_kpaired", {"model": model, "weight": what, "M": M,
                                  "K": K, "N": N, "G": 32,
                                  "block_k": W.kpaired_block_k(M, K, N, 32),
                                  "zeros_bias": not sym, "act": act,
                                  "edge": True},
                W.w4a16_kpaired, rand_x(M, K), packed, s, z, b, act, None)

    for i, (model, K, N) in enumerate(RAMP_SHAPES):
        packed, s, _ = _w4_weight(gen, dev, K, N, 128, kpaired=False)
        lib_w = lib_weights(packed, s)
        plans = [W.ramp_schedule(K)]
        if i in (2, 5):         # gate_up: also ramp_bk0 = 2048
            plans.append(W.ramp_schedule(K, 2048))
        for sched in plans:
            fn = functools.partial(W.w4a16_ramp, schedule=sched)
            for M in RAMP_M:
                _check_w4_case(
                    "w4a16_ramp", {"model": model, "M": M, "K": K, "N": N,
                                   "G": 128, "schedule": list(sched),
                                   "zeros_bias": False},
                    fn, rand_x(M, K), packed, s, None, None, None, lib_w)
        del lib_w
        if i in (0, 3):         # zero points, bias and silu
            zpacked, zs, zz = _w4_weight(gen, dev, K, N, 128, kpaired=False,
                                         symmetric=False)
            b = torch.randn((N,), generator=gen, device=dev)
            _check_w4_case(
                "w4a16_ramp", {"model": model, "M": 16, "K": K, "N": N,
                               "G": 128, "schedule": list(W.ramp_schedule(K)),
                               "zeros_bias": True, "act": "silu"},
                functools.partial(W.w4a16_ramp), rand_x(16, K), zpacked, zs,
                zz, b, "silu", None)
        if i in (0, 2):         # TinyLlama qkv and gate_up at the edges
            for M in RAMP_EDGE_M:
                _check_w4_case(
                    "w4a16_ramp", {"model": model, "M": M, "K": K, "N": N,
                                   "G": 128,
                                   "schedule": list(W.ramp_schedule(K)),
                                   "zeros_bias": False, "edge": True},
                    W.w4a16_ramp, rand_x(M, K), packed, s, None, None, None,
                    None)
        torch.cuda.empty_cache()

    model, K, N = G32_RAMP
    for sym in (True, False):
        packed, s, z = _w4_weight(gen, dev, K, N, 32, kpaired=False,
                                  symmetric=sym)
        b = None if sym else torch.randn((N,), generator=gen, device=dev)
        act = None if sym else "silu"
        for M in G32_M:
            _check_w4_case(
                "w4a16_ramp", {"model": model, "M": M, "K": K, "N": N,
                               "G": 32, "schedule": list(W.ramp_schedule(K)),
                               "zeros_bias": not sym, "act": act,
                               "edge": True},
                W.w4a16_ramp, rand_x(M, K), packed, s, z, b, act, None)

    _no_serialized_wgmma("w4a16_fused_mlp.cu")
    for model, K, I in FUSED_SHAPES:
        for zp in (False, True):
            gp, gs, gz = _w4_weight(gen, dev, K, 2 * I, 128, False, not zp)
            dp, ds, dz = _w4_weight(gen, dev, I, K, 128, False, not zp)
            gb = (torch.randn((2 * I,), generator=gen, device=dev) * 0.1
                  if zp else None)
            db = (torch.randn((K,), generator=gen, device=dev) * 0.1
                  if zp else None)
            ops = (gp, gs, dp, ds, gz, dz, gb, db)
            wq_bytes = (gp.numel() + dp.numel()
                        + (gs.numel() + ds.numel()) * 2 * (2 if zp else 1))
            copies = [tuple(None if t is None else t.clone() for t in ops)
                      for _ in range(copies_for(wq_bytes) - 1)] + [ops]
            # the library yardstick, a sequence: torch.matmul on the
            # dequantized bf16 weights, silu(g) * u, torch.matmul
            lib_w = None if zp else [
                (dequantize_w4_any(o[0], o[1]).to(torch.bfloat16),
                 dequantize_w4_any(o[2], o[3]).to(torch.bfloat16))
                for o in copies[:copies_for(6 * K * I)]]

            def unfused(x, o):
                gu = W.w4a16_matmul(x, o[0], o[1], o[4], o[6])
                h = (Fn.silu(gu[:, :I].float()) * gu[:, I:].float()).to(
                    torch.bfloat16)
                return W.w4a16_matmul(h, o[2], o[3], o[5], o[7])

            def library(x, w):
                gu = torch.matmul(x, w[0])
                h = (Fn.silu(gu[:, :I].float()) * gu[:, I:].float()).to(
                    torch.bfloat16)
                return torch.matmul(h, w[1])

            for M in (FUSED_ZEROS_M if zp else FUSED_M):
                x = rand_x(M, K)
                out = FM.w4a16_fused_mlp(x, *ops[:4], *ops[4:], "silu")
                again = FM.w4a16_fused_mlp(x, *ops[:4], *ops[4:], "silu")
                ref = FM.w4a16_fused_mlp_plain(x, *ops[:4], *ops[4:],
                                               "silu")
                torch.cuda.synchronize()
                assert torch.equal(out, again), \
                    f"K14 {model} M {M}: second call differs"
                err = (out.float() - ref.float()).abs().max().item()
                # both round h and the output to bf16 at the same places;
                # the kernel scales f32 partials per group where the plain
                # version multiplies by the exact f32 weight, so one-ulp
                # differences of h remain: 2% of the largest output
                tol = 2e-2 * ref.float().abs().max().item()
                k_ms = cuda_ms([lambda o=o: FM.w4a16_fused_mlp(
                    x, *o[:4], *o[4:], "silu") for o in copies], 20)
                p_ms = cuda_ms([lambda: FM.w4a16_fused_mlp_plain(
                    x, *ops[:4], *ops[4:], "silu")], 3)
                unf_ms = cuda_ms([lambda o=o: unfused(x, o)
                                  for o in copies], 20)
                l_ms = (cuda_ms([lambda w=w: library(x, w) for w in lib_w],
                                20) if lib_w else None)
                _, plan, st = FM.fused_mlp_launch(
                    x, *ops[:4], *ops[4:], "silu", barrier_stats=True)
                torch.cuda.synchronize()
                shape = {"model": model, "M": M, "K": K, "I": I, "G": 128,
                         "zeros": zp, "bias": zp, "repeat_bitwise": True,
                         "unfused_ms": unf_ms,
                         "library": None if zp else
                         "sequence: matmul, silu(g) * u, matmul (bf16)",
                         "plan": {k: plan[k] for k in (
                             "ntt", "ctw", "cluster", "sa", "sb", "grid",
                             "rounds_a", "rounds_b", "smem")},
                         **fused_barrier_stats(st)}
                nbytes = (2 * M * K * 2 + wq_bytes
                          + (0 if gb is None else (2 * I + K) * 4))
                record("w4a16_fused_mlp", shape, err, tol, k_ms, p_ms, l_ms,
                       bound_ms(nbytes, 2 * M * K * 2 * I + 2 * M * I * K))
            del copies, ops, gp, gs, gz, dp, ds, dz, lib_w
            torch.cuda.empty_cache()
    check_kpaired_slices(gen, dev)
    check_fused_mlp_plan(gen, dev)


def fused_barrier_stats(st):
    """K14's per-block timestamps (`fused_mlp_launch(...,
    barrier_stats=True)`) as microseconds from the first block's start:
    the barrier's own cost (the last release seen after the last arrival),
    the spread of the arrivals (the phase imbalance), and the latest
    block's time to each event."""
    st = st.double().cpu()
    t0 = st[:, 0].min()

    def last(i):
        v = st[:, i][st[:, i] > 0]
        return float(v.max() - t0) / 1e3 if v.numel() else None
    arr = st[:, 3][st[:, 3] > 0]
    out = {"barrier_us": float(st[:, 4].max() - arr.max()) / 1e3,
           "arrival_spread_us": float(arr.max() - arr.min()) / 1e3}
    for i, name in enumerate(("start", "x_in", "a_stages_done", "arrive",
                              "release_seen", "h_in", "b_stages_done",
                              "end")):
        out[f"last_{name}_us"] = last(i)
    return out


def check_fused_mlp_plan(gen, dev):
    """`fused_mlp_plan`'s pick against every launch K14 can take
    (`fused_mlp_plan_choices`: column tile, cluster, each phase's slices),
    each timed at every FUSED_SHAPES x FUSED_M row with the weights
    rotated past L2: the pick must be within GEMV_PLAN_SLACK of the
    fastest."""
    import torch
    from tensorrt_llm_tpu_torch.ops import cuda_build
    from tensorrt_llm_tpu_torch.ops import w4a16_fused as FM
    rows = []
    for model, K, I in FUSED_SHAPES:
        gp, gs, _ = _w4_weight(gen, dev, K, 2 * I, 128, False)
        dp, ds, _ = _w4_weight(gen, dev, I, K, 128, False)
        ops = (gp, gs, dp, ds)
        wq_bytes = gp.numel() + dp.numel() + (gs.numel() + ds.numel()) * 2
        copies = [ops] + [tuple(t.clone() for t in ops)
                          for _ in range(copies_for(wq_bytes) - 1)]
        for M in FUSED_M:
            x = torch.randn((M, K), generator=gen, device=dev).to(
                torch.bfloat16)
            choices = FM.fused_mlp_plan_choices(
                M, K, I, 128, 128, cuda_build.num_sms(dev),
                FM._coresident(dev), gp.shape[2], False)
            times = {c["key"]: cuda_ms([
                lambda o=o, c=c: FM.fused_mlp_launch(x, *o, activation="silu",
                                                     plan=c)
                for o in copies], 20) for c in choices}
            pick = FM.fused_mlp_launch(x, *ops, activation="silu")[1]["key"]
            best = min(times, key=times.get)
            rows.append({"model": model, "M": M, "K": K, "I": I,
                         "pick": pick, "fastest": best,
                         "pick_ms": times[pick], "fastest_ms": times[best],
                         "pick_over_fastest": times[pick] / times[best],
                         "ms": {str(k): v for k, v in times.items()},
                         "grid": {str(c["key"]): c["grid"]
                                  for c in choices}})
            log(json.dumps(rows[-1]))
        del copies, ops, gp, dp
        torch.cuda.empty_cache()
    _plan_rows("fused_mlp_plan", rows, GEMV_PLAN_SLACK, "fused_mlp_plan")


def check_kpaired_slices(gen, dev):
    """`kpaired_block_k`'s pick against every K slice K12 can take
    (`kpaired_slice_choices`), each timed at every KPAIRED_SHAPES row and
    KPAIRED_M: the pick must be within KPAIRED_BK_SLACK of the fastest.
    The pick comes from a model whose per-stage costs were measured on the
    H100; this check shows when a change to the mainloop makes them
    stale."""
    import torch
    from tensorrt_llm_tpu_torch.ops import w4a16_gemm as W
    rows = []
    for model, what, K, N, G in KPAIRED_SHAPES:
        packed, s, _ = _w4_weight(gen, dev, K, N, G, kpaired=True)
        Gp = W.pack_group_for(K, s.shape[0])
        ws = [(packed.clone(), s.clone())
              for _ in range(copies_for(packed.numel() + s.numel() * 2))]
        for M in KPAIRED_M:
            x = torch.randn((M, K), generator=gen, device=dev).to(
                torch.bfloat16)
            times = {bk: cuda_ms([lambda p=p, sc=sc, bk=bk: W.w4a16_kpaired(
                x, p, sc, block_k=bk) for p, sc in ws], 30)
                for bk in W.kpaired_slice_choices(K, Gp)}
            pick = W.kpaired_block_k(M, K, N, Gp)
            best = min(times, key=times.get)
            rows.append({"model": model, "weight": what, "M": M, "K": K,
                         "N": N, "G": G if G > 0 else K, "pick": pick,
                         "fastest": best,
                         "pick_over_fastest": times[pick] / times[best],
                         "ms": {str(bk): t for bk, t in times.items()}})
            log(json.dumps(rows[-1]))
        del ws
        torch.cuda.empty_cache()
    worst = max(r["pick_over_fastest"] for r in rows)
    PHASES["kpaired_slices"] = {"phase": "kpaired_slices", "rows": rows,
                                "worst_pick_over_fastest": worst,
                                "slack": KPAIRED_BK_SLACK}
    bad = [(r["model"], r["M"], r["pick"], r["fastest"],
            r["pick_over_fastest"]) for r in rows
           if r["pick_over_fastest"] > 1 + KPAIRED_BK_SLACK]
    assert not bad, f"kpaired_block_k picks slower than the slack: {bad}"


def _int_mm_ms(xq, w_int8, iters):
    """Library yardstick: torch._int_mm (cuBLASLt s8 x s8 -> s32) on the
    int8 (q - z) weight, without the group scales; None where this build
    refuses the shape (it takes M > 16 only)."""
    import torch
    for w in (w_int8.t().contiguous().t(), w_int8):
        try:
            torch._int_mm(xq, w)
            torch.cuda.synchronize()
        except RuntimeError:    # a yardstick only: try the other layout
            continue
        return cuda_ms([lambda w=w: torch._int_mm(xq, w)], iters)
    log(f"  torch._int_mm refused M={xq.shape[0]}")
    return None


def check_w4a8(gen, dev):
    """K8 at Llama-3-8B's four projections x W4A8_M with zero points (as
    served), plus a per-channel case and a bias + silu case, and on
    K-paired weights as stored; then `w4a8_plan`'s K slices against every
    slice count (`check_w4a8_slices`)."""
    import torch
    _no_serialized_wgmma("w4a8_gemm.cu")
    from tensorrt_llm_tpu_torch.ops import w4a16_gemm as W
    from tensorrt_llm_tpu_torch.quantization import (
        choose_block_n, dequantize_w4_any, pack_group_for, pack_w4,
        pack_w4_tiled, quantize_w4, unpack_w4, unpack_w4_tiled)
    kns = GEMM_SHAPES[W4A8_MODEL]
    plan = [(K, N, 128, [(M, None) for M in W4A8_M], False)
            for K, N in kns]
    plan += [(*kns[0], -1, [(256, None)], False),       # per-channel
             (*kns[0], 128, [(16, "silu")], False)]     # bias + silu
    # the K-paired packing as stored, at widths no 64-column tile divides
    # (the JAX package's XLA route): N 80 at the served K, N 2880
    # (GPT-OSS o_proj's) per channel
    plan += [(kns[1][0], 80, 128, [(M, None) for M in W4A8_KPAIRED_M], True),
             (kns[1][0], 2880, -1, [(4, None), (16, "silu")], True)]
    slice_rows = []
    for K, N, G, cases, kpaired in plan:
        w = torch.randn((K, N), generator=gen, device=dev) * 0.02
        q, sc, z = quantize_w4(w, G, symmetric=False)
        packed = (pack_w4(q, pack_group_for(K, sc.shape[0])) if kpaired
                  else pack_w4_tiled(q, choose_block_n(N)))
        del w, q
        wq_bytes = packed.numel() + 2 * sc.numel() * 4
        ws = [(packed.clone(), sc.clone(), z.clone())
              for _ in range(copies_for(wq_bytes))]
        wdq = dequantize_w4_any(packed, sc, z).to(torch.bfloat16)
        lib_w = [wdq.clone() for _ in range(copies_for(wdq.numel() * 2))]
        q_int = (unpack_w4(packed, pack_group_for(K, sc.shape[0]))
                 if kpaired else unpack_w4_tiled(packed))
        w_int8 = (q_int.to(torch.int16) - z.to(
            torch.int16).repeat_interleave(K // sc.shape[0], 0)).to(
                torch.int8)
        del q_int
        for M, act in cases:
            x = torch.randn((M, K), generator=gen, device=dev).to(
                torch.bfloat16)
            b = (torch.randn((N,), generator=gen, device=dev)
                 if act else None)
            xq, s_act = W.quantize_act_int8(x)
            out = W.w4a8_gemm(xq, s_act, packed, sc, z, b, act)
            ref = W.w4a8_matmul_plain(xq, s_act, packed, sc, z, b, act)
            # one slice count summed in K order: a second call gives the
            # same bits
            assert torch.equal(out, W.w4a8_gemm(xq, s_act, packed, sc, z, b,
                                                act)), "K8: second call differs"
            plan = W.w4a8_plan(K, N, sc.shape[0],
                               0 if kpaired else packed.shape[2], M)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            # the plain version rounds each dequantized weight to bf16
            # (2^-9 relative), the kernel keeps exact integer products per
            # group and scales the f32 partial; both round the output to
            # bf16: 2% of the largest output
            tol = 2e-2 * ref.float().abs().max().item()
            k_ms = cuda_ms([lambda p=p, s_=s_, z_=z_: W.w4a8_gemm(
                xq, s_act, p, s_, z_, b, act) for p, s_, z_ in ws], 30)
            p_ms = cuda_ms([lambda: W.w4a8_matmul_plain(
                xq, s_act, packed, sc, z, b, act)], 5)
            xb = xq.to(torch.bfloat16)
            l_ms = (cuda_ms([lambda lw=lw: torch.matmul(xb, lw)
                             for lw in lib_w], 30) if act is None else None)
            int_ms = _int_mm_ms(xq, w_int8, 30) if act is None else None
            nbytes = (M * K + M * 4 + wq_bytes + M * N * 2
                      + (N * 4 if act else 0))
            record("w4a8_gemm", {"model": W4A8_MODEL, "M": M, "K": K,
                                 "N": N, "G": G if G > 0 else K, "act": act,
                                 "zeros": True, "bias": act is not None,
                                 "kpaired": kpaired, "edge": kpaired,
                                 "ntok": plan["ntok"],
                                 "slices": plan["slices"],
                                 "int_mm_ms": int_ms}, err, tol,
                   k_ms, p_ms, l_ms,
                   bound_ms(nbytes, 2 * M * N * K, PEAK_INT8))
            if (G == 128 and act is None
                    and M in (W4A8_KPAIRED_M if kpaired else W4A8_SLICE_M)):
                slice_rows.append(_w4a8_slices_row(
                    xq, s_act, ws, sc, z, ref, tol,
                    {"model": W4A8_MODEL, "M": M, "K": K, "N": N,
                     "kpaired": kpaired}))
        del packed, sc, z, ws, wdq, lib_w, w_int8
        torch.cuda.empty_cache()
    worst = max(r["pick_over_fastest"] for r in slice_rows)
    PHASES["w4a8_slices"] = {"phase": "w4a8_slices", "rows": slice_rows,
                             "worst_pick_over_fastest": worst,
                             "slack": W4A8_SLICE_SLACK}
    bad = [(r["K"], r["N"], r["M"], r["pick"], r["fastest"],
            r["pick_over_fastest"]) for r in slice_rows
           if r["pick_over_fastest"] > 1 + W4A8_SLICE_SLACK]
    assert not bad, f"w4a8_plan picks K slices slower than the slack: {bad}"


def _w4a8_slices_row(xq, s_act, ws, sc, z, ref, tol, head):
    """K8 at every K slice count it takes (`k1_slice_choices`), each held
    against the plain version and timed with the weights rotated past the
    L2: `w4a8_plan`'s count must be within W4A8_SLICE_SLACK of the
    fastest."""
    import torch
    from tensorrt_llm_tpu_torch.ops import w4a16_gemm as W
    M, K, N = head["M"], head["K"], head["N"]
    packed = ws[0][0]
    bn = 0 if head["kpaired"] else packed.shape[2]
    times = {}
    for d in W.k1_slice_choices(K):
        out = W.w4a8_gemm(xq, s_act, packed, sc, z, slices=d)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        assert err <= tol, f"K8 at {d} slices {head}: {err} > {tol}"
        times[d] = cuda_ms([lambda p=p, s_=s_, z_=z_, d=d: W.w4a8_gemm(
            xq, s_act, p, s_, z_, slices=d) for p, s_, z_ in ws], 10)
    pick = W.w4a8_plan(K, N, sc.shape[0], bn, M)["slices"]
    best = min(times, key=times.get)
    row = dict(head, pick=pick, fastest=best, pick_ms=times[pick],
               fastest_ms=times[best],
               pick_over_fastest=times[pick] / times[best],
               ms={str(k): v for k, v in times.items()})
    log(json.dumps({k: v for k, v in row.items() if k != "ms"}))
    return row


def _routing(rng, M, E, kind):
    """Group sizes of M rows over E experts: uniform, or skewed (half the
    experts get no row, the rest a Zipf share)."""
    import numpy as np
    if kind == "uniform":
        ids = rng.integers(0, E, M)
    else:
        live = rng.permutation(E)[:max(1, E // 2)]
        p = 1.0 / np.arange(1, len(live) + 1)
        ids = rng.choice(live, M, p=p / p.sum())
    return np.bincount(ids, minlength=E).astype(np.int32)


def _grouped_mm_ms(x, w_bf16, gs, iters):
    """Library yardstick: torch._grouped_mm on pre-dequantized bf16 experts
    (never on the port's path); None where this build does not run it."""
    import torch
    offs = torch.cumsum(gs, 0, dtype=torch.int32)
    try:
        torch._grouped_mm(x, w_bf16, offs=offs)
        torch.cuda.synchronize()
    except Exception as e:      # a yardstick only: report and go on
        log(f"  torch._grouped_mm unavailable: {type(e).__name__}: {e}")
        return None
    return cuda_ms([lambda: torch._grouped_mm(x, w_bf16, offs=offs)], iters)


def _experts(gen, dev, E, K, N, G, zero_points):
    """Random experts drawn and quantized 16 at a time (DeepSeek's 256
    experts of 7168 x 4096 would take 30 GB as one f32 draw): symmetric
    (packed, scales, bf16 dequantized) and, with `zero_points`, the same
    weights with zero points."""
    import torch
    from tensorrt_llm_tpu_torch.ops import moe_w4a16 as MW
    sym, zp = [], []
    for e0 in range(0, E, 16):
        w = torch.randn((min(16, E - e0), K, N), generator=gen,
                        device=dev) * 0.02
        sym.append(MW.quantize_experts_w4(w, G))
        if zero_points:
            zp.append(MW.quantize_experts_w4(w, G, symmetric=False))
        del w

    def stack(parts):
        if not parts:
            return None
        pk, sc = (torch.cat([p[i] for p in parts]) for i in (0, 1))
        z = None if parts[0][2] is None else torch.cat([p[2] for p in parts])
        wdq = torch.cat([MW.dequantize_experts_w4(
            pk[e0:e0 + 16], sc[e0:e0 + 16],
            None if z is None else z[e0:e0 + 16]).to(torch.bfloat16)
            for e0 in range(0, E, 16)])
        return pk, sc, z, wdq

    return stack(sym), stack(zp), sym[0][3]


def _no_serialized_wgmma(source):
    """Fail a kernel's checks if ptxas serialized its wgmmas (the build
    keeps each source's log; `cuda_build.serialized_wgmma`)."""
    from tensorrt_llm_tpu_torch.ops import cuda_build
    bad = [w for w in cuda_build.serialized_wgmma() if w[0] == source]
    assert not bad, f"ptxas serialized wgmmas in {source}: {bad}"


def check_moe(gen, dev):
    """K5 against `w4a16_grouped_matmul_plain` at MOE_SHAPES x the models'
    token counts under uniform and skewed routing (and zero-point experts
    off the path), each on the device-built unit list, which must equal
    the plain builder's (`gmm_units_plain`); every token tile K5 takes is
    timed at the symmetric rows (`check_gmm_ntok`)."""
    import numpy as np
    import torch
    from tensorrt_llm_tpu_torch.ops import moe_w4a16 as MW
    _no_serialized_wgmma("moe_gmm.cu")
    rng = np.random.default_rng(0)
    ntok_rows = []
    for model, shapes in MOE_SHAPES.items():
        for K, N, E, G in shapes:
            with_zeros = model in MOE_ZEROS_MODELS
            (packed, scales, _, wdq), zexp, bn = _experts(
                gen, dev, E, K, N, G, with_zeros)
            # zero-point experts: the kernel's other instantiation
            zpacked, zscales, zeros, zwdq = zexp or (None,) * 4
            cases = [(M, kind, False)
                     for M in MOE_M_BY_MODEL.get(model, MOE_M)
                     for kind in ("uniform", "skewed")]
            if with_zeros:
                cases += [(M, "skewed", True) for M in MOE_M_ZEROS]
            for M, kind, zp in cases:
                pk, sc, z = ((zpacked, zscales, zeros) if zp
                             else (packed, scales, None))
                per_expert = K * N // 2 + (K // G) * N * 4 * (2 if zp else 1)
                sizes = _routing(rng, M, E, kind)
                live = int((sizes > 0).sum())
                gs = torch.from_numpy(sizes).to(dev)
                x = torch.randn((M, K), generator=gen, device=dev
                                ).to(torch.bfloat16)
                ntok = MW.gmm_ntok(M, E)
                units = MW.gmm_work_units(gs, M)
                out = MW.moe_gmm(x, pk, sc, units, z)
                ref = MW.w4a16_grouped_matmul_plain(x, pk, sc, gs, z)
                torch.cuda.synchronize()
                assert torch.equal(units, MW.gmm_units_plain(gs, M, ntok)), \
                    f"K5 unit list differs from gmm_units_plain " \
                    f"({model} K={K} N={N} M={M} {kind})"
                err = (out - ref).abs().max().item()
                # the kernel's weight is bit for bit the plain version's
                # bf16 weight; the plain version rounds the output to bf16
                # (2^-9 relative) and sums in another order, the kernel
                # keeps f32: 2% of max|ref|
                tol = 2e-2 * ref.abs().max().item()
                ws = [(pk.clone(), sc.clone()) for _ in range(
                    copies_for(live * per_expert) - 1)] + [(pk, sc)]
                k_ms = cuda_ms([lambda p=p, c=c: MW.moe_gmm(x, p, c, units, z)
                                for p, c in ws], 20)
                del ws
                p_ms = cuda_ms([lambda: MW.w4a16_grouped_matmul_plain(
                    x, pk, sc, gs, z)], 3)
                l_ms = _grouped_mm_ms(x, zwdq if zp else wdq, gs, 20)
                nbytes = M * K * 2 + live * per_expert + M * N * 4 + E * 4
                record("moe_gmm", {"model": model, "M": M, "K": K, "N": N,
                                   "E": E, "G": G, "BN": bn, "routing": kind,
                                   "experts_hit": live, "zeros": zp,
                                   "ntok": ntok,
                                   "units": int(units[0, 0].item())},
                       err, tol, k_ms, p_ms, l_ms,
                       bound_ms(nbytes, 2 * M * N * K))
                if not zp:
                    ntok_rows.append(check_gmm_ntok(
                        x, pk, sc, gs, ref, tol, live * per_expert,
                        {"model": model, "M": M, "K": K, "N": N, "E": E,
                         "routing": kind}))
            del packed, scales, zpacked, zscales, zeros, wdq, zwdq
            torch.cuda.empty_cache()
    worst = max(r["pick_over_fastest"] for r in ntok_rows)
    PHASES["gmm_ntok"] = {"phase": "gmm_ntok", "rows": ntok_rows,
                          "worst_pick_over_fastest": worst,
                          "slack": GMM_NTOK_SLACK}
    bad = [(r["model"], r["K"], r["N"], r["M"], r["routing"], r["pick"],
            r["fastest"], r["pick_over_fastest"]) for r in ntok_rows
           if r["pick_over_fastest"] > 1 + GMM_NTOK_SLACK]
    assert not bad, f"gmm_ntok picks slower than the slack: {bad}"


def check_gmm_ntok(x, pk, sc, gs, ref, tol, wbytes, head):
    """K5 at every token tile it takes (`GMM_NTOK`), each on its own unit
    list and held against the plain version, timed with the weights
    rotated past the L2: `gmm_ntok`'s pick must be within GMM_NTOK_SLACK of
    the fastest."""
    import torch
    from tensorrt_llm_tpu_torch.ops import moe_w4a16 as MW
    M, E = x.shape[0], pk.shape[0]
    ws = [(pk.clone(), sc.clone()) for _ in range(copies_for(wbytes) - 1)]
    ws.append((pk, sc))
    times, errs = {}, {}
    for nt in MW.GMM_NTOK:
        units = MW.gmm_work_units(gs, M, nt)
        out = MW.moe_gmm(x, pk, sc, units, None, ntok=nt)
        torch.cuda.synchronize()
        errs[nt] = (out - ref).abs().max().item()
        assert errs[nt] <= tol, f"K5 at ntok {nt} {head}: {errs[nt]} > {tol}"
        times[nt] = cuda_ms([lambda p=p, c=c, u=units, nt=nt: MW.moe_gmm(
            x, p, c, u, None, ntok=nt) for p, c in ws], 10)
    del ws
    pick = MW.gmm_ntok(M, E)
    best = min(times, key=times.get)
    row = dict(head, pick=pick, fastest=best, pick_ms=times[pick],
               fastest_ms=times[best],
               pick_over_fastest=times[pick] / times[best],
               ms={str(k): v for k, v in times.items()},
               max_err={str(k): v for k, v in errs.items()})
    log(json.dumps({k: v for k, v in row.items() if k != "max_err"}))
    return row


def _paged(gen, dev, seqs, Hkv, D, BS=16):
    """Random bf16 pools and shuffled block tables for sequence lengths."""
    import torch
    mb = max(-(-L // BS) for L in seqs)
    nb = len(seqs) * mb + 1
    k = torch.randn((nb, Hkv, BS, D), generator=gen, device=dev
                    ).to(torch.bfloat16)
    v = torch.randn((nb, Hkv, BS, D), generator=gen, device=dev
                    ).to(torch.bfloat16)
    perm = torch.randperm(nb - 1, generator=gen, device=dev) + 1
    tables = perm[:len(seqs) * mb].reshape(len(seqs), mb).to(torch.int32)
    return k, v, tables.contiguous()


def _int8_pool(p):
    """A bf16 pool [NB, Hkv, BS, D] quantized per (token, head) row, as the
    serve path's KV append quantizes it: (int8 data, f32 scales [NB, Hkv,
    BS])."""
    from tensorrt_llm_tpu_torch.ops.attention_plain import quantize_kv_token
    nb, h, bs, d = p.shape
    q, sc = quantize_kv_token(p.reshape(nb * h, bs, d))
    return q.reshape(p.shape), sc.reshape(nb, h, bs)


def _nbytes(c):
    """Bytes of a pool or of every tensor in nested pools (K/V pairs, INT8
    pairs, latent pools and DSA's (latent, indexer) pairs)."""
    if isinstance(c, (list, tuple)):
        return sum(_nbytes(t) for t in c)
    return c.numel() * c.element_size()


def _clone(c):
    return tuple(t.clone() for t in c) if isinstance(c, tuple) else c.clone()




def _sdpa_ms(q, k, v, mask, iters, sinks=None):
    """Time of one library call (scaled_dot_product_attention) on dense K/V
    gathered and GQA-expanded beforehand: q [B,Hq,T,D], k/v [B,Hkv,S,D],
    mask boolean, broadcast to [B,Hq,T,S].  Sinks enter as one more key and
    value of zeros whose logit the additive mask sets to sinks[h]: the
    softmax over [scores, sink] that the kernels compute."""
    import torch
    import torch.nn.functional as F
    G = q.shape[1] // k.shape[1]
    k = k.repeat_interleave(G, dim=1)
    v = v.repeat_interleave(G, dim=1)
    if sinks is not None:
        B, Hq, T, D = q.shape
        z = k.new_zeros((B, Hq, 1, D))
        k, v = torch.cat([k, z], 2), torch.cat([v, z], 2)
        bias = torch.zeros(mask.shape, dtype=q.dtype, device=q.device)
        bias = bias.masked_fill(~mask, float("-inf")).expand(
            B, Hq, T, k.shape[2] - 1)
        sink = sinks.to(q.dtype).view(1, Hq, 1, 1).expand(B, Hq, T, 1)
        mask = torch.cat([bias, sink], -1).contiguous()
    k, v = k.contiguous(), v.contiguous()
    return cuda_ms([lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask)], iters)


def check_prefill(gen, dev, cases=PREFILL_CASES, int8=False):
    """K3 (bf16 pools) or, with `int8`, K7 on freshly quantized pools."""
    import numpy as np
    import torch
    from tensorrt_llm_tpu_torch.ops.attention_plain import gather_dequant
    from tensorrt_llm_tpu_torch.ops.flash_prefill import (
        flash_prefill_attention, flash_prefill_plain)
    for model, Hq, Hkv, D, T, off, win, cap, sk in cases:
        kv_len = off + T
        k, v, tables = _paged(gen, dev, [kv_len], Hkv, D)
        if int8:
            k, v = _int8_pool(k), _int8_pool(v)
        table = tables[0].contiguous()
        q = torch.randn((T, Hq, D), generator=gen, device=dev
                        ).to(torch.bfloat16)
        sinks = (torch.randn((Hq,), generator=gen, device=dev)
                 if sk else None)
        scale = D ** -0.5
        kw = dict(sliding_window=win, logit_cap=cap, sinks=sinks)
        out = flash_prefill_attention(q, k, v, table, kv_len, off, scale, **kw)
        ref = flash_prefill_plain(q, k, v, table, kv_len, off, scale, **kw)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        n_copy = copies_for(2 * _nbytes(k))
        pools = [(_clone(k), _clone(v)) for _ in range(n_copy)]
        k_ms = cuda_ms([lambda kk=kk, vv=vv: flash_prefill_attention(
            q, kk, vv, table, kv_len, off, scale, **kw)
            for kk, vv in pools], 20)
        p_ms = cuda_ms([lambda: flash_prefill_plain(
            q, k, v, table, kv_len, off, scale, **kw)], 5)
        l_ms = None
        if not cap:
            # dense K/V gathered once outside the timing
            kd = gather_dequant(k, table).permute(1, 0, 2, 3).reshape(
                Hkv, -1, D)[None, :, :kv_len]
            vd = gather_dequant(v, table).permute(1, 0, 2, 3).reshape(
                Hkv, -1, D)[None, :, :kv_len]
            qp = off + torch.arange(T, device=dev)[:, None]
            kp = torch.arange(kv_len, device=dev)[None, :]
            mask = kp <= qp
            if win:
                mask &= kp > qp - win
            qd = q.permute(1, 0, 2)[None]
            l_ms = _sdpa_ms(qd, kd, vd, mask, 20, sinks)
        qpos = off + np.arange(T)[:, None]
        kpos = np.arange(kv_len)[None, :]
        valid = (kpos <= qpos)
        if win:
            valid &= kpos > qpos - win
        pairs = int(valid.sum())
        lo = max(0, off - win + 1) if win else 0
        # q and out in bf16; each K and V row D values (bf16, or int8 plus
        # its f32 scale)
        row = D + 4 if int8 else 2 * D
        nbytes = 2 * T * Hq * D * 2 + 2 * (kv_len - lo) * Hkv * row
        # the kernel rounds P to bf16 (2^-9 relative), the plain version the
        # dequantized K/V of an int8 pool, and both sides round the output
        # to bf16 (2^-8 relative): 2% of the largest output
        tol = 2e-2 * max(1.0, ref.float().abs().max().item())
        record("flash_prefill_int8" if int8 else "flash_prefill",
               {"model": model, "Hq": Hq, "Hkv": Hkv, "D": D, "T": T,
                "q_offset": off, "window": win, "logit_cap": cap,
                "sinks": sk},
               err, tol, k_ms, p_ms, l_ms,
               bound_ms(nbytes, 4 * pairs * Hq * D))


def check_decode(gen, dev, cases=DECODE_CASES, int8=False):
    """K4 (bf16 pools) or, with `int8`, K6 on freshly quantized pools."""
    import torch
    from tensorrt_llm_tpu_torch.ops.attention_plain import (
        gather_dequant, pool_dims)
    from tensorrt_llm_tpu_torch.ops.paged_attention import (
        decode_plan, decode_split_choices, paged_decode_attention,
        paged_decode_plain)
    for model, Hq, Hkv, D, lens, win, cap, sk in cases:
        B = len(lens)
        k, v, tables = _paged(gen, dev, lens, Hkv, D)
        if int8:
            k, v = _int8_pool(k), _int8_pool(v)
        kv_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
        q = torch.randn((B, Hq, D), generator=gen, device=dev
                        ).to(torch.bfloat16)
        sinks = (torch.randn((Hq,), generator=gen, device=dev)
                 if sk else None)
        scale = D ** -0.5
        kw = dict(sliding_window=win, logit_cap=cap, sinks=sinks)
        out = paged_decode_attention(q, k, v, tables, kv_lens, scale, **kw)
        ref = paged_decode_plain(q, k, v, tables, kv_lens, scale, **kw)
        # a second call held to the same bits (the splits merge in order)
        assert torch.equal(out, paged_decode_attention(
            q, k, v, tables, kv_lens, scale, **kw)), \
            f"paged decode {model} {lens}: second call differs"
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        pools = [(_clone(k), _clone(v))
                 for _ in range(copies_for(2 * _nbytes(k)))]
        k_ms = cuda_ms([lambda kk=kk, vv=vv: paged_decode_attention(
            q, kk, vv, tables, kv_lens, scale, **kw) for kk, vv in pools], 30)
        # `decode_plan`'s split against every split length the kernel takes
        table_tokens = tables.shape[1] * pool_dims(k)[2]
        plan = decode_plan(B, Hkv, table_tokens, win)
        splits = {L: cuda_ms([lambda kk=kk, vv=vv, L=L: paged_decode_attention(
            q, kk, vv, tables, kv_lens, scale, split_len=L, **kw)
            for kk, vv in pools], 30)
            for L in decode_split_choices(table_tokens)}
        best = min(splits, key=splits.get)
        split_ratio = splits[plan["split_len"]] / splits[best]
        p_ms = cuda_ms([lambda: paged_decode_plain(
            q, k, v, tables, kv_lens, scale, **kw)], 5)
        l_ms = None
        if not cap:
            S = tables.shape[1] * pool_dims(k)[2]
            kd = gather_dequant(k, tables).permute(0, 2, 1, 3, 4).reshape(
                B, Hkv, S, D)
            vd = gather_dequant(v, tables).permute(0, 2, 1, 3, 4).reshape(
                B, Hkv, S, D)
            pos = torch.arange(S, device=dev)[None, :]
            L = kv_lens.long()[:, None]
            mask = pos < L
            if win:
                mask &= pos >= L - win
            l_ms = _sdpa_ms(q[:, :, None], kd, vd, mask[:, None, None, :], 30,
                            sinks)
        used = [min(L, win) if win else L for L in lens]
        row = D + 4 if int8 else 2 * D
        nbytes = 2 * B * Hq * D * 2 + sum(used) * 2 * Hkv * row
        # f32 math on both sides; the bf16 output rounding (2^-8 relative)
        # and, for an int8 pool, the plain version's bf16 rounding of the
        # dequantized K/V (2^-9 relative) remain: 1% of the largest output
        tol = 1e-2 * max(1.0, ref.float().abs().max().item())
        record("paged_decode_int8" if int8 else "paged_decode",
               {"model": model, "Hq": Hq, "Hkv": Hkv, "D": D,
                "kv_lens": lens, "window": win, "logit_cap": cap,
                "sinks": sk, "split_len": plan["split_len"]},
               err, tol, k_ms, p_ms, l_ms,
               bound_ms(nbytes, 4 * sum(used) * Hq * D),
               split_ms={str(L): t for L, t in splits.items()},
               split_ratio=split_ratio)
        assert split_ratio <= 1 + DECODE_PLAN_SLACK, \
            (f"decode_plan's split {plan['split_len']} at {model} {lens}: "
             f"{split_ratio:.3f}x the fastest ({best})")


# MLA latent width (kv_lora_rank 512 + rope 64) of Moonlight and DeepSeek
MLA_L, MLA_R = 512, 64
MLA_DECODE_CASES = [
    # model, H, kv_lens
    ("moonlight-16b-a3b", 16, [33, 320, 1000, 4000]),
    ("deepseek-v3", 128, [33, 320, 1000, 4000]),
]
MLA_PREFILL_CASES = [
    # model, H, T, q_offset
    ("moonlight-16b-a3b", 16, 256, 0),
    ("moonlight-16b-a3b", 16, 256, 256),
    ("moonlight-16b-a3b", 16, 100, 37),
    ("deepseek-v3", 128, 256, 0),
    ("deepseek-v3", 128, 256, 256),
    ("deepseek-v3", 128, 100, 37),
    # short chunks and long prefixes: where K10's plan splits the latents
    ("moonlight-16b-a3b", 16, 17, 1024),
    ("moonlight-16b-a3b", 16, 256, 1024),
    ("deepseek-v3", 128, 17, 1024),
    ("deepseek-v3", 128, 256, 1024),
]
# `mla_prefill_splits` must pick a split count whose K10 time is within
# this share of the fastest count timed, at every MLA_PREFILL_CASES row
MLA_SPLIT_SLACK = 0.10
DSA_CASES = [
    # kv_lens, table blocks of 16 (MB * 16 is not a multiple of K11's
    # 64-token tile); MB 190 is the V3.2 serve's table (a 3,000-token
    # prompt and its decode), there also a served-like batch and B 1
    ([1, 1000, 4097, 8192], 517),
    ([0, 100, 3000, 2049], 190),
    ([3001, 664, 320, 81], 190),
    ([3001], 190),
]
# `mla_decode_plan` and `dsa_score_plan` must pick a split count (K9) or a
# tile count a block (K11) whose time is within this share of the fastest
# one timed, at every MLA_DECODE_CASES / DSA_CASES row
MLA_DECODE_PLAN_SLACK = 0.10
DSA_PLAN_SLACK = 0.10
DSA_HI, DSA_DI = 64, 128


def _latent_pool(gen, dev, seqs, dk, BS=16):
    """A random bf16 latent (or indexer) pool [NB, 1, BS, dk] and shuffled
    block tables covering `seqs` tokens each."""
    import torch
    mb = max(1, max(-(-L // BS) for L in seqs))
    nb = len(seqs) * mb + 1
    pool = torch.randn((nb, 1, BS, dk), generator=gen, device=dev).to(
        torch.bfloat16)
    perm = torch.randperm(nb - 1, generator=gen, device=dev) + 1
    tables = perm[:len(seqs) * mb].reshape(len(seqs), mb).to(torch.int32)
    return pool, tables.contiguous()


def _sdpa_latent_ms(q, lat, mask, scale, iters):
    """Library yardstick of K9/K10: scaled_dot_product_attention on the
    gathered dense latents, one key head broadcast to the H query heads,
    q [B, H, T, L+R], keys lat [B, S, L+R], values their first L channels;
    None where this build refuses the shapes."""
    import torch
    import torch.nn.functional as F
    B, H = q.shape[:2]
    k = lat[:, None].expand(B, H, *lat.shape[1:])
    v = lat[:, None, :, :MLA_L].expand(B, H, lat.shape[1], MLA_L)
    try:
        F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale)
        torch.cuda.synchronize()
    except RuntimeError as e:   # a yardstick only: report and go on
        log(f"  SDPA refused the latent shapes: {e}")
        return None
    return cuda_ms([lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, scale=scale)], iters)


def _plan_rows(phase, rows, slack, what):
    """Record a plan check's rows and fail if a pick is past the slack."""
    worst = max(r["pick_over_fastest"] for r in rows)
    PHASES[phase] = {"phase": phase, "rows": rows,
                     "worst_pick_over_fastest": worst, "slack": slack}
    bad = [r for r in rows if r["pick_over_fastest"] > 1 + slack]
    assert not bad, f"{what} picks slower than the slack: {bad}"


def check_mla_splits(gen, dev):
    """`mla_prefill_splits`' pick against every latent split K10 can take
    (`mla_prefill_split_choices`), each timed at every MLA_PREFILL_CASES
    row: the pick must be within MLA_SPLIT_SLACK of the fastest."""
    import torch
    from tensorrt_llm_tpu_torch.ops import mla as MLA
    DK = MLA_L + MLA_R
    scale = (128 + MLA_R) ** -0.5
    rows = []
    for model, H, T, off in MLA_PREFILL_CASES:
        kv_len = off + T
        choices = MLA.mla_prefill_split_choices(T, H, kv_len, off)
        if len(choices) < 2:
            continue
        pool, tables = _latent_pool(gen, dev, [kv_len], DK)
        table = tables[0].contiguous()
        q = torch.randn((T, H, DK), generator=gen, device=dev).to(
            torch.bfloat16)
        pools = [pool.clone() for _ in range(copies_for(_nbytes(pool)))]
        times = {sl: cuda_ms([lambda p=p, sl=sl: MLA.mla_prefill_attention(
            q, p, table, kv_len, off, scale, MLA_L, split_len=sl)
            for p in pools], 20) for sl in choices}
        _, n, pick = MLA.mla_prefill_splits(T, H, kv_len, off)
        best = min(times, key=times.get)
        rows.append({"model": model, "H": H, "T": T, "q_offset": off,
                     "pick": pick, "splits": n, "fastest": best,
                     "pick_over_fastest": times[pick] / times[best],
                     "ms": {str(sl): t for sl, t in times.items()}})
        log(json.dumps(rows[-1]))
        del pools, pool
    _plan_rows("mla_prefill_splits", rows, MLA_SPLIT_SLACK,
               "mla_prefill_splits")


def check_mla_decode_plan(gen, dev):
    """`mla_decode_plan`'s split against every split K9 can take
    (`mla_decode_split_choices`), each timed at every MLA_DECODE_CASES row:
    the pick must be within MLA_DECODE_PLAN_SLACK of the fastest."""
    import torch
    from tensorrt_llm_tpu_torch.ops import mla as MLA
    DK = MLA_L + MLA_R
    scale = (128 + MLA_R) ** -0.5
    rows = []
    for model, H, lens in MLA_DECODE_CASES:
        B = len(lens)
        pool, tables = _latent_pool(gen, dev, lens, DK)
        kv_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
        q = torch.randn((B, H, DK), generator=gen, device=dev).to(
            torch.bfloat16)
        S = tables.shape[1] * pool.shape[2]
        pools = [pool.clone() for _ in range(copies_for(_nbytes(pool)))]
        times = {sl: cuda_ms([lambda p=p, sl=sl: MLA.mla_decode_attention(
            q, p, tables, kv_lens, scale, MLA_L, split_len=sl)
            for p in pools], 30)
            for sl in MLA.mla_decode_split_choices(S)}
        _, n, pick = MLA.mla_decode_plan(B, H, S)
        best = min(times, key=times.get)
        rows.append({"model": model, "H": H, "kv_lens": lens, "pick": pick,
                     "splits": n, "fastest": best,
                     "pick_over_fastest": times[pick] / times[best],
                     "ms": {str(sl): t for sl, t in times.items()}})
        log(json.dumps(rows[-1]))
        del pools, pool
    _plan_rows("mla_decode_plan", rows, MLA_DECODE_PLAN_SLACK,
               "mla_decode_plan")


def mla_decode_breakdown(gen, dev):
    """Opt-in: where K9's time goes, at a 4,000-token table (B 4) and 16
    and 128 heads.  Every row at 1, 64, 65, 300 and 1,000 tokens under the
    plan (one tile; two tiles in one split; two live splits; four), and
    one split over 4,000-token rows with the pool HBM-cold (copies past
    the L2) and L2-resident (one copy): a tile's cost with and without the
    latent bytes' latency."""
    import torch
    from tensorrt_llm_tpu_torch.ops import mla as MLA
    DK = MLA_L + MLA_R
    scale = (128 + MLA_R) ** -0.5
    rows = []
    for H in (16, 128):
        pool, tables = _latent_pool(gen, dev, [4000] * 4, DK)
        q = torch.randn((4, H, DK), generator=gen, device=dev).to(
            torch.bfloat16)
        pools = [pool.clone() for _ in range(copies_for(_nbytes(pool)))]
        row = {"H": H, "table_tokens": tables.shape[1] * pool.shape[2]}
        for n in (1, 64, 65, 300, 1000):
            kv = torch.full((4,), n, dtype=torch.int32, device=dev)
            row[f"lens_{n}_us"] = 1e3 * cuda_ms(
                [lambda p=p, kv=kv: MLA.mla_decode_attention(
                    q, p, tables, kv, scale, MLA_L) for p in pools], 30)
        kv = torch.full((4,), 4000, dtype=torch.int32, device=dev)
        # one split: a split length past the table
        one = (row["table_tokens"] // MLA.MLA_TILE + 1) * MLA.MLA_TILE
        row["one_split_cold_us"] = 1e3 * cuda_ms(
            [lambda p=p: MLA.mla_decode_attention(
                q, p, tables, kv, scale, MLA_L, split_len=one)
             for p in pools], 10)
        row["one_split_l2_us"] = 1e3 * cuda_ms(
            [lambda: MLA.mla_decode_attention(
                q, pool, tables, kv, scale, MLA_L, split_len=one)], 10)
        rows.append(row)
        log(json.dumps(row))
        del pools, pool
    PHASES["mla_decode_breakdown"] = {"phase": "mla_decode_breakdown",
                                      "rows": rows}


def check_dsa_plan(gen, dev):
    """`dsa_score_plan`'s tiles a block against every tile count K11 can
    take (`dsa_score_tile_choices`), each timed at every DSA_CASES row: the
    pick must be within DSA_PLAN_SLACK of the fastest."""
    import torch
    from tensorrt_llm_tpu_torch.ops import dsa as DSA
    rows = []
    for lens, MB in DSA_CASES:
        B = len(lens)
        pool, tables = _latent_pool(gen, dev, [MB * 16] * B, DSA_DI)
        kv_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
        q = torch.randn((B, DSA_HI, DSA_DI), generator=gen, device=dev).to(
            torch.bfloat16)
        w = torch.rand((B, DSA_HI), generator=gen, device=dev)
        pools = [pool.clone() for _ in range(copies_for(_nbytes(pool)))]
        times = {n: cuda_ms([lambda p=p, n=n: DSA.dsa_scores(
            q, w, p, tables, kv_lens, tiles_per_block=n) for p in pools], 30)
            for n in DSA.dsa_score_tile_choices(MB * 16)}
        pick, blocks = DSA.dsa_score_plan(B, MB * 16)
        best = min(times, key=times.get)
        rows.append({"kv_lens": lens, "MB": MB, "pick": pick,
                     "blocks_per_seq": blocks, "fastest": best,
                     "pick_over_fastest": times[pick] / times[best],
                     "ms": {str(n): t for n, t in times.items()}})
        log(json.dumps(rows[-1]))
        del pools, pool
    _plan_rows("dsa_score_plan", rows, DSA_PLAN_SLACK, "dsa_score_plan")


def check_mla(gen, dev):
    """K9 mla_decode, K10 mla_prefill and K11 dsa_score against their plain
    versions at Moonlight's 16 and DeepSeek-V3's 128 heads (latent 512 +
    64) and V3.2's indexer (64 heads of 128)."""
    import torch
    from tensorrt_llm_tpu_torch.ops import dsa as DSA
    from tensorrt_llm_tpu_torch.ops import mla as MLA
    _no_serialized_wgmma("mla_prefill_sm90.cu")
    _no_serialized_wgmma("dsa_score.cu")
    DK = MLA_L + MLA_R
    scale = (128 + MLA_R) ** -0.5
    for model, H, lens in MLA_DECODE_CASES:
        B = len(lens)
        pool, tables = _latent_pool(gen, dev, lens, DK)
        kv_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
        q = torch.randn((B, H, DK), generator=gen, device=dev).to(
            torch.bfloat16)
        out = MLA.mla_decode_attention(q, pool, tables, kv_lens, scale, MLA_L)
        again = MLA.mla_decode_attention(q, pool, tables, kv_lens, scale,
                                         MLA_L)
        ref = MLA.mla_decode_plain(q, pool, tables, kv_lens, scale, MLA_L)
        torch.cuda.synchronize()
        assert torch.equal(out, again), \
            "mla_decode: a second call gave other bits"
        err = (out.float() - ref.float()).abs().max().item()
        hu = host_us(lambda: MLA.mla_decode_attention(
            q, pool, tables, kv_lens, scale, MLA_L))
        pools = [pool.clone() for _ in range(copies_for(_nbytes(pool)))]
        k_ms = cuda_ms([lambda p=p: MLA.mla_decode_attention(
            q, p, tables, kv_lens, scale, MLA_L) for p in pools], 30)
        del pools
        p_ms = cuda_ms([lambda: MLA.mla_decode_plain(
            q, pool, tables, kv_lens, scale, MLA_L)], 5)
        S = tables.shape[1] * pool.shape[2]
        lat = pool[tables.long()][:, :, 0].reshape(B, S, DK)
        mask = (torch.arange(S, device=dev)[None, :]
                < kv_lens.long()[:, None])[:, None, None, :]
        l_ms = _sdpa_latent_ms(q[:, :, None], lat, mask, scale, 30)
        hb, n_split, split_len = MLA.mla_decode_plan(B, H, S)
        # each latent row read once (the design reads it once per 64-head
        # block: `latent_reads`), q in and the latent output out, bf16
        nbytes = sum(lens) * DK * 2 + B * H * (DK + MLA_L) * 2
        ops = 2 * H * (DK + MLA_L) * sum(lens)
        # the kernel rounds P to bf16 (2^-9 relative), both sides round
        # the output to bf16 (2^-8): 2% of the largest output
        tol = 2e-2 * max(1.0, ref.float().abs().max().item())
        record("mla_decode", {"model": model, "H": H, "L": MLA_L,
                              "R": MLA_R, "kv_lens": lens,
                              "head_blocks": hb, "splits": n_split,
                              "split_len": split_len, "latent_reads": hb},
               err, tol, k_ms, p_ms, l_ms, bound_ms(nbytes, ops), host_us=hu)
        del pool, lat, mask
    for model, H, T, off in MLA_PREFILL_CASES:
        kv_len = off + T
        pool, tables = _latent_pool(gen, dev, [kv_len], DK)
        table = tables[0].contiguous()
        q = torch.randn((T, H, DK), generator=gen, device=dev).to(
            torch.bfloat16)
        out = MLA.mla_prefill_attention(q, pool, table, kv_len, off, scale,
                                        MLA_L)
        ref = MLA.mla_prefill_plain(q, pool, table, kv_len, off, scale,
                                    MLA_L)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        pools = [pool.clone() for _ in range(copies_for(_nbytes(pool)))]
        k_ms = cuda_ms([lambda p=p: MLA.mla_prefill_attention(
            q, p, table, kv_len, off, scale, MLA_L) for p in pools], 20)
        del pools
        p_ms = cuda_ms([lambda: MLA.mla_prefill_plain(
            q, pool, table, kv_len, off, scale, MLA_L)], 5)
        lat = pool[table.long()][:, 0].reshape(-1, DK)[None, :kv_len]
        qp = off + torch.arange(T, device=dev)[:, None]
        mask = torch.arange(kv_len, device=dev)[None, :] <= qp
        l_ms = _sdpa_latent_ms(q.permute(1, 0, 2)[None], lat, mask, scale,
                               20)
        pairs = sum(min(off + t + 1, kv_len) for t in range(T))
        nbytes = kv_len * DK * 2 + T * H * (DK + MLA_L) * 2
        # the kernel rounds P to bf16 (2^-9 relative), both sides round
        # the output to bf16 (2^-8): 2% of the largest output
        tol = 2e-2 * max(1.0, ref.float().abs().max().item())
        blocks, n_split, split_len = MLA.mla_prefill_splits(T, H, kv_len,
                                                            off)
        record("mla_prefill", {"model": model, "H": H, "L": MLA_L,
                               "R": MLA_R, "T": T, "q_offset": off,
                               "blocks": blocks, "splits": n_split,
                               "split_len": split_len},
               err, tol, k_ms, p_ms, l_ms,
               bound_ms(nbytes, 2 * H * (DK + MLA_L) * pairs))
        del pool, lat
    for lens, MB in DSA_CASES:
        B = len(lens)
        pool, tables = _latent_pool(gen, dev, [MB * 16] * B, DSA_DI)
        kv_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
        q = torch.randn((B, DSA_HI, DSA_DI), generator=gen, device=dev).to(
            torch.bfloat16)
        w = torch.rand((B, DSA_HI), generator=gen, device=dev) * (
            DSA_DI ** -0.5 * DSA_HI ** -0.5)
        out = DSA.dsa_scores(q, w, pool, tables, kv_lens)
        again = DSA.dsa_scores(q, w, pool, tables, kv_lens)
        ref = DSA.dsa_scores_plain(q, w, pool, tables, kv_lens)
        torch.cuda.synchronize()
        assert torch.equal(out, again), \
            "dsa_score: a second call gave other bits"
        hu = host_us(lambda: DSA.dsa_scores(q, w, pool, tables, kv_lens))
        valid = torch.arange(MB * 16, device=dev)[None, :] \
            < kv_lens.long()[:, None]
        assert torch.equal(out[~valid], ref[~valid]), \
            "dsa_score: slots past kv_len are not NEG_INF"
        err = (out[valid] - ref[valid]).abs().max().item() \
            if bool(valid.any()) else 0.0
        pools = [pool.clone() for _ in range(copies_for(_nbytes(pool)))]
        k_ms = cuda_ms([lambda p=p: DSA.dsa_scores(
            q, w, p, tables, kv_lens) for p in pools], 30)
        del pools
        p_ms = cuda_ms([lambda: DSA.dsa_scores_plain(
            q, w, pool, tables, kv_lens)], 5)
        # products of bf16 values are exact in f32; only the order of the
        # f32 sums over 128 channels and 64 heads differs: 1e-3 of max|ref|
        tol = 1e-3 * max(1.0, ref[valid].abs().max().item()
                         if bool(valid.any()) else 1.0)
        nbytes = (sum(lens) * DSA_DI * 2 + B * DSA_HI * (DSA_DI * 2 + 4)
                  + B * MB * 16 * 4)
        per, blocks = DSA.dsa_score_plan(B, MB * 16)
        record("dsa_score", {"model": "deepseek-v3.2", "Hi": DSA_HI,
                             "Di": DSA_DI, "kv_lens": lens, "MB": MB,
                             "BS": 16, "tiles_per_block": per,
                             "blocks_per_seq": blocks},
               err, tol, k_ms, p_ms, None,
               bound_ms(nbytes, 2 * DSA_HI * DSA_DI * sum(lens)), host_us=hu)
        del pool


# ------------------------------------------------------------ phases 4-8 ---
TINYLLAMA = dict(vocab_size=32000, hidden_size=2048, intermediate_size=5632,
                 num_layers=22, num_heads=32, num_kv_heads=4, head_dim=64,
                 max_position=4096)
LLAMA3_8B = dict(vocab_size=128256, hidden_size=4096, intermediate_size=14336,
                 num_layers=32, num_heads=32, num_kv_heads=8, head_dim=128,
                 max_position=8192)


def w4a16_cfg(shape, **over):
    from tensorrt_llm_tpu_torch.models import ModelConfig
    from tensorrt_llm_tpu_torch.quantization import QuantAlgo, QuantConfig
    return ModelConfig(**{**shape, **over}, quant=QuantConfig(
        quant_algo=QuantAlgo.W4A16, group_size=128))


def w4a8_cfg(shape, **over):
    """W4A8_AWQ group 128 (zero points always, as the JAX package forces)."""
    from tensorrt_llm_tpu_torch.models import ModelConfig
    from tensorrt_llm_tpu_torch.quantization import QuantAlgo, QuantConfig
    return ModelConfig(**{**shape, **over}, quant=QuantConfig(
        quant_algo=QuantAlgo.W4A8_AWQ, group_size=128))


GPT_OSS_LAYERS = 24     # full depth
LLAMA3_W4A8_LAYERS = 8  # Llama-3-8B runs at full depth in `sampling`/`openai`
MOONLIGHT_LAYERS = 27   # full depth
V32_LAYERS = 4          # 61 layers of 256 int4 experts do not fit one card
V32_LONG_PROMPT = 3000  # past index_topk (2048): DSA's top-k drops tokens
V32_DIAG_TOPK = 128     # below the cross-check's 200-token prompt


def gpt_oss_cfg(num_layers):
    from tensorrt_llm_tpu_torch.models import gpt_oss_20b_config
    return gpt_oss_20b_config(num_layers, max_position=4096)


def attention_kernels(cfg, kv_cache_quant="NONE"):
    """(prefill, decode) kernels every layer of a forward launches once on
    this path: K3/K4 (K7/K6 over an INT8 cache) for GQA, K10/K9 for dense
    MLA; under DSA, K11 scores each decode step and the attention itself
    is plain torch (as it is XLA in the JAX package)."""
    if cfg.is_mla:
        return (None, "dsa_score") if cfg.dsa else ("mla_prefill",
                                                    "mla_decode")
    sfx = "_int8" if kv_cache_quant == "INT8" else ""
    return "flash_prefill" + sfx, "paged_decode" + sfx


def moonlight_cfg(num_layers):
    from tensorrt_llm_tpu_torch.models import moonlight_16b_a3b_config
    return moonlight_16b_a3b_config(num_layers)


def deepseek_cfg(num_layers, dsa=True, index_topk=None):
    """DeepSeek-V3.2 widths (with the indexer), or V3 (`dsa=False`), at
    `num_layers`; max_position cut to 8192 (rope table only)."""
    from tensorrt_llm_tpu_torch.models import (
        deepseek_v3_config, deepseek_v32_config)
    make = deepseek_v32_config if dsa else deepseek_v3_config
    cfg = make(num_layers, max_position=8192)
    if index_topk:
        cfg.sparse_attention = dict(cfg.sparse_attention,
                                    index_topk=index_topk)
    return cfg


def w4a16_shapes(model):
    """{(K, N, tiled)} of a model's W4A16 linears (the autotuner's keys)
    and the number of its K-paired ones."""
    from tensorrt_llm_tpu_torch.layers.linear import Linear
    keys, n_kpaired = set(), 0
    for m in model.modules():
        if isinstance(m, Linear) and m.quantized and not m.w4a8:
            q = m.qweight
            tiled = q.dim() == 3
            keys.add((q.shape[-2] * 2 if tiled else q.shape[0] * 2,
                      q.shape[0] * q.shape[2] if tiled else q.shape[1],
                      int(tiled)))
            n_kpaired += not tiled
    return keys, n_kpaired


def report_tactics(phase, model, tuned_before):
    """Print every W4A16 shape's tactic: the candidates' device times and
    the winner where this warmup tuned it, else the cached tactic.  Fails
    if a shape has no tactic or a candidate of it was skipped."""
    from tensorrt_llm_tpu_torch.autotuner import AutoTuner
    tuner = AutoTuner.get()
    keys, _ = w4a16_shapes(model)
    rows = []
    for K, N, tiled in sorted(keys):
        k = ("w4a16", K, N, tiled)
        best = tuner.cache.get(k)
        assert best is not None, f"{phase}: no tactic for {k}"
        times = tuner.timings.get(k) if k not in tuned_before else None
        rows.append({"K": K, "N": N, "tiled": tiled, "tactic": best,
                     "candidates_us": times})
        log(f"  [{phase}] tactic (K={K}, N={N}, tiled={tiled}): {best}"
            + (" <- " + ", ".join(f"{t} {us:.2f} us" for t, us in times)
               if times else " (cached)"))
    skipped = [sk for sk in tuner.skipped
               if sk[0] == "w4a16" and tuple(sk[1:4]) in keys]
    assert not skipped, f"{phase}: tactic candidates skipped: {skipped}"
    return rows


def assert_launches(cfg, counts, stats, required, absent=(), n_kpaired=0,
                    kv_cache_quant="NONE", kpaired_per_layer=0,
                    ramp_per_layer=0):
    """Launches per layer per forward of a serve run, from the launch
    counts and the run's iteration stats: every kernel in `required` ran,
    none in `absent`; every layer of every forward ran the attention
    kernels (`attention_kernels`); every K-paired W4A16 linear K12 once
    (`kpaired_per_layer` of them a layer); for W4A8, K8 for all four
    projections; every MoE layer K5 twice on units built once;
    `ramp_per_layer` K13 launches per layer.  Returns (prefill chunks,
    decode steps, forwards, prefill kernel, decode kernel)."""
    from tensorrt_llm_tpu_torch.quantization import QuantAlgo
    for k in required:
        assert counts.get(k, 0) > 0, f"{k} never launched on the main path"
    for k in absent:
        assert counts.get(k, 0) == 0, f"{k} launched on this path: {counts}"
    chunks = sum(s["num_prefill_chunks"] for s in stats)
    dsteps = sum(s["decode_steps"] for s in stats)
    fwd = chunks + dsteps
    L = cfg.num_layers
    # every layer of every forward went through the attention kernels
    prefill_k, decode_k = attention_kernels(cfg, kv_cache_quant)
    if prefill_k:
        assert counts[prefill_k] == L * chunks, (counts, chunks)
    assert counts[decode_k] == L * dsteps, (counts, dsteps)
    # every K-paired W4A16 weight on K12, once per forward, nothing else
    assert counts.get("w4a16_kpaired", 0) == n_kpaired * fwd, \
        (counts, n_kpaired, fwd)
    if kpaired_per_layer:
        assert n_kpaired == kpaired_per_layer * L, (n_kpaired, L)
    if ramp_per_layer:
        assert counts.get("w4a16_ramp", 0) == ramp_per_layer * L * fwd, \
            (counts, fwd)
    if cfg.quant.quant_algo == QuantAlgo.W4A8_AWQ:
        # QKV, o, gate_up and down on K8 in every layer of every forward;
        # its combine pass wherever the plan slices K (at least the decode
        # steps' down projections, 64 column tiles at Llama-3-8B)
        assert counts["w4a8_gemm"] == 4 * L * fwd, counts
        assert 0 < counts.get("w4a8_combine", 0) <= counts["w4a8_gemm"], \
            counts
    n_moe = sum(cfg.is_moe_layer(i) for i in range(L))
    if n_moe:
        # gate_up and down on K5 in every MoE layer of every forward, on
        # work units computed once per layer
        assert counts["moe_gmm"] == 2 * n_moe * fwd, counts
        assert counts["moe_gmm_units"] == n_moe * fwd, counts
    return chunks, dsteps, fwd, prefill_k, decode_k


SERVE_TOKENS = {}          # phase -> (tokens, chosen-token logprobs)


def serve_model(card, phase, label, cfg, required, absent=(),
                kv_cache_quant="NONE", long_prompt=0, max_seq_len=1024,
                ramp_per_layer=0, kpaired_per_layer=0, llm_kw=None,
                check=None):
    """8 greedy requests (prompts 17..600 tokens, two sharing a 300-token
    prefix, plus one of `long_prompt` tokens when set), 64 new tokens each,
    through `LLM.generate`; the LLM warms up first (the W4A16 autotuner,
    `enable_warmup` default), and the launch counters are reset after that,
    just before the run, and read just after.  A second run with a fresh
    cache salt must give the same tokens.  Every layer of every forward
    must run the path's attention kernels (`attention_kernels`); every
    K-paired W4A16 linear K12 once (`kpaired_per_layer` of them a layer);
    for W4A8, K8 for all four projections; every MoE layer K5 twice;
    `ramp_per_layer` K13 launches per layer; the
    kernels in `absent` must not launch at all.  `cfg` may be a checkpoint
    directory, `llm_kw` more `LLM` arguments (a tokenizer, `quant_algo`);
    `check(llm, prompts, outs)` runs before the `LLM` shuts down.  The
    summary keeps the build's peak device memory and peak host RSS."""
    import numpy as np
    import torch
    import tensorrt_llm_tpu_torch as T
    from tensorrt_llm_tpu_torch.autotuner import AutoTuner
    from tensorrt_llm_tpu_torch.ops import cuda_build
    torch.cuda.reset_peak_memory_stats()
    tuned_before = set(AutoTuner.get().timings)
    kw = dict(skip_tokenizer_init=True, device=DEVICE, max_batch_size=4,
              max_num_tokens=256, max_seq_len=max_seq_len, kv_block_size=16,
              kv_num_blocks=640, kv_cache_quant=kv_cache_quant, seed=0,
              return_perf_metrics=True)
    kw.update(llm_kw or {})
    with PeakRss() as rss:
        rss_before = rss.peak / 2 ** 30
        t0 = time.perf_counter()
        llm = T.LLM(model=cfg, **kw)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
    build_peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    build_rss_gib = rss.gib
    cfg = llm.model_config
    log(f"[{phase}] {label}, built and warmed up in {build_s:.1f} s "
        f"(peak device memory {build_peak_gib:.2f} GiB, peak host RSS "
        f"{build_rss_gib:.2f} GiB from {rss_before:.2f} GiB before; {card})")
    tactics = report_tactics(phase, llm.model, tuned_before)
    _, n_kpaired = w4a16_shapes(llm.model)
    rng = np.random.default_rng(0)
    V = cfg.vocab_size

    def ids(n):
        return [int(t) for t in rng.integers(10, V - 10, n)]

    shared = ids(300)
    prompts = [shared + ids(20), shared + ids(45)]
    prompts += [ids(n) for n in (17, 64, 200, 333, 480, 600)]
    if long_prompt:
        prompts.append(ids(long_prompt))
    sp = T.SamplingParams(max_tokens=64, temperature=0.0,
                          ignore_eos=True, logprobs=1)
    try:
        it0 = llm.executor.iteration
        cuda_build.reset_launch_counts()
        t0 = time.perf_counter()
        outs = llm.generate(prompts, sp, cache_salt="run1")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(cuda_build.launch_counts)
        stats = [s for s in llm.get_stats() if s["iteration"] > it0]
        kv = llm.get_kv_cache_stats()
        toks = [o.outputs[0].token_ids for o in outs]
        assert all(len(t) == 64 for t in toks), [len(t) for t in toks]
        lps = [[lp for d in o.outputs[0].logprobs for lp in d.values()]
               for o in outs]
        assert np.isfinite([v for r in lps for v in r]).all(), \
            "non-finite logprobs"
        assert kv["reused_blocks"] > 0, kv
        # a fresh salt: no reuse of run 1's blocks, so the same schedule
        again = [o.outputs[0].token_ids
                 for o in llm.generate(prompts, sp, cache_salt="run2")]
        assert again == toks, "second run gave other tokens"
        if check is not None:
            check(llm, prompts, outs)
        windows = [getattr(getattr(layer.attn, "backend", None),
                           "sliding_window", None)
                   for layer in llm.model.layers]
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        kv_bytes_per_token = _nbytes(llm.engine.kv_caches) / (
            llm.kv_manager.num_blocks * llm.kv_manager.block_size)
    finally:
        llm.shutdown()
    SERVE_TOKENS[phase] = (toks, lps)
    chunks, dsteps, fwd, prefill_k, decode_k = assert_launches(
        cfg, counts, stats, required, absent, n_kpaired, kv_cache_quant,
        kpaired_per_layer, ramp_per_layer)
    ttft = [o.metrics["ttft_s"] for o in outs]
    n_out = sum(len(t) for t in toks)
    gemms = sum(counts.get(k, 0)
                for k in ("w4a16_gemm", "w4a16_gemv", "w4a16_kpaired",
                          "w4a16_ramp", "w4a8_gemm"))
    summary = {
        "phase": phase, "model": label, "card": card,
        "build_s": build_s, "build_peak_device_gib": build_peak_gib,
        "build_peak_host_rss_gib": build_rss_gib,
        "host_rss_before_build_gib": rss_before, "requests": len(prompts),
        "output_tokens": n_out, "wall_s": wall, "tokens_per_s": n_out / wall,
        "ttft_s_mean": float(np.mean(ttft)), "ttft_s_max": float(max(ttft)),
        "prefill_chunks": chunks, "decode_steps": dsteps,
        "launches": counts,
        "gemm_launches_per_forward": gemms / fwd,
        "kpaired_linears": n_kpaired,
        "kpaired_per_forward": counts.get("w4a16_kpaired", 0) / fwd,
        "ramp_per_forward": counts.get("w4a16_ramp", 0) / fwd,
        "moe_gmm_per_forward": counts.get("moe_gmm", 0) / fwd,
        "w4a8_combine_per_forward": counts.get("w4a8_combine", 0) / fwd,
        "attention_kernels": [prefill_k, decode_k],
        "prefill_attention_per_chunk": (counts[prefill_k] / chunks
                                        if prefill_k else None),
        "decode_attention_per_step": counts[decode_k] / dsteps,
        "prompt_tokens": sum(len(p) for p in prompts),
        "sliding_windows": sorted(set(map(str, windows))),
        "peak_mem_gib": peak_gb, "kv_cache_quant": kv_cache_quant,
        "kv_bytes_per_token": kv_bytes_per_token, "kv": kv,
        "tactics": tactics}
    PHASES[phase] = summary
    log(json.dumps(summary))
    del llm
    torch.cuda.empty_cache()
    return counts


RAMP_TIE = 0.05            # logprob gap accepted at a greedy near-tie


def serve_tactic(card, path, label, variant, required, absent,
                 ref_phase="serve", **kw):
    """TinyLlama W4A16 served with a tactic file, loaded through
    `AutoTuner.load`, that sets ``{"variant": variant}`` for every tiled
    shape.  Greedy tokens must equal the `ref_phase` run's, or differ first
    where both runs' chosen tokens sit at a near-tie (both logprobs below
    log(1/2) + RAMP_TIE and within RAMP_TIE)."""
    from tensorrt_llm_tpu_torch.autotuner import AutoTuner
    from tensorrt_llm_tpu_torch.ops import cuda_build
    tuner = AutoTuner.get()
    saved = dict(tuner.cache)
    cfg = w4a16_cfg(TINYLLAMA)
    H, I = cfg.hidden_size, cfg.intermediate_size
    qkv = (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim
    shapes = [(H, qkv), (cfg.num_heads * cfg.head_dim, H), (H, 2 * I), (I, H)]
    tfile = cuda_build.kernel_dir() / f"{variant}_tactics.json"
    tfile.parent.mkdir(parents=True, exist_ok=True)
    with open(tfile, "w") as f:
        json.dump([{"key": ["w4a16", K, N, 1], "tactic": {"variant": variant}}
                   for K, N in shapes], f)
    try:
        tuner.load(str(tfile))
        counts = serve_model(card, path, label, cfg, required, absent=absent,
                             **kw)
    finally:
        tuner.cache = saved
    if ref_phase in SERVE_TOKENS:
        import math
        (ta, la), (tb, lb) = SERVE_TOKENS[ref_phase], SERVE_TOKENS[path]
        exact, ties = 0, []
        for a, b, pa, pb in zip(ta, tb, la, lb):
            if a == b:
                exact += 1
                continue
            i = next(i for i, (u, v) in enumerate(zip(a, b)) if u != v)
            ok = (max(pa[i], pb[i]) <= math.log(0.5) + RAMP_TIE
                  and abs(pa[i] - pb[i]) <= RAMP_TIE)
            ties.append({"position": i, "tokens": [a[i], b[i]],
                         "logprobs": [pa[i], pb[i]], "near_tie": ok})
        PHASES[path].update({"tokens_equal_to": ref_phase,
                             "exact_requests": exact,
                             "first_differences": ties})
        log(json.dumps({"phase": path, "exact_requests": exact,
                        "of": len(ta), "first_differences": ties}))
        assert all(d["near_tie"] for d in ties), ties
    return counts


def serve_ramp(card):
    """The ramp for every tiled shape: qkv, o and gate_up (K 2048) run K13
    in every layer of every forward; down (K 5632, not a multiple of 1024)
    runs K1, as the JAX package's tiled kernel."""
    return serve_tactic(card, RAMP_PATH,
                        "tinyllama-1.1b W4A16 (22 layers), ramp tactic",
                        "ramp", ("w4a16_ramp", "w4a16_gemm"),
                        ("w4a16_gemv",), ramp_per_layer=3)


def serve_stream(card):
    """The stream tactic for every tiled shape: K2 for every decode step's
    projections (at most 16 rows), K1 for the prefill chunks; the tuner of
    the `serve` phase picks per shape, and since K1 runs on the Hopper
    mainloop it may pick K1 at decode too."""
    return serve_tactic(card, STREAM_PATH,
                        "tinyllama-1.1b W4A16 (22 layers), stream tactic",
                        "stream", ("w4a16_gemv", "w4a16_gemm"),
                        ("w4a16_ramp",))


def fused_mlp_run(card):
    """K14 through its op, as the JAX package's one caller (a kernel sweep)
    drives it: `w4a16_fused_mlp` on every layer's gated MLP of the
    full-width TinyLlama W4A16 model (22 layers, seeded weights) at a
    decode batch (4 rows) and a 200-token chunk, held against the layer's
    own unfused `GatedMLP` forward; counters reset just before, read just
    after.  The same calls again under torch.profiler must show one device
    operation each."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from tensorrt_llm_tpu_torch.models import get_model_class
    from tensorrt_llm_tpu_torch.ops import cuda_build
    from tensorrt_llm_tpu_torch.ops.w4a16_fused import w4a16_fused_mlp
    cfg = w4a16_cfg(TINYLLAMA)
    model = get_model_class(cfg.architecture)(cfg, DEVICE).init_random(0)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(8)
    xs = [torch.randn((M, cfg.hidden_size), generator=gen, device=DEVICE
                      ).to(torch.bfloat16) for M in (4, 200)]
    worst = 0.0
    cuda_build.reset_launch_counts()
    with torch.no_grad():
        for layer in model.layers:
            mlp = layer.mlp
            gu, dn = mlp.gate_up, mlp.down
            for x in xs:
                out = w4a16_fused_mlp(x, gu.qweight, gu.scales, dn.qweight,
                                      dn.scales, gu.zeros, dn.zeros, gu.bias,
                                      dn.bias, mlp.activation)
                ref = mlp(x)
                # the unfused forward rounds gate_up to bf16 before the
                # activation (2^-8 relative on h): 2% of the largest output
                err = (out.float() - ref.float()).abs().max().item()
                tol = 2e-2 * ref.float().abs().max().item()
                assert err <= tol, (err, tol)
                worst = max(worst, err / tol)
    torch.cuda.synchronize()
    counts = dict(cuda_build.launch_counts)
    L = cfg.num_layers
    assert counts.get("w4a16_fused_mlp", 0) == 2 * L, counts
    # one device operation a call (no memset, no combine pass): the same
    # calls again under torch.profiler
    with torch.no_grad(), profile(activities=[ProfilerActivity.CUDA]) as prof:
        for layer in model.layers:
            gu, dn = layer.mlp.gate_up, layer.mlp.down
            for x in xs:
                w4a16_fused_mlp(x, gu.qweight, gu.scales, dn.qweight,
                                dn.scales, gu.zeros, dn.zeros, gu.bias,
                                dn.bias, layer.mlp.activation)
        torch.cuda.synchronize()
    dev_ops = {e.key[:90]: e.count for e in prof.key_averages()
               if _dev_us(e) > 0}
    assert sum(dev_ops.values()) == 2 * L, \
        f"K14 calls ran {dev_ops}, not one device operation each"
    PHASES[FUSED_PATH] = {"phase": FUSED_PATH, "card": card,
                          "model": "tinyllama-1.1b W4A16 (22 layers)",
                          "launches": counts, "rows": [4, 200],
                          "device_ops_of_calls": dev_ops,
                          "worst_err_over_tol": worst}
    log(json.dumps(PHASES[FUSED_PATH]))
    del model
    torch.cuda.empty_cache()
    return counts


# Teacher-forcing MoE routing at near-ties (`_RouteTies`), bounded by fixed
# numbers: a flipped token is forced only if the CPU's margin is at most
# ROUTE_TIE times the token's card-vs-CPU score difference and that
# difference is at most ROUTE_NOISE_MAX (score units; the largest
# difference of a forced token in this repo's H100 runs was 0.0064, GPT-OSS
# router logits), and a check fails if it forces more than
# ROUTE_MAX_FORCED tokens (the runs forced at most 4).
ROUTE_TIE = 2.0
ROUTE_NOISE_MAX = 0.01
ROUTE_MAX_FORCED = 6


class _RouteTies:
    """Teacher-forces MoE routing at near-ties, as the cross-check
    teacher-forces tokens.  Each forward runs on the CPU first, which
    records every MoE call's selection scores and experts; the card's
    forward then routes as it computes, except for a token whose top-k set
    differs from the CPU's where the CPU's margin between its k-th and
    (k+1)-th score is at most `ROUTE_TIE` times that token's largest
    card-vs-CPU score difference, and that difference is at most
    `ROUTE_NOISE_MAX`: such a token takes the CPU's experts and weights.
    A flip at a wider margin or a larger difference is left alone, so the
    logits show it.  Every flip is listed (`flips`, each marked forced or
    not), and so is the largest score difference of any token
    (`noise_max`).  With ``force=False`` nothing is forced: a witness run
    that only lists the flips."""

    def __init__(self, force=True):
        self.force = force

    def __enter__(self):
        import torch
        from tensorrt_llm_tpu_torch.layers import moe
        self.cls = moe.MoE
        self.orig = moe.MoE.route
        self.cpu, self.i, self.on_card = [], 0, False
        self.flips, self.noise_max = [], 0.0
        tie = self

        def scores(m, x):
            lg = x.float() @ m.router.float()
            if m.has_router_bias:
                lg = lg + m.router_bias.float()[None, :]
            if m.topk_then_softmax:
                return lg
            sc = (torch.softmax(lg, dim=-1) if m.score_func == "softmax"
                  else torch.sigmoid(lg))
            return sc + m.score_bias.float()[None, :] if m.has_score_bias \
                else sc

        def route(m, x):
            ids, w = tie.orig(m, x)
            sc = scores(m, x).cpu()
            if not tie.on_card:
                tie.cpu.append((sc, ids, w))
                return ids, w
            c_sc, c_ids, c_w = tie.cpu[tie.i]
            tie.i += 1
            tie.noise_max = max(tie.noise_max,
                                float((sc - c_sc).abs().max()))
            ids_h, w_h = ids.cpu(), w.cpu()
            for t in range(ids_h.shape[0]):
                if set(ids_h[t].tolist()) == set(c_ids[t].tolist()):
                    continue
                srt = torch.sort(c_sc[t], descending=True).values
                k = c_ids.shape[1]
                gap = float(srt[k - 1] - srt[k])
                noise = float((sc[t] - c_sc[t]).abs().max())
                tie_ok = gap <= ROUTE_TIE * noise and noise <= ROUTE_NOISE_MAX
                forced = tie.force and tie_ok
                if forced:
                    ids_h[t], w_h[t] = c_ids[t], c_w[t].to(w_h.dtype)
                tie.flips.append({"call": tie.i - 1, "token": t, "gap": gap,
                                  "noise": noise, "near_tie": tie_ok,
                                  "forced": forced})
            return ids_h.to(x.device), w_h.to(x.device)

        self.cls.route = route
        return self

    @property
    def forced(self):
        return [f for f in self.flips if f["forced"]]

    def step(self, on_card):
        """Start the CPU's forward of a pair (its selections are recorded),
        or the card's (they are compared)."""
        if not on_card:
            self.cpu = []
        self.i, self.on_card = 0, on_card

    def __exit__(self, *exc):
        self.cls.route = self.orig


def cross_check_cpu(phase, label, cfg, seed, n_prompt, chunk, n_decode,
                    kv_cache_quant="NONE", tol=0.08, witness=False,
                    path=None):
    """The same weights on the card and on the CPU (plain versions), carried
    across with state()/load_state -- or, with `path`, each model loading
    that checkpoint directory itself (`load_hf_weights`) -- : a chunked
    prefill of `n_prompt` tokens then `n_decode` decode steps,
    teacher-forced on the CPU's tokens (and, at bounded near-ties, on its
    MoE routing: `_RouteTies`), over bf16 or INT8 KV pools.
    ``witness=True`` forces no routing and asserts nothing: it only lists
    the flips and the logit differences."""
    import numpy as np
    import torch
    from tensorrt_llm_tpu_torch.attention_backend import AttentionMetadata
    from tensorrt_llm_tpu_torch.llmapi.hf_checkpoint import SafetensorsReader
    from tensorrt_llm_tpu_torch.models import get_model_class
    from tensorrt_llm_tpu_torch.runtime.kv_cache_manager import model_pools
    cls = get_model_class(cfg.architecture)
    if path is None:
        gpu = cls(cfg, DEVICE).init_random(seed)
        cpu = cls(cfg, "cpu").load_state(
            {k: v.cpu() for k, v in gpu.state().items()})
    else:
        with SafetensorsReader(path) as reader:
            gpu = cls(cfg, DEVICE).load_hf_weights(reader)
            cpu = cls(cfg, "cpu").load_hf_weights(reader)
    rng = np.random.default_rng(seed)
    prompt = [int(t) for t in rng.integers(10, cfg.vocab_size - 10,
                                            n_prompt)]
    BS = 16
    blocks = list(range(1, -(-(n_prompt + n_decode) // BS) + 1))

    def pools(dev):
        return model_pools(cfg, len(blocks) + 1, BS, kv_cache_quant, dev)

    caches = {"cuda": pools(DEVICE), "cpu": pools("cpu")}
    models = {"cuda": gpu, "cpu": cpu}

    def run(key, ids, pos, kv_len, mode, q_off):
        dev = DEVICE if key == "cuda" else "cpu"
        n_blk = -(-kv_len // BS)
        meta = AttentionMetadata(
            positions=torch.tensor(pos, device=dev),
            slot_mapping=torch.tensor([blocks[p // BS] * BS + p % BS
                                       for p in pos], device=dev),
            block_tables=torch.tensor([blocks[:n_blk]], dtype=torch.int32,
                                      device=dev),
            kv_lens=torch.tensor([kv_len], dtype=torch.int32, device=dev),
            q_offset=q_off, mode=mode)
        with torch.no_grad():
            out = models[key](torch.tensor(ids, device=dev), caches[key],
                              meta, torch.tensor([len(ids) - 1], device=dev))
        return out[0].float().cpu().numpy()

    TOL = tol
    steps, agree, compared = [], 0, 0
    seq = list(prompt)
    plan = [(lo, min(lo + chunk, n_prompt)) for lo in range(0, n_prompt, chunk)]

    def pair(*args):
        """(card logits, CPU logits) of one forward, the CPU's first."""
        ties.step(False)
        lc = run("cpu", *args)
        ties.step(True)
        return run("cuda", *args), lc

    with _RouteTies(force=not witness) as ties:
        for lo, hi in plan:
            steps.append(pair(seq[lo:hi], list(range(lo, hi)), hi,
                              "prefill", lo))
        for _ in range(n_decode):
            seq.append(int(np.argmax(steps[-1][1])))   # teacher-force the CPU
            n = len(seq)
            steps.append(pair([seq[-1]], [n - 1], n, "decode", 0))
    diffs = []
    for lg, lc in steps[len(plan) - 1:]:
        assert np.isfinite(lg).all() and np.isfinite(lc).all()
        diffs.append(float(np.abs(lg - lc).max()))
        top2 = np.sort(lc)[-2:]
        if top2[1] - top2[0] > TOL:
            compared += 1
            agree += int(np.argmax(lg) == np.argmax(lc))
    worst = max(diffs)
    res = {"phase": phase, "model": label, "kv_cache_quant": kv_cache_quant,
           "prefill_chunks": len(plan),
           "decode_steps": n_decode, "max_abs_logit_diff": worst, "tol": TOL,
           "step_max_abs_logit_diff": diffs,
           "max_abs_logit": max(float(np.abs(lc).max()) for _, lc in steps),
           "greedy_compared": compared, "greedy_agree": agree,
           "routing_flips": ties.flips,
           "routing_ties_forced": len(ties.forced),
           "router_score_noise_max": ties.noise_max}
    moe = next((layer.mlp for layer in gpu.layers if layer.is_moe), None)
    if moe is not None:
        # routing, sort, both K5 launches and the finalize read nothing
        # back to the host: a synchronizing call raises in this mode
        h = torch.randn((37, cfg.hidden_size), device=DEVICE).to(
            torch.bfloat16)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.no_grad():
                moe(h)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        res["moe_forward_host_syncs"] = 0
    PHASES[phase] = res
    log(json.dumps(res))
    if not witness:
        assert worst <= TOL, res
        assert agree == compared, res
        assert len(ties.forced) <= ROUTE_MAX_FORCED, res
    del gpu, cpu, caches, models
    torch.cuda.empty_cache()
    return res


def route_witness():
    """Opt-in: are the routing flips of the MoE cross-checks the redesigned
    K12's doing?  GPT-OSS and Moonlight at 2 layers, as in their
    cross-checks, with no routing forced, twice: as served (K12 on its
    o_proj / kv_a) and with K12's calls replaced by its plain version on
    the card (the dequantized bf16 weight in an f32 product).  A flip that
    both runs show at the same MoE call and token does not come from the
    kernel."""
    from tensorrt_llm_tpu_torch.ops import w4a16_gemm as W
    orig = W._KERNELS["w4a16_kpaired"]

    def plain(x, packed, s, z, b, act, **params):
        return W.w4a16_matmul_plain(x, packed, s, z, b, act)

    summary = {}
    for label, cfg, seed in (("gpt_oss", gpt_oss_cfg(2), 4),
                             ("moonlight", moonlight_cfg(2), 6)):
        runs = {}
        for mode in ("k12", "plain_k12"):
            W._KERNELS["w4a16_kpaired"] = orig if mode == "k12" else plain
            try:
                runs[mode] = cross_check_cpu(
                    f"route_witness_{label}_{mode}", f"{label}, 2 layers",
                    cfg, seed=seed, n_prompt=200, chunk=128, n_decode=4,
                    witness=True)
            finally:
                W._KERNELS["w4a16_kpaired"] = orig
        seen = {m: {(f["call"], f["token"]) for f in r["routing_flips"]}
                for m, r in runs.items()}
        summary[label] = {
            "flips_k12": sorted(seen["k12"]),
            "flips_plain_k12": sorted(seen["plain_k12"]),
            "in_both": sorted(seen["k12"] & seen["plain_k12"]),
            "step_max_abs_logit_diff": {
                m: r["step_max_abs_logit_diff"] for m, r in runs.items()}}
    PHASES["route_witness"] = summary
    log(json.dumps({"route_witness": summary}))


def dsa_cross_breakdown():
    """Opt-in: the V3.2 card-vs-CPU check at a covering top-k and at
    `V32_DIAG_TOPK` (below the prompt), counting for every layer call where
    the card's top-k differs from the CPU's: prefill-mask entries, and
    decode selections (symmetric set difference).  Top-k is discontinuous
    in the scores, so one-ulp differences upstream can swap a token at the
    threshold; the logit gap is reported, not held to a tolerance."""
    import torch
    from tensorrt_llm_tpu_torch.layers import mla as LM
    seen = {"cuda": [], "cpu": []}
    orig = LM.dsa_prefill_mask, LM.dsa_decode_select

    def recording(fn):
        def f(*a, **k):
            out = fn(*a, **k)
            seen[out.device.type].append(out.cpu())
            return out
        return f

    LM.dsa_prefill_mask, LM.dsa_decode_select = map(recording, orig)
    try:
        for topk in (2048, V32_DIAG_TOPK):
            seen["cuda"].clear()
            seen["cpu"].clear()
            phase = f"dsa_cross_topk{topk}"
            cross_check_cpu(phase, f"deepseek-v3.2 width, 2 layers, "
                            f"index_topk {topk}",
                            deepseek_cfg(2, index_topk=topk), seed=7,
                            n_prompt=200, chunk=128, n_decode=4,
                            tol=float("inf"))
            diffs = []
            for a, b in zip(seen["cuda"], seen["cpu"]):
                if a.dtype == torch.bool:
                    diffs.append(int((a != b).sum()))
                else:
                    diffs.append(sum(len(set(x.tolist()) ^ set(y.tolist()))
                                     for x, y in zip(a, b)))
            PHASES[phase]["selection_diffs_per_layer_call"] = diffs
            log(json.dumps({"phase": phase, "selection_diffs": diffs}))
    finally:
        LM.dsa_prefill_mask, LM.dsa_decode_select = orig


def width_run(phase, label, cfg, required):
    """A short `LLM.generate` (prompts of 300 and 41 tokens, 16 new tokens
    each) at a model's full width and cut depth, so that the attention
    kernels run at its head count inside the model."""
    import numpy as np
    import torch
    import tensorrt_llm_tpu_torch as T
    from tensorrt_llm_tpu_torch.ops import cuda_build
    llm = T.LLM(model=cfg, skip_tokenizer_init=True, device=DEVICE,
                max_batch_size=4, max_num_tokens=256, max_seq_len=1024,
                kv_num_blocks=640, seed=2)
    rng = np.random.default_rng(2)
    prompts = [[int(t) for t in rng.integers(10, cfg.vocab_size - 10, n)]
               for n in (300, 41)]
    try:
        cuda_build.reset_launch_counts()
        outs = llm.generate(prompts, T.SamplingParams(
            max_tokens=16, temperature=0.0, ignore_eos=True, logprobs=1))
        torch.cuda.synchronize()
        counts = dict(cuda_build.launch_counts)
    finally:
        llm.shutdown()
    assert all(len(o.outputs[0].token_ids) == 16 for o in outs)
    lps = [lp for o in outs for d in o.outputs[0].logprobs
           for lp in d.values()]
    assert np.isfinite(lps).all()
    for k in required:
        assert counts.get(k, 0) > 0, f"{k} did not run in {label}"
    PHASES[phase] = {"phase": label, "launches": counts,
                     "tokens": [o.outputs[0].token_ids[:8] for o in outs]}
    log(json.dumps(PHASES[phase]))
    del llm
    torch.cuda.empty_cache()


def _dev_us(e):
    """A profiler event's own device time (us)."""
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0))


def profile_serve(card, phase, cfg, kv_cache_quant="NONE", long_prompt=0,
                  max_seq_len=1024):
    """Opt-in phases (`profile`: TinyLlama, `profile_gptoss`: GPT-OSS-20B,
    `profile_llama3_int8`: Llama-3-8B W4A8 + INT8 KV, `profile_deepseek`:
    Moonlight-16B-A3B, `profile_deepseek_v32`: V3.2 widths with one more
    prompt of `long_prompt` tokens): trace a short serve window (4 requests
    of 200 tokens, 32 new tokens each) with torch.profiler and report the
    device-busy share of the wall time and the kernels holding the device,
    by total device time (the top 12, and every kernel of the port).  For
    W4A8 also the device kernels one per-token activation quantization
    launches.  K9 must run as one kernel a call: no decode combine pass."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    import tensorrt_llm_tpu_torch as T
    from tensorrt_llm_tpu_torch.ops.w4a16_gemm import quantize_act_int8
    from tensorrt_llm_tpu_torch.quantization import QuantAlgo
    llm = T.LLM(model=cfg, skip_tokenizer_init=True,
                device=DEVICE, max_batch_size=4, max_num_tokens=256,
                max_seq_len=max_seq_len, kv_num_blocks=640,
                kv_cache_quant=kv_cache_quant, seed=0)
    rng = np.random.default_rng(3)
    prompts = [[int(t) for t in rng.integers(10, cfg.vocab_size - 10, n)]
               for n in [200] * 4 + ([long_prompt] if long_prompt else [])]
    try:
        llm.generate([[1, 2, 3]], T.SamplingParams(max_tokens=2,
                                                   temperature=0.0))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            llm.generate(prompts, T.SamplingParams(
                max_tokens=32, temperature=0.0, ignore_eos=True))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        stats = llm.get_stats()
    finally:
        llm.shutdown()

    rows = sorted(((e.key, _dev_us(e), e.count) for e in prof.key_averages()
                   if _dev_us(e) > 0), key=lambda r: -r[1])
    busy = sum(r[1] for r in rows) / 1e6
    PHASES[phase] = {
        "phase": phase, "card": card, "wall_s": wall,
        "device_busy_s": busy, "device_busy_share": busy / wall,
        "decode_steps": sum(s["decode_steps"] for s in stats[-50:]),
        "top_kernels_ms": [[k[:90], us / 1e3, n] for k, us, n in rows[:12]],
        # every kernel of the port, by device time (a programmatic
        # dependent launch, as K12/K13's combine pass, is timed from its
        # early start, so it overlaps its mainloop's time)
        "port_kernels_ms": [[k[:90], us / 1e3, n] for k, us, n in rows
                            if "tllm::" in k]}
    combine = [k for k, _, _ in rows if "mla_decode_combine" in k]
    assert not combine, f"K9 ran a combine pass: {combine}"
    if cfg.quant.quant_algo == QuantAlgo.W4A8_AWQ:
        x = torch.randn((4, cfg.hidden_size), device=DEVICE).to(
            torch.bfloat16)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as p1:
            quantize_act_int8(x)
            torch.cuda.synchronize()
        n = sum(e.count for e in p1.key_averages() if _dev_us(e) > 0)
        PHASES[phase]["act_quant_kernels_per_linear"] = n
        PHASES[phase]["act_quant_kernels_per_forward"] = \
            4 * cfg.num_layers * n
    log(json.dumps(PHASES[phase]))
    del llm
    torch.cuda.empty_cache()


# ------------------------------------------------------ phase 17: checkpoints --
# TinyLlama-1.1B's published config.json
# (huggingface.co/TinyLlama/TinyLlama-1.1B-Chat-v1.0), model-structure keys
TINYLLAMA_HF = dict(
    architectures=["LlamaForCausalLM"], model_type="llama", vocab_size=32000,
    hidden_size=2048, intermediate_size=5632, num_hidden_layers=22,
    num_attention_heads=32, num_key_value_heads=4,
    max_position_embeddings=2048, rms_norm_eps=1e-5, rope_theta=10000.0,
    rope_scaling=None, hidden_act="silu", tie_word_embeddings=False,
    attention_bias=False, bos_token_id=1, eos_token_id=2,
    torch_dtype="bfloat16")
CKPT_AWQ_GROUP = 128
CKPT_TINYLLAMA_LAYERS = 4   # the checkpoint phase's depth (full: 22)
CKPT_TINYLLAMA_PATH = "ckpt_tinyllama"          # bf16 shards, W4A16 at load
CKPT_TINYLLAMA_AWQ_PATH = "ckpt_tinyllama_awq"  # the same weights, AWQ
CKPT_MOONLIGHT_PATH = "ckpt_moonlight"          # 2 layers, W4A16 at load
CKPT_TEXT = "Checkpoints load on the card: ünïcødé, 漢字 and 🎉."
# autoawq's pack order: nibble i of a word holds column AWQ_ORDER[i] of 8
AWQ_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)


def write_safetensors(path, tensors):
    """A minimal safetensors writer (so that the script needs no
    `safetensors` package): an 8-byte little-endian header length, the
    JSON header, then each tensor's bytes in order.  `tensors` maps a name
    to a tensor, or to (dtype, shape, make) where make() gives the tensor
    when its bytes are written, so a file may exceed the memory that holds
    its tensors."""
    import struct
    import torch
    names = {torch.bfloat16: "BF16", torch.float16: "F16",
             torch.float32: "F32", torch.int32: "I32", torch.int64: "I64",
             torch.int8: "I8", torch.uint8: "U8", torch.bool: "BOOL"}
    specs = []
    for name, v in tensors.items():
        if isinstance(v, tuple):
            dt, shape, make = v
        else:
            dt, shape, make = v.dtype, tuple(v.shape), (lambda v=v: v)
        specs.append((name, dt, [int(d) for d in shape], make))
    header, off = {}, 0
    for name, dt, shape, _ in specs:
        n = math.prod(shape) * dt.itemsize
        header[name] = {"dtype": names[dt], "shape": shape,
                        "data_offsets": [off, off + n]}
        off += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name, dt, shape, make in specs:
            t = make().detach().to("cpu").contiguous()
            assert t.dtype == dt and list(t.shape) == shape, \
                (name, t.dtype, tuple(t.shape))
            f.write(t.reshape(-1).view(torch.uint8).numpy().data)


class ByteTokenizer:
    """A byte-level tokenizer object for random-weight checkpoints: ids 0-2
    are <unk>, <s> and </s>, ids 3-258 the bytes 0-255 (a multi-byte
    character spans several ids), and every other id below `vocab_size`
    decodes to the word " t<id>"."""

    SPECIAL = ("<unk>", "<s>", "</s>")
    bos_token_id = 1
    eos_token_id = 2

    def __init__(self, vocab_size):
        self.vocab_size = vocab_size

    def encode(self, text):
        return [self.bos_token_id] + [b + 3 for b in text.encode("utf-8")]

    def decode(self, ids, skip_special_tokens=True):
        out = bytearray()
        for i in ids:
            i = int(i)
            if not 0 <= i < self.vocab_size:
                raise ValueError(f"token id {i} outside the vocabulary")
            if i < 3:
                if not skip_special_tokens:
                    out += self.SPECIAL[i].encode()
            elif i < 259:
                out.append(i - 3)
            else:
                out += f" t{i}".encode()
        return out.decode("utf-8", errors="replace")


def ckpt_specs(hf):
    """[(name, shape, kind)] of an HF Llama or DeepSeek V3 checkpoint of
    config `hf`, as transformers saves one (linears [out, in]); kind is
    "embed", "linear", "norm" or "score_bias"."""
    H, V, L = hf["hidden_size"], hf["vocab_size"], hf["num_hidden_layers"]
    nh = hf["num_attention_heads"]
    nkv = hf.get("num_key_value_heads") or nh
    E = hf.get("n_routed_experts") or 0
    out = [("model.embed_tokens.weight", (V, H), "embed")]

    def mlp(pre, inter):
        return [(pre + "gate_proj.weight", (inter, H), "linear"),
                (pre + "up_proj.weight", (inter, H), "linear"),
                (pre + "down_proj.weight", (H, inter), "linear")]

    for i in range(L):
        p = f"model.layers.{i}."
        a = p + "self_attn."
        out += [(p + "input_layernorm.weight", (H,), "norm"),
                (p + "post_attention_layernorm.weight", (H,), "norm")]
        if hf.get("kv_lora_rank"):
            Lr, R = hf["kv_lora_rank"], hf["qk_rope_head_dim"]
            N, Vd, Q = (hf["qk_nope_head_dim"], hf["v_head_dim"],
                        hf.get("q_lora_rank"))
            if Q is None:
                out.append((a + "q_proj.weight", (nh * (N + R), H), "linear"))
            else:
                out += [(a + "q_a_proj.weight", (Q, H), "linear"),
                        (a + "q_a_layernorm.weight", (Q,), "norm"),
                        (a + "q_b_proj.weight", (nh * (N + R), Q), "linear")]
            out += [(a + "kv_a_proj_with_mqa.weight", (Lr + R, H), "linear"),
                    (a + "kv_a_layernorm.weight", (Lr,), "norm"),
                    (a + "kv_b_proj.weight", (nh * (N + Vd), Lr), "linear"),
                    (a + "o_proj.weight", (H, nh * Vd), "linear")]
        else:
            D = hf.get("head_dim") or H // nh
            out += [(a + "q_proj.weight", (nh * D, H), "linear"),
                    (a + "k_proj.weight", (nkv * D, H), "linear"),
                    (a + "v_proj.weight", (nkv * D, H), "linear"),
                    (a + "o_proj.weight", (H, nh * D), "linear")]
        if E == 0 or i < (hf.get("first_k_dense_replace") or 0):
            out += mlp(p + "mlp.", hf["intermediate_size"])
            continue
        Im = hf["moe_intermediate_size"]
        out += [(p + "mlp.gate.weight", (E, H), "linear"),
                (p + "mlp.gate.e_score_correction_bias", (E,), "score_bias")]
        for j in range(E):
            out += mlp(p + f"mlp.experts.{j}.", Im)
        if hf.get("n_shared_experts"):
            out += mlp(p + "mlp.shared_experts.",
                       Im * hf["n_shared_experts"])
    out += [("model.norm.weight", (H,), "norm"),
            ("lm_head.weight", (V, H), "linear")]
    return out


def _awq_words(u):
    """[R, C] values in [0, 15] -> int32 [R, C/8], nibble i holding column
    AWQ_ORDER[i] of each 8-column block (the top nibble as a signed value,
    so that no product leaves int32)."""
    import torch
    u = u.to(torch.int32)
    out = torch.zeros((u.shape[0], u.shape[1] // 8), dtype=torch.int32,
                      device=u.device)
    for i, m in enumerate(AWQ_ORDER):
        v = u[:, m::8]
        if i == 7:
            v = v - 16 * (v >= 8).to(torch.int32)
        out |= v * (1 << (4 * i))
    return out


def write_checkpoint(path, hf, seed, awq_group=0, shards=2):
    """An HF checkpoint directory: config.json and `shards` safetensors
    files of bf16 weights drawn on the card from a `torch.Generator` seeded
    per tensor (std 0.5/sqrt(in) for linears, 0.02 for the embedding,
    1 + N(0, 0.02^2) for norms), in HF's names and layouts.  With
    `awq_group`, every decoder linear is instead quantized (asymmetric,
    that group; the port's `quantize_w4`) and stored AWQ-packed
    (qweight/qzeros int32, scales fp16) under an AWQ quantization_config:
    the same weights, pre-quantized.  Returns the bytes written."""
    import torch
    from tensorrt_llm_tpu_torch.quantization import quantize_w4
    os.makedirs(path, exist_ok=True)

    def draw(i, shape, kind):
        g = torch.Generator(device=DEVICE)
        g.manual_seed(seed * 1_000_003 + i)
        t = torch.randn(shape, generator=g, device=DEVICE)
        t.mul_({"embed": 0.02, "norm": 0.02, "score_bias": 0.05}.get(
            kind, 0.5 / shape[-1] ** 0.5))
        if kind == "norm":
            t.add_(1.0)
        return t.to(torch.bfloat16)

    def awq(base, shape, make):
        N, K = shape
        memo = {}

        def part(key):
            if not memo:
                q, s, z = quantize_w4(make().float().t(), awq_group,
                                      symmetric=False)
                memo.update(qweight=_awq_words(q.to(torch.int32) + 8),
                            qzeros=_awq_words(z.to(torch.int32) + 8),
                            scales=s.half())
            return memo.pop(key)

        G = awq_group
        return [(base + ".qweight", torch.int32, (K, N // 8),
                 lambda: part("qweight")),
                (base + ".qzeros", torch.int32, (K // G, N // 8),
                 lambda: part("qzeros")),
                (base + ".scales", torch.float16, (K // G, N),
                 lambda: part("scales"))]

    entries = []
    for i, (name, shape, kind) in enumerate(ckpt_specs(hf)):
        make = (lambda i=i, shape=shape, kind=kind: draw(i, shape, kind))
        if (awq_group and kind == "linear" and name.startswith("model.")
                and name.endswith("_proj.weight")):
            entries += awq(name[:-len(".weight")], shape, make)
        else:
            entries.append((name, torch.bfloat16, shape, make))
    sizes = [math.prod(sh) * dt.itemsize for _, dt, sh, _ in entries]
    total, acc, cut = sum(sizes), 0, [0]
    for k, n in enumerate(sizes):
        acc += n
        if len(cut) < shards and acc >= total * len(cut) / shards:
            cut.append(k + 1)
    cut.append(len(entries))
    for s in range(shards):
        write_safetensors(
            os.path.join(path, f"model-{s + 1:05d}-of-{shards:05d}"
                               ".safetensors"),
            {name: (dt, sh, mk) for name, dt, sh, mk in
             entries[cut[s]:cut[s + 1]]})
    cfg = dict(hf)
    if awq_group:
        cfg["quantization_config"] = {
            "quant_method": "awq", "bits": 4, "group_size": awq_group,
            "version": "gemm", "zero_point": True}
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(cfg, f)
    return total


def cut_checkpoint(src, dst, num_layers):
    """`src` with config.json cut to `num_layers` and its shards linked
    (the loader does not read the layers past them)."""
    os.makedirs(dst, exist_ok=True)
    for f in os.listdir(src):
        if f.endswith(".safetensors"):
            os.symlink(os.path.join(src, f), os.path.join(dst, f))
    with open(os.path.join(src, "config.json")) as f:
        cfg = json.load(f)
    cfg["num_hidden_layers"] = num_layers
    with open(os.path.join(dst, "config.json"), "w") as f:
        json.dump(cfg, f)
    return dst


class PeakRss:
    """Peak resident set size of this process while the block runs,
    sampled every 5 ms from /proc/self/statm by a thread (a process may
    not be let reset the kernel's own peak mark)."""

    def __enter__(self):
        import threading
        self.page = os.sysconf("SC_PAGE_SIZE")
        self.peak = self._rss()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._poll, daemon=True)
        self._thread.start()
        return self

    def _rss(self):
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * self.page

    def _poll(self):
        while not self._stop.wait(0.005):
            self.peak = max(self.peak, self._rss())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self._rss())

    @property
    def gib(self):
        return self.peak / 2 ** 30


def _ckpt_checks(phase, path, quant_kw, tok):
    """The checkpoint phase's holds on a served `LLM`: every output's text
    is `tok.decode` of its tokens; one text prompt streamed rebuilds, piece
    by piece, the tokens and text of the same prompt served whole; every
    loaded buffer (RoPE tables aside: computed, not loaded) equals, byte for
    byte, the buffer the port's `load_hf_weights` / `from_float` makes on
    the CPU from the same directory."""
    import torch
    import tensorrt_llm_tpu_torch as T
    from tensorrt_llm_tpu_torch.llmapi.hf_checkpoint import SafetensorsReader
    from tensorrt_llm_tpu_torch.llmapi.llm import resolve_model_config
    from tensorrt_llm_tpu_torch.models import get_model_class

    def check(llm, prompts, outs):
        assert llm.executor.eos_token_id == tok.eos_token_id
        for o in outs:
            assert o.outputs[0].text == tok.decode(o.outputs[0].token_ids)
        sp = T.SamplingParams(max_tokens=24, temperature=0.0,
                              ignore_eos=True)
        whole = llm.generate(CKPT_TEXT, sp, cache_salt="whole")[0]
        pieces = list(llm.generate_async(CKPT_TEXT, sp, streaming=True,
                                         cache_salt="streamed"))
        assert whole.prompt == CKPT_TEXT
        assert whole.prompt_token_ids == tok.encode(CKPT_TEXT)
        assert pieces[-1].finished and not any(p.finished
                                               for p in pieces[:-1])
        prev = []
        for pc in pieces:
            ids = pc.outputs[0].token_ids
            assert ids[:len(prev)] == prev, "streamed tokens not a prefix"
            prev = ids
        last = pieces[-1].outputs[0]
        assert last.token_ids == whole.outputs[0].token_ids
        assert last.text == whole.outputs[0].text == tok.decode(
            last.token_ids)
        cfg, _ = resolve_model_config(T.LlmArgs(model=path, **quant_kw))
        cfg.max_position = llm.model_config.max_position
        with SafetensorsReader(path) as reader:
            ref = get_model_class(cfg.architecture)(cfg, "cpu") \
                .load_hf_weights(reader).state()
        got = llm.model.state()
        assert sorted(got) == sorted(ref)

        def raw(t):
            return t.contiguous().reshape(-1).view(torch.uint8)

        loaded = [k for k in ref if not k.startswith("rope_")]
        diff = [k for k in loaded if not torch.equal(raw(got[k].cpu()),
                                                     raw(ref[k]))]
        PHASES[phase + "_checks"] = {
            "texts_equal_decode": len(outs), "streamed_pieces": len(pieces),
            "buffers_compared": len(loaded),
            "buffers_differing_from_cpu": diff,
            "bytes_compared": sum(ref[k].numel() * ref[k].element_size()
                                  for k in loaded)}
        log(json.dumps({"phase": phase, **PHASES[phase + "_checks"]}))
        assert not diff, f"card and CPU loads differ: {diff[:8]}"

    return check


def checkpoint_phase(card, by_path):
    """`LLM(model=<HF checkpoint dir>)` on the card, from checkpoints this
    script writes (into a temporary directory, removed at the end):
    TinyLlama-1.1B at full width, `CKPT_TINYLLAMA_LAYERS` deep, in two bf16
    shards, loaded with W4A16 group 128 at load; the same weights AWQ-packed with zeros, loaded
    as pre-quantized; Moonlight-16B-A3B widths at 2 layers (layer 0 dense,
    layer 1 64 experts top-6 and 2 shared), W4A16 at load.  Each is served
    with the serve mix and a `ByteTokenizer` object (`serve_model`, with
    its launch counts, build seconds, peak device memory and peak host
    RSS), and held by `_ckpt_checks`.  The TinyLlama directories are also
    cross-checked against a CPU run of the same directory cut to 2 layers
    (`cross_check_cpu`).  Moonlight's is not: its load is held byte for
    byte to the CPU's, so a cross-check of it would compare the kernels
    with their plain versions at Moonlight widths, which `deepseek_cross`
    does; on these weights it forced 7 near-tie routings against
    `ROUTE_MAX_FORCED` 6 (gaps below twice a router score noise of
    0.0015-0.003)."""
    import shutil
    import tempfile
    import torch
    from tensorrt_llm_tpu_torch.llmapi.llm import resolve_model_config
    from tensorrt_llm_tpu_torch.models import MOONLIGHT_16B_A3B
    import tensorrt_llm_tpu_torch as T
    root = tempfile.mkdtemp(prefix="tllm_ckpt_")
    t_all = time.perf_counter()
    try:
        moon_hf = dict(MOONLIGHT_16B_A3B["hf_config"], num_hidden_layers=2)
        n = CKPT_TINYLLAMA_LAYERS
        tiny_hf = dict(TINYLLAMA_HF, num_hidden_layers=n)
        w4 = dict(quant_algo="W4A16", quant_group_size=128)
        gqa = ("w4a16_gemm", "flash_prefill", "paged_decode")
        runs = [
            (CKPT_TINYLLAMA_PATH, "tinyllama", tiny_hf, 0, w4,
             f"tinyllama-1.1b checkpoint ({n} layers, bf16), W4A16 at load",
             dict(required=gqa), True),
            (CKPT_TINYLLAMA_AWQ_PATH, "tinyllama_awq", tiny_hf,
             CKPT_AWQ_GROUP, {},
             f"tinyllama-1.1b checkpoint ({n} layers), AWQ g128 with zeros",
             dict(required=gqa), True),
            (CKPT_MOONLIGHT_PATH, "moonlight", moon_hf, 0, w4,
             "moonlight-16b-a3b widths checkpoint (2 layers), W4A16 at "
             "load",
             dict(required=("w4a16_gemm", "moe_gmm", "moe_gmm_units",
                            "mla_prefill", "mla_decode", "w4a16_kpaired"),
                  absent=("flash_prefill", "paged_decode", "dsa_score"),
                  kpaired_per_layer=1), False)]
        for phase, sub, hf, awq, quant_kw, label, kw, cross in runs:
            path = os.path.join(root, sub)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            nbytes = write_checkpoint(path, hf, seed=11 if awq or
                                      sub == "tinyllama" else 12,
                                      awq_group=awq)
            write_s = time.perf_counter() - t0
            log(f"[{phase}] wrote {nbytes / 2 ** 30:.2f} GiB in "
                f"{write_s:.1f} s")
            tok = ByteTokenizer(hf["vocab_size"])
            by_path[phase] = serve_model(
                card, phase, label, path,
                llm_kw=dict(quant_kw, tokenizer=tok,
                            skip_tokenizer_init=False),
                check=_ckpt_checks(phase, path, quant_kw, tok), **kw)
            PHASES[phase].update(checkpoint_gib=nbytes / 2 ** 30,
                                 write_s=write_s)
            if cross:
                cut = cut_checkpoint(path, path + "_2layers", 2)
                cfg, _ = resolve_model_config(T.LlmArgs(model=cut,
                                                        **quant_kw))
                cross_check_cpu(phase + "_cross_check",
                                f"{label}, cut to 2 layers", cfg, seed=8,
                                n_prompt=100, chunk=64, n_decode=6, path=cut)
            for d in (path, path + "_2layers"):
                shutil.rmtree(d, ignore_errors=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    PHASES["checkpoint_seconds"] = time.perf_counter() - t_all
    log(f"[checkpoint] phase took {PHASES['checkpoint_seconds']:.1f} s "
        f"({card})")


# ------------------------------------------------------- phase 18: bench --
BENCH_PRESETS = ("tinyllama-1.1b", "llama-3-8b", "llama-2-7b", "gpt-oss-20b")
# depth of the presets whose model is served at full depth by another
# phase (`sampling` and `openai`: Llama-3-8B; `serve`: TinyLlama; `gptoss`:
# GPT-OSS-20B) or whose widths are Llama-3-8B's (Llama-2-7B): the bench
# phase keeps their widths and the mix, and the script its time limit
BENCH_LAYERS = {"llama-3-8b": 4, "llama-2-7b": 4, "tinyllama-1.1b": 8,
                "gpt-oss-20b": 8}
BENCH_OVERLAP_OFF = ("tinyllama-1.1b", "gpt-oss-20b")
BENCH_ISL = 128
BENCH_OSL = 128
BENCH_REQUESTS = 32
BENCH_CONCURRENCY = 32
BENCH_BATCH = 32
BENCH_SEQ_LEN = 512
BENCH_GREEDY = 8           # greedy prompts of the overlap on/off comparison
BENCH_GREEDY_TOKENS = 64
BENCH_TIE = 0.02           # logprob gap accepted at a greedy near-tie
BENCH_LATENCY_REQUESTS = 4
BENCH_SHORT_OSL = 32       # output tokens of the latency and failure runs
# the prefill chunks partial tail-block reuse gives the bench's runs (the
# warmup seals each prompt's 8 blocks; the run reuses 7 and 15 tokens of
# the 8th and computes the last token) and the serve phases' shared-prefix
# prompts (12 tokens of block 18 reused, 20 or 45 computed)
BENCH_PREFILL_CASES = [
    # the warmup's 128-token prompts at Llama-2-7B's group of 1
    ("llama-2-7b", 32, 32, 128, 128, 0, None, None, False),
    ("tinyllama", 32, 4, 64, 1, 127, None, None, False),
    ("llama-2-7b", 32, 32, 128, 1, 127, None, None, False),
    ("llama-3-8b", 32, 8, 128, 1, 127, None, None, False),
    ("gpt-oss-20b", 64, 8, 64, 1, 127, 128, None, True),
    ("tinyllama", 32, 4, 64, 20, 300, None, None, False),
    ("gpt-oss-20b", 64, 8, 64, 45, 300, 128, None, True),
]


def bench_path(preset, overlap=True):
    return f"bench_{preset}" + ("" if overlap else "_sync")


def bench_llm(preset, overlap=True):
    """The preset as `trtllm-torch-bench --model <preset> --quant W4A16`
    builds it (random weights, group 64 for GPT-OSS), at the phase's
    batch and sequence length and the depth of `BENCH_LAYERS`; KV pool
    from free memory, native bookkeeping, the default warmup."""
    import dataclasses
    import tensorrt_llm_tpu_torch as T
    from tensorrt_llm_tpu_torch.commands import bench
    kw = dict(device=DEVICE, quant_algo="W4A16", max_batch_size=BENCH_BATCH,
              max_seq_len=BENCH_SEQ_LEN, seed=0, skip_tokenizer_init=True,
              disable_overlap_scheduler=not overlap)
    model = bench.preset_model(preset, kw)
    n = BENCH_LAYERS.get(preset)
    if n:
        model = dataclasses.replace(
            model, num_layers=n, layer_types=(
                model.layer_types[:n] if model.layer_types else None))
    return T.LLM(model=model, **kw)


class SyncChecked:
    """Times the engine's dispatch half (`ModelEngine.dispatch_decode`:
    inputs, uploads, the k steps, the copy to the host, the event) and,
    while `check` is set, runs it under
    ``torch.cuda.set_sync_debug_mode("error")``: any host sync in it
    raises, which ends the executor loop and fails every request.  Wraps
    the engine's function; the package has no switch for it."""

    def __init__(self, engine, check=True):
        import torch
        self.engine, self.real = engine, engine.dispatch_decode
        self.check = check
        self.seconds = []          # host time of each dispatch half
        self.checked = 0           # halves run under the check
        torch.cuda.synchronize()

        def dispatch(*a, **kw):
            check = self.check
            if check:
                torch.cuda.set_sync_debug_mode("error")
            t0 = time.perf_counter()
            try:
                return self.real(*a, **kw)
            finally:
                self.seconds.append(time.perf_counter() - t0)
                if check:
                    self.checked += 1
                    torch.cuda.set_sync_debug_mode("default")

        engine.dispatch_decode = dispatch

    def close(self):
        # drop the instance attribute: the class's method shows through
        # again, and no bound method of the engine is left on the engine
        # (a reference cycle would keep its KV pools until a collection)
        del self.engine.dispatch_decode
        self.engine = self.real = None


def bench_greedy(llm, prompts):
    """`BENCH_GREEDY` greedy requests plus one seeded sampled request:
    (greedy tokens, their logprobs, the sampled request's tokens)."""
    import tensorrt_llm_tpu_torch as T
    sp = T.SamplingParams(max_tokens=BENCH_GREEDY_TOKENS, temperature=0.0,
                          ignore_eos=True, logprobs=1)
    seeded = T.SamplingParams(max_tokens=BENCH_GREEDY_TOKENS,
                              temperature=0.8, top_k=20, top_p=0.9, seed=7,
                              ignore_eos=True)
    outs = llm.generate(prompts[:BENCH_GREEDY + 1],
                        [sp] * BENCH_GREEDY + [seeded])
    toks = [o.outputs[0].token_ids for o in outs]
    lps = [[lp for d in o.outputs[0].logprobs for lp in d.values()]
           for o in outs[:BENCH_GREEDY]]
    assert all(len(t) == BENCH_GREEDY_TOKENS for t in toks), toks
    return toks[:BENCH_GREEDY], lps, toks[-1]


def bench_timed(llm, reqs, cfg, n_kpaired, checked):
    """One timed `run_throughput` (no warmup): the launch counters reset
    just before it and read just after, launches asserted per layer per
    forward.  The report gains the run's host ms per dispatch half (from
    `checked`) and per decode iteration (the executor's step time).
    Returns (report, counts)."""
    import numpy as np
    import torch
    from tensorrt_llm_tpu_torch.commands import bench
    from tensorrt_llm_tpu_torch.ops import cuda_build
    torch.cuda.synchronize()
    n0 = len(checked.seconds)
    it0 = llm.executor.iteration
    cuda_build.reset_launch_counts()
    cpu0 = time.process_time()
    rep = bench.run_throughput(llm, reqs, BENCH_CONCURRENCY, warmup=False)
    torch.cuda.synchronize()
    # this process's CPU seconds (all threads) beside the run's wall
    # seconds, and the machine's load: a host that slows while its CPU
    # seconds hold is shared, not busier
    rep["process_cpu_s"] = time.process_time() - cpu0
    rep["loadavg_1m"] = os.getloadavg()[0]
    counts = dict(cuda_build.launch_counts)
    stats = [s for s in llm.get_stats() if s["iteration"] > it0]
    assert rep["num_failed"] == 0, rep["errors"]
    assert rep["output_tokens"] == BENCH_REQUESTS * BENCH_OSL, rep
    assert llm.executor._error is None
    required = ["w4a16_gemm", "flash_prefill", "paged_decode"]
    if cfg.num_experts:
        required += ["moe_gmm", "moe_gmm_units", "w4a16_kpaired"]
    chunks, dsteps, fwd, _, _ = assert_launches(
        cfg, counts, stats, required, n_kpaired=n_kpaired,
        kpaired_per_layer=1 if cfg.num_experts else 0)
    rep["prefill_chunks"], rep["decode_steps"] = chunks, dsteps
    rep["decode_chunks"] = sum(1 for s in stats if s["decode_steps"])
    rep["max_inflight_chunks"] = max(s["inflight_chunks"] for s in stats)
    rep["gemm_launches_per_forward"] = sum(
        counts.get(k, 0) for k in ("w4a16_gemm", "w4a16_gemv",
                                   "w4a16_kpaired")) / fwd
    halves = checked.seconds[n0:]
    assert len(halves) == rep["decode_chunks"], (len(halves), rep)
    rep["dispatch_half_ms_mean"] = 1e3 * float(np.mean(halves))
    rep["decode_iteration_ms_mean"] = float(np.mean(
        [s["step_time_ms"] for s in stats if s["decode_steps"]]))
    rep["prefill_iteration_ms_mean"] = float(np.mean(
        [s["step_time_ms"] for s in stats
         if s["num_prefill_chunks"] and not s["decode_steps"]] or [0.0]))
    return rep, counts


def bench_setup(preset, modes, llms, checked):
    """One `LLM` of the preset a setting of `modes` (True: overlap on) into
    `llms`, each with its dispatch halves wrapped (`SyncChecked`, into
    `checked`), and the CLI's warmup run on each (the `BENCH_CONCURRENCY`
    prompts, 8 tokens each; it seals the prompts' blocks, which the timed
    runs then reuse).  Returns (build seconds, config, K-paired linears,
    requests); `bench_teardown` releases the dicts' contents, also what a
    failed setup had built."""
    import torch
    from tensorrt_llm_tpu_torch.commands import bench
    build_s = {}
    for ov in modes:
        t0 = time.perf_counter()
        llms[ov] = bench_llm(preset, ov)
        torch.cuda.synchronize()
        build_s[ov] = time.perf_counter() - t0
        assert llms[ov].kv_manager.is_native, "KV bookkeeping not native"
        checked[ov] = SyncChecked(llms[ov].engine)
    cfg = llms[modes[0]].model_config
    _, n_kpaired = w4a16_shapes(llms[modes[0]].model)
    reqs = bench.synthetic_requests(BENCH_ISL, BENCH_OSL, BENCH_REQUESTS,
                                    cfg.vocab_size)
    for llm in llms.values():
        for f in [llm.generate_async(list(ids), bench._sampling(8))
                  for ids, _ in reqs[:BENCH_CONCURRENCY]]:
            f.result()
    return build_s, cfg, n_kpaired, reqs


def bench_teardown(llms, checked):
    import gc
    import torch
    for c in checked.values():
        c.close()
    for llm in llms.values():
        llm.shutdown()
    llms.clear()
    checked.clear()
    # the preset's LLMs are unreachable now: release their device memory
    # before the next preset sizes its KV pool from it
    gc.collect()
    torch.cuda.empty_cache()


def bench_preset(card, preset, by_path, compare=False, extra=None):
    """One preset through the bench CLI's `run_throughput`, as the CLI
    runs it: its warmup (`bench_setup`), then the timed run
    (`bench_timed`), every dispatch half under `SyncChecked`'s check
    (which costs the timed runs nothing measurable: `bench_overlap`).
    With `compare`, a second `LLM` with the overlap pipeline off is built
    beside the first, and the timed runs go off, on, on, off, so that
    neither setting always runs first; both serve the greedy and seeded
    requests (`bench_greedy`) and their greedy tokens are compared
    (`bench_compare`).  `extra(llm, requests)` runs on the overlapped
    `LLM` before shutdown.  Returns the summary."""
    import numpy as np
    import torch
    modes = (True, False) if compare else (True,)
    free_gib = torch.cuda.mem_get_info()[0] / 2 ** 30
    llms, checked = {}, {}
    try:
        build_s, cfg, n_kpaired, reqs = bench_setup(preset, modes, llms,
                                                    checked)
        runs = {ov: [] for ov in modes}
        for ov in ((False, True, True, False) if compare else (True,)):
            rep, counts = bench_timed(llms[ov], reqs, cfg, n_kpaired,
                                      checked[ov])
            runs[ov].append(rep)
            by_path.setdefault(bench_path(preset, ov), counts)
            log(f"[bench] {preset} W4A16, overlap {'on' if ov else 'off'}: "
                f"{rep['output_tokens_per_sec']} output tok/s, TTFT p50/p99 "
                f"{rep['ttft_ms']['p50']}/{rep['ttft_ms']['p99']} ms, TPOT "
                f"p50 {rep['tpot_ms']['p50']} ms, ITL p50/p99 "
                f"{rep['itl_ms']['p50']}/{rep['itl_ms']['p99']} ms; host ms "
                f"a dispatch half {rep['dispatch_half_ms_mean']:.1f} "
                f"({rep['decode_steps'] // rep['decode_chunks']} steps) "
                f"({card})")
        rng = np.random.default_rng(11)
        prompts = [[int(t) for t in rng.integers(10, cfg.vocab_size - 10,
                                                  BENCH_ISL)]
                   for _ in range(BENCH_GREEDY + 1)]
        greedy = {ov: bench_greedy(llms[ov], prompts) for ov in modes}
        if extra is not None:
            extra(llms[True], reqs)
        kv = llms[True].get_kv_cache_stats()
        dispatches = {ov: checked[ov].checked for ov in modes}
        assert all(c.checked == len(c.seconds) for c in checked.values())
    finally:
        bench_teardown(llms, checked)
    summary = {
        "phase": "bench", "preset": preset, "card": card,
        "free_gib_before_build": free_gib,
        "build_s": {str(k): v for k, v in build_s.items()},
        "runs": {("on" if ov else "off"): r for ov, r in runs.items()},
        "dispatch_halves_sync_checked": {("on" if k else "off"): v
                                         for k, v in dispatches.items()},
        "kv": kv, "seeded_sampled_tokens": greedy[True][2][:16]}
    if compare:
        summary["greedy_overlap_vs_sync"] = bench_compare(
            preset, greedy[True], greedy[False])
        mean = {ov: float(np.mean([r["output_tokens_per_sec"]
                                   for r in runs[ov]])) for ov in modes}
        summary["mean_output_tokens_per_sec"] = {"on": mean[True],
                                                 "off": mean[False]}
        log(f"[bench] {preset}: mean output tok/s overlap on "
            f"{mean[True]:.2f} / off {mean[False]:.2f} (runs off, on, on, "
            f"off; {card})")
    PHASES[bench_path(preset)] = summary
    log(json.dumps(summary))
    return summary


def bench_compare(preset, on, off):
    """Greedy tokens with overlap on equal those with it off, or first
    differ where both chosen tokens sit at a near-tie (both logprobs below
    log(1/2) + BENCH_TIE and within BENCH_TIE of each other)."""
    import math
    (ta, la, _), (tb, lb, _) = on, off
    exact, ties = 0, []
    for a, b, pa, pb in zip(ta, tb, la, lb):
        if a == b:
            exact += 1
            continue
        i = next(i for i, (u, v) in enumerate(zip(a, b)) if u != v)
        ok = (max(pa[i], pb[i]) <= math.log(0.5) + BENCH_TIE
              and abs(pa[i] - pb[i]) <= BENCH_TIE)
        ties.append({"position": i, "tokens": [a[i], b[i]],
                     "logprobs": [pa[i], pb[i]], "near_tie": ok})
    res = {"preset": preset, "exact_requests": exact, "of": len(ta),
           "first_differences": ties}
    log(json.dumps({"phase": "bench_overlap_vs_sync", **res}))
    assert all(d["near_tie"] for d in ties), ties
    return res


def bench_phase(card, gen, dev, by_path):
    """Phase 18: the four bench presets (TinyLlama-1.1B, Llama-3-8B,
    Llama-2-7B, GPT-OSS-20B) at full width and depth, W4A16, through the
    bench CLI's `run_throughput` (ISL 128, OSL 128, `ignore_eos`, 32
    requests at concurrency 32, `max_batch_size` 32) with the overlap
    pipeline on and every dispatch half under `SyncChecked`; TinyLlama
    and GPT-OSS also with it off, interleaved (`bench_preset`), greedy
    tokens compared; `run_latency` on TinyLlama with 4 requests; a
    throughput run with one failing request must end and report it.  K3
    is first held against its plain version at the prefill chunks partial
    reuse gives the bench and the serve phases."""
    from tensorrt_llm_tpu_torch.commands import bench
    t0 = time.perf_counter()
    check_prefill(gen, dev, BENCH_PREFILL_CASES)
    out = {"card": card}

    def tiny_extra(llm, reqs):
        short = [(ids, BENCH_SHORT_OSL) for ids, _ in reqs]
        lat = bench.run_latency(llm, short[:BENCH_LATENCY_REQUESTS])
        assert lat["num_requests"] == BENCH_LATENCY_REQUESTS, lat
        out["latency"] = lat
        log(f"[bench] tinyllama-1.1b latency ({BENCH_LATENCY_REQUESTS} "
            f"requests): TTFT p50 {lat['ttft_ms']['p50']} ms, TPOT p50 "
            f"{lat['tpot_ms']['p50']} ms ({card})")
        # one request longer than max_seq_len fails at submission
        bad = short[:7] + [([5] * (BENCH_SEQ_LEN + 1), BENCH_SHORT_OSL)]
        rep = bench.run_throughput(llm, bad, len(bad), warmup=False)
        assert rep["num_failed"] == 1, rep
        assert rep["num_requests"] == len(bad) - 1, rep
        out["failed_request_run"] = {k: rep[k] for k in (
            "num_requests", "num_failed", "errors", "output_tokens")}
        log(json.dumps({"phase": "bench_failed_request",
                        **out["failed_request_run"]}))

    for preset in BENCH_PRESETS:
        bench_preset(card, preset, by_path,
                     compare=preset in BENCH_OVERLAP_OFF,
                     extra=tiny_extra if preset == "tinyllama-1.1b"
                     else None)
    out["seconds"] = time.perf_counter() - t0
    PHASES["bench"] = out
    log(f"[bench] phase done in {out['seconds']:.1f} s ({card})")


# the Llama bench presets cut to 2 layers against the CPU (TinyLlama's and
# GPT-OSS's widths are phase 7's and `gptoss_cross`'s): (preset, seed)
BENCH_CROSS = (("llama-3-8b", 8), ("llama-2-7b", 9))


def bench_cross():
    """Phase 19: the Llama-3-8B and Llama-2-7B bench presets' widths
    (`MODEL_SHAPES`) at 2 layers, W4A16 g128, on the card against the
    CPU's plain versions (`cross_check_cpu`: a 200-token prompt in chunks
    of 128, then 4 decode steps)."""
    from tensorrt_llm_tpu_torch.commands import bench
    for preset, seed in BENCH_CROSS:
        t0 = time.perf_counter()
        phase = f"bench_{preset}_cross_check"
        cross_check_cpu(phase, f"{preset} bench preset, 2 layers",
                        w4a16_cfg(bench.MODEL_SHAPES[preset], num_layers=2),
                        seed=seed, n_prompt=200, chunk=128, n_decode=4)
        PHASES[phase]["seconds"] = time.perf_counter() - t0
        log(f"[bench_cross] {preset}: {PHASES[phase]['seconds']:.1f} s")


# `bench_overlap`'s timed runs, in order: the pipeline off, on, and on
# with every dispatch half under the sync check
BENCH_OVERLAP_ORDER = ("off", "on", "on+chk", "off", "on+chk", "on", "off",
                       "on")


def bench_overlap(card):
    """Opt-in: the overlap pipeline's effect and the sync check's cost at
    TinyLlama and GPT-OSS.  One `LLM` with the pipeline on and one with
    it off (`bench_setup`), then the timed `run_throughput`s of
    BENCH_OVERLAP_ORDER on them, interleaved; every dispatch half is
    timed, and only the "on+chk" runs' are checked.  Prints each run and
    each setting's range of output tok/s, TPOT p50 and host ms a dispatch
    half and a decode iteration."""
    import numpy as np
    keys = ("output_tokens_per_sec", "tpot_p50_ms", "ttft_p50_ms",
            "dispatch_half_ms_mean", "decode_iteration_ms_mean",
            "max_inflight_chunks", "wall_s", "process_cpu_s", "loadavg_1m")
    out = {"card": card, "order": BENCH_OVERLAP_ORDER}
    for preset in BENCH_OVERLAP_OFF:
        llms, checked = {}, {}
        runs = {m: [] for m in ("off", "on", "on+chk")}
        try:
            _, cfg, n_kpaired, reqs = bench_setup(preset, (True, False),
                                                  llms, checked)
            for mode in BENCH_OVERLAP_ORDER:
                ov = mode != "off"
                checked[ov].check = mode == "on+chk"
                rep, _ = bench_timed(llms[ov], reqs, cfg, n_kpaired,
                                     checked[ov])
                rep["tpot_p50_ms"] = rep["tpot_ms"]["p50"]
                rep["ttft_p50_ms"] = rep["ttft_ms"]["p50"]
                runs[mode].append({k: rep[k] for k in keys})
                log(f"[bench_overlap] {preset} {mode}: " + ", ".join(
                    f"{k} {rep[k]:.2f}" for k in keys) + f" ({card})")
        finally:
            bench_teardown(llms, checked)
        rng = {m: {k: [min(r[k] for r in rs), max(r[k] for r in rs),
                       float(np.mean([r[k] for r in rs]))] for k in keys}
               for m, rs in runs.items()}
        out[preset] = {"runs": runs, "min_max_mean": rng}
        for m in runs:
            lo, hi, mean = rng[m]["output_tokens_per_sec"]
            log(f"[bench_overlap] {preset} {m}: output tok/s {lo:.2f}-"
                f"{hi:.2f} (mean {mean:.2f}) over {len(runs[m])} runs "
                f"({card})")
    PHASES["bench_overlap"] = out
    log(json.dumps(out))


# ---------------------------------------------------------------- sampling --
SAMPLING_BATCH = 40        # the timing's 33 requests fit one batch
SAMPLING_TOKENS = 24       # new tokens of the reference and control runs
SAMPLING_PROMPT = 100      # prompt tokens of those runs
SAMPLING_TIE = 0.02        # logit gap accepted at a near-tie (test_torch_llm)
SAMPLING_LP_TOL = 1e-3     # logprobs against the plain log-softmax
SAMPLING_TIMED = 32        # plain requests of the timing runs
SAMPLING_TIMED_OSL = 64
SAMPLING_TIMED_ISL = 15    # 33 prompts in one 512-token prefill iteration
SAMPLING_REGEX = r"(yes|no), [0-9]{3}!"
SAMPLING_CHOICES = ["alpha", "beta", "gamma delta"]
SAMPLING_SCHEMA = {"type": "object",
                   "properties": {"ok": {"type": "boolean"},
                                  "c": {"enum": ["x", "y", "z"]}},
                   "required": ["ok", "c"]}


def _stop_for(tok, toks, n):
    """A stop string across the boundary of output tokens n - 2 and n - 1
    (two word tokens, so the text is ASCII) whose first match, scanning
    the text after each token as the scan worker does, completes at token
    n - 1; or None."""
    if n > len(toks) or min(toks[n - 2], toks[n - 1]) < 259:
        return None
    before, full = tok.decode(toks[:n - 1]), tok.decode(toks[:n])
    new = full[len(before):]
    for a in (3, 2):
        for b in (3, 2):
            s = before[-a:] + new[:b]
            if s not in before and s in full and all(
                    s not in tok.decode(toks[:m]) for m in range(1, n)):
                return s
    return None


def _plain_controls(raw, sp, prompt, out, eos, matcher):
    """The port's plain versions of the host logits path on the CPU, in
    f32, on one raw row: the guided mask (`matcher` advanced to `out`),
    the penalties on counts of the history, the logit controls."""
    import numpy as np
    import torch
    from tensorrt_llm_tpu_torch.runtime.sampler import (
        NEG_INF, apply_logit_controls, apply_penalties, has_penalties)
    V = raw.shape[-1]
    hist = list(prompt) + list(out)
    row = torch.from_numpy(np.array(raw, np.float32))[None]
    if matcher is not None:
        allowed = matcher.allowed_tokens()
        if allowed is not None:
            keep = torch.zeros(V, dtype=torch.bool)
            keep[torch.as_tensor(allowed, dtype=torch.int64)] = True
            row = torch.where(keep, row, row + NEG_INF)
    if has_penalties(sp):
        counts = torch.bincount(torch.tensor(hist) % V, minlength=V)
        row = apply_penalties(row, counts[None].to(torch.int32),
                              torch.tensor([sp.repetition_penalty]),
                              torch.tensor([sp.presence_penalty]),
                              torch.tensor([sp.frequency_penalty]))
    req = types.SimpleNamespace(sampling_params=sp, all_token_ids=hist,
                                num_output_tokens=len(out))
    return apply_logit_controls(row, [req], eos)[0].numpy()


def _log_softmax(row):
    import numpy as np
    row = np.asarray(row, np.float64)
    return row - (np.log(np.exp(row - row.max()).sum()) + row.max())


def _sampling_controls(llm, tok, prompts, ref):
    """Check 3-4, 6: one batch of controlled requests, each returning its
    raw rows, and a plain request that returns none; every controlled
    token is held against the port's plain controls applied on the CPU to
    its raw row."""
    import numpy as np
    import torch
    import tensorrt_llm_tpu_torch as T
    from tensorrt_llm_tpu_torch.runtime.guided_decoder import create_matcher
    V = llm.model_config.vocab_size
    seen_devices = set()

    def proc(toks, row):
        seen_devices.add(row.device.type)
        row[(toks[-1] * 7919) % row.shape[-1]] += 3.0
        return row

    G = T.GuidedDecodingParams
    cases = {
        "penalties": dict(repetition_penalty=1.3, presence_penalty=0.4,
                          frequency_penalty=0.3, logprobs=5),
        "logit_bias": dict(logit_bias={ref[1][0]: -2.0, 300: 3.0,
                                       V // 2: 2.5}),
        "bad_words": dict(bad_words=[[ref[2][0]], [ref[2][2], ref[2][3]]]),
        "min_tokens": dict(min_tokens=12, stop_token_ids=[ref[3][4]],
                           ignore_eos=False),
        "no_repeat_ngram": dict(no_repeat_ngram_size=3),
        "processor": dict(logits_processor=proc),
        "regex": dict(guided_decoding=G(regex=SAMPLING_REGEX),
                      ignore_eos=False),
        "choice": dict(guided_decoding=G(choice=SAMPLING_CHOICES),
                       ignore_eos=False),
        "json": dict(guided_decoding=G(json=SAMPLING_SCHEMA),
                     ignore_eos=False),
        "prompt_logprobs": dict(prompt_logprobs=5,
                                return_context_logits=True),
    }
    sps = [T.SamplingParams(**{**dict(
        max_tokens=SAMPLING_TOKENS, temperature=0.0, ignore_eos=True,
        return_generation_logits=True), **kw}) for kw in cases.values()]
    # one plain request rides the same host-path batch without the rows
    plain = T.SamplingParams(max_tokens=SAMPLING_TOKENS, temperature=0.0,
                             ignore_eos=True)
    outs = llm.generate(prompts[:len(cases) + 1], sps + [plain],
                        cache_salt="controls")
    assert llm.executor._error is None, llm.executor._error
    po = outs.pop().outputs[0]
    assert len(po.token_ids) == SAMPLING_TOKENS and po.finish_reason == \
        "length" and po.generation_logits is None, (po.finish_reason,
                                                   len(po.token_ids))
    assert seen_devices == {torch.device(DEVICE).type}, seen_devices
    eos = tok.eos_token_id
    res = {"tokens_checked": 0, "argmax": 0, "near_ties": 0,
           "max_logprob_err": 0.0}
    for (name, kw), sp, p, o in zip(cases.items(), sps, prompts, outs):
        c = o.outputs[0]
        toks, rows = c.token_ids, c.generation_logits
        assert rows.shape == (len(toks), V), (name, rows.shape)
        m = (create_matcher(sp.guided_decoding, tok, eos, vocab_size=V)
             if sp.guided_decoding is not None else None)
        for j, t in enumerate(toks):
            ctl = _plain_controls(rows[j], sp, p, toks[:j], eos, m)
            top = float(ctl.max())
            assert ctl[t] >= top - SAMPLING_TIE, (
                f"{name}: token {j} ({t}, {ctl[t]}) is no near-tie of the "
                f"controlled row's top {top} ({int(ctl.argmax())})")
            res["tokens_checked"] += 1
            res["argmax"] += int(ctl[t] == top)
            res["near_ties"] += int(ctl[t] != top)
            if sp.logprobs:
                lsm = _log_softmax(ctl)
                for k, v in c.logprobs[j].items():
                    err = abs(v - lsm[k])
                    res["max_logprob_err"] = max(res["max_logprob_err"], err)
                    assert err < SAMPLING_LP_TOL, (name, j, k, v, lsm[k])
                assert t in c.logprobs[j] and len(c.logprobs[j]) >= 5
            if m is not None and j + 1 < len(toks):
                assert m.advance(t), (name, j, t)
        if name == "bad_words":
            assert toks[0] != ref[2][0]
        if name == "min_tokens":
            assert ref[3][4] not in toks[:12] and eos not in toks[:12]
    by = dict(zip(cases, outs))
    # 4: prompt logprobs against the context logits, whose last row is the
    # first generation row, bit for bit
    r = by["prompt_logprobs"]
    cl, pl = r.context_logits, r.prompt_logprobs
    p = prompts[list(cases).index("prompt_logprobs")]
    assert cl.shape == (len(p), V) and len(pl) == len(p) and pl[0] is None
    assert np.array_equal(cl[-1], r.outputs[0].generation_logits[0])
    err = 0.0
    for pos in range(1, len(p)):
        lsm = _log_softmax(cl[pos - 1])
        assert p[pos] in pl[pos] and len(pl[pos]) >= 5
        err = max(err, max(abs(v - lsm[k]) for k, v in pl[pos].items()))
    assert err < SAMPLING_LP_TOL, err
    res["max_prompt_logprob_err"] = err
    # 6: guided outputs obey their constraints
    rx = by["regex"].outputs[0]
    assert re.fullmatch(SAMPLING_REGEX, rx.text), rx.text
    ch = by["choice"].outputs[0]
    assert ch.text in SAMPLING_CHOICES, ch.text
    obj = json.loads(by["json"].outputs[0].text)
    assert set(obj) == {"ok", "c"} and isinstance(obj["ok"], bool) \
        and obj["c"] in ("x", "y", "z"), obj
    assert all(by[k].outputs[0].finish_reason == "stop"
               for k in ("regex", "choice", "json"))
    res["guided_texts"] = [rx.text, ch.text, by["json"].outputs[0].text]
    return res


def _sampling_stop(llm, tok, prompts, ref, ref_text):
    """Check 2: the reference batch again under a fresh salt, one request
    with a stop string whose first match completes at output token n - 1
    (`_stop_for`): until then the batch is the reference's, so its tokens
    are the reference's cut there; once with the stop string cut from the
    text, once keeping it."""
    import tensorrt_llm_tpu_torch as T
    i, n, stop = next(((i, n, _stop_for(tok, ref[i], n))
                       for i in range(len(ref)) for n in range(4, len(ref[i]))
                       if _stop_for(tok, ref[i], n)), (None, None, None))
    assert stop is not None, "no reference text gives a stop string"
    base = dict(max_tokens=SAMPLING_TOKENS, temperature=0.0)
    res = {"request": i, "stop": stop, "match_tokens": n}
    for keep in (False, True):
        sps = [T.SamplingParams(**base)] * len(ref)
        sps[i] = T.SamplingParams(stop=stop, include_stop_str_in_output=keep,
                                  **base)
        it0 = llm.executor.iteration
        outs = llm.generate(prompts[:len(ref)], sps,
                            cache_salt=f"stop{int(keep)}")
        steps = [s["decode_steps"] for s in llm.get_stats()
                 if s["iteration"] > it0]
        assert max(steps) > 1, steps              # fused chunks
        c = outs[i].outputs[0]
        assert c.finish_reason == "stop_string", c.finish_reason
        assert c.token_ids == ref[i][:n], (c.token_ids, ref[i][:n])
        if keep:
            assert c.text == tok.decode(ref[i][:n]) and stop in c.text
        else:
            assert c.text == ref_text[i][:ref_text[i].index(stop)]
            assert stop not in c.text
        res["max_decode_steps"] = max(steps)
    return res


def _sampling_fanout(llm, prompts):
    """Check 5: n=4 at temperature 0.8 with a seed twice (fresh salts, so
    the same schedule) gives the same 4 outputs; greedy n=4 gives 4 equal
    outputs, or outputs first differing at a near-tie."""
    import tensorrt_llm_tpu_torch as T
    sp = T.SamplingParams(max_tokens=16, temperature=0.8, seed=17, n=4,
                          ignore_eos=True)
    runs = [[o.token_ids for o in llm.generate_async(
        prompts[0], sp, cache_salt=f"n{i}").result().outputs]
        for i in (1, 2)]
    assert runs[0] == runs[1], runs
    assert len({tuple(t) for t in runs[0]}) > 1, runs[0]
    g = llm.generate_async(prompts[1], T.SamplingParams(
        max_tokens=16, temperature=0.0, n=4, logprobs=2, ignore_eos=True),
        cache_salt="n3").result().outputs
    ties = []
    for o in g[1:]:
        if o.token_ids == g[0].token_ids:
            continue
        i = next(i for i, (x, y) in enumerate(zip(g[0].token_ids,
                                                  o.token_ids)) if x != y)
        d = g[0].logprobs[i]
        gap = d[g[0].token_ids[i]] - d.get(o.token_ids[i], -math.inf)
        assert gap <= SAMPLING_TIE, (i, gap)
        ties.append({"position": i, "gap": gap})
    return {"sampled_equal_across_calls": True,
            "greedy_equal": 4 - len(ties), "greedy_near_ties": ties}


def _sampling_timing(llm, card):
    """Check 8, recorded only: `SAMPLING_TIMED` plain requests against the
    same ones with one repetition-penalty request added, interleaved
    plain, mixed, mixed, plain under fresh salts.  The prompts are short
    enough that the whole batch is admitted in its first iteration, so
    the decode window (the iterations after it) compares decoding alone:
    its output tok/s over the window's summed iteration time, the mean
    decode iteration (per decode step: plain chunks take k steps, the
    mixed batch one) and the host ms of the dispatch of the one-step
    path's forward; the whole run's tok/s beside them."""
    import numpy as np
    import torch
    import tensorrt_llm_tpu_torch as T
    V = llm.model_config.vocab_size
    rng = np.random.default_rng(23)
    prompts = [[int(t) for t in rng.integers(259, V, SAMPLING_TIMED_ISL)]
               for _ in range(SAMPLING_TIMED + 1)]
    plain = T.SamplingParams(max_tokens=SAMPLING_TIMED_OSL, temperature=0.0,
                             ignore_eos=True)
    pen = T.SamplingParams(max_tokens=SAMPLING_TIMED_OSL, temperature=0.0,
                           ignore_eos=True, repetition_penalty=1.2)
    eng = llm.engine
    dispatch_s = []
    real = eng.run_decode

    def run_decode(inputs):
        t0 = time.perf_counter()
        try:
            return real(inputs)
        finally:
            dispatch_s.append(time.perf_counter() - t0)

    eng.run_decode = run_decode
    runs = {"plain": [], "mixed": []}
    try:
        for i, mode in enumerate(("plain", "mixed", "mixed", "plain")):
            # the penalty request first: it is admitted with the first
            # prefill chunks, so that it rides every decode step
            ps = ([prompts[-1]] if mode == "mixed" else []) \
                + prompts[:SAMPLING_TIMED]
            sps = ([pen] if mode == "mixed" else []) \
                + [plain] * SAMPLING_TIMED
            n0 = len(dispatch_s)
            it0 = llm.executor.iteration
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = llm.generate(ps, sps, cache_salt=f"timed{i}")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n_out = sum(len(o.outputs[0].token_ids) for o in outs)
            run = [s for s in llm.get_stats() if s["iteration"] > it0]
            st = [s for s in run if s["decode_steps"]]
            per_step = float(np.mean([s["step_time_ms"] / s["decode_steps"]
                                      for s in st]))
            pf = [j for j, s in enumerate(run) if s["num_prefill_chunks"]]
            # one token a request comes from its prefill; the rest from the
            # window, once every request is in
            window_s = sum(s["step_time_ms"] for s in run[pf[-1] + 1:]) / 1e3
            window_tokens = n_out - len(ps)
            row = {"output_tokens": n_out, "wall_s": wall,
                   "output_tokens_per_sec": n_out / wall,
                   "prefill_iterations": len(pf),
                   "decode_window_s": window_s,
                   "decode_window_tokens_per_sec": (
                       window_tokens / window_s if len(pf) == 1 else None),
                   "decode_iterations": len(st),
                   "decode_steps_max": max(s["decode_steps"] for s in st),
                   "one_step_iterations": sum(s["decode_steps"] == 1
                                              for s in st),
                   "decode_ms_per_step": per_step,
                   "host_path_dispatch_ms": (1e3 * float(np.mean(
                       dispatch_s[n0:])) if len(dispatch_s) > n0
                       else None)}
            runs[mode].append(row)
            log(f"[sampling] timing {mode}: "
                f"{row['decode_window_tokens_per_sec']} output tok/s in the "
                f"decode window ({row['prefill_iterations']} prefill "
                f"iterations), {row['output_tokens_per_sec']:.2f} over the "
                f"run, {row['decode_ms_per_step']:.2f} ms a decode "
                f"step ({row['decode_steps_max']} steps a chunk at most), "
                f"{len(st)} decode iterations, {row['one_step_iterations']} "
                f"of one step ({card})")
    finally:
        del eng.run_decode
    assert all(r["decode_steps_max"] > 1 for r in runs["plain"])
    assert all(r["one_step_iterations"] > 0 for r in runs["mixed"])
    return runs


def sampling_phase(card, by_path):
    """Phase 20: the host logits path on Llama-3-8B W4A16 at full width
    and depth (random weights, `ByteTokenizer`): the reference batch; stop
    strings in fused chunks; penalties, logit controls, a processor and
    guided regex/choice/JSON held token by token against the port's plain
    controls on the card's own raw rows; logprobs and prompt logprobs
    against the plain log-softmax; parallel sampling; the launches of
    K1/K2 and K3/K4 per layer per forward; the timing of a batch with one
    penalty request.  Then the batched logits processor on TinyLlama-1.1B
    at full depth."""
    import gc
    import numpy as np
    import torch
    import tensorrt_llm_tpu_torch as T
    from tensorrt_llm_tpu_torch.ops import cuda_build
    t_all = time.perf_counter()
    V = LLAMA3_8B["vocab_size"]
    tok = ByteTokenizer(V)
    out = {"phase": "sampling", "card": card}
    t0 = time.perf_counter()
    llm = T.LLM(model=w4a16_cfg(LLAMA3_8B), tokenizer=tok, device=DEVICE,
                max_batch_size=SAMPLING_BATCH, max_num_tokens=512,
                max_seq_len=512, kv_block_size=16, kv_num_blocks=2048,
                seed=0)
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t0
    try:
        cfg = llm.model_config
        _, n_kpaired = w4a16_shapes(llm.model)
        rng = np.random.default_rng(19)
        prompts = [[int(t) for t in rng.integers(259, V, SAMPLING_PROMPT)]
                   for _ in range(11)]
        it0 = llm.executor.iteration
        cuda_build.reset_launch_counts()
        t0 = time.perf_counter()
        # 1: the reference batch
        refs = llm.generate(prompts[:8], T.SamplingParams(
            max_tokens=SAMPLING_TOKENS, temperature=0.0), cache_salt="ref")
        ref = [o.outputs[0].token_ids for o in refs]
        ref_text = [o.outputs[0].text for o in refs]
        assert all(t == tok.decode(r) for t, r in zip(ref_text, ref))
        out["stop"] = _sampling_stop(llm, tok, prompts, ref, ref_text)
        out["controls"] = _sampling_controls(llm, tok, prompts, ref)
        out["fanout"] = _sampling_fanout(llm, prompts)
        torch.cuda.synchronize()
        out["checks_s"] = time.perf_counter() - t0
        counts = dict(cuda_build.launch_counts)
        stats = [s for s in llm.get_stats() if s["iteration"] > it0]
        chunks, dsteps, fwd, _, _ = assert_launches(
            cfg, counts, stats, ("flash_prefill", "paged_decode"),
            n_kpaired=n_kpaired)
        assert counts.get("w4a16_gemm", 0) + counts.get("w4a16_gemv", 0) \
            > 0, counts
        by_path["sampling"] = counts
        out.update(launches=counts, prefill_chunks=chunks,
                   decode_steps=dsteps, forwards=fwd)
        log(f"[sampling] checks passed in {out['checks_s']:.1f} s: "
            f"{json.dumps({k: out[k] for k in ('stop', 'controls')})}")
        out["timing"] = _sampling_timing(llm, card)
    finally:
        llm.shutdown()
        del llm
        gc.collect()
        torch.cuda.empty_cache()
    out["batched_processor"] = _sampling_batched(card)
    out["seconds"] = time.perf_counter() - t_all
    PHASES["sampling"] = out
    log(json.dumps(out))
    log(f"[sampling] phase took {out['seconds']:.1f} s ({card})")


def _sampling_batched(card):
    """Check 7: `batched_logits_processor` on TinyLlama-1.1B at full depth
    forces token (len(tokens) * 31) % V in every row of every step; it
    gets the batch's logits as a tensor on the card."""
    import gc
    import numpy as np
    import torch
    import tensorrt_llm_tpu_torch as T
    from tensorrt_llm_tpu_torch.ops import cuda_build
    V = TINYLLAMA["vocab_size"]
    seen = {"calls": 0, "batch": 0, "devices": set()}

    def proc(ids, token_lists, logits):
        seen["calls"] += 1
        seen["batch"] = max(seen["batch"], len(ids))
        seen["devices"].add(logits.device.type)
        want = torch.tensor([len(t) * 31 % V for t in token_lists],
                            device=logits.device)
        logits[torch.arange(len(ids), device=logits.device), want] += 1e4
        return logits

    llm = T.LLM(model=w4a16_cfg(TINYLLAMA), device=DEVICE, max_batch_size=8,
                max_seq_len=512, kv_block_size=16, kv_num_blocks=512,
                skip_tokenizer_init=True, seed=0,
                batched_logits_processor=proc)
    try:
        rng = np.random.default_rng(29)
        prompts = [[int(t) for t in rng.integers(10, V - 10, n)]
                   for n in (17, 64, 130, 200)]
        it0 = llm.executor.iteration
        cuda_build.reset_launch_counts()
        outs = llm.generate(prompts, T.SamplingParams(
            max_tokens=8, temperature=0.0, ignore_eos=True))
        counts = dict(cuda_build.launch_counts)
        stats = [s for s in llm.get_stats() if s["iteration"] > it0]
        for p, o in zip(prompts, outs):
            assert o.outputs[0].token_ids == [(len(p) + i) * 31 % V
                                              for i in range(8)]
        _, n_kpaired = w4a16_shapes(llm.model)
        assert_launches(llm.model_config, counts, stats,
                        ("flash_prefill", "paged_decode"),
                        n_kpaired=n_kpaired)
        assert max(s["decode_steps"] for s in stats) == 1
    finally:
        llm.shutdown()
        del llm
        gc.collect()
        torch.cuda.empty_cache()
    assert seen["devices"] == {torch.device(DEVICE).type} \
        and seen["batch"] == 4, seen
    res = {"calls": seen["calls"], "max_batch": seen["batch"],
           "launches": counts}
    log(f"[sampling] batched processor on tinyllama-1.1b: {res} ({card})")
    return res


# ----------------------------------------------------------------- summary --
# ---- phase 21: the OpenAI server -------------------------------------------
OPENAI_PATH = "openai"     # Llama-3-8B W4A16 served over HTTP: K1-K4
OPENAI_MODEL = "llama-3-8b"
OPENAI_SHORT = 12          # prompt tokens under one KV block: no reuse
OPENAI_TIMED_ORDER = ("http", "inproc", "inproc", "http")
OPENAI_TOOLS = [{"type": "function", "function": {
    "name": "get_weather", "description": "weather lookup",
    "parameters": {"type": "object",
                   "properties": {"city": {"type": "string", "maxLength": 6},
                                  "days": {"type": "integer", "minimum": 1,
                                           "maximum": 7}},
                   "required": ["city", "days"]}}}]
OPENAI_CLI_LAYERS = 2      # the CLI's TinyLlama-width checkpoint


def _http(port, method, path, body=None, timeout=600):
    """(status, body bytes) of one request to the server on 127.0.0.1."""
    import http.client
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        c.request(method, path,
                  body=None if body is None else json.dumps(body).encode(),
                  headers={"Content-Type": "application/json"})
        r = c.getresponse()
        return r.status, r.read()
    finally:
        c.close()


def _ok_json(port, method, path, body=None, status=200):
    st, raw = _http(port, method, path, body)
    assert st == status, (path, st, raw[:300])
    return json.loads(raw) if raw.startswith((b"{", b"[")) else raw


def _sse_data(raw):
    """The ``data:`` payloads of an SSE body, in order."""
    return [line[len("data: "):] for block in raw.decode().split("\n\n")
            for line in block.split("\n") if line.startswith("data: ")]


def _chain_hash(parent, chunk):
    """The KV events' chain hash of an unsalted block (FNV-1a over the
    parent hash and the block's tokens), computed here on its own."""
    h = 0xCBF29CE484222325
    for v in [parent] + [int(t) for t in chunk]:
        h = ((h ^ (v & 0xFFFFFFFFFFFFFFFF)) * 0x100000001B3) \
            & 0xFFFFFFFFFFFFFFFF
    return h


def _open_stream(port, body):
    """A raw socket with a streamed request sent and its first SSE event
    read."""
    import socket
    s = socket.create_connection(("127.0.0.1", port), timeout=120)
    data = json.dumps(body).encode()
    s.sendall(b"POST /v1/completions HTTP/1.1\r\nHost: card\r\n"
              b"Connection: close\r\n"
              b"Content-Type: application/json\r\nContent-Length: "
              + str(len(data)).encode() + b"\r\n\r\n" + data)
    got = b""
    while b"data: " not in got:
        b = s.recv(65536)
        assert b, got
        got += b
    return s


def _wait_idle(llm, free0=None, timeout=120):
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        st = llm.get_kv_cache_stats()
        if st["active_sequences"] == 0 and (
                free0 is None or st["free_blocks"] == free0):
            return st
        time.sleep(0.01)
    raise AssertionError(f"executor not idle: {llm.get_kv_cache_stats()}")


def _gemv_picked(model):
    """Whether a decode step (4 rows) of one of the model's W4A16 shapes
    dispatches K2 under its tuned tactic."""
    from tensorrt_llm_tpu_torch.autotuner import AutoTuner
    from tensorrt_llm_tpu_torch.ops.w4a16_gemm import w4a16_plan
    keys, _ = w4a16_shapes(model)
    for K, N, tiled in keys:
        t = AutoTuner.get().lookup("w4a16", (K, N, tiled)) or {}
        name, _ = w4a16_plan(4, K, N, K // 128, bool(tiled),
                             t.get("block_k"), t.get("block_m"),
                             t.get("variant"), t.get("ramp_bk0"),
                             t.get("ramp_bk_big"))
        if name == "w4a16_gemv":
            return True
    return False


def _openai_checks(llm, tok, port):
    """Every route of the server, with the checks of phase 21."""
    import numpy as np
    import torch
    import tensorrt_llm_tpu_torch as T
    V = tok.vocab_size
    rng = np.random.default_rng(31)
    out = {}

    def ids(n):
        return [int(t) for t in rng.integers(259, V, n)]

    for path in ("/health", "/v1/models", "/version",
                 "/steady_clock_offset", "/metrics", "/perf_metrics",
                 "/health_generate"):
        _ok_json(port, "GET", path)
    _ok_json(port, "POST", "/v1/embeddings", {"input": "x"}, status=400)
    m = _ok_json(port, "GET", "/v1/models")
    assert m["data"][0]["id"] == OPENAI_MODEL, m
    # greedy completion: the text llm.generate gives the same prompt
    p = ids(OPENAI_SHORT)
    body = {"model": OPENAI_MODEL, "prompt": p, "max_tokens": 32,
            "temperature": 0, "ignore_eos": True}
    r = _ok_json(port, "POST", "/v1/completions", body)
    text = r["choices"][0]["text"]
    ref = llm.generate([p], T.SamplingParams(
        max_tokens=32, temperature=0.0, ignore_eos=True))[0].outputs[0]
    assert text == ref.text and r["usage"]["completion_tokens"] == 32, \
        (text, ref.text)
    # the same request streamed: its deltas are the whole text
    st, raw = _http(port, "POST", "/v1/completions", dict(body, stream=True))
    data = _sse_data(raw)
    assert st == 200 and data[-1] == "[DONE]", raw[-300:]
    chunks = [json.loads(d)["choices"][0] for d in data[:-1]]
    assert "".join(c["text"] for c in chunks) == text
    assert chunks[-1]["finish_reason"] == "length"
    assert all(c["finish_reason"] is None for c in chunks[:-1])
    out["completion"] = {"text": text, "sse_chunks": len(chunks)}
    # chat on the fallback template, whole and streamed
    chat = {"model": OPENAI_MODEL, "max_tokens": 16, "temperature": 0,
            "ignore_eos": True,
            "messages": [{"role": "user", "content": "Hi there!"}]}
    c = _ok_json(port, "POST", "/v1/chat/completions", chat)
    assert c["choices"][0]["message"]["role"] == "assistant", c
    st, raw = _http(port, "POST", "/v1/chat/completions",
                    dict(chat, stream=True))
    data = _sse_data(raw)
    deltas = [json.loads(d)["choices"][0] for d in data[:-1]]
    assert st == 200 and data[-1] == "[DONE]"
    assert deltas[0]["delta"] == {"role": "assistant"}
    assert deltas[-1]["finish_reason"] == "length"
    # a forced tool call: guided by the tool's schema, valid JSON
    forced = dict(chat, max_tokens=64, ignore_eos=False, tools=OPENAI_TOOLS,
                  tool_choice={"type": "function",
                               "function": {"name": "get_weather"}})
    f = _ok_json(port, "POST", "/v1/chat/completions", forced)
    call = f["choices"][0]["message"]["tool_calls"][0]["function"]
    # the schema's string admits raw control bytes (the JAX grammar's)
    args = json.loads(call["arguments"], strict=False)
    assert call["name"] == "get_weather" and set(args) == {"city", "days"}
    assert 1 <= args["days"] <= 7 and len(args["city"]) <= 6, args
    assert f["choices"][0]["finish_reason"] == "tool_calls", f
    out["forced_tool_arguments"] = call["arguments"]
    resp = _ok_json(port, "POST", "/v1/responses", {
        "model": OPENAI_MODEL, "input": "Hello", "max_output_tokens": 8,
        "temperature": 0, "ignore_eos": True})
    assert resp["usage"]["output_tokens"] == 8, resp
    st, raw = _http(port, "POST", "/v1/responses", {
        "model": OPENAI_MODEL, "input": "Hello", "max_output_tokens": 8,
        "temperature": 0, "ignore_eos": True, "stream": True})
    assert st == 200 and b"response.completed" in raw, raw[-300:]
    # KV events of a shared-prefix pair (39 and 40 tokens, 2 full blocks)
    kv = _ok_json(port, "GET", "/kv_cache_events")
    since = kv["next_since_id"]
    reused0 = kv["reused_blocks"]
    a = ids(40)
    b = a[:35] + ids(4)
    for prompt in (a, b):
        _ok_json(port, "POST", "/v1/completions", {
            "model": OPENAI_MODEL, "prompt": prompt, "max_tokens": 4,
            "temperature": 0, "ignore_eos": True})
    ev = _ok_json(port, "GET", f"/kv_cache_events?since_id={since}&full=1")
    bs = ev["block_size"]
    h1 = _chain_hash(0, a[:bs])
    h2 = _chain_hash(h1, a[bs:2 * bs])
    got = [(e["id"], e["type"], e["block_hash"], e["parent_hash"])
           for e in ev["events"]]
    want = [(since + i, "stored", h, par)
            for i, (h, par) in enumerate([(h1, 0), (h2, h1)] * 2)]
    assert got == want, (got, want)
    assert ev["next_since_id"] == since + 4 and {h1, h2} <= set(
        ev["block_hashes"])
    assert ev["reused_blocks"] - reused0 == 2, ev
    pm = _ok_json(port, "POST", "/prefix_match", {"prompt_token_ids": b})
    assert pm["matched_tokens"] == 2 * bs, pm
    out["kv_events"] = {"events": len(got), "block_size": bs}
    # release and resume: the same greedy tokens before and after
    p2 = ids(OPENAI_SHORT)
    body2 = dict(body, prompt=p2, max_tokens=16)
    before = _ok_json(port, "POST", "/v1/completions", body2)
    s = _open_stream(port, dict(body2, max_tokens=200, stream=True))
    st, raw = _http(port, "POST", "/release_memory")
    assert st == 409 and b"in flight" in raw, (st, raw)
    while s.recv(65536):
        pass
    s.close()
    _wait_idle(llm)
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in llm.model.state().values())
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    _ok_json(port, "POST", "/release_memory")
    m1 = torch.cuda.memory_allocated()
    st, raw = _http(port, "POST", "/v1/completions", body2)
    assert st == 500 and b"resume_memory" in raw, (st, raw)
    _ok_json(port, "POST", "/resume_memory")
    torch.cuda.synchronize()
    m2 = torch.cuda.memory_allocated()
    after = _ok_json(port, "POST", "/v1/completions", body2)
    assert after["choices"] == before["choices"], (before, after)
    assert m0 - m1 >= 0.99 * weight_bytes, (m0, m1, weight_bytes)
    assert abs(m2 - m0) <= 0.01 * weight_bytes, (m0, m2)
    out["release"] = {"weight_bytes": weight_bytes, "allocated_before": m0,
                      "allocated_released": m1, "allocated_resumed": m2,
                      "freed_bytes": m0 - m1}
    log(f"[openai] release_memory freed {(m0 - m1) / 2 ** 30:.3f} GiB "
        f"(weights {weight_bytes / 2 ** 30:.3f} GiB; allocated "
        f"{m0 / 2 ** 30:.3f} -> {m1 / 2 ** 30:.3f} -> {m2 / 2 ** 30:.3f} "
        f"GiB); tokens equal after resume")
    # a dropped stream is cancelled and frees its blocks
    free0 = _wait_idle(llm)["free_blocks"]
    made0 = llm.executor.total_tokens_generated
    s = _open_stream(port, dict(body, prompt=ids(OPENAI_SHORT),
                                max_tokens=400, stream=True))
    s.close()
    _wait_idle(llm, free0)
    made = llm.executor.total_tokens_generated - made0
    assert made < 400, made
    out["dropped_stream_tokens"] = made
    traces = _ok_json(port, "GET", "/traces")
    assert traces and "gen_ai.latency.e2e" in traces[-1], traces[-1:]
    metrics = _ok_json(port, "GET", "/metrics").decode()
    assert "tllm_tpu_total_tokens_generated" in metrics
    return out


def _openai_requests(seed):
    """The bench mix (ISL 128, OSL 128, 32 requests) as the load
    generator draws it."""
    from tensorrt_llm_tpu_torch.commands import benchmark_serving as bs
    return bs.build_requests(types.SimpleNamespace(
        dataset=None, num_prompts=BENCH_REQUESTS, input_len=BENCH_ISL,
        output_len=BENCH_OSL, seed=seed))


def _openai_http_run(llm, port, seed):
    """One load-generator run; the executor must have made exactly the
    tokens that the client counted."""
    import asyncio
    from tensorrt_llm_tpu_torch.commands import benchmark_serving as bs
    made0 = llm.executor.total_tokens_generated
    args = types.SimpleNamespace(
        base_url=f"http://127.0.0.1:{port}", endpoint="/v1/completions",
        model=OPENAI_MODEL, dataset=None, num_prompts=BENCH_REQUESTS,
        input_len=BENCH_ISL, output_len=BENCH_OSL,
        request_rate=float("inf"), burstiness=1.0,
        max_concurrency=BENCH_CONCURRENCY, temperature=1.0, goodput=None,
        timeout=600.0, seed=seed)
    m = asyncio.run(bs.run_benchmark(args))
    assert m["completed"] == BENCH_REQUESTS and m["failed"] == 0, m
    # the client counts output_len tokens for each completed stream
    made = llm.executor.total_tokens_generated - made0
    assert made == BENCH_REQUESTS * BENCH_OSL, (made, m)
    return {"output_tok_s": m["output_token_throughput"],
            **{f"{k}_ms_{p}": m[f"{k}_ms"][p] for k in ("ttft", "tpot", "itl")
               for p in ("p50", "p99")}, "duration_s": m["duration_s"]}


def _openai_inproc_run(llm, seed):
    from tensorrt_llm_tpu_torch.commands import bench
    reqs = [(r["prompt"], r["output_len"])
            for r in _openai_requests(seed)]
    rep = bench.run_throughput(llm, reqs, BENCH_CONCURRENCY, warmup=False)
    assert rep["num_failed"] == 0 and \
        rep["output_tokens"] == BENCH_REQUESTS * BENCH_OSL, rep
    return {"output_tok_s": rep["output_tokens_per_sec"],
            **{f"{k}_ms_{p}": rep[f"{k}_ms"][p]
               for k in ("ttft", "tpot", "itl") for p in ("p50", "p99")},
            "duration_s": rep["wall_s"]}


def _openai_cli(card):
    """`python -m tensorrt_llm_tpu_torch.commands.serve` on a 2-layer
    TinyLlama-width checkpoint: /health, one token-id completion, exit 0
    on SIGINT."""
    import signal
    import socket
    import tempfile
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="tllm_cli_")
    ckpt = os.path.join(root, "ckpt")
    write_checkpoint(ckpt, dict(TINYLLAMA_HF,
                                num_hidden_layers=OPENAI_CLI_LAYERS), seed=3)
    opts = os.path.join(root, "opts.json")
    with open(opts, "w") as f:
        json.dump({"skip_tokenizer_init": True, "kv_num_blocks": 512}, f)
    with socket.socket() as so:
        so.bind(("127.0.0.1", 0))
        port = so.getsockname()[1]
    logf = open(os.path.join(root, "serve.log"), "w+")
    proc = subprocess.Popen(
        [sys.executable, "-m", "tensorrt_llm_tpu_torch.commands.serve",
         ckpt, "--quant", "W4A16", "--host", "127.0.0.1", "--port",
         str(port), "--max-seq-len", "256", "--max-batch-size", "8",
         "--served-model-name", "tinyllama-cli",
         "--extra-llm-api-options", opts],
        cwd=ROOT, stdout=logf, stderr=subprocess.STDOUT)
    try:
        while True:
            try:
                if _http(port, "GET", "/health", timeout=5)[0] == 200:
                    break
            except OSError:
                pass
            if proc.poll() is not None or time.perf_counter() - t0 > 240:
                logf.seek(0)
                raise AssertionError("trtllm-torch-serve did not come up:\n"
                                     + logf.read()[-3000:])
            time.sleep(0.25)
        up_s = time.perf_counter() - t0
        r = _ok_json(port, "POST", "/v1/completions", {
            "model": "tinyllama-cli", "prompt": [1, 450, 4996, 17354],
            "max_tokens": 8, "temperature": 0, "ignore_eos": True})
        assert r["usage"]["completion_tokens"] == 8, r
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=120)
        logf.seek(0)
        assert rc == 0, f"exit {rc}:\n" + logf.read()[-3000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        logf.close()
        subprocess.run(["rm", "-rf", root], check=False)
    out = {"up_s": up_s, "seconds": time.perf_counter() - t0}
    log(f"[openai] trtllm-torch-serve on a {OPENAI_CLI_LAYERS}-layer "
        f"TinyLlama checkpoint: up in {up_s:.1f} s, one completion, exit 0 "
        f"on SIGINT ({card})")
    return out


def openai_phase(card, by_path):
    """Phase 21: Llama-3-8B W4A16 at full width and depth (random weights,
    `ByteTokenizer`) served by the port's `OpenAIServer` on 127.0.0.1:
    every route (`_openai_checks`), then the load generator
    (`benchmark_serving`, the bench mix: ISL 128, OSL 128, 32 requests at
    concurrency 32, temperature 1, `ignore_eos`); the launch counters are
    reset after the checks, just before the first load-generator run, and
    read after it, so they count HTTP traffic only: K1, K3 and K4 asserted
    per layer per forward (K2 where the tuner picks it).  Each HTTP run
    asserts that the executor made exactly the tokens the client counted.
    The same mix then runs in process through `run_throughput`, the timed
    runs interleaved HTTP, in process, in process, HTTP.  Last the CLI in
    a subprocess (`_openai_cli`)."""
    import gc
    import torch
    import tensorrt_llm_tpu_torch as T
    from tensorrt_llm_tpu_torch.autotuner import AutoTuner
    from tensorrt_llm_tpu_torch.ops import cuda_build
    from tensorrt_llm_tpu_torch.serve.openai_server import OpenAIServer
    t_all = time.perf_counter()
    tok = ByteTokenizer(LLAMA3_8B["vocab_size"])
    out = {"phase": "openai", "card": card}
    tuned_before = set(AutoTuner.get().timings)
    t0 = time.perf_counter()
    llm = T.LLM(model=w4a16_cfg(LLAMA3_8B), tokenizer=tok, device=DEVICE,
                max_batch_size=BENCH_BATCH, max_seq_len=BENCH_SEQ_LEN,
                seed=0)
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t0
    server = None
    try:
        report_tactics(OPENAI_PATH, llm.model, tuned_before)
        cfg = llm.model_config
        _, n_kpaired = w4a16_shapes(llm.model)
        server = OpenAIServer(llm, OPENAI_MODEL).start_in_thread()
        port = server.port
        t0 = time.perf_counter()
        out["checks"] = _openai_checks(llm, tok, port)
        out["checks_s"] = time.perf_counter() - t0
        runs = {"http": [], "inproc": []}
        _wait_idle(llm)
        it0 = llm.executor.iteration
        cuda_build.reset_launch_counts()
        runs["http"].append(_openai_http_run(llm, port, seed=101))
        torch.cuda.synchronize()
        counts = dict(cuda_build.launch_counts)
        stats = [s for s in llm.get_stats() if s["iteration"] > it0]
        chunks, dsteps, fwd, _, _ = assert_launches(
            cfg, counts, stats, ("w4a16_gemm", "flash_prefill",
                                 "paged_decode"), n_kpaired=n_kpaired)
        picks_gemv = _gemv_picked(llm.model)
        if picks_gemv:
            assert counts.get("w4a16_gemv", 0) > 0, counts
        by_path[OPENAI_PATH] = counts
        out.update(launches=counts, prefill_chunks=chunks,
                   decode_steps=dsteps, forwards=fwd,
                   tuner_picks_gemv=picks_gemv)
        for i, kind in enumerate(OPENAI_TIMED_ORDER[1:], start=2):
            run = (_openai_http_run(llm, port, seed=100 + i)
                   if kind == "http"
                   else _openai_inproc_run(llm, seed=100 + i))
            runs[kind].append(run)
        out["runs"] = runs
        for kind in ("http", "inproc"):
            for r in runs[kind]:
                log(f"[openai] {kind}: {r['output_tok_s']} output tok/s, "
                    f"TTFT p50/p99 {r['ttft_ms_p50']}/{r['ttft_ms_p99']} ms, "
                    f"TPOT p50/p99 {r['tpot_ms_p50']}/{r['tpot_ms_p99']} ms, "
                    f"ITL p50/p99 {r['itl_ms_p50']}/{r['itl_ms_p99']} ms "
                    f"({card})")
    finally:
        if server is not None:
            server.stop()
        llm.shutdown()
        del llm
        gc.collect()
        torch.cuda.empty_cache()
    out["cli"] = _openai_cli(card)
    out["seconds"] = time.perf_counter() - t_all
    PHASES["openai"] = out
    log(json.dumps(out))
    log(f"[openai] phase took {out['seconds']:.1f} s ({card})")


# ------------------------------------------------------ phase 22: disagg --
DISAGG_PATH = "disagg"     # TinyLlama W4A16 disaggregated: K1-K4
DISAGG_CHUNK = 128         # each worker's prefill chunk (token budget)
DISAGG_BLOCKS = 640        # each worker's KV pool (explicit: two share a card)
DISAGG_COND_MAX = 256      # conditional mode: these prompts skip the hop
DISAGG_TIE = 0.02          # logit gap accepted at a greedy near-tie
DISAGG_MIN_FRAMES = 4      # KV frames of the 600-token prompt, at least
HOST_TIER_POOL = 32        # the host-tier LLM's device blocks: too few to
HOST_TIER_HOST = 64        # keep the 300-token prefix across two fillers
HOST_TIER_FILLER = 400     # tokens of each filler request


def _disagg_prompts(V):
    """The serve mix: 8 prompts of 17..600 tokens, two sharing a 300-token
    prefix (`serve_model`'s, from the same seed)."""
    import numpy as np
    rng = np.random.default_rng(0)

    def ids(n):
        return [int(t) for t in rng.integers(10, V - 10, n)]

    shared = ids(300)
    return [shared + ids(20), shared + ids(45)] + [
        ids(n) for n in (17, 64, 200, 333, 480, 600)]


def _near_ties(llm, prompts, want, got):
    """Requests whose tokens equal `want`, and for each other one its first
    difference, a near-tie if both tokens lie within DISAGG_TIE of the top
    of `llm`'s row there (teacher forced on `want`; a logprob gap is the
    logit gap)."""
    import tensorrt_llm_tpu_torch as T
    exact, ties = 0, []
    for p, a, b in zip(prompts, want, got):
        assert len(a) == len(b), (len(a), len(b))
        if a == b:
            exact += 1
            continue
        i = next(i for i, (u, v) in enumerate(zip(a, b)) if u != v)
        row = llm.generate([p + a[:i]], T.SamplingParams(
            max_tokens=1, temperature=0.0, logprobs=20),
            cache_salt="tie")[0].outputs[0].logprobs[0]
        top = max(row.values())
        ok = all(t in row and row[t] >= top - DISAGG_TIE
                 for t in (a[i], b[i]))
        ties.append({"position": i, "tokens": [a[i], b[i]],
                     "logprobs": [row.get(a[i]), row.get(b[i])],
                     "top": top, "near_tie": ok})
    return exact, ties


def _post_all(port, bodies):
    """The bodies POSTed to /v1/completions at once; their JSON answers."""
    import concurrent.futures as cf
    with cf.ThreadPoolExecutor(len(bodies)) as pool:
        return list(pool.map(
            lambda b: _ok_json(port, "POST", "/v1/completions", b), bodies))


def _disagg_mode(mode, front, fport, ctx, gen, prompts, want, L):
    """One mode's run of the 8 prompts through the front end, with the
    launches of each worker's executor thread counted apart."""
    import torch
    from tensorrt_llm_tpu_torch.ops import cuda_build
    front.stream_kv = mode == "stream_kv"
    front.conditional_max_prompt = (DISAGG_COND_MAX
                                    if mode == "conditional" else 0)
    bodies = [{"model": "tinyllama", "prompt": p, "prompt_token_ids": p,
               "max_tokens": 64, "temperature": 0.0, "ignore_eos": True}
              for p in prompts]
    if mode == "conditional":
        for b in bodies:
            b["logprobs"] = 0      # a plain completion's tokens, as strings
    for llm in (ctx, gen):      # each mode prefills from a cold cache
        llm.read_kv(lambda kv: kv.drop_cached_blocks())
    ic, ig = ctx.executor.iteration, gen.executor.iteration
    torch.cuda.synchronize()
    cuda_build.reset_launch_counts()
    t0 = time.perf_counter()
    outs = _post_all(fport, bodies)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    by_thread = {k: dict(v) for k, v in
                 cuda_build.launch_counts_by_thread.items()}
    total = dict(cuda_build.launch_counts)
    cc = by_thread.get(ctx.executor._thread.ident, {})
    cg = by_thread.get(gen.executor._thread.ident, {})
    sc = [x for x in ctx.get_stats() if x["iteration"] > ic]
    sg = [x for x in gen.get_stats() if x["iteration"] > ig]
    chunks_c = sum(x["num_prefill_chunks"] for x in sc)
    chunks_g = sum(x["num_prefill_chunks"] for x in sg)
    steps_c = sum(x["decode_steps"] for x in sc)
    steps_g = sum(x["decode_steps"] for x in sg)
    got = []
    for p, o in zip(prompts, outs):
        ch = o["choices"][0]
        assert ch["finish_reason"] == "length", ch
        got.append(ch["token_ids"] if "token_ids" in ch else
                   [int(t) for t in ch["logprobs"]["tokens"]])
    kv = ctx.get_kv_cache_stats()
    # the context pool holds no sequence and leaks no block
    assert kv["active_sequences"] == 0, kv
    assert kv["free_blocks"] + kv["evictable_blocks"] == \
        ctx.kv_manager.num_blocks - 1, kv
    # K3 on the context worker for every layer of every prefill chunk, no
    # decode there; K4 on the generation worker every layer of every step
    assert chunks_c > 0 and cc.get("flash_prefill", 0) == L * chunks_c, \
        (cc, chunks_c)
    assert steps_c == 0 and cc.get("paged_decode", 0) == 0, cc
    assert steps_g > 0 and cg.get("paged_decode", 0) == L * steps_g, \
        (cg, steps_g)
    assert cg.get("flash_prefill", 0) == L * chunks_g, (cg, chunks_g)
    short = [p for p in prompts if len(p) <= DISAGG_COND_MAX]
    if mode == "conditional":
        assert chunks_g > 0            # the short prompts prefill here
        assert sum(x["num_prefill_tokens"] for x in sc) <= sum(
            len(p) for p in prompts if p not in short)
    else:
        # the transferred prompts' KV was injected, not recomputed
        assert chunks_g == 0 and cg.get("flash_prefill", 0) == 0, cg
    for c in (cc, cg):
        assert c.get("w4a16_gemm", 0) + c.get("w4a16_gemv", 0) > 0, c
    exact, ties = _near_ties(gen, prompts, want, got)
    res = {"mode": mode, "wall_s": wall, "exact_requests": exact,
           "of": len(prompts), "first_differences": ties,
           "ctx_prefill_chunks": chunks_c, "gen_prefill_chunks": chunks_g,
           "gen_decode_steps": steps_g, "ctx_launches": cc,
           "gen_launches": cg, "launches": total,
           "ctx_prefill_tokens": sum(x["num_prefill_tokens"] for x in sc),
           "gen_prefill_tokens": sum(x["num_prefill_tokens"] for x in sg),
           "output_tokens_per_s": sum(len(t) for t in got) / wall}
    log(json.dumps({"phase": DISAGG_PATH, **res}))
    assert all(d["near_tie"] for d in ties), ties
    return res, total


def _disagg_overlap(front, fport, ctx, gen, prompt):
    """The 600-token prompt alone in the stream_kv mode: its KV frames
    (one a prefill chunk of DISAGG_CHUNK tokens) and the times each reaches
    the generation worker (its handler reads the frame's bytes) and is
    injected there, against the end of each of the context worker's
    prefill chunks (synchronized)."""
    import torch
    from tensorrt_llm_tpu_torch.serve import disagg_server as ds
    front.stream_kv, front.conditional_max_prompt = True, 0
    marks = {"received": [], "injected": [], "chunk_end": []}
    real_read = ds.frame_from_bytes
    inject, prefill = gen.engine.inject_kv_blocks, ctx.engine.run_prefill

    def read(data):
        marks["received"].append(time.perf_counter())
        return real_read(data)

    def timed_inject(ids, layers):
        marks["injected"].append(time.perf_counter())
        return inject(ids, layers)

    def timed_prefill(inputs):
        out = prefill(inputs)
        torch.cuda.synchronize()
        marks["chunk_end"].append(time.perf_counter())
        return out

    ctx.read_kv(lambda kv: kv.drop_cached_blocks())   # a cold prefill
    ds.frame_from_bytes = read
    gen.engine.inject_kv_blocks = timed_inject
    ctx.engine.run_prefill = timed_prefill
    try:
        out = _post_all(fport, [{
            "model": "tinyllama", "prompt_token_ids": prompt,
            "max_tokens": 8, "temperature": 0.0, "ignore_eos": True}])[0]
    finally:
        ds.frame_from_bytes = real_read
        del gen.engine.inject_kv_blocks
        del ctx.engine.run_prefill
    frames = len(marks["injected"])      # KV frames; the end frame aside
    last_chunk = max(marks["chunk_end"])
    res = {"prompt_tokens": len(prompt), "kv_frames": frames,
           "prefill_chunks": len(marks["chunk_end"]),
           "first_frame_received_ms_before_last_chunk_end":
               (last_chunk - marks["received"][0]) * 1e3,
           "first_frame_injected_ms_before_last_chunk_end":
               (last_chunk - marks["injected"][0]) * 1e3,
           "tokens": out["choices"][0]["token_ids"]}
    log(json.dumps({"phase": DISAGG_PATH + "_overlap", **res}))
    assert frames >= DISAGG_MIN_FRAMES, res
    assert marks["received"][0] < last_chunk, res
    return res


class _DictConnector:
    """A `KvCacheConnector` over a dict (save / load / contains)."""

    def __init__(self):
        self.store = {}

    def save(self, key, payload):
        self.store[key] = payload

    def load(self, key):
        return self.store.get(key)

    def contains(self, key):
        return key in self.store


def _host_tier(tier, cfg, kw, ref_llm, a_prompt, b_prompt, fillers, card):
    """A device pool of HOST_TIER_POOL blocks, with a host tier of
    HOST_TIER_HOST blocks (`tier` "host") or a dict connector and no host
    tier ("connector"): prompt A (the 300-token prefix + 20), two fillers
    that evict it, then B (the prefix + 45).  B must onboard the prefix's
    18 full blocks and prefill only its tail, with the tokens of
    `ref_llm` (a pool that keeps the prefix) on the same sequence."""
    import torch
    import tensorrt_llm_tpu_torch as T
    bs = 16
    extra = (dict(kv_host_cache_blocks=HOST_TIER_HOST) if tier == "host"
             else dict(kv_connector=_DictConnector()))
    llm = T.LLM(model=cfg, **dict(kw, kv_num_blocks=HOST_TIER_POOL), **extra)
    sp = T.SamplingParams(max_tokens=64, temperature=0.0, ignore_eos=True)
    fill = T.SamplingParams(max_tokens=8, temperature=0.0, ignore_eos=True)
    kv = llm.kv_manager
    spent = {"offload": 0.0, "onboard": 0.0}
    extract, inject = kv._extract_fn, kv._inject_fn

    def timed_extract(ids):
        t0 = time.perf_counter()
        out = extract(ids)                 # synchronous: a copy to the host
        spent["offload"] += time.perf_counter() - t0
        return out

    def timed_inject(ids, layers):
        t0 = time.perf_counter()
        inject(ids, layers)
        torch.cuda.synchronize()
        spent["onboard"] += time.perf_counter() - t0

    try:
        kv.attach_block_io(timed_extract, timed_inject)
        llm.generate([a_prompt], sp)
        for f in fillers:
            llm.generate([f], fill)
        before = llm.get_kv_cache_stats()
        it0 = llm.executor.iteration
        out = llm.generate([b_prompt], sp)[0].outputs[0].token_ids
        after = llm.get_kv_cache_stats()
        tail = sum(x["num_prefill_tokens"] for x in llm.get_stats()
                   if x["iteration"] > it0)
    finally:
        llm.shutdown()
    onboarded = after["onboarded_blocks"] - before["onboarded_blocks"]
    saved = (after["offloaded_blocks"] if tier == "host"
             else after["connector_saves"])
    ref = [ref_llm.generate([p], s, cache_salt=f"host_{tier}")
           for p, s in [(a_prompt, sp)] + [(f, fill) for f in fillers]]
    want = ref_llm.generate([b_prompt], sp, cache_salt=f"host_{tier}"
                            )[0].outputs[0].token_ids
    del ref
    exact, ties = _near_ties(ref_llm, [b_prompt], [want], [out])
    n_prefix = 300 // bs
    res = {"tier": tier, "device_blocks": HOST_TIER_POOL,
           "host_blocks": HOST_TIER_HOST if tier == "host" else 0,
           "offloaded_or_saved": saved,
           "onboarded_total": after["onboarded_blocks"],
           "onboarded_by_b": onboarded, "prefill_tokens_of_b": tail,
           "ms_per_offloaded_block": spent["offload"] * 1e3 / max(saved, 1),
           "ms_per_onboarded_block":
               spent["onboard"] * 1e3 / max(after["onboarded_blocks"], 1),
           "block_bytes": kv.num_layers * 2 * kv.num_kv_heads * bs
           * kv.head_dim * 2, "kv": after, "exact": exact,
           "first_differences": ties, "card": card}
    if tier == "connector":
        res["connector_loads"] = after["connector_loads"]
        assert after["connector_saves"] > 0 and after["connector_loads"] > 0
    log(json.dumps({"phase": DISAGG_PATH + "_" + tier, **res}))
    assert saved > 0 and after["onboarded_blocks"] > 0, res
    assert onboarded >= n_prefix, res
    assert tail == len(b_prompt) - onboarded * bs, res   # only the tail
    assert all(d["near_tie"] for d in ties), ties
    return res


def disagg_phase(card, by_path):
    """Phase 22: disaggregated serving on the card.  TinyLlama W4A16 at full
    width and depth (random weights, seed 0) as a context worker and a
    generation worker in this process, each an `LLM` with DISAGG_BLOCKS
    blocks behind an `OpenAIServer` on 127.0.0.1 that registers
    (`register_to`) with an `OpenAIDisaggServer`.  The serve mix (8 greedy
    prompts of 17..600 tokens, 64 new) goes through the front end in the
    two-phase, stream_kv and conditional modes (`_disagg_mode`): tokens
    equal the generation worker's own `generate` of the prompts (or first
    differ at a near-tie); the context pool is empty after each mode; the
    generation worker launches no K3 for a transferred prompt and K4 for
    every layer of every decode step, the context worker K3 for every layer
    of every prefill chunk.  The 600-token prompt alone sends at least
    DISAGG_MIN_FRAMES frames, the first received before the last prefill
    chunk ends (`_disagg_overlap`).  Then the host tier and the connector
    on a third and a fourth TinyLlama `LLM` (`_host_tier`)."""
    import numpy as np
    import torch
    import tensorrt_llm_tpu_torch as T
    from tensorrt_llm_tpu_torch.serve.disagg_server import OpenAIDisaggServer
    from tensorrt_llm_tpu_torch.serve.openai_server import OpenAIServer
    t_all = time.perf_counter()
    cfg = w4a16_cfg(TINYLLAMA)
    L = cfg.num_layers
    kw = dict(skip_tokenizer_init=True, device=DEVICE, max_batch_size=4,
              max_num_tokens=DISAGG_CHUNK, max_seq_len=1024,
              kv_block_size=16, kv_num_blocks=DISAGG_BLOCKS, seed=0)
    front = OpenAIDisaggServer([], [], "round_robin",
                               model_name="tinyllama", health_interval=0)
    fs = front.start_in_thread()
    furl = f"http://127.0.0.1:{fs.port}"
    t0 = time.perf_counter()
    ctx = T.LLM(model=cfg, **kw)
    gen = T.LLM(model=cfg, **kw)
    build_s = time.perf_counter() - t0
    workers = [OpenAIServer(ctx, "tinyllama", register_to=furl,
                            disagg_role="context").start_in_thread(),
               OpenAIServer(gen, "tinyllama", register_to=furl,
                            disagg_role="generation").start_in_thread()]
    summary = {"phase": DISAGG_PATH, "card": card, "build_s": build_s,
               "layers": L}
    total = {}
    try:
        assert front.ctx_pool.urls == [
            f"http://127.0.0.1:{workers[0].port}"], front.ctx_pool.urls
        assert front.gen_pool.urls == [
            f"http://127.0.0.1:{workers[1].port}"], front.gen_pool.urls
        prompts = _disagg_prompts(cfg.vocab_size)
        sp = T.SamplingParams(max_tokens=64, temperature=0.0,
                              ignore_eos=True)
        t0 = time.perf_counter()
        want = [o.outputs[0].token_ids for o in gen.generate(prompts, sp)]
        torch.cuda.synchronize()
        summary["single_instance_wall_s"] = time.perf_counter() - t0
        modes = []
        for mode in ("two_phase", "stream_kv", "conditional"):
            res, counts = _disagg_mode(mode, front, fs.port, ctx, gen,
                                       prompts, want, L)
            modes.append(res)
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
        summary["modes"] = modes
        summary["overlap"] = _disagg_overlap(front, fs.port, ctx, gen,
                                             prompts[-1])
        V = cfg.vocab_size
        rng = np.random.default_rng(1)
        fillers = [[int(t) for t in rng.integers(10, V - 10,
                                                 HOST_TIER_FILLER)]
                   for _ in range(2)]
        summary["host_tier"] = [
            _host_tier(tier, cfg, kw, gen, prompts[0], prompts[1], fillers,
                       card) for tier in ("host", "connector")]
    finally:
        for w in workers:
            w.stop()
        fs.stop()
        ctx.shutdown()
        gen.shutdown()
    assert front.ctx_pool.urls == [] and front.gen_pool.urls == []
    summary["launches"] = total
    summary["seconds"] = time.perf_counter() - t_all
    PHASES[DISAGG_PATH] = summary
    by_path[DISAGG_PATH] = total
    log(f"[disagg] phase took {summary['seconds']:.1f} s ({card})")
    del ctx, gen
    torch.cuda.empty_cache()


SERVE_PATH = "serve"                    # TinyLlama W4A16: K1-K4, K13
GPT_OSS_PATH = "serve_gpt_oss"          # GPT-OSS-20B: K1, K3-K5, K12
LLAMA3_W4A8_PATH = "serve_llama3_w4a8"  # slice 3's path: K6-K8 run there
MOONLIGHT_PATH = "serve_moonlight"      # slice 4's dense MLA path: K9/K10
V32_PATH = "serve_deepseek_v32"         # slice 4's DSA path: K11
RAMP_PATH = "serve_ramp"                # K13 under a ramp tactic file
STREAM_PATH = "serve_stream"            # K2 under a stream tactic file
FUSED_PATH = "fused_mlp"                # K14 through its op
KERNELS = {
    # each kernel's row: the serve path that runs it, and a phase-3 check
    # at the shape that path gives it
    "w4a16_gemm": ("cuda", "tensorrt_llm_tpu_torch/csrc/w4a16_gemm.cu",
                   "tensorrt_llm_tpu/ops/w4a16_gemm.py:205", GPT_OSS_PATH,
                   {"model": "gpt-oss-20b", "M": 256, "K": 2880, "N": 5120}),
    # TinyLlama down at decode, served under the stream tactic (the tuner
    # of the other paths picks per shape, K1 included)
    "w4a16_gemv": ("cuda", "tensorrt_llm_tpu_torch/csrc/w4a16_gemv.cu",
                   "tensorrt_llm_tpu/ops/w4a16_gemm.py:560", STREAM_PATH,
                   {"model": "tinyllama", "M": 4, "K": 5632, "N": 2048}),
    "flash_prefill": ("cuda",
                      "tensorrt_llm_tpu_torch/csrc/flash_prefill_sm90.cu",
                      "tensorrt_llm_tpu/ops/flash_prefill.py:282",
                      GPT_OSS_PATH,
                      {"model": "gpt-oss-20b", "T": 256, "q_offset": 128,
                       "window": 128}),
    "paged_decode": ("cuda", "tensorrt_llm_tpu_torch/csrc/paged_decode.cu",
                     "tensorrt_llm_tpu/ops/paged_attention.py:516",
                     GPT_OSS_PATH, {"model": "gpt-oss-20b", "window": 128}),
    # the D=128 bodies of K3 and K4 run in the same kernels: Llama-3-8B
    # served over HTTP
    "flash_prefill@d128": ("cuda",
                           "tensorrt_llm_tpu_torch/csrc/flash_prefill_sm90.cu",
                           "tensorrt_llm_tpu/ops/flash_prefill.py:39",
                           OPENAI_PATH,
                           {"model": "llama-3-8b", "T": 256,
                            "q_offset": 256}),
    "paged_decode@d128": ("cuda", "tensorrt_llm_tpu_torch/csrc/paged_decode.cu",
                          "tensorrt_llm_tpu/ops/paged_attention.py:40",
                          OPENAI_PATH, {"model": "llama-3-8b",
                                        "kv_lens": [320, 400, 1000, 4000]}),
    # GPT-OSS-20B gate_up at decode: 4 requests x top-4 rows
    "moe_gmm": ("cuda", "tensorrt_llm_tpu_torch/csrc/moe_gmm.cu",
                "tensorrt_llm_tpu/ops/moe_w4a16.py:78", GPT_OSS_PATH,
                {"model": "gpt-oss-20b", "M": 16, "N": 5760,
                 "routing": "uniform", "zeros": False}),
    "paged_decode_int8": ("cuda",
                          "tensorrt_llm_tpu_torch/csrc/paged_decode.cu",
                          "tensorrt_llm_tpu/ops/paged_attention.py:174",
                          LLAMA3_W4A8_PATH,
                          {"model": "llama-3-8b",
                           "kv_lens": [320, 400, 1000, 4000]}),
    "flash_prefill_int8": ("cuda",
                           "tensorrt_llm_tpu_torch/csrc/flash_prefill_sm90.cu",
                           "tensorrt_llm_tpu/ops/flash_prefill.py:157",
                           LLAMA3_W4A8_PATH,
                           {"model": "llama-3-8b", "T": 256,
                            "q_offset": 256}),
    # Llama-3-8B gate_up at decode: 4 requests
    "w4a8_gemm": ("cuda", "tensorrt_llm_tpu_torch/csrc/w4a8_gemm.cu",
                  "tensorrt_llm_tpu/ops/w4a16_gemm.py:953", LLAMA3_W4A8_PATH,
                  {"model": "llama-3-8b", "M": 4, "K": 4096, "N": 28672}),
    "mla_decode": ("cuda",
                   "tensorrt_llm_tpu_torch/csrc/mla_prefill_sm90.cu",
                   "tensorrt_llm_tpu/ops/mla_pallas.py:37", MOONLIGHT_PATH,
                   {"model": "moonlight-16b-a3b"}),
    "mla_prefill": ("cuda",
                    "tensorrt_llm_tpu_torch/csrc/mla_prefill_sm90.cu",
                    "tensorrt_llm_tpu/ops/mla_pallas.py:189", MOONLIGHT_PATH,
                    {"model": "moonlight-16b-a3b", "T": 256,
                     "q_offset": 256}),
    # the serve path's scale: 4 sequences up to ~3,000 tokens
    "dsa_score": ("cuda", "tensorrt_llm_tpu_torch/csrc/dsa_score.cu",
                  "tensorrt_llm_tpu/ops/dsa.py:138", V32_PATH, {"MB": 190}),
    # GPT-OSS-20B o_proj at decode (K12 also runs kv_a on the Moonlight and
    # V3.2 paths: `launches_by_path`)
    "w4a16_kpaired": ("cuda", "tensorrt_llm_tpu_torch/csrc/w4a16_kpaired.cu",
                      "tensorrt_llm_tpu/ops/w4a16_gemm.py:54", GPT_OSS_PATH,
                      {"model": "gpt-oss-20b", "M": 4, "zeros_bias": False}),
    # TinyLlama gate_up at decode, the default two-step schedule
    "w4a16_ramp": ("cuda", "tensorrt_llm_tpu_torch/csrc/w4a16_ramp.cu",
                   "tensorrt_llm_tpu/ops/w4a16_gemm.py:371", RAMP_PATH,
                   {"model": "tinyllama", "M": 4, "N": 11264,
                    "schedule": [1, 1]}),
    # TinyLlama's MLP at decode
    "w4a16_fused_mlp": ("cuda",
                        "tensorrt_llm_tpu_torch/csrc/w4a16_fused_mlp.cu",
                        "tensorrt_llm_tpu/ops/w4a16_fused.py:90", FUSED_PATH,
                        {"model": "tinyllama", "M": 4, "zeros": False}),
}


def kernels_line(by_path):
    """`launches` is each kernel's count in its own serve path's run;
    `launches_by_path` gives every serve path's count apart.  A row named
    ``kernel@variant`` is another TPU body that the same kernel serves."""
    out = []
    for name, (route, src, replaces, path, head) in KERNELS.items():
        kernel = name.split("@")[0]
        rows = [r for r in RESULTS if r["kernel"] == kernel]
        hit = [r for r in rows
               if all(r["shape"].get(k) == v for k, v in head.items())]
        h = hit[0]
        out.append({"name": name, "route": route, "source": src,
                    "replaces": replaces, "path": path,
                    "launches": by_path[path].get(kernel, 0),
                    "launches_by_path": {p: c.get(kernel, 0)
                                         for p, c in by_path.items()},
                    "max_abs_err": max(r["max_err"] for r in rows),
                    "ms": h["kernel_ms"], "plain_ms": h["plain_ms"],
                    "bound_ms": h["bound_ms"], "bound_by": h["bound_by"],
                    "library_ms": h["library_ms"], "shape": h["shape"]})
    return {"kernels": out}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from tensorrt_llm_tpu_torch.ops import cuda_build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[phase 1] {card}")
    log(f"[phase 1] torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    os.environ.setdefault("TLLM_NVCC_VERBOSE", "1")
    cuda_build.load_library()
    PHASES["build_seconds"] = cuda_build.last_build_seconds
    log(f"[phase 2] kernels built/loaded in "
        f"{cuda_build.last_build_seconds:.1f} s")
    for line in cuda_build.last_build_log.splitlines():
        if any(w in line for w in ("registers", "spill", "error",
                                   "entry function")):
            log("  " + line.strip())
    # K2's and K4/K6's -Xptxas -v lines, from the build's kept logs (also
    # when this run loaded an existing build)
    logs = cuda_build.build_logs()
    for src in ("w4a16_gemv.cu", "paged_decode.cu"):
        for line in logs.get(src, "").splitlines():
            if any(w in line for w in ("registers", "spill", "entry")):
                log(f"  [ptxas {src}] {line.strip()}")
    # every wgmma ptxas serialized, by source (K5's and K8's checks fail
    # on their own sources' warnings)
    serialized = cuda_build.serialized_wgmma()
    PHASES["serialized_wgmma"] = serialized
    log(f"[phase 2] ptxas serialized wgmma: {json.dumps(serialized)}")

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(DEVICE, 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    args = sys.argv[1:]
    out_json = None
    if "--json" in args:
        i = args.index("--json")
        out_json = args[i + 1]
        del args[i:i + 2]
    phases = args or ["check", "serve", "serve_ramp", "serve_stream",
                      "fused_mlp", "cross",
                      "llama3", "gptoss",
                      "gptoss_cross", "llama3_w4a8", "llama3_w4a8_cross",
                      "deepseek", "deepseek_v32", "deepseek_v3_width",
                      "deepseek_cross", "checkpoint", "sampling", "openai",
                      "disagg", "bench", "bench_cross"]
    by_path = {}      # each serve path's own launch counts
    try:
        run_phases(phases, card, gen, dev, by_path)
    finally:
        if out_json:   # also after a failed phase: what ran is kept
            os.makedirs(os.path.dirname(os.path.abspath(out_json)),
                        exist_ok=True)
            with open(out_json, "w") as f:
                json.dump({"card": card, "phases": PHASES,
                           "checks": RESULTS}, f, indent=1)
    log(card)
    if "check" in phases and {
            p for *_, p, _ in KERNELS.values()} <= set(by_path):
        log(json.dumps(kernels_line(by_path)))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run_phases(phases, card, gen, dev, by_path):
    """Run the named phases in order; any failure propagates."""
    t0 = time.perf_counter()
    if "check" in phases or "check_moe" in phases:
        check_moe(gen, dev)
    if "check" in phases or "check_k1" in phases:
        check_gemm(gen, dev)
    if "check" in phases:
        check_prefill(gen, dev)
        check_decode(gen, dev)
    if "check" in phases or "check_int8" in phases:
        check_prefill(gen, dev, PREFILL_INT8_CASES, int8=True)
        check_decode(gen, dev, DECODE_INT8_CASES, int8=True)
    if {"check", "check_int8", "check_w4a8"} & set(phases):
        check_w4a8(gen, dev)
    if "check" in phases or "check_mla" in phases:
        check_mla(gen, dev)
        check_mla_splits(gen, dev)
        check_mla_decode_plan(gen, dev)
        check_dsa_plan(gen, dev)
    if "check" in phases or "check_w4a16" in phases:
        check_w4a16(gen, dev)
    if RESULTS:
        log(f"[phase 3] {len(RESULTS)} kernel checks passed in "
            f"{time.perf_counter() - t0:.1f} s")
    # K2 (w4a16_gemv) runs where the tuner picks it; `serve_stream` runs it
    # at every decode step
    base = ("w4a16_gemm", "flash_prefill", "paged_decode")
    if "serve" in phases:
        by_path[SERVE_PATH] = serve_model(
            card, SERVE_PATH, "tinyllama-1.1b W4A16 (22 layers)",
            w4a16_cfg(TINYLLAMA), base)
    if "serve_ramp" in phases:
        by_path[RAMP_PATH] = serve_ramp(card)
    if "serve_stream" in phases:
        by_path[STREAM_PATH] = serve_stream(card)
    if "fused_mlp" in phases:
        by_path[FUSED_PATH] = fused_mlp_run(card)
    if "cross" in phases:
        cross_check_cpu("cpu_cross_check", "tinyllama width, 2 layers",
                        w4a16_cfg(TINYLLAMA, num_layers=2, max_position=2048),
                        seed=1, n_prompt=100, chunk=64, n_decode=6)
    if "llama3" in phases:
        width_run("llama3", "llama-3-8b width, 2 layers",
                  w4a16_cfg(LLAMA3_8B, num_layers=2),
                  ("flash_prefill", "paged_decode"))
    if "gptoss" in phases:
        n = GPT_OSS_LAYERS
        by_path["serve_gpt_oss"] = serve_model(
            card, "serve_gpt_oss", f"gpt-oss-20b W4A16 g64 ({n} layers)",
            gpt_oss_cfg(n), ("w4a16_gemm", "flash_prefill", "paged_decode",
                             "moe_gmm", "moe_gmm_units", "w4a16_kpaired"),
            kpaired_per_layer=1)
    if "gptoss_cross" in phases:
        cross_check_cpu("gpt_oss_cross_check",
                        "gpt-oss-20b width, 2 layers (sliding, full)",
                        gpt_oss_cfg(2), seed=4, n_prompt=200, chunk=128,
                        n_decode=4)
    if "llama3_w4a8" in phases:
        n = LLAMA3_W4A8_LAYERS
        by_path[LLAMA3_W4A8_PATH] = serve_model(
            card, LLAMA3_W4A8_PATH,
            f"llama-3-8b W4A8_AWQ g128, INT8 KV ({n} layers)",
            w4a8_cfg(LLAMA3_8B, num_layers=n), ("flash_prefill_int8", "paged_decode_int8",
                                  "w4a8_gemm"),
            absent=("flash_prefill", "paged_decode", "w4a16_gemm",
                    "w4a16_gemv"), kv_cache_quant="INT8")
    if "llama3_w4a8_cross" in phases:
        cross_check_cpu("llama3_w4a8_cross_check",
                        "llama-3-8b width W4A8 + INT8 KV, 2 layers",
                        w4a8_cfg(LLAMA3_8B, num_layers=2), seed=5,
                        n_prompt=200, chunk=128, n_decode=4,
                        kv_cache_quant="INT8")
    attn_gqa = ("flash_prefill", "paged_decode")
    if "deepseek" in phases:
        n = MOONLIGHT_LAYERS
        by_path[MOONLIGHT_PATH] = serve_model(
            card, MOONLIGHT_PATH, f"moonlight-16b-a3b W4A16 ({n} layers)",
            moonlight_cfg(n), ("w4a16_gemm", "moe_gmm",
                               "moe_gmm_units", "mla_prefill", "mla_decode",
                               "w4a16_kpaired"),
            absent=attn_gqa + ("dsa_score",), kpaired_per_layer=1)
    if "deepseek_v32" in phases:
        n = V32_LAYERS
        by_path[V32_PATH] = serve_model(
            card, V32_PATH, f"deepseek-v3.2 widths W4A16 ({n} layers)",
            deepseek_cfg(n), ("w4a16_gemm", "moe_gmm",
                              "moe_gmm_units", "dsa_score", "w4a16_kpaired"),
            absent=attn_gqa + ("mla_prefill", "mla_decode"),
            long_prompt=V32_LONG_PROMPT, max_seq_len=4096)
    if "deepseek_v3_width" in phases:
        width_run("deepseek_v3_width", "deepseek-v3 width, 2 layers (dense)",
                  deepseek_cfg(2, dsa=False), ("mla_prefill", "mla_decode"))
    if "deepseek_cross" in phases:
        cross_check_cpu("moonlight_cross_check",
                        "moonlight-16b-a3b width, 2 layers (dense, MoE)",
                        moonlight_cfg(2), seed=6, n_prompt=200, chunk=128,
                        n_decode=4)
        cross_check_cpu("deepseek_v32_cross_check",
                        "deepseek-v3.2 width, 2 layers (index_topk 2048 "
                        "covers the context)", deepseek_cfg(2), seed=7,
                        n_prompt=200, chunk=128, n_decode=4)
    if "checkpoint" in phases:
        checkpoint_phase(card, by_path)
    if "sampling" in phases:
        sampling_phase(card, by_path)
    if "openai" in phases:
        openai_phase(card, by_path)
    if "disagg" in phases:
        disagg_phase(card, by_path)
    if "bench" in phases:
        bench_phase(card, gen, dev, by_path)
    if "bench_cross" in phases:
        bench_cross()
    if "bench_overlap" in phases:
        bench_overlap(card)
    if "gemv_sweep" in phases:
        gemv_sweep(gen, dev)
    if "mla_decode_breakdown" in phases:
        mla_decode_breakdown(gen, dev)
    if "route_witness" in phases:
        route_witness()
    if "dsa_cross_breakdown" in phases:
        dsa_cross_breakdown()
    if "cross_breakdown" in phases:
        # opt-in: the card-vs-CPU gap of the W4A8 + INT8 KV check split by
        # weights (W4A8 or W4A16) and KV pools (INT8 or bf16), two seeds
        for name, make in (("w4a8", w4a8_cfg), ("w4a16", w4a16_cfg)):
            for kv in ("INT8", "NONE"):
                for seed in (5, 6):
                    cross_check_cpu(f"cross_{name}_{kv}_seed{seed}",
                                    f"llama-3-8b width {name}, {kv} KV",
                                    make(LLAMA3_8B, num_layers=2), seed=seed,
                                    n_prompt=200, chunk=128, n_decode=4,
                                    kv_cache_quant=kv)
    if "profile" in phases:
        profile_serve(card, "profile", w4a16_cfg(TINYLLAMA))
    if "profile_gptoss" in phases:
        profile_serve(card, "profile_gptoss", gpt_oss_cfg(GPT_OSS_LAYERS))
    if "profile_llama3_int8" in phases:
        profile_serve(card, "profile_llama3_int8", w4a8_cfg(LLAMA3_8B),
                      kv_cache_quant="INT8")
    if "profile_deepseek" in phases:
        profile_serve(card, "profile_deepseek", moonlight_cfg(MOONLIGHT_LAYERS))
    if "profile_deepseek_v32" in phases:
        profile_serve(card, "profile_deepseek_v32", deepseek_cfg(V32_LAYERS),
                      long_prompt=V32_LONG_PROMPT, max_seq_len=4096)
    log(f"[done] phases {phases} in {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    sys.exit(main())
