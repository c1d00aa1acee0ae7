#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port (`tensorrt_llm_tpu_torch`) on one GPU.

    python3 chip_smoke.py            # all phases, one H100

Phases (any failure exits nonzero; nothing is caught and ignored):

1. the card's name and power limit (nvidia-smi);
2. build the four CUDA kernels from `tensorrt_llm_tpu_torch/csrc`;
3. hold each kernel against its plain PyTorch version on the card, in bf16,
   at TinyLlama-1.1B and Llama-3-8B shapes, and time kernel, plain version
   and one library call; one JSON line per kernel and shape;
4. serve 8 greedy requests with `LLM.generate` on the full-width, 22-layer
   TinyLlama-1.1B W4A16 model (random weights from a seed), with launch
   counters reset just before and read just after;
5. the same weights at full width and 2 layers on the card and on the CPU
   (plain versions): logits and greedy tokens must agree;
6. a short `LLM.generate` run at Llama-3-8B width (2 layers), so that the
   attention kernels run at head dim 128 inside the model.

Arguments pick phases (default: check serve cross llama3); `profile`, run
only when named, traces a short serve window with torch.profiler.
`--json PATH` also writes every check and phase summary to PATH.

The last three lines of stdout are the card's name and power limit, the
`kernels` JSON object and the device JSON object.  Without a CUDA device,
or without the package beside it, the script exits nonzero before printing
any result.  It imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES = 3.35e12       # H100 SXM HBM3, bytes/s
PEAK_BF16 = 989e12         # H100 SXM dense bf16 tensor-core FLOP/s
ROT_BYTES = 128 << 20      # rotate operands past the 50 MB L2 when timing

RESULTS = []               # one dict per kernel check
PHASES = {}                # summaries of the other phases, by name
DEVICE = "cuda"

# (K, N) of the QKV, o, gate_up and down projections
GEMM_SHAPES = {"tinyllama": [(2048, 2560), (2048, 2048), (2048, 11264),
                             (5632, 2048)],
               "llama-3-8b": [(4096, 6144), (4096, 4096), (4096, 28672),
                              (14336, 4096)]}
GEMM_M = (1, 4, 8, 16, 256, 512)
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
]
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
]


def log(*a):
    print(*a, flush=True)


def bound_ms(nbytes, ops):
    tb, to = nbytes / PEAK_BYTES, ops / PEAK_BF16
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


def record(kernel, shape, err, tol, k_ms, p_ms, lib_ms, b):
    ok = err <= tol
    row = {"kernel": kernel, "shape": shape, "max_err": err, "tol": tol,
           "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms,
           "bound_ms": b[0], "bound_by": b[1], "ok": ok}
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
        for K, N in kns:
            w = torch.randn((K, N), generator=gen, device=dev) * 0.02
            q, s, _ = quantize_w4(w, 128)
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
                nbytes = M * K * 2 + wq_bytes + M * N * 2
                record(name, {"model": model, "M": M, "K": K, "N": N,
                              "act": act, "zeros_bias": extras}, err, tol,
                       k_ms, p_ms, l_ms, bound_ms(nbytes, 2 * M * N * K))
            del ws, lib_w, wdq
            torch.cuda.empty_cache()


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


def _sdpa_ms(q, k, v, mask, iters):
    """Time of one library call (scaled_dot_product_attention) on dense K/V
    gathered and GQA-expanded beforehand: q [B,Hq,T,D], k/v [B,Hkv,S,D]."""
    import torch.nn.functional as F
    G = q.shape[1] // k.shape[1]
    k = k.repeat_interleave(G, dim=1).contiguous()
    v = v.repeat_interleave(G, dim=1).contiguous()
    return cuda_ms([lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask)], iters)


def check_prefill(gen, dev):
    import numpy as np
    import torch
    from tensorrt_llm_tpu_torch.ops.flash_prefill import (
        flash_prefill_attention, flash_prefill_plain)
    for model, Hq, Hkv, D, T, off, win, cap, sk in PREFILL_CASES:
        kv_len = off + T
        k, v, tables = _paged(gen, dev, [kv_len], Hkv, D)
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
        n_copy = copies_for(2 * k.numel() * 2)
        pools = [(k.clone(), v.clone()) for _ in range(n_copy)]
        k_ms = cuda_ms([lambda kk=kk, vv=vv: flash_prefill_attention(
            q, kk, vv, table, kv_len, off, scale, **kw)
            for kk, vv in pools], 20)
        p_ms = cuda_ms([lambda: flash_prefill_plain(
            q, k, v, table, kv_len, off, scale, **kw)], 5)
        l_ms = None
        if not sk and not cap:
            # dense K/V gathered once outside the timing
            kd = k[table.long()].permute(1, 0, 2, 3).reshape(
                Hkv, -1, D)[None, :, :kv_len]
            vd = v[table.long()].permute(1, 0, 2, 3).reshape(
                Hkv, -1, D)[None, :, :kv_len]
            qp = off + torch.arange(T, device=dev)[:, None]
            kp = torch.arange(kv_len, device=dev)[None, :]
            mask = kp <= qp
            if win:
                mask &= kp > qp - win
            qd = q.permute(1, 0, 2)[None]
            l_ms = _sdpa_ms(qd, kd, vd, mask, 20)
        qpos = off + np.arange(T)[:, None]
        kpos = np.arange(kv_len)[None, :]
        valid = (kpos <= qpos)
        if win:
            valid &= kpos > qpos - win
        pairs = int(valid.sum())
        lo = max(0, off - win + 1) if win else 0
        nbytes = 2 * T * Hq * D * 2 + 2 * (kv_len - lo) * Hkv * D * 2
        # the kernel rounds P to bf16 (2^-9 relative) and both sides round
        # the output to bf16 (2^-8 relative): 2% of the largest output
        tol = 2e-2 * max(1.0, ref.float().abs().max().item())
        record("flash_prefill", {"model": model, "Hq": Hq, "Hkv": Hkv, "D": D,
                                 "T": T, "q_offset": off, "window": win,
                                 "logit_cap": cap, "sinks": sk},
               err, tol, k_ms, p_ms, l_ms,
               bound_ms(nbytes, 4 * pairs * Hq * D))


def check_decode(gen, dev):
    import torch
    from tensorrt_llm_tpu_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_plain)
    for model, Hq, Hkv, D, lens, win, cap, sk in DECODE_CASES:
        B = len(lens)
        k, v, tables = _paged(gen, dev, lens, Hkv, D)
        kv_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
        q = torch.randn((B, Hq, D), generator=gen, device=dev
                        ).to(torch.bfloat16)
        sinks = (torch.randn((Hq,), generator=gen, device=dev)
                 if sk else None)
        scale = D ** -0.5
        kw = dict(sliding_window=win, logit_cap=cap, sinks=sinks)
        out = paged_decode_attention(q, k, v, tables, kv_lens, scale, **kw)
        ref = paged_decode_plain(q, k, v, tables, kv_lens, scale, **kw)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        pools = [(k.clone(), v.clone())
                 for _ in range(copies_for(2 * k.numel() * 2))]
        k_ms = cuda_ms([lambda kk=kk, vv=vv: paged_decode_attention(
            q, kk, vv, tables, kv_lens, scale, **kw) for kk, vv in pools], 30)
        p_ms = cuda_ms([lambda: paged_decode_plain(
            q, k, v, tables, kv_lens, scale, **kw)], 5)
        l_ms = None
        if not sk and not cap:
            S = tables.shape[1] * k.shape[2]
            kd = k[tables.long()].permute(0, 2, 1, 3, 4).reshape(B, Hkv, S, D)
            vd = v[tables.long()].permute(0, 2, 1, 3, 4).reshape(B, Hkv, S, D)
            pos = torch.arange(S, device=dev)[None, :]
            L = kv_lens.long()[:, None]
            mask = pos < L
            if win:
                mask &= pos >= L - win
            l_ms = _sdpa_ms(q[:, :, None], kd, vd, mask[:, None, None, :], 30)
        used = [min(L, win) if win else L for L in lens]
        nbytes = 2 * B * Hq * D * 2 + sum(used) * 2 * Hkv * D * 2
        # f32 math on both sides; the bf16 output rounding (2^-8 relative)
        # remains: 1% of the largest output
        tol = 1e-2 * max(1.0, ref.float().abs().max().item())
        record("paged_decode", {"model": model, "Hq": Hq, "Hkv": Hkv, "D": D,
                                "kv_lens": lens, "window": win,
                                "logit_cap": cap, "sinks": sk},
               err, tol, k_ms, p_ms, l_ms,
               bound_ms(nbytes, 4 * sum(used) * Hq * D))


# ------------------------------------------------------------ phases 4-6 ---
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


def serve_tinyllama(card):
    import numpy as np
    import torch
    import tensorrt_llm_tpu_torch as T
    from tensorrt_llm_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    llm = T.LLM(model=w4a16_cfg(TINYLLAMA), skip_tokenizer_init=True,
                device=DEVICE, max_batch_size=4, max_num_tokens=256,
                max_seq_len=1024, kv_block_size=16, kv_num_blocks=640,
                seed=0, return_perf_metrics=True)
    log(f"[phase 4] TinyLlama-1.1B W4A16, 22 layers, built in "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    V = TINYLLAMA["vocab_size"]

    def ids(n):
        return [int(t) for t in rng.integers(10, V - 10, n)]

    shared = ids(300)
    prompts = [shared + ids(20), shared + ids(45)]
    prompts += [ids(n) for n in (17, 64, 200, 333, 480, 600)]
    sp = T.SamplingParams(max_tokens=64, temperature=0.0, ignore_eos=True,
                          logprobs=1)
    try:
        # warm-up request: library loaded, allocator and cuBLAS initialised
        llm.generate([[1, 2, 3, 4]], T.SamplingParams(max_tokens=2,
                                                      temperature=0.0))
        torch.cuda.synchronize()
        n_stats = len(llm.get_stats())
        cuda_build.reset_launch_counts()
        t0 = time.perf_counter()
        outs = llm.generate(prompts, sp, cache_salt="run1")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(cuda_build.launch_counts)
        stats = llm.get_stats()[n_stats:]
        kv = llm.get_kv_cache_stats()
        toks = [o.outputs[0].token_ids for o in outs]
        assert all(len(t) == 64 for t in toks), [len(t) for t in toks]
        lps = [lp for o in outs for d in o.outputs[0].logprobs
               for lp in d.values()]
        assert np.isfinite(lps).all(), "non-finite logprobs"
        assert kv["reused_blocks"] > 0, kv
        # a fresh salt: no reuse of run 1's blocks, so the same schedule
        again = [o.outputs[0].token_ids
                 for o in llm.generate(prompts, sp, cache_salt="run2")]
        assert again == toks, "second run gave other tokens"
    finally:
        llm.shutdown()
    for k in ("w4a16_gemm", "w4a16_gemv", "flash_prefill", "paged_decode"):
        assert counts.get(k, 0) > 0, f"{k} never launched on the main path"
    chunks = sum(s["num_prefill_chunks"] for s in stats)
    dsteps = sum(s["decode_steps"] for s in stats)
    ttft = [o.metrics["ttft_s"] for o in outs]
    n_out = sum(len(t) for t in toks)
    summary = {
        "phase": "serve", "model": "tinyllama-1.1b W4A16 (22 layers)",
        "card": card, "requests": len(prompts), "output_tokens": n_out,
        "wall_s": wall, "tokens_per_s": n_out / wall,
        "ttft_s_mean": float(np.mean(ttft)), "ttft_s_max": float(max(ttft)),
        "prefill_chunks": chunks, "decode_steps": dsteps,
        "launches": counts,
        "gemm_launches_per_forward": (counts["w4a16_gemm"]
                                      + counts["w4a16_gemv"])
        / (chunks + dsteps),
        "flash_prefill_per_chunk": counts["flash_prefill"] / chunks,
        "paged_decode_per_step": counts["paged_decode"] / dsteps,
        "kv": kv}
    PHASES["serve"] = summary
    log(json.dumps(summary))
    return counts


def cross_check_cpu():
    import numpy as np
    import torch
    from tensorrt_llm_tpu_torch.attention_backend import AttentionMetadata
    from tensorrt_llm_tpu_torch.models import get_model_class
    cfg = w4a16_cfg(TINYLLAMA, num_layers=2, max_position=2048)
    gpu = get_model_class(cfg.architecture)(cfg, DEVICE).init_random(1)
    cpu = get_model_class(cfg.architecture)(cfg, "cpu").load_state(
        {k: v.cpu() for k, v in gpu.state().items()})
    rng = np.random.default_rng(1)
    prompt = [int(t) for t in rng.integers(10, cfg.vocab_size - 10, 100)]
    BS, blocks = 16, list(range(1, 9))

    def pools(dev):
        shape = (len(blocks) + 1, cfg.num_kv_heads, BS, cfg.head_dim)
        return [(torch.zeros(shape, dtype=torch.bfloat16, device=dev),
                 torch.zeros(shape, dtype=torch.bfloat16, device=dev))
                for _ in range(cfg.num_layers)]

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

    TOL = 0.08
    steps, worst, agree, compared = [], 0.0, 0, 0
    seq = list(prompt)
    plan = [("prefill", 0, 64), ("prefill", 64, 100)]
    for mode, lo, hi in plan:
        lg = run("cuda", seq[lo:hi], list(range(lo, hi)), hi, mode, lo)
        lc = run("cpu", seq[lo:hi], list(range(lo, hi)), hi, mode, lo)
        steps.append((lg, lc))
    for _ in range(6):
        lg, lc = steps[-1]
        seq.append(int(np.argmax(lc)))          # teacher-force the CPU token
        n = len(seq)
        steps.append((run("cuda", [seq[-1]], [n - 1], n, "decode", 0),
                      run("cpu", [seq[-1]], [n - 1], n, "decode", 0)))
    for lg, lc in steps[1:]:
        assert np.isfinite(lg).all() and np.isfinite(lc).all()
        worst = max(worst, float(np.abs(lg - lc).max()))
        top2 = np.sort(lc)[-2:]
        if top2[1] - top2[0] > TOL:
            compared += 1
            agree += int(np.argmax(lg) == np.argmax(lc))
    res = {"phase": "cpu_cross_check", "model": "tinyllama width, 2 layers",
           "steps": len(steps) - 1, "max_abs_logit_diff": worst, "tol": TOL,
           "greedy_compared": compared, "greedy_agree": agree}
    PHASES["cpu_cross_check"] = res
    log(json.dumps(res))
    assert worst <= TOL, res
    assert agree == compared, res
    del gpu, cpu, caches, models
    torch.cuda.empty_cache()


def llama3_width():
    import numpy as np
    import torch
    import tensorrt_llm_tpu_torch as T
    from tensorrt_llm_tpu_torch.ops import cuda_build
    llm = T.LLM(model=w4a16_cfg(LLAMA3_8B, num_layers=2),
                skip_tokenizer_init=True, device=DEVICE, max_batch_size=4,
                max_num_tokens=256, max_seq_len=1024, seed=2)
    rng = np.random.default_rng(2)
    prompts = [[int(t) for t in rng.integers(10, LLAMA3_8B["vocab_size"] - 10,
                                             n)] for n in (300, 41)]
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
    for k in ("flash_prefill", "paged_decode"):
        assert counts.get(k, 0) > 0, f"{k} did not run at D=128"
    PHASES["llama3"] = {"phase": "llama-3-8b width, 2 layers",
                        "launches": counts,
                        "tokens": [o.outputs[0].token_ids[:8] for o in outs]}
    log(json.dumps(PHASES["llama3"]))
    del llm
    torch.cuda.empty_cache()


def profile_serve(card):
    """Opt-in phase (`python3 chip_smoke.py profile`): trace a short
    TinyLlama serve window (4 requests of 200 tokens, 32 new tokens each)
    with torch.profiler and report the device-busy share of the wall time
    and the kernels holding the device, by total device time."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    import tensorrt_llm_tpu_torch as T
    llm = T.LLM(model=w4a16_cfg(TINYLLAMA), skip_tokenizer_init=True,
                device=DEVICE, max_batch_size=4, max_num_tokens=256,
                max_seq_len=1024, kv_num_blocks=640, seed=0)
    rng = np.random.default_rng(3)
    prompts = [[int(t) for t in rng.integers(10, TINYLLAMA["vocab_size"]
                                             - 10, 200)] for _ in range(4)]
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

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    rows = sorted(((e.key, dev_us(e), e.count) for e in prof.key_averages()
                   if dev_us(e) > 0), key=lambda r: -r[1])
    busy = sum(r[1] for r in rows) / 1e6
    PHASES["profile"] = {
        "phase": "profile", "card": card, "wall_s": wall,
        "device_busy_s": busy, "device_busy_share": busy / wall,
        "decode_steps": sum(s["decode_steps"] for s in stats[-50:]),
        "top_kernels_ms": [[k[:90], us / 1e3, n] for k, us, n in rows[:12]]}
    log(json.dumps(PHASES["profile"]))


# ----------------------------------------------------------------- summary --
KERNELS = {
    "w4a16_gemm": ("cuda", "tensorrt_llm_tpu_torch/csrc/w4a16_gemm.cu",
                   "tensorrt_llm_tpu/ops/w4a16_gemm.py:205",
                   {"model": "tinyllama", "M": 256, "K": 2048, "N": 11264}),
    "w4a16_gemv": ("cuda", "tensorrt_llm_tpu_torch/csrc/w4a16_gemv.cu",
                   "tensorrt_llm_tpu/ops/w4a16_gemm.py:560",
                   {"model": "tinyllama", "M": 4, "K": 2048, "N": 11264}),
    "flash_prefill": ("cuda", "tensorrt_llm_tpu_torch/csrc/flash_prefill.cu",
                      "tensorrt_llm_tpu/ops/flash_prefill.py:282",
                      {"model": "tinyllama", "T": 256, "q_offset": 256,
                       "sinks": False}),
    "paged_decode": ("cuda", "tensorrt_llm_tpu_torch/csrc/paged_decode.cu",
                     "tensorrt_llm_tpu/ops/paged_attention.py:516",
                     {"model": "tinyllama", "kv_lens": [81, 150, 400, 664],
                      "sinks": False, "logit_cap": None, "window": None}),
}


def kernels_line(counts):
    out = []
    for name, (route, src, replaces, head) in KERNELS.items():
        rows = [r for r in RESULTS if r["kernel"] == name]
        hit = [r for r in rows
               if all(r["shape"].get(k) == v for k, v in head.items())]
        h = hit[0]
        out.append({"name": name, "route": route, "source": src,
                    "replaces": replaces, "launches": counts.get(name, 0),
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
        if "registers" in line or "spill" in line or "error" in line:
            log("  " + line.strip())

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
    phases = args or ["check", "serve", "cross", "llama3"]
    counts = {}
    t0 = time.perf_counter()
    if "check" in phases:
        check_gemm(gen, dev)
        check_prefill(gen, dev)
        check_decode(gen, dev)
        log(f"[phase 3] {len(RESULTS)} kernel checks passed in "
            f"{time.perf_counter() - t0:.1f} s")
    if "serve" in phases:
        counts = serve_tinyllama(card)
    if "cross" in phases:
        cross_check_cpu()
    if "llama3" in phases:
        llama3_width()
    if "profile" in phases:
        profile_serve(card)
    if out_json:
        os.makedirs(os.path.dirname(os.path.abspath(out_json)), exist_ok=True)
        with open(out_json, "w") as f:
            json.dump({"card": card, "phases": PHASES, "checks": RESULTS}, f,
                      indent=1)
    log(card)
    if "check" in phases and "serve" in phases:
        log(json.dumps(kernels_line(counts)))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
