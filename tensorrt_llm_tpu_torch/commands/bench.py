"""`trtllm-torch-bench`: throughput and latency benchmark CLI of the port.

Counterpart of `tensorrt_llm_tpu/commands/bench.py` (the reference's
`trtllm-bench`): output tokens/s under continuous batching with synthetic
or dataset-file requests, reported with the reference's headline metrics
(output and total tokens/s, TTFT/TPOT/ITL/request-latency percentiles).

Modes:
  throughput -- submit `--num-requests` with at most `--concurrency` in
                flight; headline: output tokens/s.
  latency    -- one request at a time; headline: TTFT and per-token time.

Dataset files are JSON lines, each ``{"input_ids": [...], "output_tokens":
N}`` or ``{"prompt": "...", "output_tokens": N}`` (needs the model's
tokenizer), the reference's `prepare_dataset.py` format.

`--model` is an HF checkpoint directory or a shape preset of
`MODEL_SHAPES` (random weights from `--seed`).  `--device` (default
``cuda``) takes the place of the JAX package's `JAX_PLATFORMS`; on CUDA the
report carries the card's name and power limit.  A request that fails, at
submission or in its result, is counted under ``num_failed`` with its
error, releases its place in the window and does not stop the run.
``--kv-dtype`` takes auto, int8 or fp8 (e4m3 KV pages) and ``--quant`` any
`QuantAlgo` name.  An option that needs a module the port does not have
yet raises with the module's name: ``--tp-size`` above 1.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import threading
import time
from typing import List, Optional

import numpy as np

PERCENTILES = (50, 90, 95, 99)


def _pctl(values: List[float], scale: float = 1.0) -> Optional[dict]:
    """Percentile summary (the reference's PercentileStats: min, max, avg,
    p50..p99)."""
    if not values:
        return None
    a = np.asarray(values, np.float64) * scale
    out = {"avg": round(float(a.mean()), 3),
           "min": round(float(a.min()), 3),
           "max": round(float(a.max()), 3)}
    for p in PERCENTILES:
        out[f"p{p}"] = round(float(np.percentile(a, p)), 3)
    return out


def load_dataset(path: str, tokenizer=None, max_requests: int = 0):
    """JSONL dataset -> [(input_ids, output_len)]."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            row = json.loads(line)
            ids = row.get("input_ids")
            if ids is None:
                if tokenizer is None:
                    raise ValueError(
                        "dataset rows with 'prompt' text need a tokenizer; "
                        "use token-id rows or a checkpoint with one")
                ids = tokenizer.encode(row["prompt"])
            rows.append(([int(t) for t in ids],
                         int(row.get("output_tokens", 128))))
            if max_requests and len(rows) >= max_requests:
                break
    return rows


def _request_stats(req, results_osl: int) -> dict:
    """Per-request record from the request's timestamps; inter-token
    latencies from its per-emit `token_times`, a piece of several tokens
    (a fused decode chunk) split evenly over them."""
    ttft = (req.first_token_time - req.arrival_time
            if req.first_token_time else None)
    e2e = (req.end_time - req.arrival_time) if req.end_time else None
    n_out = len(req.output_token_ids)
    tpot = None
    if ttft is not None and e2e is not None and n_out > 1:
        tpot = (e2e - ttft) / (n_out - 1)
    itls = []
    prev_n, prev_t = None, None
    for n, t in req.token_times:
        if prev_t is not None and n > prev_n:
            itls.extend([(t - prev_t) / (n - prev_n)] * (n - prev_n))
        prev_n, prev_t = n, t
    return {"ttft": ttft, "e2e": e2e, "tpot": tpot, "itls": itls,
            "n_out": n_out, "n_in": req.prompt_len}


def _aggregate(per_req: List[dict], wall: float, n_chips: int) -> dict:
    out_tokens = sum(r["n_out"] for r in per_req)
    total_tokens = out_tokens + sum(r["n_in"] for r in per_req)
    itls: List[float] = []
    for r in per_req:
        itls.extend(r["itls"])
    return {
        "num_requests": len(per_req),
        "wall_s": round(wall, 3),
        "output_tokens": out_tokens,
        "output_tokens_per_sec": round(out_tokens / wall, 2),
        "output_tokens_per_sec_per_chip": round(out_tokens / wall / n_chips,
                                                2),
        "total_token_throughput_per_sec": round(total_tokens / wall, 2),
        "requests_per_sec": round(len(per_req) / wall, 3),
        "ttft_ms": _pctl([r["ttft"] for r in per_req if r["ttft"]], 1e3),
        "tpot_ms": _pctl([r["tpot"] for r in per_req if r["tpot"]], 1e3),
        "itl_ms": _pctl(itls, 1e3),
        "request_latency_ms": _pctl([r["e2e"] for r in per_req if r["e2e"]],
                                    1e3),
        "per_user_output_speed_tok_s": _pctl(
            [1.0 / r["tpot"] for r in per_req if r["tpot"]]),
    }


def _sampling(osl: int):
    from tensorrt_llm_tpu_torch.llmapi import SamplingParams
    return SamplingParams(max_tokens=osl, ignore_eos=True)


def run_throughput(llm, requests, concurrency: int,
                   warmup: bool = True, streaming: bool = False) -> dict:
    """Continuous-batching throughput with at most `concurrency` requests
    in flight (the reference's async benchmark `--concurrency`): a
    semaphore gates submission and each completion releases it, also when
    the request failed.  Failed requests are left out of the aggregates
    and listed under ``num_failed`` / ``errors``."""
    if warmup:
        wf = [llm.generate_async(list(ids), _sampling(8))
              for ids, _ in requests[:min(len(requests), concurrency)]]
        for f in wf:
            f.result()

    gate = threading.BoundedSemaphore(max(concurrency, 1))
    done: list = [None] * len(requests)
    errors: list = []
    lock = threading.Lock()

    def _reap(i, fut):
        try:
            fut.result()
            with lock:
                done[i] = fut.req
        except Exception as e:  # noqa: BLE001 -- counted, run goes on
            with lock:
                errors.append(f"request {i}: {type(e).__name__}: {e}")
        finally:
            gate.release()

    t0 = time.perf_counter()
    threads = []
    for i, (ids, osl) in enumerate(requests):
        gate.acquire()
        try:
            fut = llm.generate_async(list(ids), _sampling(osl),
                                     streaming=streaming)
        except Exception as e:  # noqa: BLE001 -- refused at submission
            with lock:
                errors.append(f"request {i}: {type(e).__name__}: {e}")
            gate.release()
            continue
        th = threading.Thread(target=_reap, args=(i, fut), daemon=True)
        th.start()
        threads.append(th)
    for th in threads:
        th.join()
    wall = time.perf_counter() - t0

    per_req = [_request_stats(req, osl)
               for req, (_, osl) in zip(done, requests) if req is not None]
    rep = _aggregate(per_req, wall, n_chips=llm.num_devices)
    rep["concurrency"] = concurrency
    rep["num_failed"] = len(errors)
    rep["errors"] = errors
    return rep


def run_latency(llm, requests, warmup: bool = True) -> dict:
    """One request at a time (the reference's `trtllm-bench latency`): the
    report centres on TTFT and per-token latency."""
    if warmup:
        ids, _ = requests[0]
        llm.generate_async(list(ids), _sampling(8)).result()
    per_req = []
    t0 = time.perf_counter()
    for ids, osl in requests:
        fut = llm.generate_async(list(ids), _sampling(osl))
        fut.result()
        per_req.append(_request_stats(fut.req, osl))
    wall = time.perf_counter() - t0
    rep = _aggregate(per_req, wall, n_chips=llm.num_devices)
    rep["mode"] = "latency"
    return rep


def synthetic_requests(isl: int, osl: int, num: int, vocab: int,
                       seed: int = 0):
    rng = np.random.RandomState(seed)
    return [(list(rng.randint(10, max(vocab - 10, 11), isl)), osl)
            for _ in range(num)]


def card_name() -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them (first card)."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True)
    return r.stdout.strip().splitlines()[0]


# Shape presets for checkpoint-free runs (random weights): the JAX
# package's presets, the reference's perf-overview models.
MODEL_SHAPES = {
    "tinyllama-1.1b": dict(vocab_size=32000, hidden_size=2048,
                           intermediate_size=5632, num_layers=22,
                           num_heads=32, num_kv_heads=4, head_dim=64,
                           max_position=4096),
    "llama-3-8b": dict(vocab_size=128256, hidden_size=4096,
                       intermediate_size=14336, num_layers=32,
                       num_heads=32, num_kv_heads=8, head_dim=128,
                       max_position=8192),
    "llama-2-7b": dict(vocab_size=32000, hidden_size=4096,
                       intermediate_size=11008, num_layers=32,
                       num_heads=32, num_kv_heads=32, head_dim=128,
                       max_position=4096),
    # 24-layer, 32-expert top-4 MoE, alternating sliding/full attention
    # with sinks, as an HF config so that the GPT-OSS model class runs;
    # quant_group_size 64: hidden 2880 is not a multiple of 128
    "gpt-oss-20b": dict(quant_group_size=64, hf_config=dict(
        architectures=["GptOssForCausalLM"], model_type="gpt_oss",
        vocab_size=201088, hidden_size=2880, intermediate_size=2880,
        num_hidden_layers=24, num_attention_heads=64,
        num_key_value_heads=8, head_dim=64,
        num_local_experts=32, num_experts_per_tok=4,
        sliding_window=128,
        layer_types=["sliding_attention", "full_attention"] * 12,
        rope_theta=150000.0, attention_bias=True, attention_dropout=0.0,
        tie_word_embeddings=False, max_position_embeddings=131072,
        rms_norm_eps=1e-5,
        rope_scaling={"rope_type": "yarn", "factor": 32.0,
                      "beta_fast": 32.0, "beta_slow": 1.0,
                      "truncate": False,
                      "original_max_position_embeddings": 4096})),
}


def preset_model(name: str, kw: dict):
    """The `LLM` model argument of a preset: a `ModelConfig` (an HF config
    preset through `from_hf_config`, with `AutoConfig`'s defaults filled
    in); random weights from `kw`'s seed.  Adds the preset's group size
    to `kw`."""
    from tensorrt_llm_tpu_torch.models import ModelConfig
    shapes = dict(MODEL_SHAPES[name])
    if "quant_group_size" in shapes:
        kw["quant_group_size"] = shapes.pop("quant_group_size")
    if "hf_config" in shapes:
        from tensorrt_llm_tpu_torch.llmapi.hf_checkpoint import (
            hf_config_defaults)
        return ModelConfig.from_hf_config(
            hf_config_defaults(shapes["hf_config"]))
    return ModelConfig(**shapes)


def llm_kwargs(args) -> dict:
    """`LLM` arguments of the parsed flags (raises for what the port does
    not have yet)."""
    if args.tp_size > 1:
        raise NotImplementedError(
            "--tp-size > 1 needs the tensor-parallel mapping "
            "(tensorrt_llm_tpu_torch.parallel), not in the port yet")
    kw = dict(device=args.device, quant_algo=args.quant,
              max_batch_size=args.max_batch_size,
              max_seq_len=args.max_seq_len, seed=args.seed,
              skip_tokenizer_init=args.dataset is None)
    if args.kv_dtype and args.kv_dtype.lower() != "auto":
        kw["kv_cache_quant"] = args.kv_dtype.upper()
    if args.decode_steps:
        kw["max_decode_steps"] = args.decode_steps
    if args.max_num_tokens:
        kw["max_num_tokens"] = args.max_num_tokens
    if args.free_mem_fraction is not None:
        kw["free_mem_fraction"] = args.free_mem_fraction
    return kw


def main(argv=None):
    p = argparse.ArgumentParser("trtllm-torch-bench")
    p.add_argument("mode", nargs="?", default="throughput",
                   choices=["throughput", "latency"])
    p.add_argument("--model", required=True,
                   help="HF checkpoint path, or a shape preset "
                        f"({', '.join(MODEL_SHAPES)}) for random-weight "
                        "perf runs")
    p.add_argument("--dataset", default=None,
                   help="JSONL file of {'input_ids'|'prompt', 'output_tokens'}")
    p.add_argument("--isl", type=int, default=128)
    p.add_argument("--osl", type=int, default=128)
    p.add_argument("--num-requests", type=int, default=32)
    p.add_argument("--concurrency", type=int, default=32,
                   help="max in-flight requests (throughput mode)")
    p.add_argument("--streaming", action="store_true",
                   help="per-token emission (finer ITL percentiles)")
    p.add_argument("--tp-size", type=int, default=1)
    p.add_argument("--quant", default=None,
                   help="a QuantAlgo name: W4A16, W4A16_AWQ, W4A16_GPTQ, "
                        "W4A8_AWQ, W8A16, W8A8_SQ_PER_CHANNEL, FP8, "
                        "FP8_PER_CHANNEL_PER_TOKEN")
    p.add_argument("--kv-dtype", default=None,
                   help="auto|int8|fp8 KV cache quantization")
    p.add_argument("--max-batch-size", type=int, default=64)
    p.add_argument("--max-seq-len", type=int, default=2048)
    p.add_argument("--max-num-tokens", type=int, default=None)
    p.add_argument("--free-mem-fraction", type=float, default=None,
                   help="fraction of free device memory given to the KV "
                        "pool")
    p.add_argument("--decode-steps", type=int, default=None,
                   help="fused multi-step decode chunk size "
                        "(tokens per dispatch; default engine setting)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the kernels' plain "
                        "versions)")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of a preset's random weights")
    p.add_argument("--report-json", default=None,
                   help="also write the report to this path")
    args = p.parse_args(argv)

    from tensorrt_llm_tpu_torch.llmapi import LLM

    kw = llm_kwargs(args)
    model = args.model
    if args.model.lower() in MODEL_SHAPES:
        model = preset_model(args.model.lower(), kw)
    llm = LLM(model=model, **kw)
    try:
        if args.dataset:
            requests = load_dataset(args.dataset, llm.tokenizer,
                                    args.num_requests)
        else:
            requests = synthetic_requests(
                args.isl, args.osl, args.num_requests,
                llm.model_config.vocab_size)
        if args.mode == "latency":
            report = run_latency(llm, requests)
        else:
            report = run_throughput(llm, requests, args.concurrency,
                                    streaming=args.streaming)
        report["isl"] = args.isl if not args.dataset else None
        report["osl"] = args.osl if not args.dataset else None
        report["model"] = str(args.model)
        report["quant"] = args.quant
        report["tp_size"] = args.tp_size
        report["device"] = str(llm.device)
        if llm.device.type == "cuda":
            report["card"] = card_name()
        text = json.dumps(report, indent=2)
        print(text)
        if args.report_json:
            with open(args.report_json, "w") as f:
                f.write(text + "\n")
    finally:
        llm.shutdown()


if __name__ == "__main__":
    main()
