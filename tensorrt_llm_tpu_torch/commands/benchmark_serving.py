"""`trtllm-torch-benchmark-serving`: the HTTP-level serving benchmark.

Counterpart of `tensorrt_llm_tpu/commands/benchmark_serving.py` (the
reference's online load generator, `serve/scripts/benchmark_serving.py`),
with its flags and metric set: a client on `asyncio` streams
(`serve/http_client.py`; the JAX client is aiohttp's, which the card's
machine does not have) drives a
running OpenAI server with Poisson (gamma-burstiness) arrivals, bounded
concurrency and synthetic or JSONL-dataset requests, and reports
request/output/total token throughput, goodput, and mean/median/std/
percentile TTFT, TPOT, ITL and E2E latencies, all from SSE timing: TTFT is
the first ``data:`` event's arrival, ITL the gaps between events.
`build_requests`, `compute_metrics` and `print_report` are the JAX
package's.  Intended difference: a stream that carries an ``error`` event
or ends without ``data: [DONE]`` counts as failed (the JAX client counts
any stream with one event as a success with all its tokens).

Unlike `trtllm-torch-bench` (in process), this measures the whole serving
stack: HTTP, scheduling, streaming.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import random
import time
from dataclasses import dataclass, field
from typing import List, Optional
import numpy as np

from tensorrt_llm_tpu_torch.serve.http_client import ClientError, ClientSession


@dataclass
class RequestResult:
    success: bool = False
    error: str = ""
    prompt_len: int = 0
    output_tokens: int = 0
    chunks: int = 0              # SSE events (== tokens at stream_interval 1)
    ttft: float = 0.0            # s
    itl: List[float] = field(default_factory=list)   # s between chunks
    e2e: float = 0.0             # s


def build_requests(args) -> List[dict]:
    """[{prompt | ids, output_len}] from a JSONL dataset or synthetic."""
    reqs = []
    if args.dataset:
        with open(args.dataset) as f:
            for line in f:
                if not line.strip():
                    continue
                row = json.loads(line)
                reqs.append({
                    "prompt": row.get("prompt") or row.get("input_ids"),
                    "output_len": int(row.get("output_len",
                                              args.output_len)),
                    "prompt_len": len(row.get("input_ids")
                                      or row.get("prompt", "").split()),
                })
                if args.num_prompts and len(reqs) >= args.num_prompts:
                    break
        return reqs
    rng = random.Random(args.seed)
    for _ in range(args.num_prompts):
        ids = [rng.randrange(10, 1000) for _ in range(args.input_len)]
        reqs.append({"prompt": ids, "output_len": args.output_len,
                     "prompt_len": args.input_len})
    return reqs


async def arrival_times(n: int, request_rate: float, burstiness: float):
    """Yield after gamma-distributed inter-arrival gaps (theta =
    1/(rate*burstiness); burstiness=1 => Poisson)."""
    for i in range(n):
        yield i
        if request_rate == float("inf"):
            continue
        theta = 1.0 / (request_rate * burstiness)
        gap = np.random.gamma(shape=burstiness, scale=theta)
        await asyncio.sleep(gap)


class HTTPStatusError(Exception):
    pass


async def post_stream(url: str, body: dict):
    """POST `body` as JSON to `url`; an async generator of the response's
    lines (bytes, without the line end) as they arrive.  Raises
    `HTTPStatusError` for a status other than 200."""
    async with ClientSession() as session:
        r = await session.post(url, json=body)
        if r.status != 200:
            rest = await r.read()
            raise HTTPStatusError(
                f"HTTP {r.status}: {rest.decode(errors='replace')[:200]}")
        buf = b""
        async for b in r.iter_chunks():
            buf += b
            *lines, buf = buf.split(b"\n")
            for line in lines:
                yield line
        if buf:
            yield buf


async def one_request(args, req) -> RequestResult:
    body = {
        "model": args.model,
        "prompt": req["prompt"],
        "max_tokens": req["output_len"],
        "ignore_eos": True,
        "stream": True,
        "temperature": args.temperature,
    }
    url = args.base_url.rstrip("/") + args.endpoint
    res = RequestResult(prompt_len=req["prompt_len"])
    t0 = time.perf_counter()
    last = t0
    done = False
    try:
        async for raw in post_stream(url, body):
            line = raw.decode().strip()
            if line == "data: [DONE]":
                done = True
                continue
            if line.startswith('data: {"error"'):     # the server failed
                res.error = str(json.loads(line[6:])["error"])
                continue
            if not line.startswith("data: "):
                continue
            now = time.perf_counter()
            if res.ttft == 0.0:
                res.ttft = now - t0
            else:
                res.itl.append(now - last)
            last = now
            res.chunks += 1
        res.e2e = time.perf_counter() - t0
        if not res.error and not done:
            res.error = "stream ended without [DONE]"
        res.success = res.chunks > 0 and not res.error
        # SSE events may carry several tokens each; with ignore_eos the
        # request generates exactly output_len tokens, so token metrics
        # use that, not the event count
        res.output_tokens = req["output_len"] if res.success else 0
    except HTTPStatusError as e:
        res.error = str(e)
    except (OSError, ValueError, IndexError, ClientError,
            asyncio.IncompleteReadError) as e:
        res.error = str(e) or type(e).__name__
    return res


async def run_benchmark(args) -> dict:
    requests = build_requests(args)
    sem = asyncio.Semaphore(args.max_concurrency or len(requests))
    results: List[Optional[RequestResult]] = [None] * len(requests)

    async def worker(i):
        async with sem:
            try:
                results[i] = await asyncio.wait_for(
                    one_request(args, requests[i]), args.timeout)
            except asyncio.TimeoutError:
                results[i] = RequestResult(
                    prompt_len=requests[i]["prompt_len"],
                    error=f"timed out after {args.timeout} s")

    t_start = time.perf_counter()
    tasks = []
    async for i in arrival_times(len(requests), args.request_rate,
                                 args.burstiness):
        tasks.append(asyncio.create_task(worker(i)))
    await asyncio.gather(*tasks)
    duration = time.perf_counter() - t_start
    return compute_metrics(args, [r for r in results if r], duration)


def _pct(vals, scale=1e3):
    if not vals:
        return {}
    a = np.asarray(vals) * scale
    out = {"mean": float(a.mean()), "median": float(np.median(a)),
           "std": float(a.std())}
    for p in (50, 90, 95, 99):
        out[f"p{p}"] = float(np.percentile(a, p))
    return {k: round(v, 3) for k, v in out.items()}


def compute_metrics(args, results: List[RequestResult],
                    duration: float) -> dict:
    ok = [r for r in results if r.success]
    out_toks = sum(r.output_tokens for r in ok)
    total_toks = out_toks + sum(r.prompt_len for r in ok)
    tpots = [(r.e2e - r.ttft) / (r.output_tokens - 1)
             for r in ok if r.output_tokens > 1]
    itls = [v for r in ok for v in r.itl]
    # goodput: requests meeting every SLO, per second
    goodput = None
    if args.goodput:
        slos = dict(kv.split(":") for kv in args.goodput.split(","))

        def meets(r):
            if "ttft" in slos and r.ttft * 1e3 > float(slos["ttft"]):
                return False
            if "e2e" in slos and r.e2e * 1e3 > float(slos["e2e"]):
                return False
            if "tpot" in slos and r.output_tokens > 1 and \
                    (r.e2e - r.ttft) / (r.output_tokens - 1) * 1e3 \
                    > float(slos["tpot"]):
                return False
            return True
        goodput = round(sum(map(meets, ok)) / duration, 3)
    m = {
        "completed": len(ok),
        "failed": len(results) - len(ok),
        "duration_s": round(duration, 3),
        "request_throughput": round(len(ok) / duration, 3),
        "output_token_throughput": round(out_toks / duration, 3),
        "total_token_throughput": round(total_toks / duration, 3),
        "ttft_ms": _pct([r.ttft for r in ok]),
        "tpot_ms": _pct(tpots),
        "itl_ms": _pct(itls),
        "e2e_ms": _pct([r.e2e for r in ok]),
        "max_concurrency": args.max_concurrency,
        "request_rate": (None if args.request_rate == float("inf")
                         else args.request_rate),
    }
    if goodput is not None:
        m["request_goodput"] = goodput
    errs = [r.error for r in results if r.error]
    if errs:
        m["errors"] = errs[:5]
    return m


def print_report(m: dict):
    print("=" * 56)
    print("{:<40}{:>16}".format("Successful requests:", m["completed"]))
    print("{:<40}{:>16}".format("Benchmark duration (s):", m["duration_s"]))
    print("{:<40}{:>16}".format("Request throughput (req/s):",
                                m["request_throughput"]))
    print("{:<40}{:>16}".format("Output token throughput (tok/s):",
                                m["output_token_throughput"]))
    print("{:<40}{:>16}".format("Total token throughput (tok/s):",
                                m["total_token_throughput"]))
    for name, key in (("TTFT", "ttft_ms"), ("TPOT", "tpot_ms"),
                      ("ITL", "itl_ms"), ("E2E", "e2e_ms")):
        d = m.get(key) or {}
        if not d:
            continue
        print("-" * 20 + f" {name} (ms) " + "-" * 20)
        print("{:<40}{:>16}".format(f"Mean {name}:", d["mean"]))
        print("{:<40}{:>16}".format(f"Median {name}:", d["median"]))
        print("{:<40}{:>16}".format(f"P99 {name}:", d["p99"]))
    print("=" * 56)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Benchmark a running trtllm-torch-serve endpoint")
    ap.add_argument("--base-url", default="http://localhost:8000")
    ap.add_argument("--endpoint", default="/v1/completions")
    ap.add_argument("--model", default="model")
    ap.add_argument("--dataset", help="JSONL rows: {prompt|input_ids, "
                    "output_len}")
    ap.add_argument("--num-prompts", type=int, default=64)
    ap.add_argument("--input-len", type=int, default=128)
    ap.add_argument("--output-len", type=int, default=128)
    ap.add_argument("--request-rate", type=float, default=float("inf"),
                    help="req/s arrival rate (inf = all at once)")
    ap.add_argument("--burstiness", type=float, default=1.0,
                    help="gamma burstiness; 1.0 = Poisson")
    ap.add_argument("--max-concurrency", type=int, default=None)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--goodput", help="SLOs, e.g. ttft:200,e2e:2000 (ms)")
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--save-result", help="write metrics JSON here")
    args = ap.parse_args(argv)

    m = asyncio.run(run_benchmark(args))
    print_report(m)
    print(json.dumps(m))
    if args.save_result:
        with open(args.save_result, "w") as f:
            json.dump(m, f, indent=2)
    return m


if __name__ == "__main__":
    main()
