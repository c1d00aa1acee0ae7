"""The port's bench CLI (`tensorrt_llm_tpu_torch.commands.bench`) against
the JAX package's (`tensorrt_llm_tpu.commands.bench`): the same synthetic
and dataset rows, the same per-request records and aggregates on the same
requests, and the JAX bench tests (`tests/test_bench_cli.py`) on the
port's CPU `LLM`: concurrency window, latency mode, dataset file, the
GPT-OSS preset's config-directory path.  A failed request is counted and
does not stop the run.
"""

import contextlib
import io
import json
import tempfile
import threading
import types

import numpy as np
import pytest

from tensorrt_llm_tpu.commands import bench as jbench
import tensorrt_llm_tpu_torch as T
from tensorrt_llm_tpu_torch.commands import bench
from tensorrt_llm_tpu_torch.models import ModelConfig

TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
            max_position=128)


@pytest.fixture(scope="module")
def llm():
    llm = T.LLM(model=ModelConfig(**TINY), device="cpu",
                skip_tokenizer_init=True, max_seq_len=64, max_batch_size=4,
                kv_num_blocks=128, kv_block_size=8)
    yield llm
    llm.shutdown()


@pytest.mark.parametrize("args", [(8, 6, 10, 128, 0), (128, 128, 32, 32000,
                                                        3), (1, 1, 1, 15, 1)])
def test_synthetic_requests_equal_jax(args):
    assert bench.synthetic_requests(*args) == jbench.synthetic_requests(
        *args)


def test_load_dataset_equals_jax(tmp_path):
    path = tmp_path / "ds.jsonl"
    with open(path, "w") as f:
        for i in range(5):
            f.write(json.dumps({"input_ids": [1, 2, 3, 4 + i],
                                "output_tokens": 4 + i}) + "\n")
        f.write("\n")
        f.write(json.dumps({"prompt": "ab c"}) + "\n")
    tok = types.SimpleNamespace(encode=lambda s: [ord(c) for c in s])
    for n in (0, 2, 6):
        assert bench.load_dataset(str(path), tok, n) == \
            jbench.load_dataset(str(path), tok, n)
    rows = bench.load_dataset(str(path), tok)
    assert rows[0] == ([1, 2, 3, 4], 4) and rows[-1] == (
        [97, 98, 32, 99], 128)
    with pytest.raises(ValueError):
        bench.load_dataset(str(path), None)


def test_pctl_equals_jax():
    rng = np.random.RandomState(0)
    for n in (1, 2, 7, 100):
        v = list(rng.exponential(0.05, n))
        for scale in (1.0, 1e3):
            assert bench._pctl(v, scale) == jbench._pctl(v, scale)
    assert bench._pctl([]) is None and jbench._pctl([]) is None


def _fake_request(rng, n_in):
    t0 = 1000.0 + rng.rand()
    n_out = int(rng.randint(1, 12))
    times, t, n = [], t0 + rng.rand() * 0.1, 0
    while n < n_out:
        n = min(n_out, n + int(rng.randint(1, 4)))
        t += rng.rand() * 0.02
        times.append((n, t))
    return types.SimpleNamespace(
        arrival_time=t0, first_token_time=times[0][1], end_time=t,
        output_token_ids=[0] * n_out, token_times=times, prompt_len=n_in)


def test_request_stats_and_aggregate_equal_jax():
    """On the same requests (timestamps and per-emit token times) the
    per-request records and the report's aggregates are equal."""
    rng = np.random.RandomState(1)
    reqs = [_fake_request(rng, int(rng.randint(1, 50))) for _ in range(23)]
    mine = [bench._request_stats(r, 8) for r in reqs]
    theirs = [jbench._request_stats(r, 8) for r in reqs]
    assert mine == theirs
    for wall, chips in ((1.7, 1), (0.31, 4)):
        assert bench._aggregate(mine, wall, chips) == \
            jbench._aggregate(theirs, wall, chips)


def test_report_of_a_served_run_equals_jax_aggregate(llm):
    """The port's report of a real run equals the JAX package's
    aggregate computed over the same served requests."""
    reqs = bench.synthetic_requests(8, 6, 6, TINY["vocab_size"])
    kept = []
    orig = llm.generate_async

    def keep(*a, **kw):
        fut = orig(*a, **kw)
        kept.append(fut.req)
        return fut

    llm.generate_async = keep
    try:
        rep = bench.run_throughput(llm, reqs, concurrency=3, warmup=False)
    finally:
        llm.generate_async = orig
    agg = jbench._aggregate([jbench._request_stats(r, 6) for r in kept],
                            rep["wall_s"], 1)
    for key in ("num_requests", "output_tokens", "ttft_ms", "tpot_ms",
                "itl_ms", "request_latency_ms"):
        assert rep[key] == agg[key], key
    assert all(r.token_times and r.token_times[-1][0] == 6 for r in kept)


def test_throughput_report_and_concurrency(llm):
    reqs = bench.synthetic_requests(8, 6, 10, TINY["vocab_size"])
    rep = bench.run_throughput(llm, reqs, concurrency=3, warmup=False)
    assert rep["output_tokens"] == 60 and rep["num_requests"] == 10
    assert rep["concurrency"] == 3 and rep["num_failed"] == 0
    assert rep["output_tokens_per_sec"] > 0
    assert rep["output_tokens_per_sec_per_chip"] > 0
    for key in ("ttft_ms", "tpot_ms", "itl_ms", "request_latency_ms"):
        stats = rep[key]
        assert stats is None or {"avg", "p50", "p99"} <= set(stats)
    assert rep["ttft_ms"]["p99"] < rep["wall_s"] * 1e3


def test_concurrency_window_bounds_inflight(llm):
    reqs = bench.synthetic_requests(8, 8, 6, TINY["vocab_size"])
    seen, live, lock = [], set(), threading.Lock()
    orig = llm.generate_async

    def tracked(prompt, sp=None, **kw):
        fut = orig(prompt, sp, **kw)
        with lock:
            live.add(fut.req.request_id)
            seen.append(len(live))
        res = fut.result

        def result(*a, **k):
            out = res(*a, **k)
            with lock:
                live.discard(fut.req.request_id)
            return out
        fut.result = result
        return fut

    llm.generate_async = tracked
    try:
        bench.run_throughput(llm, reqs, concurrency=2, warmup=False)
    finally:
        llm.generate_async = orig
    assert max(seen) <= 2, seen


def test_latency_mode(llm):
    reqs = bench.synthetic_requests(4, 5, 3, TINY["vocab_size"])
    rep = bench.run_latency(llm, reqs, warmup=True)
    assert rep["mode"] == "latency" and rep["num_requests"] == 3
    assert rep["tpot_ms"] and rep["tpot_ms"]["avg"] > 0
    assert rep["itl_ms"] and rep["itl_ms"]["p50"] > 0


def test_dataset_file(tmp_path, llm):
    path = tmp_path / "ds.jsonl"
    with open(path, "w") as f:
        for i in range(5):
            f.write(json.dumps({"input_ids": [1, 2, 3, 4 + i],
                                "output_tokens": 4}) + "\n")
    rows = bench.load_dataset(str(path), None)
    assert len(bench.load_dataset(str(path), None, max_requests=2)) == 2
    rep = bench.run_throughput(llm, rows, concurrency=2, warmup=False)
    assert rep["output_tokens"] == 20


def test_failed_requests_end_the_run(llm):
    """One request refused at submission (longer than max_seq_len) and one
    whose result raises: both are counted with their errors, their window
    places are released, and the other requests are reported."""
    reqs = bench.synthetic_requests(8, 5, 6, TINY["vocab_size"])
    reqs[2] = (list(range(1, 80)), 5)
    orig = llm.generate_async
    calls = [0]

    def flaky(*a, **kw):
        fut = orig(*a, **kw)
        calls[0] += 1
        if calls[0] == 4:
            def boom(*_a, **_k):
                raise RuntimeError("generation failed: injected")
            fut.result = boom
        return fut

    llm.generate_async = flaky
    done = threading.Event()
    box = {}

    def run():
        box["rep"] = bench.run_throughput(llm, reqs, concurrency=1,
                                          warmup=False)
        done.set()

    try:
        threading.Thread(target=run, daemon=True).start()
        assert done.wait(120), "the run did not end"
    finally:
        llm.generate_async = orig
    rep = box["rep"]
    assert rep["num_failed"] == 2 and len(rep["errors"]) == 2
    assert "ValueError" in rep["errors"][0]
    assert "injected" in rep["errors"][1]
    assert rep["num_requests"] == 4 and rep["output_tokens"] == 20


def test_unported_options_raise_with_module():
    args = types.SimpleNamespace(tp_size=2, device="cpu", quant=None,
                                 max_batch_size=4, max_seq_len=64, seed=0,
                                 dataset=None, kv_dtype=None,
                                 decode_steps=None, max_num_tokens=None,
                                 free_mem_fraction=None)
    with pytest.raises(NotImplementedError, match="parallel"):
        bench.llm_kwargs(args)
    # FP8 KV pools are in the port: --kv-dtype fp8 passes through
    args.tp_size, args.kv_dtype = 1, "fp8"
    assert bench.llm_kwargs(args)["kv_cache_quant"] == "FP8"
    args.kv_dtype = "int8"
    assert bench.llm_kwargs(args)["kv_cache_quant"] == "INT8"


def test_presets_equal_jax():
    assert bench.MODEL_SHAPES == jbench.MODEL_SHAPES


def test_gpt_oss_preset_config_path(monkeypatch, tmp_path):
    """The gpt-oss-20b preset goes through its HF config (from_hf_config
    -> the GPT-OSS model, random weights -> a bench run), here at a
    downsized copy of its config, and leaves no file behind."""
    small = dict(bench.MODEL_SHAPES["gpt-oss-20b"]["hf_config"])
    small.update(hidden_size=64, num_hidden_layers=2,
                 num_attention_heads=4, num_key_value_heads=2, head_dim=32,
                 intermediate_size=64, num_local_experts=4,
                 num_experts_per_tok=2, vocab_size=256, sliding_window=16,
                 layer_types=["sliding_attention", "full_attention"],
                 max_position_embeddings=256)
    small["rope_scaling"] = dict(small["rope_scaling"],
                                 original_max_position_embeddings=32)
    monkeypatch.setitem(bench.MODEL_SHAPES, "gpt-oss-20b",
                        {"quant_group_size": 32, "hf_config": small})
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        bench.main(["throughput", "--model", "gpt-oss-20b", "--device",
                    "cpu", "--quant", "W4A16", "--isl", "8", "--osl", "8",
                    "--num-requests", "2", "--concurrency", "2",
                    "--max-batch-size", "2", "--max-seq-len", "64"])
    out = buf.getvalue()
    report = json.loads(out[out.index("{"):])
    assert report["output_tokens"] == 16 and report["device"] == "cpu"
    assert "card" not in report
    assert list(tmp_path.iterdir()) == []


def test_latency_main_on_a_small_preset(monkeypatch, tmp_path):
    monkeypatch.setitem(bench.MODEL_SHAPES, "tinyllama-1.1b", TINY)
    path = tmp_path / "rep.json"
    with contextlib.redirect_stdout(io.StringIO()):
        bench.main(["latency", "--model", "tinyllama-1.1b", "--device",
                    "cpu", "--isl", "6", "--osl", "4", "--num-requests",
                    "2", "--max-seq-len", "64", "--report-json",
                    str(path)])
    rep = json.loads(path.read_text())
    assert rep["mode"] == "latency" and rep["output_tokens"] == 8
