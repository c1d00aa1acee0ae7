"""The port's HTTP load generator (`commands/benchmark_serving.py`):
`build_requests`, `arrival_times` and `compute_metrics` (goodput included)
give the JAX package's results on the same inputs, and one live run of
the port's asyncio client against the port's OpenAI server on the CPU
finishes every request, above the default thread pool's size."""

import asyncio
import json
import types

import numpy as np
import pytest

from tensorrt_llm_tpu.commands import benchmark_serving as J
from tensorrt_llm_tpu_torch.commands import benchmark_serving as P

TINY = dict(vocab_size=1024, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
            max_position=256)


def args(**kw):
    base = dict(dataset=None, num_prompts=5, input_len=16, output_len=8,
                seed=0, goodput=None, max_concurrency=4,
                request_rate=float("inf"))
    base.update(kw)
    return types.SimpleNamespace(**base)


@pytest.mark.parametrize("kw", [
    dict(), dict(num_prompts=9, input_len=3, output_len=40, seed=7),
    dict(num_prompts=0)], ids=["default", "seed7", "empty"])
def test_build_requests_synthetic_matches_jax(kw):
    assert P.build_requests(args(**kw)) == J.build_requests(args(**kw))


@pytest.mark.parametrize("limit", [0, 2])
def test_build_requests_dataset_matches_jax(tmp_path, limit):
    ds = tmp_path / "d.jsonl"
    ds.write_text('{"input_ids": [1,2,3], "output_len": 4}\n\n'
                  '{"prompt": "hello world", "output_len": 2}\n'
                  '{"prompt": "a b c"}\n')
    a = args(dataset=str(ds), num_prompts=limit)
    assert P.build_requests(a) == J.build_requests(a)


def results(cls, rng):
    out = []
    for i in range(12):
        ok = rng.random() > 0.2
        n = int(rng.integers(1, 9))
        out.append(cls(success=ok, error="" if ok else f"boom {i}",
                       prompt_len=int(rng.integers(1, 30)),
                       output_tokens=n if ok else 0,
                       ttft=float(rng.uniform(0.01, 0.6)),
                       itl=[float(x) for x in rng.uniform(0.001, 0.05, n - 1)],
                       e2e=float(rng.uniform(0.6, 2.0))))
    return out


@pytest.mark.parametrize("goodput", [None, "ttft:100,e2e:1000",
                                     "tpot:150", "ttft:300,tpot:200,e2e:1500"])
@pytest.mark.parametrize("seed", [0, 1])
def test_compute_metrics_matches_jax(goodput, seed):
    a = args(goodput=goodput, request_rate=float("inf") if seed else 4.0)
    jm = J.compute_metrics(a, results(J.RequestResult,
                                      np.random.default_rng(seed)), 1.7)
    pm = P.compute_metrics(a, results(P.RequestResult,
                                      np.random.default_rng(seed)), 1.7)
    assert pm == jm
    assert ("request_goodput" in pm) == (goodput is not None)


def test_arrival_times_match_jax():
    async def gaps(mod):
        out = []
        loop = asyncio.get_running_loop()
        t = loop.time()
        async for i in mod.arrival_times(4, 200.0, 0.5):
            out.append(i)
        return out, loop.time() - t

    np.random.seed(3)
    ja, _ = asyncio.run(gaps(J))
    np.random.seed(3)
    pa, _ = asyncio.run(gaps(P))
    assert pa == ja == [0, 1, 2, 3]


def test_print_report(capsys):
    m = P.compute_metrics(args(), results(P.RequestResult,
                                          np.random.default_rng(0)), 1.0)
    P.print_report(m)
    out = capsys.readouterr().out
    assert "Output token throughput (tok/s):" in out and "P99 ITL:" in out


STREAMS = {
    "done": (b'data: {"id": "a"}\n\ndata: {"id": "b"}\n\n'
             b"data: [DONE]\n\n", ""),
    "error_event": (b'data: {"id": "a"}\n\ndata: {"error": "boom"}\n\n',
                    "boom"),
    "no_done": (b'data: {"id": "a"}\n\ndata: {"id": "b"}\n\n',
                "stream ended without [DONE]"),
}


@pytest.mark.parametrize("kind", list(STREAMS))
def test_client_counts_broken_streams_as_failed(kind):
    """Intended difference from the JAX client: a stream with an ``error``
    event, or one that ends without ``[DONE]``, is a failed request with
    no tokens."""
    payload, error = STREAMS[kind]

    async def handle(reader, writer):
        while (await reader.readline()) not in (b"\r\n", b""):
            pass
        writer.write(b"HTTP/1.1 200 OK\r\nContent-Type: text/event-stream"
                     b"\r\nConnection: close\r\n\r\n" + payload)
        await writer.drain()
        writer.close()

    async def go():
        srv = await asyncio.start_server(handle, "127.0.0.1", 0)
        port = srv.sockets[0].getsockname()[1]
        a = types.SimpleNamespace(model="m", temperature=0.0,
                                  base_url=f"http://127.0.0.1:{port}",
                                  endpoint="/v1/completions")
        try:
            return await P.one_request(a, {"prompt": [1, 2], "output_len": 5,
                                           "prompt_len": 2})
        finally:
            srv.close()
            await srv.wait_closed()

    res = asyncio.run(go())
    assert res.error == error
    assert res.success == (not error)
    assert res.output_tokens == (0 if error else 5)
    assert res.chunks == (2 if kind != "error_event" else 1)


def test_live_run_against_port_server(tmp_path):
    import tensorrt_llm_tpu_torch as T
    from tensorrt_llm_tpu_torch.serve.openai_server import OpenAIServer

    llm = T.LLM(model=T.ModelConfig(**TINY), skip_tokenizer_init=True,
                device="cpu", max_seq_len=128, max_batch_size=48,
                kv_num_blocks=512, kv_block_size=8, kv_bookkeeping="python")
    st = OpenAIServer(llm, "tiny").start_in_thread()
    try:
        out = tmp_path / "m.json"
        m = P.main(["--base-url", f"http://127.0.0.1:{st.port}",
                    "--model", "tiny", "--num-prompts", "40",
                    "--input-len", "8", "--output-len", "6",
                    "--max-concurrency", "40", "--goodput", "ttft:60000",
                    "--save-result", str(out)])
        free = llm.get_kv_cache_stats()["free_blocks"]
        bad = P.main(["--base-url", f"http://127.0.0.1:{st.port}",
                      "--model", "tiny", "--num-prompts", "2",
                      "--input-len", "200", "--output-len", "4"])
    finally:
        st.stop()
        llm.shutdown()
    assert m["completed"] == 40 and m["failed"] == 0, m
    assert m["output_token_throughput"] > 0 and m["ttft_ms"]["mean"] > 0
    assert m["tpot_ms"] and m["e2e_ms"] and m["request_goodput"] > 0
    assert json.loads(out.read_text()) == m
    assert free > 0
    # prompts past max_seq_len: the server's 400 is each request's error
    assert bad["completed"] == 0 and bad["failed"] == 2
    assert bad["errors"][0].startswith("HTTP 400")
