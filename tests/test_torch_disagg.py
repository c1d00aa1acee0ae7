"""The port's disaggregated serving against the JAX package's, on the CPU at
a tiny size (`llmapi/disagg_params.py`, `runtime/model_engine.py`'s extract
and inject, `runtime/executor.py`'s context-only and generation-only paths).

* Wire format: the port's payload and frame bytes equal the JAX package's
  for the same arrays (bf16 at D 128, INT8 with scales), and each side
  reads the other's.
* A JAX context-only payload read by the port (bf16 at D 64, where the JAX
  pools are lane-packed, at D 128, and INT8 with its scales) gives the JAX
  single instance's greedy tokens on a port generation worker (equal, or
  first different at a near-tie of the port's logits, `TIE`).
* Port to port: INT8 and MLA + DSA (latent and indexer pools) transfers
  give the single instance's tokens; a payload that does not fit the pools
  raises at submit, and as frames ends its request with an error.
* Streamed frames leave while later prefill chunks still run; a seeded and
  a penalised request through disagg give the single instance's tokens; a
  context-only request in a batch with the overlap pipeline full captures
  the same pages as alone.
* Faults of the JAX package not copied: shutdown resolves a receiving
  request, a receiving request keeps `release_memory` refused, a receive
  has a deadline, and the streamed context route looks at its frame queue
  once more before it declares a failure.
* The port's modules import with `jax`, `aiohttp` and `ml_dtypes` blocked.
"""

import os
import queue
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorrt_llm_tpu as J
from tensorrt_llm_tpu.llmapi import disagg_params as jdp
from tensorrt_llm_tpu.models.modeling_utils import ModelConfig as JCfg
import tensorrt_llm_tpu_torch as T
from tensorrt_llm_tpu_torch.llmapi.disagg_params import (
    DisaggregatedParams, frame_from_bytes, frame_to_bytes, leaves,
    payload_from_bytes, payload_to_bytes)
from tensorrt_llm_tpu_torch.models import ModelConfig, params_from_jax
from tensorrt_llm_tpu_torch.quantization import (
    KvCacheQuantAlgo, QuantAlgo, QuantConfig)
from tensorrt_llm_tpu_torch.runtime import executor as pexec
from tensorrt_llm_tpu_torch.runtime.request import FinishReason, LlmRequest
from tensorrt_llm_tpu_torch.serve.disagg_server import next_frame

from torch_parity import jax_generate, port_logits

ROOT = Path(__file__).resolve().parents[1]
TIE = 0.02   # ~2 bf16 ulps of the largest logits
SHAPE = dict(vocab_size=256, hidden_size=256, intermediate_size=512,
             num_layers=2, num_kv_heads=2, max_position=256)
HEADS = {64: 8, 128: 4}          # head_dim -> num_heads
LLM_KW = dict(skip_tokenizer_init=True, max_seq_len=160, max_batch_size=4,
              max_num_tokens=48, kv_num_blocks=96, kv_block_size=8,
              max_decode_steps=4)
GREEDY = dict(max_tokens=8, temperature=0.0, ignore_eos=True)


def _prompt(seed, n=37):
    return [int(t) for t in np.random.RandomState(seed).randint(1, 255, n)]


def _bf16_np(x):
    return np.asarray(jnp.asarray(x, jnp.bfloat16))


def _assert_tokens(cfg, params, prompt, want, got, kv_quant="NONE"):
    """Equal, or first different where both tokens are within `TIE` of the
    port's top logit (teacher forced on the wanted tokens)."""
    assert len(got) == len(want)
    if got == want:
        return
    i = next(i for i, (a, b) in enumerate(zip(want, got)) if a != b)
    lg = port_logits(cfg, params, prompt + want[:i], kv_quant=kv_quant)
    top = lg.max()
    assert lg[want[i]] >= top - TIE and lg[got[i]] >= top - TIE, (
        f"token {i} differs without a near-tie: {want} vs {got}")


# ----------------------------------------------------------- wire format --
def _layers(kind, rng):
    """One layer's leaves as (JAX numpy leaves, port torch leaves)."""
    if kind == "bf16":
        k, v = (_bf16_np(rng.normal(size=(3, 2, 8, 128))) for _ in range(2))
        return (k, v), tuple(
            torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
            for a in (k, v))
    q = [rng.randint(-127, 128, (3, 2, 8, 128)).astype(np.int8)
         for _ in range(2)]
    s = [rng.rand(3, 2, 8).astype(np.float32) for _ in range(2)]
    jl = ((q[0], s[0]), (q[1], s[1]))
    return jl, tuple((torch.from_numpy(a), torch.from_numpy(b))
                     for a, b in zip(q, s))


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_payload_bytes_equal_jax(kind):
    rng = np.random.RandomState(0)
    pairs = [_layers(kind, rng) for _ in range(2)]
    jlayers = [p[0] for p in pairs]
    tlayers = [p[1] for p in pairs]
    jpay = {"layers": jlayers, "num_tokens": 19, "block_size": 8}
    tpay = {"layers": tlayers, "num_tokens": 19, "block_size": 8}
    jbytes = jdp.payload_to_bytes(jpay)
    assert payload_to_bytes(tpay) == jbytes
    back = payload_from_bytes(jbytes)        # the port reads JAX's bytes
    assert back["num_tokens"] == 19 and back["block_size"] == 8
    jback = jdp.payload_from_bytes(payload_to_bytes(tpay))
    flat_t = list(leaves(tlayers))
    flat_b = list(leaves(back["layers"]))
    flat_j = [np.asarray(a) for a in jax.tree.leaves(jback["layers"])]
    assert len(flat_t) == len(flat_b) == len(flat_j)
    for t, b, j in zip(flat_t, flat_b, flat_j):
        assert b.dtype == t.dtype and torch.equal(b, t)
        if t.dtype == torch.bfloat16:
            np.testing.assert_array_equal(
                j.view(np.int16), t.view(torch.int16).numpy())
        else:
            np.testing.assert_array_equal(j, t.numpy())


@pytest.mark.parametrize("frame", ["kv", "end", "error"])
def test_frame_bytes_equal_jax(frame):
    jl, tl = _layers("bf16", np.random.RandomState(1))
    if frame == "kv":
        jf, tf = ({"start_block": 2, "layers": [jl, jl]},
                  {"start_block": 2, "layers": [tl, tl]})
    elif frame == "end":
        jf = tf = {"end": True, "num_tokens": 40, "block_size": 8,
                   "first_gen_tokens": [7]}
    else:
        jf = tf = {"end": True, "error": "prefill failed"}
    jb = jdp.frame_to_bytes(jf)
    assert frame_to_bytes(tf) == jb
    back = frame_from_bytes(jb)
    assert {k: v for k, v in back.items() if k != "layers"} == {
        k: v for k, v in tf.items() if k != "layers"}
    if frame == "kv":
        assert torch.equal(back["layers"][1][0], tl[0])
    with pytest.raises(ValueError, match="version"):
        frame_from_bytes(_bump_version(jb))


def _bump_version(data):
    import json
    h = int.from_bytes(data[:8], "little")
    spec = json.loads(data[8:8 + h])
    spec["v"] = 2
    head = json.dumps(spec).encode()
    return len(head).to_bytes(8, "little") + head + data[8 + h:]


def test_payload_roundtrip_structures():
    kv = {"layers": [(torch.ones(2, 2, 8, 16), torch.zeros(2, 2, 8, 16))] * 2,
          "num_tokens": 11, "block_size": 8}
    back = payload_from_bytes(payload_to_bytes(kv))
    assert back["num_tokens"] == 11 and back["block_size"] == 8
    assert len(back["layers"]) == 2
    assert torch.equal(back["layers"][0][0], kv["layers"][0][0])


# ----------------------------------------------------- JAX payload -> port --
def _jax_case(kind):
    """(JAX config, port config, LLM kwargs of both, port kv_quant)."""
    if kind == "int8":
        shape = dict(SHAPE, num_heads=8, head_dim=64)
        return (JCfg(**shape), ModelConfig(**shape, quant=QuantConfig(
            quant_algo=QuantAlgo.W4A8_AWQ,
            kv_cache_quant_algo=KvCacheQuantAlgo.INT8)),
            dict(quant_algo="W4A8_AWQ", kv_cache_quant="INT8"), "INT8")
    D = 64 if kind == "bf16_d64" else 128
    shape = dict(SHAPE, num_heads=HEADS[D], head_dim=D)
    return JCfg(**shape), ModelConfig(**shape), {}, "NONE"


@pytest.mark.parametrize("kind", ["bf16_d64", "bf16_d128", "int8"])
def test_jax_payload_into_port(kind, monkeypatch):
    """A JAX context worker's payload, over the wire, injected into a port
    generation worker, decodes the JAX single instance's greedy tokens."""
    monkeypatch.setenv("TLLM_KV_BOOKKEEPING", "python")
    jcfg, tcfg, kw, kvq = _jax_case(kind)
    prompt = _prompt(3)
    jl = J.LLM(model=jcfg, **LLM_KW, **kw)
    try:
        params = params_from_jax(jax.tree.map(np.asarray, jl.engine.params))
        want = jax_generate(jl, [prompt], J.SamplingParams(**GREEDY))[0]
        _, dp = jl.generate_context_only(
            prompt, J.SamplingParams(temperature=0.0, ignore_eos=True))
        leaf = jax.tree.leaves(dp.kv_payload["layers"][0])[0]
        if kind == "bf16_d64":   # the JAX pools are lane-packed at D 64
            assert leaf.shape[-1] == 128 and leaf.shape[-2] == 4
        blob = jdp.payload_to_bytes(dp.kv_payload)
        first = list(dp.first_gen_tokens)
    finally:
        jl.shutdown()
    assert first == want[:1]
    tl = T.LLM(model=tcfg, device="cpu", params=params,
               kv_cache_quant=kvq, **LLM_KW)
    try:
        got = tl.generate_async(prompt, T.SamplingParams(**GREEDY),
                                disaggregated_params=DisaggregatedParams(
                                    request_type="generation_only",
                                    first_gen_tokens=first,
                                    kv_payload=payload_from_bytes(blob))
                                ).result(timeout=120).outputs[0].token_ids
        stats = tl.get_stats()
        kv = tl.get_kv_cache_stats()
    finally:
        tl.shutdown()
    _assert_tokens(tcfg, params, prompt, want, got, kvq)
    # the prompt was injected, not recomputed, and nothing leaked
    assert sum(s["num_prefill_tokens"] for s in stats) == 0
    assert kv["active_sequences"] == 0


# ------------------------------------------------------------ port -> port --
def _port_cfg(kind):
    if kind == "int8":
        return ModelConfig(**dict(SHAPE, num_heads=8, head_dim=64),
                           quant=QuantConfig(
                               quant_algo=QuantAlgo.W4A8_AWQ,
                               kv_cache_quant_algo=KvCacheQuantAlgo.INT8)), \
            "INT8"
    from test_torch_deepseek import V32_TINY as hf
    return ModelConfig.from_hf_config(hf, quant=QuantConfig(
        quant_algo=QuantAlgo.W4A16, group_size=64)), "NONE"


def _port_llm(cfg, kvq, seed=3, **kw):
    args = dict(LLM_KW, **kw)
    return T.LLM(model=cfg, device="cpu", seed=seed, kv_cache_quant=kvq,
                 kv_bookkeeping="python", **args)


@pytest.mark.parametrize("kind", ["int8", "mla_dsa"])
def test_port_to_port_transfer(kind):
    """INT8 (data and scales) and MLA + DSA (latent and indexer pools)
    pages move between two port workers; the decode equals the single
    instance's, token for token, whole and streamed."""
    cfg, kvq = _port_cfg(kind)
    V = cfg.vocab_size
    prompt = [int(t) for t in np.random.RandomState(5).randint(1, V - 1, 37)]
    sp = T.SamplingParams(**GREEDY)
    ctx, gen = _port_llm(cfg, kvq, max_num_tokens=16), _port_llm(cfg, kvq)
    try:
        want = gen.generate([prompt], sp)[0].outputs[0].token_ids
        _, dp = ctx.generate_context_only(prompt, T.SamplingParams(
            temperature=0.0, ignore_eos=True))
        # (data, scales) of K and V / (latent, indexer keys)
        assert len(list(leaves(dp.kv_payload["layers"][0]))) == \
            (4 if kind == "int8" else 2)
        dp.kv_payload = payload_from_bytes(payload_to_bytes(dp.kv_payload))
        got = gen.generate_async(prompt, sp, disaggregated_params=dp
                                 ).result(timeout=120).outputs[0].token_ids
        fut, frames = ctx.generate_context_only_streamed(
            prompt, T.SamplingParams(temperature=0.0, ignore_eos=True))
        rx = queue.Queue()
        gfut = gen.generate_async(prompt, sp, disaggregated_params=(
            DisaggregatedParams(request_type="generation_only",
                                kv_frames=rx)))
        while True:
            f = frames.get(timeout=60)
            rx.put(frame_from_bytes(frame_to_bytes(f)))
            if f.get("end"):
                break
        streamed = gfut.result(timeout=120).outputs[0].token_ids
        fut.result(timeout=60)
    finally:
        ctx.shutdown()
        gen.shutdown()
    assert got == want and streamed == want


def test_mismatched_payload_raises():
    """A payload whose leaves do not fit the pools (INT8 pages into bf16
    pools, a layer short) is refused at submit; as frames, it ends only its
    request, with an error."""
    cfg8, _ = _port_cfg("int8")
    prompt = _prompt(6, 20)
    ctx = _port_llm(cfg8, "INT8")
    gen = _port_llm(ModelConfig(**dict(SHAPE, num_heads=8, head_dim=64)),
                    "NONE")
    try:
        _, dp = ctx.generate_context_only(prompt)
        with pytest.raises(ValueError, match="int8|leaves"):
            gen.generate_async(prompt, T.SamplingParams(max_tokens=4),
                               disaggregated_params=dp)
        short = DisaggregatedParams(
            request_type="generation_only", first_gen_tokens=[1],
            kv_payload=dict(dp.kv_payload,
                            layers=dp.kv_payload["layers"][:1]))
        with pytest.raises(ValueError, match="layers"):
            gen.generate_async(prompt, T.SamplingParams(max_tokens=4),
                               disaggregated_params=short)
        rx = queue.Queue()
        rx.put({"start_block": 0, "layers": dp.kv_payload["layers"]})
        fut = gen.generate_async(prompt, T.SamplingParams(max_tokens=4),
                                 disaggregated_params=DisaggregatedParams(
                                     request_type="generation_only",
                                     kv_frames=rx))
        with pytest.raises(RuntimeError, match="kv stream"):
            fut.result(timeout=60)
        ok = gen.generate([prompt], T.SamplingParams(max_tokens=4))[0]
        assert len(ok.outputs[0].token_ids) == 4     # the loop lives on
        assert gen.get_kv_cache_stats()["active_sequences"] == 0
    finally:
        ctx.shutdown()
        gen.shutdown()


# --------------------------------------------------------------- streaming --
def _bf16_cfg():
    return ModelConfig(**dict(SHAPE, num_heads=8, head_dim=64))


def test_streamed_frames_overlap_prefill():
    """Frames leave while later prefill chunks still run, start at block 0
    in order, and the streamed receive decodes the single instance's
    tokens."""
    cfg = _bf16_cfg()
    prompt = _prompt(11, 40)
    sp = T.SamplingParams(**GREEDY)
    ctx = _port_llm(cfg, "NONE", max_num_tokens=16)
    gen = _port_llm(cfg, "NONE")
    try:
        want = gen.generate([prompt], sp)[0].outputs[0].token_ids
        fut, frames = ctx.generate_context_only_streamed(
            prompt, T.SamplingParams(temperature=0.0, ignore_eos=True))
        first = frames.get(timeout=60)
        overlap = fut.req.end_time is None   # set only at the finish
        received = [first]
        while not received[-1].get("end"):
            received.append(frames.get(timeout=60))
        fut.result(timeout=60)
        assert overlap, "the first frame came only after the prefill"
        kv_frames = [f for f in received if not f.get("end")]
        starts = [f["start_block"] for f in kv_frames]
        assert len(kv_frames) >= 3 and starts == sorted(starts)
        assert starts[0] == 0
        end = received[-1]
        assert end["first_gen_tokens"] == want[:1]
        assert end["num_tokens"] == len(prompt)
        rx = queue.Queue()
        for f in received:
            rx.put(frame_from_bytes(frame_to_bytes(f)))
        got = gen.generate_async(prompt, sp, disaggregated_params=(
            DisaggregatedParams(request_type="generation_only",
                                kv_frames=rx))).result(timeout=120)
        assert got.outputs[0].token_ids == want
        assert ctx.get_kv_cache_stats()["active_sequences"] == 0
    finally:
        ctx.shutdown()
        gen.shutdown()


@pytest.mark.parametrize("params", [
    dict(max_tokens=10, temperature=0.8, top_k=20, seed=7),
    dict(max_tokens=10, temperature=0.0, repetition_penalty=1.5,
         presence_penalty=0.7, frequency_penalty=0.3, ignore_eos=True),
], ids=["seeded", "penalised"])
def test_sampled_request_through_disagg(params):
    """The generation worker's sampling state starts from the prompt plus
    the transferred token: a seeded and a penalised request give the single
    instance's tokens."""
    cfg = _bf16_cfg()
    prompt = _prompt(12, 30)
    ctx, gen = _port_llm(cfg, "NONE"), _port_llm(cfg, "NONE")
    try:
        want = gen.generate([prompt], T.SamplingParams(**params)
                            )[0].outputs[0].token_ids
        _, dp = ctx.generate_context_only(prompt, T.SamplingParams(**params))
        got = gen.generate_async(prompt, T.SamplingParams(**params),
                                 disaggregated_params=dp
                                 ).result(timeout=120).outputs[0].token_ids
    finally:
        ctx.shutdown()
        gen.shutdown()
    assert len(set(want)) > 1 and got == want


def test_context_only_with_full_pipeline():
    """A context-only request admitted while decode chunks are in flight
    (`_force_lag`: results never land early) captures the same pages as
    the same prompt alone, and frees its blocks."""
    cfg = _bf16_cfg()
    prompt = _prompt(13, 29)
    alone = _port_llm(cfg, "NONE")
    busy = _port_llm(cfg, "NONE")
    try:
        greedy = T.SamplingParams(temperature=0.0)
        _, ref = alone.generate_context_only(prompt, greedy)
        busy.executor._force_lag = True
        long = busy.generate_async(_prompt(14, 9), T.SamplingParams(
            max_tokens=40, ignore_eos=True))
        while len(busy.executor._inflight) < 2:
            time.sleep(0.001)
        _, dp = busy.generate_context_only(prompt, greedy)
        long.result(timeout=120)
        assert busy.get_kv_cache_stats()["active_sequences"] == 0
    finally:
        alone.shutdown()
        busy.shutdown()
    assert dp.first_gen_tokens == ref.first_gen_tokens
    for a, b in zip(leaves(dp.kv_payload["layers"]),
                    leaves(ref.kv_payload["layers"])):
        assert torch.equal(a, b)


def test_ctx_pool_is_clean_after_transfer():
    ctx = _port_llm(_bf16_cfg(), "NONE")
    try:
        before = ctx.get_kv_cache_stats()
        _, dp = ctx.generate_context_only([1, 2, 3, 4, 5, 6, 7, 8, 9])
        after = ctx.get_kv_cache_stats()
        assert after["active_sequences"] == 0
        assert after["free_blocks"] + after["evictable_blocks"] == \
            before["free_blocks"] + before["evictable_blocks"]
        assert dp.kv_payload["num_tokens"] == 9
        assert len(dp.kv_payload["layers"]) == 2
    finally:
        ctx.shutdown()


# ------------------------------------------------ faults not copied (JAX) --
def _receiving(gen, prompt):
    rx = queue.Queue()
    fut = gen.generate_async(prompt, T.SamplingParams(max_tokens=4),
                             disaggregated_params=DisaggregatedParams(
                                 request_type="generation_only",
                                 kv_frames=rx))
    deadline = time.time() + 30
    while not gen.executor._receiving:
        assert time.time() < deadline
        time.sleep(0.005)
    return fut, rx


def test_shutdown_resolves_a_receiving_request():
    """JAX `shutdown()` leaves `_receiving` unresolved (executor.py:203)."""
    gen = _port_llm(_bf16_cfg(), "NONE")
    fut, _ = _receiving(gen, _prompt(15, 20))
    gen.shutdown()
    with pytest.raises(RuntimeError, match="kv receive"):
        fut.result(timeout=10)


def test_receiving_request_keeps_the_executor_busy():
    """JAX `_step` counts a receiving-only request as idle (executor.py:
    484): here it is in flight, so the weights cannot be released under
    it."""
    gen = _port_llm(_bf16_cfg(), "NONE")
    try:
        fut, rx = _receiving(gen, _prompt(15, 20))
        with pytest.raises(RuntimeError, match="in flight"):
            gen.release_memory()
        fut.cancel()
        assert fut.result(timeout=30).outputs[0].finish_reason == \
            "cancelled"
        assert gen.get_kv_cache_stats()["active_sequences"] == 0
    finally:
        gen.shutdown()


def test_receive_deadline(monkeypatch):
    """JAX `_receiving` has no deadline (executor.py:376-442): a receive
    without an end frame ends with an error after `RECEIVE_DEADLINE_S`."""
    monkeypatch.setattr(pexec, "RECEIVE_DEADLINE_S", 0.3)
    gen = _port_llm(_bf16_cfg(), "NONE")
    try:
        fut, _ = _receiving(gen, _prompt(16, 20))
        with pytest.raises(RuntimeError, match="no end frame"):
            fut.result(timeout=30)
        assert gen.get_kv_cache_stats()["active_sequences"] == 0
    finally:
        gen.shutdown()


class _LateQueue(queue.Queue):
    """A frame queue whose frame lands just after the first wait timed
    out (the window between a request's finish and its end frame)."""

    def __init__(self, frame):
        super().__init__()
        self.frame = frame

    def get(self, block=True, timeout=None):
        if self.frame is not None:
            frame, self.frame = self.frame, None
            self.put(frame)
            raise queue.Empty
        return super().get(block, timeout)


def test_next_frame_looks_again_before_failing():
    """JAX `serve/disagg_server.py:481-505` sends "prefill failed" when the
    request reads as finished before its end frame is queued; the port
    looks at the queue once more."""
    req = LlmRequest([1, 2, 3], T.SamplingParams())
    req.finish(FinishReason.LENGTH)        # finished, no payload yet
    end = {"end": True, "first_gen_tokens": [5], "num_tokens": 3,
           "block_size": 8}
    assert next_frame(req, _LateQueue(end), poll_s=0.01) == end
    # a real failure still reads as one
    out = next_frame(req, queue.Queue(), poll_s=0.01)
    assert out == {"end": True, "error": "prefill failed"}
    req2 = LlmRequest([1, 2, 3], T.SamplingParams())
    out = next_frame(req2, queue.Queue(), deadline_s=0.03, poll_s=0.01)
    assert out["error"] == "prefill timed out"


def test_failed_streamed_context_sends_an_error_frame():
    """A cancelled streamed context request ends its frame stream with an
    error frame (the receiver learns it at once)."""
    ctx = _port_llm(_bf16_cfg(), "NONE", max_num_tokens=8)
    try:
        fut, frames = ctx.generate_context_only_streamed(_prompt(17, 120))
        f = frames.get(timeout=30)       # after the first of 15 chunks
        fut.cancel()
        while not f.get("end"):
            f = frames.get(timeout=30)
        assert fut.result(timeout=30).outputs[0].finish_reason == \
            "cancelled"
    finally:
        ctx.shutdown()
    assert f == {"end": True, "error": "cancelled"}


def test_modules_import_without_jax_aiohttp_ml_dtypes():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'aiohttp', 'ml_dtypes', 'pydantic',\n"
        "          'tensorrt_llm_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import importlib, pkgutil, tensorrt_llm_tpu_torch as P\n"
        "for mod in pkgutil.walk_packages(P.__path__, P.__name__ + '.'):\n"
        "    importlib.import_module(mod.name)\n"
        "import chip_smoke\n"
        "from tensorrt_llm_tpu_torch.serve import disagg_server, http_client\n"
        "from tensorrt_llm_tpu_torch.llmapi import disagg_params\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'aiohttp', 'ml_dtypes', 'tensorrt_llm_tpu')\n"
        "       and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                       env=dict(os.environ, PYTHONPATH=str(ROOT)),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stderr
