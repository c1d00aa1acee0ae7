"""Port parity end to end: `LLM.generate` on the CPU gives the JAX `LLM`'s
greedy tokens on the same tiny W4A16 model and weights.

The traffic covers more requests than `max_batch_size` (requests queue),
prompts longer than the token budget (chunked prefill), two prompts sharing
a 40-token prefix (block reuse) and `max_decode_steps=4` (k-step decode).

Greedy tokens are compared exactly.  Should a token ever differ, the test
accepts it only at a near-tie: the port's logits for that position (teacher
forced on the JAX tokens) must rank both candidates within `TIE` of the top
logit -- a one-ulp bf16 difference upstream may legitimately flip such a
choice, and nothing after it is comparable.

The JAX side gets the whole batch before its first step and keeps its KV
bookkeeping in Python (`torch_parity.jax_generate`), so its schedule does not
depend on thread timing and it builds no native library while other test
processes may be building it.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import tensorrt_llm_tpu as J
from tensorrt_llm_tpu.models.modeling_utils import ModelConfig as JCfg
from tensorrt_llm_tpu.quantization import QuantAlgo as JQA
from tensorrt_llm_tpu.quantization import QuantConfig as JQC
import tensorrt_llm_tpu_torch as T
from tensorrt_llm_tpu_torch.models import ModelConfig, params_from_jax
from tensorrt_llm_tpu_torch.quantization import QuantAlgo, QuantConfig

from torch_parity import jax_generate, port_logits

ROOT = Path(__file__).resolve().parents[1]
TIE = 0.02   # ~2 bf16 ulps of the largest logits
SHAPE = dict(vocab_size=256, hidden_size=256, intermediate_size=512,
             num_layers=2, num_heads=8, num_kv_heads=2, head_dim=64,
             max_position=256)
LLM_KW = dict(skip_tokenizer_init=True, max_seq_len=160, max_batch_size=3,
              max_num_tokens=48, kv_num_blocks=96, kv_block_size=8,
              max_decode_steps=4)


def _tcfg():
    return ModelConfig(**SHAPE, quant=QuantConfig(quant_algo=QuantAlgo.W4A16,
                                                  group_size=128))


def _prompts():
    rng = np.random.RandomState(0)
    base = [int(t) for t in rng.randint(1, 255, 40)]
    return [base + [3, 4], [int(t) for t in rng.randint(1, 255, 17)],
            base + [9], [int(t) for t in rng.randint(1, 255, 70)],
            [int(t) for t in rng.randint(1, 255, 5)]]


def test_generate_matches_jax_greedy(monkeypatch):
    monkeypatch.setenv("TLLM_KV_BOOKKEEPING", "python")
    prompts = _prompts()
    jl = J.LLM(model=JCfg(**SHAPE, quant=JQC(quant_algo=JQA.W4A16,
                                              group_size=128)), **LLM_KW)
    try:
        params = params_from_jax(jax.tree.map(np.asarray, jl.engine.params))
        jout = jax_generate(jl, prompts, J.SamplingParams(
            max_tokens=12, temperature=0.0, ignore_eos=True))
    finally:
        jl.shutdown()
    tl = T.LLM(model=_tcfg(), device="cpu", params=params, **LLM_KW)
    try:
        tout = [o.outputs[0].token_ids for o in tl.generate(
            prompts, T.SamplingParams(max_tokens=12, temperature=0.0,
                                      ignore_eos=True))]
        stats = tl.get_kv_cache_stats()
        steps = [s["decode_steps"] for s in tl.get_stats()]
    finally:
        tl.shutdown()
    assert stats["reused_blocks"] > 0            # shared prefix was reused
    assert stats["active_sequences"] == 0
    assert max(steps) == 4                       # k-step decode ran
    exact = 0
    for p, a, b in zip(prompts, jout, tout):
        assert len(b) == len(a) == 12
        if a == b:
            exact += 1
            continue
        i = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        logits = port_logits(_tcfg(), params, p + a[:i])
        top = logits.max()
        assert logits[a[i]] >= top - TIE and logits[b[i]] >= top - TIE, (
            f"token {i} differs without a near-tie: jax {a[i]} "
            f"({logits[a[i]]}), port {b[i]} ({logits[b[i]]}), top {top}")
    assert exact >= 1          # at least one request matched token for token


def test_generate_is_deterministic_and_respects_limits():
    tl = T.LLM(model=_tcfg(), device="cpu", seed=3, **LLM_KW)
    try:
        sp = T.SamplingParams(max_tokens=6, temperature=0.0, ignore_eos=True)
        a = [o.outputs[0].token_ids for o in tl.generate(_prompts(), sp)]
        # results are delivered after the KV blocks are freed
        assert tl.get_kv_cache_stats()["active_sequences"] == 0
        b = [o.outputs[0].token_ids for o in tl.generate(_prompts(), sp)]
        assert a == b and all(len(t) == 6 for t in a)
        s = tl.generate([[5, 6, 7]], T.SamplingParams(
            max_tokens=5, temperature=0.8, top_k=20, top_p=0.9, seed=11))
        assert len(s[0].outputs[0].token_ids) == 5
        with pytest.raises(ValueError):
            tl.generate([list(range(1, 170))], sp)      # > max_seq_len
        # beam search runs: one request, one output per beam, best first
        beams = tl.generate([[1, 2]], T.SamplingParams(
            use_beam_search=True, n=2, max_tokens=4, ignore_eos=True))
        scores = [o.cumulative_logprob for o in beams[0].outputs]
        assert len(scores) == 2 and scores == sorted(scores, reverse=True)
        assert all(len(o.token_ids) == 4 for o in beams[0].outputs)
    finally:
        tl.shutdown()


def test_results_arrive_after_bookkeeping():
    """A finished result is delivered only after its KV sequence is freed
    and its iteration's stats are kept, so a caller reads settled state."""
    cfg = ModelConfig(vocab_size=64, hidden_size=64, intermediate_size=128,
                      num_layers=1, num_heads=2, num_kv_heads=1, head_dim=32,
                      max_position=64)
    tl = T.LLM(model=cfg, device="cpu", skip_tokenizer_init=True,
               max_seq_len=32, kv_num_blocks=16, kv_block_size=8)
    sp = T.SamplingParams(max_tokens=1, temperature=0.0, ignore_eos=True)
    try:
        for _ in range(30):
            tl.generate([[1, 2, 3]], sp)
            assert tl.get_kv_cache_stats()["active_sequences"] == 0
            assert tl.get_stats()[-1]["iteration"] == tl.executor.iteration
    finally:
        tl.shutdown()


def test_warmup_fits_a_pool_smaller_than_its_prompt():
    """The warmup's scratch prompt (min(max_num_tokens, max_seq_len - 1) =
    255 tokens) is capped at what the pool holds (16 blocks of 8), so the
    `LLM` builds, serves and gives the tokens it gives without warmup."""
    cfg = ModelConfig(**dict(SHAPE, num_layers=1),
                      quant=QuantConfig(quant_algo=QuantAlgo.W4A16,
                                        group_size=128))
    kw = dict(skip_tokenizer_init=True, max_seq_len=256, kv_num_blocks=16,
              kv_block_size=8, seed=2)
    sp = T.SamplingParams(max_tokens=6, temperature=0.0, ignore_eos=True)
    prompts = [[5, 6, 7, 8], list(range(1, 30))]
    out = {}
    for warm in (True, False):
        tl = T.LLM(model=cfg, device="cpu", enable_warmup=warm, **kw)
        try:
            out[warm] = [o.outputs[0].token_ids
                         for o in tl.generate(prompts, sp)]
            assert tl.get_kv_cache_stats()["active_sequences"] == 0
        finally:
            tl.shutdown()
    assert out[True] == out[False]
    assert all(len(t) == 6 for t in out[True])


def test_default_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        T.LLM(model=_tcfg(), skip_tokenizer_init=True)


def test_package_imports_without_jax():
    """Every module of the port imports with JAX -- and `safetensors`,
    `transformers` and `tokenizers`, which serving does not need --
    blocked, and loads none of them nor the JAX package."""
    code = (
        "import sys, pkgutil, importlib\n"
        "for name in ('jax', 'safetensors', 'transformers', 'tokenizers'):\n"
        "    sys.modules[name] = None\n"
        "import tensorrt_llm_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert not any(k == 'tensorrt_llm_tpu' or\n"
        "               k.startswith('tensorrt_llm_tpu.') for k in sys.modules)\n"
        "assert not any(k.split('.')[0] in ('safetensors', 'transformers',\n"
        "                                   'tokenizers') and sys.modules[k]\n"
        "               for k in sys.modules)\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                       capture_output=True, text=True, timeout=120,
                       env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_no_module_names_the_jax_package():
    """No port module names the JAX package or JAX; none imports
    `safetensors` or `tokenizers`, and `transformers` only inside a
    function (the tokenizer loaded from a path)."""
    pat = re.compile(r"tensorrt_llm_tpu\.|import jax|from jax"
                     r"|^\s*(import|from) (safetensors|tokenizers)\b"
                     r"|^(import|from) transformers\b", re.M)
    hits = [str(p) for p in (ROOT / "tensorrt_llm_tpu_torch").rglob("*.py")
            if pat.search(p.read_text())]
    assert not hits, hits
