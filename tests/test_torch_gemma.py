"""Port parity for the Gemma family (Gemma, Gemma-2, Gemma-3 text).

* Configs: `from_hf_config` gives the JAX package's fields, and each
  family's constructor sets the same ones (tied embeddings, sqrt(hidden)
  embedding scale, tanh-GELU, post norms, softcaps, the attention scale,
  the sliding pattern, q/k norms and the local RoPE base).
* `LLM.generate` against the JAX `LLM` from the same W4A16 weights
  (`params_from_jax`), prompts longer than the window so that the sliding
  layers' VSWA rings wrap on both sides: equal greedy tokens, or a first
  difference at a near-tie (the top two port logits within `TIE` 0.02 of
  each other, as `tests/test_torch_llm.py`); the logits of a prompt's last
  row correlate above 0.99 with the JAX model's.
* HF parity (JAX `tests/test_model_zoo.py:66-83`): transformers models
  built from a config, weights read through `load_hf_weights` with the
  (1 + w) norms folded in: the same argmax and correlation > 0.99 at a
  prompt's last row.  `LLM(model=<dir>)` serves a checkpoint written by
  `save_pretrained`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorrt_llm_tpu as J
from tensorrt_llm_tpu.models import get_model_class as jax_model_class
from tensorrt_llm_tpu.models.modeling_utils import ModelConfig as JCfg
from tensorrt_llm_tpu.quantization import QuantAlgo as JQA
from tensorrt_llm_tpu.quantization import QuantConfig as JQC
import tensorrt_llm_tpu_torch as T
from tensorrt_llm_tpu_torch.models import (
    ModelConfig, get_model_class, params_from_jax)
from tensorrt_llm_tpu_torch.quantization import QuantAlgo, QuantConfig
from tensorrt_llm_tpu_torch.runtime.kv_cache_manager import (
    KVCacheConfig, KVCacheManager)
from tensorrt_llm_tpu_torch.runtime.model_engine import ModelEngine
from tensorrt_llm_tpu_torch.runtime.request import LlmRequest

from torch_parity import jax_generate, port_logits

TIE = 0.02
COMMON = dict(vocab_size=320, hidden_size=128, intermediate_size=256,
              num_hidden_layers=4, num_attention_heads=4,
              num_key_value_heads=2, head_dim=64, rms_norm_eps=1e-6,
              max_position_embeddings=256,
              hidden_activation="gelu_pytorch_tanh", tie_word_embeddings=True)
GEMMA = dict(COMMON, architectures=["GemmaForCausalLM"])
GEMMA2 = dict(COMMON, architectures=["Gemma2ForCausalLM"],
              query_pre_attn_scalar=48, attn_logit_softcapping=50.0,
              final_logit_softcapping=30.0, sliding_window=16)
GEMMA3 = dict(COMMON, architectures=["Gemma3ForCausalLM"],
              query_pre_attn_scalar=48, sliding_window=16,
              sliding_window_pattern=2, rope_local_base_freq=10000.0,
              rope_theta=1000000.0)
FAMILIES = {"gemma": GEMMA, "gemma2": GEMMA2, "gemma3": GEMMA3}
_FIELDS = ("tie_word_embeddings", "embedding_multiplier", "activation",
           "post_norms", "qk_norm", "query_pre_attn_scalar",
           "attn_logit_softcap", "final_logit_softcap",
           "sliding_window_pattern", "rope_local_theta", "sliding_window")


def _configs(hf):
    jcfg = JCfg.from_hf_config(hf, quant=JQC(quant_algo=JQA.W4A16,
                                             group_size=64))
    jcfg.attention_backend = "xla"
    tcfg = ModelConfig.from_hf_config(hf, quant=QuantConfig(
        quant_algo=QuantAlgo.W4A16, group_size=64))
    return jcfg, tcfg


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_family_configs_match_jax(name):
    jcfg, tcfg = _configs(FAMILIES[name])
    jax_model_class(jcfg.architecture)(jcfg)
    get_model_class(tcfg.architecture)(tcfg, "cpu")
    for f in _FIELDS:
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    L = tcfg.num_layers
    assert [tcfg.is_sliding_layer(i) for i in range(L)] == \
        [jcfg.is_sliding_layer(i) for i in range(L)]
    if name == "gemma2":
        assert [tcfg.is_sliding_layer(i) for i in range(4)] == \
            [True, False, True, False]


LLM_KW = dict(skip_tokenizer_init=True, max_seq_len=120, max_batch_size=3,
              max_num_tokens=32, kv_num_blocks=80, kv_block_size=8,
              max_decode_steps=4)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_generate_matches_jax_greedy(name, monkeypatch):
    monkeypatch.setenv("TLLM_KV_BOOKKEEPING", "python")
    jcfg, tcfg = _configs(FAMILIES[name])
    rng = np.random.RandomState(3)
    prompts = [[int(t) for t in rng.randint(1, 319, n)] for n in (45, 20, 7)]
    sp = dict(max_tokens=8, temperature=0.0, ignore_eos=True)
    jl = J.LLM(model=jcfg, **LLM_KW)
    try:
        params = params_from_jax(jax.tree.map(np.asarray, jl.engine.params))
        jout = jax_generate(jl, prompts, J.SamplingParams(**sp))
        assert jl.engine._vswa == (name != "gemma")
        jm, jp = jl.engine.model, jl.engine.params
    finally:
        jl.shutdown()
    tl = T.LLM(model=tcfg, device="cpu", params=params,
               kv_bookkeeping="python", **LLM_KW)
    try:
        assert tl.engine.vswa == (name != "gemma")
        tout = [o.outputs[0].token_ids
                for o in tl.generate(prompts, T.SamplingParams(**sp))]
    finally:
        tl.shutdown()
    exact = 0
    for p, x, y in zip(prompts, jout, tout):
        assert len(x) == len(y) == 8
        if x == y:
            exact += 1
            continue
        i = next(i for i, (u, v) in enumerate(zip(x, y)) if u != v)
        lg = port_logits(tcfg, params, p + x[:i])
        top = lg.max()
        assert lg[x[i]] >= top - TIE and lg[y[i]] >= top - TIE, (
            f"token {i} differs without a near-tie: jax {x[i]} "
            f"({lg[x[i]]}), port {y[i]} ({lg[y[i]]}), top {top}")
    assert exact >= 2
    # the last row's logits of a prompt inside the window (one chunk, no
    # ring on the JAX side's full pools): correlation above 0.99
    p = prompts[2]
    ours = port_logits(tcfg, params, p)
    ref = _jax_prefill_logits(jm, jp, jcfg, p)
    assert np.argmax(ours) == np.argmax(ref)
    assert np.corrcoef(ours, ref)[0, 1] > 0.99


def _jax_prefill_logits(jm, jp, jcfg, tokens, BS=8):
    from tensorrt_llm_tpu.attention_backend.interface import (
        AttentionMetadata as JMeta)
    n = len(tokens)
    blocks = list(range(1, -(-n // BS) + 1))
    shape = (len(blocks) + 1, jcfg.num_kv_heads, BS, jcfg.head_dim)
    caches = [(jnp.zeros(shape, jnp.bfloat16),) * 2
              for _ in range(jcfg.num_layers)]
    meta = JMeta(positions=jnp.arange(n, dtype=jnp.int32),
                 slot_mapping=jnp.asarray([blocks[p // BS] * BS + p % BS
                                           for p in range(n)], jnp.int32),
                 block_tables=jnp.asarray([blocks], jnp.int32),
                 kv_lens=jnp.asarray([n], jnp.int32), q_offset=jnp.int32(0),
                 mode="prefill")
    logits, _ = jm.forward(jp, jnp.asarray(tokens, jnp.int32), caches, meta,
                           jnp.asarray([n - 1], jnp.int32))
    return np.asarray(logits, np.float32)[0]


# ------------------------------------------------------------ HF parity ---
HF_COMMON = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
                 num_hidden_layers=2, num_attention_heads=4,
                 num_key_value_heads=2, head_dim=32,
                 max_position_embeddings=256, attention_dropout=0.0)


def _hf_config(name):
    transformers = pytest.importorskip("transformers")
    if name == "gemma":
        return transformers.GemmaConfig(
            **HF_COMMON, hidden_activation="gelu_pytorch_tanh",
            tie_word_embeddings=True)
    if name == "gemma2":
        return transformers.Gemma2Config(
            **HF_COMMON, hidden_activation="gelu_pytorch_tanh",
            query_pre_attn_scalar=32, attn_logit_softcapping=50.0,
            final_logit_softcapping=30.0, sliding_window=16,
            tie_word_embeddings=True)
    return transformers.Gemma3TextConfig(
        **HF_COMMON, hidden_activation="gelu_pytorch_tanh",
        query_pre_attn_scalar=32, sliding_window=16,
        sliding_window_pattern=2, rope_local_base_freq=10000.0,
        rope_theta=1000000.0, tie_word_embeddings=True)


def _hf_model(name):
    transformers = pytest.importorskip("transformers")
    hf_cfg = _hf_config(name)
    torch.manual_seed(0)
    m = transformers.AutoModelForCausalLM.from_config(hf_cfg)
    m.eval()
    # scramble the norms: ones would hide a misplaced (1 + w) or q/k norm
    with torch.no_grad():
        for n, prm in m.named_parameters():
            if "norm" in n:
                prm.add_(torch.rand_like(prm) - 0.5)
    return hf_cfg, m


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_hf_parity(name):
    hf_cfg, hf_model = _hf_model(name)
    sd = {k: v.detach().float() for k, v in hf_model.state_dict().items()}
    cfg = ModelConfig.from_hf_config(dict(
        hf_cfg.to_dict(), architectures=FAMILIES[name]["architectures"]))
    model = get_model_class(cfg.architecture)(cfg, "cpu").load_hf_weights(
        lambda n: sd.get(n))
    prompt = [int(t) for t in np.random.RandomState(0).randint(1, 255, 24)]
    with torch.no_grad():
        hf_logits = hf_model(torch.tensor([prompt])).logits[0, -1].numpy()
    kv = KVCacheManager(KVCacheConfig(block_size=8, bookkeeping="python"),
                        cfg.num_layers, cfg.num_kv_heads, cfg.head_dim,
                        num_blocks=32, device="cpu")
    engine = ModelEngine(model, kv, "cpu", max_seq_len=64, max_batch_size=4)
    assert engine.vswa == (name != "gemma")
    req = LlmRequest(prompt, T.SamplingParams(max_tokens=1))
    kv.add_sequence(req.request_id, prompt)
    req.start_context()
    ours = []
    for lo, hi in ((0, 16), (16, 24)):     # two chunks: the rings wrap
        kv.grow_sequence(req.request_id, hi)
        ours = engine.run_prefill(engine.prepare_prefill_inputs(req,
                                                                hi - lo))
        req.context_position = hi
    ours = np.asarray(ours[0], np.float32)
    assert np.argmax(ours) == np.argmax(hf_logits)
    assert np.corrcoef(ours, hf_logits)[0, 1] > 0.99


def test_llm_serves_a_gemma2_checkpoint_dir(tmp_path):
    hf_cfg, hf_model = _hf_model("gemma2")
    hf_model.save_pretrained(str(tmp_path), safe_serialization=True)
    prompt = [int(t) for t in np.random.RandomState(1).randint(1, 255, 30)]
    with torch.no_grad():
        want = int(hf_model(torch.tensor([prompt])).logits[0, -1].argmax())
    llm = T.LLM(model=str(tmp_path), device="cpu", skip_tokenizer_init=True,
                max_seq_len=64, max_batch_size=2, kv_num_blocks=32,
                kv_block_size=8, kv_bookkeeping="python")
    try:
        cfg = llm.model_config
        assert cfg.architecture == "Gemma2ForCausalLM"
        assert (cfg.attn_logit_softcap, cfg.final_logit_softcap,
                cfg.query_pre_attn_scalar) == (50.0, 30.0, 32)
        assert llm.engine.vswa
        out = llm.generate([prompt], T.SamplingParams(
            max_tokens=4, temperature=0.0, ignore_eos=True))
        toks = out[0].outputs[0].token_ids
        assert len(toks) == 4 and toks[0] == want
    finally:
        llm.shutdown()
