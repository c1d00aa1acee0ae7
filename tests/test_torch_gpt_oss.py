"""Port parity for the GPT-OSS and Mixtral paths against the JAX package.

* YaRN / llama3 RoPE tables: the same f32 formulas; `pow` and `cos` of two
  libraries may differ by an ulp, which at positions up to 512 moves an
  angle by < 1e-4: atol 2e-4.
* Forward: tiny GPT-OSS (built by `from_hf_config`: 2 layers, sliding then
  full, window 16, sinks, QKV/o biases, YaRN, 4 experts top-2, router and
  expert biases) and tiny Mixtral, with the JAX weights converted by
  `params_from_jax`, run chunked prefill and batched decode on both sides
  against their own paged pools.  Tolerance as `test_torch_model.py`:
  0.03 absolute on O(1) bf16-rounded logits (f32 sums in another order
  move a bf16 activation by an ulp here and there, through two layers).
* `LLM.generate`: greedy tokens equal the JAX `LLM`'s, under the near-tie
  rule of `test_torch_llm.py`, with prompts longer than the window.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorrt_llm_tpu as J
from tensorrt_llm_tpu.attention_backend.interface import (
    AttentionMetadata as JMeta)
from tensorrt_llm_tpu.models import get_model_class as jax_model_class
from tensorrt_llm_tpu.models.modeling_utils import ModelConfig as JCfg
from tensorrt_llm_tpu.ops.rope import RopeConfig as JRope
from tensorrt_llm_tpu.ops.rope import make_rope_tables as jax_rope_tables
from tensorrt_llm_tpu.quantization import QuantAlgo as JQA
from tensorrt_llm_tpu.quantization import QuantConfig as JQC
import tensorrt_llm_tpu_torch as T
from tensorrt_llm_tpu_torch.attention_backend import AttentionMetadata
from tensorrt_llm_tpu_torch.models import (
    ModelConfig, get_model_class, gpt_oss_20b_config, params_from_jax)
from tensorrt_llm_tpu_torch.ops.rope import RopeConfig, make_rope_tables
from tensorrt_llm_tpu_torch.quantization import QuantAlgo, QuantConfig

from torch_parity import jax_generate, port_logits

TOL = 0.03
TIE = 0.02
BS = 8
WINDOW = 16

GPT_OSS = dict(
    architectures=["GptOssForCausalLM"], model_type="gpt_oss",
    vocab_size=320, hidden_size=128, intermediate_size=128,
    num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
    head_dim=64, num_local_experts=4, num_experts_per_tok=2,
    sliding_window=WINDOW, layer_types=["sliding_attention", "full_attention"],
    rope_theta=150000.0, attention_bias=True, tie_word_embeddings=False,
    max_position_embeddings=256, rms_norm_eps=1e-5,
    rope_scaling={"rope_type": "yarn", "factor": 32.0, "beta_fast": 32.0,
                  "beta_slow": 1.0, "truncate": False,
                  "original_max_position_embeddings": 64})
MIXTRAL = dict(
    architectures=["MixtralForCausalLM"], vocab_size=320, hidden_size=128,
    intermediate_size=192, num_hidden_layers=2, num_attention_heads=4,
    num_key_value_heads=2, head_dim=64, num_local_experts=4,
    num_experts_per_tok=2, rope_theta=1e6, max_position_embeddings=256,
    rms_norm_eps=1e-5, sliding_window=None)


@pytest.mark.parametrize("scaling", [
    {"rope_type": "yarn", "factor": 32.0, "beta_fast": 32.0,
     "beta_slow": 1.0, "truncate": False,
     "original_max_position_embeddings": 4096},
    {"rope_type": "yarn", "factor": 40.0, "mscale": 1.0,
     "mscale_all_dim": 0.707, "original_max_position_embeddings": 64},
    {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
     "high_freq_factor": 4.0, "original_max_position_embeddings": 256},
])
def test_rope_tables_match_jax(scaling):
    kw = dict(head_dim=64, theta=150000.0, max_position=512,
              scaling_type=scaling["rope_type"],
              scaling_factor=scaling["factor"],
              original_max_position=scaling["original_max_position_embeddings"])
    extra = {k: scaling[k] for k in ("beta_fast", "beta_slow", "truncate",
                                     "mscale", "mscale_all_dim",
                                     "low_freq_factor", "high_freq_factor")
             if k in scaling}
    jc, js = jax_rope_tables(JRope(**kw, **extra))
    tc, ts = make_rope_tables(RopeConfig(**kw, **extra))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=2e-4)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=2e-4)


def test_from_hf_config_fields():
    cfg = gpt_oss_20b_config()
    assert (cfg.num_layers, cfg.num_experts, cfg.num_experts_per_tok) == \
        (24, 32, 4)
    assert cfg.has_sinks and cfg.o_bias and cfg.attention_bias
    assert cfg.moe_router_bias and cfg.moe_topk_then_softmax
    assert cfg.activation == "swiglu_oai" and cfg.quant.group_size == 64
    assert [cfg.is_sliding_layer(i) for i in range(4)] == [True, False] * 2
    assert cfg.rope.scaling_type == "yarn" and not cfg.rope.truncate
    jcfg = JCfg.from_hf_config(GPT_OSS)
    tcfg = ModelConfig.from_hf_config(GPT_OSS)
    for f in ("num_experts", "moe_intermediate_size", "activation",
              "has_sinks", "o_bias", "attention_bias", "layer_types",
              "sliding_window", "rope_scaling", "moe_expert_bias"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    with pytest.raises(NotImplementedError):
        ModelConfig.from_hf_config(dict(architectures=["DeciLMForCausalLM"]))


def _configs(hf, group=64):
    jcfg = JCfg.from_hf_config(hf, quant=JQC(quant_algo=JQA.W4A16,
                                             group_size=group))
    jcfg.attention_backend = "xla"
    tcfg = ModelConfig.from_hf_config(hf, quant=QuantConfig(
        quant_algo=QuantAlgo.W4A16, group_size=group))
    return jcfg, tcfg


def _jax_params(jcfg, seed):
    """JAX `init` weights with every bias made nonzero (init leaves them 0)."""
    jm = jax_model_class(jcfg.architecture)(jcfg)
    params = jm.init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def noise(a, s=0.1):
        return jnp.asarray(rng.normal(size=np.shape(a)).astype(np.float32)
                           * s)

    for lp in params["layers"]:
        for name in ("qkv", "o"):
            if "bias" in lp["attn"][name]:
                lp["attn"][name]["bias"] = noise(lp["attn"][name]["bias"])
        for leaf in ("router_bias", "b_gate_up", "b_down"):
            if leaf in lp["mlp"]:
                lp["mlp"][leaf] = noise(lp["mlp"][leaf], 0.3)
    return jm, params


class _Pair:
    """Runs the same step on the JAX and port models and compares logits."""

    def __init__(self, hf, seed, NB=24):
        self.jcfg, tcfg = _configs(hf)
        self.jm, self.params = _jax_params(self.jcfg, seed)
        self.jfwd = jax.jit(self.jm.forward)
        state = params_from_jax(jax.tree.map(np.asarray, self.params))
        # the port's own RoPE tables (YaRN for GPT-OSS), not JAX's
        state.pop("rope_cos"), state.pop("rope_sin")
        self.tm = get_model_class(tcfg.architecture)(tcfg, "cpu")
        self.tm.load_state(state)
        c = self.jcfg
        shape = (NB, c.num_kv_heads, BS, c.head_dim)
        self.jcache = [(jnp.zeros(shape, jnp.bfloat16),) * 2
                       for _ in range(c.num_layers)]
        self.tcache = [(torch.zeros(shape, dtype=torch.bfloat16),
                        torch.zeros(shape, dtype=torch.bfloat16))
                       for _ in range(c.num_layers)]

    def step(self, mode, ids, pos, slots, tables, kv_lens, q_offset, rows):
        jmeta = JMeta(positions=jnp.asarray(pos, jnp.int32),
                      slot_mapping=jnp.asarray(slots, jnp.int32),
                      block_tables=jnp.asarray(tables, jnp.int32),
                      kv_lens=jnp.asarray(kv_lens, jnp.int32),
                      q_offset=jnp.int32(q_offset), mode=mode)
        jl, self.jcache = self.jfwd(
            self.params, jnp.asarray(ids, jnp.int32), self.jcache, jmeta,
            jnp.asarray(rows, jnp.int32))
        tmeta = AttentionMetadata(
            positions=torch.tensor(pos), slot_mapping=torch.tensor(slots),
            block_tables=torch.tensor(np.asarray(tables, np.int32)),
            kv_lens=torch.tensor(np.asarray(kv_lens, np.int32)),
            q_offset=q_offset, mode=mode)
        with torch.no_grad():
            tl = self.tm(torch.tensor(ids), self.tcache, tmeta,
                         torch.tensor(rows)).numpy()
        jl = np.asarray(jl, np.float32)
        assert tl.shape == jl.shape and np.isfinite(tl).all()
        assert np.abs(tl - jl).max() <= TOL, np.abs(tl - jl).max()
        return tl


@pytest.mark.parametrize("hf", [GPT_OSS, MIXTRAL], ids=["gpt_oss", "mixtral"])
def test_forward_matches_jax(hf):
    pair = _Pair(hf, seed=5)
    rng = np.random.default_rng(5)
    V = hf["vocab_size"]
    a_blocks, b_blocks = [1, 2, 3, 4, 5, 6], [9, 10, 11, 12]
    a = list(rng.integers(1, V - 1, 37))       # crosses the window twice
    b = list(rng.integers(1, V - 1, 20))

    def slots(blocks, lo, hi):
        return [blocks[p // BS] * BS + p % BS for p in range(lo, hi)]

    def prefill(tokens, blocks, lo, hi):
        return pair.step("prefill", tokens[lo:hi], list(range(lo, hi)),
                         slots(blocks, lo, hi), [blocks], [hi], lo,
                         [hi - lo - 1])

    prefill(a, a_blocks, 0, 16)
    la = prefill(a, a_blocks, 16, 37)
    lb = prefill(b, b_blocks, 0, 20)
    na, nb = len(a), len(b)
    for _ in range(3):
        a.append(int(np.argmax(la[0])))
        b.append(int(np.argmax(lb[0])))
        mb = max(len(a_blocks), len(b_blocks))
        tables = [a_blocks + [0] * (mb - len(a_blocks)),
                  b_blocks + [0] * (mb - len(b_blocks))]
        out = pair.step("decode", [a[-1], b[-1]], [na, nb],
                        slots(a_blocks, na, na + 1)
                        + slots(b_blocks, nb, nb + 1),
                        tables, [na + 1, nb + 1], 0, [0, 1])
        la, lb = out[0:1], out[1:2]
        na, nb = na + 1, nb + 1


LLM_KW = dict(skip_tokenizer_init=True, max_seq_len=120, max_batch_size=3,
              max_num_tokens=32, kv_num_blocks=80, kv_block_size=8,
              max_decode_steps=4)


def test_generate_matches_jax_greedy(monkeypatch):
    # the JAX KV manager would otherwise build its native library, racing
    # other test processes (see ROADMAP Queue C)
    monkeypatch.setenv("TLLM_KV_BOOKKEEPING", "python")
    jcfg, tcfg = _configs(GPT_OSS)
    rng = np.random.RandomState(1)
    base = [int(t) for t in rng.randint(1, 319, 30)]
    prompts = [base + [3, 4], [int(t) for t in rng.randint(1, 319, 45)],
               base + [9], [int(t) for t in rng.randint(1, 319, 7)]]
    sp = dict(max_tokens=8, temperature=0.0, ignore_eos=True)
    jl = J.LLM(model=jcfg, **LLM_KW)
    try:
        params = params_from_jax(jax.tree.map(np.asarray, jl.engine.params))
        jout = jax_generate(jl, prompts, J.SamplingParams(**sp))
    finally:
        jl.shutdown()
    tl = T.LLM(model=tcfg, device="cpu", params=params, **LLM_KW)
    try:
        tout = [o.outputs[0].token_ids
                for o in tl.generate(prompts, T.SamplingParams(**sp))]
        stats = tl.get_kv_cache_stats()
        rings = tl.engine.vswa
    finally:
        tl.shutdown()
    # the sliding layers keep VSWA rings, as in the JAX engine, and prefix
    # reuse is off under rings there too
    assert rings and stats["reused_blocks"] == 0
    assert stats["active_sequences"] == 0
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
    assert exact >= 1
