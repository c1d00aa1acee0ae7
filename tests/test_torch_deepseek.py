"""Port parity for the DeepSeek V3 family (Moonlight, V3, V3.2) against the
JAX package: routing, the MoE with shared experts, configs, the latent KV
pools, forwards and `LLM.generate`.

* noaux_tc routing (sigmoid scores, score-correction bias, group-limited
  top-k): the same f32 math, so the selected ids agree as sets and the
  weights to 1e-6.
* The W4A16 MoE with a shared expert: the same expert math in the same
  rounding points as `test_torch_moe.py`: 1e-2 of the largest output.
* Forwards: tiny Moonlight-shaped (direct q_proj, dense layer 0, 8
  experts top-3, 2 shared) and V3.2-shaped (q_lora, indexer with
  `index_topk` 16 below the sequence, 4 groups top-2, YaRN) models, W4A16
  group 64, the JAX weights converted by `params_from_jax`, through
  chunked prefill and batched decode against their own paged latent pools:
  0.03 absolute on O(1) bf16-rounded logits, as `test_torch_gpt_oss.py`.
* `LLM.generate`: greedy tokens equal the JAX `LLM`'s under the near-tie
  rule of `test_torch_llm.py`, with prompts longer than `index_topk` so
  that DSA's top-k drops tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorrt_llm_tpu as J
from tensorrt_llm_tpu.attention_backend.interface import (
    AttentionMetadata as JMeta)
from tensorrt_llm_tpu.layers.moe import MoE as JMoE
from tensorrt_llm_tpu.models import get_model_class as jax_model_class
from tensorrt_llm_tpu.models.modeling_utils import ModelConfig as JCfg
from tensorrt_llm_tpu.quantization import QuantAlgo as JQA
from tensorrt_llm_tpu.quantization import QuantConfig as JQC
from tensorrt_llm_tpu.runtime.kv_cache_manager import (
    KVCacheManager as JKVManager)
import tensorrt_llm_tpu_torch as T
from tensorrt_llm_tpu_torch.attention_backend import AttentionMetadata
from tensorrt_llm_tpu_torch.layers.moe import MoE
from tensorrt_llm_tpu_torch.models import (
    DEEPSEEK_V3, DEEPSEEK_V32, MOONLIGHT_16B_A3B, ModelConfig,
    get_model_class, moonlight_16b_a3b_config, params_from_jax)
from tensorrt_llm_tpu_torch.quantization import QuantAlgo, QuantConfig
from tensorrt_llm_tpu_torch.runtime.kv_cache_manager import (
    KVCacheConfig, KVCacheManager, model_pools)

from torch_parity import jax_generate, port_logits

TOL = 0.03
TIE = 0.02
BS = 8
GROUP = 64

_TINY = dict(vocab_size=320, hidden_size=128, intermediate_size=256,
             moe_intermediate_size=64, num_hidden_layers=3,
             num_attention_heads=4, num_key_value_heads=4,
             n_routed_experts=8, num_experts_per_tok=3, kv_lora_rank=48,
             qk_rope_head_dim=16, qk_nope_head_dim=32, v_head_dim=32,
             first_k_dense_replace=1, max_position_embeddings=256)
MOON_TINY = dict(MOONLIGHT_16B_A3B["hf_config"], **_TINY)
V32_TINY = dict(DEEPSEEK_V32["hf_config"], **_TINY, q_lora_rank=64,
                n_group=4, topk_group=2, index_n_heads=4, index_head_dim=32,
                index_topk=16)
V32_TINY["rope_scaling"] = dict(V32_TINY["rope_scaling"],
                                original_max_position_embeddings=64)


def _np(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _moe_pair(n_group, topk_group, shared, seed=3):
    H, I, E, k = 128, 64, 8, 3
    kw = dict(score_func="sigmoid", has_score_bias=True, n_group=n_group,
              topk_group=topk_group, routed_scaling=2.446,
              n_shared_experts=shared)
    jm = JMoE(hidden_size=H, intermediate_size=I, num_experts=E, top_k=k,
              quant=JQC(quant_algo=JQA.W4A16, group_size=GROUP), **kw)
    tm = MoE(H, I, E, k, quant=QuantConfig(quant_algo=QuantAlgo.W4A16,
                                           group_size=GROUP), **kw)
    rng = np.random.default_rng(seed)

    def f(*shape, s=1.0):
        return (rng.normal(size=shape) * s).astype(np.float32)

    fl = dict(router_w=f(H, E, s=0.5), gate_w=f(E, H, I, s=H ** -0.5),
              up_w=f(E, H, I, s=H ** -0.5), down_w=f(E, I, H, s=I ** -0.5),
              score_bias=f(E, s=0.1))
    sh = None
    if shared:
        Is = shared * I
        sh = dict(gate_w=f(H, Is, s=H ** -0.5), up_w=f(H, Is, s=H ** -0.5),
                  down_w=f(Is, H, s=Is ** -0.5))
        tm.shared.from_float(**{a: torch.from_numpy(v)
                                for a, v in sh.items()})
        sh = jm.shared.from_float(**{a: jnp.asarray(v)
                                     for a, v in sh.items()})
    params = jm.from_float(**{a: jnp.asarray(v) for a, v in fl.items()},
                           shared=sh)
    tm.from_float(**{a: torch.from_numpy(v) for a, v in fl.items()})
    x = _np(jnp.asarray(f(16, H), jnp.bfloat16))
    return jm, params, tm, x


@pytest.mark.parametrize("n_group,topk_group", [(4, 2), (1, 1)])
def test_noaux_tc_routing_matches_jax(n_group, topk_group):
    jm, params, tm, x = _moe_pair(n_group, topk_group, 0)
    jids, jw = jm.route(params, jnp.asarray(x, jnp.bfloat16))
    tids, tw = tm.route(torch.from_numpy(x).to(torch.bfloat16))
    jids, jw = np.asarray(jids), np.asarray(jw)
    for t in range(x.shape[0]):
        assert set(jids[t].tolist()) == set(tids[t].tolist()), t
        jmap = dict(zip(jids[t].tolist(), jw[t].tolist()))
        for e, w in zip(tids[t].tolist(), tw[t].tolist()):
            assert abs(jmap[e] - w) <= 1e-6, (t, e)
    if n_group > 1:
        # every token's experts come from its topk_group best groups
        groups = tids.numpy() // (8 // n_group)
        assert all(len(set(g)) <= topk_group for g in groups)


def test_moe_with_shared_expert_matches_jax():
    jm, params, tm, x = _moe_pair(4, 2, 2)
    ref = np.asarray(jm(params, jnp.asarray(x, jnp.bfloat16)), np.float32)
    with torch.no_grad():
        out = tm(torch.from_numpy(x).to(torch.bfloat16)).float().numpy()
    assert np.abs(out - ref).max() <= 1e-2 * np.abs(ref).max(), \
        np.abs(out - ref).max()


_FIELDS = ("num_layers", "num_heads", "hidden_size", "vocab_size",
           "intermediate_size", "num_experts", "num_experts_per_tok",
           "moe_intermediate_size", "n_shared_experts", "n_group",
           "topk_group", "routed_scaling_factor", "mlp_only_layers",
           "norm_topk_prob", "moe_score_func", "moe_has_score_bias",
           "q_lora_rank", "kv_lora_rank", "qk_nope_head_dim",
           "qk_rope_head_dim", "v_head_dim", "rope_interleave",
           "sparse_attention", "rope_scaling", "rope_theta", "rms_eps",
           "max_position", "is_mla", "kv_pool_heads", "mla_scale")


@pytest.mark.parametrize("preset", [MOONLIGHT_16B_A3B, DEEPSEEK_V3,
                                    DEEPSEEK_V32],
                         ids=["moonlight", "v3", "v3.2"])
def test_from_hf_config_matches_jax(preset):
    hf = preset["hf_config"]
    jcfg = JCfg.from_hf_config(hf)
    tcfg = ModelConfig.from_hf_config(hf)
    for f in _FIELDS:
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    for i in range(tcfg.num_layers):
        assert tcfg.is_moe_layer(i) == jcfg.is_moe_layer(i), i
    tr, jr = tcfg.rope, jcfg.rope
    for f in ("head_dim", "theta", "scaling_type", "scaling_factor",
              "beta_fast", "beta_slow", "mscale", "mscale_all_dim",
              "original_max_position", "interleaved"):
        assert getattr(tr, f) == getattr(jr, f), f
    # the port keeps the latent row at L + R; the JAX package pads to 640
    assert (tcfg.kv_pool_dim, jcfg.kv_pool_dim) == (576, 640)
    with pytest.raises(NotImplementedError):
        ModelConfig.from_hf_config(dict(hf, topk_method="group_limited_greedy"))


def test_latent_pools_and_sizing():
    moon = moonlight_16b_a3b_config()
    pools = model_pools(moon, 2, 16, device="cpu")
    assert len(pools) == 27 and pools[0].shape == (2, 1, 16, 576)
    per_token = sum(p.numel() * p.element_size() for p in pools) / 32
    assert per_token == 31104
    v32 = ModelConfig.from_hf_config(dict(DEEPSEEK_V32["hf_config"],
                                          num_hidden_layers=4))
    mgr = KVCacheManager(KVCacheConfig(block_size=16, layout="latent",
                                       dsa_index_dim=128), 4, 1, 576, 3,
                         device="cpu")
    pools = mgr.allocate_pools()
    assert [tuple(t.shape) for t in pools[0]] == [(3, 1, 16, 576),
                                                  (3, 1, 16, 128)]
    assert [tuple(t.shape) for t in model_pools(v32, 3, 16,
                                                device="cpu")[3]] == \
        [(3, 1, 16, 576), (3, 1, 16, 128)]
    budget = 3 << 30
    args = (budget, 4, 1, 576, 16)
    assert KVCacheManager.blocks_from_memory(*args, num_pools=1,
                                             extra_dims=128) == \
        JKVManager.blocks_from_memory(*args, num_pools=1, extra_dims=128)
    with pytest.raises(NotImplementedError):
        KVCacheConfig(layout="latent", kv_quant="INT8")


def _configs(hf):
    jcfg = JCfg.from_hf_config(hf, quant=JQC(quant_algo=JQA.W4A16,
                                             group_size=GROUP))
    jcfg.attention_backend = "xla"
    tcfg = ModelConfig.from_hf_config(hf, quant=QuantConfig(
        quant_algo=QuantAlgo.W4A16, group_size=GROUP))
    return jcfg, tcfg


def _jax_params(jcfg, seed):
    """JAX `init` weights with the score-correction bias and the indexer's
    key-norm bias made nonzero (init leaves them 0)."""
    jm = jax_model_class(jcfg.architecture)(jcfg)
    params = jm.init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def noise(a, s):
        return jnp.asarray(rng.normal(size=np.shape(a)).astype(np.float32)
                           * s)

    for lp in params["layers"]:
        if "score_bias" in lp["mlp"]:
            lp["mlp"]["score_bias"] = noise(lp["mlp"]["score_bias"], 0.1)
        if "indexer" in lp["attn"]:
            ix = lp["attn"]["indexer"]
            ix["k_norm_b"] = noise(ix["k_norm_b"], 0.1)
    return jm, params


class _Pair:
    """Runs the same step on the JAX and port models over their own latent
    pools and compares logits."""

    def __init__(self, hf, seed, NB=24):
        self.jcfg, tcfg = _configs(hf)
        self.jm, self.params = _jax_params(self.jcfg, seed)
        self.jfwd = jax.jit(self.jm.forward)
        state = params_from_jax(jax.tree.map(np.asarray, self.params))
        state.pop("rope_cos"), state.pop("rope_sin")
        self.tm = get_model_class(tcfg.architecture)(tcfg, "cpu")
        self.tm.load_state(state)
        # the same [NB, 1, BS, L + R] latent (and indexer) pools on both
        # sides: the JAX layer pads nothing when the pool is L + R wide
        self.tcache = model_pools(tcfg, NB, BS, device="cpu")
        self.jcache = [
            tuple(jnp.zeros(t.shape, jnp.bfloat16) for t in c)
            if isinstance(c, tuple) else jnp.zeros(c.shape, jnp.bfloat16)
            for c in self.tcache]

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


@pytest.mark.parametrize("hf", [MOON_TINY, V32_TINY],
                         ids=["moonlight", "v3.2"])
def test_forward_matches_jax(hf):
    pair = _Pair(hf, seed=5)
    rng = np.random.default_rng(5)
    V = hf["vocab_size"]
    a_blocks, b_blocks = [1, 2, 3, 4, 5, 6], [9, 10, 11, 12]
    a = list(rng.integers(1, V - 1, 37))       # longer than index_topk
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


@pytest.mark.parametrize("hf", [MOON_TINY, V32_TINY],
                         ids=["moonlight", "v3.2"])
def test_generate_matches_jax_greedy(hf, monkeypatch):
    # the JAX KV manager would otherwise build its native library, racing
    # other test processes
    monkeypatch.setenv("TLLM_KV_BOOKKEEPING", "python")
    jcfg, tcfg = _configs(hf)
    rng = np.random.RandomState(2)
    V = hf["vocab_size"]
    base = [int(t) for t in rng.randint(1, V - 1, 30)]
    prompts = [base + [3, 4], [int(t) for t in rng.randint(1, V - 1, 45)],
               base + [9], [int(t) for t in rng.randint(1, V - 1, 7)]]
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
    finally:
        tl.shutdown()
    assert stats["reused_blocks"] > 0 and stats["active_sequences"] == 0
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
