"""Helpers of the port's speculative-decoding parity tests
(`tests/test_torch_speculative.py`, `test_torch_tree_spec.py`,
`test_torch_spec_features.py`).

`run_pair` serves the same prompts greedily on the JAX `LLM` under a JAX
`SpeculativeConfig` and on the port's `LLM` (CPU) under the port's, with the
JAX model's weights (`params_from_jax`), and on a plain port `LLM` of the
same weights.  A config is given once, as a dict of `SpeculativeConfig`
fields; a callable field is called with the side ("jax" or "port") and the
JAX `LLM` (so a draft model's state can be carried across).  Drafter
weights that the JAX package draws from `jax.random` are carried as seeded
numpy checkpoint tensors (`mtp_tensors`, `eagle3_tensors`).
"""

import numpy as np

import jax

import tensorrt_llm_tpu as J
from tensorrt_llm_tpu.models.modeling_utils import ModelConfig as JCfg
from tensorrt_llm_tpu.quantization import QuantAlgo as JQA
from tensorrt_llm_tpu.quantization import QuantConfig as JQC
from tensorrt_llm_tpu.speculative import SpeculativeConfig as JSpec
import tensorrt_llm_tpu_torch as T
from tensorrt_llm_tpu_torch.models import ModelConfig, params_from_jax
from tensorrt_llm_tpu_torch.quantization import QuantAlgo, QuantConfig
from tensorrt_llm_tpu_torch.speculative import SpeculativeConfig as TSpec

from torch_parity import jax_generate, port_logits

# the JAX speculative tests' tiny model (tests/test_speculative.py)
TINY = dict(vocab_size=64, hidden_size=128, intermediate_size=256,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=32,
            max_position=256)
LLM_KW = dict(skip_tokenizer_init=True, max_seq_len=128, max_batch_size=8,
              kv_num_blocks=128, kv_block_size=8)


def configs(w4a16=False, jax_extra=None, port_extra=None, **over):
    """(JAX ModelConfig, port ModelConfig) of TINY with `over`, W4A16 at
    group 128 with `w4a16`."""
    shape = {**TINY, **over}
    jq = JQC(quant_algo=JQA.W4A16, group_size=128) if w4a16 else None
    tq = (QuantConfig(quant_algo=QuantAlgo.W4A16, group_size=128)
          if w4a16 else None)
    return (JCfg(**shape, **(jax_extra or {}), quant=jq),
            ModelConfig(**shape, **(port_extra or {}), quant=tq))


def _spec(cls, fields, side, jl):
    """`cls(**fields)`, calling the per-side fields (a callable whose
    value is None leaves its field out)."""
    if fields is None:
        return None
    kw = {}
    for k, v in fields.items():
        if callable(v) and k not in ("proposer", "tree_proposer",
                                     "mtp_weights"):
            v = v(side, jl)
            if v is None:
                continue
        kw[k] = v
    return cls(**kw)


def draft_model_of(**over):
    """DRAFT_TARGET's draft model: TINY (with `over`) on each side."""
    return lambda side, jl: configs(**over)[0 if side == "jax" else 1]


def greedy_params(mod, n, **kw):
    return mod.SamplingParams(max_tokens=n, temperature=0.0, ignore_eos=True,
                              **kw)


def run_pair(spec, prompts, n=24, seed=0, w4a16=False, llm_kw=None,
             jax_extra=None, port_extra=None, cfg_over=None):
    """Serve `prompts` on JAX and on the port under `spec`, and on a plain
    port LLM.  Returns dict(jax, port, plain: token lists; jax_stats,
    port_stats: spec_stats; params)."""
    jcfg, tcfg = configs(w4a16, jax_extra, port_extra, **(cfg_over or {}))
    kw = {**LLM_KW, **(llm_kw or {})}
    jl = J.LLM(model=jcfg, speculative_config=_spec(JSpec, spec, "jax", None),
               seed=seed, **kw)
    try:
        params = params_from_jax(jax.tree.map(np.asarray, jl.engine.params))
        jout = jax_generate(jl, prompts, greedy_params(J, n))
        jstats = dict(jl.executor.spec_stats)
        tspec = _spec(TSpec, spec, "port", jl)
    finally:
        jl.shutdown()
    plain = serve_port(tcfg, params, None, prompts, n, kw)
    tl = T.LLM(model=tcfg, device="cpu", params=params,
               speculative_config=tspec, **kw)
    try:
        tout = [o.outputs[0].token_ids
                for o in tl.generate(prompts, greedy_params(T, n))]
        tstats = dict(tl.executor.spec_stats)
    finally:
        tl.shutdown()
    return dict(jax=jout, port=tout, plain=plain, jax_stats=jstats,
                port_stats=tstats, params=params, cfg=tcfg, prompts=prompts)


def serve_port(tcfg, params, spec, prompts, n, kw, sampling=None):
    tl = T.LLM(model=tcfg, device="cpu", params=params,
               speculative_config=spec, **kw)
    try:
        return [o.outputs[0].token_ids for o in tl.generate(
            prompts, sampling or greedy_params(T, n))]
    finally:
        tl.shutdown()


TIE = 0.02   # ~2 bf16 ulps of the largest logits (test_torch_llm)


def assert_same_or_tie(cfg, params, prompts, got, want):
    """Token lists equal, or first different at a near-tie: the port's
    logits there (teacher forced on `want`) put both tokens within `TIE`
    of the top.  A verify chunk attends through the prefill path and a
    plain step through the decode path, whose bf16 roundings differ."""
    for p, a, b in zip(prompts, want, got):
        assert len(a) == len(b), (a, b)
        if a == b:
            continue
        i = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        logits = port_logits(cfg, params, list(p) + list(a[:i]))
        top = logits.max()
        assert logits[a[i]] >= top - TIE and logits[b[i]] >= top - TIE, (
            f"token {i} differs without a near-tie: {a[i]} "
            f"({logits[a[i]]}) against {b[i]} ({logits[b[i]]}), top {top}")


def assert_parity(r, min_rounds=1):
    """The port's tokens equal the JAX package's under the same config and
    its plain greedy (or first differ from it at a near-tie); its
    spec_stats equal JAX's exactly."""
    assert r["port"] == r["jax"], (r["port"], r["jax"])
    assert_same_or_tie(r["cfg"], r["params"], r["prompts"], r["port"],
                       r["plain"])
    assert r["port_stats"] == r["jax_stats"], (r["port_stats"],
                                               r["jax_stats"])
    assert r["port_stats"]["rounds"] >= min_rounds, r["port_stats"]


def draft_params_of(side, jl):
    """DRAFT_TARGET: the JAX drafter engine's weights, for the port."""
    if side == "jax":
        return None
    return params_from_jax(jax.tree.map(
        np.asarray, jl.executor.drafter.engine.params))


def _layer_tensors(rng, pre, H, I, nh, nkv, D):
    w = lambda *s: (rng.randn(*s) * 0.5 / np.sqrt(s[-1])).astype(np.float32)
    norm = lambda: (1 + 0.02 * rng.randn(H)).astype(np.float32)
    a = pre + "self_attn."
    return {pre + "input_layernorm.weight": norm(),
            pre + "post_attention_layernorm.weight": norm(),
            a + "q_proj.weight": w(nh * D, H), a + "k_proj.weight": w(nkv * D, H),
            a + "v_proj.weight": w(nkv * D, H), a + "o_proj.weight": w(H, nh * D),
            pre + "mlp.gate_proj.weight": w(I, H),
            pre + "mlp.up_proj.weight": w(I, H),
            pre + "mlp.down_proj.weight": w(H, I)}


def mtp_tensors(seed=0, shape=TINY):
    """A seeded MTP block under DeepSeek's names for a GQA model of
    `shape` (layer index num_layers)."""
    rng = np.random.RandomState(seed)
    H = shape["hidden_size"]
    pre = f"model.layers.{shape['num_layers']}."
    out = _layer_tensors(rng, pre, H, shape["intermediate_size"],
                         shape["num_heads"], shape["num_kv_heads"],
                         shape["head_dim"])
    out[pre + "eh_proj.weight"] = (rng.randn(H, 2 * H) * 0.5
                                   / np.sqrt(2 * H)).astype(np.float32)
    for n in ("enorm", "hnorm", "shared_head.norm"):
        out[pre + n + ".weight"] = (1 + 0.02 * rng.randn(H)).astype(
            np.float32)
    return out


def eagle3_tensors(seed=1, shape=TINY, draft_vocab=None):
    """A seeded EAGLE3 draft checkpoint: fc, the `midlayer.*` layer with
    its hidden norm, the final norm, and with `draft_vocab` a reduced head
    and its d2t table (draft id d -> target id 2d); plus an MTP block
    (`mtp_tensors`), the only names that reach the block's `eh_proj`,
    which both packages otherwise draw from their own generators."""
    rng = np.random.RandomState(seed)
    H = shape["hidden_size"]
    out = mtp_tensors(seed + 100, shape)
    out.update(_layer_tensors(rng, "midlayer.", H,
                              shape["intermediate_size"], shape["num_heads"],
                              shape["num_kv_heads"], shape["head_dim"]))
    out["fc.weight"] = (rng.randn(H, 3 * H) * 0.5
                        / np.sqrt(3 * H)).astype(np.float32)
    out["midlayer.hidden_norm.weight"] = (1 + 0.02 * rng.randn(H)).astype(
        np.float32)
    out["norm.weight"] = (1 + 0.02 * rng.randn(H)).astype(np.float32)
    if draft_vocab:
        out["lm_head.weight"] = (rng.randn(draft_vocab, H) * 0.05).astype(
            np.float32)
        out["d2t"] = np.arange(draft_vocab, dtype=np.int64)
    return out
