"""Draft-tree verification in the port: `tree_verify_attention` against the
JAX package's `tree_verify_attention_xla`, and tree speculation through
`LLM.generate` against the JAX package (same tokens, same `spec_stats`) and
the port's plain greedy (same tokens, or a first difference at a
near-tie).  Trees on MLA models are refused: the JAX MLA layer ignores the
pair mask, so the reference verifies such trees without their ancestor
mask (`test_reference_mla_tree_ignores_ancestor_mask` pins that finding).
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorrt_llm_tpu as J
from tensorrt_llm_tpu.models.modeling_utils import ModelConfig as JCfg
from tensorrt_llm_tpu.ops import attention_xla as jx
from tensorrt_llm_tpu.speculative import SpeculativeConfig as JSpec
from tensorrt_llm_tpu.speculative import SpeculativeMode as JM
import tensorrt_llm_tpu_torch as T
from tensorrt_llm_tpu_torch.models import ModelConfig
from tensorrt_llm_tpu_torch.ops.attention_plain import tree_verify_attention
from tensorrt_llm_tpu_torch.speculative import (
    SpeculativeConfig, SpeculativeMode)

from torch_spec import (LLM_KW, assert_parity, assert_same_or_tie,
                        configs, greedy_params, mtp_tensors, run_pair,
                        serve_port)

# a plain op against a plain op: one bf16 rounding of the output apart
ATOL = 2.0 ** -7


@pytest.fixture(autouse=True)
def _python_bookkeeping(monkeypatch):
    monkeypatch.setenv("TLLM_KV_BOOKKEEPING", "python")


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("int8,sinks,window", [
    (False, False, None), (True, False, None), (False, True, None),
    (False, False, 6), (True, True, 6)])
def test_tree_verify_attention_matches_jax(int8, sinks, window):
    """Committed rows (2) and a 4-node tree with a junk sibling at the
    root, over a 13-token prefix in a shuffled table; bf16 or INT8 pools
    (filled through the JAX append path), sinks, a sliding window."""
    rng = np.random.default_rng(int8 * 4 + sinks * 2 + bool(window))
    Hq, Hkv, D, BS, MB = 8, 2, 64, 4, 6
    NB = MB + 2
    prefix = 13
    bf = lambda *s: jnp.asarray(rng.standard_normal(s, np.float32)  # noqa
                                ).astype(jnp.bfloat16)
    if int8:
        zero = lambda: (jnp.zeros((NB, Hkv, BS, D), jnp.int8),  # noqa
                        jnp.zeros((NB, Hkv, BS), jnp.float32))
    else:
        zero = lambda: jnp.zeros((NB, Hkv, BS, D), jnp.bfloat16)  # noqa
    table = rng.permutation(np.arange(1, NB))[:MB].astype(np.int32)
    pos = np.arange(prefix)
    kc, vc = jx.write_kv_cache(zero(), zero(), bf(prefix, Hkv, D),
                               bf(prefix, Hkv, D),
                               jnp.asarray(table[pos // BS] * BS + pos % BS))
    C, parents = 2, [-1, -1, 0, 2]       # node 1: the junk sibling
    depth = [1, 1, 2, 3]
    positions = np.array([prefix, prefix + 1]
                         + [prefix + 1 + d for d in depth], np.int32)
    Tn = C + len(parents)
    mask = np.tril(np.ones((Tn, Tn), bool))
    mask[C:, C:] = False
    for i in range(len(parents)):
        j = i
        while j >= 0:
            mask[C + i, C + j] = True
            j = parents[j]
    q, kn, vn = bf(Tn, Hq, D), bf(Tn, Hkv, D), bf(Tn, Hkv, D)
    snk = jnp.asarray(rng.standard_normal(Hq, np.float32)) if sinks else None
    ref = jx.tree_verify_attention_xla(
        q, kc, vc, kn, vn, jnp.asarray(table), jnp.int32(prefix),
        jnp.asarray(positions), jnp.asarray(mask), D ** -0.5,
        sliding_window=window, sinks=snk)
    pool = (lambda c: tuple(_t(a) for a in c)) if int8 else _t
    out = tree_verify_attention(
        _t(q), pool(kc), pool(vc), _t(kn), _t(vn), torch.from_numpy(table),
        prefix, torch.from_numpy(positions.astype(np.int64)),
        torch.from_numpy(mask), D ** -0.5, sliding_window=window,
        sinks=None if snk is None else _t(snk))
    ref = np.asarray(ref, np.float32)
    big = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(out.to(torch.float32).numpy(), ref,
                               atol=ATOL * big, rtol=0)


def junk_tree(request):
    """The JAX tree tests' adversarial proposer: 3 random roots, one
    random child each."""
    rng = np.random.default_rng(request.num_tokens)
    toks = [int(rng.integers(1, 63)) for _ in range(6)]
    return toks, [-1, -1, -1, 0, 1, 2]


def _mode(name):
    return lambda side, jl: JM(name) if side == "jax" \
        else SpeculativeMode(name)


def test_junk_tree_matches_jax_and_plain():
    r = run_pair(dict(mode=_mode("USER_PROVIDED"), tree_proposer=junk_tree,
                      max_draft_len=6), [[3, 5, 3, 5, 3, 5, 7]])
    assert_parity(r)


@pytest.mark.parametrize("w4a16", [False, True], ids=["bf16", "w4a16"])
def test_oracle_tree_accepts_deep_paths(w4a16):
    """The plain run's own next tokens as a chain, plus a junk sibling at
    the root (the `spec` chip phase's oracle tree)."""
    prompt = [2, 9, 2, 9, 11]
    jcfg, tcfg = configs(w4a16)
    jl = J.LLM(model=jcfg, seed=0, **LLM_KW)
    try:
        from torch_parity import jax_generate
        want = jax_generate(jl, [prompt], greedy_params(J, 20))[0]
    finally:
        jl.shutdown()

    def oracle(request):
        i = request.num_output_tokens
        chain = want[i:i + 3]
        if len(chain) < 3:
            return None
        return [chain[0], 63, chain[1], chain[2]], [-1, -1, 0, 2]

    r = run_pair(dict(mode=_mode("USER_PROVIDED"), tree_proposer=oracle,
                      max_draft_len=6), [prompt], n=20, w4a16=w4a16)
    assert_parity(r)
    st = r["port_stats"]
    assert st["accepted"] >= st["rounds"], st


def test_mtp_tree_matches_jax_and_plain():
    w = mtp_tensors(seed=4)
    r = run_pair(dict(mode=_mode("MTP"), max_draft_len=4,
                      tree_branches=(2, 2), mtp_weights=w.get),
                 [[4, 8, 4, 8, 15]], seed=3)
    assert_parity(r)


def test_tree_with_sliding_layers():
    """Tree verification over sliding-window layers, both sides on their
    VSWA ring pools (the tree rows read the ring before their writes)."""
    r = run_pair(dict(mode=_mode("USER_PROVIDED"), tree_proposer=junk_tree,
                      max_draft_len=6), [list(range(2, 22))], seed=5,
                 cfg_over=dict(sliding_window=16, num_layers=3),
                 jax_extra=dict(sliding_window_pattern=2),
                 port_extra=dict(layer_types=(
                     "sliding_attention", "full_attention",
                     "sliding_attention")))
    assert_parity(r)


def test_tree_then_stop_flushes_pending():
    """max_tokens reached inside a tree round: the request ends cleanly,
    and a following request on the same LLM decodes as plain greedy."""
    spec = SpeculativeConfig(mode=SpeculativeMode.USER_PROVIDED,
                             tree_proposer=junk_tree, max_draft_len=6)
    _, tcfg = configs()
    llm = T.LLM(model=tcfg, device="cpu", seed=0, speculative_config=spec,
                **LLM_KW)
    try:
        a = llm.generate([[7, 7, 7]], greedy_params(T, 3))[0]
        assert len(a.outputs[0].token_ids) == 3
        b = llm.generate([[9, 1, 9]], greedy_params(T, 5))[0]
        params = llm.model.state()
        assert llm.kv_manager.stats()["active_sequences"] == 0
    finally:
        llm.shutdown()
    plain = serve_port(tcfg, params, None, [[9, 1, 9]], 5, LLM_KW)
    assert_same_or_tie(tcfg, params, [[9, 1, 9]],
                       [b.outputs[0].token_ids], plain)


def test_pending_tree_kv_flushed_when_gate_flips():
    """Request A speculates alone on oracle trees (every round accepts, so
    accepted KV is left pending); its second tree call submits B, and the
    batch of 2 then passes max_concurrency 1: A decodes normally from
    there, and its pending KV must be written first (one flush forward
    beyond the tree rounds)."""
    prompts = [[3, 5, 3, 5, 3], [7, 2, 7, 2, 7]]
    _, tcfg = configs()
    plain_llm = T.LLM(model=tcfg, device="cpu", seed=12, **LLM_KW)
    try:
        want = [o.outputs[0].token_ids for o in plain_llm.generate(
            prompts, greedy_params(T, 12))]
        params = plain_llm.model.state()
    finally:
        plain_llm.shutdown()
    box = {"calls": 0}

    def tree(request):
        w = want[0]
        i = request.num_output_tokens
        if request.prompt_token_ids != prompts[0] or i + 2 > len(w) \
                or request.output_token_ids != w[:i]:
            return None
        box["calls"] += 1
        if box["calls"] == 2:
            box["b"] = llm.generate_async(prompts[1], greedy_params(T, 12))
        return [w[i], (w[i] + 1) % 64, w[i + 1]], [-1, -1, 0]

    spec = SpeculativeConfig(mode=SpeculativeMode.USER_PROVIDED,
                             tree_proposer=tree, proposer=lambda r: [],
                             max_draft_len=3, max_concurrency=1)
    llm = T.LLM(model=tcfg, device="cpu", params=params,
                speculative_config=spec, **LLM_KW)
    try:
        a = llm.generate(prompts[0], greedy_params(T, 12))[0]
        got = [a.outputs[0].token_ids,
               box["b"].result().outputs[0].token_ids]
        stats = llm.get_stats()
        rounds = llm.executor.spec_stats["rounds"]
    finally:
        llm.shutdown()
    assert rounds >= 2 and llm.executor.spec_stats["accepted"] >= rounds
    assert sum(s["spec_tree_forwards"] for s in stats) > rounds, stats
    assert_same_or_tie(tcfg, params, prompts, got, want)


def test_tree_rows_see_their_ancestors_only():
    """Each tree node's logits row equals the last row of a plain prefill
    of the prompt and the node's ancestor path (the engine's tree step
    under the executor's mask: siblings and cousins are invisible)."""
    from tensorrt_llm_tpu_torch.runtime.request import LlmRequest
    _, tcfg = configs()
    prompt = [3, 9, 4, 1, 5, 9, 2, 6, 5, 3]
    tokens = [7, 8, 9, 10, 11, 12]
    parents = [-1, -1, 0, 1, 2, 0]
    llm = T.LLM(model=tcfg, device="cpu", seed=7, **LLM_KW)
    try:
        ex, eng, kv = llm.executor, llm.engine, llm.kv_manager

        def run():
            req = LlmRequest(prompt, greedy_params(T, 8))
            kv.add_sequence(req.request_id, prompt, "tree-test")
            kv.grow_sequence(req.request_id, len(prompt))
            eng.run_prefill(eng.prepare_prefill_inputs(req, len(prompt) - 1))
            req.context_position = len(prompt) - 1
            box = {}

            class Drafter:
                cfg = None
                needs_hidden = False

                def on_accepted(self, r, toks):
                    box["accepted"] = toks

                def on_hidden(self, *a):
                    pass

            saved = ex.drafter
            ex.drafter = Drafter()
            try:
                req.start_context()
                req.context_position = len(prompt)
                req.finish_context()
                orig = eng.run_verify_tree

                def capture(inputs, mask, **kw):
                    box["logits"] = orig(inputs, mask, **kw)
                    box["mask"] = mask
                    return box["logits"]

                eng.run_verify_tree = capture
                # the committed last prompt token is row 0 (P = 0)
                ex._verify_tree(req, tokens, parents, type(
                    "S", (), {"spec_tree_forwards": 0, "spec_rounds": 0})())
            finally:
                eng.run_verify_tree = orig
                ex.drafter = saved
                kv.free_sequence(req.request_id)
            return box

        box = ex.call_between_steps(run)
        rows = box["logits"].numpy()
        for i in range(len(tokens)):
            path, j = [], i
            while j >= 0:
                path.insert(0, tokens[j])
                j = parents[j]
            ref = llm.generate([prompt + path], T.SamplingParams(
                max_tokens=1, temperature=0.0, logprobs=1,
                return_generation_logits=True), cache_salt=f"p{i}")[0]
            want = ref.outputs[0].generation_logits[0]
            # one bf16 rounding of the largest logit (both run the plain
            # ops on the CPU; a sibling in view moves a row by ~0.17)
            np.testing.assert_allclose(
                rows[1 + i], want, atol=ATOL * np.abs(want).max(), rtol=0)
    finally:
        llm.shutdown()


# ---- MLA: trees refused -------------------------------------------------
MLA = dict(vocab_size=64, hidden_size=64, intermediate_size=128,
           num_layers=2, num_heads=2, num_kv_heads=2, head_dim=16,
           max_position=256, q_lora_rank=None, kv_lora_rank=32,
           qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
           architecture="DeepseekV3ForCausalLM")


def test_reference_mla_tree_ignores_ancestor_mask():
    """The finding behind the refusal: the JAX MLA layer never reads the
    pair mask, so MTP trees on a tiny MLA model change JAX's greedy
    tokens (its linear MTP keeps them)."""
    def run(spec):
        llm = J.LLM(model=JCfg(**MLA), speculative_config=spec, seed=3,
                    **LLM_KW)
        try:
            return llm.generate([4, 8, 4, 8, 15], greedy_params(J, 24))[0] \
                .outputs[0].token_ids
        finally:
            llm.shutdown()

    plain = run(None)
    chain = run(JSpec(mode=JM.MTP, max_draft_len=4))
    tree = run(JSpec(mode=JM.MTP, max_draft_len=4, tree_branches=(2, 2)))
    assert chain == plain
    assert tree != plain


def _mla_llm(spec):
    return T.LLM(model=ModelConfig(**MLA), device="cpu", seed=0,
                 speculative_config=spec, **LLM_KW)


@pytest.mark.parametrize("spec", [
    dict(mode=SpeculativeMode.MTP, max_draft_len=4, tree_branches=(2, 2)),
    dict(mode=SpeculativeMode.MEDUSA, max_draft_len=3,
         medusa_choices=[(0,), (1,), (0, 0)])], ids=["mtp", "medusa"])
def test_mla_configured_tree_refused_at_construction(spec):
    with pytest.raises(NotImplementedError, match="MLA"):
        _mla_llm(SpeculativeConfig(**spec))


def test_mla_tree_proposer_refused_at_first_tree():
    """A tree proposer may answer None (a chain); its first tree on an MLA
    model ends that request with the refusal, and the executor serves on."""
    def proposer(request):
        return None if request.num_output_tokens < 3 else ([5, 6], [-1, 0])

    llm = _mla_llm(SpeculativeConfig(mode=SpeculativeMode.USER_PROVIDED,
                                     tree_proposer=proposer,
                                     proposer=lambda r: [r.all_token_ids[-1]],
                                     max_draft_len=2))
    try:
        with pytest.raises(RuntimeError, match="MLA"):
            llm.generate([4, 8, 4, 8], greedy_params(T, 8))
        plain = llm.generate([4, 8], greedy_params(T, 2))
        assert len(plain[0].outputs[0].token_ids) == 2
    finally:
        llm.shutdown()


def test_mla_linear_mtp_runs_and_dsa_refused():
    """Linear MTP on MLA serves; MTP on a DSA config is refused (the JAX
    block's pool has no indexer pool)."""
    llm = _mla_llm(SpeculativeConfig(mode=SpeculativeMode.MTP,
                                     max_draft_len=3))
    try:
        out = llm.generate([4, 8, 4, 8, 15], greedy_params(T, 8))
        assert len(out[0].outputs[0].token_ids) == 8
        assert llm.executor.spec_stats["rounds"] > 0
    finally:
        llm.shutdown()
    dsa = dict(MLA, q_lora_rank=32, sparse_attention=dict(
        algo="dsa", index_n_heads=2, index_head_dim=16, index_topk=8))
    with pytest.raises(NotImplementedError, match="DSA"):
        T.LLM(model=ModelConfig(**dsa), device="cpu", seed=0,
              speculative_config=SpeculativeConfig(
                  mode=SpeculativeMode.MTP), **LLM_KW)
