"""Port parity for LoRA: adapters merged at load (`lora_path`) and served
per request (`lora_adapters`, `lora_max_device_adapters`) against the JAX
package, on a tiny Llama checkpoint (f32 safetensors) and PEFT adapter
directories that the tests write from seeds.

* Loading and merging: `load_lora_adapter` (safetensors and ``.bin``,
  rsLoRA, a `rank_pattern` module, DoRA magnitudes) and
  `merge_lora_into_state` equal JAX's exactly (both merge in numpy f32).
* Stacks: `MultiLoraManager.build_layer_lora` equals JAX's exactly, also
  with the paged pool-wide ranks; the installed stacks equal
  `params_from_jax` of the JAX `LLM`'s.  `apply_lora` equals JAX's within
  one bf16 rounding of the output (`APPLY_TOL` relative).
* Serving: greedy tokens of a batch mixing base rows and three adapters
  equal the JAX `LLM`'s, each row's tokens equal the row served alone and
  the adapter merged with `lora_path`; `lora_path` under W4A16 loads the
  JAX package's state and tokens; the paged cache (2 slots, 3 and 4
  adapters) swaps, gives the unpaged tokens, leaves base rows untouched and
  releases every pin, also under concurrent load; the prefix-reuse salt
  keys on the adapter; an NGram speculative request and the overlap
  pipeline keep the adapter.
* The reference fault: JAX's beams decode on the base model after an
  adapter prefill; the port's keep the adapter in every step.
* Refusals: an unknown adapter, runtime DoRA, adapters on an MLA model or
  on MoE layers, `lora_path` without a checkpoint.
"""

import json
import os
import time

import jax
import numpy as np
import pytest
import torch

import tensorrt_llm_tpu as J
from tensorrt_llm_tpu.lora import lora_manager as jlm
from tensorrt_llm_tpu.lora import multi_lora as jml
import tensorrt_llm_tpu_torch as T
from tensorrt_llm_tpu_torch.lora import lora_manager as tlm
from tensorrt_llm_tpu_torch.lora import multi_lora as tml
from tensorrt_llm_tpu_torch.models import ModelConfig, params_from_jax
from tensorrt_llm_tpu_torch.speculative import SpeculativeConfig

from torch_parity import write_hf_checkpoint

HF = dict(architectures=["LlamaForCausalLM"], model_type="llama",
          vocab_size=96, hidden_size=64, intermediate_size=128,
          num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
          head_dim=16, max_position_embeddings=128)
H, I, NH, NKV, D = 64, 128, 4, 2, 16
MODS = {"q_proj": (H, NH * D), "k_proj": (H, NKV * D), "v_proj": (H, NKV * D),
        "o_proj": (NH * D, H), "gate_proj": (H, I), "up_proj": (H, I),
        "down_proj": (I, H)}
LLM_KW = dict(skip_tokenizer_init=True, max_seq_len=64, max_batch_size=8,
              kv_num_blocks=64, kv_block_size=8)
SP = dict(max_tokens=6, temperature=0.0, ignore_eos=True)
PROMPT = [3, 7, 11, 13]
APPLY_TOL = 2 ** -7    # one bf16 rounding of the output, relative
BEAM_EPS = 0.05        # decode-vs-prefill logprob noise (test_beam_search)


def write_adapter(d, seed, r=4, alpha=16.0, mods=("q_proj", "v_proj",
                                                  "gate_proj"),
                  rslora=False, rank_pattern=None, dora=False, fmt="st"):
    """A PEFT adapter directory: lora_A [r, in] / lora_B [out, r] per
    targeted module of each layer, f32, N(0, 0.3^2)."""
    os.makedirs(d, exist_ok=True)
    rng = np.random.RandomState(seed)
    tensors = {}
    for i in range(HF["num_hidden_layers"]):
        for m in mods:
            din, dout = MODS[m]
            sub = "self_attn" if m[0] in "qkvo" else "mlp"
            mod = f"model.layers.{i}.{sub}.{m}"
            rr = (rank_pattern or {}).get(m, r)
            tensors[f"base_model.model.{mod}.lora_A.weight"] = \
                (rng.randn(rr, din) * 0.3).astype(np.float32)
            tensors[f"base_model.model.{mod}.lora_B.weight"] = \
                (rng.randn(dout, rr) * 0.3).astype(np.float32)
            if dora:
                tensors[f"base_model.model.{mod}.lora_magnitude_vector"] = \
                    (1.0 + rng.rand(dout)).astype(np.float32)
    if fmt == "st":
        from safetensors.numpy import save_file
        save_file(tensors, os.path.join(d, "adapter_model.safetensors"))
    else:
        torch.save({k: torch.from_numpy(v) for k, v in tensors.items()},
                   os.path.join(d, "adapter_model.bin"))
    with open(os.path.join(d, "adapter_config.json"), "w") as f:
        json.dump({"r": r, "lora_alpha": alpha, "use_rslora": rslora,
                   "use_dora": dora,
                   "rank_pattern": rank_pattern or {}}, f)
    return d


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("lora")
    ckpt = root / "ckpt"
    ckpt.mkdir()
    write_hf_checkpoint(ckpt, HF, seed=3, dtype=torch.float32, shards=1)
    # a: q/v/gate rank 4; b: every module, rsLoRA, rank_pattern on o and
    # down; c: rank 8 on o and up only
    ad = {"a": write_adapter(str(root / "a"), 1),
          "b": write_adapter(str(root / "b"), 2, r=2, mods=tuple(MODS),
                             rslora=True,
                             rank_pattern={"o_proj": 6, "down_proj": 3}),
          "c": write_adapter(str(root / "c"), 3, r=8,
                             mods=("o_proj", "up_proj"))}
    return str(ckpt), ad, root


def _jax_llm(model, **kw):
    os.environ["TLLM_KV_BOOKKEEPING"] = "python"
    try:
        return J.LLM(model=model, **LLM_KW, **kw)
    finally:
        del os.environ["TLLM_KV_BOOKKEEPING"]


@pytest.fixture(scope="module")
def multi(files):
    """The JAX and port `LLM`s serving the three adapters at once."""
    ckpt, ad, _ = files
    jl = _jax_llm(ckpt, lora_adapters=ad)
    tl = T.LLM(model=ckpt, device="cpu", lora_adapters=ad, **LLM_KW)
    yield jl, tl
    jl.shutdown()
    tl.shutdown()


def _toks(llm, sp_mod, prompts, lora=None, **sp):
    kw = dict(SP, **sp)
    return [o.outputs[0].token_ids for o in llm.generate(
        prompts, sp_mod.SamplingParams(**kw), lora_request=lora)]


def _jax_toks(jl, lora, prompt=PROMPT, **sp):
    return jl.generate_async(prompt, J.SamplingParams(**dict(SP, **sp)),
                             lora_request=lora).result().outputs[0].token_ids


# ------------------------------------------------------- loading, merging --
@pytest.mark.parametrize("fmt", ["st", "bin"])
def test_load_adapter_matches_jax(files, fmt):
    _, _, root = files
    d = write_adapter(str(root / f"load_{fmt}"), 7, r=2, mods=tuple(MODS),
                      rslora=True, rank_pattern={"up_proj": 5}, dora=True,
                      fmt=fmt)
    want, got = jlm.load_lora_adapter(d), tlm.load_lora_adapter(d)
    assert (got.rank, got.alpha, got.use_rslora, got.is_dora) == \
        (want.rank, want.alpha, want.use_rslora, want.is_dora)
    assert sorted(got.weights) == sorted(want.weights)
    for k, (A, B) in want.weights.items():
        assert np.array_equal(got.weights[k][0], A)
        assert np.array_equal(got.weights[k][1], B)
        assert got.module_scaling(A.shape[0]) == \
            want.module_scaling(A.shape[0])
    assert all(np.array_equal(got.magnitudes[k], v)
               for k, v in want.magnitudes.items())
    assert got.scaling == want.scaling


@pytest.mark.parametrize("kind", ["plain", "rslora_rank_pattern", "dora"])
def test_merge_matches_jax(files, kind):
    ckpt, ad, root = files
    if kind == "plain":
        d = ad["a"]
    elif kind == "rslora_rank_pattern":
        d = ad["b"]
    else:
        d = write_adapter(str(root / "merge_dora"), 9, r=2, mods=tuple(MODS),
                          dora=True)
    from tensorrt_llm_tpu_torch.llmapi.hf_checkpoint import SafetensorsReader
    with SafetensorsReader(ckpt) as r:
        jget = jlm.merge_lora_into_state(lambda n: (
            None if r(n) is None else r(n).numpy()), jlm.load_lora_adapter(d))
        tget = tlm.merge_lora_into_state(r, tlm.load_lora_adapter(d))
        n = 0
        for name in r.keys():
            a, b = np.asarray(jget(name)), tget(name)
            assert np.array_equal(a, b.numpy()), name
            n += not np.array_equal(a, r(name).numpy())
    assert n == 2 * (7 if kind != "plain" else 3)


def test_stacks_match_jax(files, multi):
    ckpt, ad, _ = files
    jl, tl = multi
    cfg = tl.model_config
    adapters = {n: tlm.load_lora_adapter(p) for n, p in ad.items()}
    jads = {n: jlm.load_lora_adapter(p) for n, p in ad.items()}
    jcfg = jl.model.cfg
    for paged in (False, True):
        tm = tml.MultiLoraManager(adapters, cfg)
        jm = jml.MultiLoraManager(jads, jcfg)
        if paged:       # pool-wide ranks, one adapter resident
            tm = tml.MultiLoraManager({"c": adapters["c"]}, cfg)
            tm._rank_adapters = adapters
            jm = jml.MultiLoraManager({"c": jads["c"]}, jcfg)
            jm._rank_adapters = jads
        for i in range(cfg.num_layers):
            want, got = jm.build_layer_lora(i), tm.build_layer_lora(i)
            assert sorted(want) == sorted(got) == ["down", "gate_up", "o",
                                                   "qkv"]
            for k in want:
                assert all(np.array_equal(x, y)
                           for x, y in zip(want[k], got[k])), (paged, i, k)
    # the installed stacks are the JAX LLM's, bf16 bit for bit
    state = params_from_jax(jax.tree.map(np.asarray, jl.engine.params))
    mine = tl.model.state()
    keys = [k for k in state if ".lora_" in k]
    assert len(keys) == 2 * 4 * cfg.num_layers
    for k in keys:
        assert torch.equal(mine[k], state[k]), k


@pytest.mark.parametrize("T_rows", [1, 5])
def test_apply_lora_matches_jax(T_rows):
    import jax.numpy as jnp
    rng = np.random.default_rng(T_rows)
    L, din, R, dout = 4, 64, 12, 96
    A = rng.standard_normal((L, din, R)).astype(np.float32) * 0.3
    B = rng.standard_normal((L, R, dout)).astype(np.float32) * 0.3
    A[0] = B[0] = 0
    x = rng.standard_normal((T_rows, din)).astype(np.float32)
    base = rng.standard_normal((T_rows, dout)).astype(np.float32)
    ids = rng.integers(0, L, T_rows).astype(np.int32)
    ids[0] = 2
    bf = jnp.bfloat16
    want = np.asarray(jml.apply_lora(
        jnp.asarray(x).astype(bf), jnp.asarray(base).astype(bf),
        (jnp.asarray(A).astype(bf), jnp.asarray(B).astype(bf)),
        jnp.asarray(ids)).astype(jnp.float32))
    tb = torch.bfloat16
    got = tml.apply_lora(
        torch.from_numpy(x).to(tb), torch.from_numpy(base).to(tb),
        (torch.from_numpy(A).to(tb), torch.from_numpy(B).to(tb)),
        torch.from_numpy(ids.astype(np.int64))).float().numpy()
    assert np.allclose(got, want, rtol=APPLY_TOL, atol=APPLY_TOL)
    # slot 0 adds exactly nothing
    zero = ids == 0
    assert np.array_equal(got[zero], torch.from_numpy(base).to(tb)
                          .float().numpy()[zero])


# --------------------------------------------------------------- serving --
def test_multi_lora_tokens_match_jax(multi):
    """A batch of base rows and all three adapters: the JAX tokens, each
    row's tokens alone, and adapters that change the output."""
    jl, tl = multi
    names = [None, "a", "b", "c"]
    want = [_jax_toks(jl, n) for n in names]
    got = _toks(tl, T, [PROMPT] * 4, names)
    assert got == want
    alone = [_toks(tl, T, [PROMPT], n)[0] for n in names]
    assert alone == got
    assert len({tuple(t) for t in got}) > 1


def test_multi_lora_matches_merged(files, multi):
    """Runtime adapters give the tokens of the adapter merged at load."""
    ckpt, ad, _ = files
    _, tl = multi
    for n in ("a", "b"):
        merged = T.LLM(model=ckpt, device="cpu", lora_path=ad[n], **LLM_KW)
        try:
            assert _toks(merged, T, [PROMPT]) == _toks(tl, T, [PROMPT], n)
        finally:
            merged.shutdown()


def test_lora_path_w4a16_matches_jax(files):
    """`lora_path` merges before W4A16 quantization: the port's state and
    greedy tokens equal the JAX `LLM`'s."""
    ckpt, ad, _ = files
    jl = _jax_llm(ckpt, lora_path=ad["b"], quant_algo="W4A16",
                  quant_group_size=64)
    try:
        state = params_from_jax(jax.tree.map(np.asarray, jl.engine.params))
        want = jl.generate([PROMPT], J.SamplingParams(**SP))[0] \
            .outputs[0].token_ids
    finally:
        jl.shutdown()
    tl = T.LLM(model=ckpt, device="cpu", lora_path=ad["b"],
               quant_algo="W4A16", quant_group_size=64, **LLM_KW)
    try:
        # RoPE tables are computed, not loaded; f32 scales the port keeps
        # in bf16 after bf16 rounding
        mine = {k: v for k, v in tl.model.state().items()
                if not k.startswith("rope_")}
        assert sorted(mine) == sorted(k for k in state
                                      if not k.startswith("rope_"))
        for k, g in mine.items():
            assert torch.equal(g, state[k].to(g.dtype)), k
        assert _toks(tl, T, [PROMPT]) == [want]
    finally:
        tl.shutdown()


def test_unknown_adapter_and_missing_adapters_refused(files, multi):
    ckpt, _, _ = files
    _, tl = multi
    with pytest.raises(KeyError):
        tl.generate_async(PROMPT, T.SamplingParams(**SP),
                          lora_request="nope")
    with pytest.raises(KeyError):
        tl.generate([PROMPT], T.SamplingParams(**SP), lora_request="nope")
    with pytest.raises(ValueError, match="lora_request"):
        tl.generate([PROMPT, PROMPT], T.SamplingParams(**SP),
                    lora_request=["a"])
    plain = T.LLM(model=ckpt, device="cpu", **LLM_KW)
    try:
        with pytest.raises(ValueError, match="lora_adapters"):
            plain.generate([PROMPT], T.SamplingParams(**SP),
                           lora_request="a")
    finally:
        plain.shutdown()


def test_kv_reuse_keyed_on_adapter(multi):
    """Cached blocks serve only prompts of the same adapter."""
    _, tl = multi
    prompt = list(range(1, 30))

    def cached(lora):
        fut = tl.generate_async(prompt, T.SamplingParams(
            max_tokens=1, ignore_eos=True), lora_request=lora)
        fut.result()
        return fut.req.num_cached_tokens

    cached(None)
    assert cached("a") == 0          # the base model's blocks: not reused
    assert cached("a") > 0           # the same adapter's: reused
    assert cached("b") == 0


def test_paged_swaps_match_unpaged(files, multi):
    """Three adapters in two slots: each adapter's tokens equal the
    unpaged manager's, serving in turn swaps, a batch of all three rotates
    through the slots, base rows stay the plain model's, and every pin is
    released."""
    ckpt, ad, _ = files
    _, tl = multi
    want = {n: _toks(tl, T, [PROMPT], n)[0] for n in (None, "a", "b", "c")}
    plain = T.LLM(model=ckpt, device="cpu", **LLM_KW)
    try:
        base = _toks(plain, T, [PROMPT])[0]
    finally:
        plain.shutdown()
    assert base == want[None]
    paged = T.LLM(model=ckpt, device="cpu", lora_adapters=ad,
                  lora_max_device_adapters=2, **LLM_KW)
    try:
        mgr = paged.lora_manager
        assert isinstance(mgr, tml.PagedMultiLoraManager)
        assert _toks(paged, T, [PROMPT])[0] == base and mgr.num_swaps == 0
        for n in ("a", "b", "c", "a"):
            assert _toks(paged, T, [PROMPT], n)[0] == want[n], n
        assert mgr.num_swaps >= 2
        names = [None, "a", "b", "c"]
        assert _toks(paged, T, [PROMPT] * 4, names) == \
            [want[n] for n in names]
        assert all(v == 0 for v in mgr._refs.values()), mgr._refs
    finally:
        paged.shutdown()


def test_paged_rotation_under_concurrent_load(files, multi):
    """Four adapters, two slots, eight requests in flight at once from
    several threads: acquire waits for a slot instead of failing."""
    import concurrent.futures as cf
    ckpt, ad, root = files
    _, tl = multi
    ad4 = dict(ad, d=write_adapter(str(root / "d"), 4, r=2))
    want = {n: _toks(tl, T, [PROMPT], n)[0] for n in ("a", "b", "c")}
    paged = T.LLM(model=ckpt, device="cpu", lora_adapters=ad4,
                  lora_max_device_adapters=2, **LLM_KW)
    try:
        names = ["a", "b", "c", "d"] * 2
        with cf.ThreadPoolExecutor(8) as pool:
            got = list(pool.map(
                lambda n: paged.generate_async(
                    PROMPT, T.SamplingParams(**SP), lora_request=n)
                .result(timeout=120).outputs[0].token_ids, names))
        for n, g in zip(names, got):
            if n in want:
                assert g == want[n], n
        assert got[3] == got[7]
        assert paged.lora_manager.num_swaps >= 2
        for _ in range(100):
            if all(v == 0 for v in paged.lora_manager._refs.values()):
                break
            time.sleep(0.05)
        assert all(v == 0 for v in paged.lora_manager._refs.values())
    finally:
        paged.shutdown()


def test_ngram_speculation_keeps_adapter(files, multi):
    """An NGram speculative request with an adapter gives the adapter's
    plain greedy tokens: verify rows carry the slot."""
    ckpt, ad, _ = files
    _, tl = multi
    prompt = [6, 3, 6, 3, 6, 3, 6, 3, 12]
    want = _toks(tl, T, [prompt], "c", max_tokens=12)
    spec = T.LLM(model=ckpt, device="cpu", lora_adapters=ad,
                 speculative_config=SpeculativeConfig(max_draft_len=3),
                 **LLM_KW)
    try:
        assert _toks(spec, T, [prompt], "c", max_tokens=12) == want
        assert spec.executor.spec_stats["rounds"] > 0
    finally:
        spec.shutdown()


def test_overlap_on_and_off_agree(files, multi):
    ckpt, ad, _ = files
    names = [None, "a", "b", "c", "a"]
    prompts = [PROMPT, [1, 2, 3], [9, 8, 7, 6, 5], [4, 4], [2, 5, 8, 11]]
    res = []
    for overlap in (True, False):
        llm = T.LLM(model=ckpt, device="cpu", lora_adapters=ad,
                    disable_overlap_scheduler=not overlap,
                    max_decode_steps=4, **LLM_KW)
        try:
            llm.executor._force_lag = True
            res.append(_toks(llm, T, prompts, names, max_tokens=12))
        finally:
            llm.shutdown()
    assert res[0] == res[1]


# ------------------------------------------------------ the reference fault --
def _path_score(tl, prompt, toks, prefill_slot, decode_slot):
    """Summed logprob of `toks` after `prompt` on the port's engine, teacher
    forced: the prompt prefilled under adapter slot `prefill_slot`, each
    later token decoded under `decode_slot` (the path a beam takes)."""
    from tensorrt_llm_tpu_torch.runtime.request import LlmRequest
    eng, kv = tl.engine, tl.kv_manager

    def run():
        req = LlmRequest(list(prompt), T.SamplingParams(max_tokens=1))
        rid = req.request_id
        req.lora_slot = prefill_slot
        kv.add_sequence(rid, req.prompt_token_ids, "path-score")
        try:
            kv.grow_sequence(rid, req.prompt_len)
            logits = eng.run_prefill(eng.prepare_prefill_inputs(
                req, req.prompt_len))
            req.context_position = req.prompt_len
            req.lora_slot = decode_slot
            total = 0.0
            for j, t in enumerate(toks):
                row = logits[-1].numpy().astype(np.float32)
                row = row - row.max()
                total += float(row[t] - np.log(np.exp(row).sum()))
                if j + 1 < len(toks):
                    req.output_token_ids.append(t)
                    kv.grow_sequence(rid, req.num_tokens)
                    logits = eng.run_decode(eng.prepare_decode_inputs([req]))
            return total
        finally:
            kv.free_sequence(rid)
    return tl.executor.call_between_steps(run)


def test_beams_keep_the_adapter(multi):
    """JAX's beam steps drop the adapter (its beam sequences carry no
    slot): its beam 0 scores as the prompt and first token under the
    adapter and every later step on the base model.  The port's beam 0
    scores as every step under the adapter, and differs from the same
    request's base beams."""
    jl, tl = multi
    kw = dict(max_tokens=5, n=3, use_beam_search=True, ignore_eos=True)
    slot = tl.lora_manager.slot_of("a")
    jb = jl.generate_async(PROMPT, J.SamplingParams(**kw),
                           lora_request="a").result().outputs[0]
    tb = tl.generate([PROMPT], T.SamplingParams(**kw),
                     lora_request="a")[0].outputs[0]
    base = tl.generate([PROMPT], T.SamplingParams(**kw))[0].outputs[0]
    assert tb.token_ids != base.token_ids
    assert abs(tb.cumulative_logprob - _path_score(
        tl, PROMPT, tb.token_ids, slot, slot)) < BEAM_EPS
    jt = jb.token_ids
    assert abs(jb.cumulative_logprob - _path_score(
        tl, PROMPT, jt, slot, 0)) < BEAM_EPS
    assert abs(jb.cumulative_logprob - _path_score(
        tl, PROMPT, jt, slot, slot)) > 10 * BEAM_EPS


# -------------------------------------------------------------- refusals --
def test_refusals(files):
    ckpt, ad, root = files
    dora = write_adapter(str(root / "dora"), 5, r=2, dora=True)
    with pytest.raises(ValueError, match="DoRA"):
        T.LLM(model=ckpt, device="cpu", lora_adapters={"x": dora}, **LLM_KW)
    with pytest.raises(AssertionError):       # the JAX package's refusal
        jml.MultiLoraManager.from_paths({"x": dora}, None)
    with pytest.raises(ValueError, match="checkpoint"):
        T.LLM(model=ModelConfig(**dict(
            vocab_size=96, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16)),
            device="cpu", lora_path=ad["a"], **LLM_KW)
    mla = ModelConfig(vocab_size=96, hidden_size=64, intermediate_size=128,
                      num_layers=2, num_heads=4, num_kv_heads=4,
                      kv_lora_rank=32, qk_rope_head_dim=16,
                      qk_nope_head_dim=16, v_head_dim=16)
    with pytest.raises(ValueError, match="MLA"):
        T.LLM(model=mla, device="cpu", lora_adapters={"a": ad["a"]},
              **LLM_KW)
    moe = ModelConfig(architecture="MixtralForCausalLM", vocab_size=96,
                      hidden_size=64, intermediate_size=128, num_layers=2,
                      num_heads=4, num_kv_heads=2, head_dim=16,
                      num_experts=4)
    with pytest.raises(ValueError, match="MoE"):
        T.LLM(model=moe, device="cpu", lora_adapters={"a": ad["a"]},
              **LLM_KW)
    attn_only = write_adapter(str(root / "attn_only"), 6, mods=("q_proj",))
    llm = T.LLM(model=moe, device="cpu", lora_adapters={"q": attn_only},
                **LLM_KW)
    try:
        out = llm.generate([PROMPT], T.SamplingParams(**SP), lora_request="q")
        assert len(out[0].outputs[0].token_ids) == SP["max_tokens"]
    finally:
        llm.shutdown()
