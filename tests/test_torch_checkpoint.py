"""Port parity for `LLM(model=<HF checkpoint dir>)` against the JAX package.

Every checkpoint here is written by the test (`torch_parity.
write_hf_checkpoint`: seeded numpy weights, bf16, two shards, tiny widths,
2 layers).

* The port's `SafetensorsReader` against `safetensors.safe_open` on the same
  files, every dtype it reads, over two shards: bit for bit.  An unknown
  dtype raises naming it.
* `ModelConfig` from a sparse `config.json` (no head_dim, rope_theta,
  rms_norm_eps, max_position_embeddings) through `read_hf_config` against
  the JAX route through `transformers.AutoConfig`: every field equal, for
  Llama, Mistral, Mixtral, GPT-OSS, DeepSeek V3 with and without
  q_lora_rank and V3.2, with and without tied embeddings.
* Loaded weights: the port's `model.state()` equals
  `params_from_jax(<JAX LLM>.engine.params)` for the same directory --
  packed int4 byte for byte, W4A16 scales after bf16 rounding (the port
  rounds them once at load), everything else exactly; and greedy tokens of
  `LLM(model=dir, device="cpu")` equal the JAX `LLM`'s under the near-tie
  rule of `test_torch_llm.py`.  Each family unquantized and W4A16 at load
  (group 64: the DeepSeek linears have K 64), V3.2 unquantized only.  The
  state alone (no generation) for Llama under W4A16 group 128 and
  W4A8_AWQ, DeepSeek V3 with q_lora_rank and V3.2 under W4A16.
* AWQ and GPTQ (v1, v2): the port's unpackers equal JAX's exactly; a
  checkpoint written as `tests/test_quant_ingest.py` writes one loads into
  both `LLM`s with the same state and tokens; GPTQ act-order raises.
* HF parity: the port's unquantized forward against `transformers` models
  built from the config and saved with `save_pretrained`: top-1 equal and
  a logits correlation above 0.99 (bf16 compute against f32).
* `load_format="dummy"`, a directory without weights (warns),
  `update_weights`, `lora_path` (a PEFT adapter merged at load), the
  refusals, and `quant_clip_search` and the 8-bit algorithms at load
  (states equal to the JAX `LLM`'s; with the clip search also its tokens).
"""

import json
import warnings

import jax
import numpy as np
import pytest
import torch

import tensorrt_llm_tpu as J
from tensorrt_llm_tpu.models.modeling_utils import ModelConfig as JCfg
from tensorrt_llm_tpu.quantization import hf_ingest as jhf
import tensorrt_llm_tpu_torch as T
from tensorrt_llm_tpu_torch.llmapi.hf_checkpoint import (
    SafetensorsReader, read_hf_config)
from tensorrt_llm_tpu_torch.models import ModelConfig, params_from_jax
from tensorrt_llm_tpu_torch.quantization import hf_ingest as thf

from torch_parity import (hf_checkpoint_tensors, hf_tensor_shapes,
                          jax_generate, port_logits, write_hf_checkpoint)

TIE = 0.02
W = dict(vocab_size=320, hidden_size=128, intermediate_size=256,
         num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
         max_position_embeddings=256)
_DS = dict(architectures=["DeepseekV3ForCausalLM"], model_type="deepseek_v3",
           **dict(W, num_key_value_heads=4), moe_intermediate_size=64,
           n_routed_experts=8, num_experts_per_tok=3, n_shared_experts=1,
           first_k_dense_replace=1, kv_lora_rank=48, qk_rope_head_dim=16,
           qk_nope_head_dim=32, v_head_dim=32)
FAMILIES = {
    "llama": dict(architectures=["LlamaForCausalLM"], model_type="llama",
                  **W),
    "mistral": dict(architectures=["MistralForCausalLM"],
                    model_type="mistral", **W, sliding_window=16),
    "mixtral": dict(architectures=["MixtralForCausalLM"],
                    model_type="mixtral", **W, num_local_experts=4),
    "gpt_oss": dict(architectures=["GptOssForCausalLM"], model_type="gpt_oss",
                    **dict(W, intermediate_size=128), head_dim=64,
                    attention_bias=True, num_local_experts=4,
                    num_experts_per_tok=2, sliding_window=16,
                    rope_scaling={"rope_type": "yarn", "factor": 32.0,
                                  "beta_fast": 32.0, "beta_slow": 1.0,
                                  "truncate": False,
                                  "original_max_position_embeddings": 64}),
    "deepseek_v3": dict(_DS, q_lora_rank=64, n_group=4, topk_group=2,
                        rope_scaling={"type": "yarn", "factor": 40,
                                      "beta_fast": 32, "beta_slow": 1,
                                      "mscale": 1.0, "mscale_all_dim": 1.0,
                                      "original_max_position_embeddings": 64}),
    "deepseek_v3_noq": dict(_DS, q_lora_rank=None, n_group=1, topk_group=1),
}
FAMILIES["deepseek_v32"] = dict(FAMILIES["deepseek_v3"], index_topk=16,
                                index_n_heads=4, index_head_dim=32)
LLM_KW = dict(skip_tokenizer_init=True, max_seq_len=96, max_batch_size=2,
              max_num_tokens=64, kv_num_blocks=40, kv_block_size=8,
              max_decode_steps=1)


def _prompts(V=320):
    rng = np.random.RandomState(5)
    return [[int(t) for t in rng.randint(1, V - 1, n)] for n in (9, 14)]


@pytest.fixture(scope="module")
def ckpt_dirs(tmp_path_factory):
    """One checkpoint directory per family, written once per module."""
    out = {}
    for name, hf in FAMILIES.items():
        d = tmp_path_factory.mktemp(name)
        write_hf_checkpoint(d, hf, seed=len(out))
        out[name] = d
    return out


def assert_state_equal(port_state, jax_params):
    """Every leaf of the converted JAX params equals the port's: integer
    packings byte for byte, f32 scales the port keeps in bf16 after bf16
    rounding, the rest exactly (RoPE tables are computed, not loaded)."""
    want = params_from_jax(jax.tree.map(np.asarray, jax_params))
    got = {k: v for k, v in port_state.items() if not k.startswith("rope_")}
    want = {k: v for k, v in want.items() if not k.startswith("rope_")}
    assert sorted(got) == sorted(want)
    for k, g in got.items():
        w = want[k]
        assert tuple(g.shape) == tuple(w.shape), k
        if g.dtype != w.dtype:
            assert g.dtype == torch.bfloat16, (k, g.dtype, w.dtype)
            w = w.to(torch.bfloat16)
        if g.dtype == torch.float8_e4m3fn:     # no float8 torch.equal
            g, w = (t.contiguous().view(torch.uint8) for t in (g, w))
        assert torch.equal(g, w), k


def _tokens_match(tcfg, state, prompts, jout, tout):
    """Greedy tokens equal, or first differ at a near-tie of the port's
    teacher-forced logits (within TIE of the top logit)."""
    exact = 0
    for p, x, y in zip(prompts, jout, tout):
        assert len(x) == len(y)
        if x == y:
            exact += 1
            continue
        i = next(i for i, (u, v) in enumerate(zip(x, y)) if u != v)
        lg = port_logits(tcfg, state, p + x[:i])
        top = lg.max()
        assert lg[x[i]] >= top - TIE and lg[y[i]] >= top - TIE, (
            f"token {i} differs without a near-tie: jax {x[i]} "
            f"({lg[x[i]]}), port {y[i]} ({lg[y[i]]}), top {top}")
    assert exact >= 1


def _run_pair(path, monkeypatch, **kw):
    """(port state, JAX params, port tokens, JAX tokens, port config) of
    both `LLM`s on `path` with the same arguments."""
    monkeypatch.setenv("TLLM_KV_BOOKKEEPING", "python")
    prompts = _prompts()
    sp = dict(max_tokens=5, temperature=0.0, ignore_eos=True)
    jl = J.LLM(model=str(path), **LLM_KW, **kw)
    try:
        jparams = jl.engine.params
        jout = jax_generate(jl, prompts, J.SamplingParams(**sp))
    finally:
        jl.shutdown()
    tl = T.LLM(model=str(path), device="cpu", **LLM_KW, **kw)
    try:
        tout = [o.outputs[0].token_ids
                for o in tl.generate(prompts, T.SamplingParams(**sp))]
        state = tl.model.state()
        cfg = tl.model_config
    finally:
        tl.shutdown()
    return state, jparams, tout, jout, cfg, prompts


# ---- the reader ----------------------------------------------------------
def _bytes(t):
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def test_reader_matches_safetensors(tmp_path):
    from safetensors import safe_open
    from safetensors.torch import save_file
    g = torch.Generator().manual_seed(0)
    parts = [
        {"bf16": torch.randn(7, 3, generator=g).to(torch.bfloat16),
         "u8": torch.randint(0, 256, (3, 5), dtype=torch.uint8, generator=g),
         "bool": torch.rand(5, generator=g) > 0.5,
         "f32": torch.randn(2, 3, 4, generator=g),
         "i64": torch.randint(-2**40, 2**40, (3,), generator=g),
         "empty": torch.zeros(0, 4)},
        {"f16": torch.randn(9, generator=g).half(),
         "i8": torch.randint(-128, 128, (4, 4), dtype=torch.int8,
                             generator=g),
         "i32": torch.randint(-2**31, 2**31 - 1, (5,), dtype=torch.int32,
                              generator=g)}]
    for i, p in enumerate(parts):
        save_file(p, str(tmp_path / f"s{i}.safetensors"))
    with SafetensorsReader(str(tmp_path)) as r:
        assert sorted(r.keys()) == sorted(k for p in parts for k in p)
        assert r("missing") is None
        for i, p in enumerate(parts):
            with safe_open(str(tmp_path / f"s{i}.safetensors"), "pt") as h:
                for k in p:
                    got, want = r(k), h.get_tensor(k)
                    assert got.dtype == want.dtype and got.shape == want.shape
                    assert _bytes(got) == _bytes(want), k
    # a dtype the port does not read raises, naming it
    save_file({"w": torch.zeros(2, dtype=torch.float64)},
              str(tmp_path / "s9.safetensors"))
    with SafetensorsReader(str(tmp_path)) as r:
        with pytest.raises(NotImplementedError, match="F64"):
            r("w")


def test_chip_smoke_writer_reads_with_safetensors(tmp_path):
    """`chip_smoke.py` writes its checkpoints with its own writer (the card
    has no `safetensors`); the library reads them back bit for bit."""
    import chip_smoke
    from safetensors import safe_open
    g = torch.Generator().manual_seed(1)
    ts = {"a.weight": torch.randn(5, 3, generator=g).to(torch.bfloat16),
          "b.qweight": torch.randint(-2**31, 2**31 - 1, (4, 2),
                                     dtype=torch.int32, generator=g),
          "c.scales": torch.randn(3, generator=g).half()}
    f = tmp_path / "x.safetensors"
    chip_smoke.write_safetensors(str(f), ts)
    with safe_open(str(f), "pt") as h:
        assert sorted(h.keys()) == sorted(ts)
        for k, v in ts.items():
            assert torch.equal(h.get_tensor(k), v), k


# ---- config.json ---------------------------------------------------------
@pytest.mark.parametrize("tie", [False, True], ids=["untied", "tied"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_config_matches_autoconfig(family, tie, tmp_path):
    """A sparse config.json gives the port the JAX package's ModelConfig
    (read through AutoConfig, which fills in the family's defaults); a
    field the JAX package keeps in its `extra` dict is held to that, and
    the port's own `extra` to the JAX package's."""
    from transformers import AutoConfig
    hf = {k: v for k, v in FAMILIES[family].items()
          if k not in ("max_position_embeddings", "head_dim")}
    hf["tie_word_embeddings"] = tie
    (tmp_path / "config.json").write_text(json.dumps(hf))
    want = JCfg.from_hf_config(AutoConfig.from_pretrained(str(tmp_path)))
    got = ModelConfig.from_hf_config(read_hf_config(str(tmp_path)))
    for f in got.__dataclass_fields__:
        if f == "extra":
            # the port keeps the few `extra` keys its family classes read
            assert got.extra.items() <= want.extra.items(), got.extra
        elif f != "quant":
            w = (getattr(want, f) if hasattr(want, f)
                 else want.extra.get(f))
            w = tuple(w) if isinstance(w, list) else w
            assert getattr(got, f) == w, f


# ---- weights and tokens --------------------------------------------------
# V3 with q_lora_rank loads through the same path as V3.2 (which adds the
# indexer): its state is held below, its tokens by V3.2's.  V3.2 under
# W4A16 is held by its state (its tokens on the same state are
# `test_torch_deepseek.py`'s; the JAX LLM's W4A16 DSA compile is the
# costliest of all here)
CASES = [(f, q) for f in sorted(FAMILIES) if f != "deepseek_v3"
         for q in (None, "W4A16") if (f, q) != ("deepseek_v32", "W4A16")]


@pytest.mark.parametrize("family,quant", CASES,
                         ids=[f"{f}-{q or 'bf16'}" for f, q in CASES])
def test_family_matches_jax(family, quant, ckpt_dirs, monkeypatch):
    kw = {} if quant is None else dict(quant_algo=quant, quant_group_size=64)
    state, jparams, tout, jout, cfg, prompts = _run_pair(
        ckpt_dirs[family], monkeypatch, **kw)
    assert_state_equal(state, jparams)
    _tokens_match(cfg, state, prompts, jout, tout)


STATE_CASES = [("llama", "W4A16", 128), ("llama", "W4A8_AWQ", 128),
               ("deepseek_v3", "W4A16", 64), ("deepseek_v3", None, 0),
               ("deepseek_v32", "W4A16", 64),
               # the 8-bit algorithms quantize the checkpoint's floats at load
               ("llama", "W8A16", 0), ("llama", "W8A8_SQ_PER_CHANNEL", 0),
               ("llama", "FP8", 0), ("deepseek_v3", "FP8_PER_CHANNEL_PER_TOKEN",
                                     0)]


@pytest.mark.parametrize("family,quant,group", STATE_CASES,
                         ids=[f"{f}-{q or 'bf16'}" for f, q, _ in STATE_CASES])
def test_loaded_state_matches_jax(family, quant, group, ckpt_dirs,
                                  monkeypatch):
    """The loaded states alone (no generation): the JAX `LLM`'s params
    after its `load_hf_weights` against the port's."""
    from tensorrt_llm_tpu_torch.llmapi.llm import resolve_model_config
    monkeypatch.setenv("TLLM_KV_BOOKKEEPING", "python")
    path = str(ckpt_dirs[family])
    kw = {} if quant is None else dict(quant_algo=quant,
                                       quant_group_size=group or 128)
    jl = J.LLM(model=path, **LLM_KW, **kw)
    try:
        jparams = jl.engine.params
    finally:
        jl.shutdown()
    cfg, _ = resolve_model_config(T.LlmArgs(model=path, **kw))
    with SafetensorsReader(path) as reader:
        model = T.models.get_model_class(cfg.architecture)(cfg, "cpu")
        state = model.load_hf_weights(reader).state()
    assert_state_equal(state, jparams)


def test_clip_search_matches_jax(ckpt_dirs, monkeypatch):
    """`quant_clip_search`: both `LLM`s quantize the checkpoint's floats
    with the clip-ratio search, to the same int4 state, and decode the same
    tokens; the search moved the weights off plain absmax rounding."""
    path = ckpt_dirs["llama"]
    kw = dict(quant_algo="W4A16", quant_group_size=64, quant_clip_search=True)
    state, jparams, tout, jout, cfg, prompts = _run_pair(path, monkeypatch,
                                                         **kw)
    assert cfg.quant.clip_search
    assert_state_equal(state, jparams)
    _tokens_match(cfg, state, prompts, jout, tout)
    plain = T.LLM(model=str(path), device="cpu", quant_algo="W4A16",
                  quant_group_size=64, **LLM_KW)
    try:
        base = plain.model.state()
    finally:
        plain.shutdown()
    assert any(not torch.equal(state[k], base[k]) for k in state
               if k.endswith("qweight"))


# ---- AWQ / GPTQ ----------------------------------------------------------
def _pack_awq_words(u4):
    """[R, C] uint4 -> int32 [R, C/8]; nibble i holds column AWQ_ORDER[i]."""
    R, C = u4.shape
    out = np.zeros((R, C // 8), np.uint32)
    for i, m in enumerate(thf.AWQ_ORDER):
        out |= u4[:, m::8].astype(np.uint32) << (4 * i)
    return out.astype(np.int32)


def _pack_gptq_qweight(u4):
    """[K, N] uint4 -> int32 [K/8, N]; nibble i holds row r*8+i."""
    K, N = u4.shape
    out = np.zeros((K // 8, N), np.uint32)
    for i in range(8):
        out |= u4[i::8].astype(np.uint32) << (4 * i)
    return out.astype(np.int32)


def _pack_gptq_qzeros(z_u, v2):
    store = z_u if v2 else ((z_u.astype(np.int32) - 1) & 0xF)
    R, C = store.shape
    out = np.zeros((R, C // 8), np.uint32)
    for i in range(8):
        out |= store[:, i::8].astype(np.uint32) << (4 * i)
    return out.astype(np.int32)


def _quant_tensors(rng, K, N, G):
    q_u = rng.integers(0, 16, (K, N), np.uint8)
    z_u = rng.integers(0, 16, (K // G, N), np.uint8)
    s = (rng.random((K // G, N), np.float32) * 0.02 + 0.005).astype(
        np.float16)
    return q_u, z_u, s


@pytest.mark.parametrize("fmt", ["awq", "gptq", "gptq_v2"])
def test_unpackers_match_jax(fmt):
    rng = np.random.default_rng(3)
    K, N, G = 128, 64, 32
    q_u, z_u, s = _quant_tensors(rng, K, N, G)
    if fmt == "awq":
        args = (_pack_awq_words(q_u), _pack_awq_words(z_u), s)
        j, t = jhf.unpack_awq(*args), thf.unpack_awq(*args)
    else:
        v2 = fmt == "gptq_v2"
        g_idx = np.arange(K, dtype=np.int32) // G
        args = (_pack_gptq_qweight(q_u), _pack_gptq_qzeros(z_u, v2), s,
                g_idx)
        j, t = jhf.unpack_gptq(*args, v2=v2), thf.unpack_gptq(*args, v2=v2)
        with pytest.raises(NotImplementedError, match="act-order"):
            thf.unpack_gptq(*args[:3], rng.permutation(g_idx), v2=v2)
    np.testing.assert_array_equal(t.q.numpy(), j.q)
    np.testing.assert_array_equal(t.scales.numpy(), j.scales)
    np.testing.assert_array_equal(t.zeros.numpy(), j.zeros)
    np.testing.assert_array_equal(t.dequant().numpy(), j.dequant())


def _write_prequantized(path, fmt, G=32):
    """A tiny Llama checkpoint whose linears are AWQ or GPTQ tensors (the
    layout of `tests/test_quant_ingest.py`), embedding/lm_head/norms fp16."""
    hf = dict(FAMILIES["llama"], torch_dtype="float16")
    rng = np.random.default_rng(11)
    floats = {k: v for k, v in hf_checkpoint_tensors(hf, 4).items()
              if not k.endswith("_proj.weight")}
    ts = {k: torch.from_numpy(v).half() for k, v in floats.items()}
    v2 = fmt == "gptq_v2"
    for name, (shape, kind) in hf_tensor_shapes(hf).items():
        if not name.endswith("_proj.weight"):
            continue
        N, K = shape
        base = name[:-len(".weight")]
        q_u, z_u, s = _quant_tensors(rng, K, N, G)
        if fmt == "awq":
            qw, qz = _pack_awq_words(q_u), _pack_awq_words(z_u)
        else:
            qw, qz = _pack_gptq_qweight(q_u), _pack_gptq_qzeros(z_u, v2)
            ts[base + ".g_idx"] = torch.arange(K, dtype=torch.int32) // G
        ts[base + ".qweight"] = torch.from_numpy(qw)
        ts[base + ".qzeros"] = torch.from_numpy(qz)
        ts[base + ".scales"] = torch.from_numpy(s)
    qc = {"quant_method": "gptq" if fmt.startswith("gptq") else "awq",
          "bits": 4, "group_size": G}
    if fmt == "awq":
        qc.update(version="GEMM", zero_point=True)
    else:
        qc.update(desc_act=False, checkpoint_format="gptq_v2" if v2
                  else "gptq")
    hf["quantization_config"] = qc
    write_hf_checkpoint(path, hf, tensors=ts, dtype=torch.float16)


@pytest.mark.parametrize("fmt", ["awq", "gptq", "gptq_v2"])
def test_prequantized_checkpoint_matches_jax(fmt, tmp_path, monkeypatch):
    _write_prequantized(tmp_path, fmt)
    state, jparams, tout, jout, cfg, prompts = _run_pair(tmp_path,
                                                         monkeypatch)
    assert cfg.quant.pre_quantized and cfg.quant.group_size == 32
    assert cfg.quant.ckpt_format == fmt[:4] and cfg.quant.ckpt_v2 == (
        fmt == "gptq_v2")
    assert_state_equal(state, jparams)
    _tokens_match(cfg, state, prompts, jout, tout)


# ---- HF parity -----------------------------------------------------------
HF_PARITY = {
    "llama": FAMILIES["llama"],
    "llama_tied": dict(FAMILIES["llama"], tie_word_embeddings=True),
    "mixtral": FAMILIES["mixtral"],
    "gpt_oss": FAMILIES["gpt_oss"],
    "deepseek_v3": FAMILIES["deepseek_v3_noq"],
}


@pytest.mark.parametrize("name", sorted(HF_PARITY))
def test_hf_parity(name, tmp_path):
    """Unquantized port forward against transformers (f32) on a checkpoint
    saved by `save_pretrained`: top-1 equal, logits correlation > 0.99."""
    import transformers
    hf = HF_PARITY[name]
    cfg = transformers.AutoConfig.for_model(
        **{k: v for k, v in hf.items() if k != "architectures"},
        architectures=hf["architectures"])
    torch.manual_seed(0)
    model = transformers.AutoModelForCausalLM.from_config(cfg).eval()
    model.save_pretrained(str(tmp_path), safe_serialization=True)
    prompt = _prompts()[1]
    with torch.no_grad():
        want = model(torch.tensor([prompt])).logits[0, -1].numpy()
    tl = T.LLM(model=str(tmp_path), device="cpu", **LLM_KW)
    try:
        assert tl.model_config.tie_word_embeddings == bool(
            hf.get("tie_word_embeddings"))
        got = port_logits(tl.model_config, tl.model.state(), prompt)
    finally:
        tl.shutdown()
    assert np.argmax(got) == np.argmax(want)
    assert np.corrcoef(got, want)[0, 1] > 0.99


# ---- build paths, update_weights, refusals -------------------------------
def test_dummy_and_missing_weights(ckpt_dirs, tmp_path):
    """`load_format="dummy"` and a directory without weights both draw
    random weights at the checkpoint's shapes (the latter warns)."""
    sp = T.SamplingParams(max_tokens=3, temperature=0.0, ignore_eos=True)
    (tmp_path / "config.json").write_text(
        (ckpt_dirs["llama"] / "config.json").read_text())
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        dummy = T.LLM(model=str(ckpt_dirs["llama"]), device="cpu", seed=7,
                      load_format="dummy", **LLM_KW)
    with pytest.warns(UserWarning, match="random"):
        empty = T.LLM(model=str(tmp_path), device="cpu", seed=7, **LLM_KW)
    outs = []
    for tl in (dummy, empty):
        try:
            outs.append(tl.generate([[1, 2, 3]], sp)[0].outputs[0].token_ids)
            assert tl.model.embedding.weight.shape == (320, 128)
        finally:
            tl.shutdown()
    assert outs[0] == outs[1] and len(outs[0]) == 3


def test_update_weights_matches_a_fresh_llm(ckpt_dirs, tmp_path):
    """Tokens after swapping in another checkpoint (a directory, then a
    get_tensor callable) equal a fresh `LLM`'s on that checkpoint."""
    write_hf_checkpoint(tmp_path, FAMILIES["llama"], seed=99)
    prompts = _prompts()
    sp = T.SamplingParams(max_tokens=4, temperature=0.0, ignore_eos=True)
    kw = dict(quant_algo="W4A16", quant_group_size=64, **LLM_KW)

    def toks(llm):
        return [o.outputs[0].token_ids for o in llm.generate(prompts, sp)]

    fresh = T.LLM(model=str(tmp_path), device="cpu", **kw)
    try:
        want, want_state = toks(fresh), fresh.model.state()
    finally:
        fresh.shutdown()
    tl = T.LLM(model=str(ckpt_dirs["llama"]), device="cpu", **kw)
    try:
        before = toks(tl)
        tl.update_weights(str(tmp_path))
        assert toks(tl) == want
        tl.update_weights(str(ckpt_dirs["llama"]))
        assert toks(tl) == before
        with SafetensorsReader(str(tmp_path)) as r:
            tl.update_weights(r)
        assert toks(tl) == want
        state = tl.model.state()
        assert all(torch.equal(state[k], v) for k, v in want_state.items())
        with pytest.raises(TypeError):
            tl.update_weights(3)
    finally:
        tl.shutdown()


def test_refusals(ckpt_dirs, tmp_path):
    path = str(ckpt_dirs["llama"])
    # lora_path is no longer refused: a PEFT adapter merges at load (a zero
    # B leaves the weights as they are, a nonzero one moves q_proj only)
    from safetensors.torch import save_file
    H = FAMILIES["llama"]["hidden_size"]
    plain = T.LLM(model=path, device="cpu", **LLM_KW)
    want = plain.model.state()
    plain.shutdown()
    for scale in (0.0, 1.0):
        ad = tmp_path / f"adapter_{scale}"
        ad.mkdir()
        (ad / "adapter_config.json").write_text(json.dumps(
            {"r": 2, "lora_alpha": 4}))
        g = torch.Generator().manual_seed(0)
        save_file({f"base_model.model.model.layers.{i}.self_attn.q_proj."
                   f"lora_{ab}.weight": (torch.randn(shape, generator=g)
                                          * scale)
                   for i in range(2)
                   for ab, shape in (("A", (2, H)), ("B", (H, 2)))},
                  str(ad / "adapter_model.safetensors"))
        tl = T.LLM(model=path, device="cpu", lora_path=str(ad), **LLM_KW)
        try:
            got = tl.model.state()
            moved = sorted(k for k in want if not torch.equal(got[k],
                                                                want[k]))
            assert moved == ([] if scale == 0 else [
                f"layers.{i}.attn.qkv.weight" for i in range(2)]), moved
            assert len(tl.generate([[1, 2, 3]], T.SamplingParams(
                max_tokens=2))[0].outputs[0].token_ids) == 2
        finally:
            tl.shutdown()
    # quant_clip_search is no longer refused: the int4 weights come from
    # the clip-ratio search (test_clip_search_matches_jax holds them)
    tl = T.LLM(model=path, device="cpu", quant_algo="W4A16",
               quant_clip_search=True, **LLM_KW)
    try:
        assert tl.model.layers[0].attn.qkv.clip_search
    finally:
        tl.shutdown()
    with pytest.raises(TypeError):
        T.LLM(model=3, device="cpu", **LLM_KW)
    # MXFP4 experts (GPT-OSS's published format) are named, not misread
    with SafetensorsReader(str(ckpt_dirs["gpt_oss"])) as r:
        def mxfp4(name):
            if name.endswith("experts.gate_up_proj"):
                return None
            if name.endswith("experts.gate_up_proj_blocks"):
                return torch.zeros(1, dtype=torch.uint8)
            return r(name)
        cfg = ModelConfig.from_hf_config(
            read_hf_config(str(ckpt_dirs["gpt_oss"])))
        m = T.models.get_model_class(cfg.architecture)(cfg, "cpu")
        with pytest.raises(NotImplementedError, match="MXFP4"):
            m.load_hf_weights(mxfp4)
