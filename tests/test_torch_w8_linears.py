"""Port parity: the 8-bit linears (W8A16, W8A8_SQ_PER_CHANNEL, FP8,
FP8_PER_CHANNEL_PER_TOKEN), `quantize_w8` and the int4 clip-ratio search
against the JAX package.

The same numpy weights and inputs go through the port and through JAX's
`quantize_w8`, `FP8LinearMethod.make_params`, `quantize_w4_calibrated`,
`weight_mse` and the methods' `apply`; then tiny models through
`LLM.generate`.

Tolerances:
* quantization: bit for bit (int8 and e4m3 bytes, f32 scales); the clip
  search picks the same ratio in every group except where two ratios'
  errors lie within the f32 summation order's rounding of each other: there
  both choices' errors agree within 1e-6 relative.
* `apply`: W8A8's int32 accumulator exactly, FP8-per-token's e4m3
  activations byte for byte; outputs (bf16) within two bf16 ulps of the
  largest (2^-7 of max|ref|): the f32 sums of the products (all exact) run
  in another order than XLA's before the one rounding to bf16.
* `LLM.generate`: greedy tokens equal, with `tests/test_torch_llm.py`'s
  near-tie rule for a token that differs.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import tensorrt_llm_tpu as J
from tensorrt_llm_tpu.layers import linear as jlin
from tensorrt_llm_tpu.models.modeling_utils import ModelConfig as JCfg
from tensorrt_llm_tpu.quantization import QuantAlgo as JQA
from tensorrt_llm_tpu.quantization import QuantConfig as JQC
from tensorrt_llm_tpu.quantization import calibrate as jcal
from tensorrt_llm_tpu.quantization import quantize as jq
import tensorrt_llm_tpu_torch as T
from tensorrt_llm_tpu_torch.layers.linear import Linear
from tensorrt_llm_tpu_torch.models import (
    ModelConfig, MOONLIGHT_16B_A3B, params_from_jax)
from tensorrt_llm_tpu_torch.ops.linear_8bit import (
    int8_product, int_mm_operands, pad_int_mm_weight, quantize_act_fp8)
from tensorrt_llm_tpu_torch.ops.w4a16_gemm import quantize_act_int8
from tensorrt_llm_tpu_torch.quantization import (
    QuantAlgo, QuantConfig, quantize_fp8, quantize_w8)
from tensorrt_llm_tpu_torch.quantization.calibrate import (
    CLIP_GRID, quantize_w4_calibrated, weight_mse)
from tensorrt_llm_tpu_torch.quantization.hf_ingest import QTensor

from torch_parity import jax_generate, port_logits

E4 = jnp.float8_e4m3fn
ALGOS = ("W8A16", "W8A8_SQ_PER_CHANNEL", "FP8", "FP8_PER_CHANNEL_PER_TOKEN")


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(np.array(a).view(np.uint8)).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(np.array(a))


def _raw(a):
    """Bytes of a torch or numpy array (e4m3 included) as uint8."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy() \
            if a.element_size() == 1 else a.contiguous().numpy()
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.itemsize == 1 else a


def _weights(seed, K, N, zero_col=True):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((K, N)) * K ** -0.5).astype(np.float32)
    w[:, 3] *= 40.0                      # an outlier column
    if zero_col:
        w[:, 1] = 0.0                    # the scale clamps
    return w


# --------------------------------------------------------- quantizers ---
@pytest.mark.parametrize("K,N,seed", [(64, 48, 0), (256, 96, 1), (96, 8, 2)])
def test_quantize_w8_bit_exact(K, N, seed):
    w = _weights(seed, K, N)
    jqw, js = jq.quantize_w8(jnp.asarray(w))
    pq, ps = quantize_w8(torch.from_numpy(w))
    assert pq.dtype == torch.int8 and ps.dtype == torch.float32
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jqw))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))


@pytest.mark.parametrize("K,N,seed", [(64, 48, 3), (256, 96, 4)])
def test_fp8_make_params_bit_exact(K, N, seed):
    w = _weights(seed, K, N)
    jp = jlin.FP8LinearMethod().make_params(jnp.asarray(w), None,
                                           jnp.bfloat16)
    pq, ps = quantize_fp8(torch.from_numpy(w))
    assert pq.dtype == torch.float8_e4m3fn
    assert np.asarray(jp["qweight"]).dtype == ml_dtypes.float8_e4m3fn
    np.testing.assert_array_equal(_raw(pq), _raw(jp["qweight"]))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(jp["scales"]))


def _group_err(w, q, s, z, G):
    """Per-group squared reconstruction error, f64 [K//G, N]."""
    K, N = w.shape
    qg = q.astype(np.float64).reshape(K // G, G, N)
    if z is not None:
        qg = qg - z[:, None, :]
    d = w.astype(np.float64).reshape(K // G, G, N) - qg * s[:, None, :]
    return (d * d).sum(axis=1)


@pytest.mark.parametrize("K,N,G,symmetric,act", [
    (256, 64, 64, True, False), (256, 64, 32, False, False),
    (128, 48, -1, True, False), (256, 32, 128, False, True),
    (128, 40, 64, True, True)])
def test_clip_search_matches_jax(K, N, G, symmetric, act):
    w = _weights(K + N + G, K, N, zero_col=False)
    rng = np.random.default_rng(7)
    a = rng.uniform(0.1, 3.0, K).astype(np.float32) if act else None
    jqw, js, jz = jcal.quantize_w4_calibrated(
        jnp.asarray(w), G, symmetric=symmetric,
        act_scales=None if a is None else jnp.asarray(a))
    pqw, ps, pz = quantize_w4_calibrated(
        torch.from_numpy(w), G, symmetric=symmetric,
        act_scales=None if a is None else torch.from_numpy(a))
    jqw, js = np.asarray(jqw), np.asarray(js)
    pqw, ps = pqw.numpy(), ps.numpy()
    assert (pz is None) == (jz is None) == symmetric
    jz = None if jz is None else np.asarray(jz)
    pz = None if pz is None else pz.numpy()
    Gs = K if G == -1 else G
    same = js == ps
    if pz is not None:
        same &= jz == pz
    # the same choice: the same scales, zeros and ints
    qs = pqw.reshape(K // Gs, Gs, N) == jqw.reshape(K // Gs, Gs, N)
    assert qs.all(axis=1)[same].all()
    # another choice only at a near-tie of the two ratios' errors
    if not same.all():
        ej = _group_err(w, jqw, js, jz, Gs)
        ep = _group_err(w, pqw, ps, pz, Gs)
        np.testing.assert_allclose(ep[~same], ej[~same], rtol=1e-6)
    assert same.mean() > 0.99
    assert CLIP_GRID == jcal.CLIP_GRID
    np.testing.assert_allclose(
        weight_mse(torch.from_numpy(w), torch.from_numpy(pqw),
                   torch.from_numpy(ps),
                   None if pz is None else torch.from_numpy(pz), G),
        jcal.weight_mse(jnp.asarray(w), jnp.asarray(jqw), jnp.asarray(js),
                        None if jz is None else jnp.asarray(jz), G),
        rtol=1e-6)


# ------------------------------------------------------------- apply ----
def _jax_method(algo):
    return jlin.make_linear_method(JQC(quant_algo=JQA(algo)), "mlp")


def _port_linear(algo, jparams, K, N):
    lin = Linear(K, N, QuantConfig(quant_algo=QuantAlgo(algo)), "mlp")
    lin.load({k: _t(v) for k, v in jparams.items()})
    return lin


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("act,bias", [(None, False), ("silu", True)])
@pytest.mark.parametrize("K,N", [(192, 80), (100, 37)])
def test_apply_matches_jax(algo, act, bias, K, N):
    M = 7
    w = _weights(11, K, N)
    rng = np.random.default_rng(12)
    b = rng.standard_normal(N).astype(np.float32) if bias else None
    x = jnp.asarray(rng.standard_normal((M, K)).astype(np.float32) * 3.0
                    ).astype(jnp.bfloat16)
    meth = _jax_method(algo)
    jp = meth.make_params(jnp.asarray(w), None if b is None
                          else jnp.asarray(b), jnp.bfloat16)
    ref = np.asarray(meth.apply(jp, x, activation=act), np.float32)
    lin = _port_linear(algo, jp, K, N)
    # the port quantizes the same floats to the same bytes
    fresh = Linear(K, N, QuantConfig(quant_algo=QuantAlgo(algo)), "mlp")
    fresh.from_float(torch.from_numpy(w), None if b is None
                     else torch.from_numpy(b))
    np.testing.assert_array_equal(_raw(fresh.qweight), _raw(lin.qweight))
    assert torch.equal(fresh.scales, lin.scales)
    assert tuple(lin.qweight.shape) == (K, N)
    if algo == "W8A8_SQ_PER_CHANNEL":
        # padded once at load; qweight is a view of that storage
        mm = lin.qweight_mm
        assert mm.shape[0] % 8 == 0 and mm.shape[1] % 8 == 0
        assert lin.qweight.data_ptr() == mm.data_ptr()
    with torch.no_grad():
        out = lin(_t(x), activation=act)
    assert out.dtype == torch.bfloat16 and out.shape == (M, N)
    big = float(np.abs(ref).max())
    np.testing.assert_allclose(out.float().numpy(), ref,
                               atol=2.0 ** -7 * big, rtol=0)


def test_w8a8_int32_accumulator_exact():
    """int8 x int8 summed exactly in int32, where an f32 sum is not (127^2
    x K passes 2^24 at K > 1,040): JAX's `preferred_element_type=int32`
    product, bit for bit."""
    rng = np.random.default_rng(5)
    K, N, M = 4096, 24, 5
    xq = rng.integers(-127, 128, (M, K)).astype(np.int8)
    xq[0] = 127
    wq = rng.integers(-128, 128, (K, N)).astype(np.int8)
    wq[:, 0] = 127
    wq[0, 0] = 126             # an odd sum past 2^24: no f32 holds it
    ref = np.asarray(jnp.dot(jnp.asarray(xq), jnp.asarray(wq),
                             preferred_element_type=jnp.int32))
    got = int8_product(torch.from_numpy(xq),
                       torch.from_numpy(wq).t().contiguous().t())
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert ref[0, 0] == 127 * 127 * (K - 1) + 127 * 126 > 2 ** 24
    # what an f32 product loses on the same terms
    f32 = torch.from_numpy(xq).float() @ torch.from_numpy(wq).float()
    assert int(f32[0, 0]) != ref[0, 0]


@pytest.mark.parametrize("M,K,N", [(5, 37, 13), (20, 100, 30), (1, 8, 9)])
def test_w8a8_product_at_odd_k_and_n(M, K, N):
    """W8A8 at any K and N, as JAX's int8 dot takes them: the product of
    the weight as given and of its zero-padded copy (`pad_int_mm_weight`,
    K and N multiples of 8, made once at load), and the card's
    `torch._int_mm` operands (more than 16 rows) sliced back, all bit for
    bit."""
    rng = np.random.default_rng(M * K + N)
    xq = rng.integers(-127, 128, (M, K)).astype(np.int8)
    wq = rng.integers(-128, 128, (K, N)).astype(np.int8)
    ref = np.asarray(jnp.dot(jnp.asarray(xq), jnp.asarray(wq),
                             preferred_element_type=jnp.int32))
    w = torch.from_numpy(wq).t().contiguous().t()
    x = torch.from_numpy(xq)
    np.testing.assert_array_equal(int8_product(x, w).numpy(), ref)
    wp = pad_int_mm_weight(w)
    assert wp.shape[0] % 8 == 0 and wp.shape[1] % 8 == 0
    assert wp.stride(0) == 1
    np.testing.assert_array_equal(int8_product(x, wp, N).numpy(), ref)
    for weight in (w, wp):
        a, b = int_mm_operands(x, weight)
        assert a.shape[0] > 16 and a.shape[1] == b.shape[0]
        assert b.shape[0] % 8 == 0 and b.shape[1] % 8 == 0
        assert b.stride(0) == 1
        np.testing.assert_array_equal(torch._int_mm(a, b)[:M, :N].numpy(),
                                      ref)


def test_per_token_activations_bit_exact():
    """W8A8's int8 and FP8-per-token's e4m3 activations and their scales
    equal the JAX methods' (the reference's expressions, `layers/linear.py`
    `W8A8LinearMethod.apply` and `FP8LinearMethod.apply`)."""
    rng = np.random.default_rng(6)
    x = jnp.asarray(rng.standard_normal((9, 64)).astype(np.float32)
                    * np.geomspace(1e-3, 1e3, 9)[:, None]).astype(jnp.bfloat16)
    xf = x.astype(jnp.float32)
    amax = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True), 1e-12)
    s8 = amax / 127.0
    q8 = jnp.clip(jnp.round(xf / s8), -127, 127).astype(jnp.int8)
    sf = amax / 448.0
    qf = (xf / sf).astype(E4)
    pq8, ps8 = quantize_act_int8(_t(x))
    pqf, psf = quantize_act_fp8(_t(x))
    np.testing.assert_array_equal(pq8.numpy(), np.asarray(q8))
    np.testing.assert_array_equal(ps8.numpy(), np.asarray(s8))
    np.testing.assert_array_equal(_raw(pqf), _raw(qf))
    np.testing.assert_array_equal(psf.numpy(), np.asarray(sf))


def test_params_from_jax_and_layer_kinds():
    """e4m3 leaves (ml_dtypes) cross over byte for byte; each algorithm
    builds its buffers; an AWQ/GPTQ `QTensor` given to an 8-bit layer is
    dequantized exactly and quantized by that layer's method, as the JAX
    package's `quantize_from_float` does."""
    K, N = 128, 64
    w = _weights(21, K, N)
    for algo in ALGOS:
        meth = _jax_method(algo)
        jp = meth.make_params(jnp.asarray(w), None, jnp.bfloat16)
        st = params_from_jax({"lin": jp})
        assert st["lin.qweight"].dtype == (
            torch.float8_e4m3fn if algo.startswith("FP8") else torch.int8)
        lin = _port_linear(algo, jp, K, N)
        assert lin.w8 and not lin.w4 and lin.scales.shape == (N,)
        assert lin.scales.dtype == torch.float32 and lin.zeros is None
        assert lin.fp8 == algo.startswith("FP8")
    # a QTensor into an FP8 layer: dequantized, then FP8-quantized
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.integers(-8, 8, (K, N)).astype(np.int8))
    s = torch.from_numpy(rng.uniform(0.01, 0.02, (K // 32, N))
                         .astype(np.float32))
    qt = QTensor(q, s)
    lin = Linear(K, N, QuantConfig(quant_algo=QuantAlgo.FP8), "mlp")
    lin.from_float(qt)
    want_q, want_s = quantize_fp8(qt.dequant())
    np.testing.assert_array_equal(_raw(lin.qweight), _raw(want_q))
    assert torch.equal(lin.scales, want_s)
    jlinear = jlin.Linear(K, N, method=_jax_method("FP8"))
    from tensorrt_llm_tpu.quantization.hf_ingest import QTensor as JQT
    jpq = jlinear.quantize_from_float(JQT(q.numpy(), s.numpy(), None))
    np.testing.assert_array_equal(_raw(lin.qweight), _raw(jpq["qweight"]))
    with pytest.raises(ValueError):
        lin.load({"qweight": q, "scales": s[0]})   # int8 into an FP8 layer


# --------------------------------------------------------- generation ---
SHAPE = dict(vocab_size=256, hidden_size=256, intermediate_size=512,
             num_layers=2, num_heads=8, num_kv_heads=2, head_dim=64,
             max_position=256)
LLM_KW = dict(skip_tokenizer_init=True, max_seq_len=160, max_batch_size=3,
              max_num_tokens=48, kv_num_blocks=96, kv_block_size=8,
              max_decode_steps=4)
TIE = 0.02   # ~2 bf16 ulps of the largest logits


def _prompts(V, seed=1, n=40):
    rng = np.random.RandomState(seed)
    base = [int(t) for t in rng.randint(1, V - 1, n)]
    return [base + [3, 4], [int(t) for t in rng.randint(1, V - 1, 17)],
            base + [9], [int(t) for t in rng.randint(1, V - 1, 50)]]


def _pair(jcfg, tcfg, kv, prompts, jax_kw=None, n=10):
    """Greedy tokens of the JAX `LLM` and of the port's on its weights."""
    sp = dict(max_tokens=n, temperature=0.0, ignore_eos=True)
    jl = J.LLM(model=jcfg, kv_cache_quant=kv, **LLM_KW, **(jax_kw or {}))
    try:
        params = params_from_jax(jax.tree.map(np.asarray, jl.engine.params))
        jout = jax_generate(jl, prompts, J.SamplingParams(**sp))
    finally:
        jl.shutdown()
    tl = T.LLM(model=tcfg, device="cpu", params=params, kv_cache_quant=kv,
               **LLM_KW)
    try:
        tout = [o.outputs[0].token_ids
                for o in tl.generate(prompts, T.SamplingParams(**sp))]
    finally:
        tl.shutdown()
    exact = 0
    for p, a, b in zip(prompts, jout, tout):
        assert len(a) == len(b) == n
        if a == b:
            exact += 1
            continue
        i = next(i for i, (u, v) in enumerate(zip(a, b)) if u != v)
        lg = port_logits(tcfg, params, p + a[:i], kv_quant=kv)
        top = lg.max()
        assert lg[a[i]] >= top - TIE and lg[b[i]] >= top - TIE, (
            f"token {i} differs without a near-tie: jax {a[i]} "
            f"({lg[a[i]]}), port {b[i]} ({lg[b[i]]}), top {top}")
    assert exact >= 1
    return params


@pytest.mark.parametrize("algo,kv", [
    ("W8A16", "NONE"), ("W8A8_SQ_PER_CHANNEL", "NONE"), ("FP8", "FP8"),
    ("FP8_PER_CHANNEL_PER_TOKEN", "FP8")])
def test_generate_matches_jax_greedy(algo, kv, monkeypatch):
    monkeypatch.setenv("TLLM_KV_BOOKKEEPING", "python")
    jcfg = JCfg(**SHAPE, quant=JQC(quant_algo=JQA(algo)))
    tcfg = ModelConfig(**SHAPE, quant=QuantConfig(quant_algo=QuantAlgo(algo)))
    params = _pair(jcfg, tcfg, kv, _prompts(256))
    leaf = params["layers.0.attn.qkv.qweight"]
    assert leaf.dtype == (torch.float8_e4m3fn if algo.startswith("FP8")
                          else torch.int8)


MIXTRAL_TINY = dict(
    architectures=["MixtralForCausalLM"], vocab_size=320, hidden_size=128,
    intermediate_size=192, num_hidden_layers=2, num_attention_heads=4,
    num_key_value_heads=2, head_dim=64, num_local_experts=4,
    num_experts_per_tok=2, rope_theta=1e6, max_position_embeddings=256,
    rms_norm_eps=1e-5, sliding_window=None)
MOON_TINY = dict(MOONLIGHT_16B_A3B["hf_config"], vocab_size=320,
                 hidden_size=128, intermediate_size=256,
                 moe_intermediate_size=64, num_hidden_layers=3,
                 num_attention_heads=4, num_key_value_heads=4,
                 n_routed_experts=8, num_experts_per_tok=3, kv_lora_rank=48,
                 qk_rope_head_dim=16, qk_nope_head_dim=32, v_head_dim=32,
                 first_k_dense_replace=1, max_position_embeddings=256)


@pytest.mark.parametrize("hf", [MIXTRAL_TINY, MOON_TINY],
                         ids=["mixtral", "moonlight"])
def test_fp8_linears_on_moe_and_mla_match_jax(hf, monkeypatch):
    """FP8 linears on a tiny MoE (the routed experts stay bf16, as in the
    JAX package; shared experts and attention quantize) and on a tiny MLA
    model (q, kv_a and o quantize; the indexer and W_uk/W_uv stay bf16)."""
    monkeypatch.setenv("TLLM_KV_BOOKKEEPING", "python")
    jcfg = JCfg.from_hf_config(hf, quant=JQC(quant_algo=JQA.FP8))
    jcfg.attention_backend = "xla"
    tcfg = ModelConfig.from_hf_config(hf, quant=QuantConfig(
        quant_algo=QuantAlgo.FP8))
    params = _pair(jcfg, tcfg, "NONE", _prompts(320, seed=2, n=30), n=8)
    experts = [k for k in params if ".mlp." in k and "gate_up" in k
               and "shared" not in k and k.endswith(("w_gate_up", "gate_up"))]
    for k in experts:
        assert params[k].dtype in (torch.bfloat16, torch.float32), k
    fp8 = [k for k, v in params.items() if v.dtype == torch.float8_e4m3fn]
    assert any(".attn." in k for k in fp8), fp8
    if hf is MOON_TINY:
        assert "layers.0.attn.kv_a.qweight" in fp8
        assert any(".shared." in k for k in fp8), fp8
