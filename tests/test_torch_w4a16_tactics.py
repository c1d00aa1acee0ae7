"""Port parity: the W4A16 tactic surface, the autotuner and the warmup.

The same numpy inputs go through the port and the JAX package:

* K-paired (2-D) weights: the port's `w4a16_matmul` (CPU tensors take the
  plain version, which is what kernel K12 is held to on the card) against
  JAX `w4a16_matmul(..., interpret=True)`, which runs the Pallas
  `_w4a16_kernel` there (N % 128 == 0), and against `w4a16_matmul_xla`.
* ``variant="ramp"`` against JAX's ramp kernel in interpret mode, with the
  cases of `tests/test_w4a16_gemm.py::test_w4a16_ramp_variant`, and the
  large-M dispatch.
* `ramp_schedule`, `w4a16_tactic_candidates`, `AutoTuner` (cache, the JAX
  file format, skipped candidates), the dispatch plan, `Linear` with a
  K-paired weight, `params_from_jax`, and `LLM(enable_warmup=True)` greedy
  tokens against the JAX `LLM` (also under a loaded ramp tactic file).

Tolerances:
* vs the Pallas kernels: the kernels scale the f32 partial per group where
  the plain version multiplies by the bf16-rounded weight (q - z) * s (up
  to 2^-9 relative per weight): 1e-2 of max|ref|, as tests/test_torch_w4a16.py.
* vs `w4a16_matmul_xla`: the same math, only the f32 summation order
  differs: 1e-5 of max|ref|.
* greedy tokens: exact, except at a near-tie (both candidates within
  `TIE` of the top logit, teacher-forced on the JAX tokens), as
  tests/test_torch_llm.py.
"""

import inspect
import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorrt_llm_tpu as J
from tensorrt_llm_tpu import autotuner as jtuner
from tensorrt_llm_tpu.layers.linear import Linear as JLinear
from tensorrt_llm_tpu.layers.linear import W4A16LinearMethod as JW4A16
from tensorrt_llm_tpu.models.modeling_utils import ModelConfig as JCfg
from tensorrt_llm_tpu.ops import w4a16_gemm as jg
from tensorrt_llm_tpu.quantization import QuantAlgo as JQA
from tensorrt_llm_tpu.quantization import QuantConfig as JQC
from tensorrt_llm_tpu.quantization import quantize as jq
import tensorrt_llm_tpu_torch as T
from tensorrt_llm_tpu_torch.autotuner import AutoTuner, autotune
from tensorrt_llm_tpu_torch.layers.linear import Linear
from tensorrt_llm_tpu_torch.models import ModelConfig, params_from_jax
from tensorrt_llm_tpu_torch.ops import w4a16_gemm as W
from tensorrt_llm_tpu_torch.quantization import QuantAlgo, QuantConfig

from torch_parity import jax_generate, port_logits

TIE = 0.02   # ~2 bf16 ulps of the largest logits


def _t(a):
    return torch.from_numpy(np.array(a))


def _bf16_exact(a):
    return np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _case(M, K, N, group, symmetric, seed, kpaired):
    rng = np.random.default_rng(seed)
    x = _bf16_exact(rng.standard_normal((M, K), dtype=np.float32) * 0.5)
    w = rng.standard_normal((K, N), dtype=np.float32) * 0.1
    q, s, z = jq.quantize_w4(jnp.asarray(w), group, symmetric)
    packed = (jq.pack_w4(q, jq.pack_group_for(K, s.shape[0])) if kpaired
              else jq.pack_w4_tiled(q, 256))
    return x, np.asarray(packed), np.asarray(s), (
        None if z is None else np.asarray(z))


def _port(x, packed, s, z, bias=None, act=None, **tactic):
    out = W.w4a16_matmul(_t(x), _t(packed), _t(s),
                         None if z is None else _t(z),
                         None if bias is None else _t(bias), act, **tactic)
    return out.numpy()


def _jax(x, packed, s, z, bias=None, act=None, **kw):
    return np.asarray(jg.w4a16_matmul(
        jnp.asarray(x), jnp.asarray(packed), jnp.asarray(s),
        None if z is None else jnp.asarray(z),
        None if bias is None else jnp.asarray(bias), act, **kw), np.float32)


@pytest.fixture
def tuner():
    """The port's tuner singleton with an empty cache, restored after."""
    t = AutoTuner.get()
    saved = (dict(t.cache), dict(t.timings), list(t.skipped))
    t.clear()
    yield t
    t.clear()
    t.cache.update(saved[0])
    t.timings.update(saved[1])
    t.skipped.extend(saved[2])


# ------------------------------------------------------------ K-paired ---
KPAIRED = [
    # (M, K, N, group, symmetric, bias + silu)
    (8, 512, 384, 128, True, False),       # symmetric
    (5, 512, 256, 128, False, False),      # zero points
    (16, 512, 256, -1, True, False),       # per-channel (pack group 256)
    (4, 512, 256, 64, True, False),        # g64 (GPT-OSS's group)
    (8, 256, 384, 128, True, True),        # bias + silu epilogue
]


@pytest.mark.parametrize("M,K,N,group,symmetric,epi", KPAIRED)
def test_kpaired_matches_jax_kernel(M, K, N, group, symmetric, epi):
    x, packed, s, z = _case(M, K, N, group, symmetric, M + K + N, True)
    assert packed.ndim == 2
    rng = np.random.default_rng(M)
    bias = rng.standard_normal((N,), dtype=np.float32) if epi else None
    act = "silu" if epi else None
    ref = _jax(x, packed, s, z, bias, act, interpret=True)
    out = _port(x, packed, s, z, bias, act)
    assert np.abs(out - ref).max() <= 1e-2 * max(np.abs(ref).max(), 1.0)
    xla = np.asarray(jg.w4a16_matmul_xla(
        jnp.asarray(x), jnp.asarray(packed), jnp.asarray(s),
        None if z is None else jnp.asarray(z),
        None if bias is None else jnp.asarray(bias), act), np.float32)
    assert np.abs(out - xla).max() <= 1e-5 * max(np.abs(xla).max(), 1.0)
    # on the card this call runs K12, at the default K slice
    name, params = W.w4a16_plan(M, K, N, s.shape[0], tiled=False)
    assert name == "w4a16_kpaired"
    Gp = jq.pack_group_for(K, s.shape[0])
    assert params["block_k"] % Gp == 0 and K % params["block_k"] == 0


# ---------------------------------------------------------------- ramp ---
RAMP = [
    # tests/test_w4a16_gemm.py::test_w4a16_ramp_variant
    (16, 2048, 512, 128, True, None),
    (16, 2048, 512, 128, False, None),
    (5, 4096, 256, 128, True, "silu"),
    (16, 2048, 512, -1, True, None),
]


@pytest.mark.parametrize("M,K,N,group,symmetric,act", RAMP)
def test_ramp_matches_jax_ramp_kernel(M, K, N, group, symmetric, act):
    x, p3, s, z = _case(M, K, N, group, symmetric, 11 + M + K, False)
    bias = (np.random.default_rng(6).standard_normal((N,), dtype=np.float32)
            if act else None)
    ref = _jax(x, p3, s, z, bias, act, variant="ramp", interpret=True)
    out = _port(x, p3, s, z, bias, act, variant="ramp")
    assert np.abs(out - ref).max() <= 1e-2 * max(np.abs(ref).max(), 1.0)
    name, params = W.w4a16_plan(M, K, N, s.shape[0], True, variant="ramp")
    assert name == "w4a16_ramp"
    assert params["schedule"] == jg.ramp_schedule(K)


def test_ramp_large_m_dispatches_to_tiled_kernel():
    """M beyond one M block: JAX falls back to its tiled kernel, the port
    to K1 (a dispatch rule, not a failure fallback); outputs agree."""
    M, K, N = 400, 2048, 512
    x, p3, s, z = _case(M, K, N, 128, True, 12, False)
    ref = _jax(x, p3, s, z, variant="ramp", interpret=True)
    out = _port(x, p3, s, z, variant="ramp")
    assert out.shape == (M, N)
    assert np.abs(out - ref).max() <= 1e-2 * np.abs(ref).max()
    assert W.w4a16_plan(M, K, N, s.shape[0], True, variant="ramp") == (
        "w4a16_gemm", {})


@pytest.mark.parametrize("K,bk0,bk_big", [
    (1024, 1024, 4096), (2048, 1024, 4096), (4096, 1024, 4096),
    (4096, 2048, 4096), (8192, 1024, 2048), (16384, 4096, 8192)])
def test_ramp_schedule_matches_jax(K, bk0, bk_big):
    assert W.ramp_schedule(K, bk0, bk_big) == jg.ramp_schedule(K, bk0,
                                                               bk_big)
    assert W.RAMP_SLAB == jg.RAMP_SLAB


# ------------------------------------------------------------- tactics ---
SHAPES = [
    # (K, N, tiled, group): TinyLlama qkv and down, GPT-OSS o_proj,
    # Moonlight / V3.2 kv_a, a per-channel kv_a
    (2048, 2560, True, 128), (5632, 2048, True, 128),
    (4096, 2880, False, 64), (2048, 576, False, 128),
    (7168, 576, False, 128), (2048, 576, False, 2048)]


@pytest.mark.parametrize("K,N,tiled,group", SHAPES)
def test_tactic_candidates_use_jax_keys(K, N, tiled, group):
    """Every port candidate is a set of arguments of the JAX
    `w4a16_matmul` (a port tactic file loads in the JAX package); the JAX
    package's own non-tiled `block_k` values are among the port's; and
    every JAX candidate is accepted by the port's dispatch."""
    jax_params = set(inspect.signature(jg.w4a16_matmul).parameters)
    port = W.w4a16_tactic_candidates(K, N, tiled, group)
    assert port
    for t in port:
        assert set(t) <= jax_params, t
    ours = {t.get("block_k") for t in port}
    theirs = jg.w4a16_tactic_candidates(K, N, tiled, group)
    if not tiled:
        assert {t["block_k"] for t in theirs} <= ours
        Gp = jq.pack_group_for(K, K // group)
        assert all(K % bk == 0 and bk % Gp == 0 for bk in ours)
    port_params = set(inspect.signature(W.w4a16_matmul).parameters)
    n_groups = K // group
    for t in theirs:
        assert set(t) <= port_params, t
        keep = {k: t.get(k) for k in ("block_k", "block_m", "variant",
                                      "ramp_bk0", "ramp_bk_big")}
        name, _ = W.w4a16_plan(16, K, N, n_groups, tiled, **keep)
        assert name in ("w4a16_gemm", "w4a16_gemv", "w4a16_kpaired",
                        "w4a16_ramp")


@pytest.mark.parametrize("M,K,tiled,tactic,want", [
    (4, 2048, True, {}, "w4a16_gemv"),            # untuned: K2 at decode
    (64, 2048, True, {}, "w4a16_gemm"),           # untuned: K1 above 16
    (16, 2048, True, {"variant": "stream", "block_m": 16}, "w4a16_gemv"),
    (17, 2048, True, {"variant": "stream", "block_m": 16}, "w4a16_gemm"),
    (16, 2048, True, {"variant": "stream"}, "w4a16_gemv"),
    # a JAX "stream" tactic's larger M block goes to K1, not K2
    (256, 2048, True, {"variant": "stream"}, "w4a16_gemm"),
    (257, 2048, True, {"variant": "stream"}, "w4a16_gemm"),
    (4, 2048, True, {"block_k": 2048}, "w4a16_gemm"),
    (4, 2048, True, {"variant": "ramp"}, "w4a16_ramp"),
    (4, 5632, True, {"variant": "ramp"}, "w4a16_gemm"),   # K % 1024 != 0
    (4, 2048, False, {}, "w4a16_kpaired"),
])
def test_dispatch_plan(M, K, tiled, tactic, want):
    name, params = W.w4a16_plan(M, K, 2560, K // 128, tiled, **tactic)
    assert name == want
    if want == "w4a16_ramp":
        assert params["schedule"] == (1, 1)


@pytest.mark.parametrize("M,tactic,want", [
    (4, {"block_k": 1024, "block_m": 16}, 1024),    # tuned, timed range
    (16, {"block_k": 1024, "block_m": 16}, 1024),
    (256, {"block_k": 1024, "block_m": 16}, 2048),  # prefill: the default
    (256, {"block_k": 1024}, 1024),                 # a JAX tactic: every M
    (256, {}, 2048),
])
def test_kpaired_tuned_slice_applies_only_where_timed(M, tactic, want):
    """GPT-OSS o_proj: a tuned K12 slice decides calls of up to its
    `block_m` rows; larger ones take `kpaired_block_k`."""
    name, params = W.w4a16_plan(M, 4096, 2880, 64, False, **tactic)
    assert name == "w4a16_kpaired" and params["block_k"] == want


def test_port_candidates_decide_only_decode_sized_calls():
    for K, N, tiled, group in SHAPES:
        for t in W.w4a16_tactic_candidates(K, N, tiled, group):
            assert t["block_m"] == W.GEMV_MAX_M, t
            big, _ = W.w4a16_plan(256, K, N, K // group, tiled, **t)
            assert big == ("w4a16_gemm" if tiled else "w4a16_kpaired")


def test_tactic_file_is_named_by_the_dispatch_sources(monkeypatch, tmp_path):
    """A change to the Python that decides what a tactic means renames the
    tactic file, so old winners are not loaded."""
    from tensorrt_llm_tpu_torch.ops import cuda_build
    from tensorrt_llm_tpu_torch.runtime.model_engine import ModelEngine
    monkeypatch.setattr(cuda_build, "kernel_dir", lambda: tmp_path)
    first = ModelEngine.tactic_file()
    assert first.parent == tmp_path and first.name.startswith("autotune-")
    assert ModelEngine.tactic_file() == first
    src = tmp_path / "w4a16_gemm.py"
    src.write_text(open(W.__file__).read() + "\n# changed rule\n")
    monkeypatch.setattr(W, "__file__", str(src))
    assert ModelEngine.tactic_file() != first


def test_kpaired_default_slices_fill_the_card():
    # GPT-OSS o_proj at decode: 45 column tiles of 64 x 8 slices of 512 rows
    assert W.kpaired_block_k(4, 4096, 2880, 64) == 512
    # Moonlight kv_a: 9 column tiles x 16 slices of 128 rows
    assert W.kpaired_block_k(4, 2048, 576, 128) == 128
    # a 256-row prefill chunk: 2 M blocks x 23 tiles of 128 columns x 2
    # slices, one round of units on 132 SMs
    assert W.kpaired_block_k(256, 4096, 2880, 64) == 2048


# (M, K, N, pack group) of the K-paired weights on the serve paths, the
# per-channel case, M beyond one M block and the edge token counts
SM90_KPAIRED = [(M, K, N, Gp) for K, N, Gp in
                ((4096, 2880, 64), (2048, 576, 128), (7168, 576, 128),
                 (2048, 576, 256), (2048, 576, 32))
                for M in (1, 4, 5, 17, 255, 256, 300)]


@pytest.mark.parametrize("M,K,N,Gp", SM90_KPAIRED)
def test_sm90_kpaired_units_cover_k_in_whole_pack_groups(M, K, N, Gp):
    bk = W.kpaired_block_k(M, K, N, Gp)
    assert bk % Gp == 0 and K % bk == 0 and (bk >= 128 or bk == K)
    plan = W.sm90_plan(M, K, N, tuple(range(0, K + 1, bk)))
    st = plan["stage_start"]
    # the slices partition K: consecutive, from 0 to K, each once
    assert st[0] == 0 and st[-1] * W.SM90_STAGE_K == K
    assert all(b > a for a, b in zip(st, st[1:]))
    # every slice starts and ends on a pack group
    assert all(s * W.SM90_STAGE_K % Gp == 0 for s in st)
    # tokens, columns and M blocks cover the call
    assert plan["ntok"] >= min(M, W.SM90_M_BLOCK)
    assert plan["ntok"] in W.SM90_NTOK
    assert plan["n_mb"] * W.SM90_M_BLOCK >= M
    assert plan["n_ct"] * plan["cols"] >= N > (plan["n_ct"] - 1) * plan["cols"]
    assert plan["units"] == plan["n_mb"] * plan["n_ct"] * plan["slices"]


@pytest.mark.parametrize("K,Gp", [(4096, 64), (2048, 128), (7168, 128),
                                  (2048, 256), (2048, 32)])
def test_kpaired_slice_choices_are_whole_pack_groups(K, Gp):
    """The slices `chip_smoke.py` times against `kpaired_block_k`'s pick:
    equal cuts of K into whole pack groups and stages, largest first, and
    the pick is one of them at every M."""
    ch = W.kpaired_slice_choices(K, Gp)
    assert ch[0] == K and list(ch) == sorted(ch, reverse=True)
    for bk in ch:
        assert K % bk == 0 and bk % max(Gp, W.SM90_STAGE_K) == 0
        assert bk >= 128 and K // bk <= W.SM90_MAX_SLICES
    for M in (1, 4, 16, 256, 600):
        assert W.kpaired_block_k(M, K, 576, Gp) in ch


@pytest.mark.parametrize("M,K,N,want_ntok,want_cols", [
    (1, 2048, 2560, 8, 64), (5, 2048, 2560, 8, 64), (16, 2048, 2560, 16, 64),
    (17, 2048, 2560, 32, 64), (64, 2048, 2560, 64, 64),
    (65, 2048, 2560, 128, 128), (255, 2048, 2560, 128, 128),
    (256, 2048, 2560, 128, 128), (1000, 4096, 2880, 128, 128)])
def test_sm90_token_and_column_tiles(M, K, N, want_ntok, want_cols):
    plan = W.sm90_plan(M, K, N, (0, K))
    assert (plan["ntok"], plan["cols"]) == (want_ntok, want_cols)


@pytest.mark.parametrize("M,K,N,bounds,want_grid", [
    # GPT-OSS o_proj at decode, default slices: 360 units, 3 blocks per SM
    (4, 4096, 2880, tuple(range(0, 4097, 512)), 360),
    # TinyLlama gate_up at 256 tokens, two ramp steps: 2 M blocks x 88
    # tiles of 128 columns x 2 steps, one block per SM
    (256, 2048, 11264, (0, 1024, 2048), 132),
    # TinyLlama qkv at decode, two ramp steps: 80 units, one block each
    (4, 2048, 2560, (0, 1024, 2048), 80),
])
def test_sm90_grid_fills_the_card_where_the_shape_allows(M, K, N, bounds,
                                                         want_grid):
    plan = W.sm90_plan(M, K, N, bounds)
    per_sm = 1 if plan["nwg"] == 2 else (3 if plan["ntok"] <= 32 else 2)
    assert plan["grid"] == want_grid == min(plan["units"], per_sm * 132)


def test_ramp_steps_are_the_work_units():
    assert W.ramp_bounds(2048) == (0, 1024, 2048)
    assert W.ramp_bounds(4096) == (0, 1024, 4096)
    assert W.ramp_bounds(4096, W.ramp_schedule(4096, 2048)) == (
        0, 2048, 4096)
    for bad in ((1, 2), (5,), (0, 2)):
        with pytest.raises(ValueError):
            W.ramp_bounds(2048, bad)


@pytest.mark.parametrize("K,N,G,kpaired,Gp,bn", [
    (2048, 584, 128, True, 128, 0),      # N % 16
    (2080, 576, 32, True, 32, 0),        # K % 64
    (3072, 576, 96, True, 96, 0),        # pack group neither 32 nor 64k
    (2048, 2048, 16, False, 0, 256),     # G neither 32 nor 64k
    (2048, 2048, 128, False, 0, 96),     # BN % 64
])
def test_sm90_refuses_what_the_kernels_do_not_take(K, N, G, kpaired, Gp, bn):
    with pytest.raises(NotImplementedError):
        W.sm90_check(K, N, G, kpaired, Gp=Gp, bn=bn)


@pytest.mark.parametrize("K,N,G,kpaired,Gp,bn", [
    (2048, 576, 32, True, 32, 0),        # K-paired, pack group 32
    (2048, 2048, 32, False, 0, 256),     # tiled, G 32
    (2048, 576, 2048, True, 256, 0),     # per channel
    (4096, 2880, 64, True, 64, 0),       # GPT-OSS o_proj
])
def test_sm90_takes_group_32_and_the_served_groups(K, N, G, kpaired, Gp, bn):
    """G 32 (two scale rows a 64-row stage) stays a shape of both
    kernels, as the tiled kernel K1 and the JAX package take it."""
    W.sm90_check(K, N, G, kpaired, Gp=Gp, bn=bn)


def test_sm90_plan_refuses_bad_slices():
    for bounds in ((0, 1000, 2048), (0, 2048, 1024), (64, 2048),
                   tuple(range(0, 129 * 64 + 1, 64))):
        K = bounds[-1] if bounds[-1] > bounds[0] else 2048
        with pytest.raises(ValueError):
            W.sm90_plan(4, K, 576, bounds)
    for fn in (W.w4a16_kpaired, W.w4a16_ramp):
        with pytest.raises(ValueError):       # CPU tensors: no kernel
            x = torch.zeros((4, 2048), dtype=torch.bfloat16)
            fn(x, torch.zeros((1024, 576), dtype=torch.int8),
               torch.zeros((16, 576), dtype=torch.bfloat16))


# ----------------------------------------------------------- autotuner ---
def test_autotuner_cache_and_tuning_region(tuner):
    calls = []
    cands = [{"block_k": 1}, {"block_k": 2}]
    assert tuner.maybe_tune("w4a16", (8, 8, 1), cands,
                            lambda t: calls.append(t), "cpu") is None
    assert not calls                      # outside autotune(): no timing
    with autotune():
        best = tuner.maybe_tune("w4a16", (8, 8, 1), cands,
                                lambda t: calls.append(t), "cpu")
    assert best in cands and tuner.lookup("w4a16", (8, 8, 1)) == best
    assert len(tuner.timings[("w4a16", 8, 8, 1)]) == 2
    n = len(calls)
    with autotune():                      # cached: not timed again
        assert tuner.maybe_tune("w4a16", (8, 8, 1), cands,
                                lambda t: calls.append(t), "cpu") == best
    assert len(calls) == n


def test_autotuner_reads_and_writes_the_jax_file(tuner, tmp_path):
    jt = jtuner.AutoTuner()
    jt.cache = {("w4a16", 2048, 2560, 1): {"variant": "ramp"},
                ("w4a16", 4096, 2880, 0): {"block_k": 2048}}
    jt.save(str(tmp_path / "jax.json"))
    tuner.load(str(tmp_path / "jax.json"))
    assert tuner.cache == jt.cache
    tuner.cache[("w4a16", 2048, 576, 0)] = {"block_k": 128}
    tuner.save(str(tmp_path / "port.json"))
    back = jtuner.AutoTuner()
    back.load(str(tmp_path / "port.json"))
    assert back.cache == tuner.cache
    rows = json.loads((tmp_path / "port.json").read_text())
    assert all(set(r) == {"key", "tactic"} for r in rows)


def test_autotuner_skips_only_shape_refusals(tuner, caplog):
    def run(t):
        if t["block_k"] == 3:
            raise ValueError("block_k=3 does not divide K")
        return t

    cands = [{"block_k": 3}, {"block_k": 4}]
    with caplog.at_level(logging.WARNING, logger="tensorrt_llm_tpu_torch"):
        with autotune():
            best = tuner.maybe_tune("w4a16", (12, 8, 0), cands, run, "cpu")
    assert best == {"block_k": 4}
    assert tuner.skipped and tuner.skipped[0][4] == {"block_k": 3}
    assert "skipped" in caplog.text

    def fault(t):
        raise RuntimeError("w4a16_kpaired: CUDA error 700 at launch")

    with autotune(), pytest.raises(RuntimeError):
        tuner.maybe_tune("w4a16", (16, 8, 0), [{"block_k": 4}], fault, "cpu")


# ------------------------------------------------------ layers / state ---
def test_linear_keeps_kpaired_weight_like_jax():
    """N = 80 has no 128-multiple tile: both packages store the weight
    K-paired; the port keeps it so (no repack) and computes JAX's output."""
    K, N, G = 256, 80, 64
    rng = np.random.default_rng(5)
    w = rng.standard_normal((K, N), dtype=np.float32) * 0.1
    bias = rng.standard_normal((N,), dtype=np.float32)
    jl = JLinear(K, N, has_bias=True, method=JW4A16(G))
    jp = jl.quantize_from_float(jnp.asarray(w), jnp.asarray(bias))
    assert jp["qweight"].ndim == 2
    tl = Linear(K, N, QuantConfig(quant_algo=QuantAlgo.W4A16, group_size=G))
    tl.from_float(torch.from_numpy(w), torch.from_numpy(bias))
    assert tl.qweight.dim() == 2
    np.testing.assert_array_equal(tl.qweight.numpy(),
                                  np.asarray(jp["qweight"]))
    x = _bf16_exact(rng.standard_normal((6, K), dtype=np.float32))
    ref = np.asarray(jl(jp, jnp.asarray(x).astype(jnp.bfloat16), "silu"),
                     np.float32)
    out = tl(torch.from_numpy(x).to(torch.bfloat16), "silu").float().numpy()
    # both outputs are bf16: one bf16 ulp of the largest output
    assert np.abs(out - ref).max() <= 2 ** -7 * max(np.abs(ref).max(), 1.0)


def test_params_from_jax_carries_kpaired_weights_byte_for_byte():
    """A JAX model whose o_proj and down have N = 320 (K-paired at group
    64): its state loads into the port with those weights unchanged."""
    shape = dict(vocab_size=128, hidden_size=320, intermediate_size=256,
                 num_layers=1, num_heads=4, num_kv_heads=2, head_dim=64,
                 max_position=64)
    jcfg = JCfg(**shape, quant=JQC(quant_algo=JQA.W4A16, group_size=64),
                attention_backend="xla")
    from tensorrt_llm_tpu.models import get_model_class as jget
    jparams = jget(jcfg.architecture)(jcfg).init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    state = params_from_jax(tree)
    kpaired = {k: v for k, v in state.items()
               if k.endswith("qweight") and v.dim() == 2}
    assert len(kpaired) == 2, sorted(kpaired)        # o_proj and down
    cfg = ModelConfig(**shape, quant=QuantConfig(quant_algo=QuantAlgo.W4A16,
                                                 group_size=64))
    from tensorrt_llm_tpu_torch.models import get_model_class
    model = get_model_class(cfg.architecture)(cfg, "cpu").load_state(state)
    got = model.state()
    for k, v in kpaired.items():
        assert got[k].dtype == torch.int8 and got[k].shape == v.shape
        assert torch.equal(got[k], v.to(torch.int8)), k


# ---------------------------------------------------------- LLM warmup ---
SHAPE = dict(vocab_size=256, hidden_size=256, intermediate_size=512,
             num_layers=2, num_heads=8, num_kv_heads=2, head_dim=64,
             max_position=256)
LLM_KW = dict(skip_tokenizer_init=True, max_seq_len=160, max_batch_size=3,
              max_num_tokens=48, kv_num_blocks=96, kv_block_size=8,
              max_decode_steps=4)


def _prompts():
    rng = np.random.RandomState(0)
    base = [int(t) for t in rng.randint(1, 255, 40)]
    return [base + [3, 4], [int(t) for t in rng.randint(1, 255, 17)],
            base + [9], [int(t) for t in rng.randint(1, 255, 70)]]


@pytest.fixture(scope="module")
def jax_reference():
    """JAX `LLM` greedy tokens and its params, built once for this file."""
    mp = pytest.MonkeyPatch()
    mp.setenv("TLLM_KV_BOOKKEEPING", "python")
    jl = J.LLM(model=JCfg(**SHAPE, quant=JQC(quant_algo=JQA.W4A16,
                                              group_size=128)), **LLM_KW)
    try:
        params = params_from_jax(jax.tree.map(np.asarray, jl.engine.params))
        toks = jax_generate(jl, _prompts(), J.SamplingParams(
            max_tokens=10, temperature=0.0, ignore_eos=True))
    finally:
        jl.shutdown()
        mp.undo()
    return params, toks


def _tcfg():
    return ModelConfig(**SHAPE, quant=QuantConfig(quant_algo=QuantAlgo.W4A16,
                                                  group_size=128))


def _check_greedy(params, jout, tout):
    prompts = _prompts()
    exact = 0
    for p, a, b in zip(prompts, jout, tout):
        assert len(a) == len(b) == 10
        if a == b:
            exact += 1
            continue
        i = next(i for i, (u, v) in enumerate(zip(a, b)) if u != v)
        logits = port_logits(_tcfg(), params, p + a[:i])
        top = logits.max()
        assert logits[a[i]] >= top - TIE and logits[b[i]] >= top - TIE
    assert exact >= 1


def _serve(params):
    tl = T.LLM(model=_tcfg(), device="cpu", params=params,
               enable_warmup=True, **LLM_KW)
    try:
        stats = tl.get_kv_cache_stats()
        out = [o.outputs[0].token_ids for o in tl.generate(
            _prompts(), T.SamplingParams(max_tokens=10, temperature=0.0,
                                         ignore_eos=True))]
    finally:
        tl.shutdown()
    # the warmup's scratch sequence is gone and nothing stays cached of it
    assert stats["active_sequences"] == 0
    assert stats["free_blocks"] + stats["evictable_blocks"] \
        == stats["num_blocks"] - 1
    return out


def test_llm_warmup_tunes_and_matches_jax(jax_reference, tuner):
    params, jout = jax_reference
    tout = _serve(params)
    keys = {k[1:] for k in tuner.cache}
    # qkv, o/down (K 512, N 256), gate_up: every W4A16 shape has a tactic
    assert keys == {(256, 768, 1), (512, 256, 1), (256, 1024, 1)}
    assert not tuner.skipped
    _check_greedy(params, jout, tout)


def test_llm_under_ramp_tactic_file_matches_jax(jax_reference, tuner,
                                                tmp_path):
    params, jout = jax_reference
    path = tmp_path / "tactics.json"
    path.write_text(json.dumps([
        {"key": ["w4a16", K, N, 1], "tactic": {"variant": "ramp"}}
        for K, N in ((256, 768), (512, 256), (256, 1024))]))
    tuner.load(str(path))
    tout = _serve(params)
    assert not tuner.timings                  # loaded shapes are not re-tuned
    assert all(v == {"variant": "ramp"} for v in tuner.cache.values())
    _check_greedy(params, jout, tout)
