"""VSWA cyclic rings in the port, the five cases of `tests/test_vswa.py`.

Sliding-window layers keep rings of ``cdiv(window, BS) + 1`` blocks a
sequence in pools of their own (`KVCacheManager.configure_vswa`, set up by
`ModelEngine` under `KVCacheConfig.separate_window_pools`, True by
default).  Rings change the storage, never the outputs: the logits of a
chunked prefill and greedy decode equal those of full pools with the window
masked (the f32 sums of two gathers in another order: atol 2e-2), and the
JAX engine's rings from the same weights give the same logits.  Beams fork
rings; the disaggregated handoff carries them.
"""

import queue

import jax
import numpy as np
import pytest
import tensorrt_llm_tpu as J
from tensorrt_llm_tpu.llmapi.sampling_params import SamplingParams as JSP
from tensorrt_llm_tpu.models import get_model_class as jax_model_class
from tensorrt_llm_tpu.models.modeling_utils import ModelConfig as JCfg
from tensorrt_llm_tpu.parallel.mapping import Mapping
from tensorrt_llm_tpu.runtime.kv_cache_manager import (
    KVCacheConfig as JKVCfg, KVCacheManager as JKV)
from tensorrt_llm_tpu.runtime.model_engine import ModelEngine as JEngine
from tensorrt_llm_tpu.runtime.request import LlmRequest as JReq
import tensorrt_llm_tpu_torch as T
from tensorrt_llm_tpu_torch.llmapi.disagg_params import DisaggregatedParams
from tensorrt_llm_tpu_torch.llmapi.llm import plan_kv_pools
from tensorrt_llm_tpu_torch.models import (
    ModelConfig, get_model_class, params_from_jax)
from tensorrt_llm_tpu_torch.runtime.kv_cache_manager import (
    KVCacheConfig, KVCacheManager)
from tensorrt_llm_tpu_torch.models.gemma import GEMMA2_9B
from tensorrt_llm_tpu_torch.runtime.model_engine import (
    ModelEngine, default_ring_slots, ring_plan)
from tensorrt_llm_tpu_torch.runtime.request import LlmRequest

# a window smaller than the prompt, so that the rings wrap
SWA = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
           num_layers=3, num_heads=4, num_kv_heads=2, head_dim=16,
           max_position=256, sliding_window=16, sliding_window_pattern=3)
TOL = 2e-2


def _params(seed):
    jcfg = JCfg(**SWA)
    jm = jax_model_class(jcfg.architecture)(jcfg)
    return jm, jm.init(jax.random.PRNGKey(seed))


def build(separate_pools: bool, seed=0, max_seq_len=96):
    cfg = ModelConfig(**SWA)
    _, jp = _params(seed)
    model = get_model_class(cfg.architecture)(cfg, "cpu").load_state(
        params_from_jax(jax.tree.map(np.asarray, jp)))
    kv = KVCacheManager(
        KVCacheConfig(block_size=8, separate_window_pools=separate_pools,
                      bookkeeping="python"),
        cfg.num_layers, cfg.num_kv_heads, cfg.head_dim, num_blocks=64,
        device="cpu")
    engine = ModelEngine(model, kv, "cpu", max_seq_len=max_seq_len,
                         max_batch_size=4)
    return engine, kv


def run_sequence(engine, kv, prompt, n_decode=6, req_cls=LlmRequest,
                 sp=None):
    """Chunked prefill (chunks of 16) and n greedy decode steps: the
    logits of each step's last row."""
    req = req_cls(prompt, sp or T.SamplingParams(max_tokens=n_decode))
    kv.add_sequence(req.request_id, req.prompt_token_ids)
    req.start_context()
    outs, pos = [], 0
    while pos < len(prompt):
        chunk = min(16, len(prompt) - pos)
        kv.grow_sequence(req.request_id, pos + chunk)
        logits = engine.run_prefill(engine.prepare_prefill_inputs(req, chunk))
        req.context_position = pos = pos + chunk
        outs.append(np.asarray(logits, np.float32)[0])
    req.finish_context()
    for _ in range(n_decode):
        req.append_token(int(np.argmax(outs[-1])))
        kv.grow_sequence(req.request_id, req.num_tokens)
        logits = engine.run_decode(engine.prepare_decode_inputs([req]))
        outs.append(np.asarray(logits, np.float32)[0])
    return np.stack(outs)


def test_vswa_configured_and_pools_shrink():
    engine, kv = build(True)
    assert engine.vswa and kv.vswa
    assert 1 in kv.sliding_layers and 2 not in kv.sliding_layers
    full_nb = engine.kv_caches[2][0].shape[0]
    ring_nb = engine.kv_caches[1][0].shape[0]
    assert ring_nb == kv.local_num_blocks() and ring_nb != full_nb
    # a ring is the window and one block
    assert kv.ring_capacity >= SWA["sliding_window"] + 1
    assert kv.ring_blocks < 96 // 8
    # no rings where the engine is told not to, or the ring would be as
    # long as a full table
    assert not build(False)[0].vswa
    assert not build(True, max_seq_len=24)[0].vswa


def test_vswa_outputs_match_full_pools_and_jax():
    prompt = [int(t) for t in np.random.RandomState(0).randint(1, 127, 40)]
    e1, kv1 = build(False, seed=3)
    ref = run_sequence(e1, kv1, prompt)
    e2, kv2 = build(True, seed=3)
    assert e2.vswa
    got = run_sequence(e2, kv2, prompt)
    np.testing.assert_allclose(ref, got, rtol=TOL, atol=TOL)
    # the JAX engine's rings (its XLA backend) from the same weights
    jm, jp = _params(3)
    jkv = JKV(JKVCfg(block_size=8), SWA["num_layers"], SWA["num_kv_heads"],
              SWA["head_dim"], num_blocks=64, bookkeeping="python")
    je = JEngine(jm, jp, jkv, mapping=Mapping(), max_seq_len=96,
                 decode_buckets=(4,), prefill_buckets=(16,),
                 max_batch_size=4)
    assert je._vswa
    want = run_sequence(je, jkv, prompt, req_cls=JReq,
                        sp=JSP(max_tokens=6))
    np.testing.assert_allclose(want, got, rtol=TOL, atol=TOL)


def test_vswa_ring_slot_mapping_cyclic():
    _, kv = build(True)
    kv.add_sequence(101, [1, 2, 3])
    P = kv.ring_capacity
    # rings start at block 1 (ring block 0 is the reserved pad target)
    base = kv.block_size + kv.ring_slot_of(101) * P
    assert kv.local_block_table(101) == list(
        range(1 + kv.ring_slot_of(101) * kv.ring_blocks,
              1 + (kv.ring_slot_of(101) + 1) * kv.ring_blocks))
    m = kv.local_slot_mapping(101, P - 2, 4, pad_slot=-1, dedup=False)
    assert m == [base + P - 2, base + P - 1, base + 0, base + 1]
    # within one chunk the last write of an offset lands, earlier ones pad
    m2 = kv.local_slot_mapping(101, 0, P + 2, pad_slot=-1)
    assert m2[0] == -1 and m2[1] == -1
    assert m2[2] == base + 2 and m2[-1] == base + 1
    free = kv.free_ring_slots()
    kv.free_sequence(101)
    assert kv.can_admit_new() and kv.free_ring_slots() == free + 1
    # prefix reuse is off under rings
    assert not kv.cfg.enable_block_reuse


def _llm(seed, **kw):
    return T.LLM(model=ModelConfig(**SWA), device="cpu",
                 skip_tokenizer_init=True, max_seq_len=96, max_batch_size=4,
                 kv_num_blocks=96, kv_block_size=8, seed=seed,
                 load_format="dummy", kv_bookkeeping="python", **kw)


def test_vswa_e2e_llm_multistep_and_beams():
    llm = _llm(11)
    full = _llm(11, kv_separate_window_pools=False)
    try:
        assert llm.engine.vswa and not full.engine.vswa
        sp = T.SamplingParams(max_tokens=24, temperature=0.0,
                              ignore_eos=True)
        prompts = [list(range(1, 30)), [5, 6, 7]]
        a = [o.outputs[0].token_ids for o in llm.generate(prompts, sp)]
        b = [o.outputs[0].token_ids for o in llm.generate(prompts, sp)]
        assert a == b and all(len(t) == 24 for t in a)
        c = [o.outputs[0].token_ids for o in full.generate(prompts, sp)]
        assert c == a
        # beam forks copy rings; the full pools' beams agree
        bs = T.SamplingParams(max_tokens=6, use_beam_search=True, n=2,
                              best_of=2, ignore_eos=True)
        outs = llm.generate([[2, 4, 6, 8] * 6], bs)
        ref = full.generate([[2, 4, 6, 8] * 6], bs)
        assert [o.token_ids for o in outs[0].outputs] == \
            [o.token_ids for o in ref[0].outputs]
        assert all(len(o.token_ids) == 6 for o in outs[0].outputs)
        assert llm.get_kv_cache_stats()["active_sequences"] == 0
        assert llm.kv_manager.free_ring_slots() == llm.kv_manager.ring_slots
    finally:
        llm.shutdown()
        full.shutdown()


def test_vswa_disagg_roundtrip():
    """context_only -> generation_only, whole and streamed, with rings."""
    prefill, decode = _llm(21), _llm(21)
    try:
        sp = T.SamplingParams(max_tokens=10, temperature=0.0,
                              ignore_eos=True)
        prompt = list(range(1, 28))
        want = prefill.generate([prompt], sp)[0].outputs[0].token_ids
        _, dparams = prefill.generate_context_only(
            list(prompt), T.SamplingParams(temperature=0.0, ignore_eos=True))
        assert dparams.first_gen_tokens[0] == want[0]
        out = decode.generate_async(list(prompt), sp,
                                    disaggregated_params=dparams).result()
        assert out.outputs[0].token_ids == want
        # streamed: one frame of every page, marked "ring", then the end
        fut, q = prefill.generate_context_only_streamed(
            list(prompt), T.SamplingParams(temperature=0.0, ignore_eos=True))
        fut.result()
        frames = []
        while not q.empty():
            frames.append(q.get_nowait())
        assert [bool(f.get("ring")) for f in frames] == [True, False]
        assert frames[-1]["end"]
        rx = queue.Queue()
        for f in frames:
            rx.put(f)
        out = decode.generate_async(
            list(prompt), sp, disaggregated_params=DisaggregatedParams(
                request_type="generation_only", kv_frames=rx)).result()
        assert out.outputs[0].token_ids == want
    finally:
        prefill.shutdown()
        decode.shutdown()


# Mistral-7B-v0.1 (every layer slides, window 4,096) and Gemma-2-9B (every
# other layer) at their 8,192-token context, batch 64, in the pool budget
# of an 80 GB card (0.85 of it): the default ring slots alone would take
# ~128 and ~169 GiB
MISTRAL_V01 = dict(vocab_size=32000, hidden_size=4096,
                   intermediate_size=14336, num_layers=32, num_heads=32,
                   num_kv_heads=8, head_dim=128, max_position=32768,
                   sliding_window=4096)
POOL_BUDGET = int(0.85 * 80e9)


def _pool_bytes(cfg, kvcfg, num_blocks, ring_slots, max_seq_len):
    """Device bytes of the pools `LLM` allocates for this plan."""
    layer = KVCacheManager.block_bytes(1, cfg.num_kv_heads, cfg.head_dim,
                                       kvcfg.block_size)
    _, ring_blocks, sliding = ring_plan(cfg, kvcfg.block_size, max_seq_len)
    n_global = cfg.num_layers - len(sliding)
    return layer * (num_blocks * n_global
                    + len(sliding) * (ring_slots * ring_blocks + 1))


@pytest.mark.parametrize("name", ["mistral-7b-v0.1", "gemma-2-9b"])
@pytest.mark.parametrize("fixed_blocks", [None, 4096])
def test_pool_plan_counts_the_rings(name, fixed_blocks):
    """`plan_kv_pools` sizes the main pool over the global layers from what
    the rings leave, and cuts the ring slots to the budget."""
    if name == "mistral-7b-v0.1":
        cfg = ModelConfig(**MISTRAL_V01)
    else:
        cfg = ModelConfig.from_hf_config(GEMMA2_9B["hf_config"])
        cfg.sliding_window_pattern = 2   # as `Gemma2ForCausalLM` sets it
    kvcfg = KVCacheConfig(block_size=16, num_blocks=fixed_blocks)
    B, S = 64, 8192
    assert _pool_bytes(cfg, kvcfg, 0, default_ring_slots(B), S) \
        > POOL_BUDGET
    n, slots = plan_kv_pools(cfg, kvcfg, S, B, POOL_BUDGET)
    assert 1 <= slots < default_ring_slots(B)
    assert _pool_bytes(cfg, kvcfg, n, slots, S) <= POOL_BUDGET
    if fixed_blocks:
        assert n == fixed_blocks
    elif name == "gemma-2-9b":
        # the main pool holds as many whole sequences as the rings do
        assert abs(n // (S // 16) - slots) <= 1, (n, slots)
    # a small budget still leaves one ring slot; no rings without the
    # separate pools, and then every layer in the main pool
    assert plan_kv_pools(cfg, kvcfg, S, B, 1 << 30)[1] == 1
    full = KVCacheConfig(block_size=16, separate_window_pools=False)
    n_full, none = plan_kv_pools(cfg, full, S, B, POOL_BUDGET)
    assert none is None
    assert n_full * cfg.num_layers * KVCacheManager.block_bytes(
        1, cfg.num_kv_heads, cfg.head_dim, 16) <= POOL_BUDGET


def test_llm_allocates_the_planned_rings():
    """`LLM` gives the engine the ring slots `plan_kv_pools` chose."""
    llm = T.LLM(model=ModelConfig(**SWA), device="cpu",
                skip_tokenizer_init=True, max_seq_len=96, max_batch_size=64,
                kv_block_size=8, load_format="dummy",
                kv_bookkeeping="python")
    try:
        kv = llm.kv_manager
        n, slots = plan_kv_pools(ModelConfig(**SWA), kv.cfg, 96, 64, 4 << 30)
        assert llm.engine.vswa and kv.ring_slots == slots
        assert kv.num_blocks == n
        assert len(llm.engine.kv_caches[0][0]) == kv.local_num_blocks()
    finally:
        llm.shutdown()
