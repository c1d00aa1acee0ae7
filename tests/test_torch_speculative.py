"""Port parity of speculative decoding, mode by mode: on the JAX package's
tiny speculative-test model (and a W4A16 variant), `LLM.generate` under a
speculative config gives, on the port (CPU), the port's plain greedy tokens
and the JAX package's tokens under the same config, and the port's
`spec_stats` (proposed / accepted / rounds) equal the JAX package's
exactly.  The JAX side keeps its KV bookkeeping in Python and admits each
batch whole (`torch_parity.jax_generate`).

Drafter weights: DRAFT_TARGET's draft model from the JAX drafter engine's
params (`params_from_jax`); MTP and EAGLE3 from one seeded numpy
`get_tensor` given to both sides; Medusa's heads from their numpy seeds,
drawn the same way on both sides.
"""

import numpy as np
import pytest

from tensorrt_llm_tpu.speculative import SpeculativeMode as JM
from tensorrt_llm_tpu_torch.speculative import (
    SpeculativeConfig, SpeculativeMode, get_drafter, suggest_spec_config)
from tensorrt_llm_tpu_torch.speculative.ngram import NGramDrafter

from torch_spec import (TINY, assert_parity, draft_model_of, draft_params_of,
                        eagle3_tensors, mtp_tensors, run_pair)


@pytest.fixture(autouse=True)
def _python_bookkeeping(monkeypatch):
    monkeypatch.setenv("TLLM_KV_BOOKKEEPING", "python")


MTP_W = mtp_tensors()
EAGLE_W = eagle3_tensors()
MEDUSA_TREE = [(0,), (1,), (0, 0), (0, 1), (1, 0), (0, 0, 0)]

# (case id, spec fields, prompt, seed, new tokens)
CASES = [
    ("ngram", dict(mode="NGRAM", max_draft_len=4),
     [3, 5, 3, 5, 3, 5, 7], 0, 24),
    ("user_chain", dict(mode="USER_PROVIDED", max_draft_len=3,
                        proposer=lambda r: [r.all_token_ids[-1]] * 3),
     [4, 8, 4, 8, 4, 8, 15], 2, 24),
    # seed 0: the JAX drafter's PRNGKey(0) weights equal the target's, so
    # drafts are accepted
    ("draft_target", dict(mode="DRAFT_TARGET", max_draft_len=3,
                          draft_model=draft_model_of(),
                          draft_params=draft_params_of),
     [9, 2, 9, 2, 11], 0, 16),
    ("mtp", dict(mode="MTP", max_draft_len=3, mtp_weights=MTP_W.get),
     [2, 9, 2, 9, 2, 9, 11], 5, 24),
    ("eagle3", dict(mode="EAGLE3", max_draft_len=3, mtp_weights=EAGLE_W.get),
     [6, 3, 6, 3, 6, 3, 12], 8, 24),
    ("medusa", dict(mode="MEDUSA", max_draft_len=3),
     [7, 4, 7, 4, 7, 4, 13], 9, 24),
    ("medusa_choices", dict(mode="MEDUSA", max_draft_len=4,
                            num_medusa_heads=3, medusa_choices=MEDUSA_TREE),
     [7, 4, 7, 4, 7, 4, 13], 9, 24),
    ("auto", dict(mode="AUTO"), [7, 9, 7, 9, 7, 9, 7, 9], 0, 16),
]


def _fields(fields, side):
    mode = fields["mode"]
    out = dict(fields)
    out["mode"] = (lambda s, jl: JM(mode) if s == "jax"
                   else SpeculativeMode(mode))
    return out


@pytest.mark.parametrize("w4a16", [False, True], ids=["bf16", "w4a16"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_mode_matches_jax_and_plain_greedy(case, w4a16):
    _, fields, prompt, seed, n = case
    r = run_pair(_fields(fields, None), [prompt], n=n, seed=seed,
                 w4a16=w4a16)
    assert_parity(r)


def test_draft_target_accepts_with_shared_weights():
    """The draft model has the target's weights (JAX PRNGKey(0) on both):
    every round accepts at least one draft token."""
    _, fields, prompt, seed, n = CASES[2]
    r = run_pair(_fields(fields, None), [prompt], n=n, seed=seed)
    assert_parity(r)
    st = r["port_stats"]
    assert st["accepted"] >= st["rounds"], st


def test_mtp_chunked_prefill_and_batch_of_4():
    """MTP's hidden bookkeeping survives chunked prefill (a 16-token
    budget) and four requests in one batch."""
    prompts = [[int(t) for t in np.random.RandomState(i).randint(1, 60,
                                                                  20 + i)]
               for i in range(4)]
    r = run_pair(_fields(dict(mode="MTP", max_draft_len=4,
                              mtp_weights=MTP_W.get), None),
                 prompts, n=10, seed=6, llm_kw=dict(max_num_tokens=16))
    assert_parity(r)


def test_eagle3_reduced_vocab_d2t():
    """A reduced draft vocabulary: the head scores 32 draft ids and d2t
    maps draft id d to target id 2d."""
    w = eagle3_tensors(seed=3, draft_vocab=TINY["vocab_size"] // 2)
    r = run_pair(_fields(dict(mode="EAGLE3", max_draft_len=3,
                              mtp_weights=w.get), None),
                 [[6, 3, 6, 3, 6, 3, 12]], seed=8)
    assert_parity(r)


def test_eagle3_loads_full_draft_layer():
    """fc, head, d2t and the `midlayer.*` layer with its norms land."""
    import tensorrt_llm_tpu_torch as T
    from torch_spec import configs
    w = eagle3_tensors(seed=2)
    w["midlayer.input_layernorm.weight"] = np.full(TINY["hidden_size"], 1.5,
                                                   np.float32)
    w["midlayer.hidden_norm.weight"] = np.full(TINY["hidden_size"], 2.0,
                                               np.float32)
    w["norm.weight"] = np.full(TINY["hidden_size"], 3.0, np.float32)
    llm = T.LLM(model=configs()[1], device="cpu", skip_tokenizer_init=True,
                max_seq_len=128, kv_num_blocks=64, kv_block_size=8,
                speculative_config=SpeculativeConfig(
                    mode=SpeculativeMode.EAGLE3, max_draft_len=2,
                    mtp_weights=w.get))
    try:
        d = llm.executor.drafter
        assert float(d.layer.input_norm.weight[0]) == 1.5
        assert float(d.params["hnorm"][0]) == 2.0
        assert float(d.params["final_norm"][0]) == 3.0
        assert d.params["fc"].shape == (3 * TINY["hidden_size"],
                                        TINY["hidden_size"])
        out = llm.generate([6, 3, 6, 3, 6, 3, 12], T.SamplingParams(
            max_tokens=8, temperature=0.0, ignore_eos=True))
        assert len(out[0].outputs[0].token_ids) == 8
    finally:
        llm.shutdown()


def test_suggest_spec_config_and_auto():
    cfg = suggest_spec_config(4)
    assert (cfg.mode, cfg.max_draft_len, cfg.max_matching_ngram_size,
            cfg.max_concurrency) == (SpeculativeMode.NGRAM, 5, 3, 32)
    cfg = suggest_spec_config(64)
    assert (cfg.max_draft_len, cfg.max_matching_ngram_size) == (3, 5)

    class Args:
        max_batch_size = 4
    d = get_drafter("AUTO", Args())
    assert isinstance(d, NGramDrafter) and d.cfg.max_concurrency == 32
    assert isinstance(get_drafter("ngram"), NGramDrafter)


def test_medusa_heads_from_a_weight_source():
    """Heads and ResBlocks from a `get_tensor` (two heads): both packages
    load them and agree on tokens and spec_stats."""
    H, V = TINY["hidden_size"], TINY["vocab_size"]
    rng = np.random.RandomState(3)
    w = {}
    for i in range(2):
        w[f"medusa_head.{i}.1.weight"] = \
            rng.randn(V, H).astype(np.float32) * 0.02
        w[f"medusa_head.{i}.0.linear.weight"] = \
            rng.randn(H, H).astype(np.float32) * 0.02
    r = run_pair(_fields(dict(mode="MEDUSA", max_draft_len=2,
                              num_medusa_heads=2, mtp_weights=w.get), None),
                 [[1, 2, 1, 2, 1]], n=8, seed=3)
    assert_parity(r)
