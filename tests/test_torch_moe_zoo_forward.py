"""Port parity for the MoE model zoo: forwards against the JAX model.

For each of the 9 MoE families (`torch_moe_zoo`: the six `transformers`
has from a seeded model with its norms scrambled and its score-correction
biases drawn, through the JAX package's `load_hf_weights`; MiniMax-M2,
EXAONE-MoE and Mistral Large 3 from the JAX `init` with their norms
scrambled), the port takes the JAX parameters through `params_from_jax`
(bf16 experts) and both run the same steps on pools of one shape: a
prompt of 21 tokens in chunks of 13 and 8 beside a second prompt of 9,
then 3 batched decode steps teacher-forced on the JAX model's greedy
tokens.  At every step each row's argmax is the JAX row's, or lies within
`TIE` 0.02 of its top (a bf16 near-tie, as `tests/test_torch_gemma.py`
allows), the logits correlate above `CORR` 0.99 and differ by at most
`TOL` 0.05 (bf16 logits O(1) whose f32 sums run in another order on each
side, the dense zoo's tolerance, `test_torch_zoo_engine.py`).  Llama4's
chunked layers attend within chunks of 8, so the first prompt crosses
two chunk boundaries and the decode steps a third.
"""

import numpy as np
import pytest

from torch_moe_zoo import ARCHS, Pair, prompt

CORR = 0.99
TOL = 0.05
TIE = 0.02


def _check(tl, jl, step):
    for r in range(tl.shape[0]):
        ours, ref = tl[r], jl[r]
        assert np.isfinite(ours).all(), step
        top = int(np.argmax(ours))
        assert top == np.argmax(ref) or ref[top] >= ref.max() - TIE, (
            step, r, top, np.argmax(ref), ref[top], ref.max())
        assert np.corrcoef(ours, ref)[0, 1] > CORR, (step, r)
        assert np.abs(ours - ref).max() <= TOL, (step, r,
                                                 np.abs(ours - ref).max())


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    pair = Pair(arch, seed=1)
    BS = pair.BS
    a, b = prompt(21, seed=3), prompt(9, seed=4)
    a_blocks, b_blocks = [1, 2, 3, 4, 5], [9, 10, 11]

    def slots(blocks, lo, hi):
        return [blocks[p // BS] * BS + p % BS for p in range(lo, hi)]

    def prefill(tokens, blocks, lo, hi, step):
        tl, jl = pair.step("prefill", tokens[lo:hi], list(range(lo, hi)),
                           slots(blocks, lo, hi), [blocks], [hi], lo,
                           [hi - lo - 1])
        _check(tl, jl, step)
        return jl

    prefill(a, a_blocks, 0, 13, "a0")
    ja = prefill(a, a_blocks, 13, 21, "a1")
    jb = prefill(b, b_blocks, 0, 9, "b")
    na, nb = len(a), len(b)
    for step in range(3):
        a.append(int(np.argmax(ja[0])))
        b.append(int(np.argmax(jb[0])))
        tables = [a_blocks, b_blocks + [0] * (len(a_blocks)
                                              - len(b_blocks))]
        tl, jl = pair.step("decode", [a[-1], b[-1]], [na, nb],
                           slots(a_blocks, na, na + 1)
                           + slots(b_blocks, nb, nb + 1),
                           tables, [na + 1, nb + 1], 0, [0, 1])
        _check(tl, jl, f"decode {step}")
        ja, jb = jl[0:1], jl[1:2]
        na, nb = na + 1, nb + 1
