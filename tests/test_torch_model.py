"""Port parity: a 2-layer, 256-wide W4A16 Llama with the JAX package's
weights (converted by `params_from_jax`) gives the JAX `forward`'s logits,
for chunked prefill and for batched decode, at head dims 64 and 128.

Both sides run the same steps against their own paged KV pools with the
same block tables.  Tolerance: logits are O(1) (std ~0.5) and bf16-rounded
on both sides; the two frameworks accumulate in f32 in another order, so
activations can differ by one bf16 ulp here and there and the difference
grows through two layers.  0.03 absolute is several bf16 ulps of the
largest logits and far below the spread between distinct tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorrt_llm_tpu.attention_backend.interface import (
    AttentionMetadata as JMeta)
from tensorrt_llm_tpu.models import get_model_class as jax_model_class
from tensorrt_llm_tpu.models.modeling_utils import ModelConfig as JCfg
from tensorrt_llm_tpu.quantization import QuantAlgo as JQA
from tensorrt_llm_tpu.quantization import QuantConfig as JQC
from tensorrt_llm_tpu_torch.attention_backend import AttentionMetadata
from tensorrt_llm_tpu_torch.models import (
    ModelConfig, get_model_class, params_from_jax)
from tensorrt_llm_tpu_torch.quantization import QuantAlgo, QuantConfig

TOL = 0.03
BS = 8


def _shape(D):
    return dict(vocab_size=512, hidden_size=256, intermediate_size=512,
                num_layers=2, num_heads=8, num_kv_heads=2 if D == 64 else 4,
                head_dim=D, max_position=256)


def _models(D):
    jcfg = JCfg(**_shape(D), quant=JQC(quant_algo=JQA.W4A16, group_size=128),
                attention_backend="xla")
    jm = jax_model_class(jcfg.architecture)(jcfg)
    params = jm.init(jax.random.PRNGKey(D))
    tcfg = ModelConfig(**_shape(D), quant=QuantConfig(
        quant_algo=QuantAlgo.W4A16, group_size=128))
    tm = get_model_class(tcfg.architecture)(tcfg, "cpu")
    tm.load_state(params_from_jax(jax.tree.map(np.asarray, params)))
    return jcfg, jm, params, tm


class _Pair:
    """Runs the same step on both models and compares logits."""

    def __init__(self, D, NB=24):
        self.jcfg, self.jm, self.params, self.tm = _models(D)
        self.jfwd = jax.jit(self.jm.forward)
        c = self.jcfg
        shape = (NB, c.num_kv_heads, BS, c.head_dim)
        self.jcache = [(jnp.zeros(shape, jnp.bfloat16),) * 2
                       for _ in range(c.num_layers)]
        self.tcache = [(torch.zeros(shape, dtype=torch.bfloat16),
                        torch.zeros(shape, dtype=torch.bfloat16))
                       for _ in range(c.num_layers)]

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
                         torch.tensor(rows))
        jl = np.asarray(jl, np.float32)
        tl = tl.numpy()
        assert tl.shape == jl.shape and np.isfinite(tl).all()
        assert np.abs(tl - jl).max() <= TOL, np.abs(tl - jl).max()
        return tl


@pytest.mark.parametrize("D", [64, 128])
def test_prefill_then_decode_logits_match_jax(D):
    pair = _Pair(D)
    rng = np.random.default_rng(D)
    # sequence A: blocks 1..6, prefilled in two chunks (16 + 21 tokens)
    a_blocks, b_blocks = [1, 2, 3, 4, 5, 6], [9, 10, 11, 12]
    a = list(rng.integers(1, 511, 37))
    b = list(rng.integers(1, 511, 20))

    def slots(blocks, lo, hi):
        return [blocks[p // BS] * BS + p % BS for p in range(lo, hi)]

    def prefill(tokens, blocks, lo, hi):
        return pair.step("prefill", tokens[lo:hi], list(range(lo, hi)),
                         slots(blocks, lo, hi), [blocks], [hi], lo,
                         [hi - lo - 1])

    prefill(a, a_blocks, 0, 16)
    la = prefill(a, a_blocks, 16, 37)
    lb = prefill(b, b_blocks, 0, 20)
    # batched decode of both sequences, greedy tokens fed back
    na, nb = len(a), len(b)
    for _ in range(3):
        a.append(int(np.argmax(la[0])))
        b.append(int(np.argmax(lb[0])))
        mb = max(len(a_blocks), len(b_blocks))
        tables = [a_blocks + [0] * (mb - len(a_blocks)),
                  b_blocks + [0] * (mb - len(b_blocks))]
        out = pair.step("decode", [a[-1], b[-1]], [na, nb],
                        slots(a_blocks, na, na + 1) + slots(b_blocks, nb,
                                                            nb + 1),
                        tables, [na + 1, nb + 1], 0, [0, 1])
        la, lb = out[0:1], out[1:2]
        na, nb = na + 1, nb + 1
