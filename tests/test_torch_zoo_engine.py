"""Port parity for the dense model zoo: the engine against the JAX model.

For each of the 14 architectures, a seeded `transformers` model (norms,
biases and xIELU alphas scrambled, `torch_zoo.hf_model`) is loaded by the
JAX package's `load_hf_weights`; the port takes the same parameters through
`params_from_jax`.  A 12-token prefill chunk, then 3 decode steps
teacher-forced on the JAX model's greedy tokens, run through the port's
`ModelEngine` (its KV manager, pools and metadata) and through the JAX
`forward` on its own pools.  At every step the last row's argmax is the
same, or the port's lies within `TIE` 0.02 of the JAX row's top (a
bf16 near-tie, as `tests/test_torch_gemma.py` allows), and the logits
correlate above 0.99 (`CORR`); the largest logit
difference stays under `TOL` 0.05 (bf16 logits O(1) after two layers whose
f32 sums run in another order on each side; `tests/test_torch_model.py`
states 0.03 for one family, the scrambled norms here scale some rows up).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tensorrt_llm_tpu_torch as T
from tensorrt_llm_tpu.attention_backend.interface import (
    AttentionMetadata as JMeta)
from tensorrt_llm_tpu.models import get_model_class as jax_model_class
from tensorrt_llm_tpu.models.modeling_utils import ModelConfig as JCfg
from tensorrt_llm_tpu_torch.models import (
    ModelConfig, get_model_class, params_from_jax)
from tensorrt_llm_tpu_torch.runtime.kv_cache_manager import (
    KVCacheConfig, KVCacheManager)
from tensorrt_llm_tpu_torch.runtime.model_engine import ModelEngine
from tensorrt_llm_tpu_torch.runtime.request import LlmRequest

from torch_zoo import ARCHS, hf_dict, hf_model, prompt

CORR = 0.99
TOL = 0.05
TIE = 0.02
BS = 8


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_jax(arch):
    hf_cfg, hf = hf_model(arch)
    sd = {k: v.detach().float().numpy() for k, v in hf.state_dict().items()}
    jcfg = JCfg.from_hf_config(hf_cfg)
    jcfg.architecture = arch
    jcfg.attention_backend = "xla"
    jm = jax_model_class(arch)(jcfg)
    jp = jm.load_hf_weights(lambda n: sd.get(n))
    state = params_from_jax(jax.tree.map(np.asarray, jp))
    cfg = ModelConfig.from_hf_config(hf_dict(arch, hf_cfg))
    model = get_model_class(arch)(cfg, "cpu").load_state(state)
    kv = KVCacheManager(KVCacheConfig(block_size=BS, bookkeeping="python"),
                        cfg.num_layers, cfg.num_kv_heads, cfg.head_dim,
                        num_blocks=16, device="cpu")
    engine = ModelEngine(model, kv, "cpu", max_seq_len=64, max_batch_size=4)
    toks = prompt(12)
    req = LlmRequest(toks, T.SamplingParams(max_tokens=4))
    kv.add_sequence(req.request_id, toks)
    req.start_context()
    kv.grow_sequence(req.request_id, len(toks))
    ours = engine.run_prefill(engine.prepare_prefill_inputs(req, len(toks)))
    req.context_position = len(toks)

    shape = (5, jcfg.num_kv_heads, BS, jcfg.head_dim)
    caches = [(jnp.zeros(shape, jnp.bfloat16),) * 2
              for _ in range(jcfg.num_layers)]
    table = jnp.asarray([[1, 2, 3, 4]], jnp.int32)

    def jax_step(ids, pos, mode):
        nonlocal caches
        meta = JMeta(positions=jnp.asarray(pos, jnp.int32),
                     slot_mapping=jnp.asarray([BS + p for p in pos],
                                              jnp.int32),
                     block_tables=table,
                     kv_lens=jnp.asarray([pos[-1] + 1], jnp.int32),
                     q_offset=jnp.int32(0), mode=mode)
        lg, caches = jm.forward(jp, jnp.asarray(ids, jnp.int32), caches,
                                meta, jnp.asarray([len(ids) - 1], jnp.int32))
        return np.asarray(lg, np.float32)[0]

    ref = jax_step(toks, list(range(len(toks))), "prefill")
    for step in range(4):
        ours = np.asarray(ours[0], np.float32)
        top = int(np.argmax(ours))
        assert top == np.argmax(ref) or ref[top] >= ref.max() - TIE, (
            step, top, np.argmax(ref), ref[top], ref.max())
        assert np.corrcoef(ours, ref)[0, 1] > CORR, step
        assert np.abs(ours - ref).max() <= TOL, (step,
                                                 np.abs(ours - ref).max())
        if step == 3:
            break
        nxt = int(np.argmax(ref))
        req.append_token(nxt)
        n = req.num_tokens
        kv.grow_sequence(req.request_id, n)
        ours = engine.run_decode(engine.prepare_decode_inputs([req]))
        ref = jax_step([nxt], [n - 1], "decode")
