"""Helpers of the MoE model zoo's parity tests (`test_torch_moe_zoo*.py`):
a tiny config of each MoE family (hidden 128, 8 experts, 2-4 layers; a
`transformers` class for the six that `transformers` has, a config dict
for MiniMax-M2, EXAONE-MoE and Mistral Large 3), a seeded `transformers`
model with its norms scrambled and its score-correction biases drawn (ones
and zeros would hide a misplaced norm or a dropped bias), and a stepper
that runs the same prefill and decode steps through the JAX forward and
the port's on pools of the same shape."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorrt_llm_tpu.attention_backend.interface import (
    AttentionMetadata as JMeta)
from tensorrt_llm_tpu.models import get_model_class as jax_model_class
from tensorrt_llm_tpu.models.modeling_utils import ModelConfig as JCfg
from tensorrt_llm_tpu_torch.attention_backend import AttentionMetadata
from tensorrt_llm_tpu_torch.models import (
    ModelConfig, get_model_class, params_from_jax)
from tensorrt_llm_tpu_torch.runtime.kv_cache_manager import model_pools

COMMON = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
              num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=2, head_dim=32,
              max_position_embeddings=256, attention_dropout=0.0)
MOE = dict(num_experts=8, num_experts_per_tok=2, moe_intermediate_size=64)
_DS = dict(n_routed_experts=8, num_experts_per_tok=2,
           moe_intermediate_size=64, first_k_dense_replace=1,
           n_shared_experts=1, n_group=2, topk_group=1,
           routed_scaling_factor=1.5, norm_topk_prob=True)

# architecture -> (transformers config class, its arguments); Qwen2-MoE's
# shared expert is off (the JAX package drops it: `HF_ON` turns it on)
HF_ZOO = {
    "Qwen3MoeForCausalLM": ("Qwen3MoeConfig", dict(
        COMMON, **MOE, norm_topk_prob=True, decoder_sparse_step=2)),
    "Qwen2MoeForCausalLM": ("Qwen2MoeConfig", dict(
        COMMON, **MOE, shared_expert_intermediate_size=0,
        norm_topk_prob=False)),
    "Glm4MoeForCausalLM": ("Glm4MoeConfig", dict(
        COMMON, **_DS, use_qk_norm=True, partial_rotary_factor=0.5)),
    "Dots1ForCausalLM": ("Dots1Config", dict(COMMON, **_DS)),
    "HunYuanMoEV1ForCausalLM": ("HunYuanMoEV1Config", dict(
        COMMON, num_experts=8, moe_topk=2)),
    "Llama4ForCausalLM": ("Llama4TextConfig", dict(
        COMMON, intermediate_size=64, intermediate_size_mlp=256,
        num_hidden_layers=4, num_local_experts=8, num_experts_per_tok=1,
        interleave_moe_layer_step=2, no_rope_layer_interval=2,
        attention_chunk_size=8, use_qk_norm=True,
        attn_temperature_tuning=True, floor_scale=4.0, attn_scale=0.1,
        rope_theta=500000.0)),
}
HF_ON = {"Qwen2MoeForCausalLM": dict(shared_expert_intermediate_size=128)}
HF_ARCHS = sorted(HF_ZOO)

_NO_HD = {k: v for k, v in COMMON.items()
          if k not in ("head_dim", "attention_dropout")}
# the families `transformers` lacks: config.json dicts
DICT_ZOO = {
    # rotary_dim = head_dim: the JAX package rotates whole heads
    "MiniMaxM2ForCausalLM": dict(
        COMMON, intermediate_size=64, num_local_experts=8,
        num_experts_per_tok=2, rotary_dim=32, scoring_func="sigmoid"),
    "ExaoneMoEForCausalLM": dict(
        COMMON, **MOE, num_shared_experts=1, sliding_window=16,
        layer_types=["sliding_attention", "full_attention"]),
    "MistralLarge3ForCausalLM": dict(
        _NO_HD, num_key_value_heads=4, **_DS, kv_lora_rank=48,
        q_lora_rank=None, qk_rope_head_dim=16, qk_nope_head_dim=32,
        v_head_dim=32),
}
for _a, _d in DICT_ZOO.items():
    _d["architectures"] = [_a]
ARCHS = sorted(HF_ZOO) + sorted(DICT_ZOO)
SCRAMBLE = ("norm", "layernorm")


def hf_config(arch, **over):
    transformers = pytest.importorskip("transformers")
    name, kw = HF_ZOO[arch]
    kw = dict(dict(tie_word_embeddings=False, pad_token_id=0), **kw)
    kw.update(over)
    cfg = getattr(transformers, name)(**kw)
    cfg.architectures = [arch]
    return cfg


def hf_model(arch, seed=0, **over):
    """(config, model): a seeded `transformers` model whose norm weights are
    scaled by U(0.5, 1.5), whose biases get N(0, 0.02^2) added and whose
    score-correction biases are N(0, 0.05^2) (they start at zero)."""
    transformers = pytest.importorskip("transformers")
    cfg = hf_config(arch, **over)
    torch.manual_seed(seed)
    m = transformers.AutoModelForCausalLM.from_config(cfg).eval()
    with torch.no_grad():
        for n, p in m.named_parameters():
            if any(t in n for t in SCRAMBLE) and not n.endswith(".bias"):
                p.mul_(torch.rand_like(p) + 0.5)
            elif n.endswith(".bias"):
                p.add_(torch.randn_like(p) * 0.02)
        for n, b in m.named_buffers():
            if n.endswith("e_score_correction_bias"):
                b.add_(torch.randn_like(b) * 0.05)
    return cfg, m


def config_dict(arch, **over):
    """The family's tiny config as the dict a `config.json` holds."""
    if arch in DICT_ZOO:
        return dict(DICT_ZOO[arch], **over)
    return dict(hf_config(arch, **over).to_dict(), architectures=[arch])


def prompt(n, seed=0, vocab=256):
    return [int(t) for t in np.random.RandomState(seed).randint(1, vocab - 1,
                                                                 n)]


def jax_params(arch, jcfg, seed=0):
    """(JAX model, params): the scrambled HF model's weights through the
    JAX package's `load_hf_weights`, or the JAX `init` for a dict family
    (its norms scrambled as above)."""
    jm = jax_model_class(arch)(jcfg)
    if arch in HF_ZOO:
        _, hf = hf_model(arch, seed)
        sd = {k: v.detach().float().numpy()
              for k, v in hf.state_dict().items()}
        return jm, jm.load_hf_weights(lambda n: sd.get(n))
    params = jm.init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def scramble(path, a):
        names = [str(getattr(k, "key", "")) for k in path]
        if any("norm" in n for n in names) and np.ndim(a) == 1:
            return jnp.asarray(np.asarray(a) * rng.uniform(
                0.5, 1.5, np.shape(a)).astype(np.float32))
        return a
    return jm, jax.tree_util.tree_map_with_path(scramble, params)


class Pair:
    """The same steps through the JAX forward and the port's, each on its
    own pools of one shape (`model_pools`), with the JAX parameters carried
    across by `params_from_jax`."""

    def __init__(self, arch, seed=0, NB=24, BS=8):
        hf = config_dict(arch)
        self.jcfg = JCfg.from_hf_config(hf)
        self.jcfg.architecture = arch
        self.jcfg.attention_backend = "xla"
        self.jm, self.params = jax_params(arch, self.jcfg, seed)
        self.jfwd = jax.jit(self.jm.forward)
        self.tcfg = ModelConfig.from_hf_config(hf)
        state = params_from_jax(jax.tree.map(np.asarray, self.params))
        self.tm = get_model_class(arch)(self.tcfg, "cpu").load_state(state)
        self.BS = BS
        self.tcache = model_pools(self.tcfg, NB, BS, device="cpu")
        self.jcache = [
            tuple(jnp.zeros(t.shape, jnp.bfloat16) for t in c)
            if isinstance(c, tuple) else jnp.zeros(c.shape, jnp.bfloat16)
            for c in self.tcache]

    def step(self, mode, ids, pos, slots, tables, kv_lens, q_offset, rows):
        """(port logits, JAX logits) of the rows `rows`, f32."""
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
                         torch.tensor(rows)).numpy()
        return tl, np.asarray(jl, np.float32)
