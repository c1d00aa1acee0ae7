"""Helpers of the dense model zoo's parity tests (`tests/test_torch_zoo_*.py`):
a tiny HF config of each architecture (the JAX package's own,
`tests/test_model_zoo.py:350-494`), a seeded `transformers` model of it
with its norms, biases and xIELU alphas scrambled (ones and zeros would
hide a misplaced norm or a dropped bias), and JAX / port configs."""

import numpy as np
import pytest
import torch

COMMON = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
              num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=2, head_dim=32,
              max_position_embeddings=256, attention_dropout=0.0)
NO_HEAD_DIM = {k: v for k, v in COMMON.items() if k != "head_dim"}

# architecture -> (transformers config class, its arguments)
ZOO = {
    "Qwen2ForCausalLM": ("Qwen2Config", dict(COMMON)),
    "Qwen3ForCausalLM": ("Qwen3Config", dict(COMMON)),
    "SmolLM3ForCausalLM": ("SmolLM3Config",
                           dict(NO_HEAD_DIM, no_rope_layers=[1, 0])),
    "Olmo2ForCausalLM": ("Olmo2Config", dict(NO_HEAD_DIM)),
    "GraniteForCausalLM": ("GraniteConfig", dict(
        NO_HEAD_DIM, embedding_multiplier=2.0, residual_multiplier=0.5,
        attention_multiplier=0.2, logits_scaling=3.0)),
    "Starcoder2ForCausalLM": ("Starcoder2Config", dict(
        NO_HEAD_DIM, hidden_act="gelu_pytorch_tanh", use_bias=True,
        tie_word_embeddings=True)),
    "NemotronForCausalLM": ("NemotronConfig", dict(
        NO_HEAD_DIM, hidden_act="relu2", partial_rotary_factor=0.5)),
    "GlmForCausalLM": ("GlmConfig", dict(
        COMMON, partial_rotary_factor=0.5, attention_bias=True)),
    "Glm4ForCausalLM": ("Glm4Config", dict(
        COMMON, partial_rotary_factor=0.5, attention_bias=True)),
    "Phi3ForCausalLM": ("Phi3Config", dict(NO_HEAD_DIM)),
    "Exaone4ForCausalLM": ("Exaone4Config", dict(
        COMMON, sliding_window=16, sliding_window_pattern=2)),
    "SeedOssForCausalLM": ("SeedOssConfig", dict(COMMON,
                                                 attention_bias=True)),
    "ApertusForCausalLM": ("ApertusConfig", dict(COMMON)),
    "HunYuanDenseV1ForCausalLM": ("HunYuanDenseV1Config", dict(COMMON)),
}
ARCHS = sorted(ZOO)
SCRAMBLE = ("norm", "layernorm", "alpha_p", "alpha_n")


def hf_config(arch, **over):
    transformers = pytest.importorskip("transformers")
    name, kw = ZOO[arch]
    kw = dict(dict(tie_word_embeddings=False, pad_token_id=0), **kw)
    kw.update(over)
    return getattr(transformers, name)(**kw)


def hf_model(arch, seed=0, **over):
    """(config, model): a seeded `transformers` model whose norm weights and
    alphas are scaled by U(0.5, 1.5) (as the JAX package's `perturb`) and
    whose biases get N(0, 0.02^2) added."""
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
    return cfg, m


def hf_dict(arch, hf_cfg):
    """The config as the dict a `config.json` holds, with its class."""
    return dict(hf_cfg.to_dict(), architectures=[arch])


def prompt(n, seed=0, vocab=256):
    return [int(t) for t in np.random.RandomState(seed).randint(1, vocab - 1,
                                                                 n)]
