"""Decoder-only causal LM for the Llama family.

Counterpart of `tensorrt_llm_tpu/models/modeling_utils.py`: `ModelConfig`
(the fields the Llama family uses), `DecoderLayer`, and
`DecoderModelForCausalLM.forward` (embedding, pre-norm decoder layers over a
paged KV cache, final norm, bf16 lm_head).  Weights come from
`init_random` (numpy-seeded, identical on every device) or from
`params_from_jax`, which converts the JAX package's parameter pytree so the
tests can run the same weights on both sides.  Loading HF checkpoints
belongs to a later slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from tensorrt_llm_tpu_torch.attention_backend.interface import (
    AttentionMetadata)
from tensorrt_llm_tpu_torch.layers.attention import Attention
from tensorrt_llm_tpu_torch.layers.embedding import Embedding
from tensorrt_llm_tpu_torch.layers.linear import Linear
from tensorrt_llm_tpu_torch.layers.mlp import GatedMLP
from tensorrt_llm_tpu_torch.ops.norms import add_rms_norm
from tensorrt_llm_tpu_torch.ops.rope import RopeConfig, make_rope_tables
from tensorrt_llm_tpu_torch.quantization import QuantConfig
from tensorrt_llm_tpu_torch.utils import resolve_device


@dataclass
class ModelConfig:
    architecture: str = "LlamaForCausalLM"
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: Optional[int] = None
    rms_eps: float = 1e-5
    rope_theta: float = 10000.0
    max_position: int = 4096
    activation: str = "silu"
    quant: Optional[QuantConfig] = None

    def __post_init__(self):
        if self.head_dim is None:
            self.head_dim = self.hidden_size // self.num_heads

    @property
    def rope(self) -> RopeConfig:
        return RopeConfig(head_dim=self.head_dim, theta=self.rope_theta,
                          max_position=self.max_position)


class DecoderLayer(nn.Module):
    """Pre-norm block: x + attn(norm(x)); x + mlp(norm(x)), with the residual
    add fused into the next norm as in the JAX package."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.attn = Attention(cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads,
                              cfg.head_dim, cfg.quant, device)
        self.mlp = GatedMLP(cfg.hidden_size, cfg.intermediate_size,
                            cfg.activation, quant=cfg.quant)
        self.input_norm = _RMSNormWeight(cfg.hidden_size)
        self.post_attn_norm = _RMSNormWeight(cfg.hidden_size)

    def forward(self, x, residual, rope_tables, kv_cache,
                meta: AttentionMetadata):
        eps = self.cfg.rms_eps
        h, residual = add_rms_norm(x, residual, self.input_norm.weight, eps)
        h = self.attn(h, rope_tables, kv_cache, meta)
        h2, residual = add_rms_norm(h, residual, self.post_attn_norm.weight,
                                    eps)
        return self.mlp(h2), residual


class _RMSNormWeight(nn.Module):
    def __init__(self, n: int):
        super().__init__()
        self.register_buffer("weight", torch.ones(n, dtype=torch.float32))


_MODEL_REGISTRY: Dict[str, type] = {}


def register_auto_model(*architectures):
    def deco(cls):
        for a in architectures:
            _MODEL_REGISTRY[a] = cls
        return cls
    return deco


def get_model_class(architecture: str) -> type:
    import tensorrt_llm_tpu_torch.models.llama  # noqa: F401  (registers)
    if architecture not in _MODEL_REGISTRY:
        raise KeyError(f"architecture {architecture!r} not in this slice; "
                       f"known: {sorted(_MODEL_REGISTRY)}")
    return _MODEL_REGISTRY[architecture]


class DecoderModelForCausalLM(nn.Module):
    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.embedding = Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(
            [DecoderLayer(cfg, self.device) for _ in range(cfg.num_layers)])
        self.final_norm = _RMSNormWeight(cfg.hidden_size)
        # the LM head stays bf16 (QuantConfig.exclude_modules)
        self.lm_head = Linear(cfg.hidden_size, cfg.vocab_size, cfg.quant,
                              "lm_head")
        cos, sin = make_rope_tables(cfg.rope)
        self.register_buffer("rope_cos", cos)
        self.register_buffer("rope_sin", sin)
        self.to(self.device)

    # ---- parameters -----------------------------------------------------
    @torch.no_grad()
    def init_random(self, seed: int = 0) -> "DecoderModelForCausalLM":
        """Random weights at the real shapes, drawn with numpy from `seed`
        (so every device gets the same floats), quantized on the model's
        device.  Scales follow the JAX package's `init`."""
        cfg, dev = self.cfg, self.device
        rng = np.random.default_rng(seed)
        H, I, D = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim

        def normal(shape, std):
            a = rng.standard_normal(shape, dtype=np.float32)
            return torch.from_numpy(a).to(dev).mul_(std)

        self.embedding.load(normal((cfg.vocab_size, H), 0.02)
                            .to(torch.bfloat16))
        std = 0.5 / H ** 0.5
        for layer in self.layers:
            layer.attn.from_float(
                normal((H, cfg.num_heads * D), std),
                normal((H, cfg.num_kv_heads * D), std),
                normal((H, cfg.num_kv_heads * D), std),
                normal((cfg.num_heads * D, H), std))
            layer.mlp.from_float(normal((H, I), std), normal((H, I), std),
                                 normal((I, H), 0.5 / I ** 0.5))
        self.lm_head.from_float(normal((H, cfg.vocab_size), std))
        return self

    @torch.no_grad()
    def load_state(self, state: Dict[str, torch.Tensor]
                   ) -> "DecoderModelForCausalLM":
        """Install a state (as made by `params_from_jax`, or a `state()`):
        names are module paths, values are placed on the model's device."""
        groups: Dict[str, Dict[str, torch.Tensor]] = {}
        for name, t in state.items():
            mod, _, leaf = name.rpartition(".")
            groups.setdefault(mod, {})[leaf] = t.to(self.device)
        for mod, leaves in groups.items():
            m = self.get_submodule(mod) if mod else self
            if isinstance(m, Linear):
                m.load(leaves)
            elif isinstance(m, Embedding):
                m.load(leaves["weight"])
            else:
                for leaf, t in leaves.items():
                    setattr(m, leaf, t)
        return self

    def state(self) -> Dict[str, torch.Tensor]:
        """Every buffer by module path (feeds `load_state` on another
        device)."""
        return {k: v for k, v in self.named_buffers() if v is not None}

    # ---- forward ------------------------------------------------------------
    def forward(self, input_ids: torch.Tensor,
                kv_caches: List[Tuple[torch.Tensor, torch.Tensor]],
                meta: AttentionMetadata,
                logit_indices: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Logits [rows, V] in f32 (bf16-rounded, as the JAX package's bf16
        lm_head returns them).  KV caches are updated in place."""
        x = self.embedding(input_ids)
        residual = None
        rope = (self.rope_cos, self.rope_sin)
        for i, layer in enumerate(self.layers):
            x, residual = layer(x, residual, rope, kv_caches[i], meta)
        x, _ = add_rms_norm(x, residual, self.final_norm.weight,
                            self.cfg.rms_eps)
        if logit_indices is not None:
            x = x[logit_indices]
        return self.lm_head(x).to(torch.float32)


_NORMS = ("input_norm", "post_attn_norm", "final_norm")


def params_from_jax(tree: Any) -> Dict[str, torch.Tensor]:
    """The JAX package's parameter pytree (leaves as numpy arrays; bf16
    leaves may arrive as ml_dtypes bfloat16) as a port state for
    `DecoderModelForCausalLM.load_state`.  K-paired W4A16 weights are
    repacked to tiles by the layers at load; scales round to bf16 there."""
    out: Dict[str, torch.Tensor] = {}

    def tensor(a) -> torch.Tensor:
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        return torch.from_numpy(np.array(a))

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + [str(k)])
        elif isinstance(node, (list, tuple)):
            if path == ["rope"]:
                out["rope_cos"] = tensor(node[0])
                out["rope_sin"] = tensor(node[1])
                return
            for i, v in enumerate(node):
                walk(v, path + [str(i)])
        elif node is not None:
            name = ".".join(path)
            if path[-1] in _NORMS:
                name += ".weight"
            out[name] = tensor(node)

    walk(tree, [])
    return out

