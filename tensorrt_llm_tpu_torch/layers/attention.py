"""Multi-head attention (GQA) over a paged KV cache.

Counterpart of `tensorrt_llm_tpu/layers/attention.py` for the dense GQA
families: fused QKV projection (optionally biased), q/k RMSNorm
(`has_qk_norm`: per head before RoPE, as Qwen3 and Gemma-3; with
`qk_norm_flat` one RMS over the flattened heads x D projection, Olmo2,
weights [H*D]; with `qk_norm_post_rope` per head after RoPE, HunYuan),
RoPE (adjacent pairs under `interleaved`, GLM and Llama4; partial when the
tables are narrower than the head; none on a NoPE layer, `nope`), Llama4's
unweighted per-head q/k RMS after RoPE (`qk_norm_l2`, HF
`Llama4TextL2Norm`, eps 1e-6) and its NoPE layers' query temperature
(`attn_temperature_tuning`: q times log1p(floor((pos + 1) / floor_scale))
* attn_scale + 1 at each token's position, in f32), KV append and backend
attention, output projection (optionally biased).
Attention sinks (a per-head logit in the softmax denominator), a per-layer
sliding window, a logit cap (`logit_cap`, Gemma-2's
`attn_logit_softcapping`) and chunked attention (`attention_chunk`) pass
through to the backend; `scale` overrides head_dim^-0.5 (Gemma's
`query_pre_attn_scalar ** -0.5`).  A sliding layer under VSWA rings
attends through its ring (`AttentionMetadata.for_sliding_layer`, applied
by the decoder layer).  Context parallelism belongs to a later slice.

Multi-LoRA (JAX `layers/attention.py:173-219`): when the layer holds
adapter stacks (``lora_qkv_*``, ``lora_o_*``, installed by
`lora.multi_lora`) and the step has `meta.lora_ids`, each row's adapter
product is added after the fused QKV and after the output projection.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from tensorrt_llm_tpu_torch.attention_backend.interface import (
    AttentionMetadata, get_attention_backend)
from tensorrt_llm_tpu_torch.layers.linear import Linear
from tensorrt_llm_tpu_torch.lora.multi_lora import apply_lora
from tensorrt_llm_tpu_torch.ops.norms import rms_norm
from tensorrt_llm_tpu_torch.ops.rope import apply_rope
from tensorrt_llm_tpu_torch.quantization import QuantConfig
from tensorrt_llm_tpu_torch.quantization.hf_ingest import wcat


class Attention(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int, num_kv_heads: int,
                 head_dim: int, quant: Optional[QuantConfig] = None,
                 device="cuda", has_bias: bool = False,
                 has_o_bias: bool = False, has_sinks: bool = False,
                 sliding_window: Optional[int] = None,
                 logit_cap: Optional[float] = None,
                 attention_chunk: Optional[int] = None,
                 scale: Optional[float] = None, has_qk_norm: bool = False,
                 rms_eps: float = 1e-6, qk_norm_flat: bool = False,
                 qk_norm_post_rope: bool = False, nope: bool = False,
                 interleaved: bool = False, qk_norm_l2: bool = False,
                 attn_temperature_tuning: bool = False,
                 floor_scale: float = 8192.0, attn_scale: float = 0.1):
        super().__init__()
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads
        self.head_dim = head_dim
        self.has_bias = has_bias
        self.has_o_bias = has_o_bias
        self.has_sinks = has_sinks
        self.has_qk_norm = has_qk_norm
        self.qk_norm_flat = qk_norm_flat
        self.qk_norm_post_rope = qk_norm_post_rope
        self.nope = nope
        self.interleaved = interleaved
        self.qk_norm_l2 = qk_norm_l2
        self.attn_temperature_tuning = attn_temperature_tuning
        self.floor_scale = floor_scale
        self.attn_scale = attn_scale
        self.rms_eps = rms_eps
        self.sliding_window = sliding_window
        qkv_out = (num_heads + 2 * num_kv_heads) * head_dim
        self.qkv = Linear(hidden_size, qkv_out, quant, "qkv_proj")
        self.o = Linear(num_heads * head_dim, hidden_size, quant, "o_proj")
        self.register_buffer("sinks", None)
        self.register_buffer("q_norm", None)
        self.register_buffer("k_norm", None)
        for b in ("lora_qkv_a", "lora_qkv_b", "lora_o_a", "lora_o_b"):
            self.register_buffer(b, None)
        self.backend = get_attention_backend(device)(
            num_heads, num_kv_heads, head_dim,
            scale if scale else head_dim ** -0.5,
            sliding_window=sliding_window, logit_cap=logit_cap,
            attention_chunk=attention_chunk)

    def from_float(self, q_w, k_w, v_w, o_w, q_b=None, k_b=None, v_b=None,
                   o_b=None, sinks=None, q_norm=None, k_norm=None) -> None:
        """Full float weights [in, out] (or AWQ/GPTQ `QTensor`s); biases,
        sinks and the q/k norm weights ([head_dim], or [heads * head_dim]
        under `qk_norm_flat`) as the JAX package's `Attention.from_float`
        takes them (tp = 1)."""
        bias = (torch.cat([q_b, k_b, v_b]) if self.has_bias else None)
        self.qkv.from_float(wcat([q_w, k_w, v_w]), bias)
        self.o.from_float(o_w, o_b if self.has_o_bias else None)
        if self.has_sinks:
            self.sinks = sinks.to(torch.float32).contiguous()
        if self.has_qk_norm:
            self.q_norm = q_norm.to(torch.float32).contiguous()
            self.k_norm = k_norm.to(torch.float32).contiguous()

    def forward(self, x: torch.Tensor,
                rope_tables: Tuple[torch.Tensor, torch.Tensor],
                kv_cache: Tuple[torch.Tensor, torch.Tensor],
                meta: AttentionMetadata) -> torch.Tensor:
        T = x.shape[0]
        D, qh, kvh = self.head_dim, self.num_heads, self.num_kv_heads
        qkv = self.qkv(x)
        lora = meta.lora_ids
        if lora is not None and self.lora_qkv_a is not None:
            qkv = apply_lora(x, qkv, (self.lora_qkv_a, self.lora_qkv_b), lora)
        q = qkv[:, :qh * D].reshape(T, qh, D)
        k = qkv[:, qh * D:(qh + kvh) * D].reshape(T, kvh, D)
        v = qkv[:, (qh + kvh) * D:].reshape(T, kvh, D).contiguous()
        eps = self.rms_eps
        if self.has_qk_norm and self.qk_norm_flat:
            q = rms_norm(q.reshape(T, qh * D), self.q_norm,
                         eps).reshape(T, qh, D)
            k = rms_norm(k.reshape(T, kvh * D), self.k_norm,
                         eps).reshape(T, kvh, D)
        elif self.has_qk_norm and not self.qk_norm_post_rope:
            q = rms_norm(q, self.q_norm, eps)
            k = rms_norm(k, self.k_norm, eps)
        if not self.nope:
            q, k = apply_rope(q, k, meta.positions, *rope_tables,
                              interleaved=self.interleaved)
        if self.qk_norm_l2:
            ones = torch.ones(D, dtype=torch.float32, device=q.device)
            q = rms_norm(q, ones, 1e-6)
            k = rms_norm(k, ones, 1e-6)
        if self.has_qk_norm and self.qk_norm_post_rope:
            q = rms_norm(q, self.q_norm, eps)
            k = rms_norm(k, self.k_norm, eps)
        if self.attn_temperature_tuning:
            pos = meta.positions.to(torch.float32)
            scale = (torch.log1p(torch.floor((pos + 1.0) / self.floor_scale))
                     * self.attn_scale + 1.0)
            q = (q.to(torch.float32) * scale[:, None, None]).to(q.dtype)
        k_cache, v_cache = kv_cache
        out = self.backend(q.contiguous(), k.contiguous(), v, k_cache,
                           v_cache, meta, sinks=self.sinks)
        out = out.reshape(T, qh * D)
        y = self.o(out)
        if lora is not None and self.lora_o_a is not None:
            y = apply_lora(out, y, (self.lora_o_a, self.lora_o_b), lora)
        return y
