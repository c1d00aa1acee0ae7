"""Multi-head Latent Attention module (DeepSeek V2/V3, Moonlight) and the
DSA lightning indexer (DeepSeek V3.2).

Counterpart of `tensorrt_llm_tpu/layers/mla.py` on one device.  Q is
projected directly (`q`) or through a low-rank bottleneck (`q_a` -> RMSNorm
-> `q_b`); KV is compressed by `kv_a` to ``L = kv_lora_rank`` latent
channels (RMS-normed) plus a shared rope key of ``R`` channels, and only
that latent row is cached (`ops/mla.py`).  The per-head up-projections of
`kv_b_proj` are absorbed: W_uk [H, N, L] into the query, W_uv [H, L, V] into
the output, both as f32 einsums of the bf16 weights, as in the JAX package.
q_pe and k_pe are roped in the interleaved (adjacent-pair) layout, and the
latent pool stores k_pe de-interleaved, as HF does.

The indexer (when `sparse` is set; it taps the compressed q, so it needs
`q_lora_rank`) projects its own keys (`wk` -> LayerNorm -> NeoX rope on the
first R channels -> Hadamard rotation) into a second pool, and per-head
weights (`weights_proj`, times ``Di^-0.5 * Hi^-0.5``).  At decode each
sequence attends only its indexer top-k latents; at prefill each query its
own top-k causal keys.

Dispatch is the JAX package's: sparse decode runs `mla_sparse_decode_plain`
and sparse prefill `mla_prefill_plain` with the top-k mask (plain torch on
the card too, as they are XLA on the TPU); dense prefill runs K10 and dense
decode K9 (their plain versions on CPU tensors); DSA's decode scores run
K11.  `q_a`, `q_b`, `q`, `kv_a` and `o` are quantized linears; W_uk / W_uv
stay bf16 and the indexer's projections unquantized, as in the JAX package.
Tensor parallelism over heads belongs to a later slice.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from tensorrt_llm_tpu_torch.attention_backend.interface import (
    AttentionMetadata)
from tensorrt_llm_tpu_torch.layers.linear import Linear
from tensorrt_llm_tpu_torch.ops.dsa import (
    dsa_decode_select, dsa_prefill_mask, mla_sparse_decode_plain,
    rotate_activation, write_indexer_cache)
from tensorrt_llm_tpu_torch.ops.mla import (
    mla_decode_attention, mla_prefill_attention, mla_prefill_plain,
    write_latent_cache)
from tensorrt_llm_tpu_torch.ops.norms import layer_norm, rms_norm
from tensorrt_llm_tpu_torch.ops.rope import apply_rope
from tensorrt_llm_tpu_torch.quantization import QuantConfig
from tensorrt_llm_tpu_torch.quantization.hf_ingest import QTensor

_INDEXER_NORM_EPS = 1e-6


class Indexer(nn.Module):
    """DSA lightning-indexer weights: `wq_b` [q_lora, Hi*Di], `wk` [H, Di]
    and `weights_proj` [H, Hi] unquantized, the key LayerNorm's weight and
    bias f32."""

    def __init__(self, hidden_size: int, q_lora_rank: int, sparse: dict):
        super().__init__()
        self.n_heads = int(sparse.get("index_n_heads", 64))
        self.head_dim = int(sparse.get("index_head_dim", 128))
        self.topk = int(sparse.get("index_topk", 2048))
        self.wq_b = Linear(q_lora_rank, self.n_heads * self.head_dim)
        self.wk = Linear(hidden_size, self.head_dim)
        self.weights_proj = Linear(hidden_size, self.n_heads)
        self.register_buffer("k_norm_w", None)
        self.register_buffer("k_norm_b", None)


class MLA(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int,
                 q_lora_rank: Optional[int], kv_lora_rank: int,
                 qk_nope_head_dim: int, qk_rope_head_dim: int,
                 v_head_dim: int, scale: float, rms_eps: float = 1e-6,
                 interleaved: bool = True,
                 quant: Optional[QuantConfig] = None,
                 sparse: Optional[dict] = None):
        super().__init__()
        self.num_heads = num_heads
        self.q_lora_rank = q_lora_rank
        self.kv_lora_rank = kv_lora_rank
        self.qk_nope_head_dim = qk_nope_head_dim
        self.qk_rope_head_dim = qk_rope_head_dim
        self.v_head_dim = v_head_dim
        self.qk_head_dim = qk_nope_head_dim + qk_rope_head_dim
        self.scale = scale
        self.rms_eps = rms_eps
        self.interleaved = interleaved
        H, nq = hidden_size, num_heads * self.qk_head_dim
        if q_lora_rank is not None:
            self.q_a = Linear(H, q_lora_rank, quant, "q_a_proj")
            self.q_b = Linear(q_lora_rank, nq, quant, "q_b_proj")
            self.register_buffer("q_norm", None)
        else:
            self.q = Linear(H, nq, quant, "q_proj")
        self.kv_a = Linear(H, kv_lora_rank + qk_rope_head_dim, quant,
                           "kv_a_proj")
        self.o = Linear(num_heads * v_head_dim, H, quant, "o_proj")
        for b in ("kv_norm", "w_uk", "w_uv"):
            self.register_buffer(b, None)
        self.indexer = None
        if sparse is not None:
            if q_lora_rank is None:
                raise ValueError("the DSA indexer taps the compressed q: it "
                                 "needs q_lora_rank")
            self.indexer = Indexer(hidden_size, q_lora_rank, sparse)

    # ---- parameters -----------------------------------------------------
    def from_float(self, kv_a_w, kv_b_w, o_w, kv_norm, q_w=None, q_a_w=None,
                   q_b_w=None, q_norm=None,
                   indexer: Optional[Dict[str, torch.Tensor]] = None
                   ) -> None:
        """Full float weights [in, out], as the JAX package's
        `MLA.from_float`: kv_b_w [L, H*(N+V)] is split into the absorbed
        W_uk [H, N, L] and W_uv [H, L, V]; `indexer` holds `wq_b`, `wk`,
        `k_norm_w`, `k_norm_b` (None: zeros) and `weights_proj`.  The
        linears also take AWQ/GPTQ `QTensor`s; kv_b_w then enters the bf16
        factors as its exact dequantization."""
        L, N, V = self.kv_lora_rank, self.qk_nope_head_dim, self.v_head_dim
        if isinstance(kv_b_w, QTensor):
            kv_b_w = kv_b_w.dequant()
        kv_b = kv_b_w.reshape(L, self.num_heads, N + V)
        self.w_uk = kv_b[:, :, :N].permute(1, 2, 0).to(
            torch.bfloat16).contiguous()
        self.w_uv = kv_b[:, :, N:].permute(1, 0, 2).to(
            torch.bfloat16).contiguous()
        self.kv_a.from_float(kv_a_w)
        self.kv_norm = kv_norm.to(torch.float32).contiguous()
        self.o.from_float(o_w)
        if self.q_lora_rank is not None:
            self.q_a.from_float(q_a_w)
            self.q_norm = q_norm.to(torch.float32).contiguous()
            self.q_b.from_float(q_b_w)
        else:
            self.q.from_float(q_w)
        if self.indexer is not None:
            ix = self.indexer
            ix.wq_b.from_float(indexer["wq_b"])
            ix.wk.from_float(indexer["wk"])
            ix.weights_proj.from_float(indexer["weights_proj"])
            ix.k_norm_w = indexer["k_norm_w"].to(torch.float32).contiguous()
            b = indexer.get("k_norm_b")
            ix.k_norm_b = (torch.zeros_like(ix.k_norm_w) if b is None
                           else b.to(torch.float32).contiguous())

    # ---- forward ----------------------------------------------------------
    def forward(self, x: torch.Tensor,
                rope_tables: Tuple[torch.Tensor, torch.Tensor], kv_cache,
                meta: AttentionMetadata) -> torch.Tensor:
        """x [T, hidden]; kv_cache is the latent pool [NB, 1, BS, L+R], or
        under DSA the pair (latent pool, indexer pool [NB, 1, BS, Di]), both
        updated in place."""
        if meta.pair_mask is not None:
            # the JAX MLA layer ignores the pair mask, so its tree rows are
            # verified without their ancestor mask (ROADMAP, "Found in the
            # reference"); the port refuses instead
            raise NotImplementedError(
                "draft-tree verification on MLA models is not supported")
        pool, idx_pool = (kv_cache if self.indexer is not None
                          else (kv_cache, None))
        T = x.shape[0]
        Hn, L, N = self.num_heads, self.kv_lora_rank, self.qk_nope_head_dim
        cq = None
        if self.q_lora_rank is not None:
            cq = rms_norm(self.q_a(x), self.q_norm, self.rms_eps)
            q = self.q_b(cq)
        else:
            q = self.q(x)
        q = q.reshape(T, Hn, self.qk_head_dim)
        q_nope, q_pe = q[..., :N], q[..., N:]
        ckv_full = self.kv_a(x)                              # [T, L+R]
        ckv = rms_norm(ckv_full[:, :L], self.kv_norm, self.rms_eps)
        k_pe = ckv_full[:, None, L:]                         # [T, 1, R]
        cos_t, sin_t = rope_tables
        q_pe, k_pe = apply_rope(q_pe, k_pe, meta.positions, cos_t, sin_t,
                                interleaved=self.interleaved)
        # absorb W_uk into the query: [T, H, N] x [H, N, L] -> [T, H, L]
        q_lat = torch.einsum("thn,hnl->thl", q_nope.to(torch.float32),
                             self.w_uk.to(torch.float32))
        q_eff = torch.cat([q_lat.to(x.dtype), q_pe.to(x.dtype)], dim=-1)
        write_latent_cache(pool, torch.cat([ckv, k_pe[:, 0]], dim=-1),
                           meta.slot_mapping)

        prefill = meta.mode == "prefill"
        kv_len = meta.q_offset + T       # prefill: prefix + this chunk
        if self.indexer is not None:
            sel, mask = self._index(x, cq, rope_tables, idx_pool, meta,
                                    kv_len)
            if prefill:
                out_lat = mla_prefill_plain(
                    q_eff, pool, meta.block_tables[0], kv_len, meta.q_offset,
                    self.scale, L, extra_mask=mask)
            else:
                out_lat = mla_sparse_decode_plain(
                    q_eff, pool, meta.block_tables, meta.kv_lens, sel,
                    self.scale, L)
        elif prefill:
            out_lat = mla_prefill_attention(
                q_eff, pool, meta.block_tables[0], kv_len, meta.q_offset,
                self.scale, L)
        else:
            out_lat = mla_decode_attention(q_eff, pool, meta.block_tables,
                                           meta.kv_lens, self.scale, L)
        # absorb W_uv on the output side: [T, H, L] x [H, L, V] -> [T, H, V]
        out = torch.einsum("thl,hlv->thv", out_lat.to(torch.float32),
                           self.w_uv.to(torch.float32)).to(x.dtype)
        return self.o(out.reshape(T, Hn * self.v_head_dim))

    def _index(self, x, cq, rope_tables, idx_pool, meta, kv_len):
        """Indexer keys appended to `idx_pool`; returns (decode top-k
        selection [B, K], None) or (None, prefill visibility mask [T, S])."""
        ix = self.indexer
        T, R = x.shape[0], self.qk_rope_head_dim
        Hi, Di = ix.n_heads, ix.head_dim
        k_idx = layer_norm(ix.wk(x), ix.k_norm_w, ix.k_norm_b,
                           _INDEXER_NORM_EPS)
        q_idx = ix.wq_b(cq).reshape(T, Hi, Di)
        # the indexer's rope is NeoX (not interleaved), on the first R dims
        qi_pe, ki_pe = apply_rope(q_idx[..., :R], k_idx[:, None, :R],
                                  meta.positions, *rope_tables)
        q_idx = rotate_activation(torch.cat([qi_pe.to(x.dtype),
                                             q_idx[..., R:]], dim=-1))
        k_idx = rotate_activation(torch.cat([ki_pe[:, 0].to(x.dtype),
                                             k_idx[:, R:]], dim=-1))
        write_indexer_cache(idx_pool, k_idx, meta.slot_mapping)
        w = ix.weights_proj(x).to(torch.float32) * (Di ** -0.5 * Hi ** -0.5)
        if meta.mode == "prefill":
            return None, dsa_prefill_mask(
                q_idx, w, idx_pool, meta.block_tables[0], kv_len,
                meta.q_offset, ix.topk)
        return dsa_decode_select(q_idx.contiguous(), w.contiguous(),
                                 idx_pool, meta.block_tables, meta.kv_lens,
                                 ix.topk), None
