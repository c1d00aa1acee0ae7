"""Paged decode attention: one query token per sequence.

Counterpart of `tensorrt_llm_tpu/ops/paged_attention.py`.
`paged_decode_plain` is the plain version (the JAX package's
`paged_decode_xla`); `paged_decode_attention` takes it for CPU tensors and
launches kernel K4 (`csrc/paged_decode.cu`, head dims 64 and 128, GQA groups
1, 2, 4, 8) for CUDA tensors.
"""

from __future__ import annotations

from typing import Optional

import torch

from tensorrt_llm_tpu_torch.ops import cuda_build
from tensorrt_llm_tpu_torch.ops.attention_plain import paged_decode_plain

__all__ = ["paged_decode_attention", "paged_decode_plain", "decode_splits"]

_SMS = 132


def decode_splits(B: int, Hkv: int, table_tokens: int):
    """(n_splits, split_len): KV splits per (sequence, KV head) so that the
    blocks cover the SMs twice; sized from the table width, since kv_lens
    stay on the device."""
    n = max(1, min(-(-2 * _SMS // max(B * Hkv, 1)), -(-table_tokens // 64)))
    split_len = -(-table_tokens // n)
    split_len = -(-split_len // 64) * 64
    return -(-table_tokens // split_len), split_len


def paged_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, block_tables: torch.Tensor,
                           kv_lens: torch.Tensor, scale: float,
                           sliding_window: Optional[int] = None,
                           logit_cap: Optional[float] = None,
                           sinks: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """q [B, Hq, D] against pools [NB, Hkv, BS, D] through block_tables
    [B, MB]; kv_lens [B] include the new token.  Returns [B, Hq, D]."""
    if q.device.type == "cpu":
        return paged_decode_plain(q, k_cache, v_cache, block_tables, kv_lens,
                                  scale, sliding_window, logit_cap, sinks)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, Hq, D = q.shape
    NB, Hkv, BS, Dk = k_cache.shape
    G = Hq // Hkv if Hkv else 0
    if D not in (64, 128) or Dk != D or Hq % Hkv or G not in (1, 2, 4, 8):
        raise NotImplementedError(
            f"paged_decode kernel: D in (64, 128), Hq/Hkv in (1, 2, 4, 8) "
            f"(D={D}, Hq={Hq}, Hkv={Hkv})")
    for name, t, dt in (("q", q, torch.bfloat16), ("k_cache", k_cache,
                        torch.bfloat16), ("v_cache", v_cache, torch.bfloat16),
                        ("block_tables", block_tables, torch.int32),
                        ("kv_lens", kv_lens, torch.int32)):
        if t.device != q.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dt} on {q.device}")
    MB = block_tables.shape[1]
    if v_cache.shape != k_cache.shape or block_tables.shape[0] != B \
            or kv_lens.shape != (B,):
        raise ValueError("pool, table or kv_lens shape mismatch")
    if sinks is not None:
        sinks = sinks.to(device=q.device, dtype=torch.float32).contiguous()
        if sinks.shape != (Hq,):
            raise ValueError(f"sinks must be [{Hq}]")
    out = torch.empty_like(q)
    if B == 0:
        return out
    n_splits, split_len = decode_splits(B, Hkv, MB * BS)
    ws = torch.empty((B * Hq * n_splits * (D + 2),), dtype=torch.float32,
                     device=q.device)
    lib = cuda_build.load_library()
    err = lib.tllm_paged_decode(
        cuda_build.ptr(q), cuda_build.ptr(k_cache), cuda_build.ptr(v_cache),
        cuda_build.ptr(block_tables), cuda_build.ptr(kv_lens),
        cuda_build.ptr(sinks), cuda_build.ptr(ws), cuda_build.ptr(out),
        B, Hq, Hkv, D, BS, MB, float(scale), int(sliding_window or 0),
        float(logit_cap or 0.0), n_splits, split_len, cuda_build.stream_of(q))
    cuda_build.check(err, "paged_decode")
    cuda_build.launch_counts["paged_decode"] += 1
    return out
