"""Paged decode attention: one query token per sequence.

Counterpart of `tensorrt_llm_tpu/ops/paged_attention.py`.
`paged_decode_plain` is the plain version (the JAX package's
`paged_decode_xla`); `paged_decode_attention` takes it for CPU tensors and
for CUDA tensors launches kernel K4 over bf16 pools or K6 over INT8 pools
(`csrc/paged_decode.cu`, one template: head dims 64 and 128, GQA groups 1,
2, 4, 8).
"""

from __future__ import annotations

from typing import Optional

import torch

from tensorrt_llm_tpu_torch.ops import cuda_build
from tensorrt_llm_tpu_torch.ops.attention_plain import paged_decode_plain

__all__ = ["paged_decode_attention", "paged_decode_plain", "decode_splits",
           "pool_operands"]

_SMS = 132


def decode_splits(B: int, Hkv: int, table_tokens: int):
    """(n_splits, split_len): KV splits per (sequence, KV head) so that the
    blocks cover the SMs twice; sized from the table width, since kv_lens
    stay on the device."""
    n = max(1, min(-(-2 * _SMS // max(B * Hkv, 1)), -(-table_tokens // 64)))
    split_len = -(-table_tokens // n)
    split_len = -(-split_len // 64) * 64
    return -(-table_tokens // split_len), split_len


def pool_operands(k_cache, v_cache, device):
    """Check a K/V pool pair for the attention kernels: bf16 pools
    [NB, Hkv, BS, D], or INT8 pairs (int8 data [NB, Hkv, BS, D], f32 scales
    [NB, Hkv, BS]).  Returns (is_int8, (NB, Hkv, BS, D), device pointers in
    the C entry points' order: k, v or k_data, k_scale, v_data, v_scale)."""
    int8 = isinstance(k_cache, tuple)
    if int8 != isinstance(v_cache, tuple):
        raise ValueError("K and V pools must both be bf16 or both INT8")
    parts = [*k_cache, *v_cache] if int8 else [k_cache, v_cache]
    dts = ((torch.int8, torch.float32) * 2 if int8
           else (torch.bfloat16,) * 2)
    for t, dt in zip(parts, dts):
        if t.device != device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"KV pools must be contiguous {dt} on {device}")
    shape = tuple(parts[0].shape)
    data, scales = (parts[0::2], parts[1::2]) if int8 else (parts, [])
    if any(tuple(t.shape) != shape for t in data) \
            or any(tuple(t.shape) != shape[:3] for t in scales):
        raise ValueError("K/V pool shapes do not match")
    return int8, shape, [cuda_build.ptr(t) for t in parts]


def paged_decode_attention(q: torch.Tensor, k_cache, v_cache,
                           block_tables: torch.Tensor,
                           kv_lens: torch.Tensor, scale: float,
                           sliding_window: Optional[int] = None,
                           logit_cap: Optional[float] = None,
                           sinks: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """q [B, Hq, D] against pools [NB, Hkv, BS, D] (bf16, or INT8 pairs)
    through block_tables [B, MB]; kv_lens [B] include the new token.
    Returns [B, Hq, D]."""
    if q.device.type == "cpu":
        return paged_decode_plain(q, k_cache, v_cache, block_tables, kv_lens,
                                  scale, sliding_window, logit_cap, sinks)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    int8, (NB, Hkv, BS, Dk), pools = pool_operands(k_cache, v_cache,
                                                   q.device)
    B, Hq, D = q.shape
    G = Hq // Hkv if Hkv else 0
    if D not in (64, 128) or Dk != D or Hq % Hkv or G not in (1, 2, 4, 8):
        raise NotImplementedError(
            f"paged_decode kernel: D in (64, 128), Hq/Hkv in (1, 2, 4, 8) "
            f"(D={D}, Hq={Hq}, Hkv={Hkv})")
    for name, t, dt in (("q", q, torch.bfloat16),
                        ("block_tables", block_tables, torch.int32),
                        ("kv_lens", kv_lens, torch.int32)):
        if t.device != q.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dt} on {q.device}")
    MB = block_tables.shape[1]
    if block_tables.shape[0] != B or kv_lens.shape != (B,):
        raise ValueError("table or kv_lens shape mismatch")
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
    name = "paged_decode_int8" if int8 else "paged_decode"
    err = getattr(lib, "tllm_" + name)(
        cuda_build.ptr(q), *pools, cuda_build.ptr(block_tables),
        cuda_build.ptr(kv_lens), cuda_build.ptr(sinks), cuda_build.ptr(ws),
        cuda_build.ptr(out), B, Hq, Hkv, D, BS, MB, float(scale),
        int(sliding_window or 0), float(logit_cap or 0.0), n_splits,
        split_len, cuda_build.stream_of(q))
    cuda_build.check(err, name)
    cuda_build.launch_counts[name] += 1
    return out
