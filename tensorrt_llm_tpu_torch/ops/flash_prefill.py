"""Flash attention for (chunked) prefill over paged KV.

Counterpart of `tensorrt_llm_tpu/ops/flash_prefill.py`.  `flash_prefill_plain`
is the plain version (the JAX package's `paged_prefill_xla`);
`flash_prefill_attention` takes it for CPU tensors and launches kernel K3
(`csrc/flash_prefill.cu`, head dims 64 and 128) for CUDA tensors.
"""

from __future__ import annotations

from typing import Optional

import torch

from tensorrt_llm_tpu_torch.ops import cuda_build
from tensorrt_llm_tpu_torch.ops.attention_plain import (
    paged_prefill_plain as flash_prefill_plain)

__all__ = ["flash_prefill_attention", "flash_prefill_plain"]


def _as_int(v) -> int:
    return int(v.item()) if isinstance(v, torch.Tensor) else int(v)


def flash_prefill_attention(q: torch.Tensor, k_cache: torch.Tensor,
                            v_cache: torch.Tensor, block_table: torch.Tensor,
                            kv_len, q_offset, scale: float,
                            sliding_window: Optional[int] = None,
                            logit_cap: Optional[float] = None,
                            sinks: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """One sequence's chunk q [T, Hq, D] (positions q_offset..) against its
    paged KV [NB, Hkv, BS, D] through block_table [MB]; kv_len counts the
    prefix plus the chunk, which is already written.  Returns [T, Hq, D]."""
    if q.device.type == "cpu":
        return flash_prefill_plain(q, k_cache, v_cache, block_table, kv_len,
                                   q_offset, scale, sliding_window, logit_cap,
                                   sinks)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    T, Hq, D = q.shape
    NB, Hkv, BS, Dk = k_cache.shape
    if D not in (64, 128) or Dk != D or Hq % Hkv:
        raise NotImplementedError(
            f"flash_prefill kernel: D in (64, 128) and Hq % Hkv == 0 "
            f"(D={D}, Hq={Hq}, Hkv={Hkv})")
    for name, t, dt in (("q", q, torch.bfloat16), ("k_cache", k_cache,
                        torch.bfloat16), ("v_cache", v_cache, torch.bfloat16),
                        ("block_table", block_table, torch.int32)):
        if t.device != q.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dt} on {q.device}")
    if v_cache.shape != k_cache.shape or block_table.dim() != 1:
        raise ValueError("pool or block table shape mismatch")
    if sinks is not None:
        sinks = sinks.to(device=q.device, dtype=torch.float32).contiguous()
        if sinks.shape != (Hq,):
            raise ValueError(f"sinks must be [{Hq}]")
    out = torch.empty_like(q)
    if T == 0:
        return out
    lib = cuda_build.load_library()
    err = lib.tllm_flash_prefill(
        cuda_build.ptr(q), cuda_build.ptr(k_cache), cuda_build.ptr(v_cache),
        cuda_build.ptr(block_table), cuda_build.ptr(sinks),
        cuda_build.ptr(out), T, Hq, Hkv, D, BS, block_table.shape[0],
        _as_int(kv_len), _as_int(q_offset), float(scale),
        int(sliding_window or 0), float(logit_cap or 0.0),
        cuda_build.stream_of(q))
    cuda_build.check(err, "flash_prefill")
    cuda_build.launch_counts["flash_prefill"] += 1
    return out
