"""DSA (DeepSeek Sparse Attention) lightning-indexer ops.

Counterpart of `tensorrt_llm_tpu/ops/dsa.py`.  Each MLA layer of DeepSeek
V3.2 keeps, per token, an indexer key of ``Di`` channels in its own pool
``[NB, 1, BS, Di]``.  At decode the indexer scores every cached token

    score[b, s] = sum_h  w[b, h] * relu(q_idx[b, h] . k_idx[s])

and MLA attends over only the ``index_topk`` best; at prefill each query
keeps its own top-k causal keys (a mask on the dense prefill).

* `rotate_activation`: the Sylvester Hadamard transform scaled by D^-0.5,
  as one bf16 product, as in the JAX package.
* `dsa_scores_plain` is the plain version of kernel K11 (the JAX package's
  XLA scoring); `dsa_scores` takes it for CPU tensors and launches K11
  (`csrc/dsa_score.cu`, the counterpart of `dsa_scores_pallas`: TMA-fed
  wgmma over 64-token key tiles, tiles a block from `dsa_score_plan`) for
  CUDA tensors, or raises.
* `dsa_decode_select`, `mla_sparse_decode_plain` and `dsa_prefill_mask`
  are plain torch on the main path, on the card as well: the JAX package
  runs them in XLA, outside any Pallas kernel.  They are not the plain twins
  of a kernel.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tensorrt_llm_tpu_torch.ops import cuda_build
from tensorrt_llm_tpu_torch.ops.attention_plain import NEG_INF, pool_rows

__all__ = ["rotate_activation", "write_indexer_cache", "dsa_scores_plain",
           "dsa_scores", "dsa_score_plan", "dsa_score_tile_choices",
           "dsa_decode_select", "mla_sparse_decode_plain",
           "dsa_prefill_mask"]

_KERNEL_DIMS = ((64, 128),)   # (Hi, Di) K11 is built for
_SMS = 132
DSA_TILE = 64          # key tokens a K11 tile
DSA_BLOCKS_PER_SM = 2  # K11 blocks resident on an SM (~82 KB of shared memory)
DSA_MAX_TILES = 16     # tiles a K11 block at most (the chip check's choices)


@functools.lru_cache(maxsize=8)
def _hadamard(n: int) -> np.ndarray:
    if n & (n - 1):
        raise ValueError(f"Hadamard dim must be a power of 2: {n}")
    h = np.ones((1, 1), np.float32)
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h


_HADAMARD_ON = {}


def _hadamard_on(n: int, device) -> torch.Tensor:
    """The scaled, bf16-rounded Hadamard matrix as f32 on `device`, made
    once per (n, device): an upload on every call would make the host wait
    for the device."""
    key = (n, torch.device(device))
    hm = _HADAMARD_ON.get(key)
    if hm is None:
        hm = _HADAMARD_ON[key] = torch.from_numpy(
            _hadamard(n) * (n ** -0.5)).to(torch.bfloat16).to(
            device=device, dtype=torch.float32)
    return hm


def rotate_activation(x: torch.Tensor) -> torch.Tensor:
    """Scaled Hadamard transform over the trailing axis (scale D^-0.5): the
    bf16 input times the bf16-rounded matrix, accumulated in f32 and
    rounded once to bf16, as XLA computes the JAX package's bf16 einsum."""
    hm = _hadamard_on(x.shape[-1], x.device)
    return (x.to(torch.bfloat16).to(torch.float32) @ hm).to(torch.bfloat16)


def write_indexer_cache(cache: torch.Tensor, k_idx: torch.Tensor,
                        slot_mapping: torch.Tensor) -> None:
    """Scatter indexer keys [T, Di] into the pool [NB, 1, BS, Di] IN PLACE;
    slots past the pool land in reserved page 0."""
    nb, h, bs, d = cache.shape
    rows = pool_rows(slot_mapping, nb, h, bs)
    cache.view(-1, d).index_copy_(0, rows, k_idx.to(cache.dtype))


def dsa_scores_plain(q_idx: torch.Tensor, weights: torch.Tensor,
                     idx_cache: torch.Tensor, block_tables: torch.Tensor,
                     kv_lens: torch.Tensor) -> torch.Tensor:
    """Indexer scores [B, MB*BS] f32 of every table slot; NEG_INF at and
    past kv_lens[b].  q_idx [B, Hi, Di], weights [B, Hi] (pre-scaled)."""
    B = q_idx.shape[0]
    di = idx_cache.shape[-1]
    keys = idx_cache[block_tables.long()][:, :, 0].reshape(B, -1, di)
    S = keys.shape[1]
    logits = torch.einsum("bhd,bsd->bhs", q_idx.to(torch.float32),
                          keys.to(torch.float32))
    scores = torch.einsum("bh,bhs->bs", weights.to(torch.float32),
                          torch.relu(logits))
    valid = torch.arange(S, device=q_idx.device)[None, :] \
        < kv_lens.to(q_idx.device).long()[:, None]
    return torch.where(valid, scores, NEG_INF)


def dsa_score_plan(B: int, table_tokens: int):
    """(tiles a block, blocks a sequence) of K11: each block scores
    `tiles` consecutive 64-token tiles of one sequence's table, as few as
    keep B x blocks within the card's resident blocks (two an SM), so that
    the blocks fill the card at the table width.  Sized from the table
    width only, since kv_lens stay on the device; the kernel skips the
    tiles past each sequence's kv_len."""
    n_tiles = max(1, -(-table_tokens // DSA_TILE))
    slots = DSA_BLOCKS_PER_SM * _SMS
    per = min(DSA_MAX_TILES, n_tiles, max(1, -(-n_tiles * max(B, 1) // slots)))
    return per, -(-n_tiles // per)


def dsa_score_tile_choices(table_tokens: int):
    """Every tile count a K11 block can take at this table width, up to
    `DSA_MAX_TILES`: what the chip check times against the plan."""
    n_tiles = max(1, -(-table_tokens // DSA_TILE))
    return list(range(1, min(n_tiles, DSA_MAX_TILES) + 1))


def dsa_scores(q_idx: torch.Tensor, weights: torch.Tensor,
               idx_cache: torch.Tensor, block_tables: torch.Tensor,
               kv_lens: torch.Tensor, tiles_per_block=None) -> torch.Tensor:
    """`dsa_scores_plain` for CPU tensors; kernel K11 for CUDA tensors
    (pages of a multiple of 8 tokens).  `tiles_per_block` pins the plan's
    tiles a block."""
    if q_idx.device.type == "cpu":
        return dsa_scores_plain(q_idx, weights, idx_cache, block_tables,
                                kv_lens)
    B, Hi, Di = q_idx.shape
    if (Hi, Di) not in _KERNEL_DIMS or idx_cache.dim() != 4 \
            or idx_cache.shape[1] != 1 or idx_cache.shape[-1] != Di:
        raise NotImplementedError(
            f"dsa_score kernel is built for (Hi, Di) in {_KERNEL_DIMS} over "
            f"a pool [NB, 1, BS, Di]: q {tuple(q_idx.shape)}, pool "
            f"{tuple(idx_cache.shape)}")
    NB, _, BS, _ = idx_cache.shape
    if BS % 8:
        raise NotImplementedError(
            "the dsa_score kernel takes pages of a multiple of 8 tokens "
            f"(TMA boxes in the 128-byte swizzle): got {BS}")
    if q_idx.device.type != "cuda":
        raise ValueError(f"unsupported device {q_idx.device}")
    dev = q_idx.device
    for name, t, dt in (("q_idx", q_idx, torch.bfloat16),
                        ("weights", weights, torch.float32),
                        ("idx_cache", idx_cache, torch.bfloat16),
                        ("block_tables", block_tables, torch.int32),
                        ("kv_lens", kv_lens, torch.int32)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dt} on {dev}")
    if q_idx.data_ptr() % 16 or idx_cache.data_ptr() % 16:
        raise ValueError("q_idx and the pool must start 16-byte aligned "
                         "(TMA)")
    MB = block_tables.shape[1]
    if weights.shape != (B, Hi) or block_tables.shape[0] != B \
            or kv_lens.shape != (B,):
        raise ValueError("weights, table or kv_lens shape mismatch")
    out = torch.empty((B, MB * BS), dtype=torch.float32, device=dev)
    if B == 0 or MB == 0:
        return out
    if tiles_per_block is None:
        tiles_per_block, _ = dsa_score_plan(B, MB * BS)
    elif tiles_per_block < 1:
        raise ValueError("tiles_per_block must be positive")
    err = cuda_build.load_library().tllm_dsa_score(
        cuda_build.ptr(q_idx), cuda_build.ptr(weights),
        cuda_build.ptr(idx_cache), cuda_build.ptr(block_tables),
        cuda_build.ptr(kv_lens), cuda_build.ptr(out), B, Hi, Di, NB, BS, MB,
        int(tiles_per_block), cuda_build.stream_of(q_idx))
    cuda_build.check(err, "dsa_score")
    cuda_build.launch_counts["dsa_score"] += 1
    return out


def dsa_decode_select(q_idx: torch.Tensor, weights: torch.Tensor,
                      idx_cache: torch.Tensor, block_tables: torch.Tensor,
                      kv_lens: torch.Tensor, index_topk: int
                      ) -> torch.Tensor:
    """Top-k token selection: [B, K] int64 indices into each sequence's
    table space, K = min(index_topk, MB*BS).  When kv_len < K some picks are
    invalid slots; the sparse decode masks them.  The top-k is a stable
    descending sort, so ties go to the lower index, as `lax.top_k` breaks
    them (scores tie exactly where every head's logit is <= 0).  Plain
    torch on every device (XLA in the JAX package); only the scores run
    on a kernel (K11) on the card."""
    scores = dsa_scores(q_idx, weights, idx_cache, block_tables, kv_lens)
    k = min(index_topk, scores.shape[1])
    return torch.sort(scores, dim=1, descending=True, stable=True)[1][:, :k]


def mla_sparse_decode_plain(q_eff: torch.Tensor, cache: torch.Tensor,
                            block_tables: torch.Tensor, kv_lens: torch.Tensor,
                            sel: torch.Tensor, scale: float,
                            kv_lora_rank: int) -> torch.Tensor:
    """Absorbed MLA decode over only the selected latents sel [B, K].
    Returns [B, H, L].  Plain torch on every device, the main path's DSA
    decode (XLA in the JAX package); no kernel stands behind it."""
    bs = cache.shape[2]
    sel = sel.long()
    blk = torch.gather(block_tables.long(), 1, sel // bs)      # [B, K]
    latf = cache[blk, 0, sel % bs].to(torch.float32)          # [B, K, L+R]
    qf = q_eff.to(torch.float32) * scale
    scores = torch.einsum("bhd,bkd->bhk", qf, latf)
    mask = sel < kv_lens.to(sel.device).long()[:, None]
    scores = torch.where(mask[:, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhk,bkl->bhl", probs, latf[..., :kv_lora_rank])
    return out.to(q_eff.dtype)


def dsa_prefill_mask(q_idx: torch.Tensor, weights: torch.Tensor,
                     idx_cache: torch.Tensor, block_table: torch.Tensor,
                     kv_len, q_offset, index_topk: int) -> torch.Tensor:
    """Per-query top-k visibility mask [T, MB*BS] bool for one sequence's
    prefill chunk: each query keeps its ``index_topk`` best causal keys (ties
    at the threshold stay visible, as in the JAX package).  Plain torch on
    every device (XLA in the JAX package); no kernel stands behind it."""
    T = q_idx.shape[0]
    di = idx_cache.shape[-1]
    keys = idx_cache[block_table.long()][:, 0].reshape(-1, di)
    S = keys.shape[0]
    logits = torch.einsum("thd,sd->ths", q_idx.to(torch.float32),
                          keys.to(torch.float32))
    scores = torch.einsum("th,ths->ts", weights.to(torch.float32),
                          torch.relu(logits))
    kv_pos = torch.arange(S, device=q_idx.device)[None, :]
    q_pos = q_offset + torch.arange(T, device=q_idx.device)[:, None]
    causal = (kv_pos <= q_pos) & (kv_pos < kv_len)
    scores = torch.where(causal, scores, NEG_INF)
    kth = torch.topk(scores, min(index_topk, S), dim=1).values[:, -1:]
    return causal & (scores >= kth)
