"""Paged KV cache manager with prefix reuse.

Counterpart of the base `KVCacheManager` of
`tensorrt_llm_tpu/runtime/kv_cache_manager.py` with its pure-Python
bookkeeping (`_PyBookkeeping`): a block pool whose block 0 is reserved, a
reuse index of full blocks keyed by token-chain hashes, and LRU eviction of
unreferenced cached blocks (every block has the default retention priority;
per-request priorities come later).

Device pools, per layer, are K and V tensors of the logical head-major
layout ``[num_blocks, num_kv_heads, block_size, head_dim]``: bf16, or for an
INT8 cache (``kv_quant``) a pair of int8 data and f32 per-(token, head)
scales ``[num_blocks, num_kv_heads, block_size]`` indexed by the same block
ids, so a reused block carries its scales.  Under MLA (``layout="latent"``)
a layer has ONE bf16 pool ``[num_blocks, 1, block_size, L + R]`` of latent
rows, and under DSA (``dsa_index_dim``) the pair (latent pool, indexer-key
pool ``[num_blocks, 1, block_size, index_head_dim]``), as in the JAX
package.  The TPU's lane-packed view for head dims below 128, and its
latent width rounded up to 640, are TPU layouts and are not kept.

Not in this slice: the native (C++) bookkeeping, partial tail-block reuse,
beam forks, the host-memory tier and connector, KV events, VSWA rings and
the DP/helix/star managers.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

from tensorrt_llm_tpu_torch.quantization.mode import KvCacheQuantAlgo
from tensorrt_llm_tpu_torch.utils import cdiv, resolve_device


@dataclass
class KVCacheConfig:
    block_size: int = 16
    num_blocks: Optional[int] = None    # None => derive from free memory
    free_mem_fraction: float = 0.85
    enable_block_reuse: bool = True
    kv_quant: KvCacheQuantAlgo = KvCacheQuantAlgo.NONE
    # set from the model, not by the user: "kv" (K and V pools per layer)
    # or "latent" (one MLA pool per layer), plus the DSA indexer's width
    layout: str = "kv"
    dsa_index_dim: int = 0

    def __post_init__(self):
        self.kv_quant = KvCacheQuantAlgo(self.kv_quant)
        if self.kv_quant == KvCacheQuantAlgo.FP8:
            raise NotImplementedError("FP8 KV pools are not in the port yet")
        if self.layout not in ("kv", "latent"):
            raise ValueError(f"unknown KV layout {self.layout!r}")
        if self.layout == "latent" and self.kv_quant != KvCacheQuantAlgo.NONE:
            raise NotImplementedError("quantized latent (MLA) pools are not "
                                      "in the port yet")


def make_pools(num_layers: int, num_blocks: int, num_kv_heads: int,
               block_size: int, head_dim: int,
               kv_quant: KvCacheQuantAlgo = KvCacheQuantAlgo.NONE,
               device="cuda", layout: str = "kv",
               dsa_index_dim: int = 0) -> list:
    """Zeroed pools per layer: (K, V) bf16 ``[NB, Hkv, BS, D]``, or for INT8
    ``((k int8 [NB, Hkv, BS, D], k_scale f32 [NB, Hkv, BS]), (v, v_scale))``
    as the JAX package allocates them (logical layout, never lane-packed);
    for the latent layout one bf16 pool ``[NB, 1, BS, D]``, paired with the
    indexer pool ``[NB, 1, BS, dsa_index_dim]`` under DSA."""
    shape = (num_blocks, num_kv_heads, block_size, head_dim)
    if layout == "latent":
        def latent():
            lat = torch.zeros(shape, dtype=torch.bfloat16, device=device)
            if not dsa_index_dim:
                return lat
            return (lat, torch.zeros((num_blocks, 1, block_size,
                                      dsa_index_dim), dtype=torch.bfloat16,
                                     device=device))
        return [latent() for _ in range(num_layers)]

    def pool():
        if KvCacheQuantAlgo(kv_quant) == KvCacheQuantAlgo.INT8:
            return (torch.zeros(shape, dtype=torch.int8, device=device),
                    torch.zeros(shape[:3], dtype=torch.float32, device=device))
        return torch.zeros(shape, dtype=torch.bfloat16, device=device)

    return [(pool(), pool()) for _ in range(num_layers)]


def pool_layout(cfg) -> dict:
    """The pool geometry a model config needs (`ModelConfig`'s fields):
    ``num_kv_heads``, ``head_dim``, ``layout`` and ``dsa_index_dim``."""
    dsa = cfg.dsa
    return dict(num_kv_heads=cfg.kv_pool_heads, head_dim=cfg.kv_pool_dim,
                layout="latent" if cfg.is_mla else "kv",
                dsa_index_dim=int(dsa["index_head_dim"]) if dsa else 0)


def model_pools(cfg, num_blocks: int, block_size: int,
                kv_quant: KvCacheQuantAlgo = KvCacheQuantAlgo.NONE,
                device="cuda") -> list:
    """`make_pools` for a model config's layers (GQA or MLA)."""
    return make_pools(cfg.num_layers, num_blocks, block_size=block_size,
                      kv_quant=kv_quant, device=device, **pool_layout(cfg))


class SequenceInfo:
    __slots__ = ("block_ids", "num_tokens", "block_hashes", "salt")

    def __init__(self):
        self.block_ids: List[int] = []
        self.num_tokens = 0
        self.block_hashes: List[int] = []
        self.salt = None


class _PyBookkeeping:
    """Host bookkeeping: free list, ref counts, chain-hash reuse index."""

    def __init__(self, num_blocks: int, block_size: int, enable_reuse: bool):
        self.block_size = block_size
        self.enable_reuse = enable_reuse
        # block 0 is the reserved "null" block
        self.free_blocks = collections.deque(range(1, num_blocks))
        self.ref_count = [0] * num_blocks
        self.cached_blocks: Dict[int, int] = {}   # chain hash -> block
        self.block_hash: List[Optional[int]] = [None] * num_blocks
        # unreferenced cached blocks, least recently released first
        self.evictable: "collections.OrderedDict[int, None]" = \
            collections.OrderedDict()
        self.sequences: Dict[int, SequenceInfo] = {}
        self.num_reused_blocks = 0
        self.num_allocated_blocks = 0
        self.num_evicted_blocks = 0

    @staticmethod
    def _chain_hash(parent: int, tokens: tuple, salt) -> int:
        return hash((parent, tokens, salt))

    def _take_block(self) -> int:
        if self.free_blocks:
            bid = self.free_blocks.popleft()
        elif self.evictable:
            bid, _ = self.evictable.popitem(last=False)
            h = self.block_hash[bid]
            if h is not None:
                self.cached_blocks.pop(h, None)
                self.block_hash[bid] = None
            self.num_evicted_blocks += 1
        else:
            raise RuntimeError("KV cache out of blocks")
        self.ref_count[bid] = 1
        self.num_allocated_blocks += 1
        return bid

    def _ref_block(self, bid: int):
        if self.ref_count[bid] == 0:
            self.evictable.pop(bid, None)
        self.ref_count[bid] += 1

    def _unref_block(self, bid: int):
        self.ref_count[bid] -= 1
        assert self.ref_count[bid] >= 0
        if self.ref_count[bid] == 0:
            if self.block_hash[bid] is not None and self.enable_reuse:
                self.evictable[bid] = None
            else:
                self.free_blocks.append(bid)

    def num_free_blocks(self) -> int:
        return len(self.free_blocks) + len(self.evictable)

    def drop_cached_blocks(self):
        """Forget the reuse index: cached blocks hold KV of the old
        weights after a weight swap.  Blocks in use stay with their
        sequences and are freed, not cached, when released."""
        self.free_blocks.extend(self.evictable)
        self.evictable.clear()
        self.cached_blocks.clear()
        self.block_hash = [None] * len(self.block_hash)

    def add_sequence(self, seq_id: int, token_ids: List[int],
                     cache_salt=None) -> int:
        info = SequenceInfo()
        info.salt = cache_salt
        self.sequences[seq_id] = info
        matched, parent = 0, 0
        if self.enable_reuse:
            n_full = (len(token_ids) - 1) // self.block_size  # keep last token
            for b in range(n_full):
                chunk = tuple(token_ids[b * self.block_size:
                                        (b + 1) * self.block_size])
                h = self._chain_hash(parent, chunk, cache_salt)
                bid = self.cached_blocks.get(h)
                if bid is None:
                    break
                self._ref_block(bid)
                info.block_ids.append(bid)
                info.block_hashes.append(h)
                matched += self.block_size
                parent = h
        info.num_tokens = matched
        if matched:
            self.num_reused_blocks += len(info.block_ids)
        return matched

    def grow_sequence(self, seq_id: int, new_total_tokens: int):
        info = self.sequences[seq_id]
        need = cdiv(new_total_tokens, self.block_size)
        while len(info.block_ids) < need:
            info.block_ids.append(self._take_block())
        info.num_tokens = new_total_tokens

    def num_seq_blocks(self, seq_id: int) -> int:
        info = self.sequences.get(seq_id)
        return -1 if info is None else len(info.block_ids)

    def seal_full_blocks(self, seq_id: int, token_ids: List[int]):
        if not self.enable_reuse:
            return
        info = self.sequences[seq_id]
        n_full = len(token_ids) // self.block_size
        parent = info.block_hashes[-1] if info.block_hashes else 0
        for b in range(len(info.block_hashes), n_full):
            bid = info.block_ids[b]
            chunk = tuple(token_ids[b * self.block_size:
                                    (b + 1) * self.block_size])
            h = self._chain_hash(parent, chunk, info.salt)
            if h not in self.cached_blocks:   # first writer wins
                self.cached_blocks[h] = bid
                self.block_hash[bid] = h
            info.block_hashes.append(h)
            parent = h

    def free_sequence(self, seq_id: int):
        info = self.sequences.pop(seq_id, None)
        if info is None:
            return
        for bid in info.block_ids:
            self._unref_block(bid)

    def block_table(self, seq_id: int, max_blocks: int) -> List[int]:
        ids = self.sequences[seq_id].block_ids[:max_blocks]
        return ids + [0] * (max_blocks - len(ids))

    def slot_mapping(self, seq_id: int, start_token: int,
                     num_tokens: int) -> List[int]:
        ids = self.sequences[seq_id].block_ids
        bs = self.block_size
        return [ids[p // bs] * bs + p % bs
                for p in range(start_token, start_token + num_tokens)]

    def stats(self) -> dict:
        return {
            "free_blocks": len(self.free_blocks),
            "evictable_blocks": len(self.evictable),
            "reused_blocks": self.num_reused_blocks,
            "allocated_blocks": self.num_allocated_blocks,
            "evicted_blocks": self.num_evicted_blocks,
            "active_sequences": len(self.sequences),
        }


class KVCacheManager:
    def __init__(self, cfg: KVCacheConfig, num_layers: int, num_kv_heads: int,
                 head_dim: int, num_blocks: int, device="cuda"):
        self.cfg = cfg
        self.block_size = cfg.block_size
        self.num_layers = num_layers
        self.num_blocks = num_blocks
        self.num_kv_heads = num_kv_heads
        self.head_dim = head_dim
        self.device = resolve_device(device)
        self._bk = _PyBookkeeping(num_blocks, cfg.block_size,
                                  cfg.enable_block_reuse)

    def allocate_pools(self) -> List:
        """Zeroed pools per layer (`make_pools`)."""
        return make_pools(self.num_layers, self.num_blocks,
                          self.num_kv_heads, self.block_size, self.head_dim,
                          self.cfg.kv_quant, self.device, self.cfg.layout,
                          self.cfg.dsa_index_dim)

    @staticmethod
    def blocks_from_memory(bytes_budget: int, num_layers: int,
                           num_kv_heads: int, head_dim: int, block_size: int,
                           dtype_bytes: int = 2, num_pools: int = 2,
                           extra_dims: int = 0,
                           scale_pools: bool = False) -> int:
        """num_pools: 2 for K and V, 1 for the MLA latent layout.
        extra_dims: per-token channels of a layer's side pool (the DSA
        indexer's keys).  scale_pools: an INT8 cache adds an f32 scale per
        (token, head) to each pool."""
        per_block = num_pools * num_layers * block_size * num_kv_heads \
            * head_dim * dtype_bytes
        per_block += num_layers * block_size * extra_dims * dtype_bytes
        if scale_pools:
            per_block += num_pools * num_layers * block_size * num_kv_heads * 4
        return max(int(bytes_budget // per_block), 16)

    @property
    def num_free_blocks(self) -> int:
        return self._bk.num_free_blocks()

    def blocks_needed(self, num_tokens: int) -> int:
        return cdiv(num_tokens, self.block_size)

    def num_seq_blocks(self, seq_id: int) -> int:
        n = self._bk.num_seq_blocks(seq_id)
        return 0 if n < 0 else n

    def add_sequence(self, seq_id: int, token_ids: List[int],
                     cache_salt=None) -> int:
        """Register a sequence; returns the tokens whose KV is already
        cached (whole blocks, always fewer than the prompt so that at least
        one token is recomputed to produce logits)."""
        return self._bk.add_sequence(seq_id, token_ids, cache_salt)

    def grow_sequence(self, seq_id: int, new_total_tokens: int):
        self._bk.grow_sequence(seq_id, new_total_tokens)

    def seal_full_blocks(self, seq_id: int, token_ids: List[int]):
        """Publish completed prompt blocks into the reuse index."""
        self._bk.seal_full_blocks(seq_id, token_ids)

    def free_sequence(self, seq_id: int):
        self._bk.free_sequence(seq_id)

    def drop_cached_blocks(self):
        """Forget every reusable block (their KV came from other weights)."""
        self._bk.drop_cached_blocks()

    def block_table(self, seq_id: int, max_blocks: int) -> List[int]:
        return self._bk.block_table(seq_id, max_blocks)

    def slot_mapping(self, seq_id: int, start_token: int,
                     num_tokens: int) -> List[int]:
        return self._bk.slot_mapping(seq_id, start_token, num_tokens)

    def stats(self) -> dict:
        s = self._bk.stats()
        s["num_blocks"] = self.num_blocks
        return s
