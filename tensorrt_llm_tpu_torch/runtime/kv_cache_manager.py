"""Paged KV cache manager with prefix reuse.

Counterpart of the base `KVCacheManager` of
`tensorrt_llm_tpu/runtime/kv_cache_manager.py`: a block pool whose block 0
is reserved, a reuse index of full blocks keyed by token-chain hashes,
eviction of unreferenced cached blocks by retention priority (lowest
first, LRU within a priority; `set_seq_priority`), and partial tail-block
reuse (`KVCacheConfig.enable_partial_reuse`: after the full-block match, a
cached block sharing a token prefix with the prompt's next tokens serves
those tokens, copied into a fresh block under `copy_on_partial_reuse` --
the pairs the engine must copy come from `drain_partial_copies` -- or
adopted in place when unreferenced).

The host bookkeeping has two backends with one op surface and the same
decisions: `_NativeBookkeeping` over the C++ library `native/
kv_bookkeeping.cc` (the default) and `_PyBookkeeping`.  The backend is
chosen by `KVCacheConfig.bookkeeping` alone: a failed native build raises,
and Python runs only when it is asked for.

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

KV events (JAX `kvCacheEventManager` feed of the ``/kv_cache_events``
route): a bounded ring (`EVENT_RING` entries) of ``stored`` events, one per
full block a sequence seals (``block_hash`` and ``parent_hash``, its
predecessor's, 0 at the root), and ``removed`` events, one per cached
block evicted from the device pool when no other device block carries its
content.  Hashes are the JAX package's process-stable salted chain hash
(`_whash`: FNV-1a over the parent hash and the block's tokens, the salt's
SHA-256 mixed in), so a router can compare workers, and both backends feed
it: the wrapper hashes, the backend reports evicted block ids
(`drain_evictions`).  `get_events(since_id)`, `event_cursor()` and
`reuse_block_hashes()` are JAX's.  One intended difference: a block sealed
with content that another device block already caches (two sequences of
one prefix in one batch) is not the reuse index's, so it carries no hash
here; the JAX package counts it, and then never reports the content
removed.

The host-memory tier and the connector (JAX `host_cache_blocks`,
`secondary_offload_min_priority`, `KvCacheConnector`): once the engine's
page copies are attached (`attach_block_io`, the disaggregated-serving
extract and inject), each reuse block the backend evicts (`drain_evictions`,
on both backends) is offloaded before any new device write can overwrite it
(`_drain_evictions`): to the host cache (an LRU of `host_cache_blocks`
payloads keyed by the stable chain hash; only blocks whose retention
priority reaches `secondary_offload_min_priority`, when set) and to the
connector (`save`; every evicted block), a tier colder than the host.
`add_sequence` onboards the blocks past the device match from the host
cache, else the connector (`load`), allocating and injecting each, and
stops at the first miss or when the device pool is exhausted; partial
tail-block reuse then applies only if the chain tip was matched on the
device.  `match_prefix` counts host and connector blocks (`contains`).  A
connector exception is logged and taken as a miss, never raised.  A
``removed`` event fires only when a content leaves every matchable tier
(device, host cache, connector).  `num_offloaded`, `num_onboarded`,
`num_connector_saves` and `num_connector_loads` count the traffic, in
`stats()` too.  All of it runs on the executor's thread, as every
bookkeeping operation does.

Not in this slice: beam forks, VSWA rings and the DP/helix/star managers.
"""

from __future__ import annotations

import collections
import hashlib
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from tensorrt_llm_tpu_torch.quantization.mode import KvCacheQuantAlgo
from tensorrt_llm_tpu_torch.utils import cdiv, logger, resolve_device


@dataclass
class KVCacheConfig:
    block_size: int = 16
    num_blocks: Optional[int] = None    # None => derive from free memory
    free_mem_fraction: float = 0.85
    enable_block_reuse: bool = True
    # partial tail-block reuse (the JAX package's defaults: both on)
    enable_partial_reuse: bool = True
    copy_on_partial_reuse: bool = True
    # host bookkeeping backend: "native" (C++, built at first use) or
    # "python"; never one in place of the other
    bookkeeping: str = "native"
    kv_quant: KvCacheQuantAlgo = KvCacheQuantAlgo.NONE
    # set from the model, not by the user: "kv" (K and V pools per layer)
    # or "latent" (one MLA pool per layer), plus the DSA indexer's width
    layout: str = "kv"
    dsa_index_dim: int = 0
    # host-memory tier: evicted reuse blocks kept in host RAM (0: off), and
    # the least retention priority that goes there (None: any)
    host_cache_blocks: int = 0
    secondary_offload_min_priority: Optional[int] = None
    # external KV store: save(key, payload) / load(key) / contains(key)
    kv_connector: Optional[Any] = None

    def __post_init__(self):
        self.kv_quant = KvCacheQuantAlgo(self.kv_quant)
        if self.bookkeeping not in ("native", "python"):
            raise ValueError(f"bookkeeping={self.bookkeeping!r}: 'native' "
                             "or 'python'")
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


EVENT_RING = 4096   # KV events kept for `get_events`


def _stable_mix(h: int, v: int) -> int:
    h ^= v & 0xFFFFFFFFFFFFFFFF
    return (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF


def _whash(parent: int, chunk: tuple, salt) -> int:
    """The JAX package's process-stable content chain hash (FNV-1a over
    ints, the salt's SHA-256 mixed in), unlike Python's seeded `hash`."""
    h = _stable_mix(0xCBF29CE484222325, parent)
    for t in chunk:
        h = _stable_mix(h, int(t))
    if salt is not None:
        d = hashlib.sha256(repr(salt).encode()).digest()
        h = _stable_mix(h, int.from_bytes(d[:8], "little"))
    return h


class KvCacheConnector:
    """External KV-block store (JAX `KvCacheConnector`): the manager calls
    `save` as reuse blocks leave the device, `load` on prefix misses past
    the device and host tiers, and `contains` when scoring a prefix
    without side effects.  Payloads are `ModelEngine.extract_kv_blocks`'s
    output for one block (per layer, the pools' leaves as CPU tensors);
    keys are the process-stable chain hashes of (parent, block tokens,
    salt), so a store shared by processes serves equal tokenizations."""

    def save(self, key: int, payload) -> None:
        raise NotImplementedError

    def load(self, key: int):
        """The payload stored under `key`, or None."""
        raise NotImplementedError

    def contains(self, key: int) -> bool:
        """A remote store should override this with a cheap key probe:
        the default loads the payload and drops it."""
        return self.load(key) is not None


def prefix_chain_hashes(token_ids, block_size: int) -> List[int]:
    """The stable chain hash of every full block of an unsalted prompt:
    what the ``stored`` KV events advertise, so a router's view can match a
    prompt against them (each hash encodes its whole prefix)."""
    parent, out = 0, []
    for b in range(len(token_ids) // block_size):
        parent = _whash(parent, tuple(token_ids[b * block_size:
                                                (b + 1) * block_size]), None)
        out.append(parent)
    return out


# Default retention priority (the reference's KvCacheRetentionConfig,
# executor.h:559): lower evicts first.
DEFAULT_RETENTION_PRIORITY = 35


class SequenceInfo:
    __slots__ = ("block_ids", "num_tokens", "block_hashes", "salt",
                 "priority")

    def __init__(self):
        self.block_ids: List[int] = []
        self.num_tokens = 0
        self.block_hashes: List[int] = []
        self.salt = None
        self.priority = DEFAULT_RETENTION_PRIORITY


class _PyBookkeeping:
    """Host bookkeeping in Python (JAX `_PyBookkeeping`): free list, ref
    counts, chain-hash reuse index, priority buckets of evictable blocks
    and the partial-reuse side index."""

    def __init__(self, num_blocks: int, block_size: int, enable_reuse: bool):
        self.block_size = block_size
        self.enable_reuse = enable_reuse
        # block 0 is the reserved "null" block
        self.free_blocks = collections.deque(range(1, num_blocks))
        self.ref_count = [0] * num_blocks
        self.cached_blocks: Dict[int, int] = {}   # chain hash -> block
        self.block_hash: List[Optional[int]] = [None] * num_blocks
        # unreferenced cached blocks by retention priority, least recently
        # released first within a priority
        self.evictable: Dict[int, collections.OrderedDict] = {}
        self.block_priority = [DEFAULT_RETENTION_PRIORITY] * num_blocks
        self.sequences: Dict[int, SequenceInfo] = {}
        # partial-reuse side index: sealed blocks' tokens and the children
        # of each (parent hash, salt) chain node
        self.block_tokens: Dict[int, tuple] = {}
        self.block_parent: Dict[int, tuple] = {}
        self.children: Dict[tuple, collections.OrderedDict] = {}
        self.num_reused_blocks = 0
        self.num_partial_reused = 0
        self.num_allocated_blocks = 0
        self.num_evicted_blocks = 0
        # block ids evicted from the reuse index since the last drain
        self.pending_evictions: List[int] = []

    @staticmethod
    def _chain_hash(parent: int, tokens: tuple, salt) -> int:
        return hash((parent, tokens, salt))

    def _n_evictable(self) -> int:
        return sum(len(b) for b in self.evictable.values())

    def set_seq_priority(self, seq_id: int, priority: int):
        info = self.sequences.get(seq_id)
        if info is not None:
            info.priority = int(priority)

    def _take_block(self) -> int:
        if self.free_blocks:
            bid = self.free_blocks.popleft()
        elif self.evictable:
            prio = min(self.evictable)
            bucket = self.evictable[prio]
            bid, _ = bucket.popitem(last=False)   # LRU within a priority
            if not bucket:
                del self.evictable[prio]
            h = self.block_hash[bid]
            if h is not None:
                self.cached_blocks.pop(h, None)
                self.block_hash[bid] = None
            self._forget_block(bid)
            self.num_evicted_blocks += 1
            self.pending_evictions.append(bid)
        else:
            raise RuntimeError("KV cache out of blocks")
        self.ref_count[bid] = 1
        self.num_allocated_blocks += 1
        return bid

    def drain_evictions(self) -> List[int]:
        out, self.pending_evictions = self.pending_evictions, []
        return out

    def _forget_block(self, bid: int):
        """Drop a block from the partial-reuse side index."""
        self.block_tokens.pop(bid, None)
        key = self.block_parent.pop(bid, None)
        if key is not None:
            bucket = self.children.get(key)
            if bucket is not None:
                bucket.pop(bid, None)
                if not bucket:
                    del self.children[key]

    def _ref_block(self, bid: int):
        if self.ref_count[bid] == 0:
            for p, bucket in list(self.evictable.items()):
                if bucket.pop(bid, None) is not None:
                    if not bucket:
                        del self.evictable[p]
                    break
        self.ref_count[bid] += 1

    def _unref_block(self, bid: int):
        self.ref_count[bid] -= 1
        assert self.ref_count[bid] >= 0
        if self.ref_count[bid] == 0:
            if self.block_hash[bid] is not None and self.enable_reuse:
                self.evictable.setdefault(
                    self.block_priority[bid],
                    collections.OrderedDict())[bid] = None
            else:
                self.free_blocks.append(bid)

    def num_free_blocks(self) -> int:
        return len(self.free_blocks) + self._n_evictable()

    def drop_cached_blocks(self):
        """Forget the reuse index: cached blocks hold KV of the old
        weights after a weight swap.  Blocks in use stay with their
        sequences and are freed, not cached, when released."""
        for prio in sorted(self.evictable):
            self.free_blocks.extend(self.evictable[prio])
        self.evictable.clear()
        self.cached_blocks.clear()
        self.block_hash = [None] * len(self.block_hash)
        self.block_tokens.clear()
        self.block_parent.clear()
        self.children.clear()

    def match_prefix(self, token_ids: List[int], cache_salt=None,
                     partial: bool = False) -> int:
        """Dry-run reuse lookup: cached prefix tokens, no side effects."""
        if not self.enable_reuse:
            return 0
        matched, parent = 0, 0
        for b in range((len(token_ids) - 1) // self.block_size):
            chunk = tuple(token_ids[b * self.block_size:
                                    (b + 1) * self.block_size])
            h = self._chain_hash(parent, chunk, cache_salt)
            if h not in self.cached_blocks:
                break
            matched += self.block_size
            parent = h
        if partial:
            matched += self._best_partial(parent, cache_salt, token_ids,
                                          matched)[0]
        return matched

    def _best_partial(self, parent: int, salt, token_ids: List[int],
                      matched: int) -> Tuple[int, int]:
        """Longest shared token prefix of any cached child of `parent`
        with the prompt's next tokens, leaving at least one token to
        compute.  Returns (k, block id)."""
        limit = min(self.block_size, len(token_ids) - 1 - matched)
        if limit < 1:
            return 0, -1
        cands = self.children.get((parent, salt))
        if not cands:
            return 0, -1
        target = token_ids[matched:matched + limit]
        best_k, best_bid = 0, -1
        for bid in cands:
            toks = self.block_tokens.get(bid)
            if toks is None:
                continue
            k = 0
            for x, y in zip(toks, target):
                if x != y:
                    break
                k += 1
            if k > best_k:
                best_k, best_bid = k, bid
        return best_k, best_bid

    def try_partial_match(self, seq_id: int, token_ids: List[int],
                          copy_on_partial: bool = True
                          ) -> Tuple[int, int, int]:
        """After the full-block match, reuse the cached child of the chain
        tail whose tokens share the longest prefix with the prompt's next
        tokens: in a fresh block the caller copies the source page into
        (`copy_on_partial`), or the source block itself, adopted in place
        when unreferenced (it leaves the reuse index).  Returns
        (tokens, src, dst); dst == src needs no copy; (0, -1, -1) when
        nothing matched."""
        if not self.enable_reuse:
            return (0, -1, -1)
        info = self.sequences[seq_id]
        bs = self.block_size
        if info.num_tokens % bs or \
                info.num_tokens != bs * len(info.block_ids) or \
                len(info.block_hashes) != len(info.block_ids):
            return (0, -1, -1)
        parent = info.block_hashes[-1] if info.block_hashes else 0
        k, src = self._best_partial(parent, info.salt, token_ids,
                                    info.num_tokens)
        if k < 1:
            return (0, -1, -1)
        if not copy_on_partial:
            if self.ref_count[src] != 0:
                return (0, -1, -1)
            self._ref_block(src)
            h = self.block_hash[src]
            if h is not None:
                self.cached_blocks.pop(h, None)
                self.block_hash[src] = None
            self._forget_block(src)
            self.num_allocated_blocks += 1
            dst = src
        else:
            self._ref_block(src)   # pinned: _take_block may evict it
            try:
                dst = self._take_block()
            except RuntimeError:
                self._unref_block(src)
                return (0, -1, -1)
            self._unref_block(src)
        info.block_ids.append(dst)
        info.num_tokens += k
        self.num_partial_reused += 1
        return (k, src, dst)

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
                self.block_priority[bid] = info.priority
                self.block_tokens[bid] = chunk
                key = (parent, info.salt)
                self.block_parent[bid] = key
                self.children.setdefault(
                    key, collections.OrderedDict())[bid] = None
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
            "evictable_blocks": self._n_evictable(),
            "reused_blocks": self.num_reused_blocks,
            "partial_reused_blocks": self.num_partial_reused,
            "allocated_blocks": self.num_allocated_blocks,
            "evicted_blocks": self.num_evicted_blocks,
            "active_sequences": len(self.sequences),
        }


class _NativeBookkeeping:
    """The same op surface over the C++ library (`native.load_native`).
    Salts are hashed with Python's `hash`, so equal salts meet within one
    process, as the Python backend's chain hashes do."""

    def __init__(self, lib, num_blocks: int, block_size: int,
                 enable_reuse: bool):
        import ctypes
        self._ct = ctypes
        self._pi32 = ctypes.POINTER(ctypes.c_int32)
        self._lib = lib
        self.block_size = block_size
        self._h = lib.tllm_kvbm_create(num_blocks, block_size,
                                       1 if enable_reuse else 0)

    def __del__(self):
        try:
            self._lib.tllm_kvbm_destroy(self._h)
        except Exception:  # noqa: BLE001 -- interpreter teardown
            pass

    def _tok_buf(self, token_ids):
        arr = np.asarray(token_ids, dtype=np.int32)
        return arr, arr.ctypes.data_as(self._pi32)

    @staticmethod
    def _salt(cache_salt):
        return ((0, 0) if cache_salt is None
                else (hash(cache_salt) & (2 ** 64 - 1), 1))

    def num_free_blocks(self) -> int:
        return int(self._lib.tllm_kvbm_num_free(self._h))

    def set_seq_priority(self, seq_id: int, priority: int):
        self._lib.tllm_kvbm_set_priority(self._h, seq_id, int(priority))

    def drop_cached_blocks(self):
        self._lib.tllm_kvbm_drop_cached(self._h)

    def drain_evictions(self) -> List[int]:
        out: List[int] = []
        buf = np.zeros(256, np.int32)
        ptr = buf.ctypes.data_as(self._pi32)
        while True:
            n = int(self._lib.tllm_kvbm_drain_evictions(self._h, ptr, 256))
            out.extend(buf[:n].tolist())
            if n < 256:
                return out

    def match_prefix(self, token_ids, cache_salt=None,
                     partial: bool = False) -> int:
        _keep, ptr = self._tok_buf(token_ids)
        fn = (self._lib.tllm_kvbm_match_partial if partial
              else self._lib.tllm_kvbm_match)
        return int(fn(self._h, ptr, len(token_ids), *self._salt(cache_salt)))

    def try_partial_match(self, seq_id: int, token_ids,
                          copy_on_partial: bool = True
                          ) -> Tuple[int, int, int]:
        _keep, ptr = self._tok_buf(token_ids)
        out = (self._ct.c_int64 * 3)()
        self._lib.tllm_kvbm_partial_match(
            self._h, seq_id, ptr, len(token_ids),
            1 if copy_on_partial else 0, out)
        return (int(out[0]), int(out[1]), int(out[2]))

    def add_sequence(self, seq_id: int, token_ids, cache_salt=None) -> int:
        _keep, ptr = self._tok_buf(token_ids)
        return int(self._lib.tllm_kvbm_add_sequence(
            self._h, seq_id, ptr, len(token_ids), *self._salt(cache_salt)))

    def grow_sequence(self, seq_id: int, new_total_tokens: int):
        rc = self._lib.tllm_kvbm_grow(self._h, seq_id, new_total_tokens)
        if rc == -2:
            raise KeyError(seq_id)
        if rc != 0:
            raise RuntimeError("KV cache out of blocks")

    def num_seq_blocks(self, seq_id: int) -> int:
        return int(self._lib.tllm_kvbm_seq_num_blocks(self._h, seq_id))

    def seal_full_blocks(self, seq_id: int, token_ids):
        _keep, ptr = self._tok_buf(token_ids)
        self._lib.tllm_kvbm_seal(self._h, seq_id, ptr, len(token_ids))

    def free_sequence(self, seq_id: int):
        self._lib.tllm_kvbm_free_seq(self._h, seq_id)

    def block_table(self, seq_id: int, max_blocks: int) -> List[int]:
        out = np.zeros(max_blocks, np.int32)
        self._lib.tllm_kvbm_block_table(self._h, seq_id,
                                        out.ctypes.data_as(self._pi32),
                                        max_blocks)
        return out.tolist()

    def slot_mapping(self, seq_id: int, start_token: int,
                     num_tokens: int) -> List[int]:
        out = np.zeros(num_tokens, np.int32)
        rc = self._lib.tllm_kvbm_slot_mapping(
            self._h, seq_id, start_token, num_tokens,
            out.ctypes.data_as(self._pi32))
        if rc != 0:
            raise IndexError("slot_mapping past allocated blocks")
        return out.tolist()

    def stats(self) -> dict:
        out = (self._ct.c_int64 * 8)()
        self._lib.tllm_kvbm_stats(self._h, out)
        return {
            "free_blocks": int(out[0]),
            "evictable_blocks": int(out[1]),
            "reused_blocks": int(out[2]),
            "partial_reused_blocks": int(out[7]),
            "allocated_blocks": int(out[3]),
            "evicted_blocks": int(out[4]),
            "active_sequences": int(out[5]),
        }


def make_bookkeeping(num_blocks: int, block_size: int, enable_reuse: bool,
                     backend: str = "native"):
    """The host bookkeeping `backend` names: "native" builds (or loads)
    the C++ library and raises when that fails; "python" is the Python
    backend."""
    if backend == "python":
        return _PyBookkeeping(num_blocks, block_size, enable_reuse)
    if backend != "native":
        raise ValueError(f"unknown KV bookkeeping backend {backend!r}")
    from tensorrt_llm_tpu_torch.native import load_native
    return _NativeBookkeeping(load_native(), num_blocks, block_size,
                              enable_reuse)


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
        self._bk = make_bookkeeping(num_blocks, cfg.block_size,
                                    cfg.enable_block_reuse, cfg.bookkeeping)
        # (src, dst) page copies of copy-on-partial-reuse, taken by the
        # executor before the sequence's first prefill chunk
        self._partial_copies: Dict[int, List[tuple]] = {}
        # KV events (module docstring)
        self.events: collections.deque = collections.deque(maxlen=EVENT_RING)
        self._next_event_id = 0
        self._seq_chain: Dict[int, List[int]] = {}   # announced blocks
        self._seq_reused: Dict[int, int] = {}        # full blocks matched
        self._seq_salt: Dict[int, object] = {}
        # the reuse index's blocks by chain hash, and the way back
        self._block_whash: Dict[int, int] = {}
        self._whash_block: Dict[int, int] = {}
        # host tier and connector (module docstring)
        self.host_cache: "collections.OrderedDict[int, list]" = \
            collections.OrderedDict()
        self._extract_fn = None
        self._inject_fn = None
        self._seq_prio: Dict[int, int] = {}
        self._block_prio: Dict[int, int] = {}     # reuse blocks' priority
        self.num_offloaded = 0
        self.num_onboarded = 0
        self.num_connector_saves = 0
        self.num_connector_loads = 0

    @property
    def is_native(self) -> bool:
        return isinstance(self._bk, _NativeBookkeeping)

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
        cached, always fewer than the prompt so that at least one token is
        recomputed to produce logits: whole blocks on the device, then
        whole blocks onboarded from the host tier or the connector, then
        under `enable_partial_reuse` (only past a device match) the head of
        one more block.  Its page copy, if any, waits in
        `drain_partial_copies`."""
        matched = self._bk.add_sequence(seq_id, token_ids, cache_salt)
        self._seq_salt[seq_id] = cache_salt
        self._seq_chain[seq_id] = []
        self._seq_reused[seq_id] = matched // self.block_size
        matched_dev = matched
        if self.host_tier_enabled and (self.host_cache
                                       or self.cfg.kv_connector is not None):
            matched = self._onboard(seq_id, token_ids, cache_salt, matched)
        if self.cfg.enable_partial_reuse and self.cfg.enable_block_reuse \
                and matched == matched_dev:
            k, src, dst = self._bk.try_partial_match(
                seq_id, token_ids, self.cfg.copy_on_partial_reuse)
            if k:
                matched += k
                if dst != src:
                    self._partial_copies.setdefault(seq_id, []).append(
                        (src, dst))
                else:   # adopted in place: it left the reuse index
                    self._forget_hash(src)
                # the fresh block may have been evicted to serve this: its
                # content is offloaded before the page copy overwrites it
                self._drain_evictions()
        return matched

    # ---- host tier and connector ------------------------------------------
    @property
    def host_tier_enabled(self) -> bool:
        return ((self.cfg.host_cache_blocks > 0
                 or self.cfg.kv_connector is not None)
                and self.cfg.enable_block_reuse
                and self._extract_fn is not None)

    def attach_block_io(self, extract_fn, inject_fn):
        """The engine's page copies (`extract_kv_blocks(block_ids)`,
        `inject_kv_blocks(block_ids, layers)`), which the host tier and the
        connector move blocks with."""
        self._extract_fn = extract_fn
        self._inject_fn = inject_fn

    def _chain_to(self, token_ids, salt, n_blocks: int) -> int:
        parent, bs = 0, self.block_size
        for b in range(n_blocks):
            parent = _whash(parent, tuple(token_ids[b * bs:(b + 1) * bs]),
                            salt)
        return parent

    def _connector_call(self, what: str, *args):
        """A connector method; an exception is logged and taken as a miss
        (None)."""
        try:
            return getattr(self.cfg.kv_connector, what)(*args)
        except Exception as e:  # noqa: BLE001 -- never ends the loop
            logger.warning("kv connector %s failed: %s", what, e)
            return None

    def _onboard(self, seq_id: int, token_ids, salt, matched: int) -> int:
        """Extend a device match with whole blocks from the host cache or
        the connector, each allocated and injected; returns the tokens now
        matched.  Stops at the first miss or when the pool is exhausted."""
        bs = self.block_size
        conn = self.cfg.kv_connector
        b = matched // bs
        parent = self._chain_to(token_ids, salt, b)
        while b < (len(token_ids) - 1) // bs:
            wh = _whash(parent, tuple(token_ids[b * bs:(b + 1) * bs]), salt)
            payload = self.host_cache.get(wh)
            if payload is None and conn is not None:
                payload = self._connector_call("load", wh)
                if payload is not None:
                    self.num_connector_loads += 1
            if payload is None:
                break
            try:
                self._bk.grow_sequence(seq_id, (b + 1) * bs)
            except RuntimeError:
                break          # the device pool is exhausted
            # what that allocation evicted leaves before the inject writes
            self._drain_evictions()
            bid = self._bk.block_table(seq_id, b + 1)[b]
            self._inject_fn([bid], payload)
            if wh in self.host_cache:
                self.host_cache.move_to_end(wh)
            self.num_onboarded += 1
            parent = wh
            b += 1
            matched = b * bs
        return matched

    def _offload(self, bid: int, wh: int, prio: int) -> bool:
        """Move an evicted block's content to the host cache and the
        connector; returns whether the content is still matchable there."""
        if not self.host_tier_enabled:
            return False
        conn = self.cfg.kv_connector
        min_p = self.cfg.secondary_offload_min_priority
        host_ok = self.cfg.host_cache_blocks > 0 and (
            min_p is None or prio >= min_p)
        if host_ok and wh in self.host_cache:
            self.host_cache.move_to_end(wh)
            return True
        if not host_ok and conn is None:
            return False
        payload = self._extract_fn([bid])
        saved = False
        if conn is not None:
            try:
                conn.save(wh, payload)
                self.num_connector_saves += 1
                saved = True
            except Exception as e:  # noqa: BLE001 -- never ends the loop
                logger.warning("kv connector save failed: %s", e)
        if host_ok:
            self.host_cache[wh] = payload
            self.num_offloaded += 1
            while len(self.host_cache) > self.cfg.host_cache_blocks:
                old, _ = self.host_cache.popitem(last=False)
                # the connector keeps everything; a device copy keeps it too
                if conn is None and old not in self._whash_block:
                    self._event({"type": "removed", "block_hash": old})
        return host_ok or saved

    def drain_partial_copies(self, seq_id: int) -> List[tuple]:
        """(src, dst) block pairs whose pages the engine must copy before
        the sequence's first prefill chunk (copy-on-partial-reuse)."""
        return self._partial_copies.pop(seq_id, [])

    def set_seq_priority(self, seq_id: int, priority: int):
        """Retention priority of the blocks this sequence stores for reuse
        from now on (lower evicts first; default 35)."""
        self._bk.set_seq_priority(seq_id, priority)
        self._seq_prio[seq_id] = int(priority)

    def grow_sequence(self, seq_id: int, new_total_tokens: int):
        self._bk.grow_sequence(seq_id, new_total_tokens)
        self._drain_evictions()

    def seal_full_blocks(self, seq_id: int, token_ids: List[int]):
        """Publish completed prompt blocks into the reuse index, with a
        ``stored`` event for each full block of the sequence not yet
        announced (as the JAX package does, blocks it reused included)."""
        self._bk.seal_full_blocks(seq_id, token_ids)
        if not self.cfg.enable_block_reuse:
            return
        bs = self.block_size
        n_full = len(token_ids) // bs
        chain = self._seq_chain[seq_id]
        if len(chain) >= n_full:
            return
        table = self._bk.block_table(seq_id, n_full)
        parent = chain[-1] if chain else 0
        for b in range(len(chain), n_full):
            h = _whash(parent, tuple(token_ids[b * bs:(b + 1) * bs]),
                       self._seq_salt[seq_id])
            self._event({"type": "stored", "block_hash": h,
                         "parent_hash": parent})
            # a reused block is the index's already; else the first
            # writer of a content caches it
            if b >= self._seq_reused[seq_id] and h not in self._whash_block:
                self._block_whash[table[b]] = h
                self._whash_block[h] = table[b]
                self._block_prio[table[b]] = self._seq_prio.get(
                    seq_id, DEFAULT_RETENTION_PRIORITY)
            chain.append(h)
            parent = h

    def free_sequence(self, seq_id: int):
        self._partial_copies.pop(seq_id, None)
        self._seq_chain.pop(seq_id, None)
        self._seq_reused.pop(seq_id, None)
        self._seq_salt.pop(seq_id, None)
        self._seq_prio.pop(seq_id, None)
        self._bk.free_sequence(seq_id)

    def drop_cached_blocks(self):
        """Forget every reusable block of the device and the host cache
        (their KV came from other weights), with a ``removed`` event for
        each.  A connector is the caller's store and is not cleared."""
        self._drain_evictions()
        self._bk.drop_cached_blocks()
        for h in set(self._whash_block) | set(self.host_cache):
            self._event({"type": "removed", "block_hash": h})
        self._whash_block.clear()
        self._block_whash.clear()
        self._block_prio.clear()
        self.host_cache.clear()

    # ---- KV events -------------------------------------------------------
    def _event(self, ev: dict):
        self.events.append({"id": self._next_event_id, **ev})
        self._next_event_id += 1

    def _drain_evictions(self):
        """Offload each block the backend evicted from the reuse index
        (`_offload`), before any new device write; a ``removed`` event for
        each whose content left every tier (no other device block carries
        its hash: the first writer of a content is the only one that
        caches it)."""
        for bid in self._bk.drain_evictions():
            prio = self._block_prio.pop(bid, DEFAULT_RETENTION_PRIORITY)
            h = self._block_whash.pop(bid, None)
            if h is None:
                continue
            del self._whash_block[h]
            if not self._offload(bid, h, prio):
                self._event({"type": "removed", "block_hash": h})

    def _forget_hash(self, bid: int):
        """A block left the reuse index in place (adopted by a sequence)."""
        self._block_prio.pop(bid, None)
        h = self._block_whash.pop(bid, None)
        if h is not None:
            del self._whash_block[h]
            if h not in self.host_cache and not (
                    self.host_tier_enabled
                    and self.cfg.kv_connector is not None):
                self._event({"type": "removed", "block_hash": h})

    def get_events(self, since_id: int = 0) -> List[dict]:
        """Events with id >= since_id (the ring keeps the last
        `EVENT_RING`)."""
        return [e for e in self.events if e["id"] >= since_id]

    def event_cursor(self) -> Tuple[int, int]:
        """(next_since_id, oldest_retained_id): a client whose cursor is
        below oldest_retained_id missed events and resyncs with
        `reuse_block_hashes`."""
        oldest = self.events[0]["id"] if self.events else self._next_event_id
        return self._next_event_id, oldest

    def reuse_block_hashes(self) -> List[int]:
        """Every block chain hash matchable right now, on the device or in
        the host cache."""
        return list(self._whash_block) + [
            h for h in self.host_cache if h not in self._whash_block]

    def match_prefix(self, token_ids: List[int], cache_salt=None) -> int:
        """Cached prefix tokens of a prospective prompt (no side effects):
        whole blocks on the device, then in the host cache or the connector
        (they would onboard at admission), then, past a device match only,
        under partial reuse the head of one more."""
        matched = self._bk.match_prefix(token_ids, cache_salt)
        matched_dev = matched
        conn = self.cfg.kv_connector
        if self.host_tier_enabled and (self.host_cache or conn is not None):
            bs = self.block_size
            b = matched // bs
            parent = self._chain_to(token_ids, cache_salt, b)
            while b < (len(token_ids) - 1) // bs:
                wh = _whash(parent, tuple(token_ids[b * bs:(b + 1) * bs]),
                            cache_salt)
                if wh not in self.host_cache and not (
                        conn is not None
                        and self._connector_call("contains", wh)):
                    break
                parent = wh
                b += 1
                matched = b * bs
        if self.cfg.enable_partial_reuse and matched == matched_dev:
            matched = max(matched, self._bk.match_prefix(
                token_ids, cache_salt, partial=True))
        return matched

    def block_table(self, seq_id: int, max_blocks: int) -> List[int]:
        return self._bk.block_table(seq_id, max_blocks)

    def slot_mapping(self, seq_id: int, start_token: int,
                     num_tokens: int) -> List[int]:
        return self._bk.slot_mapping(seq_id, start_token, num_tokens)

    def stats(self) -> dict:
        s = self._bk.stats()
        s["num_blocks"] = self.num_blocks
        s["host_cached_blocks"] = len(self.host_cache)
        s["offloaded_blocks"] = self.num_offloaded
        s["onboarded_blocks"] = self.num_onboarded
        if self.cfg.kv_connector is not None:
            s["connector_saves"] = self.num_connector_saves
            s["connector_loads"] = self.num_connector_loads
        return s
