"""Model engine: assembles step inputs and runs prefill and decode steps.

Counterpart of `tensorrt_llm_tpu/runtime/model_engine.py`.  PyTorch runs
eagerly, so there are no compiled buckets: a prefill step takes exactly the
chunk's tokens and a decode step exactly the batch, with block tables as
wide as the longest sequence needs.

A decode chunk has two halves.  `dispatch_decode` is the dispatch half: the
step inputs (with `virtual_extra` positions already dispatched but not yet
applied by the executor's overlap pipeline), their uploads, the k decode
steps as a Python loop of single steps with sampling on the device between
them (the next step's input ids are the previous step's sampled tokens,
still on the device; the first step's may be the previous chunk's last
row, `prev_tokens`), and, on a CUDA device, the copy of the tokens and
logprobs to pinned host buffers with ``non_blocking=True`` and a recorded
`torch.cuda.Event`.  Nothing in it waits for the device.  The drain half is
`chunk_ready` (the event has been reached) and `chunk_result` (waits for
it and returns host arrays).  The pinned buffers are allocated once per
(k, batch size) as a ring of `host_ring` buffers (`cudaHostAlloc` stalls
the device, so never per chunk); the executor sets the ring one longer
than its pipeline is deep.  The chunk's tokens equal the JAX package's
fused `scan` mode.

`copy_kv_blocks` copies whole pages between blocks in every layer's pools
(bf16, INT8 data and scales, FP8, MLA latent and DSA indexer pools) for
copy-on-partial-reuse and beam forks, as a plain torch index copy (XLA
does it in the JAX package); FP8 pages move as their bytes (`_raw`).  `extract_kv_blocks` and `inject_kv_blocks` move the pages of
given blocks, every leaf of every layer, to host memory and back: the
transfer plane of disaggregated serving and of the host KV tier (JAX
`extract_kv_blocks` / `inject_kv_blocks`, plain XLA gathers and scatters
there too).  Extract is an `index_select` of every leaf on the engine's
stream, packed into one buffer and copied to the host at once; inject
packs the leaves into one pinned buffer (PyTorch's caching host allocator
keeps it until its copy has run), uploads it at once, then `index_copy_`s
each leaf, under `lock`, in stream order before any later step.  Inject refuses, with ValueError,
leaves that differ from the pools in count, dtype or elements per page
(`check_kv_layers`), and never casts.  A JAX payload at head dims below 128
arrives lane-packed (``[n, Hkv, BS*D//128, 128]``), row-major the same bytes
as the logical ``[n, Hkv, BS, D]``: it is taken by a reshape.  An MLA
payload is portable only from port to port (the latent row is 576 wide
here, 640 in the JAX package).

`warmup` (run by `LLM` before its executor starts, by default on a CUDA
device) tunes the W4A16 tactics (`autotune_kernels`), then runs one prefill
chunk and one decode step of a scratch sequence so that the kernel library,
library handles and the allocator are warm.  The JAX package's warmup also
compiles every bucket; eager PyTorch has nothing to compile.

Speculative decoding (JAX `prepare_verify_inputs`,
`prepare_tree_verify_inputs`, `run_with_hidden`, `run_verify_tree`): a
linear verify step is a prefill chunk of the last accepted token and the
draft, with logits at every row; a tree verify step carries the tokens not
yet in the cache (pending commits and the last token) and the tree's nodes
at their depths' positions, the nodes with pad slots (`PAD_SLOT`: their KV
never lands; the write goes to reserved page 0) and a host-built [T, T]
pair mask that routes attention to `tree_verify_attention`; its
`q_offset` is the committed prefix length.  Every step takes exactly its
tokens: no chunk is padded to a bucket, so the prefill kernel's KV length
(`q_offset` + T) never covers an unwritten row.  `run_with_hidden` and
`run_verify_tree(with_hidden=True)` also return the hidden-state tap at
the logit rows (`DecoderModelForCausalLM.forward`'s `capture`).

Every step builder fills `StepInputs.lora_ids`, each row's multi-LoRA
slot (its request's `lora_slot`, 0 for the base model; JAX
`model_engine.py:1324-1354, 1427, 1567, 1759, 1803`); a step whose rows
are all base rows passes no ids, so the layers skip the adapters'
products.  `prepare_decode_inputs` takes beam sequences, duck-typed
requests of `runtime/beam_search.py`.

VSWA rings (JAX `model_engine.py:120-143`): when the model has sliding
layers (a window, or Llama4's chunk size) and the KV config keeps
`separate_window_pools`, the engine gives those layers ring pools of
``cdiv(window, BS) + 1`` blocks a sequence (the window and a page: a
prefill chunk attends before its writes land, so the ring never needs the
chunk's size), provided that is shorter than a full table.  Every step
then also carries the rings' slots and tables (`StepInputs.local_*`); a
sliding layer attends through them (`AttentionMetadata.for_sliding_layer`,
``cyclic``).  Page copies, extracts and injects take the ring blocks for
the sliding layers (``ring_pairs`` / ``ring_ids``).

Not in this slice: the chain/scan/unroll variants, CUDA graphs and
pipeline/context/data parallelism.
"""

from __future__ import annotations

import hashlib
import itertools
import sys
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from tensorrt_llm_tpu_torch.attention_backend.interface import (
    AttentionMetadata)
from tensorrt_llm_tpu_torch.llmapi.disagg_params import leaf_torch, leaves
from tensorrt_llm_tpu_torch.llmapi.sampling_params import SamplingParams
from tensorrt_llm_tpu_torch.runtime.kv_cache_manager import KVCacheManager
from tensorrt_llm_tpu_torch.runtime.request import LlmRequest
from tensorrt_llm_tpu_torch.runtime.sampler import SamplingState, sample_tokens
from tensorrt_llm_tpu_torch.utils import (
    cdiv, logger, resolve_device, upload)

# weight bytes a tuning ring holds: past the 50 MB L2 of an H100
_ROTATE_BYTES = 128 << 20
# the slot of a row whose KV must not land (tree nodes): past every pool,
# so the write goes to reserved page 0
PAD_SLOT = 1 << 30


_ALIGN = 16    # byte alignment of each tensor in a packed buffer


def _packed(tensors, pin: bool = False) -> torch.Tensor:
    """The tensors' bytes in one uint8 buffer on their device (pinned host
    memory with `pin`), each at a 16-byte aligned offset."""
    sizes = [t.numel() * t.element_size() for t in tensors]
    total = sum(-(-n // _ALIGN) * _ALIGN for n in sizes)
    buf = torch.empty(total, dtype=torch.uint8, device=tensors[0].device,
                      pin_memory=pin)
    off = 0
    for t, n in zip(tensors, sizes):
        buf[off:off + n].copy_(t.contiguous().reshape(-1).view(torch.uint8))
        off += -(-n // _ALIGN) * _ALIGN
    return buf


def _unpacked(buf: torch.Tensor, like) -> List[torch.Tensor]:
    """Views of `_packed`'s buffer with the dtypes and shapes of `like`."""
    out, off = [], 0
    for t in like:
        n = t.numel() * t.element_size()
        out.append(buf[off:off + n].view(t.dtype).reshape(t.shape))
        off += -(-n // _ALIGN) * _ALIGN
    return out


def _raw(t: torch.Tensor) -> torch.Tensor:
    """A pool or page leaf as the dtype its index copies run in: float8 as
    its bytes (PyTorch has no float8 `index_copy_`)."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def _slots(req, n: int) -> np.ndarray:
    """`n` rows of the request's multi-LoRA slot (0 without one)."""
    return np.full(n, getattr(req, "lora_slot", 0), np.int64)


def _like(tree, it):
    """`tree`'s tuple structure over the next tensors of `it`."""
    if isinstance(tree, (tuple, list)):
        return tuple(_like(t, it) for t in tree)
    return next(it)


@dataclass
class StepInputs:
    """Host-assembled step inputs (numpy)."""

    input_ids: np.ndarray
    positions: np.ndarray
    slot_mapping: np.ndarray
    block_tables: np.ndarray
    kv_lens: np.ndarray
    logit_indices: np.ndarray
    q_offset: int = 0
    # [T] multi-LoRA slot of each row (the request's `lora_slot`)
    lora_ids: Optional[np.ndarray] = None
    # VSWA: the sliding layers' ring slots [T] and ring tables [B, R]
    local_slot_mapping: Optional[np.ndarray] = None
    local_block_tables: Optional[np.ndarray] = None


@dataclass
class DecodeChunk:
    """One dispatched decode chunk: its requests (row order), k, the device
    tokens and logprobs ``[k, B]`` and, on a CUDA device, their pinned host
    copies and the event recorded after the copies."""

    reqs: list
    k: int
    toks: torch.Tensor
    logps: torch.Tensor
    host: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    event: Optional["torch.cuda.Event"] = None


def ring_plan(cfg, block_size: int, max_seq_len: int,
              separate_window_pools: bool = True):
    """``(window, ring_blocks, sliding layers)`` where the JAX engine gives
    the sliding layers VSWA ring pools (module docstring), else None."""
    window = (getattr(cfg, "sliding_window", None)
              or getattr(cfg, "attention_chunk_size", None))
    if not window or not separate_window_pools \
            or getattr(cfg, "is_mla", False):
        return None
    sliding = [i for i in range(cfg.num_layers) if cfg.is_sliding_layer(i)]
    ring_blocks = cdiv(window, block_size) + 1
    if not sliding or ring_blocks >= cdiv(max_seq_len, block_size):
        return None
    return window, ring_blocks, sliding


def default_ring_slots(max_batch_size: int) -> int:
    """Ring slots without a memory bound: four per batch row, at least 32,
    at most the JAX slot manager's 256."""
    return min(256, max(max_batch_size * 4, 32))


def configure_rings(cfg, kv_manager: KVCacheManager, max_seq_len: int,
                    max_batch_size: int,
                    ring_slots: Optional[int] = None) -> bool:
    """Give the sliding layers VSWA ring pools where the JAX engine does
    (`ring_plan`); returns whether it did.  `ring_slots` (`LLM` bounds it
    by device memory) defaults to `default_ring_slots`."""
    plan = ring_plan(cfg, kv_manager.block_size, max_seq_len,
                     kv_manager.cfg.separate_window_pools)
    if plan is None:
        return False
    window, ring_blocks, sliding = plan
    kv_manager.configure_vswa(
        window, ring_blocks, ring_slots or default_ring_slots(max_batch_size),
        sliding)
    return True


class ModelEngine:
    def __init__(self, model, kv_manager: KVCacheManager, device="cuda",
                 max_seq_len: Optional[int] = None,
                 max_batch_size: int = 64,
                 ring_slots: Optional[int] = None):
        self.model = model
        self.kv_manager = kv_manager
        self.device = resolve_device(device)
        self.vswa = (max_seq_len is not None and configure_rings(
            model.cfg, kv_manager, max_seq_len, max_batch_size, ring_slots))
        self.kv_caches = kv_manager.allocate_pools()
        self.lock = threading.Lock()
        self.host_ring = 2          # pinned buffers per (k, batch size)
        self._rings = {}            # (k, B) -> [next slot, [(toks, logps)]]

    # ------------------------------------------------------------ inputs ---
    def prepare_prefill_inputs(self, req, chunk: int,
                               all_rows: bool = False) -> StepInputs:
        """One context chunk of one request, returning the last row's
        logits, or every row's with `all_rows` (prompt logprobs and
        context logits)."""
        kv = self.kv_manager
        start = req.context_position
        end = start + chunk
        return self._with_rings(StepInputs(
            input_ids=np.asarray(req.prompt_token_ids[start:end], np.int64),
            positions=np.arange(start, end, dtype=np.int64),
            slot_mapping=np.asarray(
                kv.slot_mapping(req.request_id, start, chunk), np.int64),
            block_tables=np.asarray(
                [kv.block_table(req.request_id, kv.blocks_needed(end))],
                np.int32),
            kv_lens=np.asarray([end], np.int32),
            logit_indices=(np.arange(chunk, dtype=np.int64) if all_rows
                           else np.asarray([chunk - 1], np.int64)),
            q_offset=start, lora_ids=_slots(req, chunk)), [req], start)

    def _with_rings(self, inputs: StepInputs, reqs, start=None,
                    write_mask=None) -> StepInputs:
        """Add the VSWA ring slots and tables (JAX `model_engine.py:1329-
        1375, 1534-1537, 1744-1752`): a chunk of one request from `start`
        (only the last write of one ring offset lands; tree rows outside
        `write_mask` take `PAD_SLOT`), or one decode row a request at
        `inputs.positions`."""
        if not self.vswa:
            return inputs
        kv = self.kv_manager
        if start is not None:
            rid = reqs[0].request_id
            T = len(inputs.positions)
            if write_mask is None:
                ls = kv.local_slot_mapping(rid, start, T, PAD_SLOT)
            else:
                ls = [kv.local_slot_mapping(rid, int(p), 1, PAD_SLOT)[0]
                      if w else PAD_SLOT
                      for p, w in zip(inputs.positions, write_mask)]
        else:
            ls = [kv.local_slot_mapping(r.request_id, int(p), 1, PAD_SLOT)[0]
                  for r, p in zip(reqs, inputs.positions)]
        inputs.local_slot_mapping = np.asarray(ls, np.int64)
        inputs.local_block_tables = np.asarray(
            [kv.local_block_table(r.request_id) for r in reqs], np.int32)
        return inputs

    def prepare_decode_inputs(self, reqs, extra_tokens: int = 0,
                              virtual_extra: Optional[Sequence[int]] = None
                              ) -> StepInputs:
        """One new token per request; `extra_tokens` widens the tables for
        k-step decode (positions up to num_tokens + extra - 1).
        `virtual_extra` (overlap decode): per request, tokens already
        dispatched but not yet applied -- positions and lengths advance as
        if they had landed, and the input ids are placeholders the caller
        replaces with the previous chunk's tokens on the device."""
        kv = self.kv_manager
        ve = np.asarray(virtual_extra if virtual_extra is not None
                        else [0] * len(reqs), np.int64)
        MB = max(kv.blocks_needed(r.num_tokens + int(v) + extra_tokens)
                 for r, v in zip(reqs, ve))
        pos = np.asarray([r.num_tokens - 1 for r in reqs], np.int64) + ve
        return self._with_rings(StepInputs(
            input_ids=np.asarray([r.all_token_ids[-1] for r in reqs],
                                 np.int64),
            positions=pos,
            slot_mapping=np.asarray(
                [kv.slot_mapping(r.request_id, int(p), 1)[0]
                 for r, p in zip(reqs, pos)], np.int64),
            block_tables=np.asarray(
                [kv.block_table(r.request_id, MB) for r in reqs], np.int32),
            kv_lens=(pos + 1).astype(np.int32),
            logit_indices=np.arange(len(reqs), dtype=np.int64),
            lora_ids=np.asarray([getattr(r, "lora_slot", 0) for r in reqs],
                                np.int64)), reqs)

    def prepare_verify_inputs(self, req, draft_tokens) -> StepInputs:
        """A linear verify step: the last accepted token and the draft at
        positions num_tokens - 1 .., logits at every row.  The request's
        blocks must cover num_tokens + len(draft) - 1 positions."""
        kv = self.kv_manager
        toks = [req.all_token_ids[-1]] + list(draft_tokens)
        start, chunk = req.num_tokens - 1, len(toks)
        end = start + chunk
        return self._with_rings(StepInputs(
            input_ids=np.asarray(toks, np.int64),
            positions=np.arange(start, end, dtype=np.int64),
            slot_mapping=np.asarray(
                kv.slot_mapping(req.request_id, start, chunk), np.int64),
            block_tables=np.asarray(
                [kv.block_table(req.request_id, kv.blocks_needed(end))],
                np.int32),
            kv_lens=np.asarray([end], np.int32),
            logit_indices=np.arange(chunk, dtype=np.int64),
            q_offset=start, lora_ids=_slots(req, chunk)), [req], start)

    def prepare_tree_verify_inputs(self, req, tokens, positions,
                                   write_mask) -> StepInputs:
        """A tree verify step: `tokens[i]` at `positions[i]`; rows whose
        `write_mask` is False get `PAD_SLOT`.  The committed prefix is
        positions[0] tokens long (kv_lens, q_offset); the block table
        covers it."""
        kv = self.kv_manager
        rid = req.request_id
        prefix = int(positions[0])
        slots = np.full(len(tokens), PAD_SLOT, np.int64)
        for i, w in enumerate(write_mask):
            if w:
                slots[i] = kv.slot_mapping(rid, int(positions[i]), 1)[0]
        return self._with_rings(StepInputs(
            input_ids=np.asarray(tokens, np.int64),
            positions=np.asarray(positions, np.int64),
            slot_mapping=slots,
            block_tables=np.asarray(
                [kv.block_table(rid, max(1, kv.blocks_needed(prefix)))],
                np.int32),
            kv_lens=np.asarray([prefix], np.int32),
            logit_indices=np.arange(len(tokens), dtype=np.int64),
            q_offset=prefix, lora_ids=_slots(req, len(tokens))), [req],
            prefix, write_mask=list(write_mask))

    def _tensors(self, inputs: StepInputs, mode: str):
        dev = self.device
        meta = AttentionMetadata(
            positions=upload(inputs.positions, dev),
            slot_mapping=upload(inputs.slot_mapping, dev),
            block_tables=upload(inputs.block_tables, dev),
            kv_lens=upload(inputs.kv_lens, dev),
            q_offset=int(inputs.q_offset), mode=mode)
        if inputs.local_block_tables is not None:
            meta.local_slot_mapping = upload(inputs.local_slot_mapping, dev)
            meta.local_block_tables = upload(inputs.local_block_tables, dev)
        li = inputs.lora_ids
        if li is not None and li.any():
            # a step of base rows alone skips the adapters' products
            meta.lora_ids = upload(np.asarray(li, np.int64), dev)
        return (upload(inputs.input_ids, dev), meta,
                upload(inputs.logit_indices, dev))

    # -------------------------------------------------------------- steps ---
    @torch.no_grad()
    def run_prefill(self, inputs: StepInputs) -> torch.Tensor:
        """One prefill chunk; returns the logits (f32) of the rows
        `inputs.logit_indices` names: [1, V], or [chunk, V]."""
        ids, meta, rows = self._tensors(inputs, "prefill")
        with self.lock:
            return self.model(ids, self.kv_caches, meta, rows)

    @torch.no_grad()
    def run_with_hidden(self, mode: str, inputs: StepInputs,
                        capture: str = "final"):
        """A prefill or decode step returning (logits, hidden) at the logit
        rows: the tap one-model drafters read."""
        ids, meta, rows = self._tensors(inputs, mode)
        with self.lock:
            return self.model(ids, self.kv_caches, meta, rows,
                              return_hidden=True, capture=capture)

    @torch.no_grad()
    def run_verify_tree(self, inputs: StepInputs, pair_mask: np.ndarray,
                        with_hidden: bool = False, capture: str = "final"):
        """A tree verify step under the [T, T] `pair_mask`: logits at every
        row (and the hidden tap with `with_hidden`)."""
        ids, meta, rows = self._tensors(inputs, "prefill")
        meta.pair_mask = upload(np.asarray(pair_mask, bool), self.device)
        with self.lock:
            return self.model(ids, self.kv_caches, meta, rows,
                              return_hidden=with_hidden, capture=capture)

    @torch.no_grad()
    def run_decode(self, inputs: StepInputs) -> torch.Tensor:
        """One decode step; returns logits [B, V] (f32): the host logits
        path's step (the executor samples on them)."""
        ids, meta, rows = self._tensors(inputs, "decode")
        with self.lock:
            return self.model(ids, self.kv_caches, meta, rows)

    @torch.no_grad()
    def dispatch_decode(self, reqs, k: int,
                        virtual_extra: Optional[Sequence[int]] = None,
                        prev_tokens: Optional[torch.Tensor] = None
                        ) -> DecodeChunk:
        """The dispatch half of a k-step decode chunk (module docstring):
        every request's blocks must already cover its positions up to
        num_tokens + virtual + k - 1.  Sampled rows draw their noise at
        their output positions (`sample_tokens`).  `prev_tokens` [B]
        (device) replaces the input ids."""
        kv = self.kv_manager
        virt = list(virtual_extra) if virtual_extra is not None \
            else [0] * len(reqs)
        inputs = self.prepare_decode_inputs(reqs, extra_tokens=k - 1,
                                            virtual_extra=virt)
        slot_table = np.stack([
            np.asarray(kv.slot_mapping(r.request_id, r.num_tokens + v - 1,
                                       k), np.int64)
            for r, v in zip(reqs, virt)], axis=1)
        params = [r.sampling_params for r in reqs]
        rids = [r.request_id for r in reqs]
        out_pos = [r.num_output_tokens + v for r, v in zip(reqs, virt)]
        ids, meta, rows = self._tensors(inputs, "decode")
        if prev_tokens is not None:
            ids = prev_tokens.to(torch.int64)
        slots = upload(slot_table, self.device)
        ring_slots = None
        if self.vswa:
            ring_slots = upload(np.stack([
                np.asarray(kv.local_slot_mapping(
                    r.request_id, r.num_tokens + v - 1, k, PAD_SLOT,
                    dedup=False), np.int64)
                for r, v in zip(reqs, virt)], axis=1), self.device)
        state = SamplingState.build(params, self.device)
        toks, logps = [], []
        with self.lock:
            for j in range(k):
                meta.slot_mapping = slots[j]
                if ring_slots is not None:
                    meta.local_slot_mapping = ring_slots[j]
                logits = self.model(ids, self.kv_caches, meta, rows)
                tok, lp = sample_tokens(logits, params, rids, out_pos,
                                        step_offset=j, state=state)
                toks.append(tok)
                logps.append(lp)
                ids = tok.to(torch.int64)
                meta.positions = meta.positions + 1
                meta.kv_lens = meta.kv_lens + 1
        chunk = DecodeChunk(list(reqs), k, torch.stack(toks),
                            torch.stack(logps))
        if self.device.type == "cuda":
            chunk.host = self._host_buffers(k, len(reqs))
            chunk.host[0].copy_(chunk.toks, non_blocking=True)
            chunk.host[1].copy_(chunk.logps, non_blocking=True)
            chunk.event = torch.cuda.Event()
            chunk.event.record()
        return chunk

    def _host_buffers(self, k: int, B: int):
        """The next pinned (tokens, logprobs) pair of the (k, B) ring."""
        ring = self._rings.get((k, B))
        if ring is None or len(ring[1]) != self.host_ring:
            ring = self._rings[(k, B)] = [0, [
                (torch.empty((k, B), dtype=torch.int32, pin_memory=True),
                 torch.empty((k, B), dtype=torch.float32, pin_memory=True))
                for _ in range(self.host_ring)]]
        slot = ring[0]
        ring[0] = (slot + 1) % self.host_ring
        return ring[1][slot]

    @staticmethod
    def chunk_ready(chunk: DecodeChunk) -> bool:
        """Whether the chunk's results have reached the host."""
        return chunk.event is None or chunk.event.query()

    @staticmethod
    def chunk_result(chunk: DecodeChunk) -> Tuple[np.ndarray, np.ndarray]:
        """The chunk's (tokens, logprobs) ``[k, B]`` on the host, waiting
        for its event if it has not been reached."""
        if chunk.event is None:
            return chunk.toks.numpy(), chunk.logps.numpy()
        chunk.event.synchronize()
        return chunk.host[0].numpy(), chunk.host[1].numpy()

    def _layer_ids(self, ids, ring_ids):
        """Per layer, the block ids a page operation takes: `ring_ids` for
        the sliding layers under VSWA rings (when given), else `ids`."""
        sliding = self.kv_manager.sliding_layers if self.vswa else set()
        return [ring_ids if (i in sliding and ring_ids is not None) else ids
                for i in range(len(self.kv_caches))]

    @torch.no_grad()
    def copy_kv_blocks(self, pairs: Sequence[Tuple[int, int]],
                       ring_pairs: Sequence[Tuple[int, int]] = ()) -> None:
        """Copy the pages of blocks ``src -> dst`` for every (src, dst) pair
        in every pool of every layer (`ring_pairs` in the sliding layers'
        ring pools), in stream order before any later step that reads
        them."""
        if not pairs and not ring_pairs:
            return

        def dev_pairs(ps):
            if not ps:
                return None
            idx = np.asarray(ps, np.int64)
            return (upload(np.ascontiguousarray(idx[:, 0]), self.device),
                    upload(np.ascontiguousarray(idx[:, 1]), self.device))

        main = dev_pairs(pairs)
        per_layer = (self._layer_ids(main, dev_pairs(ring_pairs))
                     if ring_pairs else [main] * len(self.kv_caches))
        with self.lock:
            for layer, sd in zip(self.kv_caches, per_layer):
                if sd is None:
                    continue
                for pool in leaves(layer):
                    raw = _raw(pool)
                    raw.index_copy_(0, sd[1], raw.index_select(0, sd[0]))

    @torch.no_grad()
    def extract_kv_blocks(self, block_ids: Sequence[int],
                          ring_ids: Optional[Sequence[int]] = None) -> list:
        """The pages of `block_ids` (in the sliding layers' ring pools, of
        `ring_ids`: JAX `extract_kv_blocks`; ring offsets follow positions,
        so they line up on any receiver with the same ring size) in host
        memory: per layer, the layer's pools' structure with each leaf
        ``[n, ...page dims]`` on the CPU.  The leaves are gathered into one
        device buffer and copied to the host at once (one wait, not one a
        leaf)."""
        idx = upload(np.asarray(block_ids, np.int64), self.device)
        ridx = (None if ring_ids is None else
                upload(np.asarray(ring_ids, np.int64), self.device))
        with self.lock:
            pages = [_raw(pool).index_select(0, ix).view(pool.dtype)
                     for layer, ix in zip(self.kv_caches,
                                          self._layer_ids(idx, ridx))
                     for pool in leaves(layer)]
        flat = _packed(pages).cpu()
        it = iter(_unpacked(flat, pages))
        return [_like(layer, it) for layer in self.kv_caches]

    def check_kv_layers(self, layers: list, n: Optional[int] = None,
                        ring_n: Optional[int] = None) -> List[torch.Tensor]:
        """Every leaf of transferred `layers` (torch or numpy), checked
        against the pools and shaped as their pages, in pool order: the
        same number of layers and leaves, the same dtype and the same
        elements per page (`n` pages when given; `ring_n` in the sliding
        layers' ring pools).  Raises ValueError otherwise; never casts."""
        got_layers = [[leaf_torch(h) for h in leaves(layer)]
                      for layer in layers]
        if len(layers) != len(self.kv_caches) or \
                sum(map(len, got_layers)) != len(list(leaves(self.kv_caches))):
            raise ValueError(
                f"KV payload has {len(layers)} layers / "
                f"{sum(map(len, got_layers))} leaves; the pools have "
                f"{len(self.kv_caches)} / {len(list(leaves(self.kv_caches)))}")
        out = []
        i = 0
        for layer, got, want in zip(self.kv_caches, got_layers,
                                    self._layer_ids(n, ring_n)):
            pools = list(leaves(layer))
            if len(got) != len(pools):
                raise ValueError(f"KV payload layer has {len(got)} leaves; "
                                 f"its pools have {len(pools)}")
            for c, h in zip(pools, got):
                page = c[0].numel()
                if h.dtype != c.dtype:
                    raise ValueError(f"KV payload leaf {i} is {h.dtype}, "
                                     f"the pool is {c.dtype}")
                rows = h.shape[0] if h.dim() else 0
                if rows == 0 or h.numel() != rows * page or (
                        want is not None and rows != want):
                    raise ValueError(
                        f"KV payload leaf {i} has shape {tuple(h.shape)}; "
                        f"the pool's page is {tuple(c.shape[1:])}"
                        + ("" if want is None else f", {want} pages "
                           "expected"))
                out.append(h.reshape((rows,) + tuple(c.shape[1:])))
                i += 1
        return out

    @torch.no_grad()
    def inject_kv_blocks(self, block_ids: Sequence[int], layers: list,
                         ring_ids: Optional[Sequence[int]] = None):
        """Write transferred pages (`extract_kv_blocks`' structure, or the
        flat per-layer leaves of `payload_from_bytes`, torch or numpy) into
        the blocks `block_ids` of every pool (`ring_ids` of the sliding
        layers' ring pools), after `check_kv_layers`."""
        n = len(block_ids)
        rn = None if ring_ids is None else len(ring_ids)
        host = self.check_kv_layers(layers, n, rn)
        if not n:
            return
        dev = self.device
        idx = upload(np.asarray(block_ids, np.int64), dev)
        ridx = (None if ring_ids is None
                else upload(np.asarray(ring_ids, np.int64), dev))
        if dev.type == "cuda":
            # one upload of every leaf, staged in pinned memory that the
            # caching host allocator keeps until the copy has run
            buf = _packed(host, pin=True).to(dev, non_blocking=True)
            host = _unpacked(buf, host)
        targets = [ix for layer, ix in zip(self.kv_caches,
                                           self._layer_ids(idx, ridx))
                   for _ in leaves(layer)]
        with self.lock:
            for pool, h, ix in zip(leaves(self.kv_caches), host, targets):
                _raw(pool).index_copy_(0, ix, _raw(h))

    # ------------------------------------------------------------ warmup ---
    @staticmethod
    def tactic_file() -> Path:
        """Where tuned tactics are kept: in the hashed kernel build
        directory, so kernels built from other sources never share tactics,
        under a name hashed over the Python that decides what a tactic
        means and how it is timed (the W4A16 dispatch, the tuner and this
        module), so a changed rule re-tunes instead of loading old
        winners."""
        from tensorrt_llm_tpu_torch import autotuner
        from tensorrt_llm_tpu_torch.ops import cuda_build, w4a16_gemm
        h = hashlib.sha256()
        for mod in (w4a16_gemm, autotuner, sys.modules[__name__]):
            h.update(Path(mod.__file__).read_bytes())
        return cuda_build.kernel_dir() / f"autotune-{h.hexdigest()[:16]}.json"

    def autotune_kernels(self, m_bucket: int = 16) -> None:
        """Time the W4A16 tactic candidates of every distinct weight shape
        of the model's W4A16 linears and cache the fastest (JAX
        `ModelEngine.autotune_kernels`).  Keys are ``(K, N, tiled)``; shapes
        already cached are skipped.  W4A8 linears are not tuned (their K8
        has no tactics), nor are the 8-bit ones (plain products).

        Each candidate is timed as a decode step runs it: an input of
        `m_bucket` rows (at most `GEMV_MAX_M`, the ``block_m`` that limits
        every candidate to decode-sized calls) of random values and, on the
        card, a ring of weight copies larger than the L2 (`_ROTATE_BYTES`),
        so that every call reads its weight from HBM as a forward does.  On
        a CUDA device the cache is saved to and loaded from
        `tactic_file()`."""
        from tensorrt_llm_tpu_torch.autotuner import AutoTuner, autotune
        from tensorrt_llm_tpu_torch.layers.linear import Linear
        from tensorrt_llm_tpu_torch.ops.w4a16_gemm import (
            GEMV_MAX_M, w4a16_matmul, w4a16_tactic_candidates)
        tuner = AutoTuner.get()
        path = None
        if self.device.type == "cuda":
            path = self.tactic_file()
            if path.exists() and not tuner.cache:
                tuner.load(str(path))
                logger.info("autotune cache loaded (%d tactics)",
                            len(tuner.cache))
        m = max(1, min(m_bucket, GEMV_MAX_M))
        gen = torch.Generator(device=self.device).manual_seed(0)
        n_before = len(tuner.cache)
        seen = set()
        for mod in self.model.modules():
            if not isinstance(mod, Linear) or not mod.w4a16:
                continue
            q, s, z = mod.qweight, mod.scales, mod.zeros
            tiled = q.dim() == 3
            K = q.shape[-2] * 2 if tiled else q.shape[0] * 2
            N = q.shape[0] * q.shape[2] if tiled else q.shape[1]
            key = (K, N, int(tiled))
            if key in seen or tuner.lookup("w4a16", key):
                continue
            seen.add(key)
            x = torch.randn((m, K), generator=gen, device=self.device).to(
                torch.bfloat16)
            ring = [(q, s, z)]
            if self.device.type == "cuda":
                nbytes = sum(t.numel() * t.element_size()
                             for t in (q, s, z) if t is not None)
                ring += [tuple(None if t is None else t.clone()
                               for t in (q, s, z))
                         for _ in range(-(-_ROTATE_BYTES // nbytes) - 1)]
            turn = itertools.cycle(ring)

            def run(tactic, _x=x, _turn=turn):
                wq, ws, wz = next(_turn)
                return w4a16_matmul(_x, wq, ws, wz, **tactic)

            with autotune():
                tuner.maybe_tune("w4a16", key, w4a16_tactic_candidates(
                    K, N, tiled, group=K // s.shape[0]), run, self.device)
            del ring, turn, run
        if path is not None and len(tuner.cache) > n_before:
            path.parent.mkdir(parents=True, exist_ok=True)
            tuner.save(str(path))

    @torch.no_grad()
    def warmup(self, prefill_tokens: int = 256,
               decode_batch: int = 16) -> None:
        """`autotune_kernels` at the decode batch (the scheduler's
        `max_batch_size`), then one prefill chunk of `prefill_tokens` tokens
        and one decode step of a scratch sequence, freed again.  The chunk
        takes at most half the free pool (the JAX decode warmup's cap), so
        that the decode step finds its block in any pool."""
        self.autotune_kernels(decode_batch)
        kv = self.kv_manager
        prefill_tokens = min(prefill_tokens,
                             kv.num_free_blocks * kv.block_size // 2)
        req = LlmRequest([1] * max(1, prefill_tokens),
                         SamplingParams(max_tokens=1))
        kv.add_sequence(req.request_id, req.prompt_token_ids)
        try:
            kv.grow_sequence(req.request_id, req.prompt_len)
            self.run_prefill(self.prepare_prefill_inputs(req, req.prompt_len))
            req.context_position = req.prompt_len
            req.output_token_ids.append(1)
            kv.grow_sequence(req.request_id, req.num_tokens)
            self.run_decode(self.prepare_decode_inputs([req]))
        finally:
            kv.free_sequence(req.request_id)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
