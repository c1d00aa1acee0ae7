"""One-model MTP (multi-token prediction) speculative decoding.

Counterpart of `tensorrt_llm_tpu/speculative/mtp.py` (the reference's MTP
path; DeepSeek-V3 technical report §2.2): the target's hidden state of the
previous position feeds one extra decoder block,

    x_p = eh_proj([enorm(emb(token_p)); hnorm(h_{p-1})])

(a port `DecoderLayer` at index `num_layers`, then `final_norm` and the
target's head), whose output predicts token p+1.  The block keeps a
single-layer bf16 pool (MLA: one latent pool) with the target pool's
geometry and shares the main sequence's block tables and slot mapping, so
the drafter adds no bookkeeping.  `_catch_up` runs the block over the
positions whose (hidden, token) pair is known since its last run, growing
the main sequence to cover the draft's positions; `propose` chains the
block on its own output hidden; `propose_tree` expands the top
`tree_branches[i]` children per node at level i.  Rejected drafts leave
stale block KV behind, rewritten as the accepted stream passes; the target
verification keeps the tokens exact.

Weights: `mtp_weights` (a `get_tensor` of checkpoint names, DeepSeek's
``model.layers.{num_hidden_layers}.*``), else the target checkpoint's
extra layer when `load_hf_weights` handed it over (`set_checkpoint`), else
seeded random weights (`torch.Generator` seed 7; the JAX package draws
`PRNGKey(7)`, which torch cannot replay).  Tree drafting is refused on MLA
models (`interface.refuse_mla_tree`), and MTP itself on DSA configs: the
JAX block's pool has no indexer pool, so the JAX package cannot run it.
The block's kernel launches are counted under the launch scope
``"draft"``, apart from the target's.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from tensorrt_llm_tpu_torch.attention_backend.interface import (
    AttentionMetadata)
from tensorrt_llm_tpu_torch.models.modeling_utils import dot_f32
from tensorrt_llm_tpu_torch.ops.cuda_build import launch_scope
from tensorrt_llm_tpu_torch.ops.norms import add_rms_norm, rms_norm
from tensorrt_llm_tpu_torch.speculative.interface import (
    DRAFT_SCOPE, Drafter, SpeculativeConfig, refuse_mla_tree, torch_source)
from tensorrt_llm_tpu_torch.utils import logger, upload

CATCH_UP_CHUNK = 512      # the JAX block's largest bucket: catch-up chunks


class _MtpSeq:
    __slots__ = ("next_query", "hid")

    def __init__(self):
        self.next_query = 1    # first query position not yet run
        self.hid: Dict[int, torch.Tensor] = {}   # position -> target hidden


class MTPDrafter(Drafter):
    needs_hidden = True
    hidden_capture = "final"

    def __init__(self, cfg: SpeculativeConfig, llm_args=None):
        self.cfg = cfg
        self._seqs: Dict[int, _MtpSeq] = {}
        self.engine = None
        self.checkpoint = None     # the target checkpoint's get_tensor
        # EAGLE3 reduced draft vocab: d2t[d] is the offset from draft id d
        # to its target id; None: the head scores the target vocab
        self.d2t: Optional[np.ndarray] = None
        self.params: Dict[str, torch.Tensor] = {}
        self.max_seq_len = (getattr(llm_args, "max_seq_len", 2048)
                            if llm_args else 2048)
        self.passes = 0            # block forwards run

    def set_checkpoint(self, get_tensor) -> None:
        """The target checkpoint holds an MTP layer: load it at `bind`
        unless `mtp_weights` is given."""
        self.checkpoint = get_tensor

    def _to_target(self, draft_id: int) -> int:
        if self.d2t is None:
            return int(draft_id)
        return int(draft_id + self.d2t[draft_id])

    # ---- binding -----------------------------------------------------------
    @torch.no_grad()
    def bind(self, engine, kv):
        """Build the block against the target's config and device."""
        from tensorrt_llm_tpu_torch.models.modeling_utils import DecoderLayer
        from tensorrt_llm_tpu_torch.runtime.kv_cache_manager import (
            make_pools, pool_layout)
        cfg = engine.model.cfg
        if cfg.dsa:
            raise NotImplementedError(
                "MTP on a DSA (sparse_attention) model is not supported: "
                "the draft block's pool has no indexer pool")
        if self.cfg.tree_branches:
            refuse_mla_tree(engine)
        self.engine, self.kv = engine, kv
        self.model_cfg = cfg
        dev = engine.device
        H = cfg.hidden_size
        self.layer = DecoderLayer(cfg, cfg.num_layers, dev).to(dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(7)

        def normal(shape, std):
            return torch.randn(shape, generator=gen, device=dev).mul_(std)

        ones = torch.ones(H, device=dev)
        self.params = {
            "enorm": ones, "hnorm": ones.clone(),
            "eh_proj": normal((2 * H, H), 0.5 / (2 * H) ** 0.5).to(
                torch.bfloat16),
            "final_norm": ones.clone()}
        engine.model.init_layer(self.layer, normal)
        src = self.cfg.mtp_weights or self.checkpoint
        if src is not None:
            self.load_weights(src)
        geo = dict(pool_layout(cfg), dsa_index_dim=0)
        self.pool = make_pools(1, kv.num_blocks, block_size=kv.block_size,
                               device=dev, **geo)[0]

    @torch.no_grad()
    def load_weights(self, get_tensor, layer_prefix: Optional[str] = None):
        """Load the block from checkpoint names (DeepSeek stores it as the
        extra layer ``model.layers.{num_hidden_layers}.`` with enorm, hnorm,
        eh_proj and shared_head.norm)."""
        cfg = self.model_cfg
        pre = layer_prefix or f"model.layers.{cfg.num_layers}."
        get = torch_source(get_tensor)
        if get(pre + "eh_proj.weight") is None:
            logger.warning("MTP weights not found at %s*", pre)
            return
        required = ("enorm.weight", "hnorm.weight",
                    "shared_head.norm.weight", "input_layernorm.weight",
                    "post_attention_layernorm.weight")
        missing = [pre + n for n in required if get(pre + n) is None]
        if missing:
            raise ValueError(f"partial MTP checkpoint: missing {missing}")
        t, vec = _loaders(get, self.engine.device)
        self.params.update({
            "enorm": vec(pre + "enorm.weight"),
            "hnorm": vec(pre + "hnorm.weight"),
            "eh_proj": t(pre + "eh_proj.weight").to(torch.bfloat16),
            "final_norm": vec(pre + "shared_head.norm.weight")})
        self._load_layer(get, pre, t, vec)

    def _load_layer(self, get, pre, t, vec):
        """The block's decoder layer from HF names under `pre`."""
        layer, model = self.layer, self.engine.model
        layer.input_norm.weight = vec(pre + "input_layernorm.weight")
        layer.post_attn_norm.weight = vec(pre + "post_attention_layernorm"
                                          ".weight")
        model._load_attn(layer, pre, t, vec)
        model._load_mlp(layer, get, pre, t, vec)

    # ---- the block's forward --------------------------------------------------
    @torch.no_grad()
    def _run_logits(self, hiddens: torch.Tensor, tokens, pos0: int, rid):
        """One block pass over query positions pos0 .. pos0 + m - 1 with
        hiddens [m, width]; returns (logits [V] f32, hidden_out [1, H])."""
        cfg, model, dev = self.model_cfg, self.engine.model, \
            self.engine.device
        kv = self.kv
        m = len(tokens)
        ids = upload(np.asarray(tokens, np.int64), dev)
        emb = model.embedding(ids)
        hh = hiddens.to(dev).to(emb.dtype)
        if hh.shape[-1] != cfg.hidden_size:
            # EAGLE3: fc fuses the 3H capture
            hh = dot_f32(hh, self.params["fc"]).to(emb.dtype)
        eps = cfg.rms_eps
        x = dot_f32(torch.cat([rms_norm(emb, self.params["enorm"], eps),
                               rms_norm(hh, self.params["hnorm"], eps)], -1),
                    self.params["eh_proj"]).to(emb.dtype)
        end = pos0 + m
        meta = AttentionMetadata(
            positions=torch.arange(pos0, end, device=dev),
            slot_mapping=upload(np.asarray(kv.slot_mapping(rid, pos0, m),
                                           np.int64), dev),
            block_tables=upload(np.asarray(
                [kv.block_table(rid, kv.blocks_needed(end))], np.int32), dev),
            kv_lens=upload(np.asarray([end], np.int32), dev),
            q_offset=pos0, mode="prefill")
        with launch_scope(DRAFT_SCOPE):
            out, residual = self.layer(
                x, None, (model.rope_cos, model.rope_sin), self.pool, meta)
        self.passes += 1
        hfin, _ = add_rms_norm(out, residual, self.params["final_norm"], eps)
        h_last = hfin[m - 1:m]
        if "draft_head" in self.params:
            logits = dot_f32(h_last, self.params["draft_head"])
        else:
            logits = model.logits(h_last)
        return logits[0], h_last

    def _run(self, hidden, token, pos, rid):
        logits, h = self._run_logits(hidden, [token], pos, rid)
        return self._to_target(int(torch.argmax(logits))), h

    # ---- executor hooks ---------------------------------------------------------
    def on_hidden(self, request, start_pos: int, hiddens):
        seq = self._seqs.setdefault(request.request_id, _MtpSeq())
        for j in range(hiddens.shape[0]):
            seq.hid[start_pos + j] = hiddens[j]

    def _catch_up(self, request):
        """Run the block over the contiguous run of query positions ending
        at n-1 whose pair (h_{p-1}, t_p) is known; returns (n, root logits,
        root hidden) or None.  A hidden gap below the run (rows a prefix
        reuse skipped) leaves stale block KV: acceptance, not
        correctness."""
        if self.engine is None:
            return None
        rid = request.request_id
        seq = self._seqs.get(rid)
        if seq is None or not seq.hid:
            return None
        toks = request.all_token_ids
        n = len(toks)
        # hiddens below any possible use go first (the run reads
        # hid[p-1] for p >= max(next_query, 1) and probes one below), and
        # at most ~2 chunks of them are kept
        floor = max(max(seq.next_query, 1) - 2, n - 2 * CATCH_UP_CHUNK)
        if floor > 0:
            seq.hid = {p: v for p, v in seq.hid.items() if p >= floor}
        if n < 2 or (n - 2) not in seq.hid:
            return None
        lo = n - 1
        while lo > max(seq.next_query, 1) and (lo - 2) in seq.hid:
            lo -= 1
        queries = list(range(lo, n))
        k = self.cfg.max_draft_len
        if self.cfg.tree_branches:
            # tree expansion writes block KV one position per level
            k = max(k, len(self.cfg.tree_branches))
        need = n + k - 1
        if self.kv.blocks_needed(need) - self.kv.num_seq_blocks(rid) \
                > self.kv.num_free_blocks:
            return None
        self.kv.grow_sequence(rid, need)
        logits = h_out = None
        for i in range(0, len(queries), CATCH_UP_CHUNK):
            qs = queries[i:i + CATCH_UP_CHUNK]
            logits, h_out = self._run_logits(
                torch.stack([seq.hid[p - 1] for p in qs]),
                [toks[p] for p in qs], qs[0], rid)
        seq.next_query = n
        # the chain seeds from the block's own outputs: keep the last
        seq.hid = {p: v for p, v in seq.hid.items() if p >= n - 2}
        return n, logits, h_out

    def propose(self, request) -> List[int]:
        got = self._catch_up(request)
        if got is None:
            return []
        n, logits, h_out = got
        draft = [self._to_target(int(torch.argmax(logits)))]
        pos = n
        while len(draft) < self.cfg.max_draft_len \
                and pos < self.max_seq_len - 1:
            tok, h_out = self._run(h_out, draft[-1], pos,
                                   request.request_id)
            draft.append(tok)
            pos += 1
        return draft

    def propose_tree(self, request):
        """An EAGLE-style static tree: the top `tree_branches[i]` children
        of every node at level i; siblings overwrite each other's block KV
        (acceptance noise only)."""
        branches = self.cfg.tree_branches
        if not branches:
            return None
        got = self._catch_up(request)
        if got is None:
            return None
        n, logits, h_root = got
        rid = request.request_id
        tokens: List[int] = []
        parents: List[int] = []
        frontier = [(-1, logits, h_root)]
        pos = n
        for level, b in enumerate(branches):
            nxt = []
            for pnode, lg, h in frontier:
                order = np.argsort(lg.cpu().numpy())[::-1][:max(int(b), 1)]
                for t in order:
                    tt = self._to_target(int(t))
                    tokens.append(tt)
                    parents.append(pnode)
                    if level + 1 < len(branches) \
                            and pos < self.max_seq_len - 1:
                        lg2, h2 = self._run_logits(h, [tt], pos, rid)
                        nxt.append((len(tokens) - 1, lg2, h2))
            frontier = nxt
            pos += 1
            if not frontier:
                break
        return tokens, parents

    def on_request_finished(self, request):
        self._seqs.pop(request.request_id, None)


def _loaders(get, device):
    """(t, vec) of `load_hf_weights`: linears transposed to [in, out] f32
    on `device`, vectors f32 on `device` (None when absent)."""
    def t(name):
        a = get(name)
        return None if a is None else a.to(device).to(torch.float32).t()

    def vec(name):
        a = get(name)
        return None if a is None else a.to(device).to(torch.float32)
    return t, vec
