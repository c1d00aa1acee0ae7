"""Medusa speculative decoding: K independent draft heads.

Counterpart of `tensorrt_llm_tpu/speculative/medusa.py` (the reference's
`MedusaDecodingConfig`): K heads read the target's hidden state at the
newest accepted token and predict tokens t+1 .. t+K with no draft KV and
no chaining, each the Medusa ResBlock and a vocab projection (f32):

    logits_i = (h + silu(h @ W_res_i)) @ W_head_i

A chain takes each head's argmax; ``medusa_choices`` paths (a node at depth
d is head d's n-th best candidate) become a draft tree.  Without a weight
source a head is drawn from ``np.random.RandomState(1000 + i)`` (x 0.02)
with an identity ResBlock, exactly the JAX package's draws.  Trees are
refused on MLA models (`interface.refuse_mla_tree`).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from tensorrt_llm_tpu_torch.speculative.interface import (
    Drafter, SpeculativeConfig, refuse_mla_tree, torch_source)


class MedusaDrafter(Drafter):
    needs_hidden = True
    hidden_capture = "final"

    def __init__(self, cfg: SpeculativeConfig, llm_args=None):
        self.cfg = cfg
        self.num_heads = cfg.num_medusa_heads or cfg.max_draft_len
        self.choices = [tuple(c) for c in (cfg.medusa_choices or [])]
        self._last: Dict[int, torch.Tensor] = {}  # rid -> last hidden (f32)
        self.res = self.head = None

    def bind(self, engine, kv):
        if self.choices:
            refuse_mla_tree(engine)
        cfg = engine.model.cfg
        H, V = cfg.hidden_size, cfg.vocab_size
        dev = engine.device
        src = self.cfg.mtp_weights
        get = torch_source(src) if src else (lambda name: None)
        heads, res = [], []
        for i in range(self.num_heads):
            w = get(f"medusa_head.{i}.1.weight")                  # [V, H]
            r = get(f"medusa_head.{i}.0.linear.weight")           # [H, H]
            heads.append(w.to(dev, torch.float32).t() if w is not None
                         else torch.from_numpy(np.random.RandomState(
                             1000 + i).randn(H, V).astype(np.float32)
                             * np.float32(0.02)).to(dev))
            res.append(r.to(dev, torch.float32).t() if r is not None
                       else torch.zeros((H, H), device=dev))
        self.res = torch.stack(res).contiguous()       # [K, H, H]
        self.head = torch.stack(heads).contiguous()    # [K, H, V]

    def on_hidden(self, request, start_pos: int, hiddens):
        # all K heads read the newest row only
        self._last[request.request_id] = hiddens[-1].to(torch.float32)

    @torch.no_grad()
    def _head_logits(self, request) -> Optional[torch.Tensor]:
        h = self._last.get(request.request_id)
        if h is None or self.head is None:
            return None
        x = h[None, :] + torch.nn.functional.silu(
            torch.einsum("h,khj->kj", h, self.res))
        return torch.einsum("kh,khv->kv", x, self.head)   # [K, V]

    def propose(self, request) -> List[int]:
        logits = self._head_logits(request)
        if logits is None:
            return []
        k = min(self.num_heads, self.cfg.max_draft_len)
        return [int(t) for t in torch.argmax(logits[:k], dim=-1).tolist()]

    def propose_tree(self, request):
        """medusa_choices -> (tokens, parents); a path's prefixes must be
        present for its parent to resolve."""
        if not self.choices:
            return None
        logits = self._head_logits(request)
        if logits is None:
            return None
        width = 1 + max((max(c) for c in self.choices if c), default=0)
        top = np.argsort(-logits.cpu().numpy(), axis=-1)[:, :width]
        index = {}
        tokens, parents = [], []
        for path in sorted(self.choices, key=len):
            depth = len(path) - 1
            if depth >= self.num_heads:
                continue
            parents.append(index.get(path[:-1], -1) if depth else -1)
            tokens.append(int(top[depth, path[-1]]))
            index[path] = len(tokens) - 1
        return tokens, parents

    def on_request_finished(self, request):
        self._last.pop(request.request_id, None)
