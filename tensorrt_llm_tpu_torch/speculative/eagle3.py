"""EAGLE3-style one-model speculative decoding.

Counterpart of `tensorrt_llm_tpu/speculative/eagle3.py` (the reference's
`_torch/speculative/eagle3.py`; EAGLE-3, arXiv:2503.01840): the target's
residual stream after a low, a middle and a high layer, concatenated to
[3H] (the engine's ``capture="eagle3"`` tap), is fused by a linear `fc`
into the draft block's input.  Catch-up passes read the fused target
features; chain steps feed the block its own [H] hidden (fc bypassed).
Everything else is the MTP drafter's (`mtp.py`): the single-layer pool
over the main block tables, the chain and the tree.  A checkpoint with a
reduced draft vocabulary scores only the draft ids (`draft_head`) and
translates them with its `d2t` offset table.  Without weights, `fc` is
drawn from a `torch.Generator` seeded 11 (the JAX package draws
`PRNGKey(11)`); the block's `eh_proj`, which EAGLE3 exports do not name,
comes from the MTP names of the same source when it has them.
"""

from __future__ import annotations

import numpy as np
import torch

from tensorrt_llm_tpu_torch.speculative.interface import torch_source
from tensorrt_llm_tpu_torch.speculative.mtp import MTPDrafter, _loaders
from tensorrt_llm_tpu_torch.utils import logger


class Eagle3Drafter(MTPDrafter):
    hidden_capture = "eagle3"

    def set_checkpoint(self, get_tensor) -> None:
        """A target checkpoint's MTP layer is not an EAGLE3 draft: kept
        out (the draft comes from `mtp_weights`)."""

    @torch.no_grad()
    def bind(self, engine, kv):
        # the block as MTP builds it (a source with MTP names loads them
        # first, as in the JAX package; `eh_proj` has no EAGLE3 name)
        super().bind(engine, kv)
        H = self.model_cfg.hidden_size
        gen = torch.Generator(device=engine.device)
        gen.manual_seed(11)
        self.params["fc"] = torch.randn(
            (3 * H, H), generator=gen, device=engine.device).mul_(
                0.5 / (3 * H) ** 0.5).to(torch.bfloat16)
        if self.cfg.mtp_weights is not None:
            self.load_eagle_weights(self.cfg.mtp_weights)

    @torch.no_grad()
    def load_eagle_weights(self, get_tensor):
        """Load an EAGLE3 draft checkpoint: `fc`, the draft head
        ``lm_head.weight`` [draft_vocab, H], the `d2t` table and the draft
        decoder layer with its norms (exports name the layer ``midlayer.*``,
        ``model.layers.0.*`` or ``layers.0.*``)."""
        get = torch_source(get_tensor)
        t, vec = _loaders(get, self.engine.device)
        fc = t("fc.weight")
        if fc is not None:
            self.params["fc"] = fc.to(torch.bfloat16)
        head = t("lm_head.weight")                  # -> [H, draft_vocab]
        if head is not None:
            self.params["draft_head"] = head.to(torch.bfloat16)
        d2t = get("d2t")
        if d2t is not None:
            self.d2t = d2t.cpu().numpy().astype(np.int64)
            if head is not None and head.shape[1] != len(self.d2t):
                raise ValueError("d2t length must match the draft head's "
                                 "vocab")
        pre = next((p for p in ("midlayer.", "model.layers.0.", "layers.0.")
                    if get(p + "input_layernorm.weight") is not None), None)
        if pre is None:
            if fc is not None or head is not None:
                logger.warning(
                    "EAGLE3 checkpoint has no draft decoder layer under "
                    "midlayer./model.layers.0./layers.0.: the draft block "
                    "stays random")
            return
        if get(pre + "post_attention_layernorm.weight") is None:
            raise ValueError(f"partial EAGLE3 layer under {pre!r}: missing "
                             "post-attention layernorm weights")
        self._load_layer(get, pre, t, vec)
        for key, names in (("hnorm", (pre + "hidden_norm.weight",
                                      "hidden_norm.weight")),
                           ("enorm", (pre + "input_norm.weight",
                                      "enorm.weight")),
                           ("final_norm", ("norm.weight",))):
            v = next((vec(n) for n in names if get(n) is not None), None)
            if v is not None:
                self.params[key] = v
