"""Two-model draft-target speculation.

Counterpart of `tensorrt_llm_tpu/speculative/draft_target.py` (the
reference's `model_drafter.py`): a small draft model with its own
`ModelEngine` and paged `KVCacheManager` (block size 16, no reuse, the JAX
pool size) proposes greedy tokens through prefill passes -- a catch-up pass
over the accepted tokens it has not seen, then one pass a draft token --
and the target verifies.  The draft KV stays position-addressed: rejected
positions are overwritten as the accepted stream passes them.  Its passes
run the same kernels as the target's; on the card they are counted under
the launch scope ``"draft"`` (`ops.cuda_build.launch_scope`), so the chip
check tells them apart from the target's on the same executor thread.

The draft weights: `SpeculativeConfig.draft_params` (a ready state, e.g.
`params_from_jax` of the JAX drafter's), an HF checkpoint directory's
safetensors, or seeded random weights (`init_random(0)`; the JAX package
draws `PRNGKey(0)`, which torch cannot replay).
"""

from __future__ import annotations

from typing import Dict, List

import torch

from tensorrt_llm_tpu_torch.speculative.interface import (
    DRAFT_SCOPE, Drafter, SpeculativeConfig)


class _DraftSeq:
    __slots__ = ("cached_len",)

    def __init__(self):
        self.cached_len = 0  # tokens whose KV the draft model holds


class _Shim:
    """A request view for `ModelEngine.prepare_prefill_inputs`."""

    def __init__(self, request_id, tokens, context_position):
        self.request_id = request_id
        self.prompt_token_ids = tokens
        self.context_position = context_position


class DraftTargetDrafter(Drafter):
    def __init__(self, cfg: SpeculativeConfig, llm_args=None):
        from tensorrt_llm_tpu_torch.models.modeling_utils import ModelConfig
        self.cfg = cfg
        self.llm_args = llm_args
        dm = cfg.draft_model
        if isinstance(dm, ModelConfig):
            self.model_cfg, self.path = dm, None
        elif dm is not None:
            from tensorrt_llm_tpu_torch.llmapi.hf_checkpoint import (
                read_hf_config)
            self.path = str(dm)
            self.model_cfg = ModelConfig.from_hf_config(
                read_hf_config(self.path))
        else:
            raise ValueError("DRAFT_TARGET needs cfg.draft_model")
        self.engine = None
        self.kv = None
        self._seqs: Dict[int, _DraftSeq] = {}
        self.passes = 0            # draft forwards run

    def bind(self, engine, kv):
        """Build the draft model, its pool and engine on the target's
        device."""
        import dataclasses

        from tensorrt_llm_tpu_torch.llmapi.hf_checkpoint import (
            SafetensorsReader, has_weights)
        from tensorrt_llm_tpu_torch.models.modeling_utils import (
            get_model_class)
        from tensorrt_llm_tpu_torch.runtime.kv_cache_manager import (
            KVCacheConfig, KVCacheManager, pool_layout)
        from tensorrt_llm_tpu_torch.runtime.model_engine import ModelEngine
        dev = engine.device
        a = self.llm_args
        max_seq = getattr(a, "max_seq_len", 2048) if a else 2048
        mc = dataclasses.replace(self.model_cfg)
        mc.max_position = max(mc.max_position, max_seq)
        model = get_model_class(mc.architecture)(mc, dev)
        if self.cfg.draft_params is not None:
            model.load_state(self.cfg.draft_params)
        elif self.path is not None and has_weights(self.path):
            with SafetensorsReader(self.path) as reader:
                model.load_hf_weights(reader)
        else:
            model.init_random(0)
        geo = pool_layout(mc)
        kvcfg = KVCacheConfig(
            block_size=16, enable_block_reuse=False,
            bookkeeping=getattr(a, "kv_bookkeeping", "native") if a
            else "native", layout=geo["layout"],
            dsa_index_dim=geo["dsa_index_dim"])
        num_blocks = max(256, (max_seq // 16) * 64)
        self.kv = KVCacheManager(kvcfg, mc.num_layers, geo["num_kv_heads"],
                                 geo["head_dim"], num_blocks, dev)
        self.engine = ModelEngine(model, self.kv, dev)
        if dev.type == "cuda":
            self.engine.autotune_kernels()

    def _pass(self, rid: int, toks: List[int], cached: int) -> int:
        """One draft prefill pass over toks[cached:]; the argmax of its
        last row."""
        from tensorrt_llm_tpu_torch.ops.cuda_build import launch_scope
        self.kv.grow_sequence(rid, len(toks))
        inputs = self.engine.prepare_prefill_inputs(
            _Shim(rid, toks, cached), len(toks) - cached)
        with launch_scope(DRAFT_SCOPE):
            logits = self.engine.run_prefill(inputs)
        self.passes += 1
        return int(torch.argmax(logits[0]))

    def _catch_up(self, request) -> int:
        """Feed the draft model the accepted tokens it has not seen; the
        argmax of the last position (the first draft token), or -1."""
        rid = request.request_id
        toks = request.all_token_ids
        seq = self._seqs.get(rid)
        if seq is None:
            seq = self._seqs[rid] = _DraftSeq()
            self.kv.add_sequence(rid, toks)
        if len(toks) <= seq.cached_len:
            return -1
        first = self._pass(rid, toks, seq.cached_len)
        seq.cached_len = len(toks)
        return first

    def propose(self, request) -> List[int]:
        first = self._catch_up(request)
        if first < 0:
            return []
        draft = [first]
        rid = request.request_id
        seq = self._seqs[rid]
        toks = list(request.all_token_ids)
        for _ in range(self.cfg.max_draft_len - 1):
            plus = toks + draft
            draft.append(self._pass(rid, plus, seq.cached_len))
            seq.cached_len = len(plus)
        return draft

    def on_accepted(self, request, accepted_tokens):
        seq = self._seqs.get(request.request_id)
        if seq is not None:
            # rejected draft KV is overwritten later: cap the pointer at
            # what the target accepted
            seq.cached_len = min(seq.cached_len, request.num_tokens)

    def on_request_finished(self, request):
        if self._seqs.pop(request.request_id, None) is not None:
            self.kv.free_sequence(request.request_id)
