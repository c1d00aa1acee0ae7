"""Speculative decoding interface.

Counterpart of `tensorrt_llm_tpu/speculative/interface.py` (the reference's
`_torch/speculative/interface.py`): a `Drafter` proposes tokens for one
request, the target engine verifies a whole draft chunk in one forward (the
prefill path with logits at every row) or a draft tree in one forward under
an ancestor mask, and the executor accepts the longest matching prefix plus
one bonus token (`runtime/executor.py`).

Modes: NGRAM (host matcher), USER_PROVIDED (a callable proposes a chain or
a tree), DRAFT_TARGET (a second model), MTP, EAGLE3 and MEDUSA (one-model
drafters on the target's hidden-state taps), AUTO (`suggest_spec_config`)
and SAVE_HIDDEN_STATES (records the taps).  `SpeculativeConfig` keeps the
JAX package's fields and defaults, plus `draft_params`: a ready model state
for the DRAFT_TARGET draft model (e.g. from `params_from_jax`).  Drafter
weight sources (`mtp_weights`) are `get_tensor(name)` callables returning
numpy arrays or torch tensors (None when absent).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Any, List, Optional

import numpy as np
import torch

DRAFT_SCOPE = "draft"      # the launch scope of every drafter's forwards


class SpeculativeMode(str, enum.Enum):
    NONE = "NONE"
    NGRAM = "NGRAM"
    DRAFT_TARGET = "DRAFT_TARGET"
    MTP = "MTP"                      # one-model, hidden-state tap
    EAGLE3 = "EAGLE3"                # one-model, multi-level feature fusion
    MEDUSA = "MEDUSA"                # K independent draft heads
    USER_PROVIDED = "USER_PROVIDED"  # user callable proposes drafts
    AUTO = "AUTO"                    # heuristic pick
    SAVE_HIDDEN_STATES = "SAVE_HIDDEN_STATES"  # capture hiddens to disk


@dataclass
class SpeculativeConfig:
    mode: SpeculativeMode = SpeculativeMode.NGRAM
    max_draft_len: int = 4
    # ngram
    max_matching_ngram_size: int = 3
    # draft-target: a ModelConfig or an HF checkpoint directory, and
    # optionally the draft model's ready state (else checkpoint or seeded
    # random weights)
    draft_model: Any = None
    draft_params: Optional[dict] = None
    # MTP / EAGLE3 / MEDUSA weight source: get_tensor(name) or None (MTP:
    # the target checkpoint's extra layer when it has one, else random)
    mtp_weights: Any = None
    # user-provided: callable(request) -> List[int]
    proposer: Any = None
    # user-provided tree: callable(request) -> (tokens, parents) with
    # parents[i] in {-1 (root attach), 0..i-1}
    tree_proposer: Any = None
    # draft-tree branching per level, e.g. (3, 2, 1); None => chain
    tree_branches: Optional[tuple] = None
    # Medusa: number of heads (0 => max_draft_len) and the candidate tree
    # as per-depth rank paths, e.g. [(0,), (0, 0), (1,), (0, 1)]
    num_medusa_heads: int = 0
    medusa_choices: Optional[list] = None
    # only greedy requests speculate
    greedy_only: bool = True
    # speculation off when more requests than this decode in one step
    max_concurrency: Optional[int] = None
    # {batch_size_threshold: draft_len}: the largest threshold <= the
    # decode batch size wins (0 turns speculation off); None => max_draft_len
    draft_len_schedule: Optional[dict] = None
    # adaptive disable: a full window of rounds whose mean accepted length
    # (bonus included) is below the threshold turns speculation off
    acceptance_window: Optional[int] = None
    acceptance_length_threshold: Optional[float] = None
    # relaxed acceptance inside <think>...</think> spans: a draft token in
    # the target's top-`relaxed_topk` whose probability is within
    # `relaxed_delta` of the top-1 is accepted
    use_relaxed_acceptance_for_thinking: bool = False
    relaxed_topk: int = 1
    relaxed_delta: float = 0.0
    begin_thinking_phase_token: Optional[int] = None
    end_thinking_phase_token: Optional[int] = None
    # SAVE_HIDDEN_STATES: output dir, shard prefix, records per shard,
    # capture width ("final" | "eagle3")
    save_dir: Optional[str] = None
    save_file_prefix: str = "data"
    save_write_interval: int = 16
    save_capture: str = "final"


def suggest_spec_config(max_batch_size: int) -> SpeculativeConfig:
    """The draft-model-free default of mode AUTO: NGram, deeper drafts at
    small batch, off past 32 concurrent decodes."""
    return SpeculativeConfig(
        mode=SpeculativeMode.NGRAM,
        max_draft_len=5 if max_batch_size <= 4 else 3,
        max_matching_ngram_size=3 if max_batch_size <= 4 else 5,
        max_concurrency=32)


class Drafter:
    """Proposes draft tokens for one request."""

    # one-model drafters tap the target's hidden states: the executor then
    # runs hidden-returning steps and feeds `on_hidden`
    needs_hidden = False
    hidden_capture = "final"

    def bind(self, engine, kv):
        """Called once by the executor with the target engine and its KV
        manager."""

    def propose(self, request) -> List[int]:
        raise NotImplementedError

    def propose_tree(self, request):
        """A draft tree (tokens, parents), or None for a chain."""
        return None

    def on_hidden(self, request, start_pos: int, hiddens):
        """Target hidden states (host f32 [n, width]) for positions
        start_pos .. start_pos + n - 1."""

    def on_accepted(self, request, accepted_tokens: List[int]):
        """Called after verification with the tokens appended."""

    def on_request_finished(self, request):
        pass


def torch_source(get_tensor):
    """`get_tensor` with its values as torch tensors (numpy arrays are
    converted; None stays None)."""
    def get(name):
        a = get_tensor(name)
        if a is None or isinstance(a, torch.Tensor):
            return a
        return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))
    return get


def refuse_mla_tree(engine) -> None:
    """Trees are refused on MLA models: the JAX MLA layer ignores the pair
    mask, so the reference verifies such trees without their ancestor mask
    (ROADMAP, "Found in the reference")."""
    if engine.model.cfg.is_mla:
        raise NotImplementedError(
            "draft-tree speculation on MLA models is not supported (the "
            "reference's MLA layer verifies trees without the ancestor "
            "mask)")


class UserProvidedDrafter(Drafter):
    """An arbitrary host callable proposes a chain (`proposer`) and/or a
    tree (`tree_proposer`)."""

    def __init__(self, cfg: SpeculativeConfig):
        if not (callable(cfg.proposer) or callable(cfg.tree_proposer)):
            raise ValueError("USER_PROVIDED needs cfg.proposer or "
                             "cfg.tree_proposer")
        self.cfg = cfg
        self.engine = None

    def bind(self, engine, kv):
        self.engine = engine

    def propose(self, request) -> List[int]:
        if self.cfg.proposer is None:
            return []
        return list(self.cfg.proposer(request))[: self.cfg.max_draft_len]

    def propose_tree(self, request):
        if self.cfg.tree_proposer is None:
            return None
        out = self.cfg.tree_proposer(request)
        if out is None:
            return None
        if self.engine is not None:
            refuse_mla_tree(self.engine)   # at the first tree
        tokens, parents = out
        return list(tokens), list(parents)


def get_drafter(cfg, llm_args=None) -> Drafter:
    """The drafter of a `SpeculativeConfig`, a mode name ("AUTO",
    "ngram", ...) or mode AUTO (`suggest_spec_config` at the LLM's
    `max_batch_size`)."""
    if isinstance(cfg, str):
        cfg = SpeculativeConfig(mode=SpeculativeMode(cfg.upper()))
    mode = SpeculativeMode(cfg.mode)
    if mode == SpeculativeMode.AUTO:
        mbs = getattr(llm_args, "max_batch_size", 8) if llm_args else 8
        cfg = suggest_spec_config(mbs)
        mode = cfg.mode
    if mode == SpeculativeMode.NGRAM:
        from tensorrt_llm_tpu_torch.speculative.ngram import NGramDrafter
        return NGramDrafter(cfg)
    if mode == SpeculativeMode.DRAFT_TARGET:
        from tensorrt_llm_tpu_torch.speculative.draft_target import (
            DraftTargetDrafter)
        return DraftTargetDrafter(cfg, llm_args)
    if mode == SpeculativeMode.MTP:
        from tensorrt_llm_tpu_torch.speculative.mtp import MTPDrafter
        return MTPDrafter(cfg, llm_args)
    if mode == SpeculativeMode.EAGLE3:
        from tensorrt_llm_tpu_torch.speculative.eagle3 import Eagle3Drafter
        return Eagle3Drafter(cfg, llm_args)
    if mode == SpeculativeMode.MEDUSA:
        from tensorrt_llm_tpu_torch.speculative.medusa import MedusaDrafter
        return MedusaDrafter(cfg, llm_args)
    if mode == SpeculativeMode.USER_PROVIDED:
        return UserProvidedDrafter(cfg)
    if mode == SpeculativeMode.SAVE_HIDDEN_STATES:
        from tensorrt_llm_tpu_torch.speculative.save_hidden import (
            SaveHiddenStatesDrafter)
        return SaveHiddenStatesDrafter(cfg)
    raise ValueError(f"speculative mode {mode} has no drafter")
