"""Sampling parameters: a copy of `tensorrt_llm_tpu/llmapi/sampling_params.py`
(the port imports nothing of the JAX package).  The port's executor
rejects the knobs this slice does not run (see `PyExecutor.submit`)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Union


@dataclass
class SamplingParams:
    max_tokens: int = 32
    temperature: float = 1.0
    top_k: int = 0               # 0 => disabled (full softmax)
    top_p: float = 1.0
    min_p: float = 0.0
    repetition_penalty: float = 1.0
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    seed: Optional[int] = None
    stop: Union[str, List[str], None] = None
    stop_token_ids: Optional[List[int]] = None
    include_stop_str_in_output: bool = False
    ignore_eos: bool = False
    logprobs: Optional[int] = None
    prompt_logprobs: Optional[int] = None
    return_context_logits: bool = False
    return_generation_logits: bool = False
    n: int = 1
    best_of: Optional[int] = None
    use_beam_search: bool = False
    length_penalty: float = 0.0
    detokenize: bool = True
    skip_special_tokens: bool = True
    guided_decoding: Optional[object] = None
    end_id: Optional[int] = None
    min_tokens: int = 0
    bad_words: Optional[List[List[int]]] = None
    logit_bias: Optional[dict] = None
    no_repeat_ngram_size: Optional[int] = None
    logits_processor: Optional[object] = None

    def __post_init__(self):
        if self.max_tokens < 1:
            raise ValueError(f"max_tokens={self.max_tokens} must be >= 1")
        if self.temperature < 0.0:
            raise ValueError(f"temperature={self.temperature} must be >= 0")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p={self.top_p} must be in (0, 1]")
        if self.top_k > 64:
            raise ValueError(f"top_k={self.top_k} exceeds the supported "
                             "maximum of 64")
        if isinstance(self.stop, str):
            self.stop = [self.stop]

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0 or self.top_k == 1

    def unsupported(self) -> List[str]:
        """Knobs set to something this slice of the port does not run."""
        bad = []
        for name, default in (
                ("repetition_penalty", 1.0), ("presence_penalty", 0.0),
                ("frequency_penalty", 0.0), ("stop", None),
                ("prompt_logprobs", None), ("return_context_logits", False),
                ("return_generation_logits", False), ("n", 1),
                ("best_of", None), ("use_beam_search", False),
                ("guided_decoding", None), ("min_tokens", 0),
                ("bad_words", None), ("logit_bias", None),
                ("no_repeat_ngram_size", None), ("logits_processor", None)):
            if getattr(self, name) != default:
                bad.append(name)
        if self.logprobs is not None and self.logprobs > 1:
            bad.append("logprobs>1")
        return bad
