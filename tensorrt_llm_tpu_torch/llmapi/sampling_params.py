"""Sampling parameters: a copy of `tensorrt_llm_tpu/llmapi/sampling_params.py`
(the port imports nothing of the JAX package), `GuidedDecodingParams`
included.  Beam search (`use_beam_search` with width `best_of` or `n`,
`length_penalty`, `beam_width_array`) is validated as the JAX package
does, with `ValueError`: a width of at least 2 and no guided decoding."""

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
    beam_width_array: Optional[List[int]] = None
    detokenize: bool = True
    skip_special_tokens: bool = True
    guided_decoding: Optional["GuidedDecodingParams"] = None
    end_id: Optional[int] = None
    # logit controls: eos and stop ids banned before `min_tokens` outputs,
    # banned token phrases, token id -> additive bias, no repeated n-gram,
    # and f(token_ids, logits [V]) -> logits on the logits' device
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
        if self.use_beam_search:
            if (self.best_of or self.n) < 2:
                raise ValueError("beam search needs n/best_of >= 2")
            if self.guided_decoding is not None:
                raise ValueError("beam search + guided decoding unsupported")
        if isinstance(self.stop, str):
            self.stop = [self.stop]

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0 or self.top_k == 1


@dataclass
class GuidedDecodingParams:
    """Grammar-constrained decoding spec (reference: llmapi
    GuidedDecodingParams): one of a JSON Schema (dict or string), any JSON
    value, a regex, a GBNF grammar, a list of choices, or an xgrammar-style
    structural tag (free text until a trigger string, then the matching
    ``begin + schema + end`` structure)."""

    json: Optional[Union[str, dict]] = None
    json_object: bool = False
    regex: Optional[str] = None
    grammar: Optional[str] = None
    choice: Optional[List[str]] = None
    structural_tag: Optional[Union[str, dict]] = None
