"""Request state machine.

Counterpart of `tensorrt_llm_tpu/runtime/request.py`: queued -> context
(possibly chunked) -> generation -> complete, with paged-KV progress, a
queue of streamed output pieces and one ``(cumulative tokens, time)`` entry
in `token_times` per emitted piece (the bench CLI's inter-token latencies).
The host logits path records per request the top-N logprobs of each
output token, the prompt's (`prompt_logprobs`, entry 0 None), the prompt's
raw logits rows (`context_logits`, numpy [prompt_len, V]) and each output
token's raw row (`generation_logits`), and the stop string that ended it.
`truncate_output` cuts the outputs back to a stop-string match that the
scan worker found after more tokens had been sampled; the next piece
carries `truncate_to` so that a reader drops the tokens it already has past
it.  `listener`, when set, is called after each piece is queued (the
server's wake-up, so no thread blocks on a stream).  `priority` in [0, 1]
orders the waiting queue (higher first); `kv_retention_priority` is the
retention priority of the blocks the request stores for reuse (None: the
manager's default).  Disaggregated serving (JAX `request_type`): a
``context_only`` request prefills, samples its first token and leaves the
prompt's KV pages in `kv_payload`, or, with ``disagg_params.stream``, sends
them as frames on `kv_stream` while later chunks compute
(`kv_streamed_blocks` counts the blocks sent); a ``generation_only``
request enters generation from transferred pages.  Multi-LoRA: the
adapter's name (`lora_request`) and device slot (`lora_slot`, 0 for the
base model), and `on_finished`, a one-shot hook the executor calls when the
request ends (it releases a paged adapter slot).  Beam search keeps its
state machine on `beam` and leaves one dict per returned beam in
`beam_outputs`.  Multimodal fields belong to a later slice.
"""

from __future__ import annotations

import enum
import queue
import time
from dataclasses import dataclass
from typing import Any, List, Optional

from tensorrt_llm_tpu_torch.llmapi.sampling_params import SamplingParams


class RequestState(enum.Enum):
    QUEUED = "queued"
    CONTEXT_INIT = "context_init"
    GENERATION_IN_PROGRESS = "generation"
    GENERATION_COMPLETE = "complete"


class FinishReason(enum.Enum):
    NOT_FINISHED = "not_finished"
    EOS = "stop"
    STOP_STRING = "stop_string"
    LENGTH = "length"
    CANCELLED = "cancelled"
    ERROR = "error"


@dataclass
class RequestOutputPiece:
    request_id: int
    new_token_ids: List[int]
    finished: bool
    finish_reason: Optional[FinishReason] = None
    error: Optional[str] = None
    # a stop string matched earlier than the tokens already emitted: the
    # reader drops its tokens past this output length
    truncate_to: Optional[int] = None


class LlmRequest:
    _id_counter = 0

    def __init__(self, prompt_token_ids: List[int],
                 sampling_params: SamplingParams,
                 request_id: Optional[int] = None,
                 cache_salt: Optional[str] = None,
                 kv_retention_priority: Optional[int] = None,
                 priority: float = 0.5, request_type: str = "full",
                 disagg_params: Optional[Any] = None,
                 lora_request: Optional[str] = None):
        if request_id is None:
            LlmRequest._id_counter += 1
            request_id = LlmRequest._id_counter
        self.request_id = request_id
        self.prompt_token_ids = list(prompt_token_ids)
        self.sampling_params = sampling_params
        self.cache_salt = cache_salt
        self.kv_retention_priority = kv_retention_priority
        self.priority = priority
        # disaggregated serving: full | context_only | generation_only
        self.request_type = request_type
        self.disagg_params = disagg_params
        self.kv_payload: Optional[dict] = None    # context_only's pages
        self.kv_stream: Optional[queue.Queue] = (
            queue.Queue() if request_type == "context_only"
            and getattr(disagg_params, "stream", False) else None)
        self.kv_streamed_blocks = 0
        self.receive_deadline: Optional[float] = None   # generation_only
        self.lora_request = lora_request
        self.lora_slot = 0
        self.on_finished = None
        self.beam = None                # runtime.beam_search.BeamSearch
        self.beam_outputs: Optional[List[dict]] = None

        self.state = RequestState.QUEUED
        self.output_token_ids: List[int] = []
        self.finish_reason = FinishReason.NOT_FINISHED
        self.num_cached_tokens = 0      # prefix-reuse hit length
        self.context_position = 0       # prompt tokens already in the cache
        self.logprobs: List[dict] = []
        self.prompt_logprobs: Optional[List[Optional[dict]]] = None
        self.context_logits = None            # np [prompt_len, V]
        self.generation_logits: List = []     # np [V] per output token
        self.stop_string: Optional[str] = None
        self.error: Optional[str] = None      # sent with the last piece
        self._truncated_to: Optional[int] = None

        self.out_queue: "queue.Queue[RequestOutputPiece]" = queue.Queue()
        # called (no arguments, on the executor thread) after each piece is
        # queued: the server wakes its event loop with it
        self.listener = None
        self._streamed = 0

        self.arrival_time = time.time()
        self.first_sched_time: Optional[float] = None
        self.first_token_time: Optional[float] = None
        self.end_time: Optional[float] = None
        self.token_times: List[tuple] = []     # (cum tokens, time) per emit

    @property
    def prompt_len(self) -> int:
        return len(self.prompt_token_ids)

    @property
    def num_tokens(self) -> int:
        return self.prompt_len + len(self.output_token_ids)

    @property
    def num_output_tokens(self) -> int:
        return len(self.output_token_ids)

    @property
    def all_token_ids(self) -> List[int]:
        return self.prompt_token_ids + self.output_token_ids

    @property
    def remaining_context(self) -> int:
        return self.prompt_len - self.context_position

    @property
    def is_context_init(self) -> bool:
        return self.state == RequestState.CONTEXT_INIT

    @property
    def is_generating(self) -> bool:
        return self.state == RequestState.GENERATION_IN_PROGRESS

    @property
    def is_finished(self) -> bool:
        return self.state == RequestState.GENERATION_COMPLETE

    @property
    def max_total_len(self) -> int:
        return self.prompt_len + self.sampling_params.max_tokens

    def start_context(self):
        assert self.state == RequestState.QUEUED
        self.state = RequestState.CONTEXT_INIT
        self.first_sched_time = self.first_sched_time or time.time()

    def finish_context(self):
        assert self.state == RequestState.CONTEXT_INIT
        self.state = RequestState.GENERATION_IN_PROGRESS

    def append_token(self, token_id: int):
        self.output_token_ids.append(token_id)
        if self.first_token_time is None:
            self.first_token_time = time.time()

    def finish(self, reason: FinishReason):
        self.state = RequestState.GENERATION_COMPLETE
        self.finish_reason = reason
        self.end_time = time.time()

    def truncate_output(self, n: int):
        """Drop output tokens past `n` (the fused chunks sampled past a
        stop-string match), with their logprobs and generation logits."""
        if n >= len(self.output_token_ids):
            return
        self._truncated_to = n
        self.output_token_ids = self.output_token_ids[:n]
        self.logprobs = self.logprobs[:n]
        self.generation_logits = self.generation_logits[:n]
        self._streamed = min(self._streamed, n)

    def check_stop(self, eos_token_id: Optional[int]) -> Optional[FinishReason]:
        sp = self.sampling_params
        last = self.output_token_ids[-1] if self.output_token_ids else None
        end_id = sp.end_id if sp.end_id is not None else eos_token_id
        if last is not None and not sp.ignore_eos and end_id is not None \
                and last == end_id:
            return FinishReason.EOS
        if sp.stop_token_ids and last in sp.stop_token_ids:
            return FinishReason.EOS
        if self.num_output_tokens >= sp.max_tokens:
            return FinishReason.LENGTH
        return None

    def emit(self, finished: bool, error: Optional[str] = None):
        new = self.output_token_ids[self._streamed:]
        self._streamed = len(self.output_token_ids)
        if new:
            self.token_times.append((self._streamed, time.time()))
        self.out_queue.put(RequestOutputPiece(
            request_id=self.request_id, new_token_ids=new, finished=finished,
            finish_reason=self.finish_reason if finished else None,
            error=error, truncate_to=self._truncated_to))
        listener = self.listener
        if listener is not None:
            listener()
