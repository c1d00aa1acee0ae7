"""Request tracing: one record per finished request.

After `tensorrt_llm_tpu/llmapi/tracing.py`: each record carries the
reference's span attributes (queue time, time to first token, end-to-end
latency, token counts, finish reason), in seconds from the request's
arrival.  The tracer is an in-process ring buffer of the last 256 records,
which the server's ``/traces`` route reads; the OTLP export waits until a
slice wires an endpoint through `LlmArgs`.  The executor records a request
when it is freed.
"""

from __future__ import annotations

import collections

# span attribute keys (mirroring reference SpanAttributes, tracing.py:137-170)
ATTR_QUEUE_TIME = "gen_ai.latency.time_in_queue"
ATTR_TTFT = "gen_ai.latency.time_to_first_token"
ATTR_E2E = "gen_ai.latency.e2e"
ATTR_PROMPT_TOKENS = "gen_ai.usage.prompt_tokens"
ATTR_COMPLETION_TOKENS = "gen_ai.usage.completion_tokens"
ATTR_FINISH_REASON = "gen_ai.response.finish_reasons"


class RequestTracer:
    """The last 256 finished requests' trace records."""

    def __init__(self):
        self.records = collections.deque(maxlen=256)

    def record_request(self, req) -> dict:
        """Build the span attributes from the request's timestamps
        (arrival, first scheduled, first token, end)."""
        attrs = {
            ATTR_PROMPT_TOKENS: req.prompt_len,
            ATTR_COMPLETION_TOKENS: req.num_output_tokens,
            ATTR_FINISH_REASON: req.finish_reason.value,
        }
        if req.first_sched_time:
            attrs[ATTR_QUEUE_TIME] = req.first_sched_time - req.arrival_time
        if req.first_token_time:
            attrs[ATTR_TTFT] = req.first_token_time - req.arrival_time
        if req.end_time:
            attrs[ATTR_E2E] = req.end_time - req.arrival_time
        self.records.append({"request_id": req.request_id, **attrs})
        return attrs
