"""OpenAI API request/response schemas.

Counterpart of `tensorrt_llm_tpu/serve/openai_protocol.py`, without
`pydantic` (the card's machine has none): each request is a dataclass with
the JAX schema's fields and defaults, built by `parse_request`, which
checks and coerces a decoded JSON body as pydantic's lax mode does for
these field types (an int from an integral float, a numeric string or a
bool; a float from an int or a numeric string; a bool from 0/1 or
"true"/"yes"/"on"/...; a union tried member by member, exact types first;
unknown keys ignored).  Whatever it refuses raises `RequestError`, which
the server answers with 400 as the JAX server answers a pydantic
`ValidationError`; the message differs.  The conversions to
`SamplingParams` (`to_sampling_params`, `forced_tool`,
`_guided_from_response_format`) and the response builders are the JAX
package's.
"""

from __future__ import annotations

import dataclasses
import math
import time
import uuid
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Union

from tensorrt_llm_tpu_torch.llmapi.sampling_params import (
    GuidedDecodingParams, SamplingParams)


def random_id(prefix: str) -> str:
    return f"{prefix}-{uuid.uuid4().hex[:24]}"


class RequestError(ValueError):
    """A request body the schema refuses (the server answers 400)."""


# ---- lax coercion -----------------------------------------------------------
# A field's type is a spec: str, int, float, bool, dict (Dict[str, Any]),
# a request class, ("opt", spec), ("list", spec) or ("union", spec, ...).
_TRUE = {"1", "on", "t", "true", "y", "yes"}
_FALSE = {"0", "off", "f", "false", "n", "no"}
_NO = object()


def _exact(v, spec) -> bool:
    """Whether `v` is of `spec`'s type as it stands (a union's first pass)."""
    if spec is str:
        return isinstance(v, str)
    if spec is int:
        return isinstance(v, int) and not isinstance(v, bool)
    if spec is float:
        return isinstance(v, float)
    if spec is bool:
        return isinstance(v, bool)
    if spec is dict:
        return isinstance(v, dict)
    if isinstance(spec, tuple) and spec[0] == "list":
        return isinstance(v, list) and all(_exact(x, spec[1]) for x in v)
    return False


def _lax(v, spec):
    """`v` coerced to `spec`, or `_NO`."""
    if isinstance(spec, tuple):
        kind = spec[0]
        if kind == "opt":
            return None if v is None else _lax(v, spec[1])
        if kind == "list":
            if not isinstance(v, list):
                return _NO
            out = [_lax(x, spec[1]) for x in v]
            return _NO if any(x is _NO for x in out) else out
        if kind == "union":
            for s in spec[1:]:
                if _exact(v, s):
                    return v
            for s in spec[1:]:
                r = _lax(v, s)
                if r is not _NO:
                    return r
            return _NO
        raise AssertionError(spec)
    if spec is str:
        return v if isinstance(v, str) else _NO
    if spec is int:
        if isinstance(v, bool):
            return int(v)
        if isinstance(v, int):
            return v
        if isinstance(v, float):
            return int(v) if math.isfinite(v) and v == int(v) else _NO
        if isinstance(v, str):
            try:
                return int(v.strip())
            except ValueError:
                f = _lax(v, float)
                return _NO if f is _NO else _lax(f, int)
        return _NO
    if spec is float:
        if isinstance(v, (bool, int, float)):
            return float(v)
        if isinstance(v, str):
            try:
                return float(v.strip())
            except ValueError:
                return _NO
        return _NO
    if spec is bool:
        if isinstance(v, bool):
            return v
        if isinstance(v, (int, float)) and v in (0, 1):
            return bool(v)
        if isinstance(v, str) and v.strip().lower() in _TRUE | _FALSE:
            return v.strip().lower() in _TRUE
        return _NO
    if spec is dict:
        return v if isinstance(v, dict) else _NO
    if isinstance(spec, type) and dataclasses.is_dataclass(spec):
        try:
            return parse_request(spec, v)
        except RequestError:
            return _NO
    raise AssertionError(spec)


def parse_request(cls, body):
    """An instance of request class `cls` from a decoded JSON body:
    required fields present, every given field coerced to its type."""
    if not isinstance(body, dict):
        raise RequestError(f"{cls.__name__}: the body must be a JSON object")
    kw = {}
    for f in dataclasses.fields(cls):
        spec = cls.SPEC[f.name]
        if f.name not in body:
            if f.default is dataclasses.MISSING:
                raise RequestError(f"{cls.__name__}.{f.name}: field required")
            continue
        v = _lax(body[f.name], spec)
        if v is _NO:
            raise RequestError(f"{cls.__name__}.{f.name}: invalid value "
                               f"{body[f.name]!r}")
        kw[f.name] = v
    return cls(**kw)


_OPT_INT = ("opt", int)
_OPT_STR = ("opt", str)
_OPT_DICT = ("opt", dict)
_STOP = ("opt", ("union", str, ("list", str)))


# ---- requests -------------------------------------------------------------
@dataclass
class CompletionRequest:
    model: str
    prompt: Union[str, List[str], List[int], List[List[int]]]
    max_tokens: int = 16
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 0
    min_p: float = 0.0
    n: int = 1
    stream: bool = False
    logprobs: Optional[int] = None
    echo: bool = False
    stop: Union[str, List[str], None] = None
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    repetition_penalty: float = 1.0
    seed: Optional[int] = None
    user: Optional[str] = None
    ignore_eos: bool = False
    response_format: Optional[Dict[str, Any]] = None

    SPEC = dict(model=str, prompt=("union", str, ("list", str),
                                   ("list", int), ("list", ("list", int))),
                max_tokens=int, temperature=float, top_p=float, top_k=int,
                min_p=float, n=int, stream=bool, logprobs=_OPT_INT,
                echo=bool, stop=_STOP, presence_penalty=float,
                frequency_penalty=float, repetition_penalty=float,
                seed=_OPT_INT, user=_OPT_STR, ignore_eos=bool,
                response_format=_OPT_DICT)

    def to_sampling_params(self) -> SamplingParams:
        return SamplingParams(
            max_tokens=self.max_tokens,
            temperature=self.temperature,
            top_p=self.top_p,
            top_k=self.top_k,
            min_p=self.min_p,
            n=self.n,
            stop=self.stop,
            seed=self.seed,
            logprobs=self.logprobs,
            # OpenAI echo + logprobs returns prompt-token logprobs too
            prompt_logprobs=self.logprobs if self.echo else None,
            presence_penalty=self.presence_penalty,
            frequency_penalty=self.frequency_penalty,
            repetition_penalty=self.repetition_penalty,
            ignore_eos=self.ignore_eos,
            guided_decoding=_guided_from_response_format(self.response_format),
        )


@dataclass
class ChatMessage:
    role: str
    content: Union[str, List[Dict[str, Any]], None] = None
    name: Optional[str] = None
    tool_calls: Optional[List[Dict[str, Any]]] = None

    SPEC = dict(role=str, content=("opt", ("union", str, ("list", dict))),
                name=_OPT_STR, tool_calls=("opt", ("list", dict)))


@dataclass
class ChatCompletionRequest:
    model: str
    messages: List[ChatMessage]
    max_tokens: Optional[int] = None
    max_completion_tokens: Optional[int] = None
    # a multimodal-embedding handle of an encode server: its slice is not
    # in the port yet (the server refuses it)
    multi_modal_embeddings: Optional[Dict[str, Any]] = None
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 0
    n: int = 1
    stream: bool = False
    stop: Union[str, List[str], None] = None
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    seed: Optional[int] = None
    logprobs: bool = False
    top_logprobs: Optional[int] = None
    user: Optional[str] = None
    ignore_eos: bool = False
    response_format: Optional[Dict[str, Any]] = None
    tools: Optional[List[Dict[str, Any]]] = None
    # "auto" | "none" | "required" | {"type": "function",
    #                                 "function": {"name": ...}}
    tool_choice: Union[str, Dict[str, Any]] = "auto"

    SPEC = dict(model=str, messages=("list", ChatMessage),
                max_tokens=_OPT_INT, max_completion_tokens=_OPT_INT,
                multi_modal_embeddings=_OPT_DICT, temperature=float, top_p=float, top_k=int, n=int,
                stream=bool, stop=_STOP, presence_penalty=float,
                frequency_penalty=float, seed=_OPT_INT, logprobs=bool,
                top_logprobs=_OPT_INT, user=_OPT_STR, ignore_eos=bool,
                response_format=_OPT_DICT, tools=("opt", ("list", dict)),
                tool_choice=("union", str, dict))

    def forced_tool(self) -> Optional[Dict[str, Any]]:
        """The tool definition when tool_choice forces one function."""
        if not isinstance(self.tool_choice, dict) or not self.tools:
            return None
        want = self.tool_choice.get("function", {}).get("name")
        for t in self.tools:
            if t.get("function", {}).get("name") == want:
                return t
        return None

    def to_sampling_params(self) -> SamplingParams:
        max_toks = self.max_completion_tokens or self.max_tokens or 512
        guided = _guided_from_response_format(self.response_format)
        forced = self.forced_tool()
        if forced is not None and guided is None:
            # forced function call: the whole completion follows the
            # tool's parameter schema
            schema = forced.get("function", {}).get("parameters")
            guided = (GuidedDecodingParams(json=schema) if schema
                      else GuidedDecodingParams(json_object=True))
        return SamplingParams(
            max_tokens=max_toks,
            temperature=self.temperature,
            top_p=self.top_p,
            top_k=self.top_k,
            n=self.n,
            stop=self.stop,
            seed=self.seed,
            logprobs=(self.top_logprobs or 1) if self.logprobs else None,
            presence_penalty=self.presence_penalty,
            frequency_penalty=self.frequency_penalty,
            ignore_eos=self.ignore_eos,
            guided_decoding=guided,
        )


@dataclass
class ResponsesRequest:
    """OpenAI Responses API."""
    model: str
    input: Union[str, List[Dict[str, Any]]]
    instructions: Optional[str] = None
    max_output_tokens: Optional[int] = None
    temperature: float = 1.0
    top_p: float = 1.0
    stream: bool = False
    tools: Optional[List[Dict[str, Any]]] = None
    ignore_eos: bool = False     # extension: benchmarking aid

    SPEC = dict(model=str, input=("union", str, ("list", dict)),
                instructions=_OPT_STR, max_output_tokens=_OPT_INT,
                temperature=float, top_p=float, stream=bool,
                tools=("opt", ("list", dict)), ignore_eos=bool)

    def to_messages(self) -> List[ChatMessage]:
        msgs: List[ChatMessage] = []
        if self.instructions:
            msgs.append(ChatMessage(role="system",
                                    content=self.instructions))
        if isinstance(self.input, str):
            msgs.append(ChatMessage(role="user", content=self.input))
        else:
            for item in self.input:
                if item.get("type", "message") == "message":
                    msgs.append(parse_request(ChatMessage, {
                        "role": item.get("role", "user"),
                        "content": item.get("content")}))
        return msgs

    def chat_tools(self) -> Optional[List[Dict[str, Any]]]:
        """Responses-style flat tool defs -> chat-completions nesting."""
        if not self.tools:
            return None
        out = []
        for t in self.tools:
            if "function" in t:
                out.append(t)
            else:
                out.append({"type": "function", "function": {
                    "name": t.get("name"),
                    "description": t.get("description"),
                    "parameters": t.get("parameters"),
                }})
        return out

    def to_sampling_params(self) -> SamplingParams:
        return SamplingParams(
            max_tokens=self.max_output_tokens or 512,
            temperature=self.temperature,
            top_p=self.top_p,
            ignore_eos=self.ignore_eos,
        )


def _guided_from_response_format(rf: Optional[Dict[str, Any]]):
    if not rf:
        return None
    t = rf.get("type")
    if t == "json_object":
        return GuidedDecodingParams(json_object=True)
    if t == "json_schema":
        schema = rf.get("json_schema", {}).get("schema")
        return GuidedDecodingParams(json=schema)
    if t == "structural_tag":
        # xgrammar structural tags: the spec rides alongside "type"
        return GuidedDecodingParams(structural_tag={
            k: v for k, v in rf.items() if k != "type"})
    return None


# ---- responses --------------------------------------------------------------
def completion_response(req: CompletionRequest, texts: List[str],
                        finish_reasons: List[Optional[str]],
                        usage: Dict[str, int],
                        logprobs: Optional[list] = None) -> Dict:
    return {
        "id": random_id("cmpl"),
        "object": "text_completion",
        "created": int(time.time()),
        "model": req.model,
        "choices": [
            {"index": i, "text": t, "finish_reason": fr,
             "logprobs": (logprobs[i] if logprobs else None)}
            for i, (t, fr) in enumerate(zip(texts, finish_reasons))
        ],
        "usage": usage,
    }


def chat_choice(index: int, text: Optional[str],
                finish_reason: Optional[str],
                tool_calls: Optional[List[Dict]] = None,
                reasoning: Optional[str] = None,
                logprobs: Optional[Dict] = None) -> Dict:
    message: Dict[str, Any] = {"role": "assistant", "content": text}
    if tool_calls:
        message["tool_calls"] = tool_calls
        finish_reason = "tool_calls"
    if reasoning:
        message["reasoning_content"] = reasoning
    choice = {"index": index, "message": message,
              "finish_reason": finish_reason}
    if logprobs is not None:
        choice["logprobs"] = logprobs
    return choice


def chat_response(req: ChatCompletionRequest, text: str,
                  finish_reason: Optional[str],
                  usage: Dict[str, int],
                  tool_calls: Optional[List[Dict]] = None,
                  reasoning: Optional[str] = None,
                  extra_choices: Optional[List[Dict]] = None,
                  logprobs: Optional[Dict] = None) -> Dict:
    choices = [chat_choice(0, text, finish_reason, tool_calls, reasoning,
                           logprobs)]
    choices.extend(extra_choices or [])
    return {
        "id": random_id("chatcmpl"),
        "object": "chat.completion",
        "created": int(time.time()),
        "model": req.model,
        "choices": choices,
        "usage": usage,
    }


def responses_response(model: str, text: str, usage: Dict[str, int],
                       tool_calls: Optional[List[Dict]] = None,
                       reasoning: Optional[str] = None) -> Dict:
    """OpenAI Responses API object."""
    rid = random_id("resp")
    output: List[Dict[str, Any]] = []
    if reasoning:
        output.append({"type": "reasoning", "id": random_id("rs"),
                       "summary": [{"type": "summary_text",
                                    "text": reasoning}]})
    if text:
        output.append({
            "type": "message", "id": random_id("msg"), "role": "assistant",
            "status": "completed",
            "content": [{"type": "output_text", "text": text,
                         "annotations": []}],
        })
    for tc in tool_calls or []:
        output.append({
            "type": "function_call", "id": random_id("fc"),
            "call_id": tc["id"], "name": tc["function"]["name"],
            "arguments": tc["function"]["arguments"],
            "status": "completed",
        })
    return {
        "id": rid, "object": "response", "created_at": int(time.time()),
        "status": "completed", "model": model, "output": output,
        "usage": {"input_tokens": usage.get("prompt_tokens", 0),
                  "output_tokens": usage.get("completion_tokens", 0),
                  "total_tokens": usage.get("total_tokens", 0)},
    }


def chat_chunk(rid: str, model: str, delta: Dict,
               finish_reason: Optional[str] = None) -> Dict:
    return {
        "id": rid,
        "object": "chat.completion.chunk",
        "created": int(time.time()),
        "model": model,
        "choices": [{"index": 0, "delta": delta,
                     "finish_reason": finish_reason}],
    }
