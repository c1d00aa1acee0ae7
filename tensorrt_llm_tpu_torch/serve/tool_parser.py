"""Model-specific tool-call parsers for the OpenAI server.

A copy of `tensorrt_llm_tpu/serve/tool_parser.py` (pure Python; the port
imports nothing of the JAX package): model output text is scanned for each
family's function-call markup (Qwen3 / Hermes, Qwen3-Coder, DeepSeek V3 /
V3.1 / V3.2, Kimi K2, and GPT-OSS's harmony channels), yielding OpenAI
``tool_calls`` entries, both one-shot and incrementally over a stream.

Streaming contract: ``feed(delta)`` returns the normal text that is safe to
emit now (never a partial begin-marker) plus any tool calls whose block just
completed; ``flush()`` releases whatever is still buffered at end of stream.
"""

from __future__ import annotations

import json
import re
import uuid
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


def _call_id() -> str:
    return "call-" + uuid.uuid4().hex[:24]


@dataclass
class ToolCall:
    name: str
    arguments: str               # JSON-encoded argument object
    id: str = field(default_factory=_call_id)

    def to_openai(self, index: int) -> Dict:
        return {"index": index, "id": self.id, "type": "function",
                "function": {"name": self.name, "arguments": self.arguments}}


@dataclass
class StreamEvent:
    """One increment of parsed output."""
    text: str = ""                       # normal content delta
    reasoning: str = ""                  # reasoning delta (harmony analysis)
    calls: List[ToolCall] = field(default_factory=list)


def _partial_suffix_len(buf: str, token: str) -> int:
    """Length of the longest strict prefix of `token` that ends `buf` —
    text we must hold back because the marker may still be completing."""
    for i in range(min(len(buf), len(token) - 1), 0, -1):
        if token.startswith(buf[-i:]):
            return i
    return 0


class ToolParser:
    """Block-structured parser: calls live between bot_token/eot_token."""

    bot_token = ""
    eot_token = ""
    #: extra markers stripped from surrounding normal text
    strip_tokens: Tuple[str, ...] = ()

    def __init__(self):
        self._buf = ""
        self._in_call = False

    # ---- per-family hook ----------------------------------------------------
    def parse_block(self, block: str) -> List[ToolCall]:
        raise NotImplementedError

    # ---- one-shot -----------------------------------------------------------
    def parse_full(self, text: str) -> StreamEvent:
        ev = self.feed(text)
        tail = self.flush()
        return StreamEvent(text=ev.text + tail.text,
                           reasoning=ev.reasoning + tail.reasoning,
                           calls=ev.calls + tail.calls)

    def parse(self, text: str) -> Tuple[str, List[ToolCall]]:
        ev = self.parse_full(text)
        return ev.text, ev.calls

    # ---- streaming ----------------------------------------------------------
    def _clean(self, text: str) -> str:
        for t in self.strip_tokens:
            text = text.replace(t, "")
        return text

    def feed(self, delta: str) -> StreamEvent:
        self._buf += delta
        out = StreamEvent()
        while True:
            if not self._in_call:
                idx = self._buf.find(self.bot_token)
                if idx >= 0:
                    out.text += self._clean(self._buf[:idx])
                    self._buf = self._buf[idx + len(self.bot_token):]
                    self._in_call = True
                    continue
                # hold back a possible partial begin marker (and partial
                # strip-markers) at the buffer tail
                hold = _partial_suffix_len(self._buf, self.bot_token)
                for t in self.strip_tokens:
                    hold = max(hold, _partial_suffix_len(self._buf, t))
                emit = self._buf[:len(self._buf) - hold]
                self._buf = self._buf[len(self._buf) - hold:]
                out.text += self._clean(emit)
                return out
            idx = self._buf.find(self.eot_token)
            if idx < 0:
                return out  # block still streaming in
            block = self._buf[:idx]
            self._buf = self._buf[idx + len(self.eot_token):]
            self._in_call = False
            out.calls.extend(self.parse_block(block))

    def flush(self) -> StreamEvent:
        buf, self._buf = self._buf, ""
        if self._in_call:
            self._in_call = False
            # unterminated block at end of stream (max_tokens cut the end
            # marker): trim a partial end marker and try to parse anyway
            cut = _partial_suffix_len(buf, self.eot_token)
            calls = self.parse_block(buf[:len(buf) - cut] if cut else buf)
            return StreamEvent(calls=calls) if calls else \
                StreamEvent(text=self._clean(buf))
        return StreamEvent(text=self._clean(buf))


class Qwen3ToolParser(ToolParser):
    """Qwen 2.5/3 format (reference qwen3_tool_parser.py):
    ``<tool_call>\\n{"name": ..., "arguments": {...}}\\n</tool_call>``."""

    bot_token = "<tool_call>"
    eot_token = "</tool_call>"

    def parse_block(self, block: str) -> List[ToolCall]:
        try:
            obj = json.loads(block.strip())
        except json.JSONDecodeError:
            return []
        if not isinstance(obj, dict) or "name" not in obj:
            return []
        args = obj.get("arguments", obj.get("parameters", {}))
        return [ToolCall(name=str(obj["name"]),
                         arguments=json.dumps(args, ensure_ascii=False))]


class DeepSeekV3ToolParser(ToolParser):
    """DeepSeek-V3 format (reference deepseekv3_parser.py):
    ``<｜tool▁call▁begin｜>function<｜tool▁sep｜>NAME\\n```json\\nARGS\\n```
    <｜tool▁call▁end｜>`` inside a ``<｜tool▁calls▁begin｜>…`` section."""

    bot_token = "<｜tool▁call▁begin｜>"
    eot_token = "<｜tool▁call▁end｜>"
    strip_tokens = ("<｜tool▁calls▁begin｜>", "<｜tool▁calls▁end｜>",
                    "<｜end▁of▁sentence｜>")

    _detail = re.compile(
        r"(?:function)?<｜tool▁sep｜>([^\n]+)\n```json\n(.*)\n```",
        re.DOTALL)

    def parse_block(self, block: str) -> List[ToolCall]:
        m = self._detail.search(block)
        if not m:
            return []
        name, args = m.group(1).strip(), m.group(2).strip()
        try:
            json.loads(args)
        except json.JSONDecodeError:
            return []
        return [ToolCall(name=name, arguments=args)]


class DeepSeekV31Parser(ToolParser):
    """DeepSeek-V3.1 format (reference deepseekv31_parser.py): plain
    ``<｜tool▁call▁begin｜>NAME<｜tool▁sep｜>{json args}<｜tool▁call▁end｜>``
    — no ``function`` prefix and no \\`\\`\\`json fences, unlike V3."""

    bot_token = "<｜tool▁call▁begin｜>"
    eot_token = "<｜tool▁call▁end｜>"
    strip_tokens = ("<｜tool▁calls▁begin｜>", "<｜tool▁calls▁end｜>",
                    "<｜end▁of▁sentence｜>")

    def parse_block(self, block: str) -> List[ToolCall]:
        name, sep, args = block.partition("<｜tool▁sep｜>")
        if not sep:
            return []
        name, args = name.strip(), args.strip()
        try:
            json.loads(args)
        except json.JSONDecodeError:
            return []
        return [ToolCall(name=name, arguments=args)]


class DeepSeekV32Parser(ToolParser):
    """DeepSeek-V3.2 DSML format (reference deepseekv32_parser.py):

    ``<｜DSML｜invoke name="FN"> <｜DSML｜parameter name="p" string="true">v
    </｜DSML｜parameter>… </｜DSML｜invoke>`` inside a
    ``<｜DSML｜function_calls>`` section; the invoke body may instead be a
    direct JSON object."""

    bot_token = "<｜DSML｜invoke"
    eot_token = "</｜DSML｜invoke>"
    strip_tokens = ("<｜DSML｜function_calls>", "</｜DSML｜function_calls>",
                    "<｜end▁of▁sentence｜>")

    _name = re.compile(r'^\s*name="([^"]+)"\s*>', re.DOTALL)
    _param = re.compile(
        r'<｜DSML｜parameter\s+name="([^"]+)"(?:\s+string="([^"]+)")?\s*>'
        r"(.*?)</｜DSML｜parameter>", re.DOTALL)

    def parse_block(self, block: str) -> List[ToolCall]:
        m = self._name.match(block)
        if not m:
            return []
        name = m.group(1)
        body = block[m.end():].strip()
        params = self._param.findall(body)
        if params:
            args: Dict = {}
            for pname, is_str, val in params:
                val = val.strip()
                if is_str == "true":
                    args[pname] = val
                else:
                    try:
                        args[pname] = json.loads(val)
                    except json.JSONDecodeError:
                        args[pname] = val
            return [ToolCall(name=name,
                             arguments=json.dumps(args, ensure_ascii=False))]
        # direct-JSON body variant
        try:
            obj = json.loads(body) if body else {}
        except json.JSONDecodeError:
            return []
        if not isinstance(obj, dict):
            return []
        return [ToolCall(name=name,
                         arguments=json.dumps(obj, ensure_ascii=False))]


class KimiK2ToolParser(ToolParser):
    """Kimi K2 format (reference kimi_k2_tool_parser.py):
    ``<|tool_call_begin|>functions.NAME:IDX<|tool_call_argument_begin|>
    {json}<|tool_call_end|>`` inside a ``<|tool_calls_section_begin|>``
    section."""

    bot_token = "<|tool_call_begin|>"
    eot_token = "<|tool_call_end|>"
    strip_tokens = ("<|tool_calls_section_begin|>",
                    "<|tool_calls_section_end|>")

    _id = re.compile(r"^\s*(?:functions\.)?(?P<name>[\w\.]+):\d+\s*$")

    def parse_block(self, block: str) -> List[ToolCall]:
        ident, sep, args = block.partition("<|tool_call_argument_begin|>")
        if not sep:
            return []
        m = self._id.match(ident)
        if not m:
            return []
        args = args.strip()
        try:
            json.loads(args)
        except json.JSONDecodeError:
            return []
        return [ToolCall(name=m.group("name"), arguments=args)]


class Qwen3CoderParser(ToolParser):
    """Qwen3-Coder XML-ish format (reference qwen3_coder_parser.py):

    ``<tool_call><function=NAME><parameter=KEY>value</parameter>…
    </function></tool_call>`` — parameter values are JSON-coerced when they
    parse (numbers/bools/objects), else kept as trimmed strings."""

    bot_token = "<tool_call>"
    eot_token = "</tool_call>"

    _fn = re.compile(r"<function=(.*?)>(.*?)(?:</function>|$)", re.DOTALL)
    _param = re.compile(r"<parameter=(.*?)>(.*?)(?:</parameter>|$)",
                        re.DOTALL)

    @staticmethod
    def _coerce(val: str):
        v = val.strip("\n")
        try:
            return json.loads(v)
        except (json.JSONDecodeError, ValueError):
            return v

    def parse_block(self, block: str) -> List[ToolCall]:
        calls = []
        for name, body in self._fn.findall(block):
            args = {k.strip(): self._coerce(v)
                    for k, v in self._param.findall(body)}
            calls.append(ToolCall(name=name.strip(),
                                  arguments=json.dumps(args,
                                                       ensure_ascii=False)))
        return calls


class HarmonyParser(ToolParser):
    """GPT-OSS harmony channel format (reference serve/harmony_adapter.py):

    ``<|channel|>analysis<|message|>…<|end|>`` → reasoning,
    ``<|channel|>final<|message|>…<|return|>`` → content,
    ``<|channel|>commentary to=functions.NAME <|constrain|>json<|message|>
    {args}<|call|>`` → a tool call.

    Implemented as a channel state machine rather than block begin/end
    markers, so it overrides feed()/flush() wholesale.
    """

    _CHANNEL = "<|channel|>"
    _MESSAGE = "<|message|>"
    _TERMINATORS = ("<|end|>", "<|call|>", "<|return|>", "<|start|>")
    _HOLD_TOKENS = ("<|channel|>", "<|message|>", "<|end|>", "<|call|>",
                    "<|return|>", "<|start|>", "<|constrain|>")

    def __init__(self):
        super().__init__()
        self._state = "text"         # text | header | body
        self._header = ""
        self._body = ""

    def _route(self, out: StreamEvent, chunk: str, final: bool = False):
        """Send a body chunk to the right sink for the current channel."""
        hdr = self._header
        if "to=functions." in hdr:
            if final:
                name = hdr.split("to=functions.")[1].split()[0].strip()
                args = self._body.strip()
                try:
                    json.loads(args)
                    out.calls.append(ToolCall(name=name, arguments=args))
                except json.JSONDecodeError:
                    pass
            return
        if hdr.strip().startswith("analysis"):
            out.reasoning += chunk
        else:  # final / commentary preamble
            out.text += chunk

    def feed(self, delta: str) -> StreamEvent:
        self._buf += delta
        out = StreamEvent()
        while True:
            if self._state == "skip_role":
                # after <|start|>: discard the role word up to the next
                # <|...|> marker
                idx = self._buf.find("<|")
                if idx < 0:
                    tail = _partial_suffix_len(self._buf, "<|")
                    self._buf = self._buf[len(self._buf) - tail:]
                    return out
                self._buf = self._buf[idx:]
                self._state = "text"
                continue
            if self._state == "text":
                i_ch = self._buf.find(self._CHANNEL)
                i_st = self._buf.find("<|start|>")
                if i_st >= 0 and (i_ch < 0 or i_st < i_ch):
                    out.text += self._buf[:i_st]
                    self._buf = self._buf[i_st + len("<|start|>"):]
                    self._state = "skip_role"
                    continue
                if i_ch >= 0:
                    # bare-text prefix before the channel marker
                    out.text += self._buf[:i_ch]
                    self._buf = self._buf[i_ch + len(self._CHANNEL):]
                    self._state = "header"
                    self._header = ""
                    continue
                hold = max((_partial_suffix_len(self._buf, t)
                            for t in self._HOLD_TOKENS), default=0)
                out.text += self._buf[:len(self._buf) - hold]
                self._buf = self._buf[len(self._buf) - hold:]
                return out
            if self._state == "header":
                idx = self._buf.find(self._MESSAGE)
                if idx < 0:
                    return out
                self._header = self._buf[:idx]
                self._buf = self._buf[idx + len(self._MESSAGE):]
                self._state = "body"
                self._body = ""
                continue
            # body: ends at any terminator
            positions = [(self._buf.find(t), t) for t in self._TERMINATORS]
            positions = [(i, t) for i, t in positions if i >= 0]
            if positions:
                idx, term = min(positions)
                chunk = self._buf[:idx]
                self._body += chunk
                self._route(out, chunk, final=False)
                self._route(out, "", final=True)
                self._buf = self._buf[idx + (0 if term == "<|start|>"
                                             else len(term)):]
                self._state = "text"
                continue
            hold = max((_partial_suffix_len(self._buf, t)
                        for t in self._HOLD_TOKENS), default=0)
            chunk = self._buf[:len(self._buf) - hold]
            self._body += chunk
            self._route(out, chunk, final=False)
            self._buf = self._buf[len(self._buf) - hold:]
            return out

    def flush(self) -> StreamEvent:
        out = StreamEvent()
        if self._state == "body":
            chunk, self._buf = self._buf, ""
            self._body += chunk
            self._route(out, chunk, final=False)
            self._route(out, "", final=True)
        elif self._state == "text":
            out.text = self._buf
            self._buf = ""
        else:  # header / skip_role remnants are markup, not content
            self._buf = ""
        self._state = "text"
        return out


_PARSERS = {
    "qwen3": Qwen3ToolParser,
    "qwen": Qwen3ToolParser,
    "hermes": Qwen3ToolParser,       # same <tool_call> block format
    "qwen3_coder": Qwen3CoderParser,
    "deepseek_v3": DeepSeekV3ToolParser,
    "deepseek": DeepSeekV3ToolParser,
    "deepseek_v31": DeepSeekV31Parser,
    "deepseek_v32": DeepSeekV32Parser,
    "kimi_k2": KimiK2ToolParser,
    "harmony": HarmonyParser,
    "gpt_oss": HarmonyParser,
}


def get_tool_parser(name: Optional[str]) -> Optional[ToolParser]:
    """Instantiate a parser by family name (None -> no parsing)."""
    if not name:
        return None
    try:
        return _PARSERS[name.lower()]()
    except KeyError:
        raise ValueError(
            f"unknown tool parser {name!r}; available: {sorted(_PARSERS)}")
