"""Reasoning-content parsers: split <think>...</think> blocks out of chat
completions into the ``reasoning_content`` field.

A copy of `tensorrt_llm_tpu/serve/reasoning_parser.py` (pure Python; the
port imports nothing of the JAX package).  DeepSeek-R1's chat template
appends "<think>\\n" to the prompt, so its parser starts inside reasoning;
Qwen3-style models emit the opening tag themselves.

Streaming-safe: partial tag prefixes at the end of a delta are held back
until disambiguated (a delta ending in "</th" emits nothing for those
chars until more text arrives).  Text outside think blocks always streams
as content.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class ReasoningDelta:
    content: str = ""
    reasoning: str = ""


class ThinkTagReasoningParser:
    start_tag = "<think>"
    end_tag = "</think>"

    def __init__(self, reasoning_at_start: bool = False):
        self.in_reasoning = reasoning_at_start
        self._buf = ""

    def feed(self, delta: str) -> ReasoningDelta:
        self._buf += delta
        content, reasoning = [], []
        while self._buf:
            tag = self.end_tag if self.in_reasoning else self.start_tag
            i = self._buf.find(tag)
            if i != -1:
                seg = self._buf[:i]
                self._buf = self._buf[i + len(tag):]
                (reasoning if self.in_reasoning else content).append(seg)
                self.in_reasoning = not self.in_reasoning
                continue
            # hold back the longest tail that could be a tag prefix
            hold = 0
            for j in range(1, min(len(tag), len(self._buf) + 1)):
                if self._buf.endswith(tag[:j]):
                    hold = j
            seg = self._buf[:len(self._buf) - hold]
            self._buf = self._buf[len(self._buf) - hold:]
            (reasoning if self.in_reasoning else content).append(seg)
            break
        return ReasoningDelta("".join(content), "".join(reasoning))

    def flush(self) -> ReasoningDelta:
        """Emit any held-back partial tag as plain text at end of stream."""
        seg, self._buf = self._buf, ""
        return (ReasoningDelta(reasoning=seg) if self.in_reasoning
                else ReasoningDelta(content=seg))

    def parse_full(self, text: str) -> ReasoningDelta:
        d1 = self.feed(text)
        d2 = self.flush()
        return ReasoningDelta(d1.content + d2.content,
                              d1.reasoning + d2.reasoning)


# model family -> constructor kwargs (reference ReasoningParserFactory)
_PARSERS = {
    "deepseek-r1": {"reasoning_at_start": True},
    "qwen3": {"reasoning_at_start": False},
    "nano-v3": {"reasoning_at_start": True},
}


def get_reasoning_parser(name):
    if name is None:
        return None
    key = name.lower()
    if key not in _PARSERS:
        raise ValueError(f"unknown reasoning parser {name!r}; "
                         f"supported: {sorted(_PARSERS)}")
    return ThinkTagReasoningParser(**_PARSERS[key])
