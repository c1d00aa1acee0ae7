"""Incremental detokenization for streamed outputs.

Counterpart of `tensorrt_llm_tpu/llmapi/detokenizer.py`, kept as the port's
own copy.  Re-decoding the whole token list on every streamed piece is
O(T^2) host work per request; this keeps a short decode window that starts
at the previously emitted chunk (so subword and sentencepiece context is
kept) and surfaces text only once it no longer ends in U+FFFD: a byte-level
token that ends mid-UTF-8 sequence is held back until the token that
completes it arrives.  Each piece costs O(window), a request O(T).
"""

from __future__ import annotations

from typing import Iterable, List

_REPLACEMENT = "�"


class IncrementalDetokenizer:
    """Streams stable text from a growing token-id sequence.

    ``push(new_ids)`` returns the newly-stable text (possibly ``""`` when
    the tail still ends mid-UTF-8-sequence); ``text`` accumulates every
    emitted chunk.  After the final push, ``text + flush()`` is
    byte-identical to one-shot ``tokenizer.decode(all_ids)``.
    """

    def __init__(self, tokenizer, skip_special_tokens: bool = True):
        self._tok = tokenizer
        self._skip = skip_special_tokens
        self._ids: List[int] = []
        # decode window: [prefix_offset, read_offset) is the last emitted
        # chunk (kept as context so subword merges detokenize the same way
        # they would mid-string); [read_offset, len) is not yet surfaced.
        self._prefix_offset = 0
        self._read_offset = 0
        self.text = ""

    def _decode(self, ids: List[int]) -> str:
        return self._tok.decode(ids, skip_special_tokens=self._skip)

    def push(self, new_ids: Iterable[int]) -> str:
        self._ids.extend(int(t) for t in new_ids)
        window = self._ids[self._prefix_offset:]
        prefix = self._decode(
            self._ids[self._prefix_offset:self._read_offset])
        full = self._decode(window)
        if len(full) <= len(prefix) or full.endswith(_REPLACEMENT):
            # nothing stable yet (mid-UTF-8 byte sequence, or a token that
            # decodes to nothing on its own) — hold back
            return ""
        new_text = full[len(prefix):]
        self._prefix_offset = self._read_offset
        self._read_offset = len(self._ids)
        self.text += new_text
        return new_text

    def flush(self) -> str:
        """Surface whatever the tail decodes to (end of generation: emit
        even if it still ends in U+FFFD, matching one-shot decode)."""
        prefix = self._decode(
            self._ids[self._prefix_offset:self._read_offset])
        full = self._decode(self._ids[self._prefix_offset:])
        new_text = full[len(prefix):]
        self._prefix_offset = self._read_offset = len(self._ids)
        self.text += new_text
        return new_text

    # ---------------------------------------------------------------- stop ----
    def find_stop(self, stop: str, new_len: int) -> int:
        """Bounded stop-string search: the match can only involve text that
        arrived in the last piece plus ``len(stop)-1`` older chars, so scan
        just that tail.  Returns a global index into
        ``self.text`` or -1."""
        if not stop:
            return -1
        start = max(0, len(self.text) - new_len - len(stop) + 1)
        return self.text.find(stop, start)
