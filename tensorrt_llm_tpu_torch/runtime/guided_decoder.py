"""Guided (grammar-constrained) decoding.

The port's own copy of `tensorrt_llm_tpu/runtime/guided_decoder.py`
(numpy; counterpart of the reference's xgrammar/llguidance token bitmasks
applied by `logitsBitmask.cu`): a per-request `GrammarMatcher` gives the
allowed token ids on the host, and `GuidedDecoder.mask_logits` uploads the
batch's allowed rows once a step (`utils.upload`) and bans every other
token of those rows on the logits' device before sampling.

Matchers: `choice` (a token trie over a fixed set of strings), `regex`,
`json` (a JSON Schema compiled to a regex by `json_schema_to_regex`) and
`json_object` (any JSON value) on the DFA of `regex_fsm.py`, `grammar`
(GBNF) on the pushdown automaton of `grammar_fsm.py`, and xgrammar-style
structural tags.  The vocabulary's surface strings and trie are built once
per tokenizer (`_vocab_tables`), the DFA and its token masks once per
(tokenizer, pattern).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from tensorrt_llm_tpu_torch.llmapi.sampling_params import GuidedDecodingParams
from tensorrt_llm_tpu_torch.utils import upload

NEG_INF = np.float32(np.finfo(np.float32).min)


_VOCAB_CACHE: dict = {}
_PATTERN_CACHE_MAX = 128


def _vocab_tables(tokenizer, vocab_size: int):
    """strings + trie are a function of the TOKENIZER only — building them
    per pattern made every new guided schema pay an O(vocab) build and the
    per-pattern caches retain a full copy each (unbounded growth)."""
    from tensorrt_llm_tpu_torch.runtime.regex_fsm import (
        build_vocab_trie, token_strings)
    # entry pins the tokenizer: ids of dead objects get reused, and a hit
    # on a recycled id would serve another tokenizer's tables
    key = (id(tokenizer), vocab_size)
    ent = _VOCAB_CACHE.get(key)
    if ent is None or ent[0] is not tokenizer:
        strings = token_strings(tokenizer, vocab_size)
        ent = (tokenizer, strings, build_vocab_trie(strings))
        _VOCAB_CACHE[key] = ent
    return ent[1], ent[2]


def _bound_cache(cache: dict):
    while len(cache) > _PATTERN_CACHE_MAX:
        cache.pop(next(iter(cache)))


class GrammarMatcher:
    """Tracks grammar state for one request."""

    def allowed_tokens(self) -> Optional[np.ndarray]:
        """int32 array of allowed token ids (None => everything allowed)."""
        raise NotImplementedError

    def advance(self, token_id: int) -> bool:
        """Consume a sampled token; returns False on grammar violation."""
        raise NotImplementedError

    @property
    def completed(self) -> bool:
        raise NotImplementedError


class ChoiceMatcher(GrammarMatcher):
    """Constrain output to one of N strings (token trie)."""

    def __init__(self, choices: List[str], tokenizer, eos_token_id: int):
        self.eos = eos_token_id
        self._paths = [tuple(tokenizer.encode(c)) for c in choices]
        # strip a possible BOS that encode() may prepend
        bos = getattr(tokenizer, "bos_token_id", None)
        self._paths = [p[1:] if bos is not None and p and p[0] == bos else p
                       for p in self._paths]
        self._pos = 0
        self._alive = list(self._paths)

    def allowed_tokens(self) -> Optional[np.ndarray]:
        nxt = {p[self._pos] for p in self._alive if len(p) > self._pos}
        done = any(len(p) == self._pos for p in self._alive)
        if done and self.eos is not None:
            nxt.add(self.eos)
        return np.array(sorted(nxt), np.int32)

    def advance(self, token_id: int) -> bool:
        if token_id == self.eos:
            self._alive = [p for p in self._alive if len(p) == self._pos]
            return bool(self._alive)
        self._alive = [p for p in self._alive
                       if len(p) > self._pos and p[self._pos] == token_id]
        self._pos += 1
        return bool(self._alive)

    @property
    def completed(self) -> bool:
        return any(len(p) == self._pos for p in self._alive)


class RegexMatcher(GrammarMatcher):
    """Regex/JSON-schema-constrained decoding via the DFA engine
    (runtime/regex_fsm.py) — the xgrammar-bitmask capability rebuilt from
    scratch.  Per-(tokenizer, pattern) DFA + token-mask caches are shared
    across requests."""

    _shared: dict = {}

    def __init__(self, pattern: str, tokenizer, eos_token_id: int,
                 vocab_size: int):
        from tensorrt_llm_tpu_torch.runtime.regex_fsm import (
            DFA, TokenMaskCache)
        # the entry pins the tokenizer so its id() can't be reused by a new
        # object after GC (stale-mask flake); hits verify identity anyway
        key = (id(tokenizer), pattern, vocab_size)
        hit = RegexMatcher._shared.get(key)
        if hit is None or hit[0] is not tokenizer:
            dfa = DFA(pattern)
            strings, trie = _vocab_tables(tokenizer, vocab_size)
            hit = (tokenizer,
                   TokenMaskCache(dfa, trie, eos_token_id, strings))
            RegexMatcher._shared[key] = hit
            _bound_cache(RegexMatcher._shared)
        self.masks = hit[1]
        self.eos = eos_token_id
        self.state = self.masks.dfa.start
        self._done = False

    def allowed_tokens(self) -> Optional[np.ndarray]:
        return self.masks.allowed(self.state)

    def advance(self, token_id: int) -> bool:
        if token_id == self.eos:
            self._done = self.masks.dfa.accepting[self.state]
            return self._done
        text = self.masks.strings[token_id] \
            if token_id < len(self.masks.strings) else None
        if not text:
            return False
        nxt = self.masks.dfa.walk(self.state, text)
        if nxt < 0:
            return False
        self.state = nxt
        return True

    @property
    def completed(self) -> bool:
        return self._done or self.masks.dfa.accepting[self.state]


class EbnfMatcher(GrammarMatcher):
    """EBNF (GBNF) grammar-constrained decoding via the pushdown automaton
    (runtime/grammar_fsm.py) — xgrammar's grammar-mode capability; handles
    context-free structure (unbounded nesting) regexes cannot."""

    _shared: dict = {}

    def __init__(self, grammar: str, tokenizer, eos_token_id: int,
                 vocab_size: int):
        from tensorrt_llm_tpu_torch.runtime.grammar_fsm import (
            GrammarPDA, GrammarTokenMasks)
        # see RegexMatcher: entry pins the tokenizer against id() reuse
        key = (id(tokenizer), grammar, vocab_size)
        hit = EbnfMatcher._shared.get(key)
        if hit is None or hit[0] is not tokenizer:
            pda = GrammarPDA(grammar)
            strings, trie = _vocab_tables(tokenizer, vocab_size)
            hit = (tokenizer,
                   GrammarTokenMasks(pda, trie, eos_token_id, strings))
            EbnfMatcher._shared[key] = hit
            _bound_cache(EbnfMatcher._shared)
        self.masks = hit[1]
        self.eos = eos_token_id
        self.configs = self.masks.pda.start_configs
        self._done = False

    def allowed_tokens(self) -> Optional[np.ndarray]:
        return self.masks.allowed(self.configs)

    def advance(self, token_id: int) -> bool:
        if token_id == self.eos:
            self._done = self.masks.pda.accepting(self.configs)
            return self._done
        text = self.masks.strings[token_id] \
            if token_id < len(self.masks.strings) else None
        if not text:
            return False
        nxt = self.masks.pda.walk(self.configs, text)
        if not nxt:
            return False
        self.configs = nxt
        return True

    @property
    def completed(self) -> bool:
        return self._done or self.masks.pda.accepting(self.configs)


class StructuralTagMatcher(GrammarMatcher):
    """xgrammar-style structural tags (reference GuidedDecodingParams
    .structural_tag): generation is FREE (no mask) until one of the
    trigger strings appears in the emitted text; from there the matching
    ``begin + schema-JSON + end`` structure is mask-enforced through the
    regex DFA, then generation returns to free mode.  Triggers completed
    mid-token whose remaining characters cannot start a structure are
    treated as plain text (lenient entry) — once IN a structure, masks
    make violations unsampleable.
    """

    def __init__(self, spec, tokenizer, eos_token_id: int, vocab_size: int):
        import json as _json
        from tensorrt_llm_tpu_torch.runtime.regex_fsm import (
            _regex_escape, json_schema_to_regex)
        if isinstance(spec, str):
            spec = _json.loads(spec)
        self.triggers = list(spec.get("triggers") or [])
        structs = spec.get("structures") or []
        if not self.triggers:
            # default: each structure's begin string is its own trigger
            self.triggers = [s["begin"] for s in structs]
        alts = []
        for s in structs:
            if "begin" not in s:
                raise ValueError("structural_tag structure needs 'begin'")
            schema = s.get("schema")
            body = json_schema_to_regex(schema if schema is not None else {})
            alts.append(_regex_escape(s["begin"]) + body
                        + _regex_escape(s.get("end", "")))
        pattern = "(" + "|".join(alts) + ")" if alts else "()"
        # reuse the shared DFA/token-mask cache machinery
        self._rx = RegexMatcher(pattern, tokenizer, eos_token_id, vocab_size)
        self.eos = eos_token_id
        self.mode = "free"
        self.state = 0
        self._maxw = max((len(t) for t in self.triggers), default=1)
        self._window = ""

    def allowed_tokens(self) -> Optional[np.ndarray]:
        if self.mode == "free":
            return None
        return self._struct_allowed(self.state)

    def _struct_allowed(self, state: int) -> np.ndarray:
        """Struct-mode mask that also admits tokens which FINISH the
        structure mid-token and continue as free text (advance() accepts
        them, so the plain DFA mask — which has no transitions past accept
        — would be strictly narrower than the matcher and force the model
        to end every structure exactly on the end-string boundary)."""
        masks = self._rx.masks
        cache = getattr(masks, "_free_tail_cache", None)
        if cache is None:
            cache = masks._free_tail_cache = {}
        hit = cache.get(state)
        if hit is not None:
            return hit
        dfa = masks.dfa
        memo = getattr(masks, "_subtree_memo", None)
        if memo is None:
            memo = masks._subtree_memo = {}

        def subtree(node):
            ids = memo.get(id(node))
            if ids is None:
                ids = list(node.token_ids)
                for child in node.children.values():
                    ids.extend(subtree(child))
                memo[id(node)] = ids
            return ids

        out: list = []
        stack = [(masks.trie, state)]
        while stack:
            node, st = stack.pop()
            if dfa.accepting[st]:
                # structure closed mid-token: the remaining characters are
                # free text, so every token under this prefix is legal
                out.extend(subtree(node))
                continue
            out.extend(node.token_ids)
            for ch, child in node.children.items():
                nxt = dfa.step(st, ch)
                if nxt >= 0:
                    stack.append((child, nxt))
        arr = np.array(sorted(set(out)), np.int32)
        cache[state] = arr
        return arr

    def _feed(self, text: str) -> bool:
        dfa = self._rx.masks.dfa
        i = 0
        while i < len(text):
            ch = text[i]
            if self.mode == "free":
                self._window = (self._window + ch)[-self._maxw:]
                hit = next((t for t in self.triggers
                            if self._window.endswith(t)), None)
                if hit is not None:
                    st = dfa.walk(dfa.start, hit)
                    if st >= 0:
                        self.mode = "struct"
                        self.state = st
                        self._window = ""
                i += 1
            else:
                ns = dfa.step(self.state, ch)
                if ns < 0:
                    return False
                self.state = ns
                i += 1
                if dfa.accepting[ns]:
                    self.mode = "free"  # structure closed; back to text
        return True

    def advance(self, token_id: int) -> bool:
        if token_id == self.eos:
            return self.mode == "free"
        strings = self._rx.masks.strings
        text = strings[token_id] if token_id < len(strings) else None
        if not text:
            return self.mode == "free"  # unknown/special tokens: free only
        if self.mode == "free":
            # lenient mid-token entry: if the structure DFA rejects the
            # token's tail right after a trigger, treat THAT occurrence as
            # plain text — but keep rescanning from the next character so a
            # LATER trigger in the same token still enforces (a bulk append
            # would let it escape masking entirely)
            i = 0
            while i < len(text):
                saved = (self.mode, self.state, self._window)
                if self._feed(text[i:]):
                    return True
                self.mode, self.state, self._window = saved
                self._window = (self._window + text[i])[-self._maxw:]
                i += 1
            return True
        return self._feed(text)

    @property
    def completed(self) -> bool:
        return self.mode == "free"


def create_matcher(params: GuidedDecodingParams, tokenizer,
                   eos_token_id,
                   vocab_size: Optional[int] = None
                   ) -> Optional[GrammarMatcher]:
    if params is None:
        return None
    if tokenizer is None:
        raise ValueError("guided decoding needs a tokenizer")
    if params.choice:
        return ChoiceMatcher(params.choice, tokenizer, eos_token_id)
    if params.regex or params.json is not None or params.json_object:
        from tensorrt_llm_tpu_torch.runtime.regex_fsm import (
            json_schema_to_regex)
        if params.regex:
            pattern = params.regex
        elif params.json is not None:
            import json as _json
            schema = (params.json if isinstance(params.json, dict)
                      else _json.loads(params.json))
            pattern = json_schema_to_regex(schema)
        else:
            pattern = json_schema_to_regex({})
        vs = (vocab_size
              or len(getattr(tokenizer, "get_vocab", lambda: {})())
              or getattr(tokenizer, "vocab_size", 0))
        return RegexMatcher(pattern, tokenizer, eos_token_id, vs)
    if params.grammar:
        vs = (vocab_size
              or len(getattr(tokenizer, "get_vocab", lambda: {})())
              or getattr(tokenizer, "vocab_size", 0))
        return EbnfMatcher(params.grammar, tokenizer, eos_token_id, vs)
    if params.structural_tag:
        vs = (vocab_size
              or len(getattr(tokenizer, "get_vocab", lambda: {})())
              or getattr(tokenizer, "vocab_size", 0))
        return StructuralTagMatcher(params.structural_tag, tokenizer,
                                    eos_token_id, vs)
    raise NotImplementedError(
        "unsupported guided-decoding constraint; grammar/choice/regex/"
        "json/json_object/structural_tag are available")


class GuidedDecoder:
    """The matchers of the requests in flight, by request id; bans the
    tokens they do not allow in a batch's logits."""

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size
        self.matchers: Dict[int, GrammarMatcher] = {}

    def register(self, request_id: int, matcher: GrammarMatcher):
        self.matchers[request_id] = matcher

    def drop(self, request_id: int):
        self.matchers.pop(request_id, None)

    def has(self, request_id: int) -> bool:
        return request_id in self.matchers

    def any_active(self, reqs) -> bool:
        return any(r.request_id in self.matchers for r in reqs)

    def mask_logits(self, reqs, logits: torch.Tensor,
                    failed: Optional[dict] = None) -> torch.Tensor:
        """`logits` [B, V] with every token a constraining matcher does not
        allow moved to NEG_INF (added, as the JAX package's additive mask
        does), on the logits' device: the allowed rows are built on the
        host and go up in one upload.  A matcher that raises fails its row
        into `failed` (row -> error) when given, and its row is left
        unmasked; without `failed` it raises."""
        rows, masks = [], []
        for i, r in enumerate(reqs):
            m = self.matchers.get(r.request_id)
            try:
                allowed = None if m is None else m.allowed_tokens()
            except Exception as exc:  # noqa: BLE001 -- ends its request
                if failed is None:
                    raise
                failed[i] = f"guided decoding: {exc!r}"
                continue
            if allowed is None:
                continue
            row = np.zeros(self.vocab_size, np.bool_)
            row[allowed] = True
            rows.append(i)
            masks.append(row)
        if not rows:
            return logits
        dev = logits.device
        idx = upload(np.asarray(rows, np.int64), dev)
        sel = logits.index_select(0, idx)
        sel = torch.where(upload(np.stack(masks), dev), sel,
                          sel + float(NEG_INF))
        return logits.index_copy(0, idx, sel)

    def advance(self, req, token_id: int) -> bool:
        m = self.matchers.get(req.request_id)
        if m is None:
            return True
        return m.advance(token_id)
