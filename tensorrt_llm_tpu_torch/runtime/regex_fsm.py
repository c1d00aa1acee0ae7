"""Regex -> DFA constrained decoding (the xgrammar/llguidance analog).

The port's own copy of `tensorrt_llm_tpu/runtime/regex_fsm.py` (numpy
only).  The reference guides decoding with xgrammar token bitmasks
(`pyexecutor/guided_decoder.py` + `kernels/logitsBitmask.cu`); neither
xgrammar nor llguidance is a dependency, so this module implements the
same capability from scratch, outlines-style:

  regex  --Thompson-->  NFA  --subset construction-->  DFA over character
  intervals  --vocab trie walk-->  per-DFA-state allowed-token sets

A JSON Schema (common subset) or a bare `json_object` constraint compiles to
a regex first (`json_schema_to_regex`).  Token masks are memoized per DFA
state; computing one is a trie x DFA product walk, so shared token prefixes
are pruned once.

Supported regex subset: literals, escapes (\\d \\w \\s \\n \\t \\\\ etc.),
character classes [a-z0-9_] and negations [^"], '.', alternation '|',
grouping '()', quantifiers * + ? {m} {m,} {m,n}.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------- charsets --
MAX_CP = 0x10FFFF


def _norm(ranges: List[Tuple[int, int]]) -> Tuple[Tuple[int, int], ...]:
    rs = sorted((lo, hi) for lo, hi in ranges if lo <= hi)
    out = []
    for lo, hi in rs:
        if out and lo <= out[-1][1] + 1:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return tuple(out)


def _negate(ranges) -> Tuple[Tuple[int, int], ...]:
    out, cur = [], 0
    for lo, hi in ranges:
        if cur < lo:
            out.append((cur, lo - 1))
        cur = hi + 1
    if cur <= MAX_CP:
        out.append((cur, MAX_CP))
    return tuple(out)


_ESCAPES = {
    "d": (("0", "9"),),
    "w": (("a", "z"), ("A", "Z"), ("0", "9"), ("_", "_")),
    "s": ((" ", " "), ("\t", "\t"), ("\n", "\n"), ("\r", "\r"),
          ("\f", "\f"), ("\v", "\v")),
}


def _esc_ranges(ch: str):
    if ch in _ESCAPES:
        return _norm([(ord(a), ord(b)) for a, b in _ESCAPES[ch]])
    if ch in "DWS":
        return _negate(_esc_ranges(ch.lower()))
    lit = {"n": "\n", "t": "\t", "r": "\r", "f": "\f", "v": "\v",
           "0": "\0"}.get(ch, ch)
    return ((ord(lit), ord(lit)),)


# ---------------------------------------------------------------- parsing ---
class _Parser:
    """Recursive-descent regex parser -> AST.

    AST nodes: ("cls", ranges) | ("cat", [..]) | ("alt", [..])
             | ("rep", node, min, max|None) | ("eps",)
    """

    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0

    def parse(self):
        node = self._alt()
        if self.i != len(self.p):
            raise ValueError(f"regex parse error at {self.i}: {self.p!r}")
        return node

    def _peek(self):
        return self.p[self.i] if self.i < len(self.p) else None

    def _alt(self):
        branches = [self._cat()]
        while self._peek() == "|":
            self.i += 1
            branches.append(self._cat())
        return branches[0] if len(branches) == 1 else ("alt", branches)

    def _cat(self):
        items = []
        while self._peek() not in (None, "|", ")"):
            items.append(self._rep())
        if not items:
            return ("eps",)
        return items[0] if len(items) == 1 else ("cat", items)

    def _rep(self):
        node = self._atom()
        while True:
            c = self._peek()
            if c == "*":
                self.i += 1
                node = ("rep", node, 0, None)
            elif c == "+":
                self.i += 1
                node = ("rep", node, 1, None)
            elif c == "?":
                self.i += 1
                node = ("rep", node, 0, 1)
            elif c == "{":
                j = self.p.index("}", self.i)
                spec = self.p[self.i + 1:j]
                self.i = j + 1
                if "," in spec:
                    lo, hi = spec.split(",", 1)
                    node = ("rep", node, int(lo or 0),
                            int(hi) if hi else None)
                else:
                    node = ("rep", node, int(spec), int(spec))
            else:
                return node

    def _atom(self):
        c = self.p[self.i]
        if c == "(":
            self.i += 1
            node = self._alt()
            assert self._peek() == ")", "unbalanced group"
            self.i += 1
            return node
        if c == "[":
            return self._class()
        if c == ".":
            self.i += 1
            return ("cls", _negate(((10, 10),)))  # any char but newline
        if c == "\\":
            self.i += 2
            return ("cls", _esc_ranges(self.p[self.i - 1]))
        self.i += 1
        return ("cls", ((ord(c), ord(c)),))

    def _class(self):
        assert self.p[self.i] == "["
        self.i += 1
        neg = self._peek() == "^"
        if neg:
            self.i += 1
        ranges: List[Tuple[int, int]] = []
        while self._peek() != "]":
            c = self.p[self.i]
            if c == "\\":
                self.i += 2
                ranges.extend(_esc_ranges(self.p[self.i - 1]))
                continue
            self.i += 1
            if self._peek() == "-" and self.i + 1 < len(self.p) \
                    and self.p[self.i + 1] != "]":
                hi = self.p[self.i + 1]
                self.i += 2
                ranges.append((ord(c), ord(hi)))
            else:
                ranges.append((ord(c), ord(c)))
        self.i += 1  # ]
        r = _norm(ranges)
        return ("cls", _negate(r) if neg else r)


# ---------------------------------------------------------------- NFA -------
class _NFA:
    def __init__(self):
        self.eps: List[List[int]] = []
        self.edges: List[List[Tuple[Tuple[Tuple[int, int], ...], int]]] = []

    def state(self) -> int:
        self.eps.append([])
        self.edges.append([])
        return len(self.eps) - 1

    def build(self, node, src: int, dst: int):
        kind = node[0]
        if kind == "eps":
            self.eps[src].append(dst)
        elif kind == "cls":
            self.edges[src].append((node[1], dst))
        elif kind == "cat":
            cur = src
            for item in node[1][:-1]:
                nxt = self.state()
                self.build(item, cur, nxt)
                cur = nxt
            self.build(node[1][-1], cur, dst)
        elif kind == "alt":
            for b in node[1]:
                self.build(b, src, dst)
        elif kind == "rep":
            _, inner, lo, hi = node
            cur = src
            for _ in range(lo):
                nxt = self.state()
                self.build(inner, cur, nxt)
                cur = nxt
            if hi is None:                       # unbounded tail
                loop = self.state()
                self.eps[cur].append(loop)
                self.build(inner, loop, loop)
                self.eps[loop].append(dst)
            else:
                self.eps[cur].append(dst)
                for _ in range(hi - lo):
                    nxt = self.state()
                    self.build(inner, cur, nxt)
                    self.eps[nxt].append(dst)
                    cur = nxt
        else:
            raise ValueError(kind)


class DFA:
    """Deterministic automaton over character intervals."""

    def __init__(self, pattern: str):
        ast = _Parser(pattern).parse()
        nfa = _NFA()
        s0, s1 = nfa.state(), nfa.state()
        nfa.build(ast, s0, s1)
        self._nfa, self._accept = nfa, s1

        # interval alphabet: all boundaries across all NFA edges
        points = {0, MAX_CP + 1}
        for edges in nfa.edges:
            for ranges, _ in edges:
                for lo, hi in ranges:
                    points.add(lo)
                    points.add(hi + 1)
        cuts = sorted(points)
        self.intervals = [(cuts[i], cuts[i + 1] - 1)
                          for i in range(len(cuts) - 1)]
        self._lo = np.array([iv[0] for iv in self.intervals])

        def closure(states):
            stack, seen = list(states), set(states)
            while stack:
                s = stack.pop()
                for t in nfa.eps[s]:
                    if t not in seen:
                        seen.add(t)
                        stack.append(t)
            return frozenset(seen)

        start = closure({s0})
        self.trans: List[Dict[int, int]] = []   # state -> {interval: state}
        self.accepting: List[bool] = []
        index = {start: 0}
        self.trans.append({})
        self.accepting.append(s1 in start)
        work = [start]
        order = [start]
        while work:
            cur = work.pop()
            ci = index[cur]
            for k, (lo, hi) in enumerate(self.intervals):
                nxt = set()
                for s in cur:
                    for ranges, t in nfa.edges[s]:
                        if any(rlo <= lo and hi <= rhi
                               for rlo, rhi in ranges):
                            nxt.add(t)
                if not nxt:
                    continue
                nc = closure(nxt)
                if nc not in index:
                    index[nc] = len(self.trans)
                    self.trans.append({})
                    self.accepting.append(s1 in nc)
                    work.append(nc)
                    order.append(nc)
                self.trans[ci][k] = index[nc]
        self.start = 0

    def _sym(self, ch: str) -> int:
        return int(np.searchsorted(self._lo, ord(ch), side="right")) - 1

    def step(self, state: int, ch: str) -> int:
        """-1 = dead."""
        return self.trans[state].get(self._sym(ch), -1)

    def walk(self, state: int, text: str) -> int:
        for ch in text:
            state = self.trans[state].get(self._sym(ch), -1)
            if state < 0:
                return -1
        return state

    def matches(self, text: str) -> bool:
        s = self.walk(self.start, text)
        return s >= 0 and self.accepting[s]


# ---------------------------------------------------------------- vocab -----
class _Trie:
    __slots__ = ("children", "token_ids")

    def __init__(self):
        self.children: Dict[str, "_Trie"] = {}
        self.token_ids: List[int] = []


def token_strings(tokenizer, vocab_size: int) -> List[Optional[str]]:
    """Best-effort per-token surface strings (byte-BPE Ġ/Ċ and
    sentencepiece ▁ conventions normalized)."""
    try:
        toks = tokenizer.convert_ids_to_tokens(list(range(vocab_size)))
    except Exception:  # noqa: BLE001
        toks = [None] * vocab_size
        for i in range(vocab_size):
            try:
                toks[i] = tokenizer.decode([i])
            except Exception:  # noqa: BLE001
                pass
    special = set(getattr(tokenizer, "all_special_ids", []) or [])
    out: List[Optional[str]] = []
    for i, t in enumerate(toks):
        if t is None or i in special:
            out.append(None)
            continue
        out.append(t.replace("Ġ", " ").replace("Ċ", "\n")
                   .replace("ĉ", "\t").replace("▁", " "))
    return out


def build_vocab_trie(strings: List[Optional[str]]) -> _Trie:
    root = _Trie()
    for tid, s in enumerate(strings):
        if not s:
            continue
        node = root
        for ch in s:
            node = node.children.setdefault(ch, _Trie())
        node.token_ids.append(tid)
    return root


class TokenMaskCache:
    """Per-DFA-state allowed-token sets via a trie x DFA product walk."""

    def __init__(self, dfa: DFA, trie: _Trie, eos_token_id: Optional[int],
                 strings: Optional[List[Optional[str]]] = None):
        self.dfa = dfa
        self.trie = trie
        self.eos = eos_token_id
        self.strings = strings  # token id -> surface text (advance walks)
        self._cache: Dict[int, np.ndarray] = {}

    def allowed(self, state: int) -> np.ndarray:
        hit = self._cache.get(state)
        if hit is not None:
            return hit
        out: List[int] = []
        stack = [(self.trie, state)]
        while stack:
            node, st = stack.pop()
            out.extend(node.token_ids)
            for ch, child in node.children.items():
                nxt = self.dfa.step(st, ch)
                if nxt >= 0:
                    stack.append((child, nxt))
        # the root's token_ids are empty; tokens collected above all KEEP a
        # live DFA path.  EOS only once the regex fully matches.
        out = [t for t in out]
        if self.dfa.accepting[state] and self.eos is not None:
            out.append(self.eos)
        arr = np.array(sorted(set(out)), np.int32)
        self._cache[state] = arr
        return arr


# ---------------------------------------------------------------- schema ----
_STRING_RE = r'"([^"\\]|\\["\\/bfnrtu])*"'
_INT_RE = r"(-?(0|[1-9][0-9]*))"
_NUM_RE = r"(-?(0|[1-9][0-9]*)(\.[0-9]+)?([eE][+-]?[0-9]+)?)"
_BOOL_RE = r"(true|false)"
_NULL_RE = r"null"


def _regex_escape(s: str) -> str:
    out = []
    for ch in s:
        if ch in r"\.[]{}()*+?|^$/":
            out.append("\\" + ch)
        else:
            out.append(ch)
    return "".join(out)


def _json_value_regex(depth: int) -> str:
    """Generic JSON value, recursion depth-limited."""
    scalar = f"({_STRING_RE}|{_NUM_RE}|{_BOOL_RE}|{_NULL_RE})"
    if depth <= 0:
        return scalar
    inner = _json_value_regex(depth - 1)
    arr = rf"\[({inner}(,{inner})*)?\]"
    obj = rf"\{{({_STRING_RE}:{inner}(,{_STRING_RE}:{inner})*)?\}}"
    return f"({scalar}|{arr}|{obj})"


# --- integer-bound digit regexes (xgrammar compiles numeric bounds the
# --- same way: a digit-position DFA over canonical JSON integers) ---------
def _rep09(k: int) -> str:
    return "" if k <= 0 else ("[0-9]" if k == 1 else f"[0-9]{{{k}}}")


def _crange(a: str, b: str) -> str:
    return a if a == b else f"[{a}-{b}]"


def _dig_ge(s: str) -> str:
    """Digit strings of len(s) that are numerically >= s."""
    if not s:
        return ""
    c, rest = s[0], s[1:]
    alts = [c + _dig_ge(rest)]
    if c < "9":
        alts.append(_crange(chr(ord(c) + 1), "9") + _rep09(len(rest)))
    return alts[0] if len(alts) == 1 else "(" + "|".join(alts) + ")"


def _dig_le(s: str) -> str:
    """Digit strings of len(s) that are numerically <= s."""
    if not s:
        return ""
    c, rest = s[0], s[1:]
    alts = [c + _dig_le(rest)]
    if c > "0":
        alts.append(_crange("0", chr(ord(c) - 1)) + _rep09(len(rest)))
    return alts[0] if len(alts) == 1 else "(" + "|".join(alts) + ")"


def _dig_between(lo: str, hi: str) -> str:
    """Digit strings of len(lo)==len(hi) in [lo, hi]."""
    if lo == hi:
        return lo
    c1, c2 = lo[0], hi[0]
    if c1 == c2:
        return c1 + _dig_between(lo[1:], hi[1:])
    alts = [c1 + _dig_ge(lo[1:])]
    if ord(c2) - ord(c1) > 1:
        alts.append(_crange(chr(ord(c1) + 1), chr(ord(c2) - 1))
                    + _rep09(len(lo) - 1))
    alts.append(c2 + _dig_le(hi[1:]))
    return "(" + "|".join(alts) + ")"


def _uint_range(lo: int, hi: Optional[int]) -> str:
    """Canonical (no leading zero) non-negative integers in [lo, hi]."""
    lo = max(lo, 0)
    alts = []
    if lo == 0:
        alts.append("0")
        lo = 1
    if hi is not None and hi < lo:
        return "(" + "|".join(alts) + ")" if alts else "()"
    ls = str(lo)
    if hi is None:
        alts.append(_dig_between(ls, "9" * len(ls)))
        alts.append(f"[1-9]{_rep09(len(ls))}[0-9]*")
    else:
        hs = str(hi)
        if len(ls) == len(hs):
            alts.append(_dig_between(ls, hs))
        else:
            alts.append(_dig_between(ls, "9" * len(ls)))
            for d in range(len(ls) + 1, len(hs)):
                alts.append("[1-9]" + _rep09(d - 1))
            alts.append(_dig_between("1" + "0" * (len(hs) - 1), hs))
    return "(" + "|".join(alts) + ")"


def _int_range_regex(lo: Optional[int], hi: Optional[int]) -> str:
    """Canonical JSON integers in [lo, hi]; either bound may be None."""
    if lo is None and hi is None:
        return _INT_RE
    alts = []
    # negative magnitudes m in [max(1, -hi), -lo]
    if lo is None or lo <= -1:
        nhi = None if lo is None else -lo
        nlo = 1 if hi is None or hi >= -1 else -hi
        if nhi is None or nlo <= nhi:
            alts.append("-" + _uint_range(nlo, nhi))
    # non-negative part [max(0, lo), hi]
    if hi is None or hi >= 0:
        alts.append(_uint_range(0 if lo is None else max(lo, 0), hi))
    return "(" + "|".join(alts) + ")" if alts else "()"


def _strip_anchors(pattern: str) -> str:
    if pattern.startswith("^"):
        pattern = pattern[1:]
    if pattern.endswith("$") and not pattern.endswith("\\$"):
        pattern = pattern[:-1]
    return pattern


def _resolve_ref(ref: str, root: dict):
    """Resolve an internal '#/...' JSON pointer against the root schema."""
    if not ref.startswith("#"):
        raise ValueError(f"only internal $refs supported: {ref!r}")
    node = root
    for part in ref.lstrip("#/").split("/"):
        if not part:
            continue
        part = part.replace("~1", "/").replace("~0", "~")
        node = node[part]
    return node


def _merge_allof(schema: dict) -> dict:
    """Shallow allOf merge: combine properties/required/type of branches.
    Numeric bounds intersect (max of minimums / min of maximums); other
    conflicting same-key constraints keep the tighter-looking first value
    and log, rather than silently over-admitting (ADVICE r3)."""
    merged = {k: v for k, v in schema.items() if k != "allOf"}
    _lo_keys = ("minimum", "exclusiveMinimum", "minLength", "minItems")
    _hi_keys = ("maximum", "exclusiveMaximum", "maxLength", "maxItems")
    for sub in schema["allOf"]:
        for k, v in sub.items():
            if k == "properties":
                merged.setdefault("properties", {})
                merged["properties"] = {**merged["properties"], **v}
            elif k == "required":
                merged["required"] = sorted(
                    set(merged.get("required", [])) | set(v))
            elif k not in merged:
                merged[k] = v
            elif merged[k] != v:
                if k in _lo_keys and isinstance(v, (int, float)) \
                        and not isinstance(v, bool):
                    merged[k] = max(merged[k], v)
                elif k in _hi_keys and isinstance(v, (int, float)) \
                        and not isinstance(v, bool):
                    merged[k] = min(merged[k], v)
                else:
                    from tensorrt_llm_tpu_torch.utils import logger
                    logger.warning(
                        "allOf merge: conflicting %r constraints "
                        "(%r vs %r); keeping the first", k, merged[k], v)
    return merged


def json_schema_to_regex(schema: dict, depth: int = 3,
                         root: Optional[dict] = None,
                         ref_depth: int = 16) -> str:
    """JSON Schema -> canonical compact-JSON regex (the xgrammar analog;
    reference inherits this from xgrammar,
    tensorrt_llm/_torch/pyexecutor/guided_decoder.py:156-161).

    Supports: type string/integer/number/boolean/null/object/array, enum,
    const, anyOf/oneOf (alternation), allOf (shallow merge), internal
    $ref/$defs/definitions (expansion bounded by `ref_depth`; past the
    bound a generic-JSON superset regex terminates recursion), object
    properties in declaration order with non-`required` ones omissible,
    `additionalProperties` as a schema when no properties are declared,
    string pattern (anchors stripped; matched against the *encoded* text,
    so ASCII-safe patterns only) / minLength / maxLength, integer
    minimum/maximum/exclusive bounds via digit-range regexes, arrays with
    items + minItems/maxItems + prefixItems.  `format` is not enforced
    (plain string)."""
    import json as _json

    if root is None:
        root = schema if isinstance(schema, dict) else {}

    def rec(s, d, rd=ref_depth):
        return json_schema_to_regex(s, d, root=root, ref_depth=rd)

    if schema is True or schema == {} or schema is None:
        return _json_value_regex(depth)
    if schema is False:
        # boolean schema False = match nothing; legal inside anyOf etc.
        raise ValueError("unsatisfiable schema: `false` admits no value")
    if "$ref" in schema:
        if ref_depth <= 0:
            return _json_value_regex(1)
        target = _resolve_ref(schema["$ref"], root)
        extra = {k: v for k, v in schema.items() if k != "$ref"}
        return rec({**target, **extra} if extra else target, depth,
                   ref_depth - 1)
    if "allOf" in schema:
        return rec(_merge_allof(schema), depth)
    if "anyOf" in schema or "oneOf" in schema:
        branches = schema.get("anyOf", []) + schema.get("oneOf", [])
        parts = []
        for b in branches:
            try:
                parts.append(rec(b, depth))
            except ValueError:
                continue  # unsatisfiable branch (`false` schema): drop it
        if not parts:
            raise ValueError("unsatisfiable schema: every branch is `false`")
        return "(" + "|".join(parts) + ")"
    if "enum" in schema:
        opts = "|".join(_regex_escape(_json.dumps(v, separators=(",", ":")))
                        for v in schema["enum"])
        return f"({opts})"
    if "const" in schema:
        return _regex_escape(
            _json.dumps(schema["const"], separators=(",", ":")))
    t = schema.get("type")
    if isinstance(t, list):
        return "(" + "|".join(
            rec({**schema, "type": tt}, depth) for tt in t) + ")"
    if t == "string":
        if "pattern" in schema:
            # group the pattern: a top-level alternation ("cat|dog") must not
            # escape the quote literals (ADVICE r3)
            return '"(' + _strip_anchors(schema["pattern"]) + ')"'
        lo = schema.get("minLength")
        hi = schema.get("maxLength")
        if lo is not None or hi is not None:
            char = r'([^"\\]|\\["\\/bfnrtu])'
            lo = lo or 0
            quant = (f"{{{lo},}}" if hi is None else f"{{{lo},{hi}}}")
            return f'"{char}{quant}"'
        return _STRING_RE
    if t == "integer":
        import math as _math
        lo = schema.get("minimum")
        hi = schema.get("maximum")
        # exclusive bounds: draft-2019 numeric form, or draft-4 boolean
        # (applies to the sibling minimum/maximum); non-integer bounds use
        # floor/ceil semantics (exclusiveMaximum: 10.5 admits 10)
        em = schema.get("exclusiveMinimum")
        if em is True:
            lo = None if lo is None else int(_math.floor(lo)) + 1
        elif isinstance(em, (int, float)) and not isinstance(em, bool):
            lo = int(_math.floor(em)) + 1
        ex = schema.get("exclusiveMaximum")
        if ex is True:
            hi = None if hi is None else int(_math.ceil(hi)) - 1
        elif isinstance(ex, (int, float)) and not isinstance(ex, bool):
            hi = int(_math.ceil(ex)) - 1
        if lo is None and hi is None:
            return _INT_RE
        return _int_range_regex(
            None if lo is None else int(lo),
            None if hi is None else int(hi))
    if t == "number":
        return _NUM_RE
    if t == "boolean":
        return _BOOL_RE
    if t == "null":
        return _NULL_RE
    if t == "array":
        if "prefixItems" in schema:
            parts = [rec(s, depth - 1) for s in schema["prefixItems"]]
            return r"\[" + ",".join(parts) + r"\]"
        item = rec(schema.get("items", {}), depth - 1)
        lo = schema.get("minItems", 0)
        hi = schema.get("maxItems")
        if hi is None:
            body = rf"({item}(,{item})*)?" if lo == 0 else \
                rf"{item}(,{item}){{{lo - 1},}}"
        else:
            if lo == 0:
                body = rf"({item}(,{item}){{0,{max(hi - 1, 0)}}})?"
            else:
                body = rf"{item}(,{item}){{{lo - 1},{hi - 1}}}"
        return rf"\[{body}\]"
    if t == "object" or "properties" in schema:
        props = schema.get("properties")
        if not props:
            ap = schema.get("additionalProperties")
            if isinstance(ap, dict) or ap is True:
                val = rec({} if ap is True else ap, depth - 1)
                member = f"{_STRING_RE}:{val}"
                return rf"\{{({member}(,{member})*)?\}}"
            return _json_value_regex(depth)
        required = set(schema.get("required", []))
        names = list(props)
        segs = []
        for name in names:
            key = _regex_escape(_json.dumps(name))
            segs.append(f"{key}:{rec(props[name], depth - 1)}")
        # members in declaration order; non-required ones omissible.  The
        # first *emitted* property carries no comma, so alternate over
        # which index comes first (every earlier one must be optional),
        # then every later property contributes ',seg' — mandatory when
        # required, '(,seg)?' otherwise.  Regex size is O(n^2) in the
        # property count; real tool schemas are small.
        def rest(i: int) -> str:
            out = []
            for j in range(i, len(names)):
                if names[j] in required:
                    out.append(f",{segs[j]}")
                else:
                    out.append(f"(,{segs[j]})?")
            return "".join(out)

        firsts = []
        for i, name in enumerate(names):
            firsts.append(segs[i] + rest(i + 1))
            if name in required:
                break  # a required prop can't be skipped past
        else:
            name = None  # all optional: object may be empty
        body = "(" + "|".join(firsts) + ")"
        if not required:
            body += "?"
        return r"\{" + body + r"\}"
    return _json_value_regex(depth)
