"""EBNF (GBNF) grammar -> pushdown-automaton constrained decoding.

The port's own copy of `tensorrt_llm_tpu/runtime/grammar_fsm.py` (numpy
only).
Counterpart of the reference's xgrammar EBNF support (`guided_decoder.py`
backends GuidedDecodingConfig.GuidedDecodingBackend.XGRAMMAR with
`grammar` constraints): context-free grammars — which regexes cannot
express (unbounded nesting) — are matched with a recursive transition
network: each rule compiles to a small NFA whose edges are character
classes or CALLS to other rules, and the matcher simulates the resulting
pushdown automaton nondeterministically as a set of
``(rule, node, call-stack)`` configurations.

Grammar syntax (the llama.cpp GBNF dialect xgrammar also accepts)::

    root  ::= "{" pair ("," pair)* "}"
    pair  ::= string ":" value
    string ::= "\"" [a-z]* "\""
    # comments run to end of line

Rule bodies support: "literals" (with \\n \\t \\" \\\\ escapes), character
classes ``[a-z0-9]`` / ``[^"]``, grouping ``( )``, alternation ``|``, and
the ``* + ?`` and ``{m} {m,} {m,n}`` quantifiers.

Token masks come from the same vocab-trie product walk as the regex engine
(`regex_fsm.TokenMaskCache`), with the DFA state replaced by a
configuration set; mask results are memoized per configuration set, which
hits constantly for grammars with repetitive structure (whitespace loops,
list items).
"""

from __future__ import annotations

from typing import Dict, FrozenSet, List, Optional, Tuple

import numpy as np

from tensorrt_llm_tpu_torch.runtime.regex_fsm import MAX_CP, _esc_ranges, _norm

# one PDA configuration: (rule id, node id, call stack of (rule, return))
Config = Tuple[int, int, Tuple[Tuple[int, int], ...]]

MAX_CONFIGS = 4096   # breadth cap (ambiguous grammars)
MAX_STACK = 128      # nesting-depth cap


# ---------------------------------------------------------------- parsing ---
class _EbnfParser:
    """GBNF text -> {rule: AST}.  AST reuses the regex node shapes plus
    ("ref", rule_name)."""

    def __init__(self, text: str):
        self.text = text

    def parse(self) -> Dict[str, tuple]:
        rules: Dict[str, tuple] = {}
        # strip comments, join continuation lines
        lines = []
        for raw in self.text.splitlines():
            line = self._strip_comment(raw)
            if line.strip():
                lines.append(line)
        blob = "\n".join(lines)
        # split on rule headers
        import re as _re
        heads = list(_re.finditer(r"(?m)^\s*([A-Za-z_][\w-]*)\s*::=", blob))
        if not heads:
            raise ValueError("no grammar rules found")
        for i, m in enumerate(heads):
            body = blob[m.end(): heads[i + 1].start() if i + 1 < len(heads)
                        else len(blob)]
            rules[m.group(1)] = _RhsParser(body.strip()).parse()
        return rules

    @staticmethod
    def _strip_comment(line: str) -> str:
        out = []
        in_str = in_cls = False
        i = 0
        while i < len(line):
            c = line[i]
            if c == "\\" and (in_str or in_cls):
                out.append(line[i:i + 2])
                i += 2
                continue
            if c == '"' and not in_cls:
                in_str = not in_str
            elif c == "[" and not in_str:
                in_cls = True
            elif c == "]" and not in_str:
                in_cls = False
            elif c == "#" and not in_str and not in_cls:
                break
            out.append(c)
            i += 1
        return "".join(out)


class _RhsParser:
    """One rule body -> AST (recursive descent, whitespace-insensitive)."""

    def __init__(self, s: str):
        self.s = s
        self.i = 0

    def parse(self):
        node = self._alt()
        self._ws()
        if self.i != len(self.s):
            raise ValueError(f"grammar parse error at {self.i}: {self.s!r}")
        return node

    def _ws(self):
        while self.i < len(self.s) and self.s[self.i] in " \t\n\r":
            self.i += 1

    def _peek(self):
        self._ws()
        return self.s[self.i] if self.i < len(self.s) else None

    def _alt(self):
        branches = [self._cat()]
        while self._peek() == "|":
            self.i += 1
            branches.append(self._cat())
        return branches[0] if len(branches) == 1 else ("alt", branches)

    def _cat(self):
        items = []
        while True:
            c = self._peek()
            if c in (None, "|", ")"):
                break
            items.append(self._rep())
        if not items:
            return ("eps",)
        return items[0] if len(items) == 1 else ("cat", items)

    def _rep(self):
        node = self._atom()
        while True:
            c = self.s[self.i] if self.i < len(self.s) else None
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
                j = self.s.index("}", self.i)
                spec = self.s[self.i + 1:j]
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
        c = self._peek()
        if c == "(":
            self.i += 1
            node = self._alt()
            assert self._peek() == ")", "unbalanced group"
            self.i += 1
            return node
        if c == '"':
            return self._literal()
        if c == "[":
            return self._class()
        if c == ".":
            self.i += 1
            from tensorrt_llm_tpu_torch.runtime.regex_fsm import _negate
            return ("cls", _negate(((10, 10),)))
        # rule reference
        j = self.i
        while j < len(self.s) and (self.s[j].isalnum()
                                   or self.s[j] in "_-"):
            j += 1
        if j == self.i:
            raise ValueError(f"unexpected char {c!r} at {self.i}")
        name = self.s[self.i:j]
        self.i = j
        return ("ref", name)

    def _literal(self):
        assert self.s[self.i] == '"'
        self.i += 1
        items = []
        while self.s[self.i] != '"':
            c = self.s[self.i]
            if c == "\\":
                self.i += 1
                esc = self.s[self.i]
                ch = {"n": "\n", "t": "\t", "r": "\r", '"': '"',
                      "\\": "\\"}.get(esc, esc)
                items.append(("cls", ((ord(ch), ord(ch)),)))
            else:
                items.append(("cls", ((ord(c), ord(c)),)))
            self.i += 1
        self.i += 1
        if not items:
            return ("eps",)
        return items[0] if len(items) == 1 else ("cat", items)

    def _class(self):
        from tensorrt_llm_tpu_torch.runtime.regex_fsm import _negate
        assert self.s[self.i] == "["
        self.i += 1
        neg = self.s[self.i] == "^"
        if neg:
            self.i += 1
        ranges: List[Tuple[int, int]] = []
        while self.s[self.i] != "]":
            c = self.s[self.i]
            if c == "\\":
                self.i += 2
                ranges.extend(_esc_ranges(self.s[self.i - 1]))
                continue
            self.i += 1
            if self.i + 1 < len(self.s) and self.s[self.i] == "-" \
                    and self.s[self.i + 1] != "]":
                hi = self.s[self.i + 1]
                self.i += 2
                ranges.append((ord(c), ord(hi)))
            else:
                ranges.append((ord(c), ord(c)))
        self.i += 1
        r = _norm(ranges)
        return ("cls", _negate(r) if neg else r)


# ---------------------------------------------------------------- RTN -------
class _RuleNfa:
    """NFA for one rule: eps edges, char-class edges, and rule-call edges."""

    def __init__(self):
        self.eps: List[List[int]] = []
        self.cls: List[List[Tuple[tuple, int]]] = []
        self.calls: List[List[Tuple[str, int]]] = []

    def state(self) -> int:
        self.eps.append([])
        self.cls.append([])
        self.calls.append([])
        return len(self.eps) - 1

    def build(self, node, src: int, dst: int):
        kind = node[0]
        if kind == "eps":
            self.eps[src].append(dst)
        elif kind == "cls":
            self.cls[src].append((node[1], dst))
        elif kind == "ref":
            self.calls[src].append((node[1], dst))
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
            if hi is None:
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


class GrammarPDA:
    """The compiled grammar: per-rule NFAs + nondeterministic PDA stepping
    over configuration sets."""

    def __init__(self, grammar: str, root: str = "root"):
        asts = _EbnfParser(grammar).parse()
        if root not in asts:
            raise ValueError(f"grammar has no '{root}' rule")
        self.rule_ids = {name: i for i, name in enumerate(asts)}
        self.nfas: List[_RuleNfa] = []
        self.starts: List[int] = []
        self.accepts: List[int] = []
        for name, ast in asts.items():
            nfa = _RuleNfa()
            s0, s1 = nfa.state(), nfa.state()
            nfa.build(ast, s0, s1)
            self.nfas.append(nfa)
            self.starts.append(s0)
            self.accepts.append(s1)
        self.root = self.rule_ids[root]
        self.start_configs = self.closure(
            frozenset({(self.root, self.starts[self.root], ())}))

    # ---- PDA stepping ---------------------------------------------------------
    def closure(self, configs: FrozenSet[Config]) -> FrozenSet[Config]:
        """Expand epsilon edges, rule calls (push) and rule accepts (pop)."""
        stack = list(configs)
        seen = set(configs)
        while stack and len(seen) < MAX_CONFIGS:
            r, n, st = stack.pop()
            nfa = self.nfas[r]
            for t in nfa.eps[n]:
                c = (r, t, st)
                if c not in seen:
                    seen.add(c)
                    stack.append(c)
            for rule_name, ret in nfa.calls[n]:
                q = self.rule_ids[rule_name]
                if len(st) < MAX_STACK:
                    c = (q, self.starts[q], st + ((r, ret),))
                    if c not in seen:
                        seen.add(c)
                        stack.append(c)
            if n == self.accepts[r] and st:
                pr, pn = st[-1]
                c = (pr, pn, st[:-1])
                if c not in seen:
                    seen.add(c)
                    stack.append(c)
        return frozenset(seen)

    def step(self, configs: FrozenSet[Config], ch: str
             ) -> FrozenSet[Config]:
        """Consume one character; empty set = dead."""
        cp = ord(ch)
        nxt = set()
        for r, n, st in configs:
            for ranges, t in self.nfas[r].cls[n]:
                if any(lo <= cp <= hi for lo, hi in ranges):
                    nxt.add((r, t, st))
        if not nxt:
            return frozenset()
        return self.closure(frozenset(nxt))

    def walk(self, configs: FrozenSet[Config], text: str
             ) -> FrozenSet[Config]:
        for ch in text:
            configs = self.step(configs, ch)
            if not configs:
                break
        return configs

    def accepting(self, configs: FrozenSet[Config]) -> bool:
        return any(r == self.root and n == self.accepts[r] and not st
                   for r, n, st in configs)

    def matches(self, text: str) -> bool:
        return self.accepting(self.walk(self.start_configs, text))


class GrammarTokenMasks:
    """Allowed-token sets for a configuration set via the vocab-trie
    product walk (memoized — grammars loop through the same configuration
    sets constantly)."""

    def __init__(self, pda: GrammarPDA, trie, eos_token_id: Optional[int],
                 strings: List[Optional[str]]):
        self.pda = pda
        self.trie = trie
        self.eos = eos_token_id
        self.strings = strings
        self._cache: Dict[FrozenSet[Config], np.ndarray] = {}

    def allowed(self, configs: FrozenSet[Config]) -> np.ndarray:
        hit = self._cache.get(configs)
        if hit is not None:
            return hit
        out: List[int] = []
        stack = [(self.trie, configs)]
        while stack:
            node, cfgs = stack.pop()
            out.extend(node.token_ids)
            for ch, child in node.children.items():
                nxt = self.pda.step(cfgs, ch)
                if nxt:
                    stack.append((child, nxt))
        if self.pda.accepting(configs) and self.eos is not None:
            out.append(self.eos)
        arr = np.array(sorted(set(out)), np.int32)
        if len(self._cache) < 512:
            self._cache[configs] = arr
        return arr
