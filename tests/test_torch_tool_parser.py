"""Port parity of the tool-call and reasoning parsers
(`tensorrt_llm_tpu_torch/serve/{tool,reasoning}_parser.py`) against the
JAX package's: every parser name on a corpus of texts (the cases of
`tests/test_tool_calling.py` and a few more edges), one-shot, split in two
at every offset, and fed one character at a time.  The text, reasoning and
calls (name and arguments; call ids are random) of every feed and flush
equal the JAX parser's."""

import pytest

from tensorrt_llm_tpu.serve import reasoning_parser as jrp
from tensorrt_llm_tpu.serve import tool_parser as jtp
from tensorrt_llm_tpu_torch.serve import reasoning_parser as prp
from tensorrt_llm_tpu_torch.serve import tool_parser as ptp

from test_tool_calling import (  # noqa: E402 -- the JAX tests' corpus
    DSV3, DSV31, DSV32_JSON, DSV32_XML, HARMONY, HARMONY_FINAL, KIMI,
    QCODER, QWEN_ONE, QWEN_TWO, R1_TEXT)

TOOL_CORPUS = {
    "qwen_one": QWEN_ONE, "qwen_two": QWEN_TWO, "dsv3": DSV3,
    "dsv31": DSV31, "dsv32_xml": DSV32_XML, "dsv32_json": DSV32_JSON,
    "kimi": KIMI, "qcoder": QCODER, "harmony": HARMONY,
    "harmony_final": HARMONY_FINAL,
    "plain": "No tools needed: the answer is 42.",
    "unterminated": '<tool_call>\n{"name": "f", "arguments": {"a": 1}}\n</tool',
    "bad_json": "<tool_call>{not json}</tool_call> after",
    "partial_marker_tail": "text then <tool_ca",
}
REASONING_CORPUS = {
    "r1": R1_TEXT, "tags": "pre<think>inner thought</think>post",
    "two_blocks": "<think>a</think>b<think>c</think>d",
    "unterminated": "<think>still thinking",
    "partial_tail": "answer</thi", "plain": "nothing to split",
}


def events(parser, pieces):
    """Each feed's and the flush's (text, reasoning, calls) for a parser
    fed `pieces`."""
    out = []
    for p in pieces:
        ev = parser.feed(p)
        out.append((ev.text, ev.reasoning,
                    [(c.name, c.arguments) for c in ev.calls]))
    ev = parser.flush()
    out.append((ev.text, ev.reasoning,
                [(c.name, c.arguments) for c in ev.calls]))
    return out


def test_registries_match():
    assert sorted(ptp._PARSERS) == sorted(jtp._PARSERS)
    assert len(ptp._PARSERS) == 11
    assert sorted(prp._PARSERS) == sorted(jrp._PARSERS)
    assert ptp.get_tool_parser(None) is None
    for bad in ("nope", "QWEN4"):
        with pytest.raises(ValueError):
            ptp.get_tool_parser(bad)
        with pytest.raises(ValueError):
            prp.get_reasoning_parser(bad)


@pytest.mark.parametrize("text_name", sorted(TOOL_CORPUS))
@pytest.mark.parametrize("name", sorted(jtp._PARSERS))
def test_tool_parser_matches_jax(name, text_name):
    text = TOOL_CORPUS[text_name]
    j, p = jtp.get_tool_parser(name), ptp.get_tool_parser(name)
    assert type(p).__name__ == type(j).__name__
    a, b = j.parse_full(text), p.parse_full(text)
    assert (b.text, b.reasoning, [(c.name, c.arguments) for c in b.calls]) \
        == (a.text, a.reasoning, [(c.name, c.arguments) for c in a.calls])
    assert [c.to_openai(i)["function"] for i, c in enumerate(b.calls)] == \
        [c.to_openai(i)["function"] for i, c in enumerate(a.calls)]
    for k in range(len(text) + 1):
        pieces = [text[:k], text[k:]]
        assert events(ptp.get_tool_parser(name), pieces) == \
            events(jtp.get_tool_parser(name), pieces), k
    chars = list(text)
    assert events(ptp.get_tool_parser(name), chars) == \
        events(jtp.get_tool_parser(name), chars)


@pytest.mark.parametrize("text_name", sorted(REASONING_CORPUS))
@pytest.mark.parametrize("name", sorted(jrp._PARSERS))
def test_reasoning_parser_matches_jax(name, text_name):
    text = REASONING_CORPUS[text_name]

    def run(mod, pieces):
        r = mod.get_reasoning_parser(name)
        out = []
        for piece in pieces:
            d = r.feed(piece)
            out.append((d.content, d.reasoning))
        d = r.flush()
        return out + [(d.content, d.reasoning)]

    a = jrp.get_reasoning_parser(name).parse_full(text)
    b = prp.get_reasoning_parser(name).parse_full(text)
    assert (b.content, b.reasoning) == (a.content, a.reasoning)
    for k in range(len(text) + 1):
        pieces = [text[:k], text[k:]]
        assert run(prp, pieces) == run(jrp, pieces), k
    assert run(prp, list(text)) == run(jrp, list(text))
