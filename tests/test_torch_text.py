"""Port parity for text in and text out: the tokenizer, detokenization and
streaming of `LLM(model=<HF checkpoint dir>)`.

* `IncrementalDetokenizer` against the JAX package's, on the byte-level
  and sentencepiece-like doubles of `tests/test_detokenizer.py` (copied
  here): every push, flush, the text and `find_stop` equal, and the text
  equals a one-shot decode.
* Text prompts and streaming through a real `PreTrainedTokenizerFast`
  (a byte-level BPE trained offline with `tokenizers` and saved into the
  checkpoint directory, which `LLM` loads with `AutoTokenizer`):
  `result()`'s text is `tok.decode(token_ids)`; the streamed pieces'
  token ids grow as prefixes and the last one is finished; the last
  streamed text and tokens equal `result()`'s; the eos id comes from the
  tokenizer.  A tokenizer object is taken as given.
* The refusals: a stop string without a tokenizer at submit, a text prompt
  without a tokenizer, and ``tokenizer=<path>`` with `transformers` hidden
  (ImportError).
"""

import dataclasses
import sys

import numpy as np
import pytest

from tensorrt_llm_tpu.llmapi.detokenizer import (
    IncrementalDetokenizer as JDetok)
import tensorrt_llm_tpu_torch as T
from tensorrt_llm_tpu_torch.llmapi.detokenizer import IncrementalDetokenizer

from torch_parity import write_hf_checkpoint

TEXT = "héllo 世界 🎉 — ünïcødé piñata 𝄞"


class ByteTokenizer:
    """Token id == byte value (copy of the double in
    `tests/test_detokenizer.py`)."""

    def __init__(self):
        self.calls = []

    def decode(self, ids, skip_special_tokens=True):
        self.calls.append(len(ids))
        return bytes(int(i) for i in ids).decode("utf-8", errors="replace")


class SentencePieceish:
    """'_' means a space before; a leading space is stripped (copy of the
    double in `tests/test_detokenizer.py`)."""

    VOCAB = {0: "_Hello", 1: "_world", 2: ",", 3: "_again"}

    def decode(self, ids, skip_special_tokens=True):
        text = "".join(self.VOCAB[int(i)] for i in ids).replace("_", " ")
        return text[1:] if text.startswith(" ") else text


@pytest.mark.parametrize("chunk", [1, 2, 3, 7])
@pytest.mark.parametrize("double", ["bytes", "sentencepiece"])
def test_detokenizer_matches_jax(double, chunk):
    if double == "bytes":
        tok, ids = ByteTokenizer(), list(TEXT.encode("utf-8"))
        ids += list("🎉".encode("utf-8"))[:2]    # ends mid-character
    else:
        tok, ids = SentencePieceish(), [0, 1, 2, 3, 2, 1]
    port, jax = IncrementalDetokenizer(tok), JDetok(tok)
    for i in range(0, len(ids), chunk):
        assert port.push(ids[i:i + chunk]) == jax.push(ids[i:i + chunk])
        assert port.find_stop("ll", chunk) == jax.find_stop("ll", chunk)
    assert port.flush() == jax.flush()
    assert port.text == jax.text == tok.decode(ids)


@pytest.fixture(scope="module")
def text_ckpt(tmp_path_factory):
    """A tiny Llama checkpoint with a byte-level BPE tokenizer saved beside
    it; the model's vocabulary is the tokenizer's."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers
    from tokenizers import trainers
    from transformers import PreTrainedTokenizerFast
    path = tmp_path_factory.mktemp("text_ckpt")
    bpe = Tokenizer(models.BPE())
    bpe.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    bpe.decoder = decoders.ByteLevel()
    corpus = [TEXT, "The quick brown fox jumps over the lazy dog.",
              "Checkpoints, tokenizers and streamed text " * 3,
              "a port of an inference framework to another accelerator"] * 4
    bpe.train_from_iterator(corpus, trainers.BpeTrainer(
        vocab_size=320, special_tokens=["<s>", "</s>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    tok = PreTrainedTokenizerFast(tokenizer_object=bpe, bos_token="<s>",
                                  eos_token="</s>")
    tok.save_pretrained(str(path))
    hf = dict(architectures=["LlamaForCausalLM"], model_type="llama",
              vocab_size=len(tok), hidden_size=128, intermediate_size=256,
              num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=2, max_position_embeddings=256)
    write_hf_checkpoint(path, hf, seed=3)
    return path


LLM_KW = dict(max_seq_len=96, max_batch_size=2, max_num_tokens=64,
              kv_num_blocks=40, kv_block_size=8, max_decode_steps=3,
              quant_algo="W4A16", quant_group_size=64)


@pytest.fixture(scope="module")
def text_llm(text_ckpt):
    llm = T.LLM(model=str(text_ckpt), device="cpu", **LLM_KW)
    yield llm
    llm.shutdown()


def test_text_prompts_and_streaming(text_llm):
    from transformers import AutoTokenizer
    tok = AutoTokenizer.from_pretrained(str(text_llm.args.model))
    assert text_llm.executor.eos_token_id == tok.eos_token_id is not None
    sp = T.SamplingParams(max_tokens=12, temperature=0.0, ignore_eos=True)
    prompts = [TEXT, "The quick brown fox"]
    outs = text_llm.generate(prompts, sp)
    for p, o in zip(prompts, outs):
        assert o.prompt == p and o.prompt_token_ids == tok.encode(p)
        ids = o.outputs[0].token_ids
        assert len(ids) == 12
        assert o.outputs[0].text == tok.decode(ids, skip_special_tokens=True)
    # a mixed batch: a text prompt and token ids
    mixed = text_llm.generate([TEXT, tok.encode(TEXT)], sp)
    assert mixed[0].prompt == TEXT and mixed[1].prompt is None
    assert mixed[1].prompt_token_ids == tok.encode(TEXT)
    assert [len(m.outputs[0].token_ids) for m in mixed] == [12, 12]
    for p in prompts:
        whole = text_llm.generate_async(p, sp, cache_salt="whole").result()
        pieces = list(text_llm.generate_async(p, sp, streaming=True,
                                              cache_salt="streamed"))
        assert len(pieces) > 1 and pieces[-1].finished
        assert not any(x.finished for x in pieces[:-1])
        prev = []
        for x in pieces:
            ids = x.outputs[0].token_ids
            assert ids[:len(prev)] == prev
            prev = ids
        assert prev == whole.outputs[0].token_ids
        assert pieces[-1].outputs[0].text == whole.outputs[0].text
        assert pieces[-1].prompt == p


class _ByteTok:
    """A tokenizer object: bytes as ids 3..258, eos 2."""

    eos_token_id = 2

    def encode(self, text):
        return [1] + [b + 3 for b in text.encode("utf-8")]

    def decode(self, ids, skip_special_tokens=True):
        return bytes(int(i) - 3 for i in ids if 3 <= int(i) < 259).decode(
            "utf-8", errors="replace")


def test_tokenizer_object_and_refusals(text_ckpt, monkeypatch):
    sp = T.SamplingParams(max_tokens=6, temperature=0.0, ignore_eos=True)
    tok = _ByteTok()
    llm = T.LLM(model=str(text_ckpt), tokenizer=tok, device="cpu", **LLM_KW)
    try:
        assert llm.tokenizer is tok and llm.executor.eos_token_id == 2
        out = llm.generate(TEXT, sp, cache_salt="whole")[0]
        assert out.prompt_token_ids == tok.encode(TEXT)
        assert out.outputs[0].text == tok.decode(out.outputs[0].token_ids)
        streamed = list(llm.generate_async(TEXT, sp, streaming=True,
                                           cache_salt="streamed"))
        assert streamed[-1].outputs[0].text == out.outputs[0].text
        # with a tokenizer a stop string is served: two characters of the
        # greedy text cut it where they first appear
        full = out.outputs[0]
        stop = next((full.text[i:i + 2] for i in range(len(full.text) - 1)
                     if "\ufffd" not in full.text[i:i + 2]), "\n")
        c = llm.generate(TEXT, dataclasses.replace(sp, stop=stop),
                         cache_salt="stop")[0].outputs[0]
        assert c.token_ids == full.token_ids[:len(c.token_ids)]
        assert stop not in c.text
        if stop in full.text:
            assert c.finish_reason == "stop_string"
            assert c.text == full.text[:full.text.index(stop)]
            assert stop in tok.decode(c.token_ids)
        else:
            assert c.finish_reason == "length" and c.text == full.text
    finally:
        llm.shutdown()
    ids_only = T.LLM(model=str(text_ckpt), skip_tokenizer_init=True,
                     device="cpu", **LLM_KW)
    try:
        assert ids_only.tokenizer is None
        with pytest.raises(ValueError, match="tokenizer"):
            ids_only.generate(TEXT, sp)
        with pytest.raises(ValueError, match="stop strings need a tokenizer"):
            ids_only.generate([[5, 6, 7]],
                              T.SamplingParams(max_tokens=4, stop="\n"))
        # without a tokenizer the text is empty, the token ids are served
        o = ids_only.generate([[5, 6, 7]], sp)[0]
        assert o.outputs[0].text == "" and len(o.outputs[0].token_ids) == 6
    finally:
        ids_only.shutdown()
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="transformers"):
        T.LLM(model=str(text_ckpt), device="cpu", **LLM_KW)


def test_detokenized_stream_is_byte_identical():
    """The port's streaming future on a byte tokenizer: every piece's text
    is a prefix of the final text, which equals a one-shot decode, across
    multi-byte characters split between pieces."""
    import queue
    from tensorrt_llm_tpu_torch.llmapi.llm import GenerationFuture
    from tensorrt_llm_tpu_torch.runtime.request import (
        FinishReason, LlmRequest, RequestOutputPiece)
    data = list(TEXT.encode("utf-8"))
    req = LlmRequest([0], T.SamplingParams(max_tokens=len(data)))
    req.out_queue = queue.Queue()
    rng = np.random.default_rng(0)
    cuts = np.sort(rng.choice(np.arange(1, len(data)), 9, replace=False))
    parts = np.split(np.array(data), cuts)
    for i, p in enumerate(parts):
        last = i == len(parts) - 1
        req.out_queue.put(RequestOutputPiece(
            request_id=req.request_id, new_token_ids=[int(t) for t in p],
            finished=last, finish_reason=FinishReason.LENGTH if last
            else None))

    class _LLM:
        tokenizer = ByteTokenizer()

        class args:
            return_perf_metrics = False

    outs = list(GenerationFuture(_LLM(), req))
    texts = [o.outputs[0].text for o in outs]
    assert all(TEXT.startswith(t) for t in texts) and texts[-1] == TEXT
    assert "�" not in "".join(texts)
    assert outs[-1].outputs[0].token_ids == data


def test_llm_runs_without_hf_packages(text_ckpt):
    """With `safetensors`, `transformers` and `tokenizers` blocked (the
    port needs none of them), a checkpoint loads and serves text through a
    tokenizer object; asking for a tokenizer by path names `transformers`."""
    import os
    import subprocess
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    code = (
        "import sys\n"
        "for name in ('jax', 'safetensors', 'transformers', 'tokenizers'):\n"
        "    sys.modules[name] = None\n"
        "import tensorrt_llm_tpu_torch as T\n"
        "class Tok:\n"
        "    eos_token_id = 2\n"
        "    def encode(self, text):\n"
        "        return [1] + [b + 3 for b in text.encode()]\n"
        "    def decode(self, ids, skip_special_tokens=True):\n"
        "        return ''.join(chr(65 + i % 26) for i in ids)\n"
        f"kw = dict(device='cpu', {', '.join(f'{k}={v!r}' for k, v in LLM_KW.items())})\n"
        f"llm = T.LLM(model={str(text_ckpt)!r}, tokenizer=Tok(), **kw)\n"
        "o = llm.generate('abc', T.SamplingParams(max_tokens=4,\n"
        "                 temperature=0.0, ignore_eos=True))[0].outputs[0]\n"
        "llm.shutdown()\n"
        "assert len(o.token_ids) == 4 and o.text == Tok().decode(o.token_ids)\n"
        "try:\n"
        f"    T.LLM(model={str(text_ckpt)!r}, **kw)\n"
        "except ImportError as e:\n"
        "    assert 'transformers' in str(e)\n"
        "    print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=str(root),
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": str(root)})
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]
