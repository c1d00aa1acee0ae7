"""Port parity for the MoE model zoo: `LLM.generate` against the JAX `LLM`.

Qwen3-MoE (the family served on the card), GLM-4.5 (grouped noaux_tc
routing, a dense first layer, partial RoPE), Llama4 (NoPE and chunked
layers on VSWA rings, weights on the expert input, the interleaved MoE),
MiniMax-M2 (the flat q/k norm, sigmoid routing in one group) and Mistral
Large 3 (MLA with softmax routing), each from the tiny config of
`torch_moe_zoo`, W4A16 group 64: the JAX `LLM` draws the weights, the
port's `LLM` takes them through `params_from_jax`, and both serve the same
three greedy requests (45, 20 and 7 prompt tokens, 32-token prefill
chunks, 8 new tokens).  Their tokens are equal, or first differ at a
near-tie: both tokens within `TIE` 0.02 of the top of the port's row there
(`tests/test_torch_zoo_generate.py`'s rule); at least 2 of the 3 are
equal.
"""

import jax
import numpy as np
import pytest

import tensorrt_llm_tpu as J
from tensorrt_llm_tpu.models.modeling_utils import ModelConfig as JCfg
from tensorrt_llm_tpu.quantization import QuantAlgo as JQA
from tensorrt_llm_tpu.quantization import QuantConfig as JQC
import tensorrt_llm_tpu_torch as T
from tensorrt_llm_tpu_torch.models import ModelConfig, params_from_jax
from tensorrt_llm_tpu_torch.quantization import QuantAlgo, QuantConfig

from torch_moe_zoo import config_dict
from torch_parity import jax_generate, port_logits

TIE = 0.02
FAMILIES = ("Qwen3MoeForCausalLM", "Glm4MoeForCausalLM", "Llama4ForCausalLM",
            "MiniMaxM2ForCausalLM", "MistralLarge3ForCausalLM")
LLM_KW = dict(skip_tokenizer_init=True, max_seq_len=96, max_batch_size=3,
              max_num_tokens=32, kv_num_blocks=48, kv_block_size=8,
              max_decode_steps=4)


@pytest.mark.parametrize("arch", FAMILIES)
def test_generate_matches_jax_greedy(arch, monkeypatch):
    monkeypatch.setenv("TLLM_KV_BOOKKEEPING", "python")
    hf = config_dict(arch)
    jcfg = JCfg.from_hf_config(hf, quant=JQC(quant_algo=JQA.W4A16,
                                             group_size=64))
    jcfg.architecture = arch
    jcfg.attention_backend = "xla"
    tcfg = ModelConfig.from_hf_config(hf, quant=QuantConfig(
        quant_algo=QuantAlgo.W4A16, group_size=64))
    rng = np.random.RandomState(3)
    prompts = [[int(t) for t in rng.randint(1, 255, n)] for n in (45, 20, 7)]
    sp = dict(max_tokens=8, temperature=0.0, ignore_eos=True)
    jl = J.LLM(model=jcfg, **LLM_KW)
    try:
        params = params_from_jax(jax.tree.map(np.asarray, jl.engine.params))
        jout = jax_generate(jl, prompts, J.SamplingParams(**sp))
    finally:
        jl.shutdown()
    tl = T.LLM(model=tcfg, device="cpu", params=params,
               kv_bookkeeping="python", **LLM_KW)
    try:
        cfg = tl.model_config
        rings = tl.engine.vswa
        tout = [o.outputs[0].token_ids
                for o in tl.generate(prompts, T.SamplingParams(**sp))]
    finally:
        tl.shutdown()
    # Llama4's chunked layers (chunks of 8) ride rings, as in the JAX engine
    assert rings == (arch == "Llama4ForCausalLM")
    exact = 0
    for p, x, y in zip(prompts, jout, tout):
        assert len(x) == len(y) == 8
        if x == y:
            exact += 1
            continue
        i = next(i for i, (u, v) in enumerate(zip(x, y)) if u != v)
        lg = port_logits(cfg, params, p + x[:i])
        top = lg.max()
        assert lg[x[i]] >= top - TIE and lg[y[i]] >= top - TIE, (
            f"token {i} differs without a near-tie: jax {x[i]} "
            f"({lg[x[i]]}), port {y[i]} ({lg[y[i]]}), top {top}")
    assert exact >= 2
