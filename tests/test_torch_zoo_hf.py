"""Port parity for the dense model zoo: HF models and checkpoint directories.

For each of the 14 architectures a seeded `transformers` model (norms,
biases and xIELU alphas scrambled, as the JAX package's `perturb` does:
`torch_zoo.hf_model`) is written by `save_pretrained` and served by
`LLM(model=<dir>)` on the CPU: the checkpoint's fused tensors (Phi-3's
`qkv_proj` / `gate_up_proj`, GLM's `gate_up_proj`), norm names (GLM-4,
Apertus, HunYuan) and layernorm1p weights go through the family's loader.
The context logits of the prompt's last row have HF's argmax and correlate
above 0.99 with HF's logits (JAX `tests/test_model_zoo.py:21-63`), and the
first generated token is HF's argmax.
"""

import numpy as np
import pytest
import torch

import tensorrt_llm_tpu_torch as T

from torch_zoo import ARCHS, hf_model, prompt

CORR = 0.99


@pytest.mark.parametrize("arch", ARCHS)
def test_llm_serves_the_hf_checkpoint(arch, tmp_path):
    _, hf = hf_model(arch)
    hf.save_pretrained(str(tmp_path), safe_serialization=True)
    toks = prompt(20, seed=2)
    with torch.no_grad():
        ref = hf(torch.tensor([toks])).logits[0, -1].float().numpy()
    llm = T.LLM(model=str(tmp_path), device="cpu", skip_tokenizer_init=True,
                max_seq_len=64, max_batch_size=2, kv_num_blocks=32,
                kv_block_size=8, kv_bookkeeping="python")
    try:
        assert llm.model_config.architecture == arch
        out = llm.generate([toks], T.SamplingParams(
            max_tokens=2, temperature=0.0, ignore_eos=True,
            return_context_logits=True))[0]
    finally:
        llm.shutdown()
    ours = np.asarray(out.context_logits, np.float32)[-1]
    assert np.argmax(ours) == np.argmax(ref)
    assert np.corrcoef(ours, ref)[0, 1] > CORR
    assert out.outputs[0].token_ids[0] == int(np.argmax(ref))
