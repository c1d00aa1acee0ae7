"""Port parity for the MoE model zoo: HF models and checkpoint directories.

* For each of the six MoE families `transformers` has (Qwen3-MoE,
  Qwen2-MoE with its gated shared expert on, GLM-4.5, dots.llm1,
  HunYuan-MoE, Llama4 text), the seeded model of `torch_moe_zoo` (norms
  scrambled, score-correction biases drawn) loaded by the port's
  `load_hf_weights` from its state dict: the last row's logits of a
  20-token prompt have HF's argmax and correlate above `CORR` 0.99 with
  HF's (JAX `tests/test_model_zoo.py:21-63`).
* The same models written by `save_pretrained` and served by
  `LLM(model=<dir>)` on the CPU: the context logits as above, the first
  generated token HF's argmax.
* `test_reference_qwen2_moe_drops_the_shared_expert`: on a Qwen2-MoE
  whose shared expert is made visible (its weights x4), the JAX package's
  logits leave HF's (it drops the expert and its gate: correlation under
  `CORR`, the largest gap 10x the port's) while the port's keep HF's
  argmax and correlation.
* Mistral Large 3's Mistral-native names: a checkpoint under them loads
  the same state, byte for byte, as under the HF DeepSeek names.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorrt_llm_tpu_torch as T
from tensorrt_llm_tpu.attention_backend.interface import (
    AttentionMetadata as JMeta)
from tensorrt_llm_tpu.models import get_model_class as jax_model_class
from tensorrt_llm_tpu.models.modeling_utils import ModelConfig as JCfg
from tensorrt_llm_tpu_torch.models import ModelConfig, get_model_class
from tensorrt_llm_tpu_torch.models.mistral_large3 import mistral_name

from torch_moe_zoo import (
    DICT_ZOO, HF_ARCHS, HF_ON, config_dict, hf_model, prompt)
from torch_parity import hf_checkpoint_tensors, port_logits

CORR = 0.99


def _hf_logits(hf, toks):
    with torch.no_grad():
        return hf(torch.tensor([toks])).logits[0, -1].float().numpy()


def _port_from_hf(arch, hf, **over):
    sd = {k: v.detach() for k, v in hf.state_dict().items()}
    cfg = ModelConfig.from_hf_config(config_dict(arch, **over))
    m = get_model_class(arch)(cfg, "cpu").load_hf_weights(
        lambda n: sd.get(n))
    return cfg, m.state()


@pytest.mark.parametrize("arch", HF_ARCHS)
def test_port_matches_hf(arch):
    over = HF_ON.get(arch, {})
    _, hf = hf_model(arch, **over)
    toks = prompt(20, seed=2)
    ref = _hf_logits(hf, toks)
    cfg, state = _port_from_hf(arch, hf, **over)
    ours = port_logits(cfg, state, toks)
    assert np.argmax(ours) == np.argmax(ref)
    assert np.corrcoef(ours, ref)[0, 1] > CORR


@pytest.mark.parametrize("arch", HF_ARCHS)
def test_llm_serves_the_hf_checkpoint(arch, tmp_path):
    _, hf = hf_model(arch, **HF_ON.get(arch, {}))
    hf.save_pretrained(str(tmp_path), safe_serialization=True)
    toks = prompt(20, seed=2)
    ref = _hf_logits(hf, toks)
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


def test_reference_qwen2_moe_drops_the_shared_expert():
    arch = "Qwen2MoeForCausalLM"
    over = dict(shared_expert_intermediate_size=256)
    _, hf = hf_model(arch, **over)
    with torch.no_grad():
        for n, p in hf.named_parameters():
            if ".shared_expert." in n:
                p.mul_(4.0)
    toks = prompt(20, seed=2)
    ref = _hf_logits(hf, toks)
    cfg, state = _port_from_hf(arch, hf, **over)
    ours = port_logits(cfg, state, toks)
    sd = {k: v.detach().float().numpy() for k, v in hf.state_dict().items()}
    jcfg = JCfg.from_hf_config(config_dict(arch, **over))
    jcfg.attention_backend = "xla"
    jm = jax_model_class(arch)(jcfg)
    jp = jm.load_hf_weights(lambda n: sd.get(n))
    assert jcfg.n_shared_experts == 0 and "shared" not in jp["layers"][0][
        "mlp"]
    n, BS = len(toks), 8
    caches = [(jnp.zeros((5, jcfg.num_kv_heads, BS, jcfg.head_dim),
                         jnp.bfloat16),) * 2 for _ in range(jcfg.num_layers)]
    meta = JMeta(positions=jnp.arange(n, dtype=jnp.int32),
                 slot_mapping=jnp.arange(BS, BS + n, dtype=jnp.int32),
                 block_tables=jnp.asarray([[1, 2, 3, 4]], jnp.int32),
                 kv_lens=jnp.asarray([n], jnp.int32), q_offset=jnp.int32(0),
                 mode="prefill")
    jl, _ = jax.jit(jm.forward)(jp, jnp.asarray(toks, jnp.int32), caches,
                                meta, jnp.asarray([n - 1], jnp.int32))
    jl = np.asarray(jl, np.float32)[0]
    # the port keeps HF's logits; the JAX package's leave them
    assert np.argmax(ours) == np.argmax(ref)
    assert np.corrcoef(ours, ref)[0, 1] > CORR
    assert np.corrcoef(jl, ref)[0, 1] < CORR
    assert np.abs(jl - ref).max() > 10 * np.abs(ours - ref).max()


def test_mistral_large3_loads_mistral_names():
    arch = "MistralLarge3ForCausalLM"
    hf = dict(DICT_ZOO[arch], architectures=["DeepseekV3ForCausalLM"])
    tensors = {k: torch.from_numpy(v)
               for k, v in hf_checkpoint_tensors(hf, 5).items()}
    native = {mistral_name(k): v for k, v in tensors.items()}
    assert "tok_embeddings.weight" in native and "output.weight" in native
    assert not any(k.startswith("model.") for k in native)
    cfg = ModelConfig.from_hf_config(DICT_ZOO[arch])
    a = get_model_class(arch)(cfg, "cpu").load_hf_weights(tensors.get)
    b = get_model_class(arch)(cfg, "cpu").load_hf_weights(native.get)
    sa, sb = a.state(), b.state()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    toks = prompt(12, seed=6)
    lg = port_logits(cfg, sb, toks)
    assert np.isfinite(lg).all() and lg.shape == (256,)


def test_llama4_multimodal_checkpoint_names():
    """`Llama4ForConditionalGeneration`: the config's `text_config` and the
    text tensors under ``language_model.`` give the text model's state."""
    arch = "Llama4ForCausalLM"
    _, hf = hf_model(arch)
    sd = {k: v.detach() for k, v in hf.state_dict().items()}
    text = config_dict(arch)
    cfg = ModelConfig.from_hf_config(text)
    want = get_model_class(arch)(cfg, "cpu").load_hf_weights(sd.get).state()
    mm = {"architectures": ["Llama4ForConditionalGeneration"],
          "text_config": text, "vision_config": {"hidden_size": 16}}
    mcfg = ModelConfig.from_hf_config(mm)
    assert mcfg.architecture == "Llama4ForConditionalGeneration"
    prefixed = {"language_model." + k: v for k, v in sd.items()}
    got = get_model_class(mcfg.architecture)(mcfg, "cpu").load_hf_weights(
        prefixed.get).state()
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
