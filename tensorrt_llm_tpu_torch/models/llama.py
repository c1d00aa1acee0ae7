"""Llama-family architectures.  Counterpart of
`tensorrt_llm_tpu/models/llama.py`: config specialisations of the shared
decoder in `modeling_utils.py`."""

from __future__ import annotations

from tensorrt_llm_tpu_torch.models.modeling_utils import (
    DecoderModelForCausalLM, register_auto_model)


@register_auto_model("LlamaForCausalLM", "MistralForCausalLM")
class LlamaForCausalLM(DecoderModelForCausalLM):
    pass

