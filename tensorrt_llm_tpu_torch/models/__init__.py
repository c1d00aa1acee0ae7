from tensorrt_llm_tpu_torch.models.modeling_utils import (  # noqa: F401
    DecoderModelForCausalLM, ModelConfig, get_model_class, params_from_jax)
