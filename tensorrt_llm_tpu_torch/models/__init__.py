from tensorrt_llm_tpu_torch.models.modeling_utils import (  # noqa: F401
    DecoderModelForCausalLM, ModelConfig, get_model_class, params_from_jax)
from tensorrt_llm_tpu_torch.models.gpt_oss import (  # noqa: F401
    GPT_OSS_20B, gpt_oss_20b_config)
