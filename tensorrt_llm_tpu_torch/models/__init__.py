from tensorrt_llm_tpu_torch.models.modeling_utils import (  # noqa: F401
    DecoderModelForCausalLM, ModelConfig, get_model_class, params_from_jax)
from tensorrt_llm_tpu_torch.models.gpt_oss import (  # noqa: F401
    GPT_OSS_20B, gpt_oss_20b_config)
from tensorrt_llm_tpu_torch.models.deepseek import (  # noqa: F401
    DEEPSEEK_V3, DEEPSEEK_V32, MOONLIGHT_16B_A3B, deepseek_v3_config,
    deepseek_v32_config, moonlight_16b_a3b_config)
from tensorrt_llm_tpu_torch.models.gemma import GEMMA2_9B  # noqa: F401
