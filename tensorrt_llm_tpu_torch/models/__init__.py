from tensorrt_llm_tpu_torch.models.modeling_utils import (  # noqa: F401
    DecoderModelForCausalLM, ModelConfig, get_model_class, params_from_jax)
from tensorrt_llm_tpu_torch.models.gpt_oss import (  # noqa: F401
    GPT_OSS_20B, gpt_oss_20b_config)
from tensorrt_llm_tpu_torch.models.deepseek import (  # noqa: F401
    DEEPSEEK_V3, DEEPSEEK_V32, MOONLIGHT_16B_A3B, deepseek_v3_config,
    deepseek_v32_config, moonlight_16b_a3b_config)
from tensorrt_llm_tpu_torch.models.gemma import GEMMA2_9B  # noqa: F401
from tensorrt_llm_tpu_torch.models.llama import (  # noqa: F401
    QWEN2_5_7B, QWEN3_8B)
# the dense zoo's published widths
from tensorrt_llm_tpu_torch.models.apertus import APERTUS_8B  # noqa: F401
from tensorrt_llm_tpu_torch.models.exaone4 import EXAONE4_32B  # noqa: F401
from tensorrt_llm_tpu_torch.models.glm import (  # noqa: F401
    GLM4_9B_0414, GLM_4_9B_CHAT)
from tensorrt_llm_tpu_torch.models.granite import (  # noqa: F401
    GRANITE_3_1_8B)
from tensorrt_llm_tpu_torch.models.hunyuan import (  # noqa: F401
    HUNYUAN_7B, HUNYUAN_A13B)
from tensorrt_llm_tpu_torch.models.nemotron import MINITRON_8B  # noqa: F401
from tensorrt_llm_tpu_torch.models.olmo2 import OLMO2_7B  # noqa: F401
from tensorrt_llm_tpu_torch.models.phi import PHI_4  # noqa: F401
from tensorrt_llm_tpu_torch.models.seed_oss import SEED_OSS_36B  # noqa: F401
from tensorrt_llm_tpu_torch.models.smollm3 import SMOLLM3_3B  # noqa: F401
from tensorrt_llm_tpu_torch.models.starcoder2 import (  # noqa: F401
    STARCODER2_7B)
# the MoE zoo's published widths (EXAONE_MOE_ZOO is composed: its module
# says how)
from tensorrt_llm_tpu_torch.models.dots1 import DOTS_LLM1  # noqa: F401
from tensorrt_llm_tpu_torch.models.exaone_moe import (  # noqa: F401
    EXAONE_MOE_ZOO)
from tensorrt_llm_tpu_torch.models.glm4_moe import GLM_4_5_AIR  # noqa: F401
from tensorrt_llm_tpu_torch.models.llama4 import LLAMA4_SCOUT  # noqa: F401
from tensorrt_llm_tpu_torch.models.minimax_m2 import MINIMAX_M2  # noqa: F401
from tensorrt_llm_tpu_torch.models.mixtral import (  # noqa: F401
    QWEN1_5_MOE_A2_7B, QWEN3_30B_A3B)
