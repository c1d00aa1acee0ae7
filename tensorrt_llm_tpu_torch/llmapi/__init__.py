from tensorrt_llm_tpu_torch.llmapi.llm import (  # noqa: F401
    LLM, CompletionOutput, RequestOutput)
from tensorrt_llm_tpu_torch.llmapi.llm_args import LlmArgs  # noqa: F401
from tensorrt_llm_tpu_torch.llmapi.sampling_params import (  # noqa: F401
    GuidedDecodingParams, SamplingParams)
