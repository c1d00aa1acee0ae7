"""tensorrt_llm_tpu_torch: the PyTorch/CUDA port of the JAX package
`tensorrt_llm_tpu`.

The JAX package `tensorrt_llm_tpu` stays beside it as the reference; this
package imports neither JAX nor anything of that package.  Plain tensor code
is PyTorch; every TPU (Pallas) kernel on the ported path is a CUDA kernel
written by hand for Hopper (`csrc/`), built at first use.  Entry points run
on CUDA unless the caller passes ``device="cpu"``, where the kernels' plain
PyTorch versions run instead.
"""

from tensorrt_llm_tpu_torch.llmapi import (  # noqa: F401
    LLM, GuidedDecodingParams, LlmArgs, SamplingParams)
from tensorrt_llm_tpu_torch.models import ModelConfig, params_from_jax  # noqa: F401
from tensorrt_llm_tpu_torch.quantization import (  # noqa: F401
    QuantAlgo, QuantConfig)

__version__ = "0.1.0"
