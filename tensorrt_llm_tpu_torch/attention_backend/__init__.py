from tensorrt_llm_tpu_torch.attention_backend.interface import (  # noqa: F401
    AttentionBackend, AttentionMetadata, get_attention_backend)
