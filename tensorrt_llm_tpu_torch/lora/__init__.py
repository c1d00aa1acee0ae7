"""LoRA adapters: merged into the weights at load (`lora_manager`), or
served per request from stacked adapter slots (`multi_lora`)."""

from tensorrt_llm_tpu_torch.lora.lora_manager import (  # noqa: F401
    LoraAdapter, load_lora_adapter, merge_lora_into_state)
