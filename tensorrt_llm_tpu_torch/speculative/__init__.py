from tensorrt_llm_tpu_torch.speculative.interface import (  # noqa: F401
    Drafter, SpeculativeConfig, SpeculativeMode, UserProvidedDrafter,
    get_drafter, suggest_spec_config)
