"""Quantization algorithm taxonomy.

Counterpart of `tensorrt_llm_tpu/quantization/mode.py`: the `QuantAlgo` and
`KvCacheQuantAlgo` enums and `QuantConfig`.  The port runs every algorithm
of the JAX package: the W4A16 family, W4A8_AWQ (int4 weights, dynamic
per-token int8 activations), the 8-bit ones (W8A16, W8A8_SQ_PER_CHANNEL,
FP8 and FP8_PER_CHANNEL_PER_TOKEN: per-channel int8 or e4m3 weights) and
unquantized layers; KV pools are bf16, INT8 or FP8 (e4m3 pages, no
scales).  `exclude_modules` keeps `lm_head` and the embedding in bf16 as
the JAX package does; `clip_search` quantizes int4 weights through the
clip-ratio search of `quantization/calibrate.py`.  `pre_quantized` marks an AWQ/GPTQ checkpoint whose ints,
scales and zeros are taken as stored (`quantization/hf_ingest.py`);
`ckpt_format` names its packing and `ckpt_v2` GPTQ's v2 zero convention.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional


class QuantAlgo(str, enum.Enum):
    """Weight/activation quantization algorithms."""

    W4A16 = "W4A16"                  # per-group int4 weights, symmetric
    W4A16_AWQ = "W4A16_AWQ"          # per-group int4, AWQ scales (+zeros)
    W4A16_GPTQ = "W4A16_GPTQ"        # per-group int4, GPTQ (zeros)
    W8A16 = "W8A16"
    W4A8_AWQ = "W4A8_AWQ"            # per-group int4 (+zeros), int8 acts
    W8A8_SQ_PER_CHANNEL = "W8A8_SQ_PER_CHANNEL"
    FP8 = "FP8"
    FP8_PER_CHANNEL_PER_TOKEN = "FP8_PER_CHANNEL_PER_TOKEN"
    NO_QUANT = "NO_QUANT"


class KvCacheQuantAlgo(str, enum.Enum):
    NONE = "NONE"
    INT8 = "INT8"      # int8 pages + f32 scale per (token, head)
    FP8 = "FP8"        # e4m3 pages, no scales


WEIGHT_ONLY_W4 = (QuantAlgo.W4A16, QuantAlgo.W4A16_AWQ, QuantAlgo.W4A16_GPTQ)


@dataclass
class QuantConfig:
    quant_algo: QuantAlgo = QuantAlgo.NO_QUANT
    # the JAX package's field; the KV pools follow LLM(kv_cache_quant=...)
    kv_cache_quant_algo: KvCacheQuantAlgo = KvCacheQuantAlgo.NONE
    group_size: int = 128
    has_zero_point: bool = False
    # Module name substrings excluded from quantization.
    exclude_modules: tuple = field(default_factory=lambda: ("lm_head", "embed"))
    # an AWQ/GPTQ checkpoint: qweight/qzeros/scales are ingested exactly
    # instead of quantizing floats
    pre_quantized: bool = False
    ckpt_format: Optional[str] = None   # "awq" | "gptq"
    ckpt_v2: bool = False               # gptq_v2 zeros (no -1 offset)
    # int4 weights quantized with the per-group clip-ratio search
    clip_search: bool = False

    @property
    def is_weight_only_w4(self) -> bool:
        return self.quant_algo in WEIGHT_ONLY_W4

    @property
    def is_w4(self) -> bool:
        """int4 weights in the tiled packing: W4A16 family or W4A8_AWQ."""
        return self.is_weight_only_w4 or self.quant_algo == QuantAlgo.W4A8_AWQ

    def excludes(self, name: str) -> bool:
        return any(pat in name for pat in self.exclude_modules)
