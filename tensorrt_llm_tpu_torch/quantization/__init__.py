from tensorrt_llm_tpu_torch.quantization.mode import (  # noqa: F401
    KvCacheQuantAlgo, QuantAlgo, QuantConfig)
from tensorrt_llm_tpu_torch.quantization.quantize import (  # noqa: F401
    E4M3_MAX, choose_block_n, dequantize_w4, dequantize_w4_any, pack_group_for,
    pack_w4, pack_w4_tiled, quantize_fp8, quantize_w4, quantize_w8,
    tiled_block_n, to_e4m3, to_tiled, unpack_w4, unpack_w4_tiled)
