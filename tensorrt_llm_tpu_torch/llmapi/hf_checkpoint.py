"""HF checkpoint directories: `config.json` and `*.safetensors`.

Counterpart of the JAX package's checkpoint plumbing in
`tensorrt_llm_tpu/llmapi/llm.py` (`_has_weights`, `_safetensors_reader`,
and the `AutoConfig.from_pretrained` call), without `safetensors` or
`transformers`: neither is needed to serve a checkpoint.

`SafetensorsReader` reads the format itself: an 8-byte little-endian header
length, a JSON header (dtype, shape and byte range of every tensor), then
the raw bytes.  A tensor is read when it is asked for: its byte range alone
is memory-mapped (copy-on-write), copied out and unmapped, so the host
holds about one tensor of the checkpoint at a time and no tensor outlives
its mapping.  (A mapping of the whole file keeps every page read
resident until it closes wherever the kernel ignores `MADV_DONTNEED` on
file mappings: the whole checkpoint, at the end of a load.)

`read_hf_config` reads `config.json` and fills in what `AutoConfig` would
for a key the file leaves out, for the five families the port serves
(`_HF_DEFAULTS`: the defaults of transformers' `LlamaConfig`,
`MistralConfig`, `MixtralConfig`, `GptOssConfig` and `DeepseekV3Config`,
plus the values they derive: kv heads, head_dim, GPT-OSS's `layer_types`;
for the zoo's families, dense and MoE, only `tie_word_embeddings`, from
the family class's `HF_TIE_DEFAULT`), so that `ModelConfig.from_hf_config` builds the
config the JAX package builds from the same file.
"""

from __future__ import annotations

import glob
import json
import math
import mmap
import os
import struct
from typing import Dict, List, Optional, Tuple

import torch

# safetensors dtype names the port reads
DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32,
          "I32": torch.int32, "I64": torch.int64, "I8": torch.int8,
          "U8": torch.uint8, "BOOL": torch.bool}


def has_weights(path: str) -> bool:
    return bool(glob.glob(os.path.join(path, "*.safetensors")))


class SafetensorsReader:
    """Lazy reader over every ``*.safetensors`` file of a directory (the
    files `pattern` names): ``reader(name)`` is the tensor on the CPU, or
    None when no file holds it.  Close it (or use it as a context manager)
    to close the files."""

    def __init__(self, path: str, pattern: str = "*.safetensors"):
        self._files: List = []
        self._index: Dict[str, Tuple[object, int, dict]] = {}
        for f in sorted(glob.glob(os.path.join(path, pattern))):
            fh = open(f, "rb")
            self._files.append(fh)
            (n,) = struct.unpack("<Q", fh.read(8))
            header = json.loads(fh.read(n))
            header.pop("__metadata__", None)
            for name, meta in header.items():
                self._index[name] = (fh, 8 + n, meta)

    def keys(self) -> List[str]:
        return list(self._index)

    def __call__(self, name: str) -> Optional[torch.Tensor]:
        entry = self._index.get(name)
        if entry is None:
            return None
        fh, base, meta = entry
        dt = DTYPES.get(meta["dtype"])
        if dt is None:
            raise NotImplementedError(
                f"{name}: safetensors dtype {meta['dtype']} is not read by "
                f"this port (it reads {', '.join(DTYPES)}; MXFP4 and FP8 "
                "block-scaled checkpoints are not supported)")
        lo, hi = meta["data_offsets"]
        shape = list(meta["shape"])
        count = math.prod(shape)
        if count * dt.itemsize != hi - lo:
            raise ValueError(f"{name}: {hi - lo} bytes for {meta['dtype']} "
                             f"{shape}")
        if count == 0:
            return torch.empty(shape, dtype=dt)
        start = (base + lo) // mmap.ALLOCATIONGRANULARITY \
            * mmap.ALLOCATIONGRANULARITY
        with mmap.mmap(fh.fileno(), base + hi - start, offset=start,
                       access=mmap.ACCESS_COPY) as mm:
            view = torch.frombuffer(mm, dtype=dt, count=count,
                                    offset=base + lo - start)
            out = view.clone().reshape(shape)
            del view            # release the buffer before the unmap
        return out

    def close(self) -> None:
        self._index.clear()
        for fh in self._files:
            fh.close()
        self._files.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


_LLAMA = dict(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
              num_hidden_layers=32, num_attention_heads=32,
              rms_norm_eps=1e-6, rope_theta=10000.0, rope_scaling=None,
              max_position_embeddings=2048, tie_word_embeddings=False,
              attention_bias=False)
_MISTRAL = dict(_LLAMA, intermediate_size=14336, num_key_value_heads=8,
                max_position_embeddings=131072, sliding_window=4096)
_HF_DEFAULTS = {
    "llama": _LLAMA,
    "mistral": {k: v for k, v in _MISTRAL.items()
                if k not in ("rope_scaling", "attention_bias")},
    "mixtral": dict({k: v for k, v in _MISTRAL.items()
                     if k not in ("rope_scaling", "attention_bias")},
                    rms_norm_eps=1e-5, rope_theta=1e6, sliding_window=None,
                    num_local_experts=8, num_experts_per_tok=2),
    "gpt_oss": dict(
        vocab_size=201088, hidden_size=2880, intermediate_size=2880,
        num_hidden_layers=36, num_attention_heads=64, num_key_value_heads=8,
        head_dim=64, rms_norm_eps=1e-5, rope_theta=150000.0,
        rope_scaling={"rope_type": "yarn", "factor": 32.0, "beta_fast": 32.0,
                      "beta_slow": 1.0, "truncate": False,
                      "original_max_position_embeddings": 4096},
        max_position_embeddings=131072, tie_word_embeddings=False,
        attention_bias=True, sliding_window=128, num_local_experts=128,
        num_experts_per_tok=4),
    "deepseek_v3": dict(
        vocab_size=129280, hidden_size=7168, intermediate_size=18432,
        moe_intermediate_size=2048, num_hidden_layers=61,
        num_attention_heads=128, n_shared_experts=1, n_routed_experts=256,
        routed_scaling_factor=2.5, n_group=8, topk_group=4,
        num_experts_per_tok=8, first_k_dense_replace=3, norm_topk_prob=True,
        max_position_embeddings=4096, rms_norm_eps=1e-6, rope_theta=10000.0,
        rope_scaling=None, attention_bias=False, q_lora_rank=1536,
        kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
        v_head_dim=128, rope_interleave=True, tie_word_embeddings=False),
}
_MODEL_TYPES = {"LlamaForCausalLM": "llama", "MistralForCausalLM": "mistral",
                "MixtralForCausalLM": "mixtral", "GptOssForCausalLM": "gpt_oss",
                "DeepseekV3ForCausalLM": "deepseek_v3"}


def _zoo_types() -> Dict[str, type]:
    """The zoo's families (dense and MoE) by architecture: each class names
    its HF model type and whether its HF class ties the embeddings by
    default.
    `save_pretrained` writes every key but those equal to
    `PretrainedConfig`'s own defaults, so of the keys the port reads only
    `tie_word_embeddings` can be missing from such a file (when it is true,
    that default); it takes the family's default, and nothing is filled in
    from Llama's defaults."""
    from tensorrt_llm_tpu_torch.models.modeling_utils import (
        registered_models)
    return {a: c for a, c in registered_models().items() if c.HF_MODEL_TYPE}


def hf_config_defaults(hf: dict) -> dict:
    """`hf` with the defaults `AutoConfig` gives its family filled in."""
    archs = hf.get("architectures") or []
    zoo = _zoo_types()
    arch = archs[0] if archs else ""
    mtype = (hf.get("model_type") or _MODEL_TYPES.get(arch)
             or (zoo[arch].HF_MODEL_TYPE if arch in zoo else "llama"))
    ties = {c.HF_MODEL_TYPE: c.HF_TIE_DEFAULT for c in zoo.values()}
    out = dict(_HF_DEFAULTS.get(mtype) or (
        {"tie_word_embeddings": ties[mtype]} if mtype in ties else _LLAMA))
    out.update(hf)
    out["model_type"] = mtype
    if out.get("num_key_value_heads") is None:
        out["num_key_value_heads"] = out["num_attention_heads"]
    if mtype == "deepseek_v3":
        out["head_dim"] = out["qk_rope_head_dim"]
    elif out.get("head_dim") is None and mtype == "llama":
        out["head_dim"] = out["hidden_size"] // out["num_attention_heads"]
    if mtype == "gpt_oss" and out.get("layer_types") is None:
        out["layer_types"] = ["sliding_attention" if (i + 1) % 2
                              else "full_attention"
                              for i in range(out["num_hidden_layers"])]
    rs = out.get("rope_scaling")
    if isinstance(rs, dict) and "type" in rs and "rope_type" not in rs:
        out["rope_scaling"] = dict(rs, rope_type=rs["type"])
    return out


def read_hf_config(path: str) -> dict:
    """`<path>/config.json` as `AutoConfig.from_pretrained(path)` reads it,
    as a plain dict for `ModelConfig.from_hf_config`."""
    with open(os.path.join(path, "config.json")) as f:
        return hf_config_defaults(json.load(f))
