"""LoRA adapter loading and merging.

Counterpart of `tensorrt_llm_tpu/lora/lora_manager.py`: an HF PEFT adapter
directory (`adapter_config.json` and `adapter_model.safetensors`, read with
the port's own `SafetensorsReader`, or `adapter_model.bin`, read with
`torch.load`) becomes a `LoraAdapter` of numpy f32 factors, and
`merge_lora_into_state` wraps a checkpoint reader so that the targeted
linears come back merged (before quantization, so a W4A16 base stays
quantized):

    W' = W + scaling(r) * B @ A

where ``scaling(r)`` is ``alpha / r``, or ``alpha / sqrt(r)`` under rsLoRA,
at each module's own rank (PEFT `rank_pattern`).  A DoRA adapter's
magnitude vectors then renormalize each output row:
``W'' = m * W' / ||W'||_row``.  The merge runs in numpy f32 as the JAX
package's does, so both packages quantize the same floats.
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass, field
from typing import Dict

import numpy as np
import torch

from tensorrt_llm_tpu_torch.utils import logger


@dataclass
class LoraAdapter:
    rank: int
    alpha: float
    use_rslora: bool = False
    # HF module path ("model.layers.0.self_attn.q_proj") -> (A [r, in],
    # B [out, r]) as numpy f32
    weights: Dict[str, tuple] = field(default_factory=dict)
    # DoRA: module path -> magnitude vector [out]
    magnitudes: Dict[str, np.ndarray] = field(default_factory=dict)

    @property
    def scaling(self) -> float:
        return self.module_scaling(self.rank)

    def module_scaling(self, module_rank: int) -> float:
        """The scaling of a module of rank `module_rank` (A.shape[0]): a
        `rank_pattern` module scales by its own rank."""
        r = max(int(module_rank), 1)
        if self.use_rslora:
            return self.alpha / (r ** 0.5)
        return self.alpha / r

    @property
    def is_dora(self) -> bool:
        return bool(self.magnitudes)


def _read_tensors(path: str) -> Dict[str, np.ndarray]:
    """Every tensor of the adapter's weights file as numpy f32."""
    st = os.path.join(path, "adapter_model.safetensors")
    if os.path.exists(st):
        from tensorrt_llm_tpu_torch.llmapi.hf_checkpoint import (
            SafetensorsReader)
        with SafetensorsReader(path, "adapter_model.safetensors") as r:
            return {k: r(k).float().numpy() for k in r.keys()}
    state = torch.load(os.path.join(path, "adapter_model.bin"),
                       map_location="cpu", weights_only=True)
    return {k: v.float().numpy() for k, v in state.items()}


def load_lora_adapter(path: str) -> LoraAdapter:
    """Load an HF PEFT adapter directory."""
    with open(os.path.join(path, "adapter_config.json")) as f:
        cfg = json.load(f)
    adapter = LoraAdapter(rank=cfg["r"],
                          alpha=cfg.get("lora_alpha", cfg["r"]),
                          use_rslora=bool(cfg.get("use_rslora", False)))
    pat = re.compile(r"^base_model\.model\.(.+)\.lora_(A|B)\.weight$")
    mag_pat = re.compile(
        r"^base_model\.model\.(.+)\.lora_magnitude_vector(?:\.weight)?$")
    pairs: Dict[str, dict] = {}
    for name, arr in _read_tensors(path).items():
        m = pat.match(name)
        if m:
            pairs.setdefault(m.group(1), {})[m.group(2)] = \
                np.asarray(arr, np.float32)
            continue
        m = mag_pat.match(name)
        if m:
            adapter.magnitudes[m.group(1)] = \
                np.asarray(arr, np.float32).reshape(-1)
    for mod, ab in pairs.items():
        if "A" in ab and "B" in ab:
            adapter.weights[mod] = (ab["A"], ab["B"])
    logger.info("loaded LoRA adapter: rank=%d alpha=%s modules=%d dora=%s",
                adapter.rank, adapter.alpha, len(adapter.weights),
                adapter.is_dora)
    return adapter


def merge_lora_into_state(get_tensor, adapter: LoraAdapter):
    """Wrap a checkpoint reader (`get_tensor(name)`, torch or numpy) so
    that the targeted linear weights come back merged, as f32 torch
    tensors in the HF ``[out, in]`` layout."""
    def wrapped(name: str):
        arr = get_tensor(name)
        mod = name[:-len(".weight")] if name.endswith(".weight") else None
        if arr is None or mod not in adapter.weights:
            return arr
        A, B = adapter.weights[mod]
        w = arr.float().numpy() if isinstance(arr, torch.Tensor) else arr
        v = np.asarray(w, np.float32) \
            + adapter.module_scaling(A.shape[0]) * (B @ A)
        m = adapter.magnitudes.get(mod)
        if m is not None:
            norm = np.linalg.norm(v, axis=1, keepdims=True)
            v = m[:, None] * v / np.maximum(norm, 1e-12)
        return torch.from_numpy(np.ascontiguousarray(v, np.float32))
    return wrapped
