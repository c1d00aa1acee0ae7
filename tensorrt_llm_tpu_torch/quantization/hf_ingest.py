"""Pre-quantized HF checkpoint ingestion (AWQ / GPTQ).

Counterpart of `tensorrt_llm_tpu/quantization/hf_ingest.py`, in torch.  An
AWQ or GPTQ checkpoint's scales came from an activation-aware search, so
re-quantizing its dequantized floats would not reproduce them: the int32
nibble words are unpacked exactly into the port's signed int4 domain and
carried as a `QTensor` to `Linear.from_float`, which packs them as they are.

Formats:

* AWQ (autoawq ``WQLinear_GEMM``): qweight int32 ``[K, N/8]``, nibble i of
  each word holds column ``AWQ_ORDER[i]`` of its 8-column block; qzeros
  int32 ``[K/G, N/8]`` packed the same way; scales fp16 ``[K/G, N]``;
  unsigned [0, 15], dequant = (q - z) * s.
* GPTQ (AutoGPTQ v1): qweight int32 ``[K/8, N]``, nibble i holds row
  ``r*8 + i``; qzeros int32 ``[K/G, N/8]`` in natural order storing z - 1
  (``checkpoint_format == "gptq_v2"`` stores z); scales fp16 ``[K/G, N]``.
  ``g_idx`` must be the contiguous group map: act-order (desc_act)
  reorders K and would need the activations permuted at run time, which
  neither package does.

The port's domain is signed int4 in [-8, 7] with f32 zeros in the same
domain: q_s = q_u - 8, z_s = z_u - 8, so (q_s - z_s) * s == (q_u - z_u) * s
exactly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

# autoawq pack order: nibble i of a 32-bit word holds column AWQ_ORDER[i]
# of the 8-column block
AWQ_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)
# inverse: output column m within its block lives in nibble AWQ_INVERSE[m]
AWQ_INVERSE = (0, 4, 1, 5, 2, 6, 3, 7)


def _tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a))


@dataclass
class QTensor:
    """A pre-quantized linear weight in ``[in, out]`` orientation: q int8
    ``[K, N]`` in [-8, 7], scales f32 ``[K/G, N]``, zeros f32 ``[K/G, N]``
    in the signed domain (None: symmetric)."""

    q: torch.Tensor
    scales: torch.Tensor
    zeros: Optional[torch.Tensor] = None

    @property
    def shape(self):
        return tuple(self.q.shape)

    @property
    def group_size(self) -> int:
        return self.q.shape[0] // self.scales.shape[0]

    def to(self, device) -> "QTensor":
        return QTensor(self.q.to(device), self.scales.to(device),
                       None if self.zeros is None else self.zeros.to(device))

    def dequant(self) -> torch.Tensor:
        """Exact f32 dequantization ``[K, N]`` (for consumers that take
        floats: the MLA up-projection, unquantized layers)."""
        K, N = self.q.shape
        G = self.group_size
        qg = self.q.to(torch.float32).reshape(K // G, G, N)
        if self.zeros is not None:
            qg = qg - self.zeros[:, None, :]
        return (qg * self.scales[:, None, :]).reshape(K, N)


def wcat(parts: List) -> object:
    """Concatenate weights along the output columns: float tensors, or
    QTensors of one group size (the fused QKV and gate_up builders)."""
    if not any(isinstance(p, QTensor) for p in parts):
        return torch.cat(parts, dim=1)
    if not all(isinstance(p, QTensor) for p in parts):
        raise ValueError("cannot fuse quantized and float weights into one "
                         "linear")
    if len({p.group_size for p in parts}) != 1:
        raise ValueError(f"group sizes differ: {[p.group_size for p in parts]}")
    zeros = None
    if any(p.zeros is not None for p in parts):
        zeros = torch.cat([p.zeros if p.zeros is not None
                           else torch.zeros_like(p.scales) for p in parts], 1)
    return QTensor(torch.cat([p.q for p in parts], 1),
                   torch.cat([p.scales for p in parts], 1), zeros)


def _unpack_nibbles_cols(words, order) -> torch.Tensor:
    """int32 ``[R, C/8]`` -> int16 ``[R, C]`` in [0, 15]; nibble `order[m]`
    of each word is column m of its block."""
    w = _tensor(words).to(torch.int32)
    shifts = 4 * torch.tensor(list(order), dtype=torch.int32,
                              device=w.device)
    return ((w[:, :, None] >> shifts) & 0xF).to(torch.int16).reshape(
        w.shape[0], -1)


def _signed(q_u: torch.Tensor, z_u: torch.Tensor, scales) -> QTensor:
    return QTensor((q_u - 8).to(torch.int8),
                   _tensor(scales).to(torch.float32),
                   z_u.to(torch.float32) - 8.0)


def unpack_awq(qweight, qzeros, scales) -> QTensor:
    """AWQ GEMM-format tensors -> QTensor (exact)."""
    q_u = _unpack_nibbles_cols(qweight, AWQ_INVERSE)          # [K, N]
    z_u = _unpack_nibbles_cols(qzeros, AWQ_INVERSE)           # [K/G, N]
    s = _tensor(scales)
    if q_u.shape[1] != s.shape[1] or z_u.shape != s.shape:
        raise ValueError(f"AWQ shapes: qweight {tuple(q_u.shape)}, "
                         f"qzeros {tuple(z_u.shape)}, scales {tuple(s.shape)}")
    return _signed(q_u, z_u, s)


def unpack_gptq(qweight, qzeros, scales, g_idx=None,
                v2: bool = False) -> QTensor:
    """GPTQ tensors -> QTensor (exact).  v2: ``checkpoint_format ==
    "gptq_v2"`` (zeros stored without the classic -1 offset).  A `g_idx`
    other than the contiguous group map (act-order) raises."""
    qw = _tensor(qweight).to(torch.int32)                     # [K/8, N]
    shifts = 4 * torch.arange(8, dtype=torch.int32, device=qw.device)
    q_u = ((qw[:, None, :] >> shifts[None, :, None]) & 0xF).to(
        torch.int16).reshape(-1, qw.shape[1])                 # [K, N]
    z_u = _unpack_nibbles_cols(qzeros, range(8))              # [K/G, N]
    if not v2:
        z_u = (z_u + 1) & 0xF
    s = _tensor(scales)
    K = q_u.shape[0]
    G = K // s.shape[0]
    if g_idx is not None:
        expect = torch.arange(K, dtype=torch.int64) // G
        if not torch.equal(_tensor(g_idx).to(torch.int64).cpu(), expect):
            raise NotImplementedError(
                "GPTQ act-order (desc_act) checkpoints reorder the K rows; "
                "permuting the activations at run time is not supported")
    if z_u.shape != s.shape:
        raise ValueError(f"GPTQ shapes: qzeros {tuple(z_u.shape)}, scales "
                         f"{tuple(s.shape)}")
    return _signed(q_u, z_u, s)


def maybe_load_quantized(get_tensor, name: str, fmt: str,
                         v2: bool = False) -> Optional[QTensor]:
    """The unpacked QTensor when `name` (``...weight``) is a pre-quantized
    linear of the checkpoint, else None (the caller reads floats)."""
    if not name.endswith(".weight"):
        return None
    base = name[: -len(".weight")]
    qw = get_tensor(base + ".qweight")
    if qw is None:
        return None
    qz = get_tensor(base + ".qzeros")
    s = get_tensor(base + ".scales")
    if qz is None or s is None:
        raise ValueError(f"incomplete quantized tensors: {base}")
    if fmt == "awq":
        return unpack_awq(qw, qz, s)
    if fmt == "gptq":
        return unpack_gptq(qw, qz, s, get_tensor(base + ".g_idx"), v2=v2)
    raise NotImplementedError(f"quantized checkpoint format {fmt!r}")


def quant_config_from_hf(hf_quant_cfg: Optional[dict]) -> Optional[dict]:
    """An HF ``quantization_config`` as the algorithm, group size and
    checkpoint format to adopt, or None when it is not an AWQ/GPTQ config
    (other bit widths raise)."""
    if hf_quant_cfg is None:
        return None
    method = (hf_quant_cfg.get("quant_method") or "").lower()
    bits = int(hf_quant_cfg.get("bits", 4) or 4)
    if method not in ("awq", "gptq"):
        return None
    if bits != 4:
        raise NotImplementedError(
            f"pre-quantized {method} checkpoint with bits={bits}; only 4-bit "
            "ingestion is implemented")
    if method == "awq":
        version = (hf_quant_cfg.get("version") or "gemm").lower()
        if version != "gemm":
            raise NotImplementedError(f"AWQ packing version {version!r} "
                                      "(only 'gemm' checkpoints supported)")
    group = int(hf_quant_cfg.get("group_size", 128) or 128)
    exclude = tuple(hf_quant_cfg.get("modules_to_not_convert") or ()) or None
    return {
        "algo": "W4A16_AWQ" if method == "awq" else "W4A16_GPTQ",
        "group_size": group,
        "format": method,
        "v2": hf_quant_cfg.get("checkpoint_format") == "gptq_v2",
        "exclude_modules": exclude,
    }
