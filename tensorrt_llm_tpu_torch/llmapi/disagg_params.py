"""Disaggregated serving parameters and the KV payload wire format.

Counterpart of `tensorrt_llm_tpu/llmapi/disagg_params.py`: a context-only
request returns its first generated token and the KV pages of its prompt
(`kv_payload`); a generation-only request carries both to the decode worker,
which injects the pages and goes on decoding.  With ``stream=True`` the
context worker emits KV frames as its prefill chunks finish, and the decode
worker injects them as they arrive (`kv_frames`, a `queue.Queue`).

The wire format is the JAX package's: an 8-byte little-endian header length,
a JSON spec, then each leaf's raw bytes in order (layer by layer, the leaves
of a layer in pool order).  A bf16 leaf travels as its raw 2-byte words
under the dtype name ``"bfloat16"`` and comes back as `torch.bfloat16`
through an `int16` view, and an FP8 leaf as its raw bytes under
``"float8_e4m3fn"`` (back as `torch.float8_e4m3fn` through a `uint8`
view), so neither side needs `ml_dtypes`: the JAX package reads and writes
the same names.  Leaves may be
torch tensors or numpy arrays (a JAX payload read in process); decoded
leaves are CPU torch tensors.  A frame carries ``"v"`` (`FRAME_WIRE_VERSION`)
and one of: ``start_block`` and ``layers`` (a KV frame of table rows
``[s, s + n)``), or ``end`` with ``first_gen_tokens``, ``num_tokens`` and
``block_size``, or ``error``.
"""

from __future__ import annotations

import io
import json
from dataclasses import dataclass, field
from typing import Any, List, Optional

import numpy as np
import torch

FRAME_WIRE_VERSION = 1
_FRAME_KEYS = ("start_block", "end", "first_gen_tokens", "num_tokens",
               "block_size", "ring", "error")


@dataclass
class DisaggregatedParams:
    request_type: str = "context_only"   # context_only | generation_only
    first_gen_tokens: List[int] = field(default_factory=list)
    kv_payload: Optional[dict] = None    # {"layers": [...], "num_tokens": N}
    stream: bool = False                 # context_only: emit KV frames
    kv_frames: Optional[Any] = None      # generation_only: a frame queue


def leaves(tree):
    """A layer's leaves in pool order (nested tuples and lists flattened,
    as `jax.tree.leaves` flattens them)."""
    if isinstance(tree, (tuple, list)):
        for t in tree:
            yield from leaves(t)
    else:
        yield tree


# dtypes numpy lacks without `ml_dtypes`: name -> (torch dtype, the
# same-width integer numpy dtype their words travel as)
_RAW = {"bfloat16": (torch.bfloat16, np.int16),
        "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8)}
_RAW_TORCH = {t: (name, np.dtype(w).name) for name, (t, w) in _RAW.items()}


def leaf_numpy(a) -> np.ndarray:
    """A leaf as a numpy array of its raw values: bf16 and e4m3 (torch, or
    numpy's ``bfloat16`` / ``float8_e4m3fn`` from `ml_dtypes`) as their
    int16 / uint8 words."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().contiguous()
        if a.dtype in _RAW_TORCH:
            return a.view(getattr(torch, _RAW_TORCH[a.dtype][1])).numpy()
        return a.numpy()
    a = np.ascontiguousarray(a)
    if a.dtype.name in _RAW:
        return a.view(_RAW[a.dtype.name][1])
    return a


def _dtype_name(a) -> str:
    if isinstance(a, torch.Tensor):
        if a.dtype in _RAW_TORCH:
            return _RAW_TORCH[a.dtype][0]
        return str(torch.empty((), dtype=a.dtype).numpy().dtype)
    return str(np.asarray(a).dtype)


def leaf_torch(a) -> torch.Tensor:
    """A leaf as a CPU torch tensor (numpy bf16 and e4m3 through their
    integer words)."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.ascontiguousarray(a)
    if a.dtype.name in _RAW:
        t, words = _RAW[a.dtype.name]
        return torch.from_numpy(a.view(words)).view(t)
    return torch.from_numpy(a)


def _pack(spec: dict, layers) -> bytes:
    chunks = []
    for i, layer in enumerate(layers):
        for leaf in leaves(layer):
            spec["leaves"].append({"layer": i, "dtype": _dtype_name(leaf),
                                   "shape": list(leaf.shape)})
            chunks.append(leaf_numpy(leaf).tobytes())
    head = json.dumps(spec).encode()
    buf = io.BytesIO()
    buf.write(len(head).to_bytes(8, "little"))
    buf.write(head)
    for c in chunks:
        buf.write(c)
    return buf.getvalue()


def _unpack(data: bytes):
    """(spec, layers or None): layers as per-layer leaves, one leaf bare,
    several as a tuple."""
    hlen = int.from_bytes(data[:8], "little")
    spec = json.loads(data[8:8 + hlen].decode())
    off = 8 + hlen
    by_layer: dict = {}
    for leaf in spec["leaves"]:
        name = leaf["dtype"]
        dt = np.dtype(_RAW[name][1] if name in _RAW else name)
        count = int(np.prod(leaf["shape"]))
        arr = np.frombuffer(data, dt, count, off).reshape(leaf["shape"])
        off += count * dt.itemsize
        t = torch.from_numpy(arr.copy())
        if name in _RAW:
            t = t.view(_RAW[name][0])
        by_layer.setdefault(leaf["layer"], []).append(t)
    if not by_layer:
        return spec, None
    return spec, [ls[0] if len(ls) == 1 else tuple(ls)
                  for _, ls in sorted(by_layer.items())]


def frame_to_bytes(frame: dict) -> bytes:
    """One streamed-KV frame (module docstring) as bytes."""
    spec = {"v": FRAME_WIRE_VERSION, "leaves": []}
    for k in _FRAME_KEYS:
        if k in frame:
            spec[k] = frame[k]
    return _pack(spec, frame.get("layers", []))


def frame_from_bytes(data: bytes) -> dict:
    spec, layers = _unpack(data)
    if spec.get("v", 1) > FRAME_WIRE_VERSION:
        raise ValueError(f"unsupported KV frame version {spec['v']}")
    out = {k: spec[k] for k in _FRAME_KEYS if k in spec}
    if layers is not None:
        out["layers"] = layers
    return out


def payload_to_bytes(payload: dict) -> bytes:
    """A whole-prompt KV payload as one framed blob."""
    return _pack({"num_tokens": payload["num_tokens"],
                  "block_size": payload["block_size"], "leaves": []},
                 payload["layers"])


def payload_from_bytes(data: bytes) -> dict:
    """The payload with per-layer leaves (the engine's inject matches them
    by order)."""
    spec, layers = _unpack(data)
    return {"layers": layers or [], "num_tokens": spec["num_tokens"],
            "block_size": spec["block_size"]}
