"""Small shared helpers: shape math, logging and device selection.

Counterpart of `tensorrt_llm_tpu/utils/common.py` (`cdiv`, `round_up`,
logger).  `resolve_device` is new: every entry point of the port takes a
``device`` argument that defaults to CUDA and refuses to fall back to the CPU
on its own.  `upload` moves host arrays to the device without a host sync.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

logger = logging.getLogger("tensorrt_llm_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(
        logging.Formatter("[TLLM-TORCH] %(asctime)s %(levelname)s %(message)s"))
    logger.addHandler(_h)
logger.setLevel(os.environ.get("TLLM_LOG_LEVEL", "WARNING").upper())


def cdiv(a: int, b: int) -> int:
    """Ceiling division."""
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on.  CUDA unless the caller asks for
    the CPU; asking for CUDA on a machine without a GPU raises."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain PyTorch path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def upload(arr: np.ndarray, device) -> torch.Tensor:
    """A host numpy array as a tensor on `device` without a host sync: on a
    CUDA device it is staged in pinned memory (PyTorch's caching host
    allocator, which keeps the block until the copy has run) and copied
    with ``non_blocking=True``; on the CPU it is the array's own memory."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


_DIVISORS = {}


def div_scalar(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` correctly rounded on every device.  PyTorch's CUDA
    division by a Python number multiplies by its reciprocal, which is off
    by an ulp where 1/d is inexact (7, 15, 127): the card's scales, and
    the ints rounded against them, would then differ from the CPU's and
    the JAX package's.  Dividing by a tensor on x's device is an IEEE
    division on both; the divisor is made once per (device, dtype, d)."""
    key = (x.device, x.dtype, d)
    t = _DIVISORS.get(key)
    if t is None:
        t = _DIVISORS[key] = torch.full((), d, dtype=x.dtype,
                                        device=x.device)
    return x / t
