"""Runtime multi-LoRA: many adapters served concurrently.

Counterpart of `tensorrt_llm_tpu/lora/multi_lora.py`: the adapters are
stacked into per-layer tensors on the device (slot 0 is the zero adapter,
the base model), every request carries an adapter slot (`lora_slot`, its
rows' `AttentionMetadata.lora_ids`), and each targeted linear adds its
per-row low-rank side product after the base linear's kernel

    y += (x @ A[slot]) @ B[slot]        (scaling folded into B)

as one batched product over the live slots and a one-hot row select
(`apply_lora`).  The rank-r products are plain torch matrix products, as
the JAX package computes them outside any Pallas kernel: LoRA adds no
kernel launch and replaces none.

Fused projections: the q/k/v (and gate/up) adapters concatenate along the
rank axis with their B factors placed in the fused output's column ranges,
so one (A, B) pair covers a fused linear.  The stacks of a layer are the
buffers ``lora_qkv_a`` / ``lora_qkv_b`` and ``lora_o_a`` / ``lora_o_b`` of
its `Attention` and ``lora_gate_up_*`` / ``lora_down_*`` of its `GatedMLP`
(`params_from_jax` maps the JAX package's ``lora`` subtrees onto them).

`PagedMultiLoraManager` (JAX's paged PEFT cache): at most
`max_device_adapters` adapters live in the device slots; `acquire` pins an
adapter's slot for a request's lifetime, swapping it into the least
recently used unpinned slot when absent (waiting on a condition when every
slot is pinned), and the request's `on_finished` hook releases it.  Every
stack is sized to the pool-wide rank so that any adapter fits any slot.  A
swap-in writes the slot's rows of the device stacks under the engine lock,
in stream order: a step already dispatched reads the old rows, every later
one the new.

Refused with ValueError where the JAX package is silent: a DoRA adapter at
run time (its row renormalization depends on the merged weight: merge it
with `lora_path`), and adapters on layers that would ignore the stacks
(MLA attention, MoE experts).  `interleave_columns` is the JAX package's
tensor-parallel column layout, reached only at `tp` > 1, which the port
refuses.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from tensorrt_llm_tpu_torch.lora.lora_manager import (
    LoraAdapter, load_lora_adapter)
from tensorrt_llm_tpu_torch.utils import logger

# fused linear -> the layer's submodule that holds its stacks
LORA_TARGETS = {"qkv": "attn", "o": "attn", "gate_up": "mlp", "down": "mlp"}


class MultiLoraManager:
    """Builds the stacked per-layer adapter tensors of a Llama-family
    model (slot i + 1 is adapter ``names[i + 1]``)."""

    def __init__(self, adapters: Dict[str, LoraAdapter], cfg):
        self.names = ["<base>"] + sorted(adapters)
        self.slots = {n: i for i, n in enumerate(self.names)}
        self.adapters = adapters
        self.cfg = cfg
        # paged mode sizes the ranks against the whole adapter pool
        self._rank_adapters: Optional[Dict[str, LoraAdapter]] = None

    @classmethod
    def from_paths(cls, paths: Dict[str, str], cfg) -> "MultiLoraManager":
        adapters = {name: load_lora_adapter(p) for name, p in paths.items()}
        for name, a in adapters.items():
            if a.is_dora:
                raise ValueError(
                    f"adapter {name!r} is DoRA: runtime multi-LoRA adds "
                    "B @ A per row and cannot renormalize the merged rows; "
                    "merge it at load with lora_path=")
        check_lora_targets(adapters, cfg)
        return cls(adapters, cfg)

    def slot_of(self, name: Optional[str]) -> int:
        if name is None:
            return 0
        return self.slots[name]

    # ---- stacked tensors ---------------------------------------------------
    def _fused(self, layer: int, subs: List[Tuple[str, int, int]],
               in_dim: int, out_dim: int):
        """One fused linear's stacks: (A [L, in, R], B [L, R, out]) numpy
        f32 with each module's scaling folded into B, or None when no
        adapter touches it.  `subs` are (HF suffix, column lo, hi)."""
        L = len(self.names)
        per = []
        for name in self.names[1:]:
            ad = self.adapters[name]
            pairs = []
            for suffix, lo, hi in subs:
                key = f"model.layers.{layer}.{suffix}"
                if key in ad.weights:
                    A, B = ad.weights[key]
                    pairs.append((A, B, lo, hi))
            per.append(pairs)
        if self._rank_adapters is None:
            if not any(per):
                return None
            r_tot = max(sum(A.shape[0] for A, _, _, _ in pairs) or 1
                        for pairs in per)
        else:
            r_tot = 0
            for ad in self._rank_adapters.values():
                r = sum(ad.weights[f"model.layers.{layer}.{suffix}"][0]
                        .shape[0] for suffix, _, _ in subs
                        if f"model.layers.{layer}.{suffix}" in ad.weights)
                r_tot = max(r_tot, r)
            if r_tot == 0:
                return None
        r_tot = max(r_tot, 1)
        A_st = np.zeros((L, in_dim, r_tot), np.float32)
        B_st = np.zeros((L, r_tot, out_dim), np.float32)
        for li, pairs in enumerate(per):
            off = 0
            ad = self.adapters[self.names[li + 1]]
            for A, B, lo, hi in pairs:
                r = A.shape[0]
                A_st[li + 1, :, off:off + r] = A.T
                B_st[li + 1, off:off + r, lo:hi] = \
                    B.T * ad.module_scaling(r)
                off += r
        return A_st, B_st

    def build_layer_lora(self, layer: int, tp: int = 1) -> Dict:
        """A layer's stacks by fused linear name (JAX
        `build_layer_lora`)."""
        cfg = self.cfg
        D = cfg.head_dim
        qd = cfg.num_heads * D
        kvd = cfg.num_kv_heads * D
        H, I = cfg.hidden_size, cfg.intermediate_size
        out = {}
        v = self._fused(layer, [("self_attn.q_proj", 0, qd),
                                ("self_attn.k_proj", qd, qd + kvd),
                                ("self_attn.v_proj", qd + kvd, qd + 2 * kvd)],
                        H, qd + 2 * kvd)
        if v is not None:
            A, B = v
            if tp > 1:
                B = interleave_columns(
                    B, [(0, qd), (qd, qd + kvd), (qd + kvd, qd + 2 * kvd)],
                    tp)
            out["qkv"] = (A, B)
        v = self._fused(layer, [("self_attn.o_proj", 0, H)], qd, H)
        if v is not None:
            out["o"] = v
        v = self._fused(layer, [("mlp.gate_proj", 0, I),
                                ("mlp.up_proj", I, 2 * I)], H, 2 * I)
        if v is not None:
            A, B = v
            if tp > 1:
                B = interleave_columns(B, [(0, I), (I, 2 * I)], tp)
            out["gate_up"] = (A, B)
        v = self._fused(layer, [("mlp.down_proj", 0, H)], I, H)
        if v is not None:
            out["down"] = v
        return out

    def attach(self, model, dtype=torch.bfloat16) -> None:
        """Install the stacks on the model's layers (JAX `attach`), cast to
        `dtype` on the model's device."""
        n = 0
        for i, layer in enumerate(model.layers):
            for key, (A, B) in self.build_layer_lora(i).items():
                holder = getattr(layer, LORA_TARGETS[key])
                setattr(holder, f"lora_{key}_a",
                        torch.from_numpy(A).to(model.device, dtype))
                setattr(holder, f"lora_{key}_b",
                        torch.from_numpy(B).to(model.device, dtype))
                n += 1
        logger.info("multi-LoRA: %d adapters (%s), %d fused linears patched",
                    len(self.names) - 1, self.names[1:], n)


class PagedMultiLoraManager(MultiLoraManager):
    """Bounded device adapter slots with LRU paging (module docstring)."""

    def __init__(self, adapters: Dict[str, LoraAdapter], cfg,
                 max_device_adapters: int = 4):
        if not adapters:
            raise ValueError("paged multi-LoRA needs at least one adapter")
        self.capacity = max(1, min(max_device_adapters, len(adapters)))
        resident = sorted(adapters)[:self.capacity]
        super().__init__({n: adapters[n] for n in resident}, cfg)
        self.all_adapters = dict(adapters)
        self._rank_adapters = self.all_adapters
        self._engine = None
        self._refs: Dict[str, int] = {n: 0 for n in resident}
        self._lru: List[str] = list(resident)    # least recent first
        self.num_swaps = 0
        # acquire runs on submitting threads, release on the executor's
        self._cond = threading.Condition()

    def bind_engine(self, engine) -> None:
        self._engine = engine

    def _touch(self, name: str) -> None:
        if name in self._lru:
            self._lru.remove(name)
        self._lru.append(name)

    def _has_victim(self) -> bool:
        return any(self._refs.get(c, 0) == 0 for c in self._lru)

    def acquire(self, name: Optional[str], timeout: float = 120.0,
                wait: bool = True) -> Optional[int]:
        """The slot of `name`, swapped in when absent, pinned until
        `release`.  When every slot is pinned it waits up to `timeout`
        seconds for one to free (RuntimeError past it), or with
        ``wait=False`` returns None at once.  KeyError for an unknown
        adapter."""
        if name is None:
            return 0
        if name not in self.all_adapters:
            raise KeyError(name)
        deadline = time.monotonic() + timeout
        with self._cond:
            while name not in self.slots and not self._has_victim():
                remaining = deadline - time.monotonic()
                if not wait:
                    return None
                if remaining <= 0:
                    raise RuntimeError(
                        "all device adapter slots stayed pinned for "
                        f"{timeout:.0f} s: raise lora_max_device_adapters")
                self._cond.wait(timeout=min(remaining, 1.0))
            if name not in self.slots:
                self._swap_in(name)
            self._refs[name] = self._refs.get(name, 0) + 1
            self._touch(name)
            return self.slots[name]

    def release(self, name: Optional[str]) -> None:
        if not name:
            return
        with self._cond:
            if name in self._refs:
                self._refs[name] = max(self._refs[name] - 1, 0)
                if self._refs[name] == 0:
                    self._cond.notify_all()

    def _swap_in(self, name: str) -> None:
        if self._engine is None:
            raise RuntimeError("bind_engine() before serving")
        victim = next(c for c in self._lru if self._refs.get(c, 0) == 0)
        slot = self.slots.pop(victim)
        self.adapters.pop(victim)
        self._refs.pop(victim, None)
        self._lru.remove(victim)
        self.adapters[name] = self.all_adapters[name]
        self.slots[name] = slot
        self.names[slot] = name
        self._refs[name] = 0
        self.num_swaps += 1
        one = MultiLoraManager({name: self.all_adapters[name]}, self.cfg)
        one._rank_adapters = self.all_adapters
        eng = self._engine
        with eng.lock:
            for i, layer in enumerate(eng.model.layers):
                for key, (A, B) in one.build_layer_lora(i).items():
                    holder = getattr(layer, LORA_TARGETS[key])
                    for suffix, src in (("a", A[1]), ("b", B[1])):
                        st = getattr(holder, f"lora_{key}_{suffix}")
                        st[slot].copy_(torch.from_numpy(src).to(st.dtype))
        logger.info("multi-LoRA: paged %r into slot %d (evicted %r)",
                    name, slot, victim)


def check_lora_targets(adapters: Dict[str, LoraAdapter], cfg) -> None:
    """Refuse adapters the model's layers would ignore: any adapter on an
    MLA model (its attention has no q/k/v/o stacks) and an MLP adapter on
    an MoE layer (the experts take no stacks)."""
    for name, ad in adapters.items():
        for mod in ad.weights:
            parts = mod.split(".")
            if cfg.is_mla:
                raise ValueError(
                    f"adapter {name!r}: runtime LoRA on an MLA model is not "
                    "supported (its attention would ignore the adapter)")
            if len(parts) > 3 and parts[:2] == ["model", "layers"] \
                    and parts[3] == "mlp" and cfg.is_moe_layer(int(parts[2])):
                raise ValueError(
                    f"adapter {name!r} targets {mod}, an MoE layer's MLP: "
                    "the experts take no LoRA stacks")


def _product_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched ``a @ b`` of bf16 operands with an f32 result: in f32 on the
    CPU (JAX's ``preferred_element_type=f32``), the bf16 tensor-core
    product (f32 accumulation) on the card, whose bf16 result each caller
    rounds to anyway (`apply_lora`)."""
    if a.device.type == "cuda":
        return torch.matmul(a, b).to(torch.float32)
    return torch.matmul(a.to(torch.float32), b.to(torch.float32))


def apply_lora(x: torch.Tensor, base_out: torch.Tensor, lora: Tuple,
               lora_ids: torch.Tensor) -> torch.Tensor:
    """`base_out` plus each row's adapter product (slot 0 adds nothing),
    with JAX's casts: the rank-r product in f32, cast to B's dtype, the
    output product in f32, and the selected sum cast to `base_out`'s
    dtype.  x [T, in], lora = (A [L, in, R], B [L, R, out]), lora_ids [T];
    on the card every product is one batched matrix product over the live
    slots."""
    A, B = lora
    L = A.shape[0]
    if L <= 1:
        return base_out
    xa = x.to(A.dtype).unsqueeze(0).expand(L - 1, -1, -1)
    hs = _product_f32(xa, A[1:])                         # [L-1, T, R]
    ds = _product_f32(hs.to(B.dtype), B[1:])             # [L-1, T, out]
    sel = (lora_ids.unsqueeze(0) == torch.arange(
        1, L, device=lora_ids.device).unsqueeze(1)).to(torch.float32)
    return base_out + torch.einsum("lt,lto->to", sel, ds).to(base_out.dtype)


def interleave_columns(mat: np.ndarray, seg_bounds, tp: int) -> np.ndarray:
    """Permute the last axis from segment-major [s0 | s1 | ..] to the fused
    tensor-parallel layout [s0_r0 | s1_r0 | .. | s0_r1 | ..]."""
    idx = []
    for r in range(tp):
        for lo, hi in seg_bounds:
            per = (hi - lo) // tp
            idx.extend(range(lo + r * per, lo + (r + 1) * per))
    return mat[..., np.array(idx)]
