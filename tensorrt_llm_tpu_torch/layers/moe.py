"""Mixture-of-Experts layer with W4A16 experts.

Counterpart of `tensorrt_llm_tpu/layers/moe.py` on one device: tokens are
routed, the (token, expert) pairs sorted by expert, and the expert FFNs run
as two grouped W4A16 products (`ops/moe_w4a16.py`, kernel K5 on CUDA) with
a scatter-add finalize.  Routing variants: softmax -> top-k -> renormalize
(Mixtral); top-k on raw logits -> softmax over the k with a router bias
(GPT-OSS, with per-expert gate_up/down biases and the clamped swiglu); and
DeepSeek V3's noaux_tc (sigmoid scores, a score-correction bias used for
the selection only, group-limited top-k over the best groups by their top-2
sums with the other groups zero-filled as HF does, weights from the raw
scores renormalized and times `routed_scaling`), taken whenever the layer
has a score bias or more than one group -- with one group it is MiniMax-M2's
and EXAONE-MoE's sigmoid + bias routing; and Llama4's top-k on the raw
logits with sigmoid weights (`topk_then_sigmoid`, HF `Llama4Router`), whose
weight scales the expert's input row (`apply_weight_on_input`: the scaled
rows, rounded to bf16, go into K5's gate_up and the finalize weights are
1).  The shared experts (DeepSeek, GLM-4.5, dots.llm1, HunYuan, Llama4) are
a W4A16 `GatedMLP` of width ``n_shared_experts * intermediate_size``, or
of its own width `shared_intermediate_size` (Qwen2-MoE's
`shared_expert_intermediate_size`), whose output is added to the routed
sum in f32; under `shared_gate` (Qwen2-MoE, HF `Qwen2MoeSparseMoeBlock`)
it is first scaled by sigmoid(x . w_g), an f32 gate [H] per token.

The rounding points are the JAX package's: the gate_up product is rounded
to bf16, the expert bias is added in f32 and rounded to bf16, the
activation runs in f32 and rounds to bf16, and the down product, its bias,
the routing weights, the finalize and the shared experts' sum stay f32
until the bf16 output.

Group sizes stay on the device (a scatter-add of ones, not `bincount`,
which reads the largest id back), and K5's prologue derives the work units
from them on the device, once for both products, so a forward reads
nothing back to the host.  The finalize
puts each pair's row back in (token, choice) order and sums each token's
k rows in increasing expert order -- the order of the JAX package's
scatter over the expert-sorted pairs -- with no atomics, so it is
deterministic on the card.

Unquantized (bf16) experts -- the JAX package's choice for any quant
config outside the W4A16 family, W4A8_AWQ included -- run its
`jax.lax.ragged_dot` as a plain grouped product (`_ragged_dot`: one matrix
product per expert with rows, bf16 out), as the JAX package runs them in
XLA and not in a Pallas kernel; they read the group sizes back to the
host.

Not in this slice: the capacity factor, redundant expert slots and load
counters.  Expert and tensor parallelism have no option either: the layer
runs on one device.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import torch
from torch import nn

from tensorrt_llm_tpu_torch.layers.mlp import GatedMLP
from tensorrt_llm_tpu_torch.ops.moe_w4a16 import (
    gmm_work_units, quantize_experts_w4, w4a16_grouped_matmul)
from tensorrt_llm_tpu_torch.ops.w4a16_gemm import ACTIVATIONS
from tensorrt_llm_tpu_torch.quantization import QuantConfig

_LEAVES = ("router", "router_bias", "w_gate_up", "w_gate_up_s", "w_gate_up_z",
           "b_gate_up", "w_down", "w_down_s", "w_down_z", "b_down",
           "score_bias", "shared_gate")
_EXPERT_CHUNK = 16   # experts quantized at a time (bounds f32 temporaries)


class MoE(nn.Module):
    def __init__(self, hidden_size: int, intermediate_size: int,
                 num_experts: int, top_k: int, activation: str = "silu",
                 renormalize: bool = True, has_router_bias: bool = False,
                 topk_then_softmax: bool = False,
                 has_expert_bias: bool = False,
                 quant: Optional[QuantConfig] = None,
                 score_func: str = "softmax", has_score_bias: bool = False,
                 n_group: int = 1, topk_group: int = 1,
                 routed_scaling: float = 1.0, n_shared_experts: int = 0,
                 topk_then_sigmoid: bool = False,
                 apply_weight_on_input: bool = False,
                 shared_intermediate_size: int = 0,
                 shared_gate: bool = False):
        super().__init__()
        H, I = hidden_size, intermediate_size
        # int4 experts under the W4A16 family, bf16 experts otherwise, and
        # at odd widths, which int4 pairs cannot pack (JAX
        # `layers/moe.py:102-104`: plain products, as XLA runs them there)
        self.quant_experts = (quant is not None and quant.is_weight_only_w4
                              and not (H % 2 or I % 2))
        self.hidden_size = H
        self.intermediate_size = I
        self.num_experts = num_experts
        self.top_k = top_k
        self.activation = activation
        self.renormalize = renormalize
        self.has_router_bias = has_router_bias
        self.topk_then_softmax = topk_then_softmax
        self.topk_then_sigmoid = topk_then_sigmoid
        self.apply_weight_on_input = apply_weight_on_input
        self.has_expert_bias = has_expert_bias
        if score_func not in ("softmax", "sigmoid"):
            raise ValueError(f"MoE: unknown score_func {score_func!r}")
        if num_experts % n_group or not 0 < topk_group <= n_group:
            raise ValueError(f"MoE: {num_experts} experts in {n_group} "
                             f"groups, top {topk_group} groups")
        self.score_func = score_func
        self.has_score_bias = has_score_bias
        self.n_group = n_group
        self.topk_group = topk_group
        self.routed_scaling = routed_scaling
        Is = shared_intermediate_size or n_shared_experts * I
        self.shared = (GatedMLP(H, Is, activation, quant=quant)
                       if n_shared_experts and Is else None)
        self.has_shared_gate = shared_gate and self.shared is not None
        self.symmetric = not (quant is not None and quant.has_zero_point)
        gs = quant.group_size if quant is not None else 0
        # per-group scales where the group divides the width, else one
        # scale per channel (the JAX package's _g_up / _g_down)
        self.g_up = gs if 0 < gs < H and H % gs == 0 else -1
        self.g_down = gs if 0 < gs < I and I % gs == 0 else -1
        for leaf in _LEAVES:
            self.register_buffer(leaf, None)

    # ---- parameters -----------------------------------------------------
    def load_experts(self, chunks: Iterable[Tuple[torch.Tensor,
                                                  torch.Tensor,
                                                  torch.Tensor]]) -> None:
        """Quantize (or cast to bf16) the expert weights from consecutive
        chunks along the expert axis, each (gate [e, H, I], up [e, H, I],
        down [e, I, H]) full float, so that a caller can draw or read 256
        experts a few at a time.  gate and up are fused as [gate | up] along
        the output columns, the JAX package's interleave at tp = 1."""
        parts = []
        for gate_w, up_w, down_w in chunks:
            for lo in range(0, gate_w.shape[0], _EXPERT_CHUNK):
                hi = lo + _EXPERT_CHUNK
                fused = torch.cat([gate_w[lo:hi], up_w[lo:hi]], dim=2).to(
                    torch.float32)
                if not self.quant_experts:
                    parts.append((fused.to(torch.bfloat16), None, None,
                                  down_w[lo:hi].to(torch.bfloat16), None,
                                  None))
                    continue
                gu = quantize_experts_w4(fused, self.g_up, self.symmetric)
                del fused
                dn = quantize_experts_w4(down_w[lo:hi].to(torch.float32),
                                         self.g_down, self.symmetric)
                parts.append(gu[:3] + dn[:3])

        def cat(i):
            if parts[0][i] is None:
                return None
            return parts[0][i] if len(parts) == 1 else torch.cat(
                [p[i] for p in parts])

        (self.w_gate_up, self.w_gate_up_s, self.w_gate_up_z, self.w_down,
         self.w_down_s, self.w_down_z) = (cat(i) for i in range(6))
        if self.w_gate_up.shape[0] != self.num_experts:
            raise ValueError(f"MoE: {self.w_gate_up.shape[0]} experts loaded "
                             f"for {self.num_experts}")

    def from_float(self, router_w, gate_w, up_w, down_w, router_bias=None,
                   gate_b=None, up_b=None, down_b=None, score_bias=None,
                   shared_gate=None) -> None:
        """router_w [H, E]; gate/up [E, H, I]; down [E, I, H] (full float;
        None when `load_experts` already installed the experts);
        score_bias [E] (None: zeros); shared_gate [H] (Qwen2-MoE's
        ``shared_expert_gate``).  Shared experts load through
        `self.shared.from_float`."""
        self.router = router_w.to(torch.float32).contiguous()
        if self.has_shared_gate:
            self.shared_gate = shared_gate.reshape(-1).to(
                torch.float32).contiguous()
        if gate_w is not None:
            self.load_experts([(gate_w, up_w, down_w)])
        E, H, I = self.num_experts, self.hidden_size, self.intermediate_size
        dev = self.router.device
        if self.has_score_bias:
            self.score_bias = (torch.zeros(E, device=dev) if score_bias is None
                               else score_bias.to(torch.float32).contiguous())
        if self.has_router_bias:
            self.router_bias = (torch.zeros(E, device=dev)
                                if router_bias is None
                                else router_bias.to(torch.float32))
        if self.has_expert_bias:
            if gate_b is None:
                gate_b = torch.zeros((E, I), device=dev)
                up_b = torch.zeros((E, I), device=dev)
            if down_b is None:
                down_b = torch.zeros((E, H), device=dev)
            self.b_gate_up = torch.cat([gate_b, up_b], dim=1).to(
                torch.float32).contiguous()
            self.b_down = down_b.to(torch.float32).contiguous()

    def load(self, leaves) -> None:
        """Install buffers by leaf name (`load_state`).  A score-bias layer
        whose state has no bias -- the JAX package keeps none for
        MiniMax-M2 and EXAONE-MoE -- gets zeros, as `from_float` gives it."""
        for leaf, t in leaves.items():
            setattr(self, leaf, t)
        if self.has_score_bias and self.score_bias is None:
            self.score_bias = torch.zeros(self.num_experts,
                                          device=self.router.device)

    # ---- routing --------------------------------------------------------
    def route(self, x: torch.Tensor):
        """(topk_ids [T, k] int64, topk_weights [T, k] f32)."""
        logits = x.to(torch.float32) @ self.router                 # [T, E]
        if self.has_router_bias:
            logits = logits + self.router_bias[None, :]
        if self.topk_then_softmax or self.topk_then_sigmoid:
            vals, ids = torch.topk(logits, self.top_k, dim=-1)
            if self.topk_then_sigmoid:
                # HF Llama4Router's sigmoid over the -inf-scattered logits
                return ids, torch.sigmoid(vals)
            return ids, torch.softmax(vals, dim=-1)
        scores = (torch.softmax(logits, dim=-1) if self.score_func == "softmax"
                  else torch.sigmoid(logits))
        if self.has_score_bias or self.n_group > 1:
            return self._route_noaux_tc(scores)
        w, ids = torch.topk(scores, self.top_k, dim=-1)
        if self.renormalize:
            w = w / w.sum(dim=-1, keepdim=True)
        return ids, w * self.routed_scaling

    def _route_noaux_tc(self, scores: torch.Tensor):
        """DeepSeek V3 routing (HF DeepseekV3TopkRouter): the selection uses
        the bias-corrected scores within the best groups, the weights the
        raw scores."""
        T, E = scores.shape
        g = self.n_group
        choice = scores
        if self.has_score_bias:
            choice = scores + self.score_bias[None, :]
        if g > 1:
            grouped = choice.view(T, g, E // g)
            top2 = torch.topk(grouped, min(2, E // g), dim=-1).values
            gidx = torch.topk(top2.sum(dim=-1), self.topk_group,
                              dim=-1).indices                        # [T, tg]
            gmask = torch.zeros((T, g), dtype=torch.bool,
                                device=scores.device).scatter_(1, gidx, True)
            # HF zero-fills the other groups (not -inf); so does the JAX
            # package
            choice = torch.where(gmask.repeat_interleave(E // g, dim=1),
                                 choice, 0.0)
        ids = torch.topk(choice, self.top_k, dim=-1).indices
        w = torch.gather(scores, 1, ids)
        if self.renormalize:
            w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
        return ids, w * self.routed_scaling

    # ---- forward --------------------------------------------------------
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        T, H = x.shape
        k, E, I = self.top_k, self.num_experts, self.intermediate_size
        ids, weights = self.route(x)
        flat_ids = ids.reshape(-1)
        # (token, choice) pairs sorted by expert, stable as jnp.argsort
        order = torch.argsort(flat_ids, stable=True)
        sorted_e = flat_ids[order]
        sorted_tok = order // k
        sorted_w = weights.reshape(-1)[order]
        group_sizes = torch.zeros(E, dtype=torch.int32, device=x.device)
        group_sizes.scatter_add_(0, flat_ids, torch.ones_like(
            flat_ids, dtype=torch.int32))
        xs = x[sorted_tok].to(torch.bfloat16)
        if self.apply_weight_on_input:
            # Llama4: the routing weight scales the expert's input row (not
            # its output: the MLP is not linear), and the finalize weight
            # becomes 1
            xs = (xs.to(torch.float32) * sorted_w[:, None]).to(
                torch.bfloat16)
            sorted_w = torch.ones_like(sorted_w)
        if self.quant_experts:
            units = gmm_work_units(group_sizes, T * k)   # for both products
            h = w4a16_grouped_matmul(xs, self.w_gate_up, self.w_gate_up_s,
                                     group_sizes, units, self.w_gate_up_z
                                     ).to(torch.bfloat16)
        else:
            ends = torch.cumsum(group_sizes, 0).tolist()
            h = _ragged_dot(xs, self.w_gate_up, ends)
        if self.has_expert_bias:
            h = (h.to(torch.float32) + self.b_gate_up[sorted_e]).to(
                torch.bfloat16)
        gate = h[:, :I].to(torch.float32)
        up = h[:, I:].to(torch.float32)
        if self.activation == "swiglu_oai":
            # GPT-OSS clamped swiglu: (up + 1) * gate * sigmoid(1.702 gate)
            g = torch.clamp(gate, max=7.0)
            u = torch.clamp(up, -7.0, 7.0)
            h = ((u + 1.0) * g * torch.sigmoid(1.702 * g)).to(torch.bfloat16)
        else:
            h = (ACTIVATIONS[self.activation](gate) * up).to(torch.bfloat16)
        if self.quant_experts:
            out_sorted = w4a16_grouped_matmul(h, self.w_down, self.w_down_s,
                                              group_sizes, units,
                                              self.w_down_z)
        else:
            out_sorted = _ragged_dot(h, self.w_down, ends).to(torch.float32)
        if self.has_expert_bias:
            # added once per (token, expert) pair, before the routing weight
            out_sorted = out_sorted + self.b_down[sorted_e]
        contrib = out_sorted * sorted_w[:, None]
        # finalize: rows back to (token, choice) order, then each token's k
        # rows summed in increasing expert order
        pairs = torch.empty_like(contrib).index_copy_(0, order, contrib)
        pairs = pairs.view(T, k, H)
        by_expert = torch.argsort(ids, dim=1, stable=True)
        out = pairs[torch.arange(T, device=x.device)[:, None], by_expert]
        acc = out[:, 0]
        for j in range(1, k):
            acc = acc + out[:, j]
        if self.shared is not None:
            sh = self.shared(x).to(torch.float32)
            if self.has_shared_gate:
                sh = torch.sigmoid(x.to(torch.float32)
                                   @ self.shared_gate)[:, None] * sh
            acc = acc + sh
        return acc.to(x.dtype)


def _ragged_dot(x: torch.Tensor, w: torch.Tensor, ends) -> torch.Tensor:
    """`jax.lax.ragged_dot` of bf16 rows grouped by expert (group e ends at
    row ``ends[e]``) with bf16 weights [E, K, N]: each group's product
    accumulated in f32 and rounded once to bf16."""
    out = torch.zeros((x.shape[0], w.shape[2]), dtype=torch.bfloat16,
                      device=x.device)
    start = 0
    for e, end in enumerate(ends):
        if end > start:
            if x.device.type == "cuda":
                out[start:end] = torch.matmul(x[start:end], w[e])
            else:
                out[start:end] = (x[start:end].to(torch.float32)
                                  @ w[e].to(torch.float32)).to(torch.bfloat16)
        start = end
    return out
