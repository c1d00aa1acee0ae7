"""Llama-4 text (HF `Llama4ForCausalLM`; the text stack of
`Llama4ForConditionalGeneration`).  Counterpart of
`tensorrt_llm_tpu/models/llama4.py`, semantics of HF `modeling_llama4.py`:

* every `no_rope_layer_interval`-th layer (or HF's `no_rope_layers` list)
  is NoPE: no RoPE, global attention, and the query temperature of
  `layers.attention` (`attn_temperature_tuning`);
* the RoPE layers rotate adjacent pairs, take an unweighted q/k RMS after
  RoPE (`use_qk_norm`) and attend within their `attention_chunk_size`
  chunk: they count as sliding, so they ride the VSWA rings where the
  engine makes them and take the plain ops (as the JAX engine sends them
  to XLA);
* a MoE every `interleave_moe_layer_step`-th layer: top-k on the raw
  router logits, sigmoid weights applied to the expert's input, and one
  always-on shared expert; the experts stored fused and stacked in HF
  (``feed_forward.experts.gate_up_proj`` [E, H, 2I], ``down_proj``
  [E, I, H]); experts and shared expert of `intermediate_size`, the dense
  layers of `intermediate_size_mlp`;
* a checkpoint of the multimodal class prefixes every text tensor with
  ``language_model.``.

The preset is the published text config (model-structure keys only) of
huggingface.co/meta-llama/Llama-4-Scout-17B-16E-Instruct, kept as the
port's own copy."""

from __future__ import annotations

import torch

from tensorrt_llm_tpu_torch.layers.moe import MoE
from tensorrt_llm_tpu_torch.models.modeling_utils import (
    DecoderModelForCausalLM, ModelConfig, hf_tensor, register_auto_model)

# Llama-4-Scout's published widths: 40/8 heads of 128, 16 experts of
# 8,192 (top 1) and one shared, every layer a MoE, chunks of 8,192 on three
# of every four layers
LLAMA4_SCOUT = {"hf_config": {
    "architectures": ["Llama4ForCausalLM"], "vocab_size": 202048,
    "hidden_size": 5120, "intermediate_size": 8192,
    "intermediate_size_mlp": 16384, "num_hidden_layers": 48,
    "num_attention_heads": 40, "num_key_value_heads": 8, "head_dim": 128,
    "num_local_experts": 16, "num_experts_per_tok": 1,
    "interleave_moe_layer_step": 1, "no_rope_layer_interval": 4,
    "attention_chunk_size": 8192, "use_qk_norm": True,
    "attn_temperature_tuning": True, "floor_scale": 8192, "attn_scale": 0.1,
    "rope_theta": 500000.0,
    "rope_scaling": {"rope_type": "llama3", "factor": 16.0,
                     "low_freq_factor": 1.0, "high_freq_factor": 1.0,
                     "original_max_position_embeddings": 8192},
    "rms_norm_eps": 1e-5, "max_position_embeddings": 10485760,
    "attention_bias": False, "tie_word_embeddings": False}}


@register_auto_model("Llama4ForCausalLM", "Llama4ForConditionalGeneration")
class Llama4ForCausalLM(DecoderModelForCausalLM):
    HF_MODEL_TYPE = "llama4_text"
    HF_EXTRA_KEYS = ("use_qk_norm", "attn_temperature_tuning", "floor_scale",
                     "attn_scale", "no_rope_layer_interval",
                     "interleave_moe_layer_step", "intermediate_size_mlp")
    MOE_SHARED_PREFIX = "feed_forward.shared_expert."

    def __init__(self, cfg: ModelConfig, device="cuda"):
        ex = cfg.extra
        cfg.gqa_rope_interleave = True
        cfg.qk_norm_l2 = bool(ex.get("use_qk_norm", True))
        cfg.attn_temperature_tuning = bool(
            ex.get("attn_temperature_tuning", True))
        cfg.floor_scale = float(ex.get("floor_scale", 8192.0))
        cfg.attn_scale = float(ex.get("attn_scale", 0.1))
        cfg.no_rope_layer_interval = int(ex.get("no_rope_layer_interval", 4))
        if cfg.attention_chunk_size is None:
            cfg.attention_chunk_size = 8192
        if cfg.num_experts > 0:
            cfg.moe_topk_then_sigmoid = True
            cfg.moe_apply_router_weight_on_input = True
            cfg.norm_topk_prob = False
            cfg.n_shared_experts = 1
            cfg.decoder_sparse_step = int(
                ex.get("interleave_moe_layer_step", 1))
            # the experts keep HF's `intermediate_size` (the config has no
            # `moe_intermediate_size`, so it took that width), the dense
            # layers take `intermediate_size_mlp`
            cfg.intermediate_size = int(
                ex.get("intermediate_size_mlp", cfg.intermediate_size))
        super().__init__(cfg, device)

    @torch.no_grad()
    def load_hf_weights(self, get_tensor, mtp_sink=None):
        def get(name):
            a = get_tensor(name)
            return a if a is not None else get_tensor("language_model." + name)
        return super().load_hf_weights(get, mtp_sink)

    def _load_mlp(self, layer, get_tensor, pre, t, vec) -> None:
        mlp = layer.mlp
        ff = pre + "feed_forward."
        if not isinstance(mlp, MoE):
            mlp.from_float(t(ff + "gate_proj.weight"),
                           t(ff + "up_proj.weight"),
                           t(ff + "down_proj.weight"))
            return
        dev, I = self.device, mlp.intermediate_size
        gu = hf_tensor(get_tensor, ff + "experts.gate_up_proj", "cpu")
        down = hf_tensor(get_tensor, ff + "experts.down_proj", "cpu")
        mlp.load_experts(
            (gu[lo:lo + 16, :, :I].to(dev), gu[lo:lo + 16, :, I:].to(dev),
             down[lo:lo + 16].to(dev))
            for lo in range(0, mlp.num_experts, 16))
        del gu, down
        self._load_moe_rest(mlp, pre, t, vec, ff + "router.weight")
