"""Phi-3 / Phi-4 (HF `Phi3ForCausalLM`).  Counterpart of
`tensorrt_llm_tpu/models/phi.py`: the Llama decoder whose checkpoints ship
fused `qkv_proj` and `gate_up_proj` tensors, split back into the
per-projection tensors at load."""

from __future__ import annotations

from tensorrt_llm_tpu_torch.models.modeling_utils import (
    DecoderModelForCausalLM, register_auto_model)

# Phi-4's published widths (HF microsoft/phi-4 config.json)
PHI_4 = {"hf_config": {
    "architectures": ["Phi3ForCausalLM"], "vocab_size": 100352,
    "hidden_size": 5120, "intermediate_size": 17920,
    "num_hidden_layers": 40, "num_attention_heads": 40,
    "num_key_value_heads": 10, "rope_theta": 250000.0,
    "rms_norm_eps": 1e-5, "max_position_embeddings": 16384,
    "tie_word_embeddings": False}}

# (per-projection name, fused name, which rows of the fused [out, in])
_FUSED = (("self_attn.q_proj.weight", "self_attn.qkv_proj.weight", "q"),
          ("self_attn.k_proj.weight", "self_attn.qkv_proj.weight", "k"),
          ("self_attn.v_proj.weight", "self_attn.qkv_proj.weight", "v"),
          ("mlp.gate_proj.weight", "mlp.gate_up_proj.weight", "gate"),
          ("mlp.up_proj.weight", "mlp.gate_up_proj.weight", "up"))


@register_auto_model("Phi3ForCausalLM", "Phi4ForCausalLM")
class Phi3ForCausalLM(DecoderModelForCausalLM):
    HF_MODEL_TYPE = "phi3"

    def load_hf_weights(self, get_tensor, mtp_sink=None):
        cfg = self.cfg
        qd = cfg.num_heads * cfg.head_dim
        kvd = cfg.num_kv_heads * cfg.head_dim
        I = cfg.intermediate_size
        rows = {"q": slice(0, qd), "k": slice(qd, qd + kvd),
                "v": slice(qd + kvd, None), "gate": slice(0, I),
                "up": slice(I, None)}

        def split(name):
            a = get_tensor(name)
            if a is not None:
                return a
            for own, fused, part in _FUSED:
                if name.endswith("." + own):
                    f = get_tensor(name[:-len(own)] + fused)
                    return None if f is None else f[rows[part]]
            return None
        return super().load_hf_weights(split, mtp_sink)
