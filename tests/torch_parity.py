"""Helpers shared by the port's parity tests (`tests/test_torch_*.py`)."""

import queue
import threading

import numpy as np
import torch

from tensorrt_llm_tpu_torch.attention_backend import AttentionMetadata
from tensorrt_llm_tpu_torch.models import get_model_class
from tensorrt_llm_tpu_torch.runtime.kv_cache_manager import model_pools


def jax_generate(jl, prompts, sampling_params):
    """Greedy token ids from the JAX `LLM` with the whole batch admitted
    before its executor's first step.  Its `generate` submits requests one
    by one while the executor thread runs, so under load the first steps
    could see part of the batch and the chunk schedule would depend on
    thread timing; the port's `generate` admits a batch at once."""
    ex = jl.executor
    real = ex.request_queue
    gate = threading.Event()

    class _Gated:
        def get_nowait(self):
            if not gate.is_set():
                raise queue.Empty
            return real.get_nowait()

        def __getattr__(self, name):
            return getattr(real, name)

    ex.request_queue = _Gated()
    try:
        futs = [jl.generate_async(p, sampling_params) for p in prompts]
        gate.set()
        return [f.result().outputs[0].token_ids for f in futs]
    finally:
        ex.request_queue = real


def port_logits(cfg, params, tokens, block_size=8, kv_quant="NONE"):
    """The port's last-row logits after `tokens`, one prefill of a fresh
    CPU model with `params` on fresh pools (bf16, or INT8 for
    ``kv_quant="INT8"``)."""
    m = get_model_class(cfg.architecture)(cfg, "cpu").load_state(params)
    n = len(tokens)
    blocks = list(range(1, -(-n // block_size) + 1))
    caches = model_pools(cfg, len(blocks) + 1, block_size, kv_quant, "cpu")
    meta = AttentionMetadata(
        positions=torch.arange(n), mode="prefill", q_offset=0,
        slot_mapping=torch.tensor([blocks[p // block_size] * block_size
                                   + p % block_size for p in range(n)]),
        block_tables=torch.tensor([blocks], dtype=torch.int32),
        kv_lens=torch.tensor([n], dtype=torch.int32))
    with torch.no_grad():
        return m(torch.tensor(tokens), caches, meta,
                 torch.tensor([n - 1]))[0].numpy()


# ---- HF checkpoints written by the tests --------------------------------
def hf_tensor_shapes(hf):
    """HF tensor names -> (shape, kind) of a Llama, Mistral, Mixtral,
    GPT-OSS or DeepSeek V3 (V3.2) checkpoint of config dict `hf`, as
    transformers saves them (linears [out, in]).  kind: "embed", "linear",
    "norm", "bias", "sinks", "score_bias"."""
    g = hf.get
    arch = g("architectures")[0]
    H, V, L = g("hidden_size"), g("vocab_size"), g("num_hidden_layers")
    nh = g("num_attention_heads")
    nkv = g("num_key_value_heads") or nh
    out = {"model.embed_tokens.weight": ((V, H), "embed"),
           "model.norm.weight": ((H,), "norm")}
    if not g("tie_word_embeddings", False):
        out["lm_head.weight"] = ((V, H), "linear")
    deepseek = g("kv_lora_rank") is not None
    dense = set(range(g("first_k_dense_replace") or 0))
    E = g("num_local_experts") or g("n_routed_experts") or 0
    for i in range(L):
        p = f"model.layers.{i}."
        out[p + "input_layernorm.weight"] = ((H,), "norm")
        out[p + "post_attention_layernorm.weight"] = ((H,), "norm")
        a = p + "self_attn."
        if deepseek:
            Lr, R = g("kv_lora_rank"), g("qk_rope_head_dim")
            N, Vd, Q = g("qk_nope_head_dim"), g("v_head_dim"), g("q_lora_rank")
            if Q is None:
                out[a + "q_proj.weight"] = ((nh * (N + R), H), "linear")
            else:
                out[a + "q_a_proj.weight"] = ((Q, H), "linear")
                out[a + "q_a_layernorm.weight"] = ((Q,), "norm")
                out[a + "q_b_proj.weight"] = ((nh * (N + R), Q), "linear")
            out[a + "kv_a_proj_with_mqa.weight"] = ((Lr + R, H), "linear")
            out[a + "kv_a_layernorm.weight"] = ((Lr,), "norm")
            out[a + "kv_b_proj.weight"] = ((nh * (N + Vd), Lr), "linear")
            out[a + "o_proj.weight"] = ((H, nh * Vd), "linear")
            if g("index_topk"):
                Hi, Di = g("index_n_heads"), g("index_head_dim")
                ix = a + "indexer."
                out[ix + "wq_b.weight"] = ((Hi * Di, Q), "linear")
                out[ix + "wk.weight"] = ((Di, H), "linear")
                out[ix + "k_norm.weight"] = ((Di,), "norm")
                out[ix + "k_norm.bias"] = ((Di,), "bias")
                out[ix + "weights_proj.weight"] = ((Hi, H), "linear")
        else:
            D = g("head_dim") or H // nh
            for n, o, k in (("q", nh * D, H), ("k", nkv * D, H),
                            ("v", nkv * D, H), ("o", H, nh * D)):
                out[a + f"{n}_proj.weight"] = ((o, k), "linear")
                if g("attention_bias"):
                    out[a + f"{n}_proj.bias"] = ((o,), "bias")
            if arch == "GptOssForCausalLM":
                out[a + "sinks"] = ((nh,), "sinks")
        I = g("intermediate_size")
        if E == 0 or i in dense:
            for n, o, k in (("gate", I, H), ("up", I, H), ("down", H, I)):
                out[p + f"mlp.{n}_proj.weight"] = ((o, k), "linear")
        elif arch == "GptOssForCausalLM":
            m = p + "mlp."
            out[m + "router.weight"] = ((E, H), "linear")
            out[m + "router.bias"] = ((E,), "bias")
            out[m + "experts.gate_up_proj"] = ((E, H, 2 * I), "linear")
            out[m + "experts.gate_up_proj_bias"] = ((E, 2 * I), "bias")
            out[m + "experts.down_proj"] = ((E, I, H), "linear")
            out[m + "experts.down_proj_bias"] = ((E, H), "bias")
        elif arch == "MixtralForCausalLM":
            m = p + "block_sparse_moe."
            out[m + "gate.weight"] = ((E, H), "linear")
            for j in range(E):
                for n, o, k in (("w1", I, H), ("w3", I, H), ("w2", H, I)):
                    out[m + f"experts.{j}.{n}.weight"] = ((o, k), "linear")
        else:
            Im = g("moe_intermediate_size")
            m = p + "mlp."
            out[m + "gate.weight"] = ((E, H), "linear")
            out[m + "gate.e_score_correction_bias"] = ((E,), "score_bias")
            for j in range(E):
                for n, o, k in (("gate", Im, H), ("up", Im, H),
                                ("down", H, Im)):
                    out[m + f"experts.{j}.{n}_proj.weight"] = ((o, k),
                                                               "linear")
            Is = Im * (g("n_shared_experts") or 0)
            if Is:
                for n, o, k in (("gate", Is, H), ("up", Is, H),
                                ("down", H, Is)):
                    out[m + f"shared_experts.{n}_proj.weight"] = ((o, k),
                                                                  "linear")
    return out


def hf_checkpoint_tensors(hf, seed):
    """Seeded numpy f32 tensors at `hf_tensor_shapes(hf)`: linears
    N(0, 0.5^2 / in), the embedding N(0, 0.02^2), norms 1 + N(0, 0.02^2),
    biases N(0, 0.02^2), sinks N(0, 0.25), score biases N(0, 0.05^2)."""
    rng = np.random.default_rng(seed)
    std = {"embed": lambda s: 0.02, "norm": lambda s: 0.02,
           "bias": lambda s: 0.02, "sinks": lambda s: 0.5,
           "score_bias": lambda s: 0.05,
           "linear": lambda s: 0.5 / np.sqrt(s[-2] if len(s) == 3 else s[-1])}
    out = {}
    for name, (shape, kind) in hf_tensor_shapes(hf).items():
        a = rng.standard_normal(shape).astype(np.float32) * std[kind](shape)
        out[name] = a + 1.0 if kind == "norm" else a
    return out


def write_hf_checkpoint(path, hf, seed=0, dtype=torch.bfloat16, shards=2,
                        tensors=None):
    """config.json plus `shards` safetensors files (written with the
    `safetensors` library) of `hf_checkpoint_tensors(hf, seed)` (or of
    `tensors`, numpy or torch) in `dtype`.  Returns the tensors as
    written (torch)."""
    import json
    from safetensors.torch import save_file
    tensors = hf_checkpoint_tensors(hf, seed) if tensors is None else tensors
    out = {}
    for k, v in tensors.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(v)
        out[k] = t.to(dtype) if t.is_floating_point() else t
    names = sorted(out)
    for s in range(shards):
        part = {k: out[k].contiguous() for k in names[s::shards]}
        save_file(part, str(path / f"model-{s + 1:05d}-of-{shards:05d}"
                                   ".safetensors"))
    (path / "config.json").write_text(json.dumps(hf))
    return out
