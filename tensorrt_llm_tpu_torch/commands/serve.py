"""`trtllm-torch-serve`: the OpenAI-compatible serving CLI of the port.

Counterpart of `tensorrt_llm_tpu/commands/serve.py` (the reference's
`trtllm-serve`), with its flags: `model` is an HF checkpoint directory (or
a shape preset of `commands/bench.py`'s `MODEL_SHAPES`, random weights from
``seed``), served by `serve/openai_server.py` until SIGINT.
``--extra-llm-api-options`` names a file of `LlmArgs` field overrides: JSON,
or YAML where the `yaml` package imports (``skip_tokenizer_init: true``
serves token-id prompts on a machine without `transformers`).  ``--device``
(default ``cuda``) is the port's own flag.

Flags of slices not in the port yet raise with the slice's name:
``--tp-size`` above 1 (tensor parallelism), ``--register-to``,
``--advertise-url`` and ``--disagg-role`` (and the ``disaggregated``
subcommand: disaggregated serving), ``--mm-encoder-only`` (the multimodal
encoder).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

_DISAGG = ("disaggregated serving (serve/disagg_server.py and "
           "llmapi/disagg_params.py) is not in the port yet")


def load_overrides(path: str) -> dict:
    """`LlmArgs` overrides from a JSON file, or a YAML one where `yaml`
    imports."""
    with open(path) as f:
        text = f.read()
    try:
        data = json.loads(text)
    except ValueError:
        try:
            import yaml
        except ImportError:
            raise ValueError(
                f"{path} is not JSON, and YAML needs the `yaml` package, "
                "which does not import here: write the overrides as JSON"
            ) from None
        data = yaml.safe_load(text)
    if data is None:
        return {}
    if not isinstance(data, dict):
        raise ValueError(f"{path}: the overrides must be a mapping")
    return data


def build_llm(args):
    from tensorrt_llm_tpu_torch.commands.bench import MODEL_SHAPES, preset_model
    from tensorrt_llm_tpu_torch.llmapi import LLM, LlmArgs
    if args.tp_size > 1:
        raise NotImplementedError(
            "--tp-size > 1 needs the tensor-parallel mapping "
            "(tensorrt_llm_tpu_torch.parallel), not in the port yet")
    if args.register_to or args.advertise_url or \
            args.disagg_role is not None:
        raise NotImplementedError(
            "--register-to / --advertise-url / --disagg-role: " + _DISAGG)
    if args.mm_encoder_only:
        raise NotImplementedError(
            "--mm-encoder-only needs the multimodal encoder, not in the "
            "port yet")
    kw = dict(device=args.device, max_batch_size=args.max_batch_size,
              max_num_tokens=args.max_num_tokens,
              max_seq_len=args.max_seq_len, quant_algo=args.quant,
              kv_block_size=args.kv_block_size)
    model = args.model
    if model in MODEL_SHAPES:
        model = preset_model(model, kw)
    if args.extra_llm_api_options:
        over = load_overrides(args.extra_llm_api_options)
        names = {f.name for f in dataclasses.fields(LlmArgs)}
        bad = sorted(set(over) - names)
        if bad:
            raise ValueError(f"unknown LlmArgs fields in overrides: {bad}")
        kw.update(over)
    return LLM(model=model, **kw)


def main(argv=None):
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    if argv and argv[0] == "disaggregated":
        raise NotImplementedError("trtllm-torch-serve disaggregated: "
                                  + _DISAGG)
    p = argparse.ArgumentParser("trtllm-torch-serve")
    p.add_argument("model", help="HF checkpoint directory, or a preset of "
                   "trtllm-torch-bench's MODEL_SHAPES")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--tp-size", type=int, default=1)
    p.add_argument("--max-batch-size", type=int, default=64)
    p.add_argument("--max-num-tokens", type=int, default=2048)
    p.add_argument("--max-seq-len", type=int, default=2048)
    p.add_argument("--quant", default=None,
                   help="W4A16 | W4A16_AWQ | W4A16_GPTQ | W4A8_AWQ")
    p.add_argument("--kv-block-size", type=int, default=16)
    p.add_argument("--served-model-name", default=None)
    p.add_argument("--tool-parser", default=None,
                   help="function-call parser family: qwen3 | deepseek_v3 "
                        "| harmony | ...")
    p.add_argument("--reasoning-parser", default=None,
                   help="split <think> blocks into reasoning_content: "
                        "deepseek-r1 | qwen3 | nano-v3")
    p.add_argument("--register-to", default=None)
    p.add_argument("--advertise-url", default=None)
    p.add_argument("--disagg-role", default=None,
                   choices=["context", "generation"])
    p.add_argument("--extra-llm-api-options", default=None,
                   help="JSON (or YAML, where yaml imports) file of LlmArgs "
                        "overrides")
    p.add_argument("--mm-encoder-only", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from tensorrt_llm_tpu_torch.serve.openai_server import OpenAIServer
    llm = build_llm(args)
    try:
        server = OpenAIServer(llm, args.served_model_name or args.model,
                              tool_parser=args.tool_parser,
                              reasoning_parser=args.reasoning_parser)
        server.run(args.host, args.port)
    finally:
        llm.shutdown()


if __name__ == "__main__":
    main()
