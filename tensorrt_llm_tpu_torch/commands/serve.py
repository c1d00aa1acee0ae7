"""`trtllm-torch-serve`: the OpenAI-compatible serving CLI of the port.

Counterpart of `tensorrt_llm_tpu/commands/serve.py` (the reference's
`trtllm-serve`), with its flags: `model` is an HF checkpoint directory (or
a shape preset of `commands/bench.py`'s `MODEL_SHAPES`, random weights from
``seed``), served by `serve/openai_server.py` until SIGINT.
``--extra-llm-api-options`` names a file of `LlmArgs` field overrides: JSON,
or YAML where the `yaml` package imports (``skip_tokenizer_init: true``
serves token-id prompts on a machine without `transformers`).  ``--device``
(default ``cuda``) is the port's own flag.

``--register-to URL`` joins a disaggregated front end as a worker of
``--disagg-role`` (``context`` or ``generation``, the default), announced
as ``--advertise-url`` (default ``http://<host>:<port>``); the worker leaves
the front end when it stops.  ``trtllm-torch-serve disaggregated`` runs the
front end itself (`serve/disagg_server.py`): ``--ctx-servers`` and
``--gen-servers`` (more may join through ``/register``), ``--router``
(``round_robin``, ``load_based``, ``kv_aware``), ``--health-interval``, the
conditional skip of the context hop (``--conditional-max-prompt``,
``--conditional-cached-fraction``) and ``--stream-kv`` (KV frames pulled by
the generation worker while the prefill runs).

Flags of slices not in the port yet raise with the slice's name:
``--tp-size`` above 1 (tensor parallelism) and ``--mm-encoder-only`` (the
multimodal encoder).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

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
        return main_disaggregated(argv[1:])
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
    p.add_argument("--register-to", default=None,
                   help="disaggregated front end's base URL to join")
    p.add_argument("--advertise-url", default=None,
                   help="this worker's URL as the front end reaches it")
    p.add_argument("--disagg-role", default="generation",
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
        server = OpenAIServer(
            llm, args.served_model_name or args.model,
            tool_parser=args.tool_parser,
            reasoning_parser=args.reasoning_parser,
            register_to=args.register_to,
            advertise_url=(args.advertise_url
                           or f"http://{args.host}:{args.port}"),
            disagg_role=args.disagg_role)
        server.run(args.host, args.port)
    finally:
        llm.shutdown()


def main_disaggregated(argv):
    """`trtllm-torch-serve disaggregated`: the two-pool front end."""
    p = argparse.ArgumentParser("trtllm-torch-serve disaggregated")
    p.add_argument("--ctx-servers", nargs="*", default=[],
                   help="context (prefill) worker base URLs (more may "
                        "join through /register)")
    p.add_argument("--gen-servers", nargs="*", default=[],
                   help="generation (decode) worker base URLs")
    p.add_argument("--router", default="round_robin",
                   choices=["round_robin", "load_based", "kv_aware"])
    p.add_argument("--health-interval", type=float, default=5.0,
                   help="seconds between worker health sweeps (0: off)")
    p.add_argument("--conditional-max-prompt", type=int, default=0,
                   help="prompts of at most this many tokens skip the "
                        "context hop")
    p.add_argument("--conditional-cached-fraction", type=float, default=0.0,
                   help="skip the context hop when a generation worker "
                        "caches at least this fraction of the prompt")
    p.add_argument("--stream-kv", action="store_true",
                   help="the generation worker pulls KV frames from the "
                        "context worker while the prefill runs")
    p.add_argument("--served-model-name", default="tpu-llm")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    args = p.parse_args(argv)

    from tensorrt_llm_tpu_torch.serve.disagg_server import OpenAIDisaggServer
    OpenAIDisaggServer(
        args.ctx_servers, args.gen_servers, args.router,
        model_name=args.served_model_name,
        health_interval=args.health_interval,
        conditional_max_prompt=args.conditional_max_prompt,
        conditional_cached_fraction=args.conditional_cached_fraction,
        stream_kv=args.stream_kv).run(args.host, args.port)


if __name__ == "__main__":
    main()
