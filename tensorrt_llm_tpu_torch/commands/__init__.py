"""Command-line entry points of the port (`trtllm-torch-bench`)."""
