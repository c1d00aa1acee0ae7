"""Token embedding.  Counterpart of `tensorrt_llm_tpu/layers/embedding.py`
(replicated table; vocab sharding belongs to the parallel slice)."""

from __future__ import annotations

import torch
from torch import nn


class Embedding(nn.Module):
    def __init__(self, vocab_size: int, hidden_size: int):
        super().__init__()
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.register_buffer("weight", None)

    def load(self, w: torch.Tensor) -> None:
        self.weight = w.to(torch.bfloat16).contiguous()

    def forward(self, token_ids: torch.Tensor) -> torch.Tensor:
        return self.weight[token_ids]
