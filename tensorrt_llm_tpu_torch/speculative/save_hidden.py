"""SAVE_HIDDEN_STATES mode: capture the target's hidden states to disk.

Counterpart of `tensorrt_llm_tpu/speculative/save_hidden.py` (the
reference's `SaveHiddenStatesDrafter`): a drafter that proposes nothing and
rides the executor's hidden-state tap, writing each finished request's
``{input_ids, hidden_state}`` (f32, one row a position) to ``.npz`` shards
in the JAX file format (``<prefix>_<shard>.npz`` with ``input_ids_<id>`` /
``hidden_state_<id>`` arrays), the training data of EAGLE-style heads.
``save_capture="eagle3"`` records the three-layer features.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np
import torch

from tensorrt_llm_tpu_torch.speculative.interface import (
    Drafter, SpeculativeConfig)


class SaveHiddenStatesDrafter(Drafter):
    needs_hidden = True

    def __init__(self, cfg: SpeculativeConfig):
        self.cfg = cfg
        self.hidden_capture = cfg.save_capture
        self.out_dir = cfg.save_dir or "hidden_states"
        self.file_prefix = cfg.save_file_prefix
        self.write_interval = int(cfg.save_write_interval)
        self._buf = {}            # request id -> {position: row}
        self._records: List[dict] = []
        self._shard = 0
        self._count = 0

    def bind(self, engine, kv):
        os.makedirs(self.out_dir, exist_ok=True)

    def propose(self, request) -> List[int]:
        return []

    def on_hidden(self, request, start_pos: int, hiddens):
        rows = self._buf.setdefault(request.request_id, {})
        h = hiddens.to(torch.float32).cpu().numpy()
        for i in range(h.shape[0]):
            rows[start_pos + i] = h[i]

    def on_request_finished(self, request):
        rows = self._buf.pop(request.request_id, None)
        if not rows:
            return
        n = max(rows) + 1
        width = next(iter(rows.values())).shape[-1]
        hs = np.zeros((n, width), np.float32)
        for p, row in rows.items():
            hs[p] = row
        ids = list(request.prompt_token_ids) + list(request.output_token_ids)
        self._count += 1
        self._records.append({"id": self._count,
                              "input_ids": np.asarray(ids[:n], np.int64),
                              "hidden_state": hs})
        if len(self._records) >= self.write_interval:
            self.flush()

    def flush(self):
        if not self._records:
            return
        self._shard += 1
        arrays = {}
        for rec in self._records:
            arrays[f"input_ids_{rec['id']}"] = rec["input_ids"]
            arrays[f"hidden_state_{rec['id']}"] = rec["hidden_state"]
        np.savez(os.path.join(self.out_dir,
                              f"{self.file_prefix}_{self._shard}.npz"),
                 **arrays)
        self._records = []


def load_hidden_state_shards(out_dir: str, prefix: str = "data"):
    """Read saved shards back as a list of {input_ids, hidden_state}."""
    records = []
    for name in sorted(os.listdir(out_dir)):
        if not (name.startswith(prefix) and name.endswith(".npz")):
            continue
        with np.load(os.path.join(out_dir, name)) as z:
            for rid in sorted({int(k.rsplit("_", 1)[1]) for k in z.files}):
                records.append({"input_ids": z[f"input_ids_{rid}"],
                                "hidden_state": z[f"hidden_state_{rid}"]})
    return records
