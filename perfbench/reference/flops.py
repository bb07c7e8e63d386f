"""The network's floating-point operations per step, counted by
torch.utils.flop_counter.FlopCounterMode over the reference's own forward
(and, for a training step, its loss and backward) at a batch's real level
sizes, on meta tensors: shapes only, no data and no device. It counts the
matrix products (each multiply-add as two operations: the linears, the
K-contractions) and not the elementwise work; the pyramid's kNN is not
counted. The count is the same whatever implements the network.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.reference.model import Segmentation


def _meta_set(level_sizes, k: int, n_classes: int) -> dict:
    L = len(level_sizes)
    m = torch.device("meta")

    def rows(n, c):
        return torch.empty(n, c, device=m)

    def edges(n):
        return torch.empty(n, k, dtype=torch.int64, device=m)

    return {"points": [rows(n, 3) for n in level_sizes],
            "norms": [rows(n, 3) for n in level_sizes],
            "feats": rows(level_sizes[0], 3),
            "labels": torch.empty(level_sizes[0], dtype=torch.int64, device=m),
            "edges_self": [edges(n) for n in level_sizes],
            "edges_forward": [edges(level_sizes[lvl + 1]) for lvl in range(L - 1)],
            "edges_propagate": [edges(level_sizes[lvl]) for lvl in range(L - 1)]}


def step_flops(cfg, level_sizes, train: bool) -> int:
    """Operations of one forward (train=False) or forward + loss + backward
    (train=True) over a batch whose levels hold `level_sizes` real points."""
    with torch.device("meta"):
        model = Segmentation(cfg)
    model.train(train)
    s = _meta_set(list(level_sizes), int(cfg["K_self"][0]), cfg["num_classes"])
    with FlopCounterMode(display=False) as fc:
        logits = model(s)
        if train:
            torch.nn.functional.cross_entropy(logits, s["labels"]).backward()
    return int(fc.get_total_flops())
