"""Aggregation over the stacked client axis (the port's
``attackfl_tpu/ops/aggregators.py``).  Ported: ``fedavg``; the robust
defenses follow in ROADMAP.md queue 1, item 10."""

from __future__ import annotations

import torch

from attackfl_tpu_torch.ops import pytree as pt


def fedavg(stacked: dict, sizes: torch.Tensor) -> dict:
    """Size-weighted mean (reference avg_all_parameters, server.py:751-775)."""
    return pt.tree_weighted_mean(stacked, sizes.to(torch.float32))
