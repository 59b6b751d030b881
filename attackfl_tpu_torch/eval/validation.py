"""Server-side validation, the round-acceptance gate (the port's
``attackfl_tpu/eval/validation.py:24-76,143-192``).

ICU rounds are scored by ROC-AUC and fail on NaN outputs (reference
src/Validation.py:92-122).  The forward is plain PyTorch: the JAX package
leaves it to XLA, and it is no kernel.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def roc_auc(labels: torch.Tensor, scores: torch.Tensor) -> torch.Tensor:
    """Tie-aware area under the ROC curve via the rank-sum identity
    AUC = (sum of positive ranks - n+(n+ + 1)/2) / (n+ n-), with average
    ranks for ties.  NaN when the labels hold a single class."""
    labels = labels.reshape(-1)
    scores = scores.reshape(-1)
    sorted_scores = torch.sort(scores).values
    left = torch.searchsorted(sorted_scores, scores, side="left")
    right = torch.searchsorted(sorted_scores, scores, side="right")
    avg_rank = (left + right + 1).to(torch.float32) / 2.0
    n_pos = torch.sum(labels)
    n_neg = labels.shape[0] - n_pos
    rank_sum = torch.sum(torch.where(labels > 0.5, avg_rank, 0.0))
    denom = n_pos * n_neg
    auc = (rank_sum - n_pos * (n_pos + 1) / 2.0) / torch.clamp(denom, min=1.0)
    return torch.where(denom > 0, auc, torch.nan)


def evaluate_icu(model, params: dict, test_data: dict[str, torch.Tensor],
                 chunk: int = 4096) -> dict[str, torch.Tensor]:
    """ROC-AUC over the ICU test set in chunks of ``chunk`` rows (bounded
    activation memory); ok is False on NaN outputs."""
    with torch.no_grad():
        probs = torch.cat([
            model.apply(params, test_data["vitals"][i:i + chunk],
                        test_data["labs"][i:i + chunk])[:, 0]
            for i in range(0, test_data["label"].shape[0], chunk)])
    auc_val = roc_auc(test_data["label"], probs)
    ok = ~torch.any(torch.isnan(probs)) & torch.isfinite(auc_val)
    return {"roc_auc": auc_val, "ok": ok, "metric": auc_val}


class Validation:
    """The reference's ``Validation.test`` surface (src/Validation.py)."""

    def __init__(self, model, data_name: str, test_data: dict[str, np.ndarray],
                 device: torch.device, logger=None):
        if data_name != "ICU":
            raise NotImplementedError(
                f"validation for {data_name!r} is not ported yet (ROADMAP.md "
                "queue 1, item 11)")
        self.model = model
        self.logger = logger
        self.test_data = {k: torch.as_tensor(v, device=device)
                          for k, v in test_data.items()}

    def test(self, params: Any) -> tuple[bool, dict[str, float]]:
        out = evaluate_icu(self.model, params, self.test_data)
        ok = bool(out.pop("ok"))
        metrics = {k: float(v) for k, v in out.items()}
        if self.logger:
            self.logger.info(" ".join(f"{k}={v:.4f}" for k, v in metrics.items()))
        return ok, metrics
