"""Server-side validation, the round-acceptance gate (the port's
``attackfl_tpu/eval/validation.py:24-140,143-229``).

ICU rounds are scored by ROC-AUC and fail on NaN outputs (reference
src/Validation.py:92-122); HAR rounds by accuracy, always ok (:124-136);
CIFAR10 rounds by NLL and accuracy, failing on a NaN or |NLL| > 1e6
(:69-90).  In hyper mode every active client's own model runs the test
set and the outputs pool: one ROC-AUC for ICU (:178-214), the NLL and
the accuracy for CIFAR10 (:147-176).  The forward runs in chunks of the
model's ``eval_chunk`` rows, which bounds the activations' memory and
leaves the result unchanged (rows are independent).  It is plain
PyTorch: the JAX package leaves it to XLA, and it is no kernel.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from attackfl_tpu_torch.ops import pytree as pt


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


def forward_in_chunks(model, params: dict, data: dict[str, torch.Tensor],
                      inputs: tuple[str, ...]) -> torch.Tensor:
    """The eval-mode forward over every row of ``data``, in chunks of
    ``model.eval_chunk`` rows."""
    chunk = model.eval_chunk
    n = data["label"].shape[0]
    with torch.no_grad():
        return torch.cat([model.apply(params, *(data[k][i:i + chunk] for k in inputs))
                          for i in range(0, n, chunk)])


def evaluate_icu(model, params: dict, test_data: dict[str, torch.Tensor]
                 ) -> dict[str, torch.Tensor]:
    """ROC-AUC over the ICU test set; ok is False on NaN outputs."""
    probs = forward_in_chunks(model, params, test_data, ("vitals", "labs"))[:, 0]
    auc_val = roc_auc(test_data["label"], probs)
    ok = ~torch.any(torch.isnan(probs)) & torch.isfinite(auc_val)
    return {"roc_auc": auc_val, "ok": ok, "metric": auc_val}


def evaluate_har(model, params: dict, test_data: dict[str, torch.Tensor]
                 ) -> dict[str, torch.Tensor]:
    """Accuracy over the HAR test set; always ok."""
    logits = forward_in_chunks(model, params, test_data, ("x",))
    acc = torch.mean((torch.argmax(logits, dim=-1) == test_data["label"]).to(torch.float32))
    return {"accuracy": acc, "ok": torch.ones((), dtype=torch.bool, device=acc.device),
            "metric": acc}


def evaluate_cifar(model, params: dict, test_data: dict[str, torch.Tensor]
                   ) -> dict[str, torch.Tensor]:
    """Mean NLL and accuracy; ok is False on a NaN NLL or |NLL| > 1e6."""
    logp = forward_in_chunks(model, params, test_data, ("x",))
    label = test_data["label"].to(torch.int64)
    loss = torch.mean(-torch.gather(logp, 1, label[:, None])[:, 0])
    acc = torch.mean((torch.argmax(logp, dim=-1) == label).to(torch.float32))
    ok = torch.isfinite(loss) & (torch.abs(loss) <= 1e6)
    return {"nll": loss, "accuracy": acc, "ok": ok, "metric": acc}


def _per_client(model, stacked: dict, test_data: dict[str, torch.Tensor],
                inputs: tuple[str, ...]) -> torch.Tensor:
    """Every client's forward over the whole test set, (C, N, ...): one
    client at a time, each in chunks."""
    n = pt.tree_leaves(stacked)[0].shape[0]
    return torch.stack([forward_in_chunks(model, pt.tree_take(stacked, c), test_data, inputs)
                        for c in range(n)])


def evaluate_hyper_icu(model, stacked: dict, test_data: dict[str, torch.Tensor]
                       ) -> dict[str, torch.Tensor]:
    """Hyper-mode ICU validation: every given client's personalized model
    runs the full test set and ALL outputs pool into one ROC-AUC, the
    labels tiled (reference test_hyper_icu, src/Validation.py:178-214)."""
    probs = _per_client(model, stacked, test_data, ("vitals", "labs"))[..., 0]   # (C, N)
    auc_val = roc_auc(test_data["label"].repeat(probs.shape[0]), probs.reshape(-1))
    ok = ~torch.any(torch.isnan(probs)) & torch.isfinite(auc_val)
    return {"roc_auc": auc_val, "ok": ok, "metric": auc_val}


def evaluate_hyper_cifar(model, stacked: dict, test_data: dict[str, torch.Tensor]
                         ) -> dict[str, torch.Tensor]:
    """Hyper-mode CIFAR-10 validation: per-client models over the full
    test set, NLL and accuracy pooled (reference test_hyper_image,
    src/Validation.py:147-176)."""
    logp = _per_client(model, stacked, test_data, ("x",))                     # (C, N, 10)
    label = test_data["label"].to(torch.int64)
    nll = -torch.gather(logp, 2, label[None, :, None].expand(logp.shape[0], -1, 1))[..., 0]
    loss = torch.mean(nll)
    acc = torch.mean((torch.argmax(logp, dim=-1) == label[None, :]).to(torch.float32))
    ok = torch.isfinite(loss) & (torch.abs(loss) <= 1e6)
    return {"nll": loss, "accuracy": acc, "ok": ok, "metric": acc}


EVALUATORS = {"ICU": evaluate_icu, "HAR": evaluate_har, "CIFAR10": evaluate_cifar}
# the metrics each dataset's evaluation reports besides ``ok``, in its
# order (the fused path's NaN row of a skipped validation)
METRIC_KEYS = {"ICU": ("roc_auc", "metric"), "HAR": ("accuracy", "metric"),
               "CIFAR10": ("nll", "accuracy", "metric")}
# HAR has no hyper evaluation (reference src/Validation.py:138-145)
HYPER_EVALUATORS = {"ICU": evaluate_hyper_icu, "CIFAR10": evaluate_hyper_cifar}


class Validation:
    """The reference's ``Validation.test`` surface (src/Validation.py).
    ``logger``: a ``telemetry.Logger``; :meth:`test` writes its metrics
    line to ``app.log`` through it (JAX validation.py:187-190), the hyper
    and async evaluations write nothing, as JAX's.  ``telemetry``: a
    failed synchronous validation raises ``validation_failures`` and
    writes a ``validation`` event (JAX validation.py:172-181); the engine
    records the async ones when it resolves them."""

    def __init__(self, model, data_name: str, test_data: dict[str, np.ndarray],
                 device: torch.device, logger=None, telemetry=None):
        if data_name not in EVALUATORS:
            raise ValueError(f"Data name '{data_name}' is not valid.")
        self.data_name = data_name
        self.evaluate = EVALUATORS[data_name]
        self.model = model
        self.logger = logger
        self.telemetry = telemetry
        self.test_data = {k: torch.as_tensor(v, device=device)
                          for k, v in test_data.items()}

    def test(self, params: Any) -> tuple[bool, dict[str, float]]:
        ok, metrics = self._result(self.evaluate(self.model, params, self.test_data))
        if self.logger:
            self.logger.log_info(" ".join(f"{k}={v:.4f}" for k, v in metrics.items()))
        self._record(ok, metrics)
        return ok, metrics

    def _record(self, ok: bool, metrics: dict[str, float]) -> None:
        if self.telemetry is None or not self.telemetry.enabled or ok:
            return
        self.telemetry.counters.inc("validation_failures")
        self.telemetry.events.emit("validation", ok=False, data_name=self.data_name, **metrics)

    def test_hyper(self, stacked: Any) -> tuple[bool, dict[str, float]]:
        """Hyper mode: the pooled evaluation of the stacked per-client
        params (the active clients' generated models).  ``config.py``
        refuses hyper on HAR; this guards a direct caller, as JAX's
        ``Validation.test_hyper`` does (validation.py:222-224)."""
        if self.data_name not in HYPER_EVALUATORS:
            raise ValueError(f"Not found hyper test function for data name {self.data_name}")
        ok, metrics = self._result(HYPER_EVALUATORS[self.data_name](self.model, stacked,
                                                                    self.test_data))
        self._record(ok, metrics)
        return ok, metrics

    def test_async(self, params: Any) -> dict[str, torch.Tensor]:
        """Start the evaluation and return its dict of device tensors
        without a sync; :meth:`resolve_async` reads it later (JAX
        validation.py:194-201).  The engine's ``validation_async``: the
        card evaluates round N while the host prepares round N + 1, and
        the verdict does not gate the round."""
        return self.evaluate(self.model, params, self.test_data)

    def test_hyper_async(self, stacked: Any) -> dict[str, torch.Tensor]:
        """Hyper mode's :meth:`test_async` (JAX validation.py:203-208)."""
        if self.data_name not in HYPER_EVALUATORS:
            raise ValueError(f"Not found hyper test function for data name {self.data_name}")
        return HYPER_EVALUATORS[self.data_name](self.model, stacked, self.test_data)

    def resolve_async(self, out: dict[str, torch.Tensor]) -> tuple[bool, dict[str, float]]:
        """The host values of a :meth:`test_async` result (it waits for the
        evaluation to finish)."""
        return self._result(dict(out))

    @staticmethod
    def _result(out: dict[str, torch.Tensor]) -> tuple[bool, dict[str, float]]:
        """``(ok, metrics)`` on the host, the metrics in sorted key order,
        as JAX's jitted evaluation returns its dict."""
        ok = bool(out.pop("ok"))
        return ok, {k: float(out[k]) for k in sorted(out)}
