"""Job pricing: a queue spec -> predicted device-seconds (the port's copy
of ``attackfl_tpu/scheduler/pricing.py``, on the port's config, cost model,
fingerprint and grid).

The bin-packer's input.  Pricing goes through the cost model
(:mod:`attackfl_tpu_torch.costmodel.estimate`) against the service's SHARED
ledger — the same corpus ``attackfl-tpu cost estimate`` reads, so the
packer's decisions inherit the leave-one-out 2x accuracy contract
``cost validate`` enforces:

* a **run** job is priced by its config fingerprint: peer-median
  ``round_device_time`` x rounds first, the flops/bytes regression over
  non-peer records when a static profile is available;
* a **matrix** job is priced per cell (each cell has its own
  fingerprint, exactly like ``cost estimate --matrix``) and summed —
  the serial bound, which the batched sweep executor lands at or under;
* an honestly unpredictable job (cold ledger, no profile) gets the
  corpus-median wall time when the ledger has ANY measured history,
  else the configured default — explicit, recorded in the decision's
  ``schedule`` event, never a silent zero (a zero-priced job would pack
  for free and the backlog estimate would lie).

The ``estimate_skew`` fault kind multiplies prices here — the chaos
seam proving degradation stays graceful when the cost model is wrong.

It makes no device call: the program-counting path stays in
:mod:`attackfl_tpu_torch.costmodel.cli`; the scheduler prices jobs in the
dispatch loop without touching the card.
"""

from __future__ import annotations

from typing import Any

from attackfl_tpu_torch.config import config_from_dict
from attackfl_tpu_torch.costmodel.estimate import (
    corpus_default_seconds, predict_run,
)
from attackfl_tpu_torch.utils.fingerprint import config_fingerprint

DEFAULT_SECONDS = 30.0


class JobPricer:
    """Price specs against the service ledger, one load per price call
    (the corpus grows as jobs finish — a later job of the same
    fingerprint prices off its predecessors' measurements)."""

    def __init__(self, ledger_dir: str, default_seconds: float =
                 DEFAULT_SECONDS, injector=None):
        self.ledger_dir = ledger_dir
        self.default_seconds = max(float(default_seconds), 0.001)
        self._injector = injector
        self._skew_seq = 0

    # ---- ledger access ----------------------------------------------

    def _records(self) -> list[dict[str, Any]]:
        try:
            from attackfl_tpu_torch.ledger.store import LedgerStore

            records, _ = LedgerStore(self.ledger_dir).load()
            return records
        except Exception:  # noqa: BLE001 — a cold/absent ledger prices default
            return []

    # ---- pricing ----------------------------------------------------

    def price(self, spec: dict[str, Any]) -> dict[str, Any]:
        """One spec -> ``{predicted_seconds, method, fingerprint, ...}``.
        Never raises on an unpriceable spec — unpredictable work gets
        the explicit default (the packer needs SOME number, and the
        decision record says which kind it was)."""
        try:
            records = self._records()
            if spec.get("type") == "matrix":
                out = self._price_matrix(spec, records)
            else:
                out = self._price_run(spec, records)
        except Exception as e:  # noqa: BLE001 — malformed spec: default price
            out = {"predicted_seconds": self.default_seconds,
                   "method": "default",
                   "error": f"{type(e).__name__}: {e}"[:200]}
        self._skew_seq += 1
        if self._injector is not None:
            factor = self._injector.estimate_skew_factor(self._skew_seq)
            if factor != 1.0:
                out["predicted_seconds"] = round(
                    out["predicted_seconds"] * factor, 6)
                out["skewed_by"] = factor
        return out

    def _default(self, records: list[dict[str, Any]]) -> tuple[float, str]:
        corpus = corpus_default_seconds(records)
        if corpus is not None:
            return corpus, "corpus_median"
        return self.default_seconds, "default"

    def _price_run(self, spec: dict[str, Any],
                   records: list[dict[str, Any]]) -> dict[str, Any]:
        cfg = config_from_dict(dict(spec.get("config") or {}))
        rounds = int(spec.get("num_rounds") or cfg.num_round)
        fingerprint = config_fingerprint(cfg)
        prediction = predict_run(records, fingerprint, rounds)
        if prediction is None:
            seconds, method = self._default(records)
            return {"predicted_seconds": round(seconds, 6),
                    "method": method, "fingerprint": fingerprint,
                    "rounds": rounds}
        return {"predicted_seconds": prediction["predicted_wall_seconds"],
                "method": prediction["method"],
                "fingerprint": fingerprint, "rounds": rounds,
                "round_device_time": prediction["round_device_time"]}

    def _price_matrix(self, spec: dict[str, Any],
                      records: list[dict[str, Any]]) -> dict[str, Any]:
        from attackfl_tpu_torch.matrix.grid import (
            cell_config, expand_cells, grid_from_dict,
        )

        cfg = config_from_dict(dict(spec.get("config") or {}))
        if cfg.prng_impl != "threefry2x32":
            # the worker forces threefry for batched sweeps — price the
            # config that will actually run (fingerprints must match)
            cfg = cfg.replace(prng_impl="threefry2x32")
        grid = grid_from_dict(dict(spec.get("grid") or {}))
        cells = expand_cells(grid)
        total = 0.0
        predicted: list[float] = []
        for cell in cells:
            ccfg = cell_config(cfg, cell, rounds=grid.rounds)
            prediction = predict_run(records, config_fingerprint(ccfg),
                                     grid.rounds)
            if prediction is not None:
                predicted.append(prediction["predicted_wall_seconds"])
        if predicted:
            # unpredictable cells price at their siblings' mean — the
            # cells share the round program shape, so a peer-priced
            # sibling is the best available stand-in
            per_cell = sum(predicted) / len(predicted)
            total = sum(predicted) + per_cell * (len(cells) - len(predicted))
            method = "peer" if len(predicted) == len(cells) \
                else "peer_partial"
        else:
            seconds, method = self._default(records)
            total = seconds  # one sweep = one default job price
        return {"predicted_seconds": round(total, 6), "method": method,
                "cells": len(cells), "predicted_cells": len(predicted),
                "rounds": grid.rounds}
