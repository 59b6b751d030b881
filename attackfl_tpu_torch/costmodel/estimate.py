"""Predictive cost model: price a config BEFORE running it (the port's
copy of ``attackfl_tpu/costmodel/estimate.py``).

Two prediction paths, tried in order:

* **peer** — ledger records sharing the candidate's config fingerprint
  already measured ``round_device_time``; the prediction is their median
  (newest ``window`` records), exactly the statistic the depth-k
  auto-tuner trusts.  This is the path the future multi-tenant
  scheduler's bin-packing takes for warm workloads.
* **regression** — no fingerprint peer exists (a NEW config).  Fit
  ``device_time ≈ a·flops + b·bytes`` by least squares over every
  non-peer record that carries both a measured ``round_device_time`` and
  a per-round cost profile (``utilization.flops_per_round`` /
  ``bytes_per_round`` — the schema-v9 capture layer writes these), then
  apply it to the candidate's OWN static profile.  Degenerate corpora
  (fewer than two usable records, singular normal equations) fall back
  to the median seconds-per-flop ratio.

``validate_predictions`` replays the whole corpus leave-one-out —
every measured record is re-predicted from the others — and reports the
error distribution (median/p90 of the symmetric error factor
``max(pred/meas, meas/pred)``).  That distribution is the accuracy
contract: ``python -m attackfl_tpu_torch cost validate`` exits non-zero when the median
factor exceeds the bound (default 2×).

Torch-free: reads JSON-shaped ledger records only.  The CLI's
no-peer path counts the candidate's programs to GET a profile — that
import lives in :mod:`attackfl_tpu_torch.costmodel.cli`, not here.
"""

from __future__ import annotations

import statistics
from typing import Any

DEFAULT_WINDOW = 5
# leave-one-out acceptance bar: median symmetric error factor
DEFAULT_MAX_MEDIAN_FACTOR = 2.0


def _num(value: Any) -> float | None:
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        return None
    if value != value:
        return None
    return value + 0.0


def _measured(record: dict[str, Any]) -> float | None:
    value = _num(record.get("round_device_time"))
    return value if value is not None and value > 0 else None


def _cost_features(record: dict[str, Any]) -> tuple[float, float] | None:
    """(flops_per_round, bytes_per_round) from a record's utilization
    block; bytes default to 0 when only flops is known."""
    utilization = record.get("utilization")
    if not isinstance(utilization, dict):
        return None
    flops = _num(utilization.get("flops_per_round"))
    if flops is None or flops <= 0:
        return None
    size = _num(utilization.get("bytes_per_round"))
    return flops, (size if size is not None and size > 0 else 0.0)


def peer_prediction(records: list[dict[str, Any]], fingerprint: str,
                    window: int = DEFAULT_WINDOW,
                    exclude_id: str | None = None
                    ) -> tuple[float, dict[str, Any]] | None:
    """Median measured device time over the newest fingerprint peers."""
    peers = [r for r in records
             if r.get("fingerprint") == fingerprint
             and _measured(r) is not None
             and (exclude_id is None or r.get("record_id") != exclude_id)]
    if not peers or not fingerprint:
        return None
    peers = peers[-window:]
    times = [_measured(r) for r in peers]
    prediction = statistics.median(times)
    spread = (max(times) - min(times)) / prediction if prediction else 0.0
    return prediction, {
        "method": "peer",
        "peers": len(peers),
        "peer_ids": [r.get("record_id") for r in peers],
        "peer_spread": round(spread, 4),
    }


def fit_regression(records: list[dict[str, Any]],
                   exclude_fingerprint: str | None = None,
                   exclude_id: str | None = None
                   ) -> dict[str, Any] | None:
    """``time ≈ a·flops + b·bytes`` over records carrying both a measured
    device time and a cost profile.  No intercept: zero work takes zero
    time, and the corpora are small enough that an intercept just soaks
    up noise.  Returns ``{a, b, n}`` (b = 0 on the ratio fallback), or
    None when nothing is usable."""
    rows: list[tuple[float, float, float]] = []
    for record in records:
        if exclude_fingerprint is not None \
                and record.get("fingerprint") == exclude_fingerprint:
            continue
        if exclude_id is not None \
                and record.get("record_id") == exclude_id:
            continue
        measured = _measured(record)
        features = _cost_features(record)
        if measured is None or features is None:
            continue
        rows.append((features[0], features[1], measured))
    if not rows:
        return None
    if len(rows) >= 2 and any(b > 0 for _, b, _ in rows):
        # 2x2 normal equations for [a, b]
        sff = sum(f * f for f, _, _ in rows)
        sbb = sum(b * b for _, b, _ in rows)
        sfb = sum(f * b for f, b, _ in rows)
        sft = sum(f * t for f, _, t in rows)
        sbt = sum(b * t for _, b, t in rows)
        det = sff * sbb - sfb * sfb
        if det > 0 and sff > 0:
            a = (sft * sbb - sbt * sfb) / det
            b = (sbt * sff - sft * sfb) / det
            if a >= 0 and b >= 0 and (a > 0 or b > 0):
                return {"a": a, "b": b, "n": len(rows),
                        "method": "regression"}
    # ratio fallback: median seconds-per-flop (always well-defined)
    ratios = [t / f for f, _, t in rows if f > 0]
    if not ratios:
        return None
    return {"a": statistics.median(ratios), "b": 0.0, "n": len(rows),
            "method": "flops_ratio"}


def apply_regression(fit: dict[str, Any], flops: float,
                     size_bytes: float) -> float:
    return fit["a"] * flops + fit["b"] * size_bytes


def predict_device_time(records: list[dict[str, Any]], fingerprint: str,
                        profile: dict[str, Any] | None = None,
                        window: int = DEFAULT_WINDOW,
                        exclude_id: str | None = None
                        ) -> tuple[float, dict[str, Any]] | None:
    """Per-round device-time prediction for a config: fingerprint peers
    first, the flops/bytes regression over NON-peer records when none
    exist (``profile`` must then carry ``flops_per_round`` — without it
    there is nothing to regress onto, and the result is None)."""
    peer = peer_prediction(records, fingerprint, window, exclude_id)
    if peer is not None:
        return peer
    if profile is None:
        return None
    flops = _num(profile.get("flops_per_round"))
    if flops is None or flops <= 0:
        return None
    size = _num(profile.get("bytes_per_round")) or 0.0
    fit = fit_regression(records, exclude_fingerprint=fingerprint,
                         exclude_id=exclude_id)
    if fit is None:
        return None
    prediction = apply_regression(fit, flops, size)
    if prediction <= 0:
        return None
    return prediction, {"method": fit["method"], "fit_records": fit["n"],
                        "a_s_per_flop": fit["a"], "b_s_per_byte": fit["b"]}


def predict_run(records: list[dict[str, Any]], fingerprint: str,
                rounds: int, profile: dict[str, Any] | None = None,
                window: int = DEFAULT_WINDOW) -> dict[str, Any] | None:
    """Whole-run prediction: per-round device time × rounds, plus the
    peers' median host-resolution latency when available (regression
    predictions carry no host estimate — flagged ``device_only``)."""
    prediction = predict_device_time(records, fingerprint, profile, window)
    if prediction is None:
        return None
    device, info = prediction
    host_values = [
        _num(r.get("host_resolution_latency")) for r in records
        if r.get("fingerprint") == fingerprint
        and _num(r.get("host_resolution_latency")) is not None]
    host = statistics.median(host_values) if host_values else None
    per_round = device + (host or 0.0)
    return {
        "rounds": rounds,
        "round_device_time": round(device, 6),
        "host_resolution_latency": (round(host, 6)
                                    if host is not None else None),
        "device_only": host is None,
        "predicted_wall_seconds": round(per_round * rounds, 3),
        **info,
    }


def corpus_default_seconds(records: list[dict[str, Any]]
                           ) -> float | None:
    """Median measured wall time across the whole corpus — the
    scheduler's price for an honestly unpredictable job (no fingerprint
    peer, no static profile).  A corpus-derived default keeps the
    packer's backlog estimate in the right order of magnitude on warm
    services; None on an empty/unmeasured corpus (the caller falls back
    to its configured constant)."""
    walls = [w for w in (_num(r.get("wall_seconds")) for r in records)
             if w is not None and w > 0]
    if not walls:
        return None
    return statistics.median(walls)


def prediction_error_factor(predicted: float | None,
                            actual: float | None) -> float | None:
    """The symmetric error factor ``max(pred/actual, actual/pred)`` —
    the same statistic the leave-one-out validation reports — as a
    None-safe join for the fleet observatory's predicted-vs-actual
    column.  None (or a non-positive side) means "no joinable pair",
    never a crash: the ledger row shows the hole instead of hiding it."""
    p, a = _num(predicted), _num(actual)
    if p is None or a is None or p <= 0 or a <= 0:
        return None
    return round(max(p / a, a / p), 4)


def validate_predictions(records: list[dict[str, Any]],
                         window: int = DEFAULT_WINDOW) -> dict[str, Any]:
    """Leave-one-out replay: predict every measured record from the rest
    and report the error-factor distribution (the scheduler's accuracy
    contract)."""
    rows: list[dict[str, Any]] = []
    for record in records:
        measured = _measured(record)
        fingerprint = record.get("fingerprint")
        if measured is None or not fingerprint:
            continue
        features = _cost_features(record)
        profile = ({"flops_per_round": features[0],
                    "bytes_per_round": features[1]}
                   if features is not None else None)
        prediction = predict_device_time(
            records, fingerprint, profile, window,
            exclude_id=record.get("record_id"))
        if prediction is None:
            # peerless AND profile-less: honestly unpredictable — counted,
            # never silently dropped
            rows.append({"record_id": record.get("record_id"),
                         "measured_s": measured, "predicted_s": None,
                         "method": "unpredictable"})
            continue
        predicted, info = prediction
        factor = max(predicted / measured, measured / predicted)
        rows.append({"record_id": record.get("record_id"),
                     "measured_s": round(measured, 6),
                     "predicted_s": round(predicted, 6),
                     "error_factor": round(factor, 4),
                     "method": info["method"]})
    factors = sorted(r["error_factor"] for r in rows
                     if r.get("error_factor") is not None)

    def quantile(q: float) -> float | None:
        if not factors:
            return None
        rank = min(int(q * (len(factors) - 1) + 0.5), len(factors) - 1)
        return factors[rank]

    by_method: dict[str, int] = {}
    for row in rows:
        by_method[row["method"]] = by_method.get(row["method"], 0) + 1
    return {
        "records": len(rows),
        "predicted": len(factors),
        "unpredictable": by_method.get("unpredictable", 0),
        "by_method": by_method,
        "median_error_factor": (round(statistics.median(factors), 4)
                                if factors else None),
        "p90_error_factor": (round(quantile(0.9), 4) if factors else None),
        "worst_error_factor": (round(factors[-1], 4) if factors else None),
        "rows": rows,
    }
