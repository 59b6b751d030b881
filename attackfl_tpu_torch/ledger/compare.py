"""Cross-run comparison + the CI regression gate (the port's copy of
``attackfl_tpu/ledger/compare.py``).

``compare_records`` diffs two ledger records across the perf, numerics
and forensics columns; ``rolling_baseline`` synthesizes a baseline from
the candidate's own history (median over the last ``window`` records
sharing its config fingerprint + executor — apples to apples only);
``regress_check`` turns the diff into pass/fail verdicts with
noise-aware thresholds.

**Noise awareness** reuses the lesson of the JAX package's paired-means
bench protocol: on a drifting box,
comparing best-of single observations routinely overstates small deltas
by more than the delta itself.  So (a) when a record carries per-rep
rates (bench imports), its MEAN is compared, not its best; (b) the
effective slowdown threshold is floored by the baseline's own observed
inter-rep spread (a run can't be declared 10% slower by a gate whose
baseline wobbles 15% rep-to-rep); (c) the rolling baseline is a median,
not a max.
"""

from __future__ import annotations

import statistics
from typing import Any

# Default gate thresholds (overridable from the CLI).
DEFAULT_THRESHOLDS: dict[str, float] = {
    # relative steady-rounds/s slowdown (percent) that fails the gate
    "rounds_per_sec_pct": 10.0,
    # per-phase p95 regression: relative percent AND an absolute floor
    # (a 2ms phase doubling is noise, not a regression)
    "phase_p95_pct": 50.0,
    "phase_p95_floor_s": 0.010,
    # quality: absolute drop in roc_auc/accuracy that fails
    "quality_drop": 0.02,
    # forensics: absolute TPR drop / FPR rise that fails
    "tpr_drop": 0.05,
    "fpr_rise": 0.05,
    # cost observatory: relative achieved-FLOP/s drop
    # (percent) that fails — the roofline column the future scheduler's
    # bin-packing relies on.  Noise-floored like the rounds/s gate: the
    # denominator is the same measured device time, so it inherits the
    # same rep-to-rep wobble.
    "util_drop_pct": 10.0,
    # cap on how far the noise floor can stretch the perf threshold
    "noise_cap_pct": 30.0,
    # scheduler SLO: a candidate's queue wait may exceed the
    # fingerprint peers' p95 by this much (percent) before the gate
    # fails, with an absolute floor so a 0.2s-vs-0.1s wait on an idle
    # box (pure dispatch jitter) is never declared a regression
    "queue_wait_pct": 100.0,
    "queue_wait_floor_s": 5.0,
    # hotspot observatory: absolute host-bound-fraction rise
    # past the peers' median that fails the gate, noise-floored by the
    # peers' own observed spread (capped below — a wobbling baseline
    # can't demand the moon), and absolute top-op self-time share drift
    # (either direction: a kernel silently taking over the round and a
    # kernel silently vanishing are both news)
    "hostbound_rise": 0.15,
    "hostbound_noise_cap": 0.30,
    "top_op_share_drift": 0.15,
}

# The "perf columns" a comparison renders (record key, short label).
PERF_COLUMNS = (
    ("rounds_per_sec_steady", "steady r/s"),
    ("rounds_per_sec_incl_compile", "incl-compile r/s"),
    ("round_device_time", "device s/round"),
    ("host_resolution_latency", "host s/round"),
    ("wall_seconds", "wall s"),
)


def _num(value: Any) -> float | None:
    if isinstance(value, (int, float)) and not isinstance(value, bool) \
            and value == value:
        return float(value)
    return None


def effective_rate(record: dict[str, Any]) -> float | None:
    """The rate a comparison uses: the mean over reps when the record
    carries them (paired-means protocol), else the single steady rate."""
    per_rep = record.get("per_rep")
    if isinstance(per_rep, list):
        reps = [v for v in (_num(x) for x in per_rep) if v is not None]
        if reps:
            return sum(reps) / len(reps)
    for key in ("rounds_per_sec_mean", "rounds_per_sec_steady",
                "rounds_per_sec_incl_compile"):
        value = _num(record.get(key))
        if value is not None:
            return value
    return None


def rate_noise_pct(record: dict[str, Any]) -> float:
    """Observed inter-rep spread of a record's rate, as percent of its
    mean (0 when the record has no per-rep data — a single observation
    carries no self-noise estimate)."""
    per_rep = record.get("per_rep")
    if not isinstance(per_rep, list):
        return 0.0
    reps = [v for v in (_num(x) for x in per_rep) if v is not None]
    if len(reps) < 2:
        return 0.0
    mean = sum(reps) / len(reps)
    if mean <= 0:
        return 0.0
    return 100.0 * statistics.pstdev(reps) / mean


def _delta(old: float | None, new: float | None) -> dict[str, Any]:
    out: dict[str, Any] = {"old": old, "new": new}
    if old is not None and new is not None:
        out["delta"] = round(new - old, 6)
        if old != 0:
            out["pct"] = round(100.0 * (new - old) / abs(old), 2)
    return out


def compare_records(old: dict[str, Any],
                    new: dict[str, Any]) -> dict[str, Any]:
    """Column-wise diff: perf rates + time attribution, per-phase p95,
    quality finals, numerics gauges, forensics rates, lifecycle counts."""
    perf = {key: _delta(_num(old.get(key)), _num(new.get(key)))
            for key, _ in PERF_COLUMNS}
    perf["rate_effective"] = _delta(effective_rate(old), effective_rate(new))

    attribution = {}
    old_attr = old.get("time_attribution") or {}
    new_attr = new.get("time_attribution") or {}
    for key in sorted(set(old_attr) | set(new_attr)):
        attribution[key] = _delta(_num(old_attr.get(key)),
                                  _num(new_attr.get(key)))

    phases = {}
    old_phases = old.get("phases") or {}
    new_phases = new.get("phases") or {}
    for name in sorted(set(old_phases) | set(new_phases)):
        phases[name] = {
            "p50_s": _delta(_num((old_phases.get(name) or {}).get("p50_s")),
                            _num((new_phases.get(name) or {}).get("p50_s"))),
            "p95_s": _delta(_num((old_phases.get(name) or {}).get("p95_s")),
                            _num((new_phases.get(name) or {}).get("p95_s"))),
        }

    quality = {}
    for key in sorted(set(old.get("final") or {}) | set(new.get("final")
                                                        or {})):
        quality[key] = _delta(_num((old.get("final") or {}).get(key)),
                              _num((new.get("final") or {}).get(key)))

    numerics = {}
    old_num = old.get("numerics") or {}
    new_num = new.get("numerics") or {}
    for key in sorted(set(old_num) | set(new_num)):
        numerics[key] = _delta(_num(old_num.get(key)), _num(new_num.get(key)))

    forensics = {}
    old_for = old.get("forensics") or {}
    new_for = new.get("forensics") or {}
    for key in sorted(set(old_for) | set(new_for)):
        forensics[key] = _delta(_num(old_for.get(key)), _num(new_for.get(key)))

    utilization = {}
    old_util = old.get("utilization") or {}
    new_util = new.get("utilization") or {}
    for key in sorted(set(old_util) | set(new_util)):
        delta = _delta(_num(old_util.get(key)), _num(new_util.get(key)))
        if delta.get("old") is not None or delta.get("new") is not None:
            utilization[key] = delta

    counts = {}
    old_counts = old.get("counts") or {}
    new_counts = new.get("counts") or {}
    for key in sorted(set(old_counts) | set(new_counts)):
        counts[key] = _delta(_num(old_counts.get(key)),
                             _num(new_counts.get(key)))

    # scheduler accounting: wait/preemption deltas + the
    # priority identity (a cross-priority comparison is apples to
    # oranges for wait time — rendered, never silently hidden)
    sched = None
    if any(r.get(k) is not None for r in (old, new)
           for k in ("sched_priority", "sched_wait_seconds",
                     "sched_preemptions")):
        sched = {
            "priority": {"old": old.get("sched_priority"),
                         "new": new.get("sched_priority")},
            "wait_seconds": _delta(_num(old.get("sched_wait_seconds")),
                                   _num(new.get("sched_wait_seconds"))),
            "preemptions": _delta(_num(old.get("sched_preemptions")),
                                  _num(new.get("sched_preemptions"))),
        }

    # hotspot observatory: host-bound fraction + measured
    # device time deltas, prediction-error factors, and per-op share
    # drift across the union of both records' top-op tables
    hotspots = None
    old_hot = old.get("hotspots") or {}
    new_hot = new.get("hotspots") or {}
    if old_hot or new_hot:
        def shares(block: dict[str, Any]) -> dict[str, float]:
            out: dict[str, float] = {}
            for row in block.get("top_ops") or []:
                if isinstance(row, dict) and row.get("name"):
                    value = _num(row.get("share"))
                    if value is not None:
                        out[str(row["name"])] = value
            return out

        old_shares, new_shares = shares(old_hot), shares(new_hot)
        hotspots = {
            "host_bound_fraction": _delta(
                _num(old_hot.get("host_bound_fraction")),
                _num(new_hot.get("host_bound_fraction"))),
            "measured_round_device_s": _delta(
                _num(old_hot.get("measured_round_device_s")),
                _num(new_hot.get("measured_round_device_s"))),
            "prediction_error_factor": _delta(
                _num(old_hot.get("hotspot_prediction_error_factor")),
                _num(new_hot.get("hotspot_prediction_error_factor"))),
            "top_op_shares": {
                name: _delta(old_shares.get(name), new_shares.get(name))
                for name in sorted(set(old_shares) | set(new_shares))},
            "books_close": {"old": old_hot.get("books_close"),
                            "new": new_hot.get("books_close")},
        }

    return {
        "old_id": old.get("record_id"),
        "new_id": new.get("record_id"),
        "fingerprint_match": (old.get("fingerprint") == new.get("fingerprint")
                              and bool(old.get("fingerprint"))),
        "executor": {"old": old.get("executor"), "new": new.get("executor")},
        "pipeline_depth": {"old": old.get("pipeline_depth"),
                           "new": new.get("pipeline_depth")},
        "mesh_devices": {"old": old.get("mesh_devices"),
                         "new": new.get("mesh_devices")},
        "perf": perf,
        "time_attribution": attribution,
        "phases": phases,
        "quality": quality,
        "numerics": numerics,
        "forensics": forensics,
        "utilization": utilization,
        "counts": counts,
        "sched": sched,
        "hotspots": hotspots,
    }


def rolling_baseline(records: list[dict[str, Any]],
                     candidate: dict[str, Any],
                     window: int = 5) -> dict[str, Any] | None:
    """Synthetic baseline record: the median over the last ``window``
    records sharing the candidate's fingerprint + executor + matrix cell
    (the candidate itself excluded — by record_id when it has one, by
    identity otherwise).  None when no peer exists.

    The ``cell`` key: per-cell matrix records can share a
    config fingerprint (the sweep's base config collapses in edge cases
    — e.g. records imported without full configs), so baseline peers
    must ALSO agree on the (attack × defense × seed) cell identity.
    Non-matrix records carry no ``cell`` and match each other as before
    (None == None).

    The ``pipeline_depth`` key (the same lesson): the depth knob
    is fingerprint-VOLATILE — params are bit-identical at every depth —
    but throughput is exactly what depth changes, so records at
    different depths are non-peers for the rolling baseline (a depth-4
    run must not be gated against depth-0 history).  Non-pipelined
    records carry None and keep matching each other.

    The ``mesh_devices`` key (the same lesson again): mesh size
    is a placement knob — fingerprints don't see it (num-devices: 0
    means "whatever is visible"), yet throughput is exactly what it
    changes, so an 8-device run must never be gated against 1-device
    history.  Records predating the field carry None; ``0`` (explicitly
    meshless) and None are treated as the same pool so old baselines
    keep working."""
    fingerprint = candidate.get("fingerprint")

    def mesh_key(record: dict[str, Any]) -> int:
        value = record.get("mesh_devices")
        if isinstance(value, bool) or not isinstance(value, int):
            return 0
        return value

    peers = [r for r in records
             if r is not candidate
             and r.get("fingerprint") == fingerprint
             and r.get("executor") == candidate.get("executor")
             and r.get("cell") == candidate.get("cell")
             and r.get("pipeline_depth") == candidate.get("pipeline_depth")
             and mesh_key(r) == mesh_key(candidate)
             and (candidate.get("record_id") is None
                  or r.get("record_id") != candidate.get("record_id"))]
    if not peers or not fingerprint:
        return None
    peers = peers[-window:]

    def median_of(path: tuple[str, ...]) -> float | None:
        values = []
        for record in peers:
            node: Any = record
            for key in path:
                node = (node or {}).get(key) if isinstance(node, dict) \
                    else None
            value = _num(node)
            if value is not None:
                values.append(value)
        return statistics.median(values) if values else None

    baseline: dict[str, Any] = {
        "record_id": f"baseline[{len(peers)}]",
        "source": "baseline",
        "fingerprint": fingerprint,
        "executor": candidate.get("executor"),
        "cell": candidate.get("cell"),
        "pipeline_depth": candidate.get("pipeline_depth"),
        "mesh_devices": candidate.get("mesh_devices"),
        "baseline_of": [r.get("record_id") for r in peers],
    }
    for key, _ in PERF_COLUMNS:
        baseline[key] = median_of((key,))
    # queue-wait evidence: pool the peers' scheduler waits so
    # regress_check can gate the candidate's wait against the peers' p95
    # (the baseline alone — one median — can't carry a distribution)
    peer_waits = [w for w in (_num(r.get("sched_wait_seconds"))
                              for r in peers) if w is not None]
    if peer_waits:
        baseline["sched_wait_peers"] = [round(w, 6) for w in peer_waits]
        baseline["sched_wait_seconds"] = round(
            statistics.median(peer_waits), 6)
    # effective-rate noise floor: pool the peers' rates as pseudo-reps so
    # the gate sees the baseline's own run-to-run wobble
    rates = [effective_rate(r) for r in peers]
    rates = [r for r in rates if r is not None]
    if rates:
        baseline["per_rep"] = [round(r, 6) for r in rates]
    baseline["phases"] = {}
    names = {name for r in peers for name in (r.get("phases") or {})}
    for name in sorted(names):
        baseline["phases"][name] = {
            "p50_s": median_of(("phases", name, "p50_s")),
            "p95_s": median_of(("phases", name, "p95_s")),
        }
    baseline["final"] = {
        key: median_of(("final", key))
        for key in {k for r in peers for k in (r.get("final") or {})}}
    baseline["numerics"] = {
        key: median_of(("numerics", key))
        for key in {k for r in peers for k in (r.get("numerics") or {})}}
    if not any(v is not None for v in baseline["numerics"].values()):
        baseline["numerics"] = None
    baseline["forensics"] = {
        key: median_of(("forensics", key))
        for key in {k for r in peers for k in (r.get("forensics") or {})}}
    if not any(v is not None for v in baseline["forensics"].values()):
        baseline["forensics"] = None
    # roofline columns: medians over the numeric utilization
    # fields (device_kind/basis are identity, not medianable)
    baseline["utilization"] = {
        key: median_of(("utilization", key))
        for key in {k for r in peers for k in (r.get("utilization") or {})
                    if _num((r.get("utilization") or {}).get(k)) is not None}}
    if not any(v is not None for v in baseline["utilization"].values()):
        baseline["utilization"] = None
    # hotspot peers: median host-bound fraction + the pooled
    # per-peer fractions (the gate's noise floor — same design as
    # sched_wait_peers) and per-name median top-op shares
    peer_fractions = [
        f for f in (_num((r.get("hotspots") or {})
                         .get("host_bound_fraction")) for r in peers)
        if f is not None]
    if peer_fractions:
        share_pool: dict[str, list[float]] = {}
        for record in peers:
            for row in (record.get("hotspots") or {}).get("top_ops") or []:
                if isinstance(row, dict) and row.get("name"):
                    value = _num(row.get("share"))
                    if value is not None:
                        share_pool.setdefault(
                            str(row["name"]), []).append(value)
        baseline["hotspots"] = {
            "host_bound_fraction": round(
                statistics.median(peer_fractions), 4),
            "hostbound_peers": [round(f, 4) for f in peer_fractions],
            "measured_round_device_s": median_of(
                ("hotspots", "measured_round_device_s")),
            "top_ops": [
                {"name": name,
                 "share": round(statistics.median(values), 4)}
                for name, values in sorted(share_pool.items())],
        }
    baseline["counts"] = {}
    baseline["time_attribution"] = {}
    return baseline


def regress_check(baseline: dict[str, Any], candidate: dict[str, Any],
                  thresholds: dict[str, float] | None = None
                  ) -> dict[str, Any]:
    """Gate verdict: ``{ok, violations: [...], checks: N, ...}`` —
    ``ok`` is False when any perf/quality/forensics/numerics column
    regresses past its (noise-floored) threshold."""
    th = dict(DEFAULT_THRESHOLDS)
    th.update(thresholds or {})
    violations: list[dict[str, Any]] = []
    checks = 0

    # --- perf: steady rounds/s (paired means + noise floor) -----------
    base_rate = effective_rate(baseline)
    cand_rate = effective_rate(candidate)
    noise_pct = min(max(rate_noise_pct(baseline), rate_noise_pct(candidate)),
                    th["noise_cap_pct"])
    rate_threshold = max(th["rounds_per_sec_pct"], noise_pct)
    if base_rate is not None and cand_rate is not None and base_rate > 0:
        checks += 1
        drop_pct = 100.0 * (base_rate - cand_rate) / base_rate
        if drop_pct > rate_threshold:
            violations.append({
                "check": "rounds_per_sec",
                "baseline": round(base_rate, 4),
                "candidate": round(cand_rate, 4),
                "drop_pct": round(drop_pct, 2),
                "threshold_pct": round(rate_threshold, 2),
            })

    # --- perf: per-phase p95 ------------------------------------------
    base_phases = baseline.get("phases") or {}
    cand_phases = candidate.get("phases") or {}
    for name in sorted(set(base_phases) & set(cand_phases)):
        old = _num((base_phases.get(name) or {}).get("p95_s"))
        new = _num((cand_phases.get(name) or {}).get("p95_s"))
        if old is None or new is None or old <= 0:
            continue
        checks += 1
        if (new - old) > th["phase_p95_floor_s"] \
                and 100.0 * (new - old) / old > th["phase_p95_pct"]:
            violations.append({
                "check": f"phase_p95:{name}",
                "baseline": round(old, 6), "candidate": round(new, 6),
                "rise_pct": round(100.0 * (new - old) / old, 2),
                "threshold_pct": th["phase_p95_pct"],
            })

    # --- quality: final metric drops ----------------------------------
    for key in ("roc_auc", "accuracy"):
        old = _num((baseline.get("final") or {}).get(key))
        new = _num((candidate.get("final") or {}).get(key))
        if old is None or new is None:
            continue
        checks += 1
        if (old - new) > th["quality_drop"]:
            violations.append({
                "check": f"quality:{key}",
                "baseline": round(old, 4), "candidate": round(new, 4),
                "drop": round(old - new, 4),
                "threshold": th["quality_drop"],
            })

    # --- forensics: detection quality ---------------------------------
    base_for = baseline.get("forensics") or {}
    cand_for = candidate.get("forensics") or {}
    old_tpr, new_tpr = _num(base_for.get("tpr")), _num(cand_for.get("tpr"))
    if old_tpr is not None and new_tpr is not None:
        checks += 1
        if (old_tpr - new_tpr) > th["tpr_drop"]:
            violations.append({
                "check": "forensics:tpr",
                "baseline": round(old_tpr, 4), "candidate": round(new_tpr, 4),
                "drop": round(old_tpr - new_tpr, 4),
                "threshold": th["tpr_drop"]})
    old_fpr, new_fpr = _num(base_for.get("fpr")), _num(cand_for.get("fpr"))
    if old_fpr is not None and new_fpr is not None:
        checks += 1
        if (new_fpr - old_fpr) > th["fpr_rise"]:
            violations.append({
                "check": "forensics:fpr",
                "baseline": round(old_fpr, 4), "candidate": round(new_fpr, 4),
                "rise": round(new_fpr - old_fpr, 4),
                "threshold": th["fpr_rise"]})

    # --- utilization: achieved-FLOP/s drop -----------------
    # Same noise floor as the rounds/s gate: achieved FLOP/s divides a
    # STATIC flop count by the measured device time, so its wobble is
    # exactly the rate wobble — a gate tighter than the noise would cry
    # wolf on every loaded-box rep.
    old_util = _num((baseline.get("utilization") or {})
                    .get("achieved_flops_per_sec"))
    new_util = _num((candidate.get("utilization") or {})
                    .get("achieved_flops_per_sec"))
    util_threshold = max(th["util_drop_pct"], noise_pct)
    if old_util is not None and new_util is not None and old_util > 0:
        checks += 1
        drop_pct = 100.0 * (old_util - new_util) / old_util
        if drop_pct > util_threshold:
            violations.append({
                "check": "utilization:achieved_flops_per_sec",
                "baseline": round(old_util, 3),
                "candidate": round(new_util, 3),
                "drop_pct": round(drop_pct, 2),
                "threshold_pct": round(util_threshold, 2),
            })

    # --- scheduler SLO: p95 queue wait over fingerprint peers ---------
    # Noise-floored like the perf gates: the allowed wait is
    # the peers' p95 stretched by queue_wait_pct AND at least
    # queue_wait_floor_s above it, so an idle-box dispatch-jitter delta
    # can never fail the gate.  Only fires when the baseline carries the
    # pooled peer waits (rolling_baseline) or at least a single wait.
    peer_waits = baseline.get("sched_wait_peers")
    if not isinstance(peer_waits, list) or not peer_waits:
        single = _num(baseline.get("sched_wait_seconds"))
        peer_waits = [single] if single is not None else []
    peer_waits = [w for w in (_num(x) for x in peer_waits)
                  if w is not None]
    cand_wait = _num(candidate.get("sched_wait_seconds"))
    if peer_waits and cand_wait is not None:
        from attackfl_tpu_torch.telemetry.summary import percentile

        checks += 1
        p95 = percentile(peer_waits, 95.0)
        allowed = max(p95 * (1.0 + th["queue_wait_pct"] / 100.0),
                      p95 + th["queue_wait_floor_s"])
        if cand_wait > allowed:
            violations.append({
                "check": "sched:queue_wait_p95",
                "baseline": round(p95, 3),
                "candidate": round(cand_wait, 3),
                "allowed": round(allowed, 3),
                "peers": len(peer_waits),
            })

    # --- hotspots: host-bound-fraction rise ----------------
    # Absolute rise past the baseline, floored by the peers' own spread
    # (pooled fractions when the rolling baseline carries them) and
    # capped — the dispatch-gap diagnosis is exactly what the
    # sweep-regroup work moves, so a silent host-bound drift must fail
    # loudly, but a baseline that itself wobbles 0.2 can't gate at 0.15.
    base_hot = baseline.get("hotspots") or {}
    cand_hot = candidate.get("hotspots") or {}
    old_hb = _num(base_hot.get("host_bound_fraction"))
    new_hb = _num(cand_hot.get("host_bound_fraction"))
    if old_hb is not None and new_hb is not None:
        checks += 1
        peer_fractions = [f for f in
                          (_num(x) for x in
                           base_hot.get("hostbound_peers") or [])
                          if f is not None]
        spread = (max(peer_fractions) - min(peer_fractions)
                  if len(peer_fractions) >= 2 else 0.0)
        hb_threshold = min(max(th["hostbound_rise"], spread),
                           th["hostbound_noise_cap"])
        if (new_hb - old_hb) > hb_threshold:
            violations.append({
                "check": "hotspots:host_bound_fraction",
                "baseline": round(old_hb, 4),
                "candidate": round(new_hb, 4),
                "rise": round(new_hb - old_hb, 4),
                "threshold": round(hb_threshold, 4),
            })

    # --- hotspots: top-op self-time share drift ------------
    # Either direction, ops named in BOTH top tables only (an op absent
    # from one side is a table-depth artifact, not evidence).
    def _shares(block: dict[str, Any]) -> dict[str, float]:
        out: dict[str, float] = {}
        for row in block.get("top_ops") or []:
            if isinstance(row, dict) and row.get("name"):
                value = _num(row.get("share"))
                if value is not None:
                    out[str(row["name"])] = value
        return out

    base_shares, cand_shares = _shares(base_hot), _shares(cand_hot)
    for name in sorted(set(base_shares) & set(cand_shares)):
        checks += 1
        drift = cand_shares[name] - base_shares[name]
        if abs(drift) > th["top_op_share_drift"]:
            violations.append({
                "check": f"hotspots:op_share:{name}",
                "baseline": round(base_shares[name], 4),
                "candidate": round(cand_shares[name], 4),
                "drift": round(drift, 4),
                "threshold": th["top_op_share_drift"],
            })

    # --- numerics: non-finite values are never an acceptable delta ----
    old_nf = _num((baseline.get("numerics") or {}).get("nonfinite_total"))
    new_nf = _num((candidate.get("numerics") or {}).get("nonfinite_total"))
    if new_nf is not None:
        checks += 1
        if new_nf > (old_nf or 0.0):
            violations.append({
                "check": "numerics:nonfinite_total",
                "baseline": old_nf or 0, "candidate": new_nf})

    return {
        "ok": not violations,
        "checks": checks,
        "violations": violations,
        "baseline_id": baseline.get("record_id"),
        "candidate_id": candidate.get("record_id"),
        "rate_threshold_pct": round(rate_threshold, 2),
        "rate_noise_pct": round(noise_pct, 2),
    }
