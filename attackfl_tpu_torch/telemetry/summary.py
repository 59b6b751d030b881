"""Turn a run's events back into a run summary (the port's copy of
``summarize`` from ``attackfl_tpu/telemetry/summary.py``).

``summarize`` gives the per-phase p50/p95/mean, rounds/s steady and
including compile, the final quality metric, the counters snapshot and
the lifecycle lists the ledger record reads.  The ``metrics`` command
line itself is not ported yet: the JAX package's jax-free
``python -m attackfl_tpu metrics <dir>`` reads a port run's file.
"""

from __future__ import annotations

from typing import Any

FINAL_METRIC_KEYS = ("roc_auc", "accuracy", "nll", "train_loss")


def percentile(values: list[float], q: float) -> float:
    """Linear-interpolation percentile (numpy's default), dependency-free."""
    if not values:
        return float("nan")
    ordered = sorted(values)
    if len(ordered) == 1:
        return ordered[0]
    rank = (len(ordered) - 1) * (q / 100.0)
    lo = int(rank)
    hi = min(lo + 1, len(ordered) - 1)
    frac = rank - lo
    return ordered[lo] * (1.0 - frac) + ordered[hi] * frac


def summarize(events: list[dict[str, Any]]) -> dict[str, Any]:
    """Aggregate one run's events into the summary dict the CLI renders."""
    header = next((e for e in events if e.get("kind") == "run_header"), None)
    skipped = sum(e.get("count", 0) for e in events
                  if e.get("kind") == "_skipped")
    rounds = [e for e in events if e.get("kind") == "round"]
    chunks = [e for e in events if e.get("kind") == "chunk"]
    compiles = [e for e in events if e.get("kind") == "compile"]
    retries = [e for e in events if e.get("kind") == "retry"]
    # schema v4: fault-injection ground truth, executor
    # degradation transitions, and the crash-safe resume boundary
    faults = [e for e in events if e.get("kind") == "fault"]
    degrades = [e for e in events if e.get("kind") == "degrade"]
    resume = next((e for e in events if e.get("kind") == "resume"), None)
    counters = next((e["counters"] for e in reversed(events)
                     if e.get("kind") == "counters"), None)
    run_end = next((e for e in reversed(events)
                    if e.get("kind") == "run_end"), None)

    phases: dict[str, list[float]] = {}
    for record in rounds:
        for name, dur in (record.get("phases") or {}).items():
            if isinstance(dur, (int, float)) and not isinstance(dur, bool):
                phases.setdefault(name, []).append(float(dur))
    per_phase = {
        name: {
            "p50_s": round(percentile(vals, 50), 6),
            "p95_s": round(percentile(vals, 95), 6),
            "mean_s": round(sum(vals) / len(vals), 6),
            "count": len(vals),
        }
        for name, vals in phases.items()
    }

    ok_rounds = sum(1 for r in rounds if r.get("ok"))
    rates: dict[str, Any] = {}
    if chunks:
        # fused path: per-chunk wall is the genuine measurement; the first
        # dispatch of a chunk length includes its compile
        total_rounds = sum(int(c["chunk_len"]) for c in chunks)
        total_s = sum(float(c["seconds"]) for c in chunks)
        steady = [c for c in chunks if not c.get("includes_compile")]
        if total_s > 0:
            rates["rounds_per_sec_incl_compile"] = round(total_rounds / total_s, 4)
        if steady:
            steady_rounds = sum(int(c["chunk_len"]) for c in steady)
            steady_s = sum(float(c["seconds"]) for c in steady)
            if steady_s > 0:
                rates["rounds_per_sec_steady"] = round(steady_rounds / steady_s, 4)
                rates["seconds_per_round_steady"] = round(steady_s / steady_rounds, 4)
    else:
        timed = [r for r in rounds
                 if isinstance(r.get("seconds"), (int, float))]
        total_s = sum(float(r["seconds"]) for r in timed)
        if timed and total_s > 0:
            rates["rounds_per_sec_incl_compile"] = round(len(timed) / total_s, 4)
        if len(timed) > 1:
            # round 1's wall time includes every first-call jit compile
            steady_s = sum(float(r["seconds"]) for r in timed[1:])
            if steady_s > 0:
                rates["rounds_per_sec_steady"] = round(
                    (len(timed) - 1) / steady_s, 4)
                rates["seconds_per_round_steady"] = round(
                    steady_s / (len(timed) - 1), 4)

    final: dict[str, float] = {}
    for record in reversed(rounds):
        if not record.get("ok"):
            continue
        for key in FINAL_METRIC_KEYS:
            value = record.get(key)
            if isinstance(value, (int, float)) and not isinstance(value, bool):
                final[key] = value
        if final:
            break

    return {
        "run_id": (header or {}).get("run_id"),
        "header": {k: (header or {}).get(k) for k in
                   ("backend", "num_devices", "mode", "model", "data_name",
                    "total_clients")} if header else None,
        "rounds_attempted": len(rounds),
        "rounds_ok": ok_rounds,
        "retries": len(retries),
        "phases": per_phase,
        "rates": rates,
        "compiles": [{k: c.get(k) for k in
                      ("program", "seconds", "cache_hits", "cache_misses")
                      if c.get(k) is not None}
                     for c in compiles],
        "final": final,
        "counters": counters,
        "run_end": ({k: run_end.get(k) for k in ("rounds", "ok_rounds", "seconds")}
                    if run_end else None),
        "skipped_lines": skipped,
        # run-lifecycle robustness (schema v4): present even when empty so
        # the JSON shape is stable across fault-free and chaos runs
        "faults": [{k: f.get(k) for k in ("fault", "action", "round")
                    if f.get(k) is not None} for f in faults],
        "degrades": [{k: d.get(k)
                      for k in ("state", "round", "consecutive_failures")
                      if d.get(k) is not None} for d in degrades],
        "resumed_from": ({"round": resume.get("round"),
                          "path": resume.get("path"),
                          "source_run_id": resume.get("source_run_id")}
                         if resume else None),
        # hotspot observatory (schema v14): one row per
        # profiling window — status + the mined headline numbers
        "hotspots": [{k: e.get(k) for k in
                      ("status", "program", "round_first", "round_last",
                       "host_bound_fraction", "classification",
                       "books_close", "trace", "reason")
                      if e.get(k) is not None}
                     for e in events if e.get("kind") == "hotspot"],
    }
