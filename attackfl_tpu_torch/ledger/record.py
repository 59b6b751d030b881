"""Ledger record derivation: one run's events -> one cross-run record, and
the bench backfill behind ``ledger import`` (the port's copy of
``attackfl_tpu/ledger/record.py``).

``derive_record`` is pure post-processing over the run's written
telemetry (this run's slice of ``events.jsonl`` and the tracer's spans):
it adds no host sync and never touches the round loop.

**Wall-time attribution** is mined from the tracer's spans, per executor:

* sync — ``device_compute_s`` = the phases that wait on the card (train,
  aggregate, hyper_update);
* fused — ``device_compute_s`` = the ``chunk`` spans;
* pipelined — ``device_compute_s`` = the ``resolve`` + ``dispatch`` spans:
  the host's time issuing rounds and waiting for them, which is JAX's
  definition and not the card's busy time.

``validation_s`` / ``checkpoint_s`` are the foreground spans,
``checkpoint_overlapped_s`` the async writer's submits, and
``host_resolution_s`` the remainder of the run's wall time.  The two
per-round derivatives ``round_device_time`` and
``host_resolution_latency`` are what ``pipeline_depth: auto`` reads.  The
cost model's bookkeeping during a counted dispatch is taken out of every
span (``Tracer.discount``), so it is in none of these buckets but the
remainder; the counted dispatch's own work stays in its round's spans.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from typing import Any

from attackfl_tpu_torch.costmodel.estimate import predict_device_time, prediction_error_factor
from attackfl_tpu_torch.costmodel.report import profiles_from_events
from attackfl_tpu_torch.costmodel.roofline import utilization_summary
from attackfl_tpu_torch.profiler.mine import hotspots_from_events
from attackfl_tpu_torch.telemetry.forensics import forensics_summary
from attackfl_tpu_torch.telemetry.numerics import numerics_summary
from attackfl_tpu_torch.telemetry.summary import summarize
from attackfl_tpu_torch.utils.fingerprint import fingerprint_from_dict

LEDGER_SCHEMA_VERSION = 1

# Span names that block on device programs, per executor (see module doc).
_DEVICE_SPANS = {
    "sync": ("train", "aggregate", "hyper_update", "numerics"),
    "fused": ("chunk",),
    "pipelined": ("resolve", "dispatch"),
}
_DEFENSE_SPANS = ("defense", "detect", "attribution")

_REQUIRED_RECORD_FIELDS: dict[str, type | tuple[type, ...]] = {
    "ledger_schema": int, "source": str, "executor": str,
    "fingerprint": str, "rounds": int, "ok_rounds": int,
    "time_attribution": dict, "counts": dict,
}

_git_rev_cache: str | None = None


def git_revision(root: str | None = None) -> str:
    """Working-tree revision (``-dirty`` suffixed), cached per process;
    empty string outside a git checkout.  Called once per run header —
    never on the round loop."""
    global _git_rev_cache
    if _git_rev_cache is not None and root is None:
        return _git_rev_cache
    cwd = root or os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    rev = ""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short=12", "HEAD"], cwd=cwd,
            capture_output=True, text=True, timeout=5)
        if out.returncode == 0:
            rev = out.stdout.strip()
            dirty = subprocess.run(
                ["git", "status", "--porcelain", "--untracked-files=no"],
                cwd=cwd, capture_output=True, text=True, timeout=5)
            if dirty.returncode == 0 and dirty.stdout.strip():
                rev += "-dirty"
    except (OSError, subprocess.SubprocessError):
        rev = ""
    if root is None:
        _git_rev_cache = rev
    return rev


# ---------------------------------------------------------------------------
# span mining
# ---------------------------------------------------------------------------

def _span_totals(trace_events: list[dict[str, Any]] | None
                 ) -> dict[str, list]:
    """Chrome-trace "X" events -> {name: [total_seconds, count]}, with
    checkpoint spans split by their ``background`` arg into
    ``checkpoint`` (foreground) and ``checkpoint_bg`` (overlapped)."""
    totals: dict[str, list] = {}
    for event in trace_events or []:
        if event.get("ph") != "X":
            continue
        name = str(event.get("name", ""))
        dur = event.get("dur")
        if not isinstance(dur, (int, float)) or isinstance(dur, bool):
            continue
        if name == "checkpoint" and (event.get("args") or {}).get(
                "background"):
            name = "checkpoint_bg"
        bucket = totals.setdefault(name, [0.0, 0])
        bucket[0] += float(dur) / 1e6  # trace durations are microseconds
        bucket[1] += 1
    return totals


def detect_executor(events: list[dict[str, Any]]) -> str:
    """Which executor produced this run — derivable from the event record
    alone: pipelined rounds stamp ``pipelined: true``, the fused path
    emits ``chunk`` events, everything else is the synchronous loop."""
    for event in events:
        if event.get("kind") == "round" and event.get("pipelined"):
            return "pipelined"
    if any(e.get("kind") == "chunk" for e in events):
        return "fused"
    return "sync"


def mine_attribution(events: list[dict[str, Any]],
                     trace_events: list[dict[str, Any]] | None,
                     executor: str, wall_s: float) -> dict[str, Any]:
    """The device/host/overlap wall-time split (see module doc)."""
    spans = _span_totals(trace_events)

    def total(*names: str) -> float:
        return sum(spans.get(n, (0.0, 0))[0] for n in names)

    device = total(*_DEVICE_SPANS.get(executor, ()))
    validation = total("validate")
    checkpoint = total("checkpoint")
    checkpoint_bg = total("checkpoint_bg")
    compile_s = total("compile")
    if executor in ("fused", "pipelined"):
        # the AOT compile spans nest INSIDE the chunk/dispatch spans
        # (engine._fused_executable / _pipeline_executable run under
        # them); subtract so compile time is not double-counted
        device = max(device - compile_s, 0.0)
    defense = total(*_DEFENSE_SPANS)
    accounted = device + validation + checkpoint + compile_s + defense
    host_resolution = max(wall_s - accounted, 0.0)
    background_validations = sum(
        1 for e in events
        if e.get("kind") == "validation" and e.get("background"))
    return {
        "wall_s": round(wall_s, 6),
        "device_compute_s": round(device, 6),
        "host_resolution_s": round(host_resolution, 6),
        "validation_s": round(validation, 6),
        "checkpoint_s": round(checkpoint, 6),
        "checkpoint_overlapped_s": round(checkpoint_bg, 6),
        "validation_overlapped": background_validations,
        "compile_s": round(compile_s, 6),
        "defense_host_s": round(defense, 6),
    }


# ---------------------------------------------------------------------------
# record derivation
# ---------------------------------------------------------------------------

def derive_record(events: list[dict[str, Any]],
                  trace_events: list[dict[str, Any]] | None = None,
                  fingerprint: str | None = None,
                  source: str = "run",
                  ledger_records: list[dict[str, Any]] | None = None
                  ) -> dict[str, Any] | None:
    """Distill one run's event slice (+ optional trace spans) into a
    ledger record.  Returns None for an empty slice (nothing ran).

    The ``numerics`` join reads the numerics ``metric`` events
    (``telemetry.numerics``).  ``programs`` are the run's
    ``program_profile`` events deduplicated per fingerprint, and
    ``utilization`` their per-round cost against the measured
    ``round_device_time`` (JAX ``ledger/record.py:280-300``).  ``hotspots``
    distills the run's ``hotspot`` windows; with ``ledger_records`` (the
    existing corpus) the windows' measured device time a round is priced
    against the cost model's prediction
    (``hotspot_prediction_error_factor``, the symmetric max(p/a, a/p) of
    ``costmodel/estimate.py``; JAX ``ledger/record.py:329-353``).  Each is
    None when the run wrote no such event."""
    if not events:
        return None
    summary = summarize(events)
    header = next((e for e in events if e.get("kind") == "run_header"), None)
    header = header or {}
    executor = detect_executor(events)
    run_end = summary.get("run_end") or {}
    wall_s = float(run_end.get("seconds") or 0.0)
    rounds = int(summary.get("rounds_attempted") or 0)
    attribution = mine_attribution(events, trace_events, executor, wall_s)

    if fingerprint is None:
        config = header.get("config")
        fingerprint = (fingerprint_from_dict(config)
                       if isinstance(config, dict) else "")

    rates = summary.get("rates") or {}
    counters = summary.get("counters") or {}
    counts = {
        "retries": int(summary.get("retries") or 0),
        "rollbacks": sum(1 for e in events if e.get("kind") == "rollback"),
        "faults_injected": sum(
            1 for f in summary.get("faults") or []
            if f.get("action") == "injected"),
        "faults_recovered": sum(
            1 for f in summary.get("faults") or []
            if f.get("action") == "recovered"),
        "degrades": len(summary.get("degrades") or []),
        "rounds_failed": int(counters.get("rounds_failed") or 0),
        "checkpoint_fallbacks": int(
            counters.get("checkpoint_fallbacks") or 0),
        "checkpoint_write_failures": int(
            counters.get("checkpoint_write_failures") or 0),
    }

    # compile events (the port writes none: it compiles no per-program
    # code) and the persistent-cache stats event, as JAX counts them
    compile_info: dict[str, Any] = {"programs": 0, "seconds": 0.0}
    for event in summary.get("compiles") or []:
        if event.get("program") == "persistent_cache":
            compile_info["cache_hits"] = event.get("cache_hits")
            compile_info["cache_misses"] = event.get("cache_misses")
            compile_info["backend_compile_s"] = event.get("seconds")
        else:
            compile_info["programs"] += 1
            seconds = event.get("seconds")
            if isinstance(seconds, (int, float)):
                compile_info["seconds"] = round(
                    compile_info["seconds"] + float(seconds), 6)

    numerics = numerics_summary(events)
    numerics_out = None
    if numerics is not None:
        numerics_out = {
            "rounds": numerics.get("rounds"),
            "nonfinite_total": numerics.get("nonfinite_total"),
            **(numerics.get("final") or {}),
        }
        separation = numerics.get("separation")
        if separation:
            numerics_out["sep_margin_mean"] = separation.get("margin_mean")
            numerics_out["sep_margin_min"] = separation.get("margin_min")

    forensics = forensics_summary(events)
    forensics_out = None
    if forensics is not None:
        forensics_out = {k: forensics.get(k) for k in
                         ("tpr", "fpr", "precision", "rounds",
                          "attack_rounds", "rollbacks")}

    # the pipelined executor's resolved depth from the run header, and
    # the run's least effective depth: 0 when it was ever demoted
    depth = header.get("pipeline_depth")
    if isinstance(depth, bool) or not isinstance(depth, int):
        depth = None
    demoted = any(e.get("kind") == "degrade"
                  and e.get("state") == "demoted" for e in events)
    configured = header.get("pipeline_depth_configured")

    # the provenance fields of JAX's mesh and scheduler runs, None (or 0)
    # on the port's one-device runs unless a header carries them
    mesh_devices = header.get("mesh_devices")
    if isinstance(mesh_devices, bool) or not isinstance(mesh_devices, int):
        mesh_devices = 0
    mesh_strategy = header.get("mesh_strategy")

    sched_priority = header.get("sched_priority")
    sched_preemptions = header.get("sched_preemptions")
    if isinstance(sched_preemptions, bool) \
            or not isinstance(sched_preemptions, int):
        sched_preemptions = None
    sched_wait = header.get("sched_wait_seconds")
    if isinstance(sched_wait, bool) \
            or not isinstance(sched_wait, (int, float)):
        sched_wait = None
    sched_fleet_id = header.get("sched_fleet_id")
    sched_tenant = header.get("sched_tenant")
    sched_slot = header.get("sched_slot")
    if isinstance(sched_slot, bool) or not isinstance(sched_slot, int):
        sched_slot = None

    programs = profiles_from_events(events) or None
    utilization = None
    if programs:
        device_kind = next((p["device_kind"] for p in programs.values()
                            if p.get("device_kind")), "")
        utilization = utilization_summary(
            programs,
            (attribution["device_compute_s"] / rounds) if rounds else None,
            device_kind, mesh_devices=mesh_devices)

    hotspots = hotspots_from_events(events)
    if hotspots is not None:
        measured = hotspots.get("measured_round_device_s")
        predicted = None
        if measured is not None and ledger_records:
            prediction = predict_device_time(
                ledger_records, fingerprint or "", profile=utilization)
            if prediction is not None:
                predicted, info = prediction
                hotspots["prediction_method"] = info.get("method")
        hotspots["predicted_round_device_s"] = (
            round(predicted, 6) if predicted is not None else None)
        hotspots["hotspot_prediction_error_factor"] = \
            prediction_error_factor(predicted, measured)

    steady = rates.get("rounds_per_sec_steady")
    record: dict[str, Any] = {
        "ledger_schema": LEDGER_SCHEMA_VERSION,
        "ts": _latest_ts(events),
        "source": source,
        "run_id": summary.get("run_id") or next(
            (e.get("run_id") for e in events if e.get("run_id")), None),
        "executor": executor,
        "pipeline_depth": depth,
        "pipeline_depth_configured": (str(configured)
                                      if configured is not None else None),
        "pipeline_depth_effective": ((0 if demoted else depth)
                                     if depth is not None else None),
        "mesh_devices": mesh_devices,
        "mesh_strategy": (str(mesh_strategy)
                          if mesh_strategy is not None else None),
        "sched_priority": (str(sched_priority)
                           if sched_priority is not None else None),
        "sched_preemptions": sched_preemptions,
        "sched_wait_seconds": (round(sched_wait + 0.0, 6)
                               if sched_wait is not None else None),
        "sched_fleet_id": (str(sched_fleet_id)
                           if sched_fleet_id is not None else None),
        "sched_tenant": (str(sched_tenant)
                         if sched_tenant is not None else None),
        "sched_slot": sched_slot,
        "resumed": summary.get("resumed_from") is not None,
        "fingerprint": fingerprint,
        "git_rev": str(header.get("git_rev") or ""),
        "jax_version": str(header.get("jax_version") or ""),
        "jaxlib_version": str(header.get("jaxlib_version") or ""),
        "backend": str(header.get("backend") or ""),
        "platform": str(header.get("platform") or ""),
        "mode": header.get("mode"),
        "model": header.get("model"),
        "data_name": header.get("data_name"),
        "total_clients": header.get("total_clients"),
        "rounds": rounds,
        "ok_rounds": int(summary.get("rounds_ok") or 0),
        "wall_seconds": round(wall_s, 6),
        "rounds_per_sec_steady": steady,
        "rounds_per_sec_incl_compile": rates.get(
            "rounds_per_sec_incl_compile"),
        "phases": {name: {k: stats[k] for k in ("p50_s", "p95_s", "count")}
                   for name, stats in (summary.get("phases") or {}).items()},
        "time_attribution": attribution,
        # the depth-k auto-tuner's two measured inputs (ROADMAP)
        "round_device_time": (
            round(attribution["device_compute_s"] / rounds, 6)
            if rounds else None),
        "host_resolution_latency": (
            round(attribution["host_resolution_s"] / rounds, 6)
            if rounds else None),
        "compile": compile_info,
        "programs": programs,
        "utilization": utilization,
        "hotspots": hotspots,
        "numerics": numerics_out,
        "forensics": forensics_out,
        "counts": counts,
        "final": summary.get("final") or {},
    }
    return record


def _latest_ts(events: list[dict[str, Any]]) -> float | None:
    latest = None
    for event in events:
        ts = event.get("ts")
        if isinstance(ts, (int, float)) and not isinstance(ts, bool):
            latest = ts if latest is None else max(latest, ts)
    return latest


def validate_record(record: Any) -> list[str]:
    """Schema floor for one ledger record (empty list = valid); extra
    fields are always allowed, like the event schema."""
    if not isinstance(record, dict):
        return [f"record is not an object: {type(record).__name__}"]
    errors: list[str] = []
    for name, typ in _REQUIRED_RECORD_FIELDS.items():
        if name not in record:
            errors.append(f"missing field '{name}'")
        elif typ is int and isinstance(record[name], bool):
            errors.append(f"'{name}' must be int, got bool")
        elif not isinstance(record[name], typ):
            errors.append(f"'{name}' has type {type(record[name]).__name__}")
    schema = record.get("ledger_schema")
    if isinstance(schema, int) and schema > LEDGER_SCHEMA_VERSION:
        errors.append(f"ledger schema {schema} is newer than "
                      f"{LEDGER_SCHEMA_VERSION}; update the tooling")
    return errors


# ---------------------------------------------------------------------------
# bench backfill (`ledger import`)
# ---------------------------------------------------------------------------

def _bench_fingerprint(metric: str, variant: str, label: str) -> str:
    """Baseline-matching key for bench records: same bench mode + variant
    + workload label -> same fingerprint (the bench has no Config dict)."""
    blob = f"{metric}|{variant}|{label}"
    return "bench-" + hashlib.sha256(blob.encode()).hexdigest()[:12]


def _bench_base(parsed: dict[str, Any], variant: str,
                executor: str) -> dict[str, Any]:
    metric = str(parsed.get("metric") or "")
    detail = parsed.get("detail") if isinstance(parsed.get("detail"), dict) \
        else {}
    label = str(detail.get("config") or "")
    return {
        "ledger_schema": LEDGER_SCHEMA_VERSION,
        "ts": parsed.get("ts"),
        "source": "bench",
        "run_id": None,
        "executor": executor,
        "resumed": False,
        "fingerprint": _bench_fingerprint(metric, variant, label),
        "bench_metric": metric,
        "bench_variant": variant,
        "config_label": label,
        "rounds": 0,
        "ok_rounds": 0,
        "time_attribution": {},
        "counts": {},
        "final": {},
    }


def records_from_bench(parsed: dict[str, Any]) -> list[dict[str, Any]]:
    """One bench metric line (or a ``BENCH_r0N.json`` wrapper with
    a ``parsed`` field) -> ledger records.  Comparative bench modes yield
    one record per measured variant so each variant gets its own baseline
    trajectory.  Unrecognized/contentless lines yield []."""
    if isinstance(parsed.get("parsed"), dict):
        parsed = parsed["parsed"]
    metric = str(parsed.get("metric") or "")
    detail = parsed.get("detail") if isinstance(parsed.get("detail"), dict) \
        else {}
    if not metric:
        return []
    records: list[dict[str, Any]] = []

    def rate_record(variant: str, executor: str,
                    block: dict[str, Any]) -> dict[str, Any]:
        record = _bench_base(parsed, variant, executor)
        record["rounds_per_sec_steady"] = (
            block.get("rounds_per_sec_steady")
            or block.get("rounds_per_sec"))
        if isinstance(block.get("rounds_per_sec_mean"), (int, float)):
            record["rounds_per_sec_mean"] = block["rounds_per_sec_mean"]
        if isinstance(block.get("per_rep"), list):
            record["per_rep"] = block["per_rep"]
        return record

    if metric.startswith("fl_pipeline_vs_sync"):
        for variant, executor in (("sync", "sync"),
                                  ("pipelined_async_ckpt", "pipelined")):
            block = detail.get(variant)
            if isinstance(block, dict):
                records.append(rate_record(variant, executor, block))
    elif metric.startswith("fl_numerics_on"):
        for variant in ("metrics_off", "metrics_on"):
            block = detail.get(variant)
            if isinstance(block, dict):
                record = rate_record(variant, "pipelined", block)
                if "overhead_pct" in detail:
                    record["overhead_pct"] = detail["overhead_pct"]
                records.append(record)
    elif metric.startswith("fl_matrix_vs_serial"):
        # one record per sweep variant so the serial and batched
        # trajectories each get their own baseline
        for variant, executor in (("serial", "fused"),
                                  ("batched", "matrix")):
            block = detail.get(variant)
            if isinstance(block, dict):
                record = rate_record(variant, executor, block)
                record["wall_seconds"] = block.get("warm_wall_s")
                record["cold_wall_s"] = block.get("cold_wall_s")
                for key in ("speedup_cold", "speedup_warm",
                            "compile_once_saving_s"):
                    if key in detail:
                        record[key] = detail[key]
                records.append(record)
    elif metric.startswith("fl_depth_sweep"):
        # depth sweep: one record per measured depth so every
        # k gets its own baseline trajectory — `pipeline_depth` rides the
        # record, making depths non-peers for `ledger regress` exactly
        # like engine-run records
        by_depth = detail.get("by_depth")
        if isinstance(by_depth, dict):
            def depth_key(name: str) -> int:
                return int(name) if str(name).lstrip("-").isdigit() else -1

            for key in sorted(by_depth, key=depth_key):
                block = by_depth[key]
                if not isinstance(block, dict):
                    continue
                record = rate_record(f"depth{key}", "pipelined", block)
                if depth_key(key) >= 0:
                    record["pipeline_depth"] = depth_key(key)
                    record["pipeline_depth_effective"] = depth_key(key)
                if isinstance(detail.get("auto_pick"), dict):
                    record["auto_pick"] = detail["auto_pick"]
                records.append(record)
    elif metric.startswith("fl_mesh_sweep"):
        # mesh sweep: one record per (device count x
        # workload) so every mesh size gets its own baseline trajectory
        # — `mesh_devices` rides the record, making sizes non-peers for
        # `ledger regress` exactly like engine-run records
        by_devices = detail.get("by_devices")
        if isinstance(by_devices, dict):
            def dev_key(name: str) -> int:
                return int(name) if str(name).isdigit() else -1

            for key in sorted(by_devices, key=dev_key):
                child = by_devices[key]
                if not isinstance(child, dict):
                    continue
                for workload, executor in (("fused", "fused"),
                                           ("matrix", "matrix")):
                    block = child.get(workload)
                    if not isinstance(block, dict):
                        continue
                    record = rate_record(f"{workload}@{key}dev", executor,
                                         block)
                    if dev_key(key) > 0:
                        record["mesh_devices"] = dev_key(key)
                    speedups = detail.get(f"{workload}_speedup")
                    if isinstance(speedups, dict) and key in speedups:
                        record["mesh_speedup"] = speedups[key]
                    records.append(record)
    elif metric.startswith("fl_contention"):
        # contention bench: scheduler vs serialized dispatch
        # over the same N-job mixed workload — one record per dispatch
        # mode so each keeps its own baseline trajectory
        for variant in ("serialized", "scheduler"):
            block = detail.get(variant)
            if not isinstance(block, dict):
                continue
            record = _bench_base(parsed, variant, "service")
            record["wall_seconds"] = block.get("makespan_s_mean")
            for key in ("mean_wait_s", "throughput_jobs_per_s",
                        "preemptions", "jobs"):
                if key in block:
                    record[key] = block[key]
            if isinstance(block.get("per_rep"), list):
                record["per_rep"] = block["per_rep"]
            if "throughput_ratio" in detail:
                record["throughput_ratio"] = detail["throughput_ratio"]
            records.append(record)
    elif metric.startswith("fl_compile_cache"):
        for variant in ("first_run", "warm_cache"):
            block = detail.get(variant)
            if not isinstance(block, dict):
                continue
            record = _bench_base(parsed, variant, "fused")
            record["compile"] = {
                "backend_compile_s": block.get("backend_compile_s"),
                "cache_hits": block.get("cache_hits"),
                "cache_misses": block.get("cache_misses"),
                "seconds": block.get("backend_compile_s"),
                "programs": 0,
            }
            records.append(record)
    else:
        # single-rate modes: fl_rounds_per_sec_100c / _configN /
        # _1000c / fl_e2e_N — the headline value IS the rate
        value = parsed.get("value")
        if isinstance(value, (int, float)) and not isinstance(value, bool):
            record = _bench_base(parsed, "headline", "fused")
            record["rounds_per_sec_steady"] = value
            for key in ("roc_auc_final", "roc_auc"):
                best = detail.get(key)
                if isinstance(best, (int, float)):
                    record["final"] = {"roc_auc": best}
                    break
            records.append(record)
    return records
