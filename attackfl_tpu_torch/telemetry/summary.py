"""The ``metrics`` command: turn ``events.jsonl`` back into a run summary
(the port's copy of ``attackfl_tpu/telemetry/summary.py``).

``python -m attackfl_tpu_torch metrics <dir-or-file>`` prints, for the
last run recorded in the file (or a specific ``--run-id``, or ``--all``):
per-phase p50/p95/mean, rounds/s both steady-state and including the
first round's builds, the final quality metric, the counters snapshot
and the lifecycle lists the ledger record reads.  ``--forensics`` gives
the defense's TPR/FPR from ``attribution`` events, ``--numerics`` the
device-side round metrics, ``--programs`` the cost model's per-program
profiles and roofline estimate, ``--json`` the summary as JSON.
``--merge`` interleaves a run directory's per-process ``events.<i>.jsonl``
files, or a run service spool's service and per-job streams, by ``ts``
and reports the cross-process round skew (:mod:`.merge`); the other
reports then read the merged stream.

It reads JSON and does percentile arithmetic only, so it runs anywhere
the file is.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any

FINAL_METRIC_KEYS = ("roc_auc", "accuracy", "nll", "train_loss")


def load_events(path: str) -> list[dict[str, Any]]:
    """Read events from a file, or from ``<path>/events.jsonl`` when given
    a directory.  Malformed lines are skipped (a wedged run can die
    mid-write) but counted into the '_skipped' sentinel of the result: a
    synthetic trailing ``{"kind": "_skipped", "count": N, "path": ...}``
    record (in-memory only, never written to disk) that ``summarize``
    surfaces as ``skipped_lines`` so a truncated artifact is visibly
    truncated instead of silently shorter."""
    if os.path.isdir(path):
        path = os.path.join(path, "events.jsonl")
    events: list[dict[str, Any]] = []
    skipped = 0
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                record = json.loads(line)
            except json.JSONDecodeError:
                skipped += 1
                continue
            if isinstance(record, dict):
                events.append(record)
            else:
                skipped += 1  # valid JSON but not an event object
    if skipped:
        events.append({"kind": "_skipped", "count": skipped, "path": path})
    return events


def split_runs(events: list[dict[str, Any]]) -> list[list[dict[str, Any]]]:
    """Group an appended multi-run file into per-run segments by run_id
    (falling back to run_header boundaries for id-less records)."""
    runs: list[list[dict[str, Any]]] = []
    index: dict[str, int] = {}
    for event in events:
        run_id = event.get("run_id")
        if run_id is None:
            if not runs or event.get("kind") == "run_header":
                runs.append([])
            runs[-1].append(event)
            continue
        if run_id not in index:
            index[run_id] = len(runs)
            runs.append([])
        runs[index[run_id]].append(event)
    return runs


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


def format_summary(summary: dict[str, Any]) -> str:
    lines: list[str] = []
    header = summary.get("header") or {}
    title = f"run {summary.get('run_id') or '<no header>'}"
    if header:
        title += (f" — {header.get('model')}/{header.get('data_name')}"
                  f" mode={header.get('mode')} backend={header.get('backend')}"
                  f" clients={header.get('total_clients')}")
    lines.append(title)
    lines.append(
        f"rounds: {summary['rounds_attempted']} attempted, "
        f"{summary['rounds_ok']} ok, {summary['retries']} retried")
    resumed = summary.get("resumed_from")
    if resumed:
        lines.append(
            f"resumed: from round {resumed['round']} "
            f"({resumed.get('path') or 'manifest'}) — round numbers "
            "continue from there")
    if summary.get("faults"):
        injected = [f for f in summary["faults"]
                    if f.get("action") == "injected"]
        recovered = [f for f in summary["faults"]
                     if f.get("action") == "recovered"]
        kinds = sorted({f.get("fault", "?") for f in injected})
        lines.append(
            f"faults: {len(injected)} injected"
            + (f" ({', '.join(kinds)})" if kinds else "")
            + (f", {len(recovered)} recovered" if recovered else ""))
    for transition in summary.get("degrades") or []:
        lines.append(
            f"degrade: {transition.get('state')} at round "
            f"{transition.get('round')}")
    for window in summary.get("hotspots") or []:
        detail = (f" hostbound={window.get('host_bound_fraction')}"
                  f" ({window.get('classification')})"
                  if window.get("status") == "ok"
                  else f" ({window.get('reason') or 'no attribution'})")
        lines.append(
            f"hotspot: {window.get('program')} rounds "
            f"{window.get('round_first')}-{window.get('round_last')} "
            f"{window.get('status')}{detail}")
    if summary["phases"]:
        lines.append(f"{'phase':<14}{'p50':>10}{'p95':>10}{'mean':>10}{'n':>6}")
        for name, stats in summary["phases"].items():
            lines.append(
                f"{name:<14}{stats['p50_s'] * 1e3:>8.1f}ms"
                f"{stats['p95_s'] * 1e3:>8.1f}ms"
                f"{stats['mean_s'] * 1e3:>8.1f}ms{stats['count']:>6}")
    rates = summary["rates"]
    if rates:
        parts = []
        if "rounds_per_sec_steady" in rates:
            parts.append(f"steady={rates['rounds_per_sec_steady']} "
                         f"({rates['seconds_per_round_steady']} s/round)")
        if "rounds_per_sec_incl_compile" in rates:
            parts.append(f"incl-compile={rates['rounds_per_sec_incl_compile']}")
        lines.append("rounds/s: " + ", ".join(parts))
    for compile_event in summary["compiles"]:
        line = (f"compile: {compile_event['program']} "
                f"{compile_event['seconds']:.2f}s")
        if "cache_hits" in compile_event or "cache_misses" in compile_event:
            # persistent-cache stats event (training/engine._finish_run)
            line += (f" [persistent cache: {compile_event.get('cache_hits', 0)}"
                     f" hit(s), {compile_event.get('cache_misses', 0)} miss(es)]")
        lines.append(line)
    if summary["final"]:
        lines.append("final: " + " ".join(
            f"{k}={v:.4f}" for k, v in summary["final"].items()))
    if summary["counters"]:
        lines.append("counters: " + " ".join(
            f"{k}={v}" for k, v in summary["counters"].items()))
    if summary["run_end"]:
        lines.append(f"run_end: {summary['run_end']['ok_rounds']}/"
                     f"{summary['run_end']['rounds']} ok in "
                     f"{summary['run_end']['seconds']:.2f}s")
    if summary.get("skipped_lines"):
        lines.append(f"skipped: {summary['skipped_lines']} malformed "
                     "line(s) (truncated mid-write?)")
    return "\n".join(lines)


def _select_runs(events: list[dict[str, Any]], run_id: str | None,
                 all_runs: bool) -> list[list[dict[str, Any]]]:
    """The CLI's run-selection rule: a specific --run-id, --all, or the
    last run recorded in the file."""
    runs = split_runs(events)
    if run_id:
        runs = [r for r in runs if any(e.get("run_id") == run_id for e in r)]
    elif not all_runs:
        runs = runs[-1:]
    return runs


def _merge_main(args) -> int:
    from attackfl_tpu_torch.telemetry import merge as merge_mod

    try:
        merged, per_process = merge_mod.merge_events(args.path)
    except (FileNotFoundError, NotADirectoryError):
        merged, per_process = [], {}
    if not merged:
        print(f"no events*.jsonl under {args.path!r}", file=sys.stderr)
        return 2
    if args.forensics:
        return _forensics_main(args, merged, merged_stream=True)
    if args.numerics:
        return _numerics_main(args, merged)
    if args.programs:
        return _programs_main(args, merged)
    skew = merge_mod.skew_summary(merged)
    if args.json:
        print(json.dumps({
            "events_per_process": {str(k): v for k, v in per_process.items()},
            "skew": skew,
        }, indent=1))
    else:
        print(merge_mod.format_merge_report(merged, per_process, skew))
    return 0


def _numerics_main(args, events: list[dict[str, Any]]) -> int:
    from attackfl_tpu_torch.telemetry.numerics import (
        format_numerics, numerics_summary,
    )

    runs = _select_runs(events, args.run_id, args.all)
    if not runs:
        print(f"no events recorded in {args.path!r}", file=sys.stderr)
        return 2
    reports = []
    for run in runs:
        summary = numerics_summary(run)
        if summary is not None:
            run_id = next((e.get("run_id") for e in run
                           if e.get("run_id")), None)
            reports.append((run_id, summary))
    if not reports:
        print("no numerics metric events found (enable telemetry.numerics "
              "/ --numerics on the run, or a pre-v3 artifact)",
              file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps([dict(s, run_id=rid) for rid, s in reports]
                         if args.all or len(reports) > 1
                         else dict(reports[0][1], run_id=reports[0][0]),
                         indent=1))
    else:
        print("\n\n".join(format_numerics(s, rid) for rid, s in reports))
    return 0


def _programs_main(args, events: list[dict[str, Any]]) -> int:
    """``--programs``: the cost model's per-program table (schema v9;
    JAX ``summary._programs_main``)."""
    from attackfl_tpu_torch.costmodel.report import format_programs, programs_summary

    runs = _select_runs(events, args.run_id, args.all)
    if not runs:
        print(f"no events recorded in {args.path!r}", file=sys.stderr)
        return 2
    reports = []
    for run in runs:
        summary = programs_summary(run)
        if summary is not None:
            run_id = next((e.get("run_id") for e in run
                           if e.get("run_id")), None)
            reports.append((run_id, summary))
    if not reports:
        print("no program_profile events found (telemetry.costmodel off, "
              "or a pre-v9 artifact)", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps([dict(s, run_id=rid) for rid, s in reports]
                         if args.all or len(reports) > 1
                         else dict(reports[0][1], run_id=reports[0][0]),
                         indent=1))
    else:
        print("\n\n".join(format_programs(s, rid) for rid, s in reports))
    return 0


def _forensics_main(args, events: list[dict[str, Any]],
                    merged_stream: bool = False) -> int:
    from attackfl_tpu_torch.telemetry.forensics import (
        forensics_by_defense, forensics_summary, format_forensics,
    )

    if merged_stream and not args.run_id:
        # a merged multi-stream spool (a service spool, a sweep's cell
        # spools) is one cross-run aggregate with a per-defense breakdown
        summary = forensics_by_defense(events)
        if summary is None:
            print("no attribution events found in the merged stream",
                  file=sys.stderr)
            return 2
        print(json.dumps(summary, indent=1) if args.json
              else format_forensics(summary))
        return 0

    runs = _select_runs(events, args.run_id, args.all)
    if not runs:
        print(f"no events recorded in {args.path!r}", file=sys.stderr)
        return 2
    reports = []
    for run in runs:
        summary = forensics_summary(run)
        if summary is not None:
            run_id = next((e.get("run_id") for e in run
                           if e.get("run_id")), None)
            reports.append((run_id, summary))
    if not reports:
        print("no attribution events found (no attackers configured, "
              "fused-path-only run, or a pre-v2 artifact)", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps([dict(s, run_id=rid) for rid, s in reports]
                         if args.all or len(reports) > 1
                         else dict(reports[0][1], run_id=reports[0][0]),
                         indent=1))
    else:
        print("\n\n".join(format_forensics(s, rid) for rid, s in reports))
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m attackfl_tpu_torch metrics",
        description="Summarize a telemetry events.jsonl (per-phase p50/p95, "
                    "rounds/s steady vs incl-compile, final metric).  "
                    "--forensics reports the defense's TPR/FPR/precision "
                    "from attribution events; --numerics reports the "
                    "device-side round metrics; --programs reports the "
                    "cost model's per-program flops/bytes/memory profiles "
                    "and roofline estimate.  --merge interleaves a run "
                    "directory's per-process events.<i>.jsonl files by ts "
                    "and reports cross-process round skew.")
    parser.add_argument("path", nargs="?", default=".",
                        help="events.jsonl or a directory containing it")
    parser.add_argument("--run-id", type=str, default=None,
                        help="summarize this run instead of the last one")
    parser.add_argument("--all", action="store_true",
                        help="summarize every run in the file")
    parser.add_argument("--json", action="store_true",
                        help="emit the summary as JSON instead of a table")
    parser.add_argument("--merge", action="store_true",
                        help="interleave per-process event files "
                             "(multi-process run) or a service spool's "
                             "service + per-job streams (each job event "
                             "stamped with its job_id) and report round "
                             "skew")
    parser.add_argument("--forensics", action="store_true",
                        help="defense detection quality (TPR/FPR) from "
                             "attribution events")
    parser.add_argument("--numerics", action="store_true",
                        help="per-round device-side numerics report "
                             "(update-norm distributions, attack "
                             "separation, drift, non-finite provenance) "
                             "from schema-v3 metric events")
    parser.add_argument("--programs", action="store_true",
                        help="per-program cost profiles (flops, bytes "
                             "accessed, peak memory) and the roofline "
                             "utilization estimate from schema-v9 "
                             "program_profile events")
    args = parser.parse_args(argv)

    if args.merge:
        return _merge_main(args)

    try:
        events = load_events(args.path)
    except FileNotFoundError:
        print(f"no events.jsonl at {args.path!r}", file=sys.stderr)
        return 2
    if args.forensics:
        return _forensics_main(args, events)
    if args.numerics:
        return _numerics_main(args, events)
    if args.programs:
        return _programs_main(args, events)
    runs = split_runs(events)
    if not runs:
        print(f"no events recorded in {args.path!r}", file=sys.stderr)
        return 2
    if args.run_id:
        runs = [r for r in runs if any(e.get("run_id") == args.run_id for e in r)]
        if not runs:
            print(f"run id {args.run_id!r} not found", file=sys.stderr)
            return 2
    elif not args.all:
        runs = runs[-1:]

    summaries = [summarize(run) for run in runs]
    if args.json:
        print(json.dumps(summaries if args.all else summaries[0], indent=1))
    else:
        print("\n\n".join(format_summary(s) for s in summaries))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
