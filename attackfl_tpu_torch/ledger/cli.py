"""``python -m attackfl_tpu_torch ledger``: query the cross-run store, diff
runs, gate CI (the port's copy of ``attackfl_tpu/ledger/cli.py``; its
output and exit codes are the JAX package's).

Subcommands (all torch-free — they read JSON and print; safe on any box
that merely holds the artifacts):

* ``list`` — the store's index as a table (or ``--json``);
* ``show ID`` — one full record (id prefixes resolve when unambiguous);
* ``compare A [B]`` — column diff of two records; with one id, A is
  diffed against its rolling baseline (median of its fingerprint+executor
  peers);
* ``regress [ID]`` — the CI gate: noise-aware thresholds over perf,
  quality, forensics and numerics columns; exit 0 = pass, 1 = regression,
  2 = nothing to compare.  Default candidate: the newest record;
  default baseline: its rolling baseline (``--against ID`` pins one);
* ``import FILE...`` — backfill committed bench artifacts
  (``BENCH_*.json`` metric lines or their wrappers) into the store.
"""

from __future__ import annotations

import argparse
import datetime
import json
import sys
from typing import Any

from attackfl_tpu_torch.ledger.compare import (
    compare_records, regress_check, rolling_baseline,
)
from attackfl_tpu_torch.ledger.record import records_from_bench, validate_record
from attackfl_tpu_torch.ledger.store import LedgerStore, resolve_ledger_dir


def _fmt_ts(ts: Any) -> str:
    if not isinstance(ts, (int, float)) or isinstance(ts, bool):
        return "-"
    return datetime.datetime.fromtimestamp(ts).strftime("%Y-%m-%d %H:%M")


def _fmt(value: Any, nd: int = 4) -> str:
    if isinstance(value, bool):
        return str(value)
    if isinstance(value, (int, float)):
        return f"{value:.{nd}g}" if isinstance(value, float) else str(value)
    return "-" if value is None else str(value)


def _fmt_depth(entry: dict[str, Any]) -> str:
    """`ledger list` depth column: configured depth, with the effective
    depth appended when a demotion dropped it mid-run (``4>0``)."""
    depth = entry.get("pipeline_depth")
    if not isinstance(depth, int) or isinstance(depth, bool):
        return "-"
    effective = entry.get("pipeline_depth_effective")
    if isinstance(effective, int) and not isinstance(effective, bool) \
            and effective != depth:
        return f"{depth}>{effective}"
    return str(depth)


def _fmt_mesh(entry: dict[str, Any]) -> str:
    """`ledger list` mesh column: device count of the run's mesh (``-``
    for meshless runs and records predating the field)."""
    devices = entry.get("mesh_devices")
    if not isinstance(devices, int) or isinstance(devices, bool) \
            or devices < 1:
        return "-"
    return str(devices)


def _fmt_sched(entry: dict[str, Any]) -> tuple[str, str]:
    """`ledger list` scheduler columns: priority class (with the
    preemption count appended when nonzero, ``low*2``) and queue wait —
    ``-`` on runs that never went through the service scheduler."""
    priority = entry.get("sched_priority")
    if not priority:
        return "-", "-"
    preemptions = entry.get("sched_preemptions")
    prio = str(priority)
    if isinstance(preemptions, int) and not isinstance(preemptions, bool) \
            and preemptions > 0:
        prio += f"*{preemptions}"
    wait = entry.get("sched_wait_seconds")
    wait_text = (f"{wait:.1f}s" if isinstance(wait, (int, float))
                 and not isinstance(wait, bool) else "-")
    return prio, wait_text


def format_list(entries: list[dict[str, Any]]) -> str:
    lines = [f"{'id':<22}{'when':<18}{'exec':<11}{'depth':<7}{'mesh':<6}"
             f"{'src':<7}"
             f"{'workload':<28}{'rounds':>7}{'steady r/s':>11}"
             f"{'prio':>8}{'wait':>7}"]
    for entry in entries:
        workload = "-"
        if entry.get("cell"):
            # a matrix cell record: the cell key IS the workload identity
            workload = str(entry["cell"])
        elif entry.get("model") or entry.get("mode"):
            workload = (f"{entry.get('model') or '?'}/"
                        f"{entry.get('mode') or '?'}"
                        f" c{entry.get('total_clients') or '?'}")
        rounds = entry.get("rounds")
        ok = entry.get("ok_rounds")
        rounds_text = (f"{ok}/{rounds}" if isinstance(rounds, int)
                       and isinstance(ok, int) and rounds else "-")
        prio, wait_text = _fmt_sched(entry)
        lines.append(
            f"{str(entry.get('record_id') or '?')[:21]:<22}"
            f"{_fmt_ts(entry.get('ts')):<18}"
            f"{str(entry.get('executor') or '-'):<11}"
            f"{_fmt_depth(entry):<7}"
            f"{_fmt_mesh(entry):<6}"
            f"{str(entry.get('source') or '-'):<7}"
            f"{workload[:27]:<28}"
            f"{rounds_text:>7}"
            f"{_fmt(entry.get('rounds_per_sec_steady')):>11}"
            f"{prio:>8}{wait_text:>7}")
    return "\n".join(lines)


def format_record(record: dict[str, Any]) -> str:
    lines = [f"record {record.get('record_id')} "
             f"[{record.get('source')}/{record.get('executor')}"
             + (f"/depth={_fmt_depth(record)}"
                if isinstance(record.get("pipeline_depth"), int)
                and not isinstance(record.get("pipeline_depth"), bool)
                else "")
             + (f"/mesh={_fmt_mesh(record)}"
                if _fmt_mesh(record) != "-" else "")
             + ("/resumed" if record.get("resumed") else "") + "]"]
    lines.append(
        f"  run_id={record.get('run_id') or '-'} "
        f"fingerprint={record.get('fingerprint') or '-'} "
        f"git={record.get('git_rev') or '-'}")
    lines.append(
        f"  jax={record.get('jax_version') or '-'}"
        f"/{record.get('jaxlib_version') or '-'} "
        f"backend={record.get('backend') or '-'} "
        f"platform={record.get('platform') or '-'}")
    if record.get("model") or record.get("mode"):
        lines.append(
            f"  workload: {record.get('model')}/{record.get('data_name')} "
            f"mode={record.get('mode')} clients={record.get('total_clients')}")
    lines.append(
        f"  rounds: {record.get('ok_rounds')}/{record.get('rounds')} ok "
        f"in {_fmt(record.get('wall_seconds'))}s, "
        f"steady={_fmt(record.get('rounds_per_sec_steady'))} r/s, "
        f"incl-compile={_fmt(record.get('rounds_per_sec_incl_compile'))} r/s")
    attribution = record.get("time_attribution") or {}
    if attribution:
        lines.append(
            "  time: device={} host={} validate={} ckpt={} "
            "ckpt-overlap={} compile={} defense={} (of wall {})".format(
                *(_fmt(attribution.get(k)) for k in (
                    "device_compute_s", "host_resolution_s", "validation_s",
                    "checkpoint_s", "checkpoint_overlapped_s", "compile_s",
                    "defense_host_s", "wall_s"))))
    if record.get("sched_priority") is not None:
        sched_line = (f"  sched: priority={record.get('sched_priority')} "
                      f"wait={_fmt(record.get('sched_wait_seconds'))}s "
                      f"preemptions="
                      f"{_fmt(record.get('sched_preemptions'))}")
        if record.get("sched_tenant"):
            sched_line += f" tenant={record['sched_tenant']}"
        if record.get("sched_fleet_id"):
            sched_line += f" fleet={record['sched_fleet_id']}"
        if record.get("sched_slot") is not None:
            sched_line += f" slot={record['sched_slot']}"
        lines.append(sched_line)
    if record.get("round_device_time") is not None:
        lines.append(
            f"  per-round: device={_fmt(record.get('round_device_time'))}s "
            f"host-resolution="
            f"{_fmt(record.get('host_resolution_latency'))}s "
            "(depth-k auto-tune inputs)")
    utilization = record.get("utilization") or {}
    if utilization:
        achieved = utilization.get("achieved_flops_per_sec")
        fraction = utilization.get("utilization_flops")
        line = (f"  cost: flops/round={_fmt(utilization.get('flops_per_round'))} "
                f"bytes/round={_fmt(utilization.get('bytes_per_round'))}")
        if achieved is not None:
            line += f" achieved={_fmt(achieved)}FLOP/s"
        if fraction is not None:
            line += (f" roofline={100 * fraction:.2f}% of "
                     f"{_fmt(utilization.get('peak_flops_per_sec'))} peak")
        elif achieved is not None:
            line += (f" (achieved-only: no peak spec for "
                     f"{utilization.get('device_kind') or 'this device'})")
        lines.append(line)
    hotspots = record.get("hotspots") or {}
    if hotspots:
        line = (f"  hotspots: windows={_fmt(hotspots.get('windows'))} "
                f"hostbound={_fmt(hotspots.get('host_bound_fraction'))} "
                f"({hotspots.get('classification') or '-'}) "
                f"books={'close' if hotspots.get('books_close') else 'OPEN'}")
        factor = hotspots.get("hotspot_prediction_error_factor")
        if factor is not None:
            line += f" pred-err={_fmt(factor)}x"
        lines.append(line)
        top = hotspots.get("top_ops") or []
        if top:
            lines.append("  top ops: " + " ".join(
                f"{row.get('name')}={_fmt(row.get('share'))}"
                for row in top[:5] if isinstance(row, dict)))
    programs = record.get("programs") or {}
    if programs:
        lines.append(
            "  programs: " + " ".join(
                f"{name}[flops={_fmt(p.get('flops'))}]"
                for name, p in sorted(programs.items())
                if isinstance(p, dict)))
    compile_info = record.get("compile") or {}
    if compile_info.get("programs") or compile_info.get("cache_hits") \
            is not None:
        lines.append(
            f"  compile: {compile_info.get('programs', 0)} program(s) "
            f"{_fmt(compile_info.get('seconds'))}s"
            + (f", persistent cache {compile_info.get('cache_hits')} hit(s) "
               f"/ {compile_info.get('cache_misses')} miss(es)"
               if compile_info.get("cache_hits") is not None else ""))
    for section in ("final", "numerics", "forensics", "counts"):
        data = record.get(section)
        if data:
            shown = {k: v for k, v in data.items() if v not in (None, 0)}
            if shown:
                lines.append(f"  {section}: " + " ".join(
                    f"{k}={_fmt(v)}" for k, v in shown.items()))
    phases = record.get("phases") or {}
    if phases:
        lines.append(f"  {'phase':<14}{'p50':>10}{'p95':>10}{'n':>6}")
        for name, stats in phases.items():
            p50, p95 = stats.get("p50_s"), stats.get("p95_s")
            lines.append(
                f"  {name:<14}"
                f"{(p50 or 0) * 1e3:>8.1f}ms{(p95 or 0) * 1e3:>8.1f}ms"
                f"{stats.get('count', 0):>6}")
    return "\n".join(lines)


def format_compare(diff: dict[str, Any]) -> str:
    lines = [f"compare {diff.get('old_id')} -> {diff.get('new_id')}"
             + ("" if diff.get("fingerprint_match")
                else "  [WARNING: different config fingerprints — "
                     "not apples to apples]")]
    executor = diff.get("executor") or {}
    if executor.get("old") != executor.get("new"):
        lines.append(f"  executor: {executor.get('old')} -> "
                     f"{executor.get('new')}")
    depth = diff.get("pipeline_depth") or {}
    if depth.get("old") != depth.get("new"):
        lines.append(f"  pipeline depth: {depth.get('old')} -> "
                     f"{depth.get('new')}  [different depths are "
                     "non-peers for rolling baselines]")
    mesh = diff.get("mesh_devices") or {}
    if mesh.get("old") != mesh.get("new"):
        lines.append(f"  mesh devices: {mesh.get('old')} -> "
                     f"{mesh.get('new')}  [different mesh sizes are "
                     "non-peers for rolling baselines]")

    def render(title: str, columns: dict[str, Any], pct: bool = True):
        rows = []
        for name, delta in columns.items():
            if not isinstance(delta, dict) or delta.get("old") is None \
                    and delta.get("new") is None:
                continue
            row = (f"    {name:<26}{_fmt(delta.get('old')):>12}"
                   f"{_fmt(delta.get('new')):>12}")
            if "pct" in delta and pct:
                row += f"{delta['pct']:>+9.1f}%"
            elif "delta" in delta:
                row += f"{delta['delta']:>+10.4g}"
            rows.append(row)
        if rows:
            lines.append(f"  {title}:")
            lines.append(f"    {'column':<26}{'old':>12}{'new':>12}"
                         f"{'delta':>10}")
            lines.extend(rows)

    render("perf", diff.get("perf") or {})
    render("time attribution", diff.get("time_attribution") or {})
    phase_rows = {f"{name}.p95": (data or {}).get("p95_s")
                  for name, data in (diff.get("phases") or {}).items()}
    render("phases", {k: v for k, v in phase_rows.items() if v})
    render("quality", diff.get("quality") or {}, pct=False)
    render("numerics", diff.get("numerics") or {}, pct=False)
    render("forensics", diff.get("forensics") or {}, pct=False)
    render("utilization", diff.get("utilization") or {})
    sched = diff.get("sched") or {}
    if sched:
        prio = sched.get("priority") or {}
        if prio.get("old") != prio.get("new"):
            lines.append(f"  sched priority: {prio.get('old')} -> "
                         f"{prio.get('new')}  [cross-priority waits are "
                         "not apples to apples]")
        render("sched", {"wait_seconds": sched.get("wait_seconds"),
                         "preemptions": sched.get("preemptions")},
               pct=False)
    hotspots = diff.get("hotspots") or {}
    if hotspots:
        render("hotspots", {
            "host_bound_fraction": hotspots.get("host_bound_fraction"),
            "measured_device_s": hotspots.get("measured_round_device_s"),
            "pred_error_factor": hotspots.get("prediction_error_factor"),
        }, pct=False)
        share_rows = {f"share:{name}": delta for name, delta in
                      (hotspots.get("top_op_shares") or {}).items()}
        render("top-op shares", share_rows, pct=False)
    counts = {k: v for k, v in (diff.get("counts") or {}).items()
              if isinstance(v, dict) and v.get("delta")}
    render("counts (changed)", counts, pct=False)
    return "\n".join(lines)


def format_regress(verdict: dict[str, Any]) -> str:
    lines = [
        f"regress {verdict.get('candidate_id')} vs "
        f"{verdict.get('baseline_id')}: "
        + ("PASS" if verdict.get("ok") else "REGRESSION")
        + f" ({verdict.get('checks')} check(s), rate threshold "
          f"{verdict.get('rate_threshold_pct')}%"
        + (f", noise floor {verdict.get('rate_noise_pct')}%"
           if verdict.get("rate_noise_pct") else "") + ")"]
    for violation in verdict.get("violations") or []:
        detail = " ".join(f"{k}={_fmt(v)}" for k, v in violation.items()
                          if k != "check")
        lines.append(f"  FAIL {violation.get('check')}: {detail}")
    return "\n".join(lines)


def sweep_rollup(records: list[dict[str, Any]], sweep_id: str) -> str:
    """One-line sweep summary for ``ledger list --sweep``: cell
    completion (a cell with lost rounds was quarantined by the per-cell
    retry budget or cut by an interruption) + median final quality.
    Reads FULL records — the index carries no quality columns."""
    import statistics

    from attackfl_tpu_torch.science.outcomes import pick_quality_key

    cells = [r for r in records if r.get("source") == "matrix"
             and r.get("sweep_id") == sweep_id]
    if not cells:
        return f"sweep {sweep_id}: no cell records"
    done = sum(
        1 for r in cells
        if isinstance(r.get("ok_rounds"), int)
        and isinstance(r.get("rounds"), int)
        and r["rounds"] > 0 and r["ok_rounds"] >= r["rounds"])
    quality_key = pick_quality_key(cells)
    line = (f"sweep {sweep_id}: {len(cells)} cell(s), {done} complete, "
            f"{len(cells) - done} quarantined/cut")
    if quality_key:
        values = [
            (r.get("final") or {}).get(quality_key) for r in cells]
        values = [v for v in values if isinstance(v, (int, float))
                  and not isinstance(v, bool)]
        if values:
            line += (f", median {quality_key} "
                     f"{statistics.median(values):.4f}")
    return line


def _store(args) -> LedgerStore:
    # an explicit --dir beats the env var (the user typed it); without
    # one, fall back to $ATTACKFL_LEDGER_DIR then ./ledger
    return LedgerStore(args.dir or resolve_ledger_dir())


def _get_or_die(store: LedgerStore, record_id: str) -> dict[str, Any]:
    record = store.get(record_id)
    if record is None:
        print(f"no ledger record {record_id!r} in {store.directory!r}",
              file=sys.stderr)
        raise SystemExit(2)
    return record


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m attackfl_tpu_torch ledger",
        description="Query the persistent cross-run ledger, diff runs and "
                    "gate regressions.")
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--dir", type=str, default=None,
                        help="ledger directory (default: "
                             "$ATTACKFL_LEDGER_DIR or ./ledger)")
    sub = parser.add_subparsers(dest="command", required=True)

    p_list = sub.add_parser("list", parents=[common],
                            help="index of every recorded run")
    p_list.add_argument("--fingerprint", type=str, default=None)
    p_list.add_argument("--executor", type=str, default=None)
    p_list.add_argument("--sweep", type=str, default=None,
                        help="only this matrix sweep's cell records, "
                             "plus a one-line completion/quality rollup")
    p_list.add_argument("--json", action="store_true")

    p_show = sub.add_parser("show", parents=[common],
                            help="one full record")
    p_show.add_argument("id")
    p_show.add_argument("--json", action="store_true")

    p_cmp = sub.add_parser("compare", parents=[common],
                           help="diff two records (or one vs its rolling "
                                "baseline)")
    p_cmp.add_argument("a")
    p_cmp.add_argument("b", nargs="?", default=None)
    p_cmp.add_argument("--window", type=int, default=5,
                       help="rolling-baseline depth (records)")
    p_cmp.add_argument("--json", action="store_true")

    p_reg = sub.add_parser("regress", parents=[common],
                           help="CI gate: exit 1 on perf/quality regression")
    p_reg.add_argument("id", nargs="?", default=None,
                       help="candidate record (default: newest)")
    p_reg.add_argument("--against", type=str, default=None,
                       help="explicit baseline record id (default: rolling "
                            "baseline by config fingerprint)")
    p_reg.add_argument("--window", type=int, default=5)
    p_reg.add_argument("--threshold-pct", type=float, default=None,
                       help="steady-rounds/s slowdown that fails "
                            "(default 10; noise-floored)")
    p_reg.add_argument("--sweeps", nargs=2, metavar=("OLD", "NEW"),
                       default=None,
                       help="rank-stability gate between two matrix "
                            "sweeps instead of a record pair (delegates "
                            "to `science diff --gate`)")
    p_reg.add_argument("--json", action="store_true")

    p_imp = sub.add_parser("import", parents=[common],
                           help="backfill bench artifacts (BENCH_*.json)")
    p_imp.add_argument("files", nargs="+")
    p_imp.add_argument("--json", action="store_true")

    args = parser.parse_args(argv)
    store = _store(args)

    if args.command == "list":
        entries = store.index()
        if args.fingerprint:
            entries = [e for e in entries
                       if e.get("fingerprint") == args.fingerprint]
        if args.executor:
            entries = [e for e in entries
                       if e.get("executor") == args.executor]
        if args.sweep:
            entries = [e for e in entries
                       if e.get("sweep_id") == args.sweep]
        if args.json:
            print(json.dumps(entries, indent=1))
        elif not entries:
            print(f"empty ledger at {store.directory!r}", file=sys.stderr)
            return 2
        else:
            print(format_list(entries))
            if args.sweep:
                records, _ = store.load()
                print(sweep_rollup(records, args.sweep))
        return 0

    if args.command == "show":
        record = _get_or_die(store, args.id)
        print(json.dumps(record, indent=1) if args.json
              else format_record(record))
        return 0

    if args.command == "compare":
        new = _get_or_die(store, args.a if args.b is None else args.b)
        if args.b is None:
            records, _ = store.load()
            old = rolling_baseline(records, new, window=args.window)
            if old is None:
                print(f"no baseline peers for {args.a!r} (fingerprint "
                      f"{new.get('fingerprint')!r})", file=sys.stderr)
                return 2
        else:
            old = _get_or_die(store, args.a)
        diff = compare_records(old, new)
        print(json.dumps(diff, indent=1) if args.json
              else format_compare(diff))
        return 0

    if args.command == "regress" and args.sweeps:
        # the science rank gate rides the familiar CI entry point
        from attackfl_tpu_torch.science.cli import main as science_main

        return science_main(
            ["diff", args.sweeps[0], args.sweeps[1], "--gate"]
            + (["--dir", args.dir] if args.dir else [])
            + (["--json"] if args.json else []))

    if args.command == "regress":
        records, _ = store.load()
        if not records:
            print(f"empty ledger at {store.directory!r}", file=sys.stderr)
            return 2
        candidate = (_get_or_die(store, args.id) if args.id
                     else records[-1])
        if args.against:
            baseline = _get_or_die(store, args.against)
        else:
            baseline = rolling_baseline(records, candidate,
                                        window=args.window)
            if baseline is None:
                print(
                    f"no baseline peers for "
                    f"{candidate.get('record_id')!r} (fingerprint "
                    f"{candidate.get('fingerprint')!r}) — nothing to gate",
                    file=sys.stderr)
                return 2
        thresholds = ({"rounds_per_sec_pct": args.threshold_pct}
                      if args.threshold_pct is not None else None)
        verdict = regress_check(baseline, candidate, thresholds)
        print(json.dumps(verdict, indent=1) if args.json
              else format_regress(verdict))
        return 0 if verdict["ok"] else 1

    if args.command == "import":
        imported: list[str] = []
        problems = 0
        for path in args.files:
            try:
                with open(path) as fh:
                    parsed = json.load(fh)
            except (OSError, json.JSONDecodeError) as e:
                print(f"skipping {path}: {e}", file=sys.stderr)
                problems += 1
                continue
            records = records_from_bench(parsed) \
                if isinstance(parsed, dict) else []
            if not records:
                print(f"skipping {path}: no recognizable bench metric",
                      file=sys.stderr)
                problems += 1
                continue
            for record in records:
                bad = validate_record(record)
                if bad:
                    print(f"skipping a record from {path}: {bad}",
                          file=sys.stderr)
                    problems += 1
                    continue
                rid = store.append(record)
                imported.append(rid)
                if not args.json:
                    print(f"imported {rid} "
                          f"[{record.get('bench_metric')}"
                          f"/{record.get('bench_variant')}] from {path}")
        if args.json:
            print(json.dumps({"imported": imported,
                              "skipped": problems}, indent=1))
        return 0 if imported and not problems else (0 if imported else 2)

    raise AssertionError(f"unhandled command {args.command!r}")


if __name__ == "__main__":
    raise SystemExit(main())
