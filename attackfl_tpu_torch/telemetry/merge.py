"""Cross-process event merge and round-skew analysis (the port's copy of
``attackfl_tpu/telemetry/merge.py``).

A multi-process run writes one ``events.<process_index>.jsonl`` per
process, keyed by the shared ``run_id``.  ``python -m attackfl_tpu_torch
metrics --merge <dir>`` interleaves those per-process streams by ``ts``
into one timeline and reports per-round cross-process skew:

* **completion skew** — spread of the ``round`` event timestamps across
  processes for the same round (how far apart the processes leave the
  round's final barrier);
* **barrier lag per phase** — max−min of each phase's duration across
  processes for the same round: a process that finishes ``train`` early
  waits in the collective aggregation for the slowest one, so a
  persistent per-phase lag is the cross-process imbalance.

The same entry point understands the run service's spool layout: a
directory holding ``service.events.jsonl`` and/or
``jobs/<job_id>/events.jsonl`` per-job streams merges those by ``ts``
instead, with each job event stamped with its ``job_id`` provenance.
The port's runs over more than one process (``--coordinator``) write the
per-process files, as the JAX package's do.

It reads JSON only, like :mod:`.summary`.
"""

from __future__ import annotations

import os
import re
from typing import Any

from attackfl_tpu_torch.telemetry.fleet import JOBS_DIRNAME, SERVICE_EVENTS_NAME
from attackfl_tpu_torch.telemetry.summary import load_events, percentile

PROCESS_FILE_RE = re.compile(r"^events\.(\d+)\.jsonl$")
# the run-service spool layout (attackfl_tpu_torch/service/daemon.py)
SERVICE_FILE = SERVICE_EVENTS_NAME
SERVICE_KEY = "service"


def find_process_files(path: str) -> list[tuple[int | None, str]]:
    """Event files in a run directory: ``events.jsonl`` (single-process,
    index None) plus every ``events.<i>.jsonl``, ordered by index."""
    if os.path.isfile(path):
        match = PROCESS_FILE_RE.match(os.path.basename(path))
        return [(int(match.group(1)) if match else None, path)]
    found: list[tuple[int | None, str]] = []
    single = os.path.join(path, "events.jsonl")
    if os.path.exists(single):
        found.append((None, single))
    for name in sorted(os.listdir(path)):
        match = PROCESS_FILE_RE.match(name)
        if match:
            found.append((int(match.group(1)), os.path.join(path, name)))
    return sorted(found, key=lambda item: (item[0] is not None, item[0] or 0))


def is_spool(path: str) -> bool:
    """A run-service spool: holds ``service.events.jsonl`` or a
    ``jobs/`` directory, and no plain ``events.jsonl`` (a run directory
    with one keeps the classic per-process merge)."""
    return (os.path.isdir(path)
            and not os.path.exists(os.path.join(path, "events.jsonl"))
            and (os.path.exists(os.path.join(path, SERVICE_FILE))
                 or os.path.isdir(os.path.join(path, JOBS_DIRNAME))))


def find_spool_files(path: str) -> list[tuple[str, str]]:
    """Event files of a service spool: the service stream (key
    ``"service"``) plus every ``jobs/<job_id>/events.jsonl`` (key = the
    job id), jobs sorted for a stable merge order."""
    found: list[tuple[str, str]] = []
    service = os.path.join(path, SERVICE_FILE)
    if os.path.exists(service):
        found.append((SERVICE_KEY, service))
    jobs_dir = os.path.join(path, JOBS_DIRNAME)
    if os.path.isdir(jobs_dir):
        for job_id in sorted(os.listdir(jobs_dir)):
            job_file = os.path.join(jobs_dir, job_id, "events.jsonl")
            if os.path.exists(job_file):
                found.append((job_id, job_file))
    return found


def merge_events(path: str) -> tuple[list[dict[str, Any]],
                                     dict[int | str | None, int]]:
    """Load every event file under ``path`` and interleave by ``ts``
    (stable sort, so same-timestamp records keep file order).

    Run directories merge ``events.<i>.jsonl`` per-process files, events
    missing a ``process_index`` envelope field (v1 files) inheriting the
    index parsed from their filename.  Service SPOOLS merge
    the service stream with every ``jobs/<id>/events.jsonl``, each job
    event stamped with its ``job_id`` provenance.  Returns
    (merged, events-per-source)."""
    per_process: dict[int | str | None, int] = {}
    merged: list[dict[str, Any]] = []
    if is_spool(path):
        sources: list[tuple[int | str | None, str]] = list(
            find_spool_files(path))
    else:
        sources = list(find_process_files(path))
    for index, file_path in sources:
        events = [e for e in load_events(file_path)
                  if e.get("kind") != "_skipped"]
        for event in events:
            if isinstance(index, str):
                if index != SERVICE_KEY:
                    event.setdefault("job_id", index)
            else:
                event.setdefault("process_index", index)
        per_process[index] = len(events)
        merged.extend(events)
    merged.sort(key=lambda e: e.get("ts") if isinstance(
        e.get("ts"), (int, float)) else float("inf"))
    return merged, per_process


def skew_summary(merged: list[dict[str, Any]]) -> dict[str, Any]:
    """Per-round cross-host skew over a merged stream.

    Rounds are correlated by (run_id, round number) and compared only when
    two or more processes reported them.  All figures are seconds.
    """
    headers: dict[Any, set[Any]] = {}
    rounds: dict[tuple[Any, int], dict[Any, dict[str, Any]]] = {}
    for event in merged:
        run_id = event.get("run_id")
        pid = event.get("process_index")
        if event.get("kind") == "run_header":
            headers.setdefault(run_id, set()).add(pid)
        elif event.get("kind") == "round" and isinstance(
                event.get("round"), int):
            rounds.setdefault((run_id, event["round"]), {})[pid] = event

    completion: list[tuple[int, float]] = []  # (round, spread)
    phase_lags: dict[str, list[tuple[int, float]]] = {}
    compared = 0
    for (_run_id, rnd), by_pid in sorted(rounds.items(),
                                         key=lambda kv: kv[0][1]):
        if len(by_pid) < 2:
            continue
        compared += 1
        stamps = [e["ts"] for e in by_pid.values()
                  if isinstance(e.get("ts"), (int, float))]
        if len(stamps) >= 2:
            completion.append((rnd, max(stamps) - min(stamps)))
        names = set()
        for event in by_pid.values():
            names |= set((event.get("phases") or {}).keys())
        for name in names:
            durations = [
                (event.get("phases") or {}).get(name)
                for event in by_pid.values()
            ]
            durations = [d for d in durations
                         if isinstance(d, (int, float))]
            if len(durations) >= 2:
                phase_lags.setdefault(name, []).append(
                    (rnd, max(durations) - min(durations)))

    spreads = [s for _, s in completion]
    worst = max(completion, key=lambda rs: rs[1]) if completion else None
    return {
        "processes": sorted(
            {pid for by_pid in rounds.values() for pid in by_pid
             if pid is not None}),
        "run_headers": {str(run_id): sorted(
            p for p in pids if p is not None)
            for run_id, pids in headers.items()},
        "rounds_compared": compared,
        "completion_skew_s": {
            "p50": round(percentile(spreads, 50), 6),
            "max": round(worst[1], 6),
            "max_round": worst[0],
        } if completion else None,
        "phase_lag_s": {
            name: {
                "max": round(max(lag for _, lag in lags), 6),
                "max_round": max(lags, key=lambda rl: rl[1])[0],
                "mean": round(sum(lag for _, lag in lags) / len(lags), 6),
                "rounds": len(lags),
            }
            for name, lags in sorted(phase_lags.items())
        },
    }


def _source_label(key: int | str | None) -> str:
    """One merge source's display name: per-process files by index, a
    spool's service stream / per-job files by layout."""
    if key is None:
        return "events.jsonl"
    if isinstance(key, int):
        return f"events.{key}.jsonl"
    if key == SERVICE_KEY:
        return SERVICE_FILE
    return f"{JOBS_DIRNAME}/{key}/events.jsonl"


def format_merge_report(merged: list[dict[str, Any]],
                        per_process: dict[int | str | None, int],
                        skew: dict[str, Any]) -> str:
    lines = ["merged " + ", ".join(
        f"{_source_label(i)} ({n} events)" for i, n in sorted(
            per_process.items(),
            key=lambda kv: (kv[0] is None, isinstance(kv[0], str),
                            kv[0] if isinstance(kv[0], int) else 0,
                            str(kv[0]))))]
    for run_id, pids in skew["run_headers"].items():
        lines.append(f"run {run_id}: run_header from process(es) "
                     f"{pids or ['<single>']}")
    if not skew["rounds_compared"]:
        lines.append("no round reported by 2+ processes — nothing to "
                     "compare (single-process run?)")
        return "\n".join(lines)
    lines.append(f"rounds compared across processes: "
                 f"{skew['rounds_compared']}")
    spread = skew["completion_skew_s"]
    if spread:
        lines.append(
            f"round completion skew: p50={spread['p50'] * 1e3:.1f}ms "
            f"max={spread['max'] * 1e3:.1f}ms "
            f"(round {spread['max_round']})")
    if skew["phase_lag_s"]:
        lines.append(f"{'phase':<14}{'max lag':>12}{'mean lag':>12}"
                     f"{'worst round':>13}")
        for name, stats in skew["phase_lag_s"].items():
            lines.append(
                f"{name:<14}{stats['max'] * 1e3:>10.1f}ms"
                f"{stats['mean'] * 1e3:>10.1f}ms"
                f"{stats['max_round']:>13}")
    return "\n".join(lines)
