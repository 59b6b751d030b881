"""The fleet observatory: cross-job causal tracing, per-tenant device-time
accounting and service-level SLO gauges (the port's copy of
``attackfl_tpu/telemetry/fleet.py``).

The run service writes its scheduler's ``schedule`` and ``slot``
decisions into the spool's service stream and each job's own
``events.jsonl`` beside it.  This module stitches the spool back together
along the causal id every job carries (its ``fleet_id``, stamped into the
sealed spec at submit) into three views:

* :func:`fleet_trace` — one Perfetto-loadable Chrome trace for the whole
  session: one track per device SLOT (occupancy spans from paired
  ``slot`` acquire/release events — who held the device, billed to which
  tenant) and one track per JOB (queue-wait span from submit to first
  pack, preemption-gap spans from requeue to resume, run spans, and the
  per-chunk/per-round execution spans read from the job's own
  ``events.jsonl``).  Preempt/shed decisions land as instants.
* :func:`device_time_ledger` — the accounting view that CLOSES THE
  BOOKS: per-tenant busy device-seconds (slot-span durations billed to
  the occupant's tenant) plus measured idle (per-slot wall minus the
  union of its spans) must equal wall x slots within 5%.  A
  double-booked slot or a torn acquire/release pair breaks it.  Each job
  row joins its cost-model prediction (the admit event's
  ``predicted_seconds``) to its measured busy time via
  :func:`attackfl_tpu_torch.costmodel.estimate.prediction_error_factor`.
* :func:`slo_report` — service-level objectives from the same stream:
  p95 queue wait per priority class, preemption rate, shed rate, and the
  margin between the worst observed wait and the scheduler's configured
  starvation bound (the ``service started`` event carries the bound).

:func:`slot_spans` keys an open span by ``(slot, job_id)``, as the JAX
package does: a job that held a slot when its daemon was killed, and is
acquired on the same slot after the restart's replay, loses its first
span (ROADMAP.md, faults of the reference, replicated).

``SERVICE_EVENTS_NAME`` and ``JOBS_DIRNAME`` name the spool's layout for
the daemon (:mod:`attackfl_tpu_torch.service.daemon`), this module and
:mod:`.merge` alike.  The module reads JSON and does interval arithmetic
only, so ``python -m attackfl_tpu_torch fleet report|trace`` runs on any
machine holding a spool, and the daemon's ``/fleet`` route and the SLO
gauges on its ``/metrics`` call it live.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any

from attackfl_tpu_torch.telemetry.summary import load_events, percentile

# the run service's spool layout: its own event stream, and one directory
# a job under ``jobs/``
SERVICE_EVENTS_NAME = "service.events.jsonl"
JOBS_DIRNAME = "jobs"

# terminal job actions: the last one observed names how the job ended
_END_ACTIONS = ("completed", "failed", "cancelled")


def load_service_events(spool: str) -> list[dict[str, Any]]:
    """The service stream of one spool, ``_skipped`` sentinel dropped
    (the fleet stitcher works on real events only)."""
    events = load_events(os.path.join(spool, SERVICE_EVENTS_NAME))
    return [e for e in events if e.get("kind") != "_skipped"]


def _num(value: Any) -> float | None:
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        return None
    return float(value)


# ---------------------------------------------------------------------------
# causal stitching: service stream -> per-job timelines + slot spans
# ---------------------------------------------------------------------------

def job_timelines(events: list[dict[str, Any]]) -> dict[str, dict[str, Any]]:
    """Stitch the service stream into one causal record per job.

    Returns ``{job_id: {...}}`` where each record carries the submit ts,
    the admit evidence (priority / tenant / fleet_id / predicted
    seconds), every dispatch (pack/resume) and preemption, the requeue
    gaps, and the terminal action — everything the trace, the
    device-time ledger and the SLO report need, computed once."""
    jobs: dict[str, dict[str, Any]] = {}

    def rec(job_id: str) -> dict[str, Any]:
        return jobs.setdefault(job_id, {
            "job_id": job_id, "name": "", "priority": "", "tenant": "",
            "fleet_id": "", "predicted_seconds": None,
            "submitted_ts": None, "admit_ts": None,
            "dispatches": [],   # pack/resume schedule events
            "preempts": [],     # preempt schedule events
            "requeues": [],     # job requeued events (preempt/drain gaps)
            "end_ts": None, "end_action": "",
            "wait_seconds": 0.0, "preemptions": 0,
        })

    for event in events:
        kind = event.get("kind")
        ts = _num(event.get("ts"))
        if kind == "job" and event.get("job_id"):
            job = rec(str(event["job_id"]))
            action = event.get("action")
            if action == "submitted":
                if job["submitted_ts"] is None:
                    job["submitted_ts"] = ts
                job["name"] = str(event.get("name") or job["name"])
            elif action == "requeued":
                job["requeues"].append(
                    {"ts": ts, "reason": str(event.get("reason", ""))})
                if event.get("preemptions") is not None:
                    job["preemptions"] = max(
                        job["preemptions"], int(event["preemptions"]))
            elif action in _END_ACTIONS:
                job["end_ts"] = ts
                job["end_action"] = str(action)
        elif kind == "schedule" and event.get("job_id"):
            job = rec(str(event["job_id"]))
            action = event.get("action")
            for field in ("priority", "tenant", "fleet_id"):
                if event.get(field):
                    job[field] = str(event[field])
            if action == "admit":
                if job["admit_ts"] is None:
                    job["admit_ts"] = ts
                if job["predicted_seconds"] is None:
                    job["predicted_seconds"] = _num(
                        event.get("predicted_seconds"))
            elif action in ("pack", "resume"):
                job["dispatches"].append({
                    "ts": ts, "action": str(action),
                    "slot": event.get("slot"),
                    "wait_seconds": _num(event.get("wait_seconds")),
                    "preemptions": int(event.get("preemptions", 0)),
                })
                wait = _num(event.get("wait_seconds"))
                if wait is not None:
                    job["wait_seconds"] = max(job["wait_seconds"], wait)
            elif action == "preempt":
                job["preempts"].append({"ts": ts,
                                        "reason": str(event.get("reason",
                                                                ""))})
                if event.get("preemptions") is not None:
                    job["preemptions"] = max(
                        job["preemptions"], int(event["preemptions"]))
    return jobs


def slot_spans(events: list[dict[str, Any]],
               until_ts: float | None = None) -> list[dict[str, Any]]:
    """Pair ``slot`` acquire/release events into occupancy spans.

    An acquire without a release (session cut mid-run) is closed at
    ``until_ts`` (or the last event ts) so the span stays countable —
    the ledger's identity check is what flags systematic tearing."""
    open_spans: dict[tuple[int, str], dict[str, Any]] = {}
    spans: list[dict[str, Any]] = []
    last_ts = 0.0
    for event in events:
        if event.get("kind") != "slot":
            continue
        ts = _num(event.get("ts"))
        if ts is None:
            continue
        last_ts = max(last_ts, ts)
        slot = int(event.get("slot", 0))
        job_id = str(event.get("job_id", ""))
        key = (slot, job_id)
        if event.get("action") == "acquire":
            open_spans[key] = {
                "slot": slot, "job_id": job_id, "start_ts": ts,
                "tenant": str(event.get("tenant", "")),
                "priority": str(event.get("priority", "")),
                "fleet_id": str(event.get("fleet_id", "")),
                "reason": "",
            }
        elif event.get("action") == "release":
            span = open_spans.pop(key, None)
            if span is None:
                # release without a matched acquire: synthesize a span
                # from the scheduler's own busy measurement so the
                # device time is still billed, visibly approximate
                busy = _num(event.get("busy_seconds")) or 0.0
                span = {"slot": slot, "job_id": job_id,
                        "start_ts": ts - busy,
                        "tenant": str(event.get("tenant", "")),
                        "priority": str(event.get("priority", "")),
                        "fleet_id": str(event.get("fleet_id", "")),
                        "reason": "unmatched"}
            span["end_ts"] = ts
            span["reason"] = span["reason"] or str(event.get("reason", ""))
            for field in ("tenant", "priority", "fleet_id"):
                if not span[field] and event.get(field):
                    span[field] = str(event[field])
            spans.append(span)
    close_ts = until_ts if until_ts is not None else last_ts
    for span in open_spans.values():
        span["end_ts"] = max(close_ts, span["start_ts"])
        span["reason"] = "open"
        spans.append(span)
    spans.sort(key=lambda s: (s["slot"], s["start_ts"]))
    return spans


def _session_window(events: list[dict[str, Any]]
                    ) -> tuple[float, float, dict[str, Any]]:
    """(t0, t1, started-event) for the session: the ``service started``
    event opens the wall clock, ``stopped`` (or the last event) closes
    it.  Raises ValueError on a stream with no events at all."""
    ts_all = [t for t in (_num(e.get("ts")) for e in events)
              if t is not None]
    if not ts_all:
        raise ValueError("no timestamped events — not a service stream?")
    started = next((e for e in events if e.get("kind") == "service"
                    and e.get("action") == "started"), {})
    stopped = next((e for e in reversed(events)
                    if e.get("kind") == "service"
                    and e.get("action") == "stopped"), None)
    t0 = _num(started.get("ts")) if started else None
    t1 = _num(stopped.get("ts")) if stopped else None
    return (t0 if t0 is not None else min(ts_all),
            t1 if t1 is not None else max(ts_all), started)


# ---------------------------------------------------------------------------
# (b) the per-tenant device-time ledger — where the books close
# ---------------------------------------------------------------------------

def device_time_ledger(spool: str,
                       events: list[dict[str, Any]] | None = None
                       ) -> dict[str, Any]:
    """Close the books on one session: per-tenant busy device-seconds
    plus measured idle against wall x slots, and every job joined to its
    cost-model prediction."""
    from attackfl_tpu_torch.costmodel.estimate import prediction_error_factor

    if events is None:
        events = load_service_events(spool)
    t0, t1, started = _session_window(events)
    wall = max(t1 - t0, 0.0)
    spans = slot_spans(events, until_ts=t1)
    slot_indices = {s["slot"] for s in spans}
    slots = int(started.get("slots") or started.get("max_workers")
                or (max(slot_indices) + 1 if slot_indices else 1))
    slots = max(slots, (max(slot_indices) + 1) if slot_indices else 1)

    # clamp every span into the session window, then bill tenants
    clamped = []
    for span in spans:
        start = min(max(span["start_ts"], t0), t1)
        end = min(max(span["end_ts"], t0), t1)
        if end > start:
            clamped.append(dict(span, start_ts=start, end_ts=end,
                                busy_seconds=end - start))
    tenants: dict[str, dict[str, Any]] = {}
    busy_by_job: dict[str, float] = {}
    for span in clamped:
        tenant = span["tenant"] or span["job_id"] or "?"
        bucket = tenants.setdefault(
            tenant, {"busy_seconds": 0.0, "spans": 0, "jobs": set()})
        bucket["busy_seconds"] += span["busy_seconds"]
        bucket["spans"] += 1
        bucket["jobs"].add(span["job_id"])
        busy_by_job[span["job_id"]] = (
            busy_by_job.get(span["job_id"], 0.0) + span["busy_seconds"])

    # measured idle: per slot, wall minus the UNION of its spans (so a
    # double-booked slot inflates busy without shrinking idle -> the
    # identity breaks -> the tear is visible)
    idle_total = 0.0
    for slot in range(slots):
        intervals = sorted((s["start_ts"], s["end_ts"])
                           for s in clamped if s["slot"] == slot)
        occupied = 0.0
        cursor = t0
        for start, end in intervals:
            start = max(start, cursor)
            if end > start:
                occupied += end - start
                cursor = end
        idle_total += max(wall - occupied, 0.0)

    busy_total = sum(b["busy_seconds"] for b in tenants.values())
    capacity = wall * slots
    error_pct = (abs(busy_total + idle_total - capacity) / capacity * 100.0
                 if capacity > 0 else 0.0)

    timelines = job_timelines(events)
    job_rows = []
    for job_id, job in sorted(timelines.items()):
        if not job["dispatches"] and job_id not in busy_by_job:
            continue  # shed/rejected before ever running
        busy = round(busy_by_job.get(job_id, 0.0), 6)
        predicted = job["predicted_seconds"]
        job_rows.append({
            "job_id": job_id,
            "name": job["name"],
            "tenant": job["tenant"] or job["name"] or job_id,
            "priority": job["priority"],
            "fleet_id": job["fleet_id"],
            "busy_seconds": busy,
            "predicted_seconds": predicted,
            "prediction_error_factor": prediction_error_factor(
                predicted, busy),
            "preemptions": job["preemptions"],
            "wait_seconds": round(job["wait_seconds"], 6),
            "end_action": job["end_action"],
        })

    return {
        "wall_seconds": round(wall, 6),
        "slots": slots,
        "capacity_seconds": round(capacity, 6),
        "busy_seconds_total": round(busy_total, 6),
        "idle_seconds_total": round(idle_total, 6),
        "identity_error_pct": round(error_pct, 3),
        "books_close": error_pct <= 5.0,
        "tenants": {
            tenant: {
                "busy_seconds": round(b["busy_seconds"], 6),
                "share_of_busy": round(
                    b["busy_seconds"] / busy_total, 4) if busy_total else 0.0,
                "spans": b["spans"],
                "jobs": sorted(b["jobs"]),
            }
            for tenant, b in sorted(tenants.items())
        },
        "jobs": job_rows,
    }


# ---------------------------------------------------------------------------
# (c) the SLO report — the service-level gauges
# ---------------------------------------------------------------------------

def slo_report(events: list[dict[str, Any]]) -> dict[str, Any]:
    """Service-level objectives over one stream: p95 queue wait per
    priority class (over JOBS, each contributing its final cumulative
    wait), preemption rate, shed rate, and the starvation-bound margin
    (configured bound minus worst observed wait).  Always returns the
    full gauge shape — an empty stream reports zeros, not a hole."""
    timelines = job_timelines(events)
    started = next((e for e in events if e.get("kind") == "service"
                    and e.get("action") == "started"), {})
    dispatched = [j for j in timelines.values() if j["dispatches"]]
    waits_by_prio: dict[str, list[float]] = {}
    for job in dispatched:
        prio = job["priority"] or "normal"
        waits_by_prio.setdefault(prio, []).append(job["wait_seconds"])
    preempt_events = sum(len(j["preempts"]) for j in timelines.values())
    admits = sum(1 for e in events if e.get("kind") == "schedule"
                 and e.get("action") == "admit")
    sheds = sum(1 for e in events if e.get("kind") == "schedule"
                and e.get("action") == "shed")
    all_waits = [w for waits in waits_by_prio.values() for w in waits]
    bound = _num(started.get("starvation_bound_seconds"))
    return {
        "jobs": len(timelines),
        "jobs_dispatched": len(dispatched),
        "admits": admits,
        "queue_wait_p95_seconds": {
            prio: round(percentile(waits, 95.0), 6)
            for prio, waits in sorted(waits_by_prio.items())
        },
        "queue_wait_max_seconds": {
            prio: round(max(waits), 6)
            for prio, waits in sorted(waits_by_prio.items())
        },
        "preemptions": preempt_events,
        "preemption_rate": round(
            preempt_events / len(dispatched), 4) if dispatched else 0.0,
        "sheds": sheds,
        "shed_rate": round(
            sheds / (admits + sheds), 4) if (admits + sheds) else 0.0,
        "starvation_bound_seconds": bound,
        "starvation_bound_margin_seconds": (
            round(bound - max(all_waits), 6)
            if bound is not None and all_waits else bound),
    }


# ---------------------------------------------------------------------------
# (a) the fleet trace — the Perfetto view
# ---------------------------------------------------------------------------

_SLOT_PID = 1
_JOB_PID = 2


def _load_job_events(spool: str, job_id: str) -> list[dict[str, Any]]:
    path = os.path.join(spool, JOBS_DIRNAME, job_id, "events.jsonl")
    if not os.path.exists(path):
        return []
    return [e for e in load_events(path) if e.get("kind") != "_skipped"]


def fleet_trace(spool: str,
                events: list[dict[str, Any]] | None = None
                ) -> dict[str, Any]:
    """One Chrome/Perfetto trace for the whole session.

    Track layout: process 1 is the DEVICE (one thread per slot, spans =
    occupancy billed to ``tenant/job``), process 2 is the JOBS (one
    thread per job: queue-wait span, preemption-gap spans, run spans,
    and the chunk/round execution spans read from the job's own
    ``events.jsonl``).  ``ts``/``dur`` are microseconds relative to the
    session start, per the trace-event format."""
    if events is None:
        events = load_service_events(spool)
    t0, t1, _started = _session_window(events)
    timelines = job_timelines(events)
    spans = slot_spans(events, until_ts=t1)

    def us(ts: float) -> int:
        return int(round((ts - t0) * 1e6))

    trace: list[dict[str, Any]] = [{
        "ph": "M", "pid": _SLOT_PID, "name": "process_name",
        "args": {"name": "device slots"},
    }, {
        "ph": "M", "pid": _JOB_PID, "name": "process_name",
        "args": {"name": "jobs"},
    }]

    # --- device-slot tracks: who held which slot, billed to whom ---
    for slot in sorted({s["slot"] for s in spans}):
        trace.append({"ph": "M", "pid": _SLOT_PID, "tid": slot,
                      "name": "thread_name",
                      "args": {"name": f"slot {slot}"}})
    for span in spans:
        start = max(span["start_ts"], t0)
        end = max(span["end_ts"], start)
        label = span["tenant"] or span["job_id"]
        trace.append({
            "ph": "X", "pid": _SLOT_PID, "tid": span["slot"],
            "ts": us(start), "dur": max(us(end) - us(start), 1),
            "name": f"{label}", "cat": "slot",
            "args": {"job_id": span["job_id"],
                     "fleet_id": span["fleet_id"],
                     "priority": span["priority"],
                     "released": span["reason"]},
        })

    # --- job tracks: queue-wait, preemption gaps, runs, chunks ---
    for tid, (job_id, job) in enumerate(sorted(timelines.items())):
        label = job["name"] or job_id
        if job["priority"]:
            label += f" [{job['priority']}]"
        trace.append({"ph": "M", "pid": _JOB_PID, "tid": tid,
                      "name": "thread_name", "args": {"name": label}})
        common_args = {"job_id": job_id, "fleet_id": job["fleet_id"],
                       "tenant": job["tenant"],
                       "priority": job["priority"]}

        dispatches = sorted(job["dispatches"], key=lambda d: d["ts"] or 0.0)
        requeues = sorted(job["requeues"], key=lambda r: r["ts"] or 0.0)
        # queue-wait: submit (or admit) -> first dispatch; preemption
        # gap: each requeue -> the next dispatch after it
        wait_starts: list[tuple[float, str]] = []
        first = job["submitted_ts"] or job["admit_ts"]
        if first is not None:
            wait_starts.append((first, "queue-wait"))
        for requeue in requeues:
            if requeue["ts"] is not None:
                name = ("preempted" if requeue["reason"] == "preempt"
                        else f"requeued ({requeue['reason'] or 'drain'})")
                wait_starts.append((requeue["ts"], name))
        for start, name in wait_starts:
            nxt = next((d["ts"] for d in dispatches
                        if d["ts"] is not None and d["ts"] >= start), None)
            end = nxt if nxt is not None else (job["end_ts"] or t1)
            if end is None or end < start:
                continue
            trace.append({
                "ph": "X", "pid": _JOB_PID, "tid": tid,
                "ts": us(start), "dur": max(us(end) - us(start), 1),
                "name": name, "cat": "wait", "args": common_args,
            })
        # run spans: each dispatch -> the next requeue after it, else
        # the terminal event, else the session end
        boundaries = sorted(
            [r["ts"] for r in requeues if r["ts"] is not None]
            + ([job["end_ts"]] if job["end_ts"] is not None else []))
        for dispatch in dispatches:
            start = dispatch["ts"]
            if start is None:
                continue
            end = next((b for b in boundaries if b >= start), t1)
            trace.append({
                "ph": "X", "pid": _JOB_PID, "tid": tid,
                "ts": us(start), "dur": max(us(end) - us(start), 1),
                "name": ("run" if dispatch["action"] == "pack"
                         else "run (resumed)"),
                "cat": "run",
                "args": dict(common_args, slot=dispatch["slot"],
                             wait_seconds=dispatch["wait_seconds"]),
            })
        for preempt in job["preempts"]:
            if preempt["ts"] is not None:
                trace.append({
                    "ph": "i", "pid": _JOB_PID, "tid": tid,
                    "ts": us(preempt["ts"]), "s": "t",
                    "name": "preempt requested", "cat": "sched",
                    "args": dict(common_args, reason=preempt["reason"]),
                })
        # execution detail from the job's own stream: chunk spans (the
        # fused scan path — ts stamps the END, `seconds` the length) and
        # per-round spans for the unfused path
        for event in _load_job_events(spool, job_id):
            ts = _num(event.get("ts"))
            seconds = _num(event.get("seconds"))
            if ts is None or seconds is None or seconds <= 0:
                continue
            if event.get("kind") == "chunk":
                trace.append({
                    "ph": "X", "pid": _JOB_PID, "tid": tid,
                    "ts": us(ts - seconds), "dur": max(int(seconds * 1e6), 1),
                    "name": f"chunk[{event.get('chunk_len')}]",
                    "cat": "chunk",
                    "args": dict(common_args,
                                 includes_compile=bool(
                                     event.get("includes_compile"))),
                })
            elif event.get("kind") == "round":
                trace.append({
                    "ph": "X", "pid": _JOB_PID, "tid": tid,
                    "ts": us(ts - seconds), "dur": max(int(seconds * 1e6), 1),
                    "name": f"round {event.get('round')}",
                    "cat": "chunk",
                    "args": dict(common_args, ok=bool(event.get("ok"))),
                })

    # shed decisions have no job track — mark them on the device process
    for event in events:
        if event.get("kind") == "schedule" and event.get("action") == "shed":
            ts = _num(event.get("ts"))
            if ts is not None:
                trace.append({
                    "ph": "i", "pid": _SLOT_PID, "ts": us(ts), "s": "p",
                    "name": "shed", "cat": "sched",
                    "args": {"backlog_seconds": event.get("backlog_seconds"),
                             "retry_after_seconds":
                                 event.get("retry_after_seconds")},
                })

    return {"traceEvents": trace, "displayTimeUnit": "ms"}


# ---------------------------------------------------------------------------
# rendering + CLI
# ---------------------------------------------------------------------------

def format_report(slo: dict[str, Any], ledger: dict[str, Any]) -> str:
    lines = [
        f"fleet session: wall {ledger['wall_seconds']:.2f}s x "
        f"{ledger['slots']} slot(s) = {ledger['capacity_seconds']:.2f} "
        f"device-seconds",
        f"books: busy {ledger['busy_seconds_total']:.2f}s + idle "
        f"{ledger['idle_seconds_total']:.2f}s "
        f"(identity error {ledger['identity_error_pct']:.2f}% -> "
        f"{'CLOSED' if ledger['books_close'] else 'OPEN'})",
    ]
    if ledger["tenants"]:
        lines.append(f"{'tenant':<20}{'busy':>10}{'share':>8}{'jobs':>6}")
        for tenant, bucket in ledger["tenants"].items():
            lines.append(
                f"{tenant[:19]:<20}{bucket['busy_seconds']:>9.2f}s"
                f"{bucket['share_of_busy'] * 100:>7.1f}%"
                f"{len(bucket['jobs']):>6}")
    if ledger["jobs"]:
        lines.append(
            f"{'job':<14}{'prio':<8}{'busy':>9}{'pred':>9}{'err':>7}"
            f"{'wait':>9}{'pre':>4}  end")
        for job in ledger["jobs"]:
            err = job["prediction_error_factor"]
            pred = job["predicted_seconds"]
            lines.append(
                f"{job['job_id'][:13]:<14}{(job['priority'] or '?')[:7]:<8}"
                f"{job['busy_seconds']:>8.2f}s"
                f"{(f'{pred:.1f}s' if pred is not None else '-'):>9}"
                f"{(f'{err:.2f}x' if err is not None else '-'):>7}"
                f"{job['wait_seconds']:>8.2f}s{job['preemptions']:>4}"
                f"  {job['end_action'] or '?'}")
    lines.append(
        f"slo: {slo['jobs_dispatched']}/{slo['jobs']} jobs dispatched, "
        f"preemption rate {slo['preemption_rate']}, shed rate "
        f"{slo['shed_rate']}")
    for prio, p95 in slo["queue_wait_p95_seconds"].items():
        lines.append(
            f"slo: queue wait [{prio}] p95 {p95:.2f}s, max "
            f"{slo['queue_wait_max_seconds'][prio]:.2f}s")
    margin = slo.get("starvation_bound_margin_seconds")
    if margin is not None:
        lines.append(
            f"slo: starvation bound {slo['starvation_bound_seconds']:.1f}s, "
            f"margin {margin:.2f}s "
            f"({'ok' if margin >= 0 else 'VIOLATED'})")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m attackfl_tpu_torch fleet",
        description="Fleet observatory over a service spool: the "
                    "per-tenant device-time ledger + SLO report "
                    "(`report`) and the Perfetto-loadable cross-job "
                    "trace (`trace`), stitched from the schema-v12 "
                    "causal stream.")
    sub = parser.add_subparsers(dest="command", required=True)
    rep = sub.add_parser("report", help="SLO gauges + device-time ledger")
    rep.add_argument("spool", nargs="?", default=".",
                     help="service spool directory (default: .)")
    rep.add_argument("--json", action="store_true",
                     help="emit {slo, ledger} as JSON")
    tra = sub.add_parser("trace", help="write the fleet trace.json")
    tra.add_argument("spool", nargs="?", default=".",
                     help="service spool directory (default: .)")
    tra.add_argument("--out", default=None,
                     help="output path (default: <spool>/fleet.trace.json)")
    args = parser.parse_args(argv)

    try:
        events = load_service_events(args.spool)
    except FileNotFoundError:
        print(f"no {SERVICE_EVENTS_NAME} under {args.spool!r} — "
              "not a service spool?", file=sys.stderr)
        return 2
    try:
        if args.command == "report":
            slo = slo_report(events)
            ledger = device_time_ledger(args.spool, events=events)
            if args.json:
                print(json.dumps({"slo": slo, "ledger": ledger}, indent=1))
            else:
                print(format_report(slo, ledger))
            return 0
        out = args.out or os.path.join(args.spool, "fleet.trace.json")
        payload = fleet_trace(args.spool, events=events)
        with open(out, "w") as fh:
            json.dump(payload, fh)
        spans = sum(1 for e in payload["traceEvents"] if e.get("ph") == "X")
        print(f"wrote {out}: {len(payload['traceEvents'])} trace events "
              f"({spans} spans) — load it in Perfetto / chrome://tracing")
        return 0
    except ValueError as e:
        print(f"fleet: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    raise SystemExit(main())
