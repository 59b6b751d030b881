"""The run-service daemon: queue + workers + control plane, supervised
(the port's copy of ``attackfl_tpu/service/daemon.py``).

:class:`RunService` composes the durable queue, the checkpoint manager and
the run monitor into a service that survives its own failures:

* **durable queue** (:mod:`.queue`) — submissions are acknowledged only
  once spooled; torn entries are detected, never trusted or dropped;
* **worker supervision** (:mod:`.worker`) — each job runs in an isolated
  worker with its own telemetry dir and a record in the shared ledger; a
  crashed worker restarts with bounded exponential backoff and a retry
  budget, then the job is marked failed WITHOUT taking down the service;
* **admission control** — at most ``max_workers`` concurrent runs (they
  are threads of this process and share its one device) and at most
  ``queue_depth`` live jobs: submission beyond that is an explicit
  HTTP 429 / :class:`~.queue.QueueFullError`, never a silent drop;
* **preemptive scheduling** (:mod:`attackfl_tpu_torch.scheduler`) —
  dispatch order comes from cost-model bin-packing over priority classes
  with aging (a starvation bound, not a promise); higher classes preempt
  at the round/chunk-boundary safe seams and victims resume
  byte-identical; a configured shed horizon turns predicted overload
  into priced 429s (``retry_after_seconds``) and crash-looping jobs trip
  a per-job circuit breaker instead of eating the service.  ``/schedule``
  exposes the live decision state; every decision is a schema-v11
  ``schedule`` event;
* **crash recovery** — kill -9 the daemon, restart it: the queue replay
  requeues whatever was running and the workers resume from each job's
  newest hash-valid checkpoint (the ``CheckpointManager`` path), so
  every acknowledged job still completes with final params bit-identical
  to an uninterrupted run;
* **graceful drain** — SIGTERM (the CLI wires it): stop dispatching, let
  each in-flight ROUND finish (its checkpoint is already durable),
  requeue the unfinished jobs, publish a final ``service`` event, exit.

The device is resolved once, when the service is built
(:func:`~attackfl_tpu_torch.device.resolve_device`: the card unless
``device="cpu"``), and handed to every worker; no job runs anywhere else.

The control plane extends the monitor layer's
:class:`~attackfl_tpu_torch.telemetry.monitor.JsonHTTPServer` with
submit/status/cancel endpoints beside the monitor-style ones, and the
service-level ``/healthz`` aggregates every running job's
healthy/degraded/stalled state (one stalled run flips the service to
503 — same "no progress beats slow progress" precedence the run monitor
keeps).  ``/fleet`` answers the fleet observatory's SLO report and
per-tenant device-time ledger, stitched live from the spool
(:mod:`attackfl_tpu_torch.telemetry.fleet`), and ``/metrics`` carries its
SLO gauges beside the scheduler's.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from typing import Any

from attackfl_tpu_torch.device import resolve_device
from attackfl_tpu_torch.scheduler.core import JobScheduler, OverloadShedError
from attackfl_tpu_torch.service.queue import JobQueue, QueueFullError
from attackfl_tpu_torch.service.worker import JobWorker
from attackfl_tpu_torch.telemetry.core import Telemetry
from attackfl_tpu_torch.telemetry.counters import Counters
from attackfl_tpu_torch.telemetry.events import EventLog
from attackfl_tpu_torch.telemetry.fleet import (
    JOBS_DIRNAME, SERVICE_EVENTS_NAME, device_time_ledger, load_service_events, slo_report,
)
from attackfl_tpu_torch.telemetry.monitor import JsonHTTPServer, _sanitize
from attackfl_tpu_torch.telemetry.trace import NullTracer
from attackfl_tpu_torch.utils.atomicio import write_json_atomic

DISCOVERY_NAME = "service.json"
LEDGER_DIRNAME = "ledger"


class RunService:
    """One spool directory's daemon.  Drive it in-process (tests) or via
    ``python -m attackfl_tpu_torch serve`` (signals + serve_forever).
    ``device`` is resolved here, once: ``cuda`` (the default) raises
    without a card."""

    def __init__(self, spool: str, *, port: int = 0, host: str = "0.0.0.0",
                 max_workers: int = 1, queue_depth: int = 16,
                 worker_retries: int = 2, worker_backoff: float = 0.5,
                 worker_backoff_cap: float = 30.0, run_monitors: bool = True,
                 fault_plan=(), compile_cache_dir: str = "",
                 base_config: dict[str, Any] | None = None,
                 poll_interval: float = 0.05,
                 scheduler: bool = True, sched_aging_rate: float = 1.0,
                 sched_min_runtime: float = 2.0,
                 sched_shed_horizon: float = 0.0,
                 sched_breaker_attempts: int = 5,
                 sched_default_cost: float = 30.0, device="cuda"):
        self.device = resolve_device(device)
        self.spool = spool
        os.makedirs(spool, exist_ok=True)
        # default job config: submissions that send no `config` run this
        # (the serve CLI passes its --config yaml dict here)
        self.base_config = dict(base_config or {})
        self.max_workers = max(int(max_workers), 1)
        self.run_monitors = bool(run_monitors)
        self.worker_retries = worker_retries
        self.worker_backoff = worker_backoff
        self.worker_backoff_cap = worker_backoff_cap
        self.compile_cache_dir = compile_cache_dir
        self.poll_interval = poll_interval
        # the service's own telemetry: service.events.jsonl in the spool
        # (schema v6 `service`/`job` kinds ride the standard event log)
        self.telemetry = Telemetry(
            EventLog(os.path.join(spool, SERVICE_EVENTS_NAME)),
            NullTracer(), Counters(), True, base_dir=spool)
        self._injector = None
        if fault_plan:
            from attackfl_tpu_torch.faults.inject import HostFaultInjector

            self._injector = HostFaultInjector(fault_plan, self.telemetry)
        self.queue = JobQueue(
            os.path.join(spool, "queue"), depth=queue_depth,
            telemetry=self.telemetry, injector=self._injector)
        self.ledger_dir = os.path.join(spool, LEDGER_DIRNAME)
        self._http = JsonHTTPServer(host, port, name="attackfl-service-http")
        self._register_routes()
        self._lock = threading.Lock()
        self._workers: dict[str, JobWorker] = {}
        # preemptive multi-tenant scheduler: cost-model
        # bin-packing + chunk-boundary preemption + overload shedding.
        # Default ON — with all-default priorities and a cold ledger it
        # degenerates to the old oldest-first-up-to-max_workers loop.
        self.scheduler: JobScheduler | None = None
        if scheduler:
            self.scheduler = JobScheduler(
                self.queue, self.telemetry, self.ledger_dir,
                slots=self.max_workers, aging_rate=sched_aging_rate,
                min_runtime_seconds=sched_min_runtime,
                shed_horizon_seconds=sched_shed_horizon,
                breaker_attempts=sched_breaker_attempts,
                default_cost_seconds=sched_default_cost,
                injector=self._injector, spawn=self._spawn_worker,
                workers=self._workers_snapshot)
        self._draining = threading.Event()
        self._stopped = threading.Event()
        self._dispatcher: threading.Thread | None = None
        self.started_ts: float | None = None

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    @property
    def port(self) -> int | None:
        return self._http.port

    def start(self) -> "RunService":
        """Replay the queue (crash recovery), bind the control plane,
        start dispatching.  Idempotent."""
        if self._dispatcher is not None:
            return self
        self.started_ts = round(time.time(), 6)
        replay = self.queue.replay()
        self._http.start()
        started_fields: dict[str, Any] = {}
        if self.scheduler is not None:
            # the scheduler's constants, as the JAX package records them
            # for its fleet report's starvation bound
            started_fields = {
                "slots": self.scheduler.policy.slots,
                "aging_rate": self.scheduler.policy.aging_rate,
                "starvation_bound_seconds": round(
                    self.scheduler.policy.starvation_bound_seconds(), 6),
                "shed_horizon_seconds":
                    self.scheduler.policy.shed_horizon_seconds,
            }
        self.telemetry.events.emit(
            "service", action="started", port=self._http.port,
            spool=self.spool, max_workers=self.max_workers, device=str(self.device),
            queue_depth=self.queue.depth, **started_fields)
        if replay["requeued"] or replay["torn"]:
            self.telemetry.events.emit(
                "service", action="replayed",
                requeued=replay["requeued"],
                torn_entries=len(replay["torn"]))
        # service discovery: the ACTUAL port (0 binds ephemeral) — the
        # job client and the smoke script read it instead of guessing
        write_json_atomic(os.path.join(self.spool, DISCOVERY_NAME), {
            "url": f"http://127.0.0.1:{self._http.port}",
            "port": self._http.port, "pid": os.getpid(),
            "started_ts": self.started_ts})
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="attackfl-service-dispatch",
            daemon=True)
        self._dispatcher.start()
        return self

    def _dispatch_loop(self) -> None:
        while not self._stopped.is_set():
            if not self._draining.is_set():
                try:
                    self._dispatch_once()
                except Exception as e:  # noqa: BLE001 — dispatcher must not die
                    self.telemetry.events.emit(
                        "service", action="dispatch_error",
                        error=f"{type(e).__name__}: {e}"[:300])
            self._stopped.wait(self.poll_interval)

    def _dispatch_once(self) -> None:
        if self.scheduler is not None:
            self.scheduler.tick()
            return
        # legacy oldest-first dispatch (--no-scheduler)
        with self._lock:
            if len(self._workers) >= self.max_workers:
                return
        job = self.queue.claim()
        if job is None:
            return
        self._spawn_worker(job, None)

    def _workers_snapshot(self) -> dict[str, JobWorker]:
        with self._lock:
            return dict(self._workers)

    def _spawn_worker(self, job, sched_meta: dict[str, Any] | None) -> None:
        """One claimed job -> one supervised worker thread.  The
        scheduler's spawn callback (``sched_meta`` carries priority +
        preemption/wait accounting into the run header) and the legacy
        dispatcher both land here."""
        worker = JobWorker(
            job, os.path.join(self.spool, JOBS_DIRNAME, job.job_id),
            self.ledger_dir, self.queue, self.telemetry,
            retries=self.worker_retries, backoff=self.worker_backoff,
            backoff_cap=self.worker_backoff_cap,
            run_monitor=self.run_monitors,
            compile_cache_dir=self.compile_cache_dir,
            injector=self._injector, device=self.device, sched=sched_meta,
            on_done=self._worker_done)
        with self._lock:
            self._workers[job.job_id] = worker
        self.telemetry.events.emit(
            "job", job_id=job.job_id, action="started",
            attempts=int(job.status.get("attempts", 0)),
            resume=bool(job.status.get("resume")))
        worker.start()

    def _worker_done(self, worker: JobWorker) -> None:
        with self._lock:
            self._workers.pop(worker.job.job_id, None)

    def request_drain(self) -> None:
        """Graceful drain (the SIGTERM path): stop admitting work to
        workers, let every in-flight ROUND finish (its checkpoint is
        already durable), requeue unfinished jobs for the next daemon."""
        if self._draining.is_set():
            return
        self._draining.set()
        self.telemetry.events.emit("service", action="draining")
        with self._lock:
            workers = list(self._workers.values())
        for worker in workers:
            worker.request_drain()

    def drain(self, timeout: float | None = None) -> bool:
        """Request + wait for the drain.  Returns True when every worker
        handed its job back within ``timeout`` (None = wait forever)."""
        self.request_drain()
        deadline = None if timeout is None else time.monotonic() + timeout
        clean = True
        while True:
            with self._lock:
                workers = list(self._workers.values())
            if not workers:
                break
            remaining = None if deadline is None \
                else max(deadline - time.monotonic(), 0.0)
            workers[0].join(remaining)
            if workers[0].is_alive():  # timed out: the replay will recover
                clean = False
                break
        self.telemetry.events.emit("service", action="drained",
                                   clean=clean)
        return clean

    def close(self) -> None:
        """Stop dispatch + HTTP + flush telemetry (does NOT drain — call
        :meth:`drain` first for the graceful path)."""
        self._stopped.set()
        self._http.stop()
        self.telemetry.events.emit("service", action="stopped")
        self.telemetry.close()

    # ------------------------------------------------------------------
    # operations
    # ------------------------------------------------------------------

    def submit(self, spec: dict[str, Any]) -> str:
        """Durably enqueue one job spec (raises
        :class:`~.queue.QueueFullError` at depth — admission control is
        explicit).  Draining services refuse new work the same way."""
        if self._draining.is_set():
            raise QueueFullError("service is draining; resubmit after restart")
        if spec.get("type") == "matrix":
            # a matrix job: ONE sealed queue entry expands to one sweep
            # + a grid of ledger records — validate the grid NOW so a
            # malformed sweep is a 400 at submit, not a worker crash-loop
            from attackfl_tpu_torch.matrix.grid import grid_from_dict

            grid_from_dict(dict(spec.get("grid") or {}))
        if not spec.get("config"):
            spec = dict(spec, config=self.base_config)
        if not spec.get("fleet_id"):
            # fleet-trace id: stamped BEFORE the queue seals
            # the spec, so the causal id survives daemon restarts and
            # preemption requeues — every schedule/slot event and the
            # run header name this one id from submit to completion
            spec = dict(spec, fleet_id=uuid.uuid4().hex[:12])
        if self.scheduler is not None:
            # validates the priority class (400 on typos), prices the
            # job, and raises OverloadShedError (429 + retry-after) when
            # the predicted backlog is past the shed horizon
            self.scheduler.admit_check(spec)
        return self.queue.submit(spec)

    def cancel(self, job_id: str) -> str:
        """Cancel a job: queued jobs flip to ``cancelled`` in the spool,
        running jobs stop at the next round boundary."""
        with self._lock:
            worker = self._workers.get(job_id)
        if worker is not None:
            worker.request_cancel()
            return "stopping"
        return self.queue.cancel(job_id)

    # ------------------------------------------------------------------
    # control-plane payloads
    # ------------------------------------------------------------------

    def health(self) -> tuple[int, dict[str, Any]]:
        """Service-level aggregate: every running run's
        healthy/degraded/stalled state (from its own monitor watchdog)
        plus queue depth evidence.  One stalled run -> 503, mirroring
        the run monitor's "no progress beats slow progress" precedence;
        draining is reported but stays 200 (progress continues)."""
        with self._lock:
            workers = list(self._workers.values())
        runs = [w.health() for w in workers]
        states = [r.get("status", "ok") for r in runs]
        jobs = self.queue.jobs()
        by_state: dict[str, int] = {}
        for job in jobs:
            by_state[job.state] = by_state.get(job.state, 0) + 1
        stalled = any(r.get("stalled") for r in runs)
        status = "stalled" if stalled else (
            "draining" if self._draining.is_set() else (
                "degraded" if "degraded" in states else "ok"))
        payload = {
            "status": status,
            "draining": self._draining.is_set(),
            "active_runs": len(runs),
            "max_workers": self.max_workers,
            "queue_depth": self.queue.depth,
            "jobs": by_state,
            "runs": runs,
        }
        return (503 if stalled else 200), payload

    def metrics_text(self) -> str:
        """Prometheus exposition: job-state gauges, the scheduler's and the
        fleet's SLO gauges, the kernels' launch counts and the service
        counters."""
        jobs = self.queue.jobs()
        by_state: dict[str, int] = {}
        for job in jobs:
            by_state[job.state] = by_state.get(job.state, 0) + 1
        with self._lock:
            active = len(self._workers)
        lines = [
            "# TYPE attackfl_service_jobs gauge",
        ]
        for state, count in sorted(by_state.items()):
            lines.append(
                f'attackfl_service_jobs{{state="{_sanitize(state)}"}} '
                f'{count}')
        lines += [
            "# TYPE attackfl_service_active_runs gauge",
            f"attackfl_service_active_runs {active}",
            "# TYPE attackfl_service_draining gauge",
            f"attackfl_service_draining {int(self._draining.is_set())}",
        ]
        if self.scheduler is not None:
            snap = self.scheduler.snapshot()
            lines += [
                "# TYPE attackfl_sched_queue_depth gauge",
                f"attackfl_sched_queue_depth {snap['queue_depth']}",
                "# TYPE attackfl_sched_running_jobs gauge",
                f"attackfl_sched_running_jobs {snap['running_jobs']}",
                "# TYPE attackfl_sched_backlog_seconds gauge",
                f"attackfl_sched_backlog_seconds "
                f"{snap['backlog_seconds']}",
                "# TYPE attackfl_sched_max_wait_seconds gauge",
                f"attackfl_sched_max_wait_seconds "
                f"{snap['max_wait_seconds']}",
                "# TYPE attackfl_sched_preempted_total counter",
                f"attackfl_sched_preempted_total {snap['preempted_total']}",
                "# TYPE attackfl_sched_shed_total counter",
                f"attackfl_sched_shed_total {snap['shed_total']}",
                "# TYPE attackfl_sched_circuit_broken_total counter",
                f"attackfl_sched_circuit_broken_total "
                f"{snap['circuit_broken_total']}",
            ]
            if snap.get("waits_by_priority"):
                lines.append(
                    "# TYPE attackfl_sched_wait_seconds gauge")
                for prio in sorted(snap["waits_by_priority"]):
                    bucket = snap["waits_by_priority"][prio]
                    tag = _sanitize(prio)
                    for stat in ("p95", "max"):
                        lines.append(
                            f'attackfl_sched_wait_seconds'
                            f'{{priority="{tag}",stat="{stat}"}} '
                            f'{bucket[f"{stat}_seconds"]}')
            # service-level SLO gauges: stitched from this daemon's own
            # event stream, so the exported p95s cover the whole session,
            # not just the jobs currently queued
            try:
                slo = slo_report(load_service_events(self.spool))
            except Exception:  # noqa: BLE001 — observational endpoint
                slo = None
            if slo is not None:
                lines.append(
                    "# TYPE attackfl_slo_queue_wait_p95_seconds gauge")
                for prio in sorted(slo.get("queue_wait_p95_seconds", {})):
                    lines.append(
                        f'attackfl_slo_queue_wait_p95_seconds'
                        f'{{priority="{_sanitize(prio)}"}} '
                        f'{slo["queue_wait_p95_seconds"][prio]}')
                lines += [
                    "# TYPE attackfl_slo_preemption_rate gauge",
                    f"attackfl_slo_preemption_rate "
                    f"{slo['preemption_rate']}",
                    "# TYPE attackfl_slo_shed_rate gauge",
                    f"attackfl_slo_shed_rate {slo['shed_rate']}",
                ]
                if slo.get("starvation_bound_margin_seconds") is not None:
                    lines += [
                        "# TYPE attackfl_slo_starvation_bound_margin_"
                        "seconds gauge",
                        f"attackfl_slo_starvation_bound_margin_seconds "
                        f"{slo['starvation_bound_margin_seconds']}",
                    ]
        # the port's hand-written kernels launched in this process so far
        # (every job's: the workers are this process's threads)
        from attackfl_tpu_torch.ops import fused_step

        lines += [
            "# TYPE attackfl_kernel_launches_total counter",
            f'attackfl_kernel_launches_total{{kernel="fused_step"}} '
            f"{fused_step.run_epoch.launches}",
            f'attackfl_kernel_launches_total{{kernel="dropout_mask"}} '
            f"{fused_step.fill_masks.launches}",
        ]
        counters = self.telemetry.counters.snapshot()
        if counters:
            lines.append("# TYPE attackfl_counter counter")
            for name, value in counters.items():
                lines.append(
                    f'attackfl_counter{{name="{_sanitize(name)}"}} {value}')
        return "\n".join(lines) + "\n"

    # ------------------------------------------------------------------
    # http routes
    # ------------------------------------------------------------------

    def _register_routes(self) -> None:
        http = self._http
        http.route("GET", "/healthz", lambda q, b: self.health())
        http.route("GET", "/metrics", lambda q, b: (
            200, self.metrics_text().encode(), "text/plain; version=0.0.4"))
        http.route("GET", "/jobs", self._route_jobs)
        http.route("GET", "/status", self._route_status)
        http.route("POST", "/submit", self._route_submit)
        http.route("POST", "/cancel", self._route_cancel)
        http.route("GET", "/runs", self._route_runs)
        http.route("GET", "/schedule", self._route_schedule)
        http.route("GET", "/fleet", self._route_fleet)
        http.route("GET", "/science", self._route_science)

    def _route_jobs(self, query, body):
        return 200, {"jobs": [j.describe() for j in self.queue.jobs()]}

    def _route_schedule(self, query, body):
        """The scheduler's live decision state: per-job effective
        priorities, predicted remaining seconds, preemption/wait
        accounting, backlog vs shed horizon, the starvation bound."""
        if self.scheduler is None:
            return 404, {"error": "scheduler disabled (--no-scheduler)"}
        return 200, self.scheduler.snapshot()

    def _route_fleet(self, query, body):
        """The fleet observatory: the SLO report and the per-tenant
        device-time ledger, stitched live from this daemon's own spool.
        Books only fully close once the session ends (the wall clock keeps
        running), so ``books_close`` here is advisory.  Fail-open: an
        error is a 200 with the error in it."""
        try:
            events = load_service_events(self.spool)
            return 200, {"slo": slo_report(events),
                         "ledger": device_time_ledger(self.spool, events=events)}
        except Exception as e:  # noqa: BLE001 — observational endpoint
            return 200, {"error": f"{type(e).__name__}: {e}"[:300]}

    def _route_science(self, query, body):
        """The scenario science observatory: the defense
        leaderboard of the newest matrix sweep in the shared ledger
        (``?sweep=<id>`` pins one; prefixes resolve when unambiguous).
        Fail-open: an error is a 200 with the error in it."""
        try:
            from attackfl_tpu_torch.ledger.store import LedgerStore
            from attackfl_tpu_torch.science.outcomes import outcome_rows, sweep_ids
            from attackfl_tpu_torch.science.rank import leaderboard

            store = LedgerStore(self.ledger_dir)
            records, _ = store.load()
            ids = sweep_ids(records)
            if not ids:
                return 200, {"ledger": self.ledger_dir, "sweeps": [],
                             "error": "no matrix-sweep records"}
            wanted = query.get("sweep", "")
            sweep = ids[-1]
            if wanted:
                matches = [s for s in ids
                           if s == wanted or s.startswith(wanted)]
                if len(matches) != 1:
                    return 404, {"error": f"no unique sweep {wanted!r}",
                                 "sweeps": ids}
                sweep = matches[0]
            board = leaderboard(outcome_rows(records, sweep_id=sweep),
                                sweep_id=sweep, n_boot=200)
            return 200, {"ledger": self.ledger_dir, "sweeps": ids,
                         **board}
        except Exception as e:  # noqa: BLE001 — observational endpoint
            return 200, {"ledger": self.ledger_dir,
                         "error": f"{type(e).__name__}: {e}"[:300]}

    def _route_status(self, query, body):
        job_id = query.get("job", "")
        job = self.queue.get(job_id)
        if job is None:
            return 404, {"error": f"no such job {job_id!r}"}
        payload = job.describe()
        with self._lock:
            worker = self._workers.get(job_id)
        if worker is not None:
            payload["run"] = worker.health()
        return 200, payload

    def _route_submit(self, query, body):
        try:
            spec = json.loads(body.decode() or "{}")
        except ValueError as e:
            return 400, {"error": f"submit body is not JSON: {e}"}
        if not isinstance(spec, dict):
            return 400, {"error": "submit body must be a JSON object"}
        try:
            job_id = self.submit(spec)
        except OverloadShedError as e:
            # shed: the 429 names WHEN to come back, not just no
            return 429, {"error": str(e),
                         "retry_after_seconds": round(
                             e.retry_after_seconds, 3)}
        except QueueFullError as e:
            return 429, {"error": str(e)}
        except ValueError as e:
            return 400, {"error": str(e)}
        return 200, {"job_id": job_id}

    def _route_cancel(self, query, body):
        job_id = query.get("job", "")
        outcome = self.cancel(job_id)
        if outcome == "not_found":
            return 404, {"error": f"no such job {job_id!r}"}
        ok = outcome in ("cancelled", "stopping")
        return (200 if ok else 409), {"job_id": job_id, "outcome": outcome}

    def _route_runs(self, query, body):
        """The shared cross-run ledger's index, newest first (the run
        monitor's /runs shape, service-wide)."""
        try:
            from attackfl_tpu_torch.ledger.store import LedgerStore

            store = LedgerStore(self.ledger_dir)
            entries = store.index()
        except Exception as e:  # noqa: BLE001 — observational endpoint
            return 200, {"ledger": self.ledger_dir,
                         "error": f"{type(e).__name__}: {e}"[:300],
                         "records": []}
        return 200, {"ledger": self.ledger_dir, "count": len(entries),
                     "records": list(reversed(entries[-50:]))}
