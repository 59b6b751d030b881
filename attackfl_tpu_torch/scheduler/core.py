"""The daemon-facing scheduler: tickets <-> durable queue <-> workers (the
port's copy of ``attackfl_tpu/scheduler/core.py``).

:class:`JobScheduler` replaces the service's oldest-first claim loop.
Each dispatch tick it

1. syncs its in-memory tickets with the durable queue (the queue stays
   the source of truth — tickets are derived state and rebuild from the
   spool after any restart, preemption counts included, because the
   workers persist them into the status records);
2. trips the per-job **circuit breaker**: a queued job whose persisted
   ``attempts`` already reached the threshold is quarantined ``failed``
   without killing the service (a crash-looping job would otherwise eat
   its full retry budget again after every daemon restart: the
   fail-open rule, applied to dispatch);
3. asks the pure :class:`~.policy.SchedulerPolicy` for a plan and acts
   on it: preempt victims via the worker's ``request_preempt`` (the
   round/chunk-boundary stop hook — the job checkpoints, requeues and
   later resumes byte-identical), start picks via the daemon's spawn
   callback with the scheduler's provenance (priority / preemptions /
   accumulated wait) riding the run header into the ledger.

Every decision emits a schema-v11 ``schedule`` event; the ``/schedule``
endpoint and the Prometheus gauges read :meth:`JobScheduler.snapshot`.

The ``preempt_storm`` fault kind forces preemptions of healthy running
jobs here (the chaos gate kills the daemon mid-storm and asserts
byte-identical completion after restart); ``estimate_skew`` lives in
:mod:`.pricing`.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable

from attackfl_tpu_torch.scheduler.policy import (
    DEFAULT_PRIORITY, SchedulerPolicy, Ticket, priority_base,
)
from attackfl_tpu_torch.scheduler.pricing import JobPricer
from attackfl_tpu_torch.service.queue import QueueFullError


class OverloadShedError(QueueFullError):
    """Load shed: predicted backlog past the horizon.  Carries the
    priced ``retry_after_seconds`` hint the HTTP 429 payload forwards —
    an overloaded service tells the submitter WHEN to come back, not
    just no."""

    def __init__(self, message: str, retry_after_seconds: float):
        super().__init__(message)
        self.retry_after_seconds = retry_after_seconds


def spec_priority(spec: dict[str, Any]) -> str:
    """The spec's validated priority class (submit-time 400 on typos)."""
    name = str(spec.get("priority") or DEFAULT_PRIORITY)
    priority_base(name)  # raises ValueError on unknown classes
    return name


def spec_tenant(spec: dict[str, Any], job_id: str) -> str:
    """The tenant a job's device time bills to: an explicit
    ``tenant`` spec field, else the submitter's job ``name``, else the
    job id itself — never empty, so the fleet books always have a row."""
    return str(spec.get("tenant") or spec.get("name") or job_id)


def spec_fleet_id(spec: dict[str, Any], job_id: str) -> str:
    """The job's causal fleet-trace id: stamped into the sealed spec at
    submit (so it survives daemon restarts and preemption requeues);
    legacy entries predating the field fall back to the job id, which is
    just as durable a join key."""
    return str(spec.get("fleet_id") or job_id)


class JobScheduler:
    """One service's scheduler.  Thread-safety mirrors the daemon: the
    dispatcher thread ticks; the HTTP thread calls ``admit_check`` and
    ``snapshot``; the shared state is lock-guarded."""

    def __init__(self, queue, telemetry, ledger_dir: str, *,
                 slots: int = 1, aging_rate: float = 1.0,
                 min_runtime_seconds: float = 2.0,
                 shed_horizon_seconds: float = 0.0,
                 breaker_attempts: int = 5,
                 default_cost_seconds: float = 30.0,
                 injector=None,
                 spawn: Callable[[Any, dict[str, Any]], None] | None = None,
                 workers: Callable[[], dict[str, Any]] | None = None,
                 clock: Callable[[], float] = time.monotonic,
                 rescan_seconds: float = 0.25):
        self.queue = queue
        self.telemetry = telemetry
        self.policy = SchedulerPolicy(
            slots=slots, aging_rate=aging_rate,
            min_runtime_seconds=min_runtime_seconds,
            shed_horizon_seconds=shed_horizon_seconds)
        self.pricer = JobPricer(ledger_dir,
                                default_seconds=default_cost_seconds,
                                injector=injector)
        self.breaker_attempts = max(int(breaker_attempts), 1)
        self._injector = injector
        self._spawn = spawn
        self._workers = workers or (lambda: {})
        self._clock = clock
        self._lock = threading.Lock()
        self._tickets: dict[str, Ticket] = {}
        # slot occupancy: job_id -> (slot index, acquire
        # monotonic ts).  Rebuilt implicitly after a restart — replayed
        # jobs re-acquire on their resume pack, and the fleet stitcher
        # clamps any unreleased span at the session boundary.
        self._slot_book: dict[str, tuple[int, float]] = {}
        self._tick_seq = 0
        self.last_backlog_seconds = 0.0
        # change detection: a saturated slot must not cost a sealed-entry
        # queue rescan per poll interval (the legacy loop idles there) —
        # rescan only when the queue's durable version or the worker set
        # moved, or every ``rescan_seconds`` as the aging/anti-thrash
        # fallback (bounds preemption latency when nothing else mutates)
        self.rescan_seconds = float(rescan_seconds)
        self._seen_version: int | None = None
        self._seen_workers: int | None = None
        self._last_scan_mono: float | None = None

    # ---- events -----------------------------------------------------

    def _emit(self, action: str, **fields: Any) -> None:
        self.telemetry.events.emit("schedule", action=action, **fields)

    # ---- slot occupancy ----------------------------------

    def _acquire_slot(self, ticket: Ticket) -> int:
        """Lowest free device-slot index for a starting job; emits the
        schema-v12 ``slot`` acquire record the fleet books are built
        from."""
        used = {slot for slot, _ in self._slot_book.values()}
        slot = next(i for i in range(len(used) + 1) if i not in used)
        self._slot_book[ticket.job_id] = (slot, self._clock())
        self.telemetry.events.emit(
            "slot", slot=slot, action="acquire", job_id=ticket.job_id,
            priority=ticket.priority, tenant=ticket.tenant,
            fleet_id=ticket.fleet_id)
        return slot

    def _release_slot(self, job_id: str, reason: str,
                      ticket: Ticket | None = None) -> None:
        """Release ``job_id``'s slot (job left the running set for any
        reason) with the measured busy time.  Idempotent — jobs that
        never held a slot (legacy dispatch, replay windows) are a
        no-op."""
        entry = self._slot_book.pop(job_id, None)
        if entry is None:
            return
        slot, acquired = entry
        fields: dict[str, Any] = {
            "slot": slot, "action": "release", "job_id": job_id,
            "reason": reason,
            "busy_seconds": round(max(self._clock() - acquired, 0.0), 6),
        }
        if ticket is not None:
            fields.update(priority=ticket.priority, tenant=ticket.tenant,
                          fleet_id=ticket.fleet_id)
        self.telemetry.events.emit("slot", **fields)

    # ---- admission (HTTP thread) ------------------------------------

    def admit_check(self, spec: dict[str, Any]) -> dict[str, Any]:
        """Validate priority + shed decision BEFORE the queue admits.
        Returns the price (the daemon's admit event reuses it); raises
        ValueError on a bad priority, :class:`OverloadShedError` when
        the backlog horizon says no."""
        priority = spec_priority(spec)
        price = self.pricer.price(spec)
        with self._lock:
            live = [t for t in self._tickets.values()]
        decision = self.policy.shed_decision(live, price["predicted_seconds"])
        if decision is not None:
            self.telemetry.counters.inc("jobs_shed")
            self._emit("shed", priority=priority,
                       predicted_seconds=price["predicted_seconds"],
                       backlog_seconds=decision["backlog_seconds"],
                       retry_after_seconds=decision["retry_after_seconds"])
            raise OverloadShedError(
                f"overloaded: predicted backlog "
                f"{decision['backlog_seconds']:.1f}s exceeds the "
                f"{decision['horizon_seconds']:.1f}s horizon — retry in "
                f"~{decision['retry_after_seconds']:.1f}s",
                decision["retry_after_seconds"])
        return {"priority": priority, **price}

    # ---- ticket sync ------------------------------------------------

    def _sync_tickets(self, jobs) -> tuple[list[Ticket], list[Ticket]]:
        """Durable queue -> tickets.  Returns (queued, running) tickets;
        terminal jobs drop out, crash-looping queued jobs trip the
        breaker."""
        now = self._clock()
        seen: set[str] = set()
        queued: list[Ticket] = []
        running: list[Ticket] = []
        workers = self._workers()
        for job in jobs:
            state = job.state
            if state not in ("queued", "running"):
                self._release_slot(job.job_id, reason=state,
                                   ticket=self._tickets.get(job.job_id))
                self._tickets.pop(job.job_id, None)
                continue
            seen.add(job.job_id)
            ticket = self._tickets.get(job.job_id)
            if ticket is None:
                ticket = self._admit_ticket(job, now)
            status = job.status
            if state == "queued":
                if int(status.get("attempts", 0)) >= self.breaker_attempts:
                    self._break_job(job, ticket)
                    seen.discard(job.job_id)
                    continue
                if ticket.started_ts is not None:
                    # came back from a preempt/drain requeue: refresh the
                    # persisted progress + preemption count and re-enter
                    # the wait clock (the slot came free with it)
                    self._release_slot(job.job_id, reason="preempt",
                                       ticket=ticket)
                    ticket.started_ts = None
                    ticket.preempt_requested = False
                    ticket.enqueued_ts = now
                    ticket.preemptions = int(status.get("preemptions", 0)
                                             or ticket.preemptions)
                self._refresh_progress(ticket, status)
                queued.append(ticket)
            else:  # running
                if job.job_id not in workers:
                    # replay window: marked running but no live worker
                    # yet (or the worker just exited) — not packable,
                    # not preemptable this tick
                    continue
                if ticket.started_ts is None:
                    ticket.started_ts = now
                running.append(ticket)
        for job_id in list(self._tickets):
            if job_id not in seen:
                self._release_slot(job_id, reason="gone",
                                   ticket=self._tickets.get(job_id))
                self._tickets.pop(job_id, None)
        return queued, running

    def _admit_ticket(self, job, now: float) -> Ticket:
        status = job.status
        price = self.pricer.price(job.spec)
        ticket = Ticket(
            job_id=job.job_id,
            priority=spec_priority(job.spec),
            predicted_seconds=float(price["predicted_seconds"]),
            pricing=price,
            enqueued_ts=now,
            preemptions=int(status.get("preemptions", 0)),
            wait_seconds=float(status.get("wait_seconds", 0.0) or 0.0),
            seq=int(job.spec.get("seq", 0)),
            fleet_id=spec_fleet_id(job.spec, job.job_id),
            tenant=spec_tenant(job.spec, job.job_id),
        )
        self._refresh_progress(ticket, status)
        self._tickets[job.job_id] = ticket
        self._emit("admit", job_id=job.job_id, priority=ticket.priority,
                   predicted_seconds=ticket.predicted_seconds,
                   fleet_id=ticket.fleet_id, tenant=ticket.tenant,
                   reason=str(price.get("method", "")))
        return ticket

    @staticmethod
    def _refresh_progress(ticket: Ticket, status: dict[str, Any]) -> None:
        completed = status.get("completed")
        target = status.get("target")
        if isinstance(completed, int) and isinstance(target, int) \
                and not isinstance(completed, bool) and target > 0:
            ticket.completed_fraction = min(max(completed / target, 0.0), 1.0)

    def _break_job(self, job, ticket: Ticket) -> None:
        attempts = int(job.status.get("attempts", 0))
        error = str(job.status.get("error") or "")
        self.queue.mark(
            job.job_id, "failed", attempts=attempts, circuit_broken=True,
            error=(f"circuit breaker open after {attempts} crash(es)"
                   + (f"; last: {error}" if error else "")))
        self._tickets.pop(job.job_id, None)
        self.telemetry.counters.inc("jobs_circuit_broken")
        self._emit("break", job_id=job.job_id, priority=ticket.priority,
                   reason=f"{attempts} attempts >= breaker threshold "
                          f"{self.breaker_attempts}")

    # ---- the tick (dispatcher thread) -------------------------------

    def tick(self) -> None:
        with self._lock:
            self._tick_seq += 1
            storm = 0
            if self._injector is not None:
                storm = self._injector.preempt_storm_count(self._tick_seq)
            workers = self._workers()
            version = getattr(self.queue, "version", None)
            mono = time.monotonic()
            if (not storm and version is not None
                    and version == self._seen_version
                    and len(workers) == self._seen_workers
                    and self._last_scan_mono is not None
                    and mono - self._last_scan_mono < self.rescan_seconds):
                return
            self._seen_version = version
            self._seen_workers = len(workers)
            self._last_scan_mono = mono
            queued, running = self._sync_tickets(self.queue.jobs())
            now = self._clock()
            plan = self.policy.plan(queued, running, now)
            self.last_backlog_seconds = plan.backlog_seconds
            victims = list(plan.preempt)
            if storm:
                forced = [t for t in running
                          if not t.preempt_requested][:storm]
                for ticket in forced:
                    ticket.preempt_requested = True
                victims += forced
            for ticket in victims:
                self._preempt(ticket, workers,
                              reason=("preempt_storm"
                                      if ticket not in plan.preempt
                                      else "priority"))
            for ticket in plan.start:
                self._start(ticket, now)

    def _preempt(self, ticket: Ticket, workers: dict[str, Any],
                 reason: str) -> None:
        worker = workers.get(ticket.job_id)
        if worker is None:
            ticket.preempt_requested = False
            return
        worker.request_preempt()
        self.telemetry.counters.inc("jobs_preempted")
        self._emit("preempt", job_id=ticket.job_id,
                   priority=ticket.priority, reason=reason,
                   preemptions=ticket.preemptions + 1,
                   fleet_id=ticket.fleet_id, tenant=ticket.tenant,
                   predicted_seconds=round(ticket.remaining_seconds(), 6))

    def _start(self, ticket: Ticket, now: float) -> None:
        job = self.queue.claim(ticket.job_id)
        if job is None:  # cancelled/raced away — drop, next tick resyncs
            self._tickets.pop(ticket.job_id, None)
            return
        ticket.wait_seconds = round(
            ticket.wait_seconds + max(now - ticket.enqueued_ts, 0.0), 6)
        ticket.started_ts = now
        slot = self._acquire_slot(ticket)
        sched_meta = {
            "priority": ticket.priority,
            "preemptions": ticket.preemptions,
            "wait_seconds": ticket.wait_seconds,
            "fleet_id": ticket.fleet_id,
            "tenant": ticket.tenant,
            "slot": slot,
        }
        # persist the accounting next to the job so it survives daemon
        # restarts and `job status` shows it without the event log
        self.queue.mark(job.job_id, "running", **sched_meta)
        job.status = dict(job.status, state="running", **sched_meta)
        self._emit("resume" if ticket.preemptions > 0 else "pack",
                   job_id=ticket.job_id, priority=ticket.priority,
                   predicted_seconds=round(ticket.remaining_seconds(), 6),
                   wait_seconds=ticket.wait_seconds,
                   preemptions=ticket.preemptions,
                   backlog_seconds=self.last_backlog_seconds,
                   fleet_id=ticket.fleet_id, tenant=ticket.tenant,
                   slot=slot,
                   reason=str(ticket.pricing.get("method", "")))
        if self._spawn is not None:
            self._spawn(job, sched_meta)

    # ---- observability (/schedule + gauges) -------------------------

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            now = self._clock()
            tickets = list(self._tickets.values())
            rows = []
            for ticket in sorted(
                    tickets, key=lambda t: (t.started_ts is None, t.seq)):
                waiting = ticket.started_ts is None
                slot_entry = self._slot_book.get(ticket.job_id)
                rows.append({
                    "job_id": ticket.job_id,
                    "state": "queued" if waiting else "running",
                    "priority": ticket.priority,
                    "fleet_id": ticket.fleet_id,
                    "tenant": ticket.tenant,
                    "slot": slot_entry[0] if slot_entry else None,
                    "effective_priority": round(
                        self.policy.effective_priority(ticket, now), 3)
                    if waiting else ticket.base,
                    "predicted_remaining_seconds": round(
                        ticket.remaining_seconds(), 3),
                    "pricing_method": ticket.pricing.get("method"),
                    "preemptions": ticket.preemptions,
                    "wait_seconds": round(
                        ticket.wait_seconds
                        + (max(now - ticket.enqueued_ts, 0.0)
                           if waiting else 0.0), 3),
                    "preempt_requested": ticket.preempt_requested,
                })
            waits = [r["wait_seconds"] for r in rows
                     if r["state"] == "queued"]
            # per-priority queue-wait evidence: count + p95 + max over the
            # QUEUED rows of each class, so /metrics can export them
            # without replaying events
            from attackfl_tpu_torch.telemetry.summary import percentile

            waits_by_priority: dict[str, dict[str, Any]] = {}
            for row in rows:
                if row["state"] != "queued":
                    continue
                bucket = waits_by_priority.setdefault(
                    row["priority"], {"waits": []})
                bucket["waits"].append(row["wait_seconds"])
            waits_by_priority = {
                prio: {
                    "count": len(b["waits"]),
                    "p95_seconds": round(percentile(b["waits"], 95.0), 3),
                    "max_seconds": round(max(b["waits"]), 3),
                }
                for prio, b in waits_by_priority.items()
            }
            counters = self.telemetry.counters.snapshot()
            return {
                "slots": self.policy.slots,
                "aging_rate": self.policy.aging_rate,
                "starvation_bound_seconds": round(
                    self.policy.starvation_bound_seconds(), 3),
                "shed_horizon_seconds": self.policy.shed_horizon_seconds,
                "breaker_attempts": self.breaker_attempts,
                "backlog_seconds": self.last_backlog_seconds,
                "queue_depth": len(waits),
                "running_jobs": sum(
                    1 for r in rows if r["state"] == "running"),
                "max_wait_seconds": round(max(waits), 3) if waits else 0.0,
                "waits_by_priority": waits_by_priority,
                "preempted_total": int(counters.get("jobs_preempted", 0)),
                "shed_total": int(counters.get("jobs_shed", 0)),
                "circuit_broken_total": int(
                    counters.get("jobs_circuit_broken", 0)),
                "jobs": rows,
            }
