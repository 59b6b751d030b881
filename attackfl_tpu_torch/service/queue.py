"""Durable on-disk job queue: the run service's source of truth (the
port's copy of ``attackfl_tpu/service/queue.py``; the spool format is the
JAX package's, so either package reads the other's queue).

Layout (one spool directory per service):

* ``<spool>/queue/<job_id>.json`` — the IMMUTABLE submit record (sealed
  JSON: config dict + round target + submit sequence), written once with
  the checkpoint manifest's temp+fsync+rename discipline.  The submit
  call returns only after this file is durable, so an acknowledged job
  survives any crash.
* ``<spool>/queue/<job_id>.status.json`` — the MUTABLE state record
  (sealed JSON: queued/running/done/failed/cancelled + attempts +
  resume flag + result summary), atomically republished on every
  transition.

Torn-entry detection: both files carry a content-hash seal
(:func:`attackfl_tpu_torch.utils.atomicio.read_sealed_json`).  The rename
publish is atomic, but a fault-injected tear (``queue_torn``) or foreign
corruption must be *detected*, never deserialized into garbage or — the
real sin — silently dropped:

* a torn STATUS entry degrades to "state unknown" — replay requeues the
  job (its immutable spec is intact) and the worker resumes from the
  job's newest hash-valid checkpoint, so the run still completes
  bit-identical;
* a torn SPEC entry is unrecoverable by construction (the submit ack
  never fired for it) — it is quarantined with a ``.torn`` suffix and
  counted, loudly.

Crash recovery: :meth:`JobQueue.replay` classifies every entry at
service startup.  Jobs found ``running`` are stale by definition (only a
live daemon marks them, and it just started) — they are requeued with
``resume=True`` and re-enter dispatch ahead of never-started jobs.

The module imports no torch: the ``job`` client inspects spool
directories on boxes that only hold the artifacts.
"""

from __future__ import annotations

import os
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any

from attackfl_tpu_torch.utils.atomicio import read_sealed_json, write_sealed_json

QUEUE_DIRNAME = "queue"
JOB_STATES = ("queued", "running", "done", "failed", "cancelled")
# states that still occupy a queue slot (admission control counts these)
LIVE_STATES = ("queued", "running")


class QueueFullError(RuntimeError):
    """Admission control: the queue is at depth — an EXPLICIT rejection
    the submitter sees (HTTP 429 / CLI error), never a silent drop."""


@dataclass
class Job:
    """One job: the immutable spec + the latest known status."""

    job_id: str
    spec: dict[str, Any]
    status: dict[str, Any] = field(default_factory=dict)

    @property
    def state(self) -> str:
        return str(self.status.get("state", "queued"))

    def describe(self) -> dict[str, Any]:
        """JSON-ready summary for /jobs, /status and `job list`."""
        out = {
            "job_id": self.job_id,
            "state": self.state,
            "name": self.spec.get("name", ""),
            "seq": self.spec.get("seq"),
            "num_rounds": self.spec.get("num_rounds"),
            "submitted_ts": self.spec.get("submitted_ts"),
        }
        for key in ("attempts", "resume", "updated_ts", "error", "result",
                    "monitor_port", "priority", "preemptions",
                    "wait_seconds", "circuit_broken"):
            if key in self.status:
                out[key] = self.status[key]
        return out


class JobQueue:
    """The spool's queue directory: submit, claim, transition, replay.

    In-process access is lock-serialized (the dispatcher thread claims
    while the HTTP thread submits and workers transition).  ``injector``
    is the chaos seam: every status publish is numbered and offered to
    ``HostFaultInjector.on_status_publish`` (the ``queue_torn`` kind),
    every submission to ``flood_count`` (``submit_flood``).
    """

    def __init__(self, directory: str, depth: int = 16, telemetry=None,
                 injector=None):
        self.directory = directory
        os.makedirs(self.directory, exist_ok=True)
        self.depth = max(int(depth), 1)
        self._tel = telemetry
        self._injector = injector
        self._lock = threading.Lock()
        self._publish_seq = 0
        self._submit_seq = 0
        self.torn_entries: list[dict[str, str]] = []

    # ------------------------------------------------------------------
    # paths + file primitives
    # ------------------------------------------------------------------

    def _spec_path(self, job_id: str) -> str:
        return os.path.join(self.directory, f"{job_id}.json")

    def _status_path(self, job_id: str) -> str:
        return os.path.join(self.directory, f"{job_id}.status.json")

    def _emit_job(self, job_id: str, action: str, **fields: Any) -> None:
        if self._tel is not None:
            self._tel.events.emit("job", job_id=job_id, action=action,
                                  **fields)

    @property
    def version(self) -> int:
        """Monotone mutation counter — every durable publish (submit,
        mark, cancel, replay) bumps it.  The scheduler's tick uses it as
        cheap change detection so a saturated service does not pay a
        full sealed-entry rescan (read + sha256 per job) at every poll
        interval while nothing can possibly change."""
        return self._publish_seq

    def _publish_status(self, job_id: str, status: dict[str, Any]) -> None:
        """Atomically republish one job's status (sealed), then offer the
        publish to the ``queue_torn`` injector — tearing happens AFTER
        the honest entry landed, exactly like ``ckpt_torn``."""
        status = dict(status, updated_ts=round(time.time(), 6))
        path = self._status_path(job_id)
        write_sealed_json(path, status)
        self._publish_seq += 1
        if self._injector is not None:
            self._injector.on_status_publish(self._publish_seq, path)

    # ------------------------------------------------------------------
    # submit + admission control
    # ------------------------------------------------------------------

    def submit(self, spec: dict[str, Any], job_id: str | None = None) -> str:
        """Durably enqueue one job; returns its id once the spec file is
        on disk (the ack IS the durability boundary).  Raises
        :class:`QueueFullError` when queued+running jobs are at depth —
        bounded admission, explicit rejection."""
        with self._lock:
            self._submit_seq += 1
            flood = (self._injector.flood_count(self._submit_seq)
                     if self._injector is not None else 0)
            job_id = self._admit(spec, job_id)
        for i in range(flood):
            # injected duplicates take the same admission path; overflow
            # must surface as explicit rejections, not lost submissions
            try:
                with self._lock:
                    self._admit(dict(spec, name=f"{spec.get('name', 'job')}"
                                                f"-flood{i + 1}"), None)
            except QueueFullError:
                pass  # counted + evented inside _admit
        return job_id

    def _admit(self, spec: dict[str, Any], job_id: str | None) -> str:
        jobs = self._scan_unlocked()
        live = [j for j in jobs if j.state in LIVE_STATES]
        if len(live) >= self.depth:
            if self._tel is not None:
                self._tel.counters.inc("jobs_rejected")
            self._emit_job(spec.get("name") or "?", "rejected",
                           reason=f"queue full ({len(live)}/{self.depth})")
            raise QueueFullError(
                f"queue full: {len(live)}/{self.depth} live jobs — retry "
                "after one completes, or raise service.queue-depth")
        job_id = job_id or uuid.uuid4().hex[:12]
        if os.path.exists(self._spec_path(job_id)):
            raise ValueError(f"job id {job_id!r} already exists")
        seq = max([int(j.spec.get("seq", 0)) for j in jobs] or [0]) + 1
        spec = dict(spec, seq=seq, submitted_ts=round(time.time(), 6))
        write_sealed_json(self._spec_path(job_id), spec)
        self._publish_status(job_id, {"state": "queued", "attempts": 0,
                                      "resume": False})
        if self._tel is not None:
            self._tel.counters.inc("jobs_submitted")
        self._emit_job(job_id, "submitted", seq=seq,
                       name=spec.get("name", ""))
        return job_id

    # ------------------------------------------------------------------
    # scanning + reads
    # ------------------------------------------------------------------

    def _scan_unlocked(self) -> list[Job]:
        jobs: list[Job] = []
        try:
            names = os.listdir(self.directory)
        except OSError:
            return jobs
        for name in sorted(names):
            if not name.endswith(".json") or name.endswith(".status.json"):
                continue
            job_id = name[:-len(".json")]
            spec_path = self._spec_path(job_id)
            spec, reason = read_sealed_json(spec_path)
            if spec is None:
                # unrecoverable by construction: the submit ack never
                # fired for a torn spec — quarantine it, loudly
                self._quarantine(spec_path, reason or "torn")
                continue
            status, status_reason = read_sealed_json(
                self._status_path(job_id))
            if status is None:
                # torn/missing status = state unknown; replay() decides
                status = {"state": "queued", "attempts": 0, "resume": False,
                          "status_torn": status_reason or "missing"}
            jobs.append(Job(job_id=job_id, spec=spec, status=status))
        jobs.sort(key=lambda j: (int(j.spec.get("seq", 0)), j.job_id))
        return jobs

    def _quarantine(self, path: str, reason: str) -> None:
        try:
            os.replace(path, path + ".torn")
        except OSError:
            return
        self.torn_entries.append({"path": path, "reason": reason})
        if self._tel is not None:
            self._tel.counters.inc("queue_torn_entries")
            self._tel.events.emit("service", action="entry_quarantined",
                                  path=path, reason=reason[:200])

    def jobs(self) -> list[Job]:
        with self._lock:
            return self._scan_unlocked()

    def get(self, job_id: str) -> Job | None:
        with self._lock:
            for job in self._scan_unlocked():
                if job.job_id == job_id:
                    return job
        return None

    # ------------------------------------------------------------------
    # transitions
    # ------------------------------------------------------------------

    def claim(self, job_id: str | None = None) -> Job | None:
        """Queued job -> running (the dispatcher's pop): the oldest, or
        — the scheduler's targeted path — exactly ``job_id``.  Returns
        None when nothing matching is claimable (e.g. the named job was
        cancelled between the plan and the claim)."""
        with self._lock:
            for job in self._scan_unlocked():
                if job.state != "queued":
                    continue
                if job_id is not None and job.job_id != job_id:
                    continue
                job.status = dict(job.status, state="running")
                job.status.pop("status_torn", None)
                self._publish_status(job.job_id, job.status)
                return job
        return None

    def mark(self, job_id: str, state: str, **extra: Any) -> None:
        """Publish a terminal/updated state for one job."""
        if state not in JOB_STATES:
            raise ValueError(f"unknown job state {state!r}")
        with self._lock:
            job = next((j for j in self._scan_unlocked()
                        if j.job_id == job_id), None)
            if job is None:
                return
            status = dict(job.status, state=state, **extra)
            status.pop("status_torn", None)
            self._publish_status(job_id, status)

    def cancel(self, job_id: str) -> str:
        """Cancel a QUEUED job (running jobs are the daemon's to stop —
        it owns the worker threads).  Returns the outcome: ``cancelled``,
        the current state for non-queued jobs, or ``not_found``."""
        with self._lock:
            job = next((j for j in self._scan_unlocked()
                        if j.job_id == job_id), None)
            if job is None:
                return "not_found"
            if job.state != "queued":
                return job.state
            self._publish_status(job_id, dict(job.status, state="cancelled"))
        if self._tel is not None:
            self._tel.counters.inc("jobs_cancelled")
        self._emit_job(job_id, "cancelled")
        return "cancelled"

    # ------------------------------------------------------------------
    # crash recovery
    # ------------------------------------------------------------------

    def replay(self) -> dict[str, Any]:
        """Startup replay: classify every entry, requeue interrupted
        work.  Jobs found ``running`` are stale (only a live daemon marks
        them — and this one just started): requeued with ``resume=True``
        so the worker restores the job's newest hash-valid checkpoint.
        Torn status entries requeue the same way; torn spec entries were
        quarantined by the scan."""
        requeued: list[str] = []
        with self._lock:
            for job in self._scan_unlocked():
                torn = job.status.pop("status_torn", None)
                if torn is not None and job.state in LIVE_STATES:
                    self.torn_entries.append(
                        {"path": self._status_path(job.job_id),
                         "reason": torn})
                    if self._tel is not None:
                        self._tel.counters.inc("queue_torn_entries")
                if job.state == "running" or (torn is not None
                                              and job.state == "queued"):
                    job.status = dict(job.status, state="queued",
                                      resume=True)
                    self._publish_status(job.job_id, job.status)
                    requeued.append(job.job_id)
                    if self._tel is not None:
                        self._tel.counters.inc("jobs_requeued")
                    self._emit_job(job.job_id, "requeued",
                                   reason=("status_torn" if torn is not None
                                           else "interrupted"))
        return {"requeued": requeued,
                "torn": [dict(t) for t in self.torn_entries]}
