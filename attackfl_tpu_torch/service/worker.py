"""Supervised job execution: one isolated worker per running job (the
port's copy of ``attackfl_tpu/service/worker.py``).

Isolation is directory-shaped: every job gets its own working directory
under ``<spool>/jobs/<job_id>/`` holding its telemetry (explicit
``events.jsonl``/``trace.json`` paths, so the global
``ATTACKFL_TELEMETRY_DIR`` harness override cannot collide N jobs into
one file), its checkpoint manifest (the resume source after any crash)
and its console log — while the cross-run LEDGER is shared service-wide
(one record per run, flock-serialized by the store) and the kernels'
libraries are shared process-wide (built once under
``attackfl_tpu_torch/_build`` and loaded once per process).

Every job runs on the device the daemon resolved once (the card unless
the daemon was started with ``--device cpu``); the workers are threads of
one process, so ``max_workers`` jobs share one GPU.  A CUDA error in a
job is a crash like any other: the supervisor counts it and restarts
the job from its checkpoint on the same device, never elsewhere.

Supervision contract (:class:`JobWorker`):

* a worker that CRASHES (any exception out of ``Simulator.run``,
  including the injected :class:`~attackfl_tpu_torch.faults.inject.
  WorkerDeathError`) is restarted with bounded exponential backoff up to
  the retry budget, each restart resuming from the job's newest
  hash-valid checkpoint; past the budget the job is marked ``failed`` —
  the service never dies with it;
* a worker asked to DRAIN (SIGTERM path) finishes the in-flight round —
  the stop hook fires only at round boundaries, where the checkpoint for
  the last completed round is already durable — and the job is requeued
  with ``resume=True`` for the next daemon;
* a worker asked to CANCEL stops at the same boundary and marks the job
  ``cancelled``;
* stalls are caught by REUSING the run monitor's watchdog: each job's
  Simulator gets its own :class:`~attackfl_tpu_torch.telemetry.monitor.
  RunMonitor` on an ephemeral port, and the service-level ``/healthz``
  aggregates every run's healthy/degraded/stalled state.
"""

from __future__ import annotations

import dataclasses
import os
import random
import threading
import time
from typing import Any, Callable

from attackfl_tpu_torch.config import Config, config_from_dict


def build_job_config(spec: dict[str, Any], job_dir: str, ledger_dir: str,
                     *, resume: bool, run_monitor: bool,
                     compile_cache_dir: str = "") -> Config:
    """The job spec's config dict -> an isolated per-job :class:`Config`.

    The spec's own ``log_path``/``checkpoint_dir``/telemetry paths are
    overridden — isolation is the service's invariant, not the
    submitter's choice — and ``resume`` reflects the supervision state
    (restart after a crash / requeue after a drain), not the spec.

    ``compile_cache_dir`` is kept for the JAX package's schema and flag;
    the port compiles no programs (its kernels' libraries are cached under
    ``attackfl_tpu_torch/_build``), so nothing reads it."""
    cfg = config_from_dict(dict(spec.get("config") or {}))
    telemetry = dataclasses.replace(
        cfg.telemetry,
        # explicit per-job paths: stronger than the ATTACKFL_TELEMETRY_DIR
        # env default, so N concurrent jobs never share an events file
        events_path=os.path.join(job_dir, "events.jsonl"),
        trace_path=os.path.join(job_dir, "trace.json"),
        # one SHARED ledger for the whole service: every run lands one
        # record (the store's advisory file lock makes N writers safe)
        ledger_dir=ledger_dir,
        # per-run monitor on an ephemeral port: the stall watchdog plus
        # /metrics per run; the service aggregates health states
        monitor=run_monitor,
        monitor_port=0,
    )
    return cfg.replace(
        log_path=job_dir,
        checkpoint_dir=job_dir,
        telemetry=telemetry,
        resume=resume,
        compile_cache_dir=(compile_cache_dir or cfg.compile_cache_dir),
    )


_BACKOFF_RNG = random.Random()


def backoff_delay(attempt: int, base: float, cap: float,
                  prev: float | None = None,
                  rng: random.Random | None = None) -> float:
    """Decorrelated-jitter backoff: ``uniform(base, 3*prev)``, capped.

    N workers crashing on the same cause (a shared bad dependency, a
    full disk) must NOT retry in lockstep — deterministic exponential
    backoff synchronizes the herd.  Decorrelated jitter keeps the
    expected growth exponential while spreading each worker's retries
    uniformly, and the cap still bounds the worst case.  ``prev`` is the
    previous delay (None on the first retry, where the spread collapses
    to ``[base, 3*base]``); ``rng`` is the determinism seam for tests.
    ``attempt`` stays in the signature so the delay remains a pure
    function of the retry history the caller already tracks.
    """
    del attempt  # growth lives in prev, not in a fixed 2**n schedule
    rng = rng or _BACKOFF_RNG
    high = min(max(3.0 * (prev if prev is not None else base), base), cap)
    return min(rng.uniform(base, high) if high > base else base, cap)


class JobWorker(threading.Thread):
    """One job's execution thread, supervised by the service.

    ``on_done(worker)`` fires exactly once from this thread when the job
    reaches a terminal-or-requeued state; the daemon uses it to free the
    admission slot.  ``injector`` threads the service fault plan into
    the per-round stop hook (``worker_death``).  ``device`` is the
    daemon's resolved device: every attempt of the job runs there.
    """

    def __init__(self, job, job_dir: str, ledger_dir: str, queue,
                 telemetry, *, retries: int = 2, backoff: float = 0.5,
                 backoff_cap: float = 30.0, run_monitor: bool = True,
                 compile_cache_dir: str = "", injector=None, device="cuda",
                 sched: dict[str, Any] | None = None,
                 on_done: Callable | None = None,
                 sleep: Callable[[float], None] = time.sleep):
        super().__init__(name=f"attackfl-worker-{job.job_id}", daemon=True)
        self.job = job
        self.job_dir = job_dir
        self.ledger_dir = ledger_dir
        self.queue = queue
        self._tel = telemetry
        self.retries = max(int(retries), 0)
        self.backoff = backoff
        self.backoff_cap = backoff_cap
        self.run_monitor = run_monitor
        self.compile_cache_dir = compile_cache_dir
        self._injector = injector
        self.device = device
        # scheduler metadata: priority + accounting carried
        # into the run header so ledger records can mine them
        self.sched = dict(sched or {})
        self._on_done = on_done
        self._sleep = sleep
        self._drain = threading.Event()
        self._cancel = threading.Event()
        self._preempt = threading.Event()
        self.sim = None  # live Simulator while a run is in flight
        self.final_state = "running"
        self.error: str | None = None

    # ---- control ----------------------------------------------------

    def request_drain(self) -> None:
        """Finish the in-flight round, checkpoint, requeue (SIGTERM)."""
        self._drain.set()

    def request_cancel(self) -> None:
        """Finish the in-flight round, mark cancelled."""
        self._cancel.set()

    def request_preempt(self) -> None:
        """Scheduler preemption: stop at the next safe seam
        (round boundary for runs, chunk boundary for matrix sweeps),
        checkpoint, requeue with ``resume=True`` — same machinery as
        drain, but the job goes back to the QUEUE of this daemon rather
        than the next one's."""
        self._preempt.set()

    # ---- health aggregation (service /healthz) ----------------------

    def health(self) -> dict[str, Any]:
        """This run's health snapshot for the service aggregate."""
        out: dict[str, Any] = {"job_id": self.job.job_id, "status": "running"}
        sim = self.sim
        monitor = getattr(sim, "monitor", None) if sim is not None else None
        if monitor is not None:
            code, payload = monitor.health()
            out["status"] = payload.get("status", "ok")
            out["rounds_completed"] = payload.get("rounds_completed")
            out["monitor_port"] = monitor.port
            out["stalled"] = code == 503
        return out

    # ---- execution --------------------------------------------------

    def _stop_hook(self, completed_rounds: int) -> str | bool:
        """Consulted by the engine between rounds: the drain/cancel/
        preempt seam AND the ``worker_death`` injection point (the
        injector raises).  Returns the stop REASON as a truthy string —
        the engine treats any truthy value as "stop" and threads the
        reason into its run_end event — or False to keep running."""
        if self._injector is not None:
            self._injector.maybe_worker_death(completed_rounds)
        if self._cancel.is_set():
            return "cancel"
        if self._drain.is_set():
            return "drain"
        if self._preempt.is_set():
            return "preempt"
        return False

    def _emit_job(self, action: str, **fields: Any) -> None:
        if self._tel is not None:
            self._tel.events.emit("job", job_id=self.job.job_id,
                                  action=action, **fields)

    def _sched_header(self) -> dict[str, Any]:
        """Schema-v11 run-header fields from the scheduler's metadata,
        so every ledger record derived from this run carries its
        priority + preemption/wait accounting."""
        out: dict[str, Any] = {}
        if self.sched.get("priority"):
            out["sched_priority"] = str(self.sched["priority"])
        if self.sched.get("preemptions") is not None:
            out["sched_preemptions"] = int(self.sched["preemptions"])
        if self.sched.get("wait_seconds") is not None:
            # scheduler JSON (host value) — no float() coercion needed,
            # and the service layer is a no-allowlist host-sync zone
            out["sched_wait_seconds"] = round(
                self.sched["wait_seconds"], 6)
        # schema v12: the fleet-trace id + tenant + device
        # slot join this run's header to the service's causal stream
        if self.sched.get("fleet_id"):
            out["sched_fleet_id"] = str(self.sched["fleet_id"])
        if self.sched.get("slot") is not None:
            out["sched_slot"] = int(self.sched["slot"])
        if self.sched.get("tenant"):
            out["sched_tenant"] = str(self.sched["tenant"])
        return out

    def _execute(self, resume: bool) -> dict[str, Any]:
        """One attempt: build the isolated config, run to completion or
        a stop/crash.  Returns {completed, target, interrupted}."""
        from attackfl_tpu_torch.training.engine import Simulator

        os.makedirs(self.job_dir, exist_ok=True)
        cfg = build_job_config(
            self.job.spec, self.job_dir, self.ledger_dir, resume=resume,
            run_monitor=self.run_monitor,
            compile_cache_dir=self.compile_cache_dir)
        if self.job.spec.get("type") == "matrix":
            return self._execute_matrix(cfg, resume)
        num_rounds = self.job.spec.get("num_rounds") or cfg.num_round
        sim = Simulator(cfg, device=self.device)
        sim.header_extra.update(self._sched_header())
        self.sim = sim
        try:
            if sim.monitor is not None:
                # bind now so /jobs can report the run's monitor port
                # while the first round is still running
                sim.monitor.start()
                self.queue.mark(self.job.job_id, "running",
                                monitor_port=sim.monitor.port)
            state, history = sim.run(num_rounds=int(num_rounds),
                                     verbose=False, stop=self._stop_hook)
        finally:
            self.sim = None
            sim.close()
        completed = int(state["completed_rounds"])
        return {
            "completed": completed,
            "target": int(num_rounds),
            "ok_rounds": sum(1 for h in history if h.get("ok")),
            "interrupted": completed < int(num_rounds),
        }

    def _execute_matrix(self, cfg, resume: bool) -> dict[str, Any]:
        """A ``matrix`` job: ONE sealed queue entry expands to one sweep
        (its device cells' local updates folded under one K3 launch a
        step) plus a full grid of per-cell ledger records in the SHARED
        service ledger.  ``threefry2x32`` is forced, as the JAX package's
        worker forces it for batched sweeps (the price and the
        fingerprints name the config that runs).  The sweep's chunk
        boundary is the drain/cancel seam (the stop hook), and restarts
        resume from the sweep checkpoint byte-identically — the same
        supervision contract plain run jobs get."""
        from attackfl_tpu_torch.matrix.grid import grid_from_dict
        from attackfl_tpu_torch.training.matrix_exec import MatrixRun

        grid = grid_from_dict(dict(self.job.spec.get("grid") or {}))
        if cfg.prng_impl != "threefry2x32":
            cfg = cfg.replace(prng_impl="threefry2x32")
        cfg = cfg.replace(resume=resume or cfg.resume)
        runner = MatrixRun(cfg, grid,
                           sweep_id=self.job.spec.get("sweep_id")
                           or self.job.job_id, device=self.device)
        runner.header_extra.update(self._sched_header())
        try:
            self.queue.mark(self.job.job_id, "running",
                            sweep_id=runner.sweep_id)
            _, histories = runner.run(stop=self._stop_hook, verbose=False)
        finally:
            runner.close()
        # the runner knows whether a stop hook cut it short — histories
        # alone can't tell (a resumed sweep's cells re-run zero rounds)
        interrupted = runner.interrupted
        return {
            "completed": 0 if interrupted else grid.n_cells,
            "target": grid.n_cells,
            "ok_rounds": sum(1 for h in histories.values()
                             for e in h if e.get("ok")),
            "interrupted": interrupted,
        }

    def run(self) -> None:  # thread body
        attempts = int(self.job.status.get("attempts", 0))
        resume = bool(self.job.status.get("resume"))
        prev_delay: float | None = None
        try:
            while True:
                try:
                    result = self._execute(resume)
                except Exception as e:  # noqa: BLE001 — the supervision seam
                    attempts += 1
                    self.error = f"{type(e).__name__}: {e}"[:300]
                    if self._tel is not None:
                        self._tel.counters.inc("worker_restarts")
                    if attempts > self.retries:
                        self.final_state = "failed"
                        self.queue.mark(self.job.job_id, "failed",
                                        attempts=attempts, error=self.error)
                        if self._tel is not None:
                            self._tel.counters.inc("jobs_failed")
                        self._emit_job("failed", attempts=attempts,
                                       error=self.error)
                        return
                    delay = backoff_delay(attempts, self.backoff,
                                          self.backoff_cap, prev=prev_delay)
                    prev_delay = delay
                    self.queue.mark(self.job.job_id, "running",
                                    attempts=attempts, resume=True,
                                    error=self.error)
                    self._emit_job("retried", attempts=attempts,
                                   backoff_seconds=round(delay, 3),
                                   error=self.error)
                    self._sleep(delay)
                    resume = True  # restart from the newest valid checkpoint
                    continue
                if result["interrupted"] and self._cancel.is_set():
                    self.final_state = "cancelled"
                    self.queue.mark(self.job.job_id, "cancelled",
                                    attempts=attempts, **_summary(result))
                    if self._tel is not None:
                        self._tel.counters.inc("jobs_cancelled")
                    self._emit_job("cancelled", **_summary(result))
                    return
                if result["interrupted"] and self._preempt.is_set() \
                        and not self._drain.is_set():
                    # scheduler preemption: checkpointed at the safe
                    # seam, back to this daemon's queue with the
                    # preemption count persisted (survives restarts —
                    # the scheduler rebuilds tickets from status files)
                    preemptions = int(self.sched.get("preemptions", 0)) + 1
                    extra: dict[str, Any] = {"preemptions": preemptions}
                    if self.sched.get("priority"):
                        extra["priority"] = self.sched["priority"]
                    if self.sched.get("wait_seconds") is not None:
                        extra["wait_seconds"] = self.sched["wait_seconds"]
                    self.final_state = "queued"
                    self.queue.mark(self.job.job_id, "queued",
                                    attempts=attempts, resume=True,
                                    **extra, **_summary(result))
                    if self._tel is not None:
                        self._tel.counters.inc("jobs_requeued")
                    self._emit_job("requeued", reason="preempt",
                                   preemptions=preemptions,
                                   **_summary(result))
                    return
                if result["interrupted"]:  # drain: hand the rest back
                    self.final_state = "queued"
                    self.queue.mark(self.job.job_id, "queued",
                                    attempts=attempts, resume=True,
                                    **_summary(result))
                    if self._tel is not None:
                        self._tel.counters.inc("jobs_requeued")
                    self._emit_job("requeued", reason="drain",
                                   **_summary(result))
                    return
                self.final_state = "done"
                self.queue.mark(self.job.job_id, "done", attempts=attempts,
                                result=_summary(result))
                if self._tel is not None:
                    self._tel.counters.inc("jobs_completed")
                self._emit_job("completed", **_summary(result))
                return
        finally:
            if self._on_done is not None:
                self._on_done(self)


def _summary(result: dict[str, Any]) -> dict[str, Any]:
    return {"completed": result["completed"], "target": result["target"],
            "ok_rounds": result["ok_rounds"]}
