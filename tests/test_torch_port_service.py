"""The port's run service in process on the CPU, against standalone port
runs and the JAX package's service.

``attackfl_tpu_torch/service`` (``RunService``, ``JobWorker``) with the
scheduler on: a ``worker_death`` crash restarts and resumes bit for bit; a
job past its retry budget fails and the service survives; a drain requeues
and the next daemon finishes bit for bit; a run job and a matrix job, each
preempted at its safe seam (round and chunk boundary), resume bit for bit;
two concurrent jobs with hotspot windows both complete, one window failing
open; the HTTP routes answer with JAX's status codes and keys, the fleet
observatory's ``/fleet`` and SLO gauges included; and one small job through JAX's
``RunService`` and the port's goes through the same lifecycle, trains to
the same final params and validates to the same AUCs.  The kernels' launch
counters lose no count across threads, and a device-wide sync waits for a
step graph's capture.
"""

import json
import os
import pathlib
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch
from _torch_port_threads import one_torch_thread  # noqa: F401

from attackfl_tpu_torch.config import TelemetryConfig, config_from_dict
from attackfl_tpu_torch.faults.plan import parse_fault_plan
from attackfl_tpu_torch.matrix.grid import cell_config, expand_cells, grid_from_dict
from attackfl_tpu_torch.ops import fused_step
from attackfl_tpu_torch.service.daemon import RunService
from attackfl_tpu_torch.training.engine import Simulator
from attackfl_tpu_torch.training.matrix_exec import MATRIX_STATE_FILE

# config 4's model and backend at a small size: 3 rounds take ~0.3 s
JOB = {"server": {"num-round": 3, "clients": 3, "mode": "fedavg", "model": "TransformerModel",
                  "data-name": "ICU", "train-size": 128, "test-size": 64, "random-seed": 1,
                  "data-distribution": {"num-data-range": [16, 24]}},
       "learning": {"epoch": 1, "batch-size": 16}, "tpu": {"local-backend": "pallas"}}
GRID = {"attacks": ["LIE", "none"], "attack-clients": 1, "defenses": ["fedavg", "median"],
        "seeds": [1], "rounds": 6, "chunk": 1}
TERMINAL = ("done", "failed", "cancelled")
# the engine tests' AUC tolerance (test_torch_port_defense_round.py)
AUC_TOL = 1e-4


def job_config(backend: str = "pallas", **server) -> dict:
    raw = json.loads(json.dumps(JOB))
    raw["server"].update(server)
    raw["tpu"]["local-backend"] = backend
    return raw


def make_service(tmp_path, name: str = "spool", **kw) -> RunService:
    kw.setdefault("port", 0)
    kw.setdefault("worker_backoff", 0.01)
    kw.setdefault("worker_backoff_cap", 0.05)
    kw.setdefault("poll_interval", 0.02)
    return RunService(str(tmp_path / name), device="cpu", **kw)


def wait_for(predicate, timeout: float = 60.0, message: str = "condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        value = predicate()
        if value:
            return value
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {message}")


def terminal(service, job_id: str):
    job = service.queue.get(job_id)
    return job if job is not None and job.state in TERMINAL else None


def events_of(path) -> list:
    with open(path) as fh:
        return [json.loads(line) for line in fh]


def load(path) -> dict:
    return torch.load(path, weights_only=True, map_location="cpu")


def same_bits(a, b) -> bool:
    if isinstance(a, dict):
        return isinstance(b, dict) and sorted(a) == sorted(b) and all(
            same_bits(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    return a == b


_REFERENCES: dict = {}


def reference_state(tmp_path, raw: dict) -> dict:
    """The config's uninterrupted standalone port run on the CPU: its final
    checkpointed state (memoized per config)."""
    key = json.dumps(raw, sort_keys=True)
    if key not in _REFERENCES:
        directory = tmp_path / "reference"
        cfg = config_from_dict(raw).replace(log_path=str(directory),
                                            checkpoint_dir=str(directory),
                                            telemetry=TelemetryConfig(enabled=False))
        sim = Simulator(cfg, device="cpu")
        sim.run(verbose=False)
        sim.close()
        _REFERENCES[key] = load(directory / "TransformerModel.pth")
    return _REFERENCES[key]


def job_state(service, job_id: str) -> dict:
    return load(pathlib.Path(service.spool) / "jobs" / job_id / "TransformerModel.pth")


# ---------------------------------------------------------------------------
# supervision
# ---------------------------------------------------------------------------

def test_worker_death_restarts_and_resumes_bit_identical(tmp_path):
    service = make_service(tmp_path, fault_plan=parse_fault_plan("worker_death@1"))
    service.start()
    try:
        job_id = service.submit({"config": job_config(), "name": "crashy"})
        job = wait_for(lambda: terminal(service, job_id), message="the job to end")
    finally:
        service.drain(timeout=10)
        service.close()
    assert job.state == "done" and job.status["attempts"] == 1
    assert "WorkerDeathError" in job.status["error"]
    events = events_of(os.path.join(service.spool, "service.events.jsonl"))
    assert [e["fault"] for e in events if e["kind"] == "fault"] == ["worker_death"]
    retried = [e for e in events if e["kind"] == "job" and e["action"] == "retried"]
    assert len(retried) == 1 and retried[0]["backoff_seconds"] > 0
    job_events = events_of(os.path.join(service.spool, "jobs", job_id, "events.jsonl"))
    assert [e["round"] for e in job_events if e["kind"] == "resume"] == [1]
    assert same_bits(job_state(service, job_id), reference_state(tmp_path, job_config()))


def test_retry_budget_marks_failed_service_survives(tmp_path):
    service = make_service(tmp_path, worker_retries=1)
    service.start()
    try:
        bad = service.submit({"config": job_config("xla", model="NoSuchModel"), "name": "bad"})
        job = wait_for(lambda: terminal(service, bad), message="the bad job to end")
        good = service.submit({"config": job_config(**{"num-round": 1}), "name": "good"})
        wait_for(lambda: terminal(service, good), message="the good job to end")
        code, payload = service.health()
    finally:
        service.drain(timeout=10)
        service.close()
    assert job.state == "failed" and job.status["attempts"] == 2
    assert "NoSuchModel" in job.status["error"]
    assert service.queue.get(good).state == "done"
    assert code == 200 and payload["jobs"] == {"failed": 1, "done": 1}
    assert service.telemetry.counters.get("worker_restarts") == 2


def test_drain_requeues_and_next_daemon_completes_bit_identical(tmp_path):
    raw = job_config(**{"num-round": 30})
    service = make_service(tmp_path)
    service.start()
    job_id = service.submit({"config": raw, "name": "drainee"})
    manifest = pathlib.Path(service.spool) / "jobs" / job_id / "manifest.json"
    wait_for(manifest.exists, message="the first checkpoint")
    assert service.drain(timeout=30) is True
    job = service.queue.get(job_id)
    service.close()
    assert job.state == "queued" and job.status["resume"] is True
    assert 1 <= job.status["completed"] < 30
    second = make_service(tmp_path)
    second.start()
    try:
        wait_for(lambda: terminal(second, job_id), message="the resumed job to end")
    finally:
        second.drain(timeout=10)
        second.close()
    assert second.queue.get(job_id).state == "done"
    assert same_bits(job_state(second, job_id), reference_state(tmp_path, raw))


# ---------------------------------------------------------------------------
# preemption at the safe seams
# ---------------------------------------------------------------------------

def test_preempted_run_job_resumes_bit_identical(tmp_path):
    low_raw = job_config(**{"num-round": 30})
    service = make_service(tmp_path, sched_min_runtime=0.0)
    service.start()
    try:
        low = service.submit({"config": low_raw, "name": "low", "priority": "low"})
        wait_for((pathlib.Path(service.spool) / "jobs" / low / "manifest.json").exists,
                 message="low's first checkpoint")
        high = service.submit({"config": job_config(), "name": "high", "priority": "high"})
        for job_id in (low, high):
            wait_for(lambda j=job_id: terminal(service, j), message=f"{job_id} to end")
    finally:
        service.drain(timeout=10)
        service.close()
    status = service.queue.get(low).status
    assert status["state"] == "done" and status["preemptions"] >= 1
    assert status["priority"] == "low"
    assert same_bits(job_state(service, low), reference_state(tmp_path, low_raw))
    assert same_bits(job_state(service, high), reference_state(tmp_path, job_config()))
    job_events = events_of(os.path.join(service.spool, "jobs", low, "events.jsonl"))
    headers = [e for e in job_events if e["kind"] == "run_header"]
    assert headers[0]["sched_priority"] == "low"
    assert any(h.get("sched_preemptions", 0) >= 1 for h in headers)
    assert any(e.get("stop_reason") == "preempt" for e in job_events if e["kind"] == "run_end")
    schedule = [(e["action"], e.get("job_id"), e.get("reason"))
                for e in events_of(os.path.join(service.spool, "service.events.jsonl"))
                if e["kind"] == "schedule"]
    assert ("preempt", low, "priority") in schedule
    assert any(a == "resume" and j == low for a, j, _ in schedule)


def test_preempted_matrix_job_resumes_bit_identical(tmp_path):
    """A matrix job preempted at a chunk boundary by a high-priority run
    job: every cell's final state equals its standalone run_fast's."""
    raw = job_config("xla")
    service = make_service(tmp_path, sched_min_runtime=0.0)
    service.start()
    try:
        sweep = service.submit({"type": "matrix", "config": raw, "grid": GRID, "name": "sweep",
                                "priority": "low", "sweep_id": "preempted"})
        wait_for((pathlib.Path(service.spool) / "jobs" / sweep / "manifest.json").exists,
                 message="the sweep's first checkpoint")
        high = service.submit({"config": job_config(), "name": "high", "priority": "high"})
        for job_id in (sweep, high):
            wait_for(lambda j=job_id: terminal(service, j), message=f"{job_id} to end")
    finally:
        service.drain(timeout=10)
        service.close()
    status = service.queue.get(sweep).status
    assert status["state"] == "done" and status["preemptions"] >= 1
    job_dir = pathlib.Path(service.spool) / "jobs" / sweep
    stops = [e for e in events_of(job_dir / "events.jsonl")
             if e["kind"] == "matrix" and e["action"] == "interrupted"]
    assert stops and stops[0]["stop_reason"] == "preempt"
    final = load(job_dir / MATRIX_STATE_FILE)
    base = config_from_dict(raw).replace(prng_impl="threefry2x32")
    grid = grid_from_dict(GRID)
    for cell in expand_cells(grid):
        directory = tmp_path / "alone" / cell.key
        sim = Simulator(cell_config(base, cell, rounds=grid.rounds, log_path=str(directory),
                                    checkpoint_dir=str(directory),
                                    telemetry=TelemetryConfig(enabled=False)), device="cpu")
        state, _ = sim.run_fast(state=sim.init_state(), chunk_size=grid.chunk,
                                save_checkpoints=False, verbose=False)
        alone = sim.host_state(dict(state, completed_rounds=int(state["completed_rounds"]),
                                    have_genuine=bool(state["have_genuine"])))
        mine = dict(final[cell.key])
        mine.pop("failures")
        assert same_bits(mine, alone), cell.key


# ---------------------------------------------------------------------------
# two jobs at once on one device
# ---------------------------------------------------------------------------

def test_two_concurrent_jobs_with_hotspot_windows_complete(tmp_path, monkeypatch):
    """One torch.profiler window per process: with two jobs' windows open
    at once the second fails open (an ``unavailable`` hotspot event) or
    both run; both jobs end bit-equal to their runs without a window."""
    monkeypatch.setenv("ATTACKFL_TELEMETRY_DIR", str(tmp_path / "telemetry"))
    raws = [job_config(**{"num-round": 12}), job_config(**{"num-round": 12, "random-seed": 2})]
    for raw in raws:
        raw["telemetry"] = {"hotspots": "1:12"}
    service = make_service(tmp_path, max_workers=2)
    service.start()
    try:
        ids = [service.submit({"config": raw, "name": f"j{i}"}) for i, raw in enumerate(raws)]
        wait_for(lambda: all(service.queue.get(j).state == "running" for j in ids),
                 message="both jobs running")
        for job_id in ids:
            wait_for(lambda j=job_id: terminal(service, j), message=f"{job_id} to end")
    finally:
        service.drain(timeout=10)
        service.close()
    statuses = []
    for job_id, raw in zip(ids, raws):
        assert service.queue.get(job_id).state == "done"
        plain = dict(raw)
        plain.pop("telemetry")
        assert same_bits(job_state(service, job_id), reference_state(tmp_path, plain))
        hotspots = [e for e in events_of(os.path.join(service.spool, "jobs", job_id,
                                                      "events.jsonl"))
                    if e["kind"] == "hotspot"]
        assert len(hotspots) == 1
        statuses.append(hotspots[0]["status"])
    assert "ok" in statuses and set(statuses) <= {"ok", "unavailable"}


@pytest.mark.parametrize("wrapper", ["run_epoch", "fill_masks"])
def test_launch_counters_lose_no_count_across_threads(wrapper, monkeypatch):
    fn = getattr(fused_step, wrapper)
    monkeypatch.setattr(fn, "launches", 0)
    threads = [threading.Thread(target=lambda: [fused_step._count_launch(fn)
                                                for _ in range(20000)]) for _ in range(8)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)       # switch threads as often as the interpreter can
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert fn.launches == 8 * 20000


def test_device_syncs_wait_for_a_graph_capture(monkeypatch):
    """``device.synchronize`` does nothing on the CPU; on the card it waits
    for ``CAPTURE_LOCK``, which a step graph's capture holds, and syncs
    under it."""
    from attackfl_tpu_torch import device as devices

    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda dev=None: calls.append((dev, devices.CAPTURE_LOCK.locked())))
    devices.synchronize("cpu")
    assert calls == []
    with devices.CAPTURE_LOCK:
        waiter = threading.Thread(target=devices.synchronize, args=("cuda",))
        waiter.start()
        waiter.join(timeout=0.2)
        assert waiter.is_alive() and calls == []
    waiter.join(timeout=10)
    assert not waiter.is_alive() and calls == [(torch.device("cuda"), True)]


# ---------------------------------------------------------------------------
# the control plane against JAX's
# ---------------------------------------------------------------------------

def _call(base: str, path: str, method: str = "GET", body=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(base + path, data=data, method=method)
    if data:
        req.add_header("Content-Type", "application/json")
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            raw, code = resp.read().decode(), resp.status
    except urllib.error.HTTPError as e:
        raw, code = e.read().decode(), e.code
    try:
        return code, json.loads(raw)
    except ValueError:
        return code, raw


def _shape(payload):
    """A payload's keys, recursively (values aside)."""
    if isinstance(payload, dict):
        return {k: _shape(v) for k, v in payload.items()}
    if isinstance(payload, list):
        return [_shape(v) for v in payload[:1]]
    return type(payload).__name__


ROUTES = [("/submit", "POST", {"name": "one"}), ("/submit", "POST", {"name": "two"}),
          ("/submit", "POST", {"name": "three"}), ("/submit", "POST", {"priority": "urgent"}),
          ("/submit", "POST", [1]), ("/submit", "POST", "{"), ("/jobs", "GET", None),
          ("/status?job=@0", "GET", None), ("/status?job=nope", "GET", None),
          ("/cancel?job=@0", "POST", None), ("/cancel?job=@0", "POST", None),
          ("/cancel?job=nope", "POST", None), ("/healthz", "GET", None),
          ("/schedule", "GET", None), ("/runs", "GET", None), ("/science", "GET", None),
          ("/science?sweep=nope", "GET", None), ("/nowhere", "GET", None),
          ("/fleet", "GET", None), ("/metrics", "GET", None)]


def _drive_routes(service) -> list:
    """ROUTES against a control plane with no dispatcher: (code, payload)."""
    service._http.start()
    base = f"http://127.0.0.1:{service._http.port}"
    out, first = [], None
    try:
        for path, method, body in ROUTES:
            if first is not None:
                path = path.replace("@0", first)
            if body == "{":
                req = urllib.request.Request(base + path, data=b"{", method="POST")
                try:
                    urllib.request.urlopen(req, timeout=10)
                    code, payload = 200, None
                except urllib.error.HTTPError as e:
                    code, payload = e.code, json.loads(e.read().decode())
            else:
                code, payload = _call(base, path, method, body)
            if first is None and isinstance(payload, dict) and "job_id" in payload:
                first = payload["job_id"]
            out.append((path.replace(first or "@0", "@0"), code, payload))
    finally:
        service.close()
    return out


def test_http_routes_answer_as_jaxs(tmp_path):
    from attackfl_tpu.service.daemon import RunService as JaxRunService

    ours = _drive_routes(make_service(tmp_path, "ours", queue_depth=2))
    theirs = _drive_routes(JaxRunService(str(tmp_path / "theirs"), port=0, queue_depth=2))
    assert [(p, c) for p, c, _ in ours] == [(p, c) for p, c, _ in theirs]
    for (path, code, mine), (_, _, jax_payload) in zip(ours, theirs):
        if path == "/fleet":
            # the SLO report and the device-time ledger of the submissions
            assert code == 200 and set(mine) == {"slo", "ledger"}
            assert _shape(mine) == _shape(jax_payload)
        elif path == "/metrics":
            names = {line.split(" ")[0].split("{")[0] for line in mine.splitlines()
                     if line and not line.startswith("#")}
            jax_names = {line.split(" ")[0].split("{")[0] for line in jax_payload.splitlines()
                         if line and not line.startswith("#")}
            # JAX's gauges, the SLO ones included; the kernels' launch
            # counts beside
            assert "attackfl_slo_preemption_rate" in names
            assert jax_names - names == set()
            assert names - jax_names == {"attackfl_kernel_launches_total"}
        elif path == "/healthz":
            assert set(mine) - {"device"} == set(jax_payload) - {"device"}
        elif path in ("/runs", "/science", "/science?sweep=nope"):
            assert set(mine) == set(jax_payload)
        elif isinstance(mine, dict) and "error" in mine:
            assert set(mine) == set(jax_payload)
        else:
            assert _shape(mine) == _shape(jax_payload), path


# ---------------------------------------------------------------------------
# one job through JAX's service and the port's
# ---------------------------------------------------------------------------

# one distinct training sample (train-size 1, sampled with replacement)
# and every client's size fixed: each client trains on copies of it, so
# the result does not depend on either package's draws; a small learning
# rate keeps the AUC off its saturated 0.5
CNN_JOB = {"server": {"num-round": 2, "clients": 3, "mode": "fedavg", "model": "CNNModel",
                      "data-name": "ICU", "train-size": 1, "test-size": 128, "random-seed": 1,
                      "parameters": {"load": True},
                      "data-distribution": {"num-data-range": [16, 16]}},
           "learning": {"epoch": 1, "batch-size": 8, "learning-rate": 3e-4}}
# the final params of both services' jobs (measured 5.1e-7 apart, each
# 1.2e-3 from the initial params)
PARAM_TOL = 1e-5


def _lifecycle(spool: str, job_id: str) -> tuple:
    events = events_of(os.path.join(spool, "service.events.jsonl"))
    keep = [(e["kind"], e.get("action")) for e in events
            if e["kind"] in ("service", "job", "schedule", "slot")]
    rounds = [e for e in events_of(os.path.join(spool, "jobs", job_id, "events.jsonl"))
              if e["kind"] == "round"]
    return keep, rounds


def test_one_job_through_jaxs_service_and_the_ports(tmp_path, monkeypatch):
    """The same small CNNModel job (model dropout off in both packages, no
    client dropout, one distinct training sample, so the result does not
    depend on either package's draws) through both services from JAX's
    initial params: the same service, job, schedule and slot events in the
    same order, the same final status, the rounds' AUCs within the engine
    tests' tolerance, and the final params within PARAM_TOL of each other
    and a hundred times farther from the initial ones.  The port's job
    loads the JAX package's initial params through ``parameters.load``,
    written into its job directory before the daemon starts."""
    import jax
    import numpy as np

    from attackfl_tpu.config import TelemetryConfig as JaxTelemetryConfig
    from attackfl_tpu.config import config_from_dict as jax_config_from_dict
    from attackfl_tpu.models.icu import CNNModel as JaxCNNModel
    from attackfl_tpu.service.daemon import RunService as JaxRunService
    from attackfl_tpu.training import engine as jax_engine
    from attackfl_tpu.utils import checkpoint as jax_ckpt
    from attackfl_tpu_torch.models.icu import CNNModel
    from attackfl_tpu_torch.ops import pytree as pt
    from attackfl_tpu_torch.training import engine
    from attackfl_tpu_torch.utils import checkpoint as ckpt
    from attackfl_tpu_torch.weights import params_from_jax

    monkeypatch.setattr(jax_engine, "get_model", lambda name: JaxCNNModel(dropout_rate=0.0))
    monkeypatch.setattr(engine, "get_model", lambda name: CNNModel(dropout_rate=0.0))
    jcfg = jax_config_from_dict(CNN_JOB).replace(
        log_path=str(tmp_path / "jinit"), checkpoint_dir=str(tmp_path / "jinit"),
        telemetry=JaxTelemetryConfig(enabled=False))
    jax_init = jax_engine.Simulator(jcfg).init_state()
    to_port = lambda t: params_from_jax(jax.tree.map(np.asarray, t), "CNNModel")  # noqa: E731

    results, finals = {}, {}
    for pkg in ("jax", "port"):
        spool = str(tmp_path / pkg)
        service = (JaxRunService(spool, port=0, poll_interval=0.02) if pkg == "jax"
                   else make_service(tmp_path, pkg))
        job_id = service.submit({"config": CNN_JOB, "name": "cnn"})
        if pkg == "port":
            cfg = config_from_dict(CNN_JOB).replace(
                log_path=str(tmp_path / "pinit"), checkpoint_dir=str(tmp_path / "pinit"),
                telemetry=TelemetryConfig(enabled=False))
            sim = Simulator(cfg, device="cpu")
            template = sim.host_state(dict(sim.init_state(), global_params=to_port(
                jax_init["global_params"])))
            os.makedirs(os.path.join(spool, "jobs", job_id))
            ckpt.save_state(os.path.join(spool, "jobs", job_id, "CNNModel.pth"), template)
        service.start()
        try:
            job = wait_for(lambda: terminal(service, job_id), timeout=120,
                           message=f"the {pkg} job to end")
            # the worker's completed event and the scheduler's slot release
            # follow the status write; wait for both before draining
            events_path = os.path.join(spool, "service.events.jsonl")
            wait_for(lambda: not service._workers and any(
                e["kind"] == "slot" and e["action"] == "release"
                for e in events_of(events_path)), message=f"the {pkg} slot's release")
        finally:
            service.drain(timeout=30)
            service.close()
        keep = ("state", "attempts", "resume", "result", "priority", "preemptions")
        results[pkg] = (_lifecycle(spool, job_id), {k: job.status.get(k) for k in keep})
        if pkg == "jax":
            path = jax_ckpt.checkpoint_path(jcfg, os.path.join(spool, "jobs", job_id))
            finals[pkg] = to_port(jax_ckpt.load_state(path, jax_ckpt.host_state(jax_init))[
                "global_params"])
        else:
            finals[pkg] = ckpt.load_state(os.path.join(spool, "jobs", job_id, "CNNModel.pth"),
                                          template)["global_params"]
    (jax_events, jax_rounds), jax_status = results["jax"]
    (events, rounds), status = results["port"]
    assert events == jax_events and status == jax_status
    assert status["state"] == "done" and status["result"]["ok_rounds"] == 2
    assert [r["round"] for r in rounds] == [r["round"] for r in jax_rounds] == [1, 2]
    for ours, theirs in zip(rounds, jax_rounds):
        assert abs(ours["roc_auc"] - theirs["roc_auc"]) <= AUC_TOL
    gap = lambda a, b: max(float((x - y).abs().max())  # noqa: E731
                           for x, y in zip(pt.tree_leaves(a), pt.tree_leaves(b)))
    assert gap(finals["port"], finals["jax"]) <= PARAM_TOL
    assert gap(finals["jax"], to_port(jax_init["global_params"])) >= 100 * PARAM_TOL
