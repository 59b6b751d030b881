"""The port's run-service queue against the JAX package's, on the CPU.

``attackfl_tpu_torch/service/queue.py`` and the sealed-JSON helpers of
``attackfl_tpu_torch/utils/atomicio.py`` against ``attackfl_tpu/service/
queue.py`` and ``attackfl_tpu/utils/atomicio.py``: the sealed entries are
the same bytes for the same payload, a spool written by either package's
``JobQueue`` is claimed, cancelled and replayed by the other's (torn status
and spec entries included), and the ``submit_flood`` and ``queue_torn``
faults fire at the same submission and publish numbers with the same
rejections.
"""

import json
import os
import shutil

import pytest

from attackfl_tpu.faults.inject import HostFaultInjector as JaxInjector
from attackfl_tpu.faults.plan import parse_fault_plan as jax_parse_fault_plan
from attackfl_tpu.service.queue import JobQueue as JaxJobQueue
from attackfl_tpu.service.queue import QueueFullError as JaxQueueFullError
from attackfl_tpu.telemetry import Counters as JaxCounters
from attackfl_tpu.telemetry import EventLog as JaxEventLog
from attackfl_tpu.telemetry import NullTracer as JaxNullTracer
from attackfl_tpu.telemetry import Telemetry as JaxTelemetry
from attackfl_tpu.utils import atomicio as jax_atomicio
from attackfl_tpu_torch.faults.inject import HostFaultInjector
from attackfl_tpu_torch.faults.plan import parse_fault_plan
from attackfl_tpu_torch.service.queue import JobQueue, QueueFullError
from attackfl_tpu_torch.telemetry.core import Telemetry
from attackfl_tpu_torch.telemetry.counters import Counters
from attackfl_tpu_torch.telemetry.events import EventLog, validate_event
from attackfl_tpu_torch.telemetry.trace import NullTracer
from attackfl_tpu_torch.utils import atomicio

PACKAGES = {
    "jax": (JaxJobQueue, JaxQueueFullError, JaxInjector, jax_parse_fault_plan,
            lambda path: JaxTelemetry(JaxEventLog(path), JaxNullTracer(), JaxCounters(), True)),
    "port": (JobQueue, QueueFullError, HostFaultInjector, parse_fault_plan,
             lambda path: Telemetry(EventLog(path), NullTracer(), Counters(), True)),
}
OTHER = {"jax": "port", "port": "jax"}
PAYLOADS = [
    {"config": {"server": {"num-round": 2, "clients": 3}}, "name": "a", "seq": 1,
     "submitted_ts": 1792324933.697718},
    {"state": "running", "attempts": 1, "resume": True, "error": "WorkerDeathError: é ✓",
     "result": {"completed": 2, "target": 3, "ok_rounds": 2}, "priority": "low"},
    {"type": "matrix", "grid": {"attacks": ["LIE", "none"], "seeds": [1, 2], "rounds": 2},
     "nested": [1.5, None, True, {"z": [], "a": {}}]},
    [], "", 0, None,
]


def _events(path) -> list:
    with open(path) as fh:
        return [json.loads(line) for line in fh]


def _tear(path) -> None:
    with open(path, "rb") as fh:
        data = fh.read()
    with open(path, "wb") as fh:
        fh.write(data[:len(data) // 2])


@pytest.mark.parametrize("payload", PAYLOADS, ids=[f"payload{i}" for i in range(len(PAYLOADS))])
def test_sealed_json_bytes_equal_jax(payload, tmp_path):
    ours, theirs = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    atomicio.write_sealed_json(ours, payload)
    jax_atomicio.write_sealed_json(theirs, payload)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    assert atomicio.read_sealed_json(theirs) == (payload, None)
    assert jax_atomicio.read_sealed_json(ours) == (payload, None)


@pytest.mark.parametrize("damage", ["torn", "tampered", "missing", "not_sealed"])
def test_read_sealed_json_reasons_match_jax(damage, tmp_path):
    path = str(tmp_path / "entry.json")
    atomicio.write_sealed_json(path, PAYLOADS[1])
    if damage == "torn":
        _tear(path)
    elif damage == "tampered":
        raw = json.loads(open(path).read())
        raw["payload"]["attempts"] = 2
        with open(path, "w") as fh:
            json.dump(raw, fh)
    elif damage == "missing":
        os.unlink(path)
    else:
        with open(path, "w") as fh:
            json.dump({"state": "queued"}, fh)
    ours, theirs = atomicio.read_sealed_json(path), jax_atomicio.read_sealed_json(path)
    assert ours[0] is None and theirs[0] is None
    # the reasons carry the parser's and the OS's text, the same in both
    assert ours[1] == theirs[1]


def test_write_json_atomic_bytes_equal_jax(tmp_path):
    payload = {"url": "http://127.0.0.1:8781", "port": 8781, "pid": 7, "started_ts": 1.5}
    atomicio.write_json_atomic(str(tmp_path / "a.json"), payload)
    jax_atomicio.write_json_atomic(str(tmp_path / "b.json"), payload)
    assert (tmp_path / "a.json").read_bytes() == (tmp_path / "b.json").read_bytes()


def _spool_history(queue_cls, qdir) -> dict:
    """A spool with a job of each state: one running (claimed, its daemon
    then gone), one queued, one done, one cancelled, one queued with its
    status torn, one whose spec is torn."""
    queue = queue_cls(str(qdir), depth=8)
    ids = {name: queue.submit({"name": name, "config": {"server": {"num-round": 2}}})
           for name in ("interrupted", "queued", "done", "cancelled", "torn", "torn_spec")}
    assert queue.claim().job_id == ids["interrupted"]
    queue.mark(ids["done"], "done", result={"completed": 2, "target": 2, "ok_rounds": 2})
    assert queue.cancel(ids["cancelled"]) == "cancelled"
    _tear(qdir / f"{ids['torn']}.status.json")
    _tear(qdir / f"{ids['torn_spec']}.json")
    return ids


def _describe(jobs) -> list:
    keep = ("job_id", "state", "name", "seq", "attempts", "resume", "result")
    return [{k: d[k] for k in keep if k in d} for d in (j.describe() for j in jobs)]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_spool_of_either_package_replays_alike(writer, tmp_path):
    """The other package's replay of ``writer``'s spool requeues the same
    jobs (the interrupted one and the torn-status one, with resume), counts
    the same torn entries, quarantines the torn spec, and leaves the spool
    as ``writer``'s own replay of a copy leaves it."""
    reader = OTHER[writer]
    _spool_history(PACKAGES[writer][0], tmp_path / "a")
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    out = {}
    for side, pkg in (("a", reader), ("b", writer)):
        queue = PACKAGES[pkg][0](str(tmp_path / side), depth=8)
        replay = queue.replay()
        out[pkg] = (sorted(replay["requeued"]), len(replay["torn"]), _describe(queue.jobs()),
                    sorted(os.listdir(tmp_path / side)))
    assert out[reader] == out[writer]
    requeued, torn, jobs, files = out[reader]
    by_name = {j["name"]: j for j in jobs}
    assert sorted(requeued) == sorted([by_name["interrupted"]["job_id"],
                                       by_name["torn"]["job_id"]])
    assert torn == 2 and "torn_spec" not in by_name and len(jobs) == 5
    assert by_name["interrupted"]["resume"] is True and by_name["torn"]["state"] == "queued"
    assert by_name["done"]["state"] == "done" and by_name["cancelled"]["state"] == "cancelled"
    assert sum(f.endswith(".json.torn") for f in files) == 1


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_spool_of_either_package_is_claimed_by_the_other(writer, tmp_path):
    """Jobs submitted by one package are claimed oldest first, by id,
    marked, cancelled and counted against the depth by the other; the
    entries the reader publishes are read back by the writer."""
    reader = OTHER[writer]
    w_cls, r_cls = PACKAGES[writer][0], PACKAGES[reader][0]
    full_error = PACKAGES[reader][1]
    w = w_cls(str(tmp_path), depth=3)
    a, b, c = (w.submit({"name": n}) for n in "abc")
    r = r_cls(str(tmp_path), depth=3)
    with pytest.raises(full_error, match="queue full"):
        r.submit({"name": "d"})
    assert r.claim().job_id == a
    assert r.claim(c).job_id == c and r.claim(c) is None
    assert r.cancel(a) == "running" and r.cancel(b) == "cancelled" and r.cancel("x") == "not_found"
    r.mark(c, "done", attempts=1, result={"completed": 2})
    assert [(j.job_id, j.state) for j in w.jobs()] == [(a, "running"), (b, "cancelled"),
                                                        (c, "done")]
    assert w.get(c).status["result"] == {"completed": 2} and w.get(c).status["attempts"] == 1
    d = w.submit({"name": "d"})
    assert r.get(d).spec["seq"] == 4 and r.get(d).state == "queued"


def _fault_run(pkg: str, tmp_path, plan: str, depth: int, submissions: int) -> dict:
    queue_cls, full_error, injector_cls, parse, telemetry = PACKAGES[pkg]
    events_path = tmp_path / pkg / "service.events.jsonl"
    tel = telemetry(str(events_path))
    queue = queue_cls(str(tmp_path / pkg / "queue"), depth=depth, telemetry=tel,
                      injector=injector_cls(parse(plan), tel))
    outcomes = []
    for i in range(submissions):
        try:
            queue.submit({"name": f"j{i}"})
            outcomes.append("ok")
        except full_error:
            outcomes.append("full")
    first = queue.jobs()[0].job_id if queue.jobs() else None
    if first is not None:
        queue.claim(first)
        queue.mark(first, "done")
    tel.close()
    events = _events(events_path)
    torn = sorted(f for f in os.listdir(tmp_path / pkg / "queue")
                  if atomicio.read_sealed_json(str(tmp_path / pkg / "queue" / f))[0] is None)
    return {"outcomes": outcomes,
            "faults": [(e["fault"], e["round"], e.get("count")) for e in events
                       if e["kind"] == "fault"],
            "jobs": [(e["action"], e.get("reason", "")[:10]) for e in events
                     if e["kind"] == "job"],
            "counters": tel.counters.snapshot(),
            "names": [j.spec["name"] for j in queue_cls(str(tmp_path / pkg / "queue")).jobs()],
            "torn": len(torn), "port_events": events if pkg == "port" else None}


@pytest.mark.parametrize("plan,depth,submissions", [
    ("submit_flood@1:count=5", 3, 1),
    ("submit_flood@2:count=2", 8, 3),
    ("submit_flood@3:count=4;submit_flood@4:count=1", 5, 5),
    ("queue_torn@2", 4, 3),
    ("queue_torn@1;queue_torn@4;submit_flood@2:count=3", 4, 4),
])
def test_flood_and_tear_fire_at_jaxs_numbers(plan, depth, submissions, tmp_path):
    """The same plan, depth and submissions through both queues: the
    faults fire at the same submission and publish numbers, the flood's
    duplicates are admitted and rejected alike, the same status entries
    are torn, and the port's events pass its schema."""
    jax_run = _fault_run("jax", tmp_path, plan, depth, submissions)
    port_run = _fault_run("port", tmp_path, plan, depth, submissions)
    events = port_run.pop("port_events")
    jax_run.pop("port_events")
    assert port_run == jax_run
    assert port_run["faults"]
    assert all(validate_event(e) == [] for e in events)


def test_torn_status_of_a_running_job_is_requeued_with_resume(tmp_path):
    """``queue_torn`` on the claim's publish: the next daemon's replay
    (either package's) requeues the job with resume, as a status it can no
    longer trust."""
    tel = Telemetry(EventLog(str(tmp_path / "events.jsonl")), NullTracer(), Counters(), True)
    queue = JobQueue(str(tmp_path / "q"), depth=4, telemetry=tel,
                     injector=HostFaultInjector(parse_fault_plan("queue_torn@2"), tel))
    job_id = queue.submit({"name": "a"})
    assert queue.claim().job_id == job_id          # publish 2: torn
    assert atomicio.read_sealed_json(str(tmp_path / "q" / f"{job_id}.status.json"))[0] is None
    for pkg in ("jax", "port"):
        fresh = PACKAGES[pkg][0](str(tmp_path / "q"), depth=4)
        jobs = fresh.jobs()
        assert [(j.job_id, j.state, j.status.get("status_torn") is not None)
                for j in jobs] == [(job_id, "queued", True)]
    replay = JaxJobQueue(str(tmp_path / "q"), depth=4).replay()
    assert replay["requeued"] == [job_id]
    assert JobQueue(str(tmp_path / "q")).get(job_id).status["resume"] is True
