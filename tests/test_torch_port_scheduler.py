"""The port's scheduler against the JAX package's, on the CPU.

``attackfl_tpu_torch/scheduler`` against ``attackfl_tpu/scheduler``: the
two ``SchedulerPolicy``s make the same ``plan`` and ``shed_decision`` on
seeded random ticket sets; the two ``JobPricer``s give the same price dict
over the committed ledger corpus and over a ledger of peers, for run and
matrix specs, cold and under ``estimate_skew``; and the two
``JobScheduler``s, each on its own package's durable queue with a fake
clock and stub workers, emit the same ``schedule`` and ``slot`` events
(job ids, run ids and timestamps aside) through the same history: packing,
a circuit-broken job, a priced shed, a priority preemption and its resume,
a ``preempt_storm`` and sustained high-priority load against the aging
bound.
"""

import json
import pathlib

import numpy as np
import pytest

from attackfl_tpu.faults.inject import HostFaultInjector as JaxInjector
from attackfl_tpu.faults.plan import parse_fault_plan as jax_parse_fault_plan
from attackfl_tpu.ledger.store import LedgerStore as JaxLedgerStore
from attackfl_tpu.scheduler import core as jcore
from attackfl_tpu.scheduler import policy as jpolicy
from attackfl_tpu.scheduler.pricing import JobPricer as JaxJobPricer
from attackfl_tpu.service.queue import JobQueue as JaxJobQueue
from attackfl_tpu.telemetry import Counters as JaxCounters
from attackfl_tpu.telemetry import EventLog as JaxEventLog
from attackfl_tpu.telemetry import NullTracer as JaxNullTracer
from attackfl_tpu.telemetry import Telemetry as JaxTelemetry
from attackfl_tpu_torch.config import config_from_dict
from attackfl_tpu_torch.faults.inject import HostFaultInjector
from attackfl_tpu_torch.faults.plan import parse_fault_plan
from attackfl_tpu_torch.scheduler import core, policy
from attackfl_tpu_torch.scheduler.pricing import JobPricer
from attackfl_tpu_torch.service.queue import JobQueue
from attackfl_tpu_torch.telemetry.core import Telemetry
from attackfl_tpu_torch.telemetry.counters import Counters
from attackfl_tpu_torch.telemetry.events import EventLog, validate_event
from attackfl_tpu_torch.telemetry.trace import NullTracer
from attackfl_tpu_torch.utils.fingerprint import config_fingerprint

DATA = pathlib.Path(__file__).resolve().parent / "data"
JOB = {"server": {"num-round": 2, "clients": 3, "mode": "fedavg", "model": "CNNModel",
                  "data-name": "ICU", "validation": False, "train-size": 256,
                  "test-size": 128, "random-seed": 1,
                  "data-distribution": {"num-data-range": [48, 64]}},
       "learning": {"epoch": 1, "batch-size": 32}}
GRID = {"attacks": ["LIE", "none"], "attack-clients": 1, "defenses": ["fedavg", "median"],
        "seeds": [1, 2], "rounds": 3, "chunk": 2}


# ---------------------------------------------------------------------------
# policy: seeded random ticket sets
# ---------------------------------------------------------------------------

def _ticket_fields(rng, i: int, now: float) -> dict:
    running = bool(rng.random() < 0.4)
    return dict(job_id=f"j{i:02d}", priority=str(rng.choice(list(policy.PRIORITY_CLASSES))),
                predicted_seconds=float(rng.choice([0.0, rng.uniform(0.1, 300.0)])),
                enqueued_ts=float(now - rng.uniform(0.0, 400.0)),
                started_ts=float(now - rng.uniform(0.0, 10.0)) if running else None,
                completed_fraction=float(rng.choice([0.0, rng.uniform(-0.2, 1.2)])),
                preemptions=int(rng.integers(0, 3)),
                preempt_requested=bool(running and rng.random() < 0.2),
                seq=int(rng.integers(0, 5)))


def _both_tickets(seed: int):
    rng = np.random.default_rng(seed)
    now = 1000.0
    fields = [_ticket_fields(rng, i, now) for i in range(int(rng.integers(0, 14)))]
    knobs = dict(slots=int(rng.integers(1, 4)), aging_rate=float(rng.uniform(0.05, 20.0)),
                 band_width=float(rng.choice([1.0, 10.0, 25.0])),
                 min_runtime_seconds=float(rng.choice([0.0, 2.0, 5.0])),
                 shed_horizon_seconds=float(rng.choice([0.0, 50.0, 500.0])))
    return fields, knobs, now, float(rng.uniform(0.0, 200.0))


def _plan(mod, fields, knobs, now):
    tickets = [mod.Ticket(**f) for f in fields]
    queued = [t for t in tickets if t.started_ts is None]
    running = [t for t in tickets if t.started_ts is not None]
    pol = mod.SchedulerPolicy(**knobs)
    plan = pol.plan(queued, running, now)
    return ([t.job_id for t in plan.start], [t.job_id for t in plan.preempt],
            plan.backlog_seconds, [(t.job_id, t.preempt_requested) for t in tickets],
            [round(pol.effective_priority(t, now), 9) for t in tickets],
            pol.starvation_bound_seconds())


@pytest.mark.parametrize("seed", range(16))
def test_plan_matches_jax_on_random_tickets(seed):
    fields, knobs, now, _ = _both_tickets(seed)
    assert _plan(policy, fields, knobs, now) == _plan(jpolicy, fields, knobs, now)


@pytest.mark.parametrize("seed", range(8))
def test_shed_decision_matches_jax_on_random_tickets(seed):
    fields, knobs, now, candidate = _both_tickets(100 + seed)
    for mod_knobs in (knobs, dict(knobs, shed_horizon_seconds=1.0)):
        ours = policy.SchedulerPolicy(**mod_knobs).shed_decision(
            [policy.Ticket(**f) for f in fields], candidate)
        theirs = jpolicy.SchedulerPolicy(**mod_knobs).shed_decision(
            [jpolicy.Ticket(**f) for f in fields], candidate)
        assert ours == theirs


def test_policy_refusals_match_jax():
    assert policy.PRIORITY_CLASSES == jpolicy.PRIORITY_CLASSES
    assert policy.BAND_WIDTH == jpolicy.BAND_WIDTH
    for mod in (policy, jpolicy):
        with pytest.raises(ValueError, match="unknown priority 'urgent'"):
            mod.priority_base("urgent")
        with pytest.raises(ValueError, match="aging_rate must be > 0"):
            mod.SchedulerPolicy(aging_rate=0.0)


# ---------------------------------------------------------------------------
# pricing
# ---------------------------------------------------------------------------

def _peer_ledger(directory: str, store_cls) -> str:
    """Peers of JOB's config (two round counts) and of two of GRID's cells,
    and a record of another fingerprint."""
    from attackfl_tpu_torch.matrix.grid import cell_config, expand_cells, grid_from_dict

    store = store_cls(directory)
    fingerprint = config_fingerprint(config_from_dict(JOB))
    base = config_from_dict(JOB).replace(prng_impl="threefry2x32")
    cells = expand_cells(grid_from_dict(GRID))[:2]
    rows = [(fingerprint, 2.0, 4.5), (fingerprint, 4.0, 8.5), (fingerprint, 3.0, 6.5),
            ("other-fp", 99.0, 200.0)]
    rows += [(config_fingerprint(cell_config(base, c, rounds=GRID["rounds"])), 1.5, 5.0)
             for c in cells]
    for i, (fp, device, wall) in enumerate(rows):
        store.append({"ledger_schema": 1, "source": "test", "executor": "sync",
                      "fingerprint": fp, "rounds": 2, "ok_rounds": 2,
                      "round_device_time": device, "wall_seconds": wall,
                      "record_id": f"r{i}", "time_attribution": {}, "counts": {},
                      "final": {}, "ts": 1.0 + i})
    return directory


SPECS = {"run": {"config": JOB, "name": "j"}, "run-rounds": {"config": JOB, "num_rounds": 7},
         "matrix": {"type": "matrix", "config": JOB, "grid": GRID},
         "malformed": {"config": "not-a-mapping"}, "bad-grid": {"type": "matrix", "config": JOB,
                                                                "grid": {"seeds": ["x"]}}}


@pytest.mark.parametrize("ledger", ["corpus", "peers", "cold"])
@pytest.mark.parametrize("spec", list(SPECS))
def test_prices_match_jax(ledger, spec, tmp_path):
    if ledger == "corpus":
        ours_dir = theirs_dir = str(DATA / "ledger_corpus")
    elif ledger == "peers":
        ours_dir = _peer_ledger(str(tmp_path / "ours"), JaxLedgerStore)
        theirs_dir = ours_dir
    else:
        ours_dir, theirs_dir = str(tmp_path / "cold"), str(tmp_path / "cold")
    ours = JobPricer(ours_dir, default_seconds=42.0).price(SPECS[spec])
    theirs = JaxJobPricer(theirs_dir, default_seconds=42.0).price(SPECS[spec])
    assert ours == theirs
    if ledger == "peers" and spec == "run":
        assert ours["method"] == "peer" and ours["predicted_seconds"] == pytest.approx(6.0)
    if ledger == "peers" and spec == "matrix":
        assert ours["method"] == "peer_partial" and ours["predicted_cells"] == 2


def _telemetry(pkg: str, path):
    if pkg == "jax":
        return JaxTelemetry(JaxEventLog(str(path)), JaxNullTracer(), JaxCounters(), True)
    return Telemetry(EventLog(str(path)), NullTracer(), Counters(), True)


@pytest.mark.parametrize("plan", ["estimate_skew@2:count=4",
                                  "estimate_skew@1:count=3;estimate_skew@3:count=2"])
def test_skewed_prices_match_jax(plan, tmp_path):
    ledger = _peer_ledger(str(tmp_path / "peers"), JaxLedgerStore)
    out = {}
    for pkg, pricer_cls, injector_cls, parse in (
            ("jax", JaxJobPricer, JaxInjector, jax_parse_fault_plan),
            ("port", JobPricer, HostFaultInjector, parse_fault_plan)):
        tel = _telemetry(pkg, tmp_path / f"{pkg}.events.jsonl")
        pricer = pricer_cls(ledger, injector=injector_cls(parse(plan), tel))
        prices = [pricer.price(SPECS[name]) for name in ("run", "matrix", "run", "malformed")]
        tel.close()
        with open(tmp_path / f"{pkg}.events.jsonl") as fh:
            faults = [(e["fault"], e["round"], e.get("factor")) for e in map(json.loads, fh)]
        out[pkg] = (prices, faults)
    assert out["port"] == out["jax"]
    assert any("skewed_by" in p for p in out["port"][0])


# ---------------------------------------------------------------------------
# the scheduler: one history through both packages' JobScheduler
# ---------------------------------------------------------------------------

class _StubWorker:
    def __init__(self):
        self.preempted = False

    def request_preempt(self):
        self.preempted = True


class _Bench:
    """A JobScheduler of one package on that package's durable queue, a
    fake clock and stub spawn/workers."""

    def __init__(self, pkg: str, tmp_path, plan: str = "", **kw):
        self.pkg = pkg
        root = tmp_path / pkg
        root.mkdir()
        self.events_path = root / "service.events.jsonl"
        self.tel = _telemetry(pkg, self.events_path)
        queue_cls, sched_cls = (JaxJobQueue, jcore.JobScheduler) if pkg == "jax" else (
            JobQueue, core.JobScheduler)
        injector = None
        if plan:
            injector = (JaxInjector(jax_parse_fault_plan(plan), self.tel) if pkg == "jax"
                        else HostFaultInjector(parse_fault_plan(plan), self.tel))
        self.queue = queue_cls(str(root / "queue"), depth=64, telemetry=self.tel)
        self.now = 0.0
        self.workers: dict = {}
        self.spawned: list = []
        self.names: dict = {}
        kw.setdefault("slots", 1)
        kw.setdefault("default_cost_seconds", 30.0)
        # the change detection's fallback rescan runs on the wall clock:
        # every tick rescans, so the fake clock alone decides
        self.sched = sched_cls(self.queue, self.tel, str(root / "ledger"), spawn=self._spawn,
                               workers=lambda: dict(self.workers), clock=lambda: self.now,
                               injector=injector, rescan_seconds=-1.0, **kw)

    def _spawn(self, job, meta):
        self.workers[job.job_id] = _StubWorker()
        self.spawned.append((self.now, self.names[job.job_id], dict(meta, fleet_id=None)))

    def submit(self, name: str, **spec) -> str:
        job_id = self.queue.submit({"name": name, **spec})
        self.names[job_id] = name
        return job_id

    def finish(self, job_id: str) -> None:
        self.workers.pop(job_id, None)
        self.queue.mark(job_id, "done", result={})

    def requeue(self, job_id: str, **extra) -> None:
        """The worker reaching its seam after a preemption."""
        self.workers.pop(job_id, None)
        self.queue.mark(job_id, "queued", resume=True, **extra)

    def stream(self) -> list:
        """The schedule and slot events with the job ids as names, the
        fleet ids (the job id when the spec has none) dropped."""
        self.tel.close()
        with open(self.events_path) as fh:
            events = [json.loads(line) for line in fh]
        out = []
        for e in events:
            if e["kind"] not in ("schedule", "slot", "fault"):
                continue
            if self.pkg == "port":
                assert validate_event(e) == [], e
            row = {k: v for k, v in e.items() if k not in ("ts", "run_id", "schema", "fleet_id")}
            if "job_id" in row:
                row["job_id"] = self.names.get(row["job_id"], row["job_id"])
            out.append(row)
        return out


def _history_packing(b: _Bench) -> None:
    for i in range(3):
        b.submit(f"j{i}")
    for _ in range(3):
        b.sched.tick()
        (running,) = list(b.workers)
        b.now += 1.0
        b.finish(running)
    b.sched.tick()


def _history_breaker(b: _Bench) -> None:
    looper = b.submit("looper")
    b.submit("healthy")
    b.queue.mark(looper, "queued", attempts=3, resume=True, error="IndexError: boom")
    b.sched.tick()
    b.now += 1.0
    b.sched.tick()


def _history_shed(b: _Bench) -> None:
    b.sched.admit_check({"name": "a"})
    b.submit("a")
    b.sched.tick()
    for name in ("b", "c"):
        try:
            b.sched.admit_check({"name": name})
        except b.shed_error as e:
            b.sheds.append(round(e.retry_after_seconds, 6))


def _history_preempt(b: _Bench) -> None:
    low = b.submit("low", priority="low")
    b.sched.tick()
    b.now = 5.0
    high = b.submit("high", priority="high")
    b.sched.tick()
    b.requeue(low, preemptions=1, priority="low", wait_seconds=0.0)
    b.now = 6.0
    b.sched.tick()
    b.now = 9.0
    b.finish(high)
    b.sched.tick()
    b.now = 12.0
    b.finish(low)
    b.sched.tick()


def _history_storm(b: _Bench) -> None:
    jobs = [b.submit(f"j{i}") for i in range(2)]
    b.sched.tick()
    b.now = 1.0
    b.sched.tick()
    for job_id in jobs:
        b.requeue(job_id, preemptions=1)
    b.now = 2.0
    b.sched.tick()
    b.sched.tick()


def _history_starvation(b: _Bench) -> None:
    low = b.submit("starved", priority="low")
    b.submit("high-0", priority="high")
    for step in range(1, 40):
        b.sched.tick()
        if any(name == "starved" for _, name, _ in b.spawned):
            break
        b.now = step * 2.0
        for running in list(b.workers):
            b.finish(running)
        b.submit(f"high-{step}", priority="high")
    assert low in b.workers


HISTORIES = {
    "packing": (_history_packing, "", {}),
    "breaker": (_history_breaker, "", dict(breaker_attempts=3)),
    "shed": (_history_shed, "", dict(shed_horizon_seconds=100.0, default_cost_seconds=60.0)),
    "preempt": (_history_preempt, "", dict(min_runtime_seconds=2.0)),
    "storm": (_history_storm, "preempt_storm@2:count=2", dict(slots=2)),
    "starvation": (_history_starvation, "", dict(aging_rate=10.0, min_runtime_seconds=1e9)),
}


@pytest.mark.parametrize("history", list(HISTORIES))
def test_scheduler_events_match_jax(history, tmp_path):
    fn, plan, kw = HISTORIES[history]
    out = {}
    for pkg in ("jax", "port"):
        bench = _Bench(pkg, tmp_path, plan, **kw)
        bench.shed_error = jcore.OverloadShedError if pkg == "jax" else core.OverloadShedError
        bench.sheds = []
        fn(bench)
        snap = bench.sched.snapshot()
        for row in snap["jobs"]:
            row["job_id"] = bench.names.get(row["job_id"], row["job_id"])
            row.pop("fleet_id")
        states = sorted((bench.names[j.job_id], j.state, j.status.get("circuit_broken", False))
                        for j in bench.queue.jobs())
        out[pkg] = (bench.stream(), bench.spawned, bench.sheds, snap, states,
                    bench.tel.counters.snapshot())
    assert out["port"] == out["jax"]
    actions = [e["action"] for e in out["port"][0] if e.get("kind") == "schedule"]
    assert actions, history
