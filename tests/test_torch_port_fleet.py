"""The port's fleet observatory (``attackfl_tpu_torch/telemetry/fleet.py``)
against the JAX package's, on the same spools.

The inputs: a synthetic session (one slot, a low job preempted once by a
high one, both complete), the committed ``tests/data/events.v12.jsonl``'s
service events, a spool written by the port's ``RunService`` on the CPU
(two small CNNModel jobs on one slot, the low one preempted by the high
one, both done), a killed daemon's replayed stream, and the error paths.
On each, ``fleet report`` (text and ``--json``) and ``fleet trace`` give
JAX's stdout, stderr, files and exit codes, and on the port's spool every
stitching function, the merge and the skew summary equal JAX's.  While
the port's daemon lives, ``/fleet`` equals the port's functions on its
spool, ``/metrics`` carries JAX's SLO lines and ``watch --fleet --once``
prints JAX's line for the same text.
"""

import json
import os
import pathlib
import time

import pytest
from _torch_port_threads import one_torch_thread  # noqa: F401

from attackfl_tpu.telemetry import fleet as jfleet
from attackfl_tpu.telemetry import merge as jmerge
from attackfl_tpu_torch import cli
from attackfl_tpu_torch.service.daemon import RunService
from attackfl_tpu_torch.telemetry import fleet, merge

REPO = pathlib.Path(__file__).resolve().parent.parent
SERVICE_KINDS = ("service", "job", "schedule", "slot")
# a small CNNModel job: its rounds take milliseconds on the CPU
CNN = {"server": {"num-round": 2, "clients": 3, "mode": "fedavg", "model": "CNNModel",
                  "data-name": "ICU", "train-size": 64, "test-size": 64, "random-seed": 1,
                  "data-distribution": {"num-data-range": [16, 16]}},
       "learning": {"epoch": 1, "batch-size": 8}}
LOW_ROUNDS = 12


def _ev(kind, ts, **fields):
    return dict({"schema": 12, "kind": kind, "ts": ts}, **fields)


def _session_events():
    """One slot: jobA (low) preempted once by jobB (high), both complete."""
    return [
        _ev("service", 0.0, action="started", slots=1, aging_rate=1.0,
            starvation_bound_seconds=100.0, shed_horizon_seconds=0.0),
        _ev("job", 1.0, action="submitted", job_id="jobA", name="tenant-a", seq=1),
        _ev("schedule", 1.1, action="admit", job_id="jobA", priority="low",
            tenant="tenant-a", fleet_id="fa", predicted_seconds=30.0),
        _ev("slot", 2.0, action="acquire", slot=0, job_id="jobA", tenant="tenant-a",
            priority="low", fleet_id="fa"),
        _ev("schedule", 2.0, action="pack", job_id="jobA", priority="low", tenant="tenant-a",
            fleet_id="fa", slot=0, wait_seconds=1.0, preemptions=0),
        _ev("job", 3.0, action="submitted", job_id="jobB", name="tenant-b", seq=2),
        _ev("schedule", 3.1, action="admit", job_id="jobB", priority="high",
            tenant="tenant-b", fleet_id="fb", predicted_seconds=10.0),
        _ev("schedule", 4.0, action="preempt", job_id="jobA", priority="low",
            tenant="tenant-a", fleet_id="fa", reason="priority", preemptions=1),
        _ev("slot", 10.0, action="release", slot=0, job_id="jobA", tenant="tenant-a",
            priority="low", fleet_id="fa", busy_seconds=8.0, reason="preempt"),
        _ev("job", 10.0, action="requeued", job_id="jobA", reason="preempt", preemptions=1),
        _ev("slot", 10.5, action="acquire", slot=0, job_id="jobB", tenant="tenant-b",
            priority="high", fleet_id="fb"),
        _ev("schedule", 10.5, action="pack", job_id="jobB", priority="high",
            tenant="tenant-b", fleet_id="fb", slot=0, wait_seconds=7.5, preemptions=0),
        _ev("slot", 30.0, action="release", slot=0, job_id="jobB", tenant="tenant-b",
            priority="high", fleet_id="fb", busy_seconds=19.5, reason="done"),
        _ev("job", 30.0, action="completed", job_id="jobB"),
        _ev("slot", 31.0, action="acquire", slot=0, job_id="jobA", tenant="tenant-a",
            priority="low", fleet_id="fa"),
        _ev("schedule", 31.0, action="resume", job_id="jobA", priority="low",
            tenant="tenant-a", fleet_id="fa", slot=0, wait_seconds=22.0, preemptions=1),
        _ev("slot", 95.0, action="release", slot=0, job_id="jobA", tenant="tenant-a",
            priority="low", fleet_id="fa", busy_seconds=64.0, reason="done"),
        _ev("job", 95.0, action="completed", job_id="jobA"),
        _ev("service", 100.0, action="stopped"),
    ]


def _killed_session_events():
    """A daemon killed while jobK holds slot 0, restarted: the replay
    requeues jobK and the new daemon acquires slot 0 for it again."""
    return [
        _ev("service", 0.0, action="started", slots=1, starvation_bound_seconds=100.0),
        _ev("job", 1.0, action="submitted", job_id="jobK", name="killed", seq=1),
        _ev("schedule", 1.5, action="admit", job_id="jobK", priority="normal",
            tenant="killed", fleet_id="fk", predicted_seconds=30.0),
        _ev("slot", 2.0, action="acquire", slot=0, job_id="jobK", tenant="killed",
            priority="normal", fleet_id="fk"),
        _ev("schedule", 2.0, action="pack", job_id="jobK", priority="normal", tenant="killed",
            fleet_id="fk", slot=0, wait_seconds=1.0, preemptions=0),
        # kill -9 at 20: no release, no stopped
        _ev("service", 21.0, action="started", slots=1, starvation_bound_seconds=100.0),
        _ev("job", 21.0, action="requeued", job_id="jobK", reason="interrupted"),
        _ev("slot", 22.0, action="acquire", slot=0, job_id="jobK", tenant="killed",
            priority="normal", fleet_id="fk"),
        _ev("schedule", 22.0, action="resume", job_id="jobK", priority="normal",
            tenant="killed", fleet_id="fk", slot=0, wait_seconds=2.0, preemptions=0),
        _ev("slot", 40.0, action="release", slot=0, job_id="jobK", tenant="killed",
            priority="normal", fleet_id="fk", busy_seconds=18.0, reason="done"),
        _ev("job", 40.0, action="completed", job_id="jobK"),
        _ev("service", 50.0, action="stopped"),
    ]


def _write_jsonl(path, events, tail: str = "") -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as fh:
        for event in events:
            fh.write(json.dumps(event) + "\n")
        fh.write(tail)


def _synthetic_spool(root) -> str:
    spool = root / "synthetic"
    _write_jsonl(spool / "service.events.jsonl", _session_events())
    _write_jsonl(spool / "jobs" / "jobA" / "events.jsonl", [
        _ev("chunk", 6.0, seconds=3.5, chunk_len=4, includes_compile=True),
        _ev("round", 9.0, seconds=1.0, round=5, ok=True)])
    _write_jsonl(spool / "jobs" / "jobB" / "events.jsonl", [
        _ev("round", 15.0, seconds=1.0, round=1, ok=True)])
    return str(spool)


def _v12_spool(root) -> str:
    """The committed v12 corpus's service events as a spool's stream."""
    spool = root / "v12"
    with open(REPO / "tests" / "data" / "events.v12.jsonl") as fh:
        events = [json.loads(line) for line in fh]
    _write_jsonl(spool / "service.events.jsonl",
                 [e for e in events if e["kind"] in SERVICE_KINDS])
    return str(spool)


def _wait_for(predicate, timeout: float = 120.0, message: str = "condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        value = predicate()
        if value:
            return value
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {message}")


def _events_of(path) -> list:
    with open(path) as fh:
        return [json.loads(line) for line in fh]


def _job_config(rounds: int) -> dict:
    raw = json.loads(json.dumps(CNN))
    raw["server"]["num-round"] = rounds
    return raw


@pytest.fixture(scope="module")
def port_spool(tmp_path_factory):
    """The port's RunService on the CPU, one slot, the scheduler on: a low
    CNNModel job preempted by a high one after its first checkpoint, both
    done.  While the daemon lives: /fleet, the port's functions on the
    spool at that moment, /metrics, and JAX's metrics_text over the same
    service.  Returns the spool and what was read live."""
    from attackfl_tpu.service.daemon import RunService as JaxRunService

    root = tmp_path_factory.mktemp("fleet")
    service = RunService(str(root / "spool"), device="cpu", port=0, max_workers=1,
                         poll_interval=0.02, worker_backoff=0.01, worker_backoff_cap=0.05,
                         sched_min_runtime=0.0)
    service.start()
    live = {}
    try:
        low = service.submit({"config": _job_config(LOW_ROUNDS), "name": "low",
                              "priority": "low"})
        _wait_for((pathlib.Path(service.spool) / "jobs" / low / "manifest.json").exists,
                  message="low's first checkpoint")
        high = service.submit({"config": _job_config(2), "name": "high", "priority": "high"})
        for job_id in (low, high):
            _wait_for(lambda j=job_id: (service.queue.get(j) is not None
                                        and service.queue.get(j).state == "done"),
                      message=f"{job_id} to end")
        # the completed events and the slot releases follow the status
        # writes: wait for all of them before reading the live surfaces
        path = os.path.join(service.spool, "service.events.jsonl")
        _wait_for(lambda: not service._workers and sum(
            e["kind"] == "job" and e["action"] == "completed" for e in _events_of(path)) == 2
            and sum(e["kind"] == "slot" and e["action"] == "release"
                    for e in _events_of(path)) == 3, message="the releases")
        base = f"http://127.0.0.1:{service.port}"
        live["fleet"] = cli._http_get_json(base + "/fleet")
        events = fleet.load_service_events(service.spool)
        live["fleet_functions"] = {
            "slo": fleet.slo_report(events),
            "ledger": fleet.device_time_ledger(service.spool, events=events)}
        live["metrics"] = cli._http_get_text(base + "/metrics")
        live["jax_metrics"] = JaxRunService.metrics_text(service)
        live["jobs"] = {"low": low, "high": high}
    finally:
        service.drain(timeout=30)
        service.close()
    return service.spool, live


def _spool(name: str, tmp_path, port_spool) -> str:
    if name == "port":
        return port_spool[0]
    return {"synthetic": _synthetic_spool, "v12": _v12_spool}[name](tmp_path)


def _both(capsys, argv: list) -> tuple:
    """``fleet <argv>`` through the port's command line and JAX's main:
    (exit code, stdout, stderr) of each."""
    rc = cli.main(["fleet", *argv])
    ours = capsys.readouterr()
    jrc = jfleet.main(argv)
    theirs = capsys.readouterr()
    return (rc, ours.out, ours.err), (jrc, theirs.out, theirs.err)


# ---------------------------------------------------------------------------
# the command line on each spool
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spool_name", ["synthetic", "v12", "port"])
@pytest.mark.parametrize("flags", [[], ["--json"]])
def test_fleet_report_prints_jaxs(spool_name, flags, tmp_path, port_spool, capsys):
    spool = _spool(spool_name, tmp_path, port_spool)
    ours, theirs = _both(capsys, ["report", spool, *flags])
    assert ours == theirs and ours[0] == 0
    if flags:
        payload = json.loads(ours[1])
        assert payload["ledger"]["books_close"] is True
        assert payload["slo"]["preemptions"] >= 1
    else:
        assert "CLOSED" in ours[1] and "p95" in ours[1]


@pytest.mark.parametrize("spool_name", ["synthetic", "v12", "port"])
def test_fleet_trace_writes_jaxs(spool_name, tmp_path, port_spool, capsys):
    spool = _spool(spool_name, tmp_path, port_spool)
    out = str(tmp_path / "fleet.trace.json")
    rc = cli.main(["fleet", "trace", spool, "--out", out])
    ours = capsys.readouterr()
    with open(out) as fh:
        mine = fh.read()
    jrc = jfleet.main(["trace", spool, "--out", out])
    theirs = capsys.readouterr()
    with open(out) as fh:
        assert fh.read() == mine
    assert (rc, ours.out, ours.err) == (jrc, theirs.out, theirs.err) and rc == 0
    events = json.loads(mine)["traceEvents"]
    names = {e["name"] for e in events if e["ph"] == "X"}
    assert {"queue-wait", "preempted", "run", "run (resumed)"} <= names


def test_fleet_trace_default_path_and_error_paths(tmp_path, capsys):
    """The default output path, a directory with no stream, a stream with
    no timestamps and a torn line: JAX's stdout, stderr and exit codes."""
    spool = _synthetic_spool(tmp_path)
    ours, theirs = _both(capsys, ["trace", spool])
    assert ours == theirs and ours[0] == 0
    assert os.path.exists(os.path.join(spool, "fleet.trace.json"))
    empty = tmp_path / "empty"
    empty.mkdir()
    for command in ("report", "trace"):
        ours, theirs = _both(capsys, [command, str(empty)])
        assert ours == theirs and ours[0] == 2 and "not a service spool" in ours[2]
    untimed = tmp_path / "untimed"
    _write_jsonl(untimed / "service.events.jsonl",
                 [{"kind": "service", "action": "started"}, {"kind": "job", "job_id": "x"}])
    for command in ("report", "trace"):
        ours, theirs = _both(capsys, [command, str(untimed)])
        assert ours == theirs and ours[0] == 2 and "no timestamped events" in ours[2]
    torn = tmp_path / "torn"
    _write_jsonl(torn / "service.events.jsonl", _session_events()[:-1],
                 tail='{"schema": 12, "kind": "service", "ts": 100.0, "act')
    for flags in ([], ["--json"]):
        ours, theirs = _both(capsys, ["report", str(torn), *flags])
        assert ours == theirs and ours[0] == 0
    assert fleet.load_service_events(str(torn)) == jfleet.load_service_events(str(torn))


# ---------------------------------------------------------------------------
# the functions on the port's spool
# ---------------------------------------------------------------------------

def test_port_spool_through_jaxs_functions(port_spool):
    spool, live = port_spool
    events = fleet.load_service_events(spool)
    assert events == jfleet.load_service_events(spool)
    assert fleet.job_timelines(events) == jfleet.job_timelines(events)
    assert fleet.slot_spans(events) == jfleet.slot_spans(events)
    assert fleet.slot_spans(events, until_ts=events[-1]["ts"] + 5) == jfleet.slot_spans(
        events, until_ts=events[-1]["ts"] + 5)
    ledger = fleet.device_time_ledger(spool)
    assert ledger == jfleet.device_time_ledger(spool)
    assert fleet.slo_report(events) == jfleet.slo_report(events)
    assert fleet.fleet_trace(spool) == jfleet.fleet_trace(spool)
    merged, sources = merge.merge_events(spool)
    assert (merged, sources) == jmerge.merge_events(spool)
    assert merge.skew_summary(merged) == jmerge.skew_summary(merged)
    # the books close; both jobs ran, the low one preempted
    assert ledger["books_close"] is True and ledger["slots"] == 1
    rows = {row["job_id"]: row for row in ledger["jobs"]}
    low, high = live["jobs"]["low"], live["jobs"]["high"]
    assert set(rows) == {low, high}
    assert rows[low]["preemptions"] >= 1 and rows[low]["priority"] == "low"
    assert {row["end_action"] for row in rows.values()} == {"completed"}
    assert all(row["prediction_error_factor"] is not None for row in rows.values())
    assert set(sources) == {merge.SERVICE_KEY, low, high}


# ---------------------------------------------------------------------------
# the live surfaces
# ---------------------------------------------------------------------------

def test_live_fleet_route_equals_the_functions(port_spool):
    _, live = port_spool
    code, payload = live["fleet"]
    assert code == 200 and "error" not in payload
    assert payload == json.loads(json.dumps(live["fleet_functions"]))
    assert payload["slo"]["preemption_rate"] > 0


def test_live_metrics_carry_jaxs_slo_lines(port_spool):
    """The port's /metrics is JAX's exposition over the same service, SLO
    gauges included, with the kernels' launch counts beside it."""
    _, live = port_spool
    code, text = live["metrics"]
    assert code == 200
    kernel_lines = [line for line in text.splitlines()
                    if "attackfl_kernel_launches_total" in line]
    assert len(kernel_lines) == 3
    rest = [line for line in text.splitlines() if line not in kernel_lines]
    assert rest == live["jax_metrics"].splitlines()
    slo = [line for line in rest if line.startswith("attackfl_slo_")]
    assert [line.split(" ")[0] for line in slo] == [
        'attackfl_slo_queue_wait_p95_seconds{priority="high"}',
        'attackfl_slo_queue_wait_p95_seconds{priority="low"}',
        "attackfl_slo_preemption_rate", "attackfl_slo_shed_rate",
        "attackfl_slo_starvation_bound_margin_seconds"]


@pytest.mark.parametrize("source", ["port", "synthetic"])
def test_watch_fleet_once_prints_jaxs_line(source, port_spool, monkeypatch, capsys):
    """``watch --fleet --once`` on the same /metrics text through a patched
    ``_http_get_text``: the port's line is JAX's."""
    import attackfl_tpu.cli as jcli

    if source == "port":
        text = port_spool[1]["metrics"][1]
    else:
        text = ("# TYPE attackfl_sched_queue_depth gauge\nattackfl_sched_queue_depth 3\n"
                'attackfl_slo_queue_wait_p95_seconds{priority="normal"} 1.25\n'
                'attackfl_slo_queue_wait_p95_seconds{priority="high"} 0.5\n'
                "attackfl_slo_shed_rate 0.25\nattackfl_bogus not-a-number\n")
    seen = []

    def fake(url, timeout=5.0):
        seen.append(url)
        return 200, text

    monkeypatch.setattr(cli, "_http_get_text", fake)
    monkeypatch.setattr(jcli, "_http_get_text", fake)
    url = "http://127.0.0.1:1/"
    assert cli.main(["watch", url, "--fleet", "--once"]) == 0
    ours = capsys.readouterr()
    assert jcli.watch_main([url, "--fleet", "--once"]) == 0
    theirs = capsys.readouterr()
    assert (ours.out, ours.err) == (theirs.out, theirs.err)
    assert seen == ["http://127.0.0.1:1/metrics"] * 2
    assert ours.out.startswith("[watch] fleet queue=") and "slo: p95[" in ours.out


def test_watch_fleet_unreachable_exits_2_as_jaxs(capsys):
    import attackfl_tpu.cli as jcli

    rc = cli.main(["watch", "http://127.0.0.1:9", "--fleet", "--once"])
    ours = capsys.readouterr()
    jrc = jcli.watch_main(["http://127.0.0.1:9", "--fleet", "--once"])
    theirs = capsys.readouterr()
    assert rc == jrc == 2 and ours.err == theirs.err and "unreachable" in ours.err


# ---------------------------------------------------------------------------
# a fault of the reference, replicated
# ---------------------------------------------------------------------------

def test_killed_session_drops_the_first_span_as_jaxs(tmp_path):
    """A job acquired again on its slot after a kill -9 and replay: the
    ``(slot, job_id)`` key overwrites its open span, so the killed run's
    18 s on the slot are billed as idle, as the JAX package bills them
    (attackfl_tpu/telemetry/fleet.py:164-171).  The books still close."""
    spool = tmp_path / "killed"
    _write_jsonl(spool / "service.events.jsonl", _killed_session_events())
    events = fleet.load_service_events(str(spool))
    spans = fleet.slot_spans(events)
    assert spans == jfleet.slot_spans(events)
    assert [(s["start_ts"], s["end_ts"]) for s in spans] == [(22.0, 40.0)]
    ledger = fleet.device_time_ledger(str(spool))
    assert ledger == jfleet.device_time_ledger(str(spool))
    assert ledger["books_close"] is True and ledger["identity_error_pct"] == 0.0
    assert ledger["busy_seconds_total"] == 18.0 and ledger["idle_seconds_total"] == 32.0
    row = ledger["jobs"][0]
    # ran 2-21 and 22-40 (37 s), billed 18 s
    assert row["job_id"] == "jobK" and row["busy_seconds"] == 18.0
    assert row["end_action"] == "completed"


def _drained_sessions_events():
    """Two sessions of one spool: the first drained after jobP ended but
    before the scheduler's tick released its slot (the drain stops the
    ticks), the second running jobQ on the same slot."""
    return [
        _ev("service", 0.0, action="started", slots=1, starvation_bound_seconds=100.0),
        _ev("job", 0.5, action="submitted", job_id="jobP", name="first", seq=1),
        _ev("schedule", 0.6, action="admit", job_id="jobP", priority="normal",
            tenant="first", fleet_id="fp", predicted_seconds=30.0),
        _ev("slot", 1.0, action="acquire", slot=0, job_id="jobP", tenant="first",
            priority="normal", fleet_id="fp"),
        _ev("schedule", 1.0, action="pack", job_id="jobP", priority="normal", tenant="first",
            fleet_id="fp", slot=0, wait_seconds=0.4, preemptions=0),
        _ev("job", 10.0, action="completed", job_id="jobP"),
        _ev("service", 10.01, action="draining"),
        _ev("service", 10.02, action="drained", clean=True),
        _ev("service", 10.03, action="stopped"),
        _ev("service", 11.0, action="started", slots=1, starvation_bound_seconds=100.0),
        _ev("job", 11.5, action="submitted", job_id="jobQ", name="second", seq=2),
        _ev("schedule", 11.6, action="admit", job_id="jobQ", priority="normal",
            tenant="second", fleet_id="fq", predicted_seconds=30.0),
        _ev("slot", 12.0, action="acquire", slot=0, job_id="jobQ", tenant="second",
            priority="normal", fleet_id="fq"),
        _ev("schedule", 12.0, action="pack", job_id="jobQ", priority="normal",
            tenant="second", fleet_id="fq", slot=0, wait_seconds=0.4, preemptions=0),
        _ev("slot", 20.0, action="release", slot=0, job_id="jobQ", tenant="second",
            priority="normal", fleet_id="fq", busy_seconds=8.0, reason="done"),
        _ev("job", 20.0, action="completed", job_id="jobQ"),
        _ev("service", 21.0, action="stopped"),
    ]


def test_unreleased_span_of_a_drained_session_spans_the_next_as_jaxs(tmp_path):
    """A session drained before its last job's slot release: the open span
    is closed at the stream's last stop, across the next session of the
    spool, as the JAX package closes it (attackfl_tpu/telemetry/fleet.py:
    192-196; the drain stops the ticks that release, attackfl_tpu/service/
    daemon.py:181-184).  jobQ's 8 s on the slot are billed twice, so the
    books do not close."""
    spool = tmp_path / "drained"
    _write_jsonl(spool / "service.events.jsonl", _drained_sessions_events())
    events = fleet.load_service_events(str(spool))
    spans = fleet.slot_spans(events, until_ts=21.0)
    assert spans == jfleet.slot_spans(events, until_ts=21.0)
    assert [(s["job_id"], s["start_ts"], s["end_ts"], s["reason"]) for s in spans] == [
        ("jobP", 1.0, 21.0, "open"), ("jobQ", 12.0, 20.0, "done")]
    ledger = fleet.device_time_ledger(str(spool))
    assert ledger == jfleet.device_time_ledger(str(spool))
    assert ledger["busy_seconds_total"] == 28.0 and ledger["idle_seconds_total"] == 1.0
    assert ledger["identity_error_pct"] == 38.095 and ledger["books_close"] is False
    assert {r["job_id"]: r["busy_seconds"] for r in ledger["jobs"]} == {"jobP": 20.0,
                                                                       "jobQ": 8.0}
