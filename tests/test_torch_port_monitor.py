"""The port's live monitor (``attackfl_tpu_torch/telemetry/monitor.py``),
its ``monitor_stall`` seam and the ``metrics`` and ``watch`` commands,
against the JAX package's, on the CPU.

1. The JAX package's ``tests/test_monitor.py`` cases on the port's
   ``RunMonitor``: the endpoints of a healthy run, a stall detected and
   cleared, the grace window, the watchdog disarmed outside runs, the
   degraded state, the depth and numerics gauges; after the same calls
   the port's ``metrics_text``, ``health`` and ``last_round`` equal those
   of JAX's monitor (the stall's seconds aside).
2. The engine: a run with the monitor on serves ``/healthz``,
   ``/metrics`` and ``/last-round`` and records its port in the run
   header; telemetry off builds no monitor; ``monitor_stall`` fires a
   ``stall`` event and a 503 under ``run``, ``run_fast`` and the
   pipeline, cleared by the next round; the pipeline's depth gauge
   follows a demotion and a re-promotion.
3. ``python -m attackfl_tpu_torch watch --once`` prints what JAX's prints
   on the same monitor, with its exit codes; ``metrics`` (plain,
   ``--numerics``, ``--forensics``, ``--json``) prints what JAX's prints on
   the same ``events.jsonl``; ``--merge`` is refused with its item and
   ``--programs`` prints what JAX's prints on a run with the cost model
   on; ``run --numerics --monitor-port 0`` runs.
"""

import json
import time
import urllib.error
import urllib.request

import pytest
from _torch_port_threads import one_torch_thread  # noqa: F401

from attackfl_tpu import cli as jcli
from attackfl_tpu.telemetry import Counters as JaxCounters
from attackfl_tpu.telemetry import EventLog as JaxEventLog
from attackfl_tpu.telemetry import NullTracer as JaxNullTracer
from attackfl_tpu.telemetry import Telemetry as JaxTelemetry
from attackfl_tpu.telemetry import summary as jsummary
from attackfl_tpu.telemetry.monitor import RunMonitor as JaxRunMonitor
from attackfl_tpu_torch import cli
from attackfl_tpu_torch.config import AttackSpec, Config, TelemetryConfig
from attackfl_tpu_torch.faults.plan import parse_fault_plan
from attackfl_tpu_torch.telemetry import summary
from attackfl_tpu_torch.telemetry.core import Telemetry
from attackfl_tpu_torch.telemetry.counters import Counters
from attackfl_tpu_torch.telemetry.events import EventLog, validate_event
from attackfl_tpu_torch.telemetry.monitor import MIN_STALL_SECONDS, RunMonitor
from attackfl_tpu_torch.telemetry.trace import NullTracer
from attackfl_tpu_torch.training.engine import Simulator
from test_torch_port_cli_server import _yaml

# a cut of test_torch_port_fused_rounds.py's size: 2 LIE attackers
TINY = dict(num_round=3, total_clients=6, mode="fedavg", model="TransformerModel",
            data_name="ICU", num_data_range=(16, 24), epochs=1, batch_size=16,
            train_size=128, test_size=64, local_backend="xla",
            attacks=(AttackSpec(mode="LIE", num_clients=2, attack_round=2),))


def make_pair(tmp_path):
    """The port's monitor and JAX's, each on its own event log."""
    ours = RunMonitor(Telemetry(EventLog(str(tmp_path / "events.jsonl")), NullTracer(),
                                Counters(), True, base_dir=str(tmp_path)),
                      port=0, poll_interval=3600)
    theirs = JaxRunMonitor(JaxTelemetry(JaxEventLog(str(tmp_path / "jax.jsonl")),
                                        JaxNullTracer(), JaxCounters(), True,
                                        base_dir=str(tmp_path)),
                           port=0, poll_interval=3600)
    return ours, theirs


def get(port: int, path: str) -> tuple[int, bytes]:
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=5) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:  # 503 arrives as an exception
        return e.code, e.read()


def _events(path) -> list:
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def _same(ours, theirs, call) -> None:
    """Make ``call`` on both monitors; their payloads then agree."""
    call(ours)
    call(theirs)
    assert ours.metrics_text() == theirs.metrics_text()
    code, health = ours.health()
    jcode, jhealth = theirs.health()
    aside = ("seconds_since_round",)
    assert code == jcode
    assert {k: v for k, v in health.items() if k not in aside} == \
        {k: v for k, v in jhealth.items() if k not in aside}
    assert ours.last_round() == theirs.last_round()


@pytest.fixture()
def monitor(tmp_path):
    mon = RunMonitor(Telemetry(EventLog(str(tmp_path / "events.jsonl")), NullTracer(),
                               Counters(), True, base_dir=str(tmp_path)),
                     port=0, poll_interval=3600)  # ticks driven by the tests
    mon.start()
    yield mon
    mon.stop()


# ---------------------------------------------------------------------------
# 1. the monitor against JAX's
# ---------------------------------------------------------------------------


def test_endpoints_healthy_run(monitor):
    monitor.run_started()
    for rnd in range(1, 4):
        monitor.record_round({"round": rnd, "broadcast": rnd, "ok": True, "seconds": 0.1,
                              "roc_auc": 0.9, "phases": {"train": 0.08, "validate": 0.01}})
    code, body = get(monitor.port, "/healthz")
    assert code == 200 and json.loads(body)["status"] == "ok"
    assert json.loads(body)["rounds_completed"] == 3
    code, body = get(monitor.port, "/metrics")
    text = body.decode()
    assert code == 200
    assert "attackfl_rounds_completed 3" in text
    assert "attackfl_stalled 0" in text
    assert 'attackfl_last_round_phase_seconds{phase="train"} 0.08' in text
    assert "attackfl_round_seconds_median 0.1" in text
    code, body = get(monitor.port, "/last-round")
    last = json.loads(body)
    assert code == 200 and last["round"] == 3 and last["roc_auc"] == 0.9
    assert get(monitor.port, "/runs") == (200, b'{"ledger": null, "records": []}')
    code, body = get(monitor.port, "/programs")
    assert code == 200 and json.loads(body) == {
        "programs": {}, "device_kind": "", "round_seconds_median": 0.1, "utilization": None}
    assert get(monitor.port, "/hotspots") == (200, b'{"windows": {}}')
    assert get(monitor.port, "/nonsense")[0] == 404


def test_stall_detected_and_cleared(monitor, tmp_path):
    monitor.run_started()
    for rnd in range(1, 5):
        monitor.record_round({"round": rnd, "broadcast": rnd, "ok": True, "seconds": 0.1})
    assert monitor.stall_threshold_seconds() == MIN_STALL_SECONDS
    now = time.monotonic()
    assert monitor.check_stall(now=now) is False
    assert get(monitor.port, "/healthz")[0] == 200
    hang = now + MIN_STALL_SECONDS + 1.0
    assert monitor.check_stall(now=hang) is True
    code, body = get(monitor.port, "/healthz")
    assert code == 503
    payload = json.loads(body)
    assert payload["status"] == "stalled" and payload["rounds_completed"] == 4
    assert "attackfl_stalled 1" in get(monitor.port, "/metrics")[1].decode()
    # one stall event a transition, through the lock-serialised event log
    monitor.check_stall(now=hang + 1.0)
    stalls = [e for e in _events(tmp_path / "events.jsonl") if e.get("kind") == "stall"]
    assert len(stalls) == 1 and not validate_event(stalls[0])
    assert stalls[0]["rounds_completed"] == 4
    assert stalls[0]["seconds_since_round"] > stalls[0]["threshold_seconds"]
    assert monitor._tel.counters.get("stalls_detected") == 1
    monitor.record_round({"round": 5, "broadcast": 5, "ok": True, "seconds": 0.1})
    assert get(monitor.port, "/healthz")[0] == 200


def test_grace_window_and_disarmed_outside_runs(monitor):
    assert monitor.check_stall(now=time.monotonic() + 1e6) is False  # never armed
    monitor.run_started()
    assert monitor.stall_threshold_seconds() == monitor.stall_grace_seconds
    beat = time.monotonic()
    assert monitor.check_stall(now=beat + monitor.stall_grace_seconds - 1) is False
    assert monitor.check_stall(now=beat + monitor.stall_grace_seconds + 1) is True
    monitor.record_round({"round": 1, "broadcast": 1, "ok": True, "seconds": 0.1})
    monitor.run_ended()  # a finished run is not a stalled one
    assert monitor.check_stall(now=time.monotonic() + 1e6) is False


def test_payloads_equal_jaxs_after_the_same_calls(tmp_path):
    ours, theirs = make_pair(tmp_path)
    _same(ours, theirs, lambda m: m.run_started())
    for rnd in range(1, 4):
        _same(ours, theirs, lambda m: m.record_round(
            {"round": rnd, "broadcast": rnd, "ok": True, "seconds": 0.1 * rnd,
             "roc_auc": 0.9, "phases": {"train": 0.08, "numerics": 0.002}}))
    _same(ours, theirs, lambda m: m._tel.counters.inc("rounds_failed", 2))
    _same(ours, theirs, lambda m: m.update_numerics(
        {"update_norm_all_p95": 2.5, "nonfinite_count": 0.0, "sep_margin": None,
         "broadcast": 3.0}))
    _same(ours, theirs, lambda m: m.set_pipeline_depth(3))
    _same(ours, theirs, lambda m: m.set_degraded(
        {"round": 4, "consecutive_failures": 2, "depth": 0, "configured_depth": 3}))
    _same(ours, theirs, lambda m: m.set_pipeline_depth(0))
    _same(ours, theirs, lambda m: m.simulate_hang())   # stalled beats degraded
    assert ours.health()[0] == 503
    _same(ours, theirs, lambda m: m.record_round({"round": 4, "broadcast": 5, "ok": False,
                                                  "seconds": 0.2}))
    _same(ours, theirs, lambda m: m.set_degraded(None))
    _same(ours, theirs, lambda m: m.run_ended())
    text = ours.metrics_text()
    assert 'attackfl_numerics{name="update_norm_all_p95"} 2.5' in text
    assert "sep_margin" not in text and "attackfl_pipeline_depth 0" in text
    assert ours.last_round()["numerics"] == {"update_norm_all_p95": 2.5,
                                             "nonfinite_count": 0.0, "broadcast": 3.0}
    assert [e["kind"] for e in _events(tmp_path / "events.jsonl")] == \
        [e["kind"] for e in _events(tmp_path / "jax.jsonl")] == ["stall"]


# ---------------------------------------------------------------------------
# 2. the engine's seams
# ---------------------------------------------------------------------------


def test_engine_monitor_integration(tmp_path, monkeypatch):
    monkeypatch.setenv("ATTACKFL_TELEMETRY_DIR", str(tmp_path))
    cfg = Config(**TINY, log_path=str(tmp_path),
                 telemetry=TelemetryConfig(monitor=True, monitor_port=0, numerics=True))
    sim = Simulator(cfg, device="cpu")
    assert sim.monitor is not None and sim.monitor.port is None  # bound at the run
    try:
        _, history = sim.run(save_checkpoints=False, verbose=False)
        assert all(h["ok"] for h in history)
        code, body = get(sim.monitor.port, "/healthz")
        assert code == 200 and json.loads(body)["rounds_completed"] == 3
        last = json.loads(get(sim.monitor.port, "/last-round")[1])
        # the drainer's latest gauges (the window of 16 drains at the end)
        assert last["round"] == 3 and last["numerics"]["broadcast"] == 3.0
        text = get(sim.monitor.port, "/metrics")[1].decode()
        assert "attackfl_rounds_completed 3" in text
        assert 'attackfl_numerics{name="update_norm_all_p95"}' in text
        assert 'attackfl_last_round_phase_seconds{phase="numerics"}' in text
        assert "attackfl_pipeline_depth" not in text
        runs = json.loads(get(sim.monitor.port, "/runs")[1])
        assert runs["count"] == 1 and runs["records"][0]["executor"] == "sync"
        port = sim.monitor.port
    finally:
        sim.close()
    events = _events(tmp_path / "events.jsonl")
    assert events[0]["monitor_port"] == port
    assert not [e for e in events if e["kind"] == "stall"]
    with pytest.raises(OSError):
        urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=2)


def test_disabled_telemetry_has_no_monitor(tmp_path, monkeypatch):
    monkeypatch.setenv("ATTACKFL_TELEMETRY_DIR", str(tmp_path))
    cfg = Config(**TINY, log_path=str(tmp_path), telemetry=TelemetryConfig(
        enabled=False, monitor=True, monitor_port=0, numerics=True))
    sim = Simulator(cfg, device="cpu")
    assert sim.monitor is None and sim._numerics is None
    _, history = sim.run(num_rounds=1, save_checkpoints=False, verbose=False)
    assert history[0]["ok"]
    assert {p.name for p in tmp_path.iterdir()} <= {"app.log"}


@pytest.mark.parametrize("how", ["run", "run_fast", "pipeline"])
def test_monitor_stall_through_the_engine(how, tmp_path, monkeypatch):
    """``monitor_stall@2``: right after round 2 resolves the watchdog has
    fired (503, one ``stall`` event, ``stalls_detected`` 1, the fault
    event); round 2's heartbeat then clears it."""
    monkeypatch.setenv("ATTACKFL_TELEMETRY_DIR", str(tmp_path))
    cfg = Config(**TINY, log_path=str(tmp_path), pipeline=how == "pipeline",
                 pipeline_depth=1, faults=parse_fault_plan("monitor_stall@2"),
                 telemetry=TelemetryConfig(monitor=True, monitor_port=0))
    sim = Simulator(cfg, device="cpu")
    seen = []
    real = sim.fault_injector.maybe_stall_monitor

    def observed(round_no, monitor):
        real(round_no, monitor)
        seen.append((round_no, get(monitor.port, "/healthz")[0]))

    sim.fault_injector.maybe_stall_monitor = observed
    try:
        if how == "run_fast":
            sim.run_fast(chunk_size=1, save_checkpoints=False, verbose=False)
        else:
            sim.run(save_checkpoints=False, verbose=False)
        assert get(sim.monitor.port, "/healthz")[0] == 200
    finally:
        sim.close()
    assert seen == [(1, 200), (2, 503), (3, 200)]
    events = _events(tmp_path / "events.jsonl")
    stalls = [e for e in events if e["kind"] == "stall"]
    assert len(stalls) == 1 and stalls[0]["rounds_completed"] == 1
    faults = [e for e in events if e["kind"] == "fault"]
    assert [(e["fault"], e["round"]) for e in faults] == [("monitor_stall", 2)]
    assert sim.telemetry.counters.get("stalls_detected") == 1


def test_pipeline_depth_gauge_follows_demotion(tmp_path, monkeypatch):
    monkeypatch.setenv("ATTACKFL_TELEMETRY_DIR", str(tmp_path))
    cfg = Config(**{**TINY, "num_round": 4}, log_path=str(tmp_path), pipeline=True,
                 pipeline_depth=2, pipeline_demote_after=2, pipeline_repromote_after=2,
                 faults=parse_fault_plan("nan_storm@2;nan_storm@3"),
                 telemetry=TelemetryConfig(monitor=True, monitor_port=0))
    sim = Simulator(cfg, device="cpu")
    depths = []
    real = sim.monitor.record_round

    def record(metrics, duration=None):
        real(metrics, duration)
        depths.append((metrics["broadcast"], sim.monitor.last_round()["pipeline_depth"],
                       sim.monitor.health()[1]["status"]))

    sim.monitor.record_round = record
    try:
        sim.run(save_checkpoints=False, verbose=False)
        assert "attackfl_pipeline_depth 2" in get(sim.monitor.port, "/metrics")[1].decode()
    finally:
        sim.close()
    # each round's heartbeat comes before the transition it causes (JAX
    # engine.py:2549-2623): broadcast 3's rollback demotes, broadcast 5's
    # second clean round re-promotes
    assert depths == [(1, 2, "ok"), (2, 2, "ok"), (3, 2, "ok"), (4, 0, "degraded"),
                      (5, 0, "degraded"), (6, 2, "ok")]


# ---------------------------------------------------------------------------
# 3. watch and metrics
# ---------------------------------------------------------------------------


def _both_watch(url: str, capsys) -> tuple:
    rc = cli.main(["watch", url, "--once"])
    ours = capsys.readouterr()
    jrc = jcli.watch_main([url, "--once"])
    theirs = capsys.readouterr()
    assert (rc, ours.out) == (jrc, theirs.out)
    return rc, ours.out


def test_watch_once_prints_jaxs_lines(monitor, capsys):
    url = f"http://127.0.0.1:{monitor.port}"
    monitor.run_started()
    monitor.record_round({"round": 7, "broadcast": 7, "ok": True, "seconds": 0.1,
                          "roc_auc": 0.88})
    monitor.update_numerics({"update_norm_all_p95": 2.51, "nonfinite_count": 0.0,
                             "sep_margin": -0.12})
    monitor.set_pipeline_depth(2)
    rc, out = _both_watch(url, capsys)
    assert rc == 0 and "round 7" in out and "roc_auc=0.8800" in out
    assert "unorm_p95=2.51" in out and "nonfinite=0" in out and "sep=-0.12" in out
    assert "depth=2" in out
    monitor.set_degraded({"round": 7, "consecutive_failures": 3, "depth": 0,
                          "configured_depth": 2})
    monitor.set_pipeline_depth(0)
    rc, out = _both_watch(url, capsys)
    assert rc == 0 and "DEGRADED" in out and "depth 0" in out and "configured 2" in out
    monitor.check_stall(now=time.monotonic() + monitor.stall_grace_seconds + 1)
    rc, out = _both_watch(url, capsys)
    assert rc == 1 and "STALL detected" in out
    assert cli.main(["watch", "http://127.0.0.1:9", "--once"]) == 2
    # --fleet reads /metrics' scheduler and SLO gauges: a run monitor has
    # none, so JAX's line reads zeros and no `slo:` part
    capsys.readouterr()
    rc = cli.main(["watch", url, "--once", "--fleet"])
    ours = capsys.readouterr()
    jrc = jcli.watch_main([url, "--once", "--fleet"])
    theirs = capsys.readouterr()
    assert (rc, ours.out, ours.err) == (jrc, theirs.out, theirs.err)
    assert rc == 0 and ours.out == ("[watch] fleet queue=0 running=0 backlog=0.0s "
                                    "preempted=0 shed=0\n")


@pytest.fixture(scope="module")
def defended_run(tmp_path_factory):
    """Two runs of a median-defended config with numerics on in one
    events.jsonl: the attackers' attribution events and the rows."""
    path = tmp_path_factory.mktemp("metrics")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ATTACKFL_TELEMETRY_DIR", str(path))
        for rounds in (2, 3):
            cfg = Config(**{**TINY, "num_round": rounds, "mode": "median"}, log_path=str(path),
                         telemetry=TelemetryConfig(numerics=True))
            sim = Simulator(cfg, device="cpu")
            sim.run(save_checkpoints=False, verbose=False)
            sim.close()
    return str(path)


@pytest.mark.parametrize("flags", [[], ["--numerics"], ["--forensics"], ["--json"],
                                   ["--numerics", "--json"], ["--forensics", "--all"],
                                   ["--numerics", "--all", "--json"]])
def test_metrics_prints_jaxs_report(flags, defended_run, capsys):
    rc = cli.main(["metrics", defended_run, *flags])
    ours = capsys.readouterr().out
    jrc = jsummary.main([defended_run, *flags])
    theirs = capsys.readouterr().out
    assert rc == jrc == 0
    assert ours == theirs
    if "--numerics" in flags and "--json" not in flags:
        assert "rounds with numerics: 3" in ours and "attack separation over" in ours


def test_metrics_refuses_merge_and_programs(defended_run, capsys, tmp_path, monkeypatch):
    """``--merge``, refused until ROADMAP item 21 was ported, prints JAX's
    report: a run directory with one ``events.jsonl`` merges one stream
    and has nothing to compare.  ``--programs``, refused until item 16c
    was ported, prints JAX's table: none on a run with the cost model
    off, the profiles of a run with it on."""
    for flags in ([], ["--json"], ["--forensics"]):
        rc = summary.main([defended_run, "--merge", *flags])
        ours = capsys.readouterr()
        jrc = jsummary.main([defended_run, "--merge", *flags])
        theirs = capsys.readouterr()
        assert (rc, ours.out, ours.err) == (jrc, theirs.out, theirs.err) and rc == 0
        if not flags:
            assert ours.out.startswith("merged events.jsonl (") and "nothing to compare" in ours.out
    assert summary.main([defended_run, "--programs"]) == jsummary.main(
        [defended_run, "--programs"]) == 2
    assert "no program_profile events found" in capsys.readouterr().err
    monkeypatch.setenv("ATTACKFL_TELEMETRY_DIR", str(tmp_path))
    monkeypatch.setenv("ATTACKFL_COSTMODEL", "1")
    sim = Simulator(Config(**{**TINY, "num_round": 2}, log_path=str(tmp_path)), device="cpu")
    sim.run(save_checkpoints=False, verbose=False)
    sim.close()
    capsys.readouterr()
    for flags in ([], ["--json"]):
        assert cli.main(["metrics", str(tmp_path), "--programs", *flags]) == 0
        ours = capsys.readouterr().out
        assert jsummary.main([str(tmp_path), "--programs", *flags]) == 0
        assert ours == capsys.readouterr().out
    assert "round_step" in ours and "aggregate" in ours


def test_run_command_with_numerics_and_monitor(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("ATTACKFL_TELEMETRY_DIR", str(tmp_path))
    assert cli.main(["run", "--config", _yaml(tmp_path), "--device", "cpu", "--rounds", "1",
                     "--numerics", "--monitor-port", "0"]) == 0
    out = capsys.readouterr().out
    assert "[monitor] http://localhost:" in out and "Finished: 1 successful rounds." in out
    events = _events(tmp_path / "events.jsonl")
    assert events[0]["monitor_port"] > 0 and events[0]["config"]["telemetry"]["numerics"]
    rows = [e for e in events if e["kind"] == "metric"]
    assert [e["round"] for e in rows] == [1] and not validate_event(rows[0])
