"""The port's ledger record and store (``attackfl_tpu_torch/ledger``) and
its summaries (``telemetry/summary.py``, ``telemetry/forensics.py``)
against the JAX package's jax-free tools, on the CPU, at the size of
``test_torch_port_fused_rounds.py``.

1. JAX's ``derive_record`` on a port run's ``events.jsonl`` and
   ``trace.json`` gives the record the port appended to its ledger (the
   timestamp and the id aside), under ``run``, ``run_fast`` and the
   pipeline; both packages' ``validate_record`` pass it.  Under the
   suite's ``ATTACKFL_COSTMODEL=0`` its ``programs`` and ``utilization``
   joins are None; with the cost model on and a hotspot window they hold
   the run's profiles, its utilization and its window, priced against
   the ledger's earlier record, as JAX's joins give them.
2. JAX's ``load_events``, ``summarize``, ``forensics_summary``, its
   ``metrics`` and ``ledger list`` command lines and its ``LedgerStore``
   read a port run; the port's ``summarize`` and ``forensics_summary``
   equal JAX's on it.
3. ``pipeline_depth: auto`` after a recorded run takes the depth JAX's
   ``auto_depth_from_records`` gives on the ledger's records.
4. A ledger that cannot be written leaves the run's result as it was and
   raises ``ledger_append_failures`` with a yellow line; a store sweeps
   its orphaned temps into ``orphan_tmp_swept``.
"""

import json
import os

import pytest
import torch
from _torch_port_threads import one_torch_thread  # noqa: F401

from attackfl_tpu.ledger import cli as jledger_cli
from attackfl_tpu.ledger.record import derive_record as jax_derive_record
from attackfl_tpu.ledger.record import validate_record as jax_validate_record
from attackfl_tpu.ledger.store import LedgerStore as JaxLedgerStore
from attackfl_tpu.telemetry import forensics as jforensics
from attackfl_tpu.telemetry import summary as jsummary
from attackfl_tpu.training.engine import auto_depth_from_records as jax_auto_depth
from attackfl_tpu_torch.config import Config, TelemetryConfig
from attackfl_tpu_torch.faults.plan import parse_fault_plan
from attackfl_tpu_torch.ledger import record, store
from attackfl_tpu_torch.ops import pytree as pt
from attackfl_tpu_torch.telemetry import forensics, summary
from attackfl_tpu_torch.training import engine
from attackfl_tpu_torch.training.engine import Simulator
from test_torch_port_fused_rounds import RUN_PLAN, SMALL


def _run(path, how: str = "run", **kw):
    """One port run writing its telemetry and ledger under ``path``."""
    cfg = Config(**{**SMALL, "local_backend": "xla", "log_path": str(path),
                    "checkpoint_dir": str(path), "pipeline": how == "pipeline",
                    "pipeline_depth": 2, **kw})
    sim = Simulator(cfg, device="cpu")
    if how == "run_fast":
        state, history = sim.run_fast(chunk_size=2, verbose=False)
    else:
        state, history = sim.run(verbose=False)
    sim.close()
    return sim, state, history


@pytest.fixture(autouse=True)
def own_telemetry_dir(monkeypatch):
    """Each run writes under its own ``log_path``, not the suite's shared
    telemetry directory."""
    monkeypatch.delenv("ATTACKFL_TELEMETRY_DIR")
    monkeypatch.delenv("ATTACKFL_LEDGER_DIR", raising=False)


@pytest.mark.parametrize("how", ["run", "run_fast", "pipeline"])
def test_jax_derive_record_gives_the_ports_record(how, tmp_path):
    sim, _, history = _run(tmp_path, how, faults=parse_fault_plan(RUN_PLAN))
    events = jsummary.load_events(str(tmp_path))
    with open(tmp_path / "trace.json") as fh:
        spans = json.load(fh)["traceEvents"]
    (appended,), skipped = store.LedgerStore(str(tmp_path / "ledger")).load()
    assert skipped == 0 and not record.validate_record(appended)
    assert not jax_validate_record(appended)
    theirs = jax_derive_record(events, trace_events=spans,
                               fingerprint=sim.checkpoints.fingerprint)
    ours = record.derive_record(events, trace_events=spans,
                                fingerprint=sim.checkpoints.fingerprint)
    aside = ("ts", "record_id")
    assert {k: v for k, v in theirs.items() if k not in aside} == \
        {k: v for k, v in appended.items() if k not in aside}
    assert ours == theirs
    assert appended["executor"] == {"run": "sync", "run_fast": "fused",
                                    "pipeline": "pipelined"}[how]
    assert appended["rounds"] == len(history) == 5 and appended["ok_rounds"] == 3
    assert appended["counts"]["rounds_failed"] == 2
    assert appended["programs"] is appended["numerics"] is appended["hotspots"] is None
    assert appended["round_device_time"] > 0 and appended["host_resolution_latency"] >= 0


@pytest.mark.parametrize("how", ["run", "pipeline"])
def test_jax_derive_record_gives_the_ports_joins_with_the_cost_model_on(how, tmp_path,
                                                                      monkeypatch):
    """The counterpart of the record test with the cost model on and a
    hotspot window: the ``programs``, ``utilization`` and ``hotspots``
    joins JAX's ``derive_record`` gives on the port's events (the second
    run priced against the first's record) are the port's."""
    monkeypatch.setenv("ATTACKFL_COSTMODEL", "1")
    tel = TelemetryConfig(hotspots="1:2")
    _run(tmp_path, how, telemetry=tel)
    corpus, _ = store.LedgerStore(str(tmp_path / "ledger")).load()
    sim, _, _ = _run(tmp_path, how, telemetry=tel)
    records, _ = store.LedgerStore(str(tmp_path / "ledger")).load()
    appended = records[-1]
    events = jsummary.split_runs(jsummary.load_events(str(tmp_path)))[-1]
    with open(tmp_path / "trace.json") as fh:
        spans = json.load(fh)["traceEvents"]
    theirs = jax_derive_record(events, trace_events=spans,
                               fingerprint=sim.checkpoints.fingerprint, ledger_records=corpus)
    ours = record.derive_record(events, trace_events=spans,
                                fingerprint=sim.checkpoints.fingerprint, ledger_records=corpus)
    assert ours == theirs
    aside = ("ts", "record_id")
    assert {k: v for k, v in theirs.items() if k not in aside} == \
        {k: v for k, v in appended.items() if k not in aside}
    names = {"run": {"round_step", "aggregate"}, "pipeline": {"pipeline_step[eval=True]"}}[how]
    assert set(appended["programs"]) == names
    assert appended["utilization"]["device_kind"] == "cpu"
    assert appended["utilization"]["achieved_flops_per_sec"] > 0
    assert appended["hotspots"]["status_counts"] == {"ok": 1}
    assert appended["hotspots"]["hotspot_prediction_error_factor"] >= 1.0
    assert appended["hotspots"]["prediction_method"] == "peer"


def test_jax_tools_read_a_port_run(tmp_path, capsys):
    _run(tmp_path, mode="krum", faults=parse_fault_plan(RUN_PLAN))
    events = jsummary.load_events(str(tmp_path))
    theirs = jsummary.summarize(events)
    assert summary.summarize(events) == theirs
    assert theirs["rounds_attempted"] == 5 and theirs["rounds_ok"] == 3
    assert set(theirs["phases"]) == {"train", "attribution", "aggregate", "validate"}
    assert "rounds_per_sec_steady" in theirs["rates"]
    verdict = jforensics.forensics_summary(events)
    assert forensics.forensics_summary(events) == verdict
    assert forensics.forensics_by_defense(events) == jforensics.forensics_by_defense(events)
    assert verdict["mode"] == "krum" and verdict["rounds"] == 3
    assert verdict["attack_rounds"] == 2
    assert jsummary.main([str(tmp_path)]) == 0
    assert "rounds/s" in capsys.readouterr().out
    assert jledger_cli.main(["list", "--dir", str(tmp_path / "ledger")]) == 0
    (jrec,), _ = JaxLedgerStore(str(tmp_path / "ledger")).load()
    assert jrec["forensics"]["tpr"] == verdict["tpr"]


def test_auto_depth_reads_the_ledger(tmp_path, capsys):
    ledger = str(tmp_path / "ledger")
    tel = TelemetryConfig(ledger_dir=ledger)
    first, _, _ = _run(tmp_path / "first", "pipeline", telemetry=tel)
    records, _ = JaxLedgerStore(ledger).load()
    want, info = jax_auto_depth(records, first.checkpoints.fingerprint)
    assert want is not None and info["peers"] == 1
    capsys.readouterr()
    auto, _, history = _run(tmp_path / "auto", "pipeline", pipeline_depth="auto", telemetry=tel)
    assert auto._depth_resolved == min(want, 2)
    assert auto._depth_info["ratio"] == info["ratio"] and auto._depth_info["peers"] == 1
    assert f"[pipeline] depth auto -> {auto._depth_resolved}" in capsys.readouterr().out
    assert all(h["pipelined"] for h in history)
    # three records asking for a deeper queue outvote the two measured
    # ones: the pick follows, capped at 2 under a checkpoint every round
    for _ in range(3):
        store.LedgerStore(ledger).append(dict(records[0], round_device_time=0.01,
                                              host_resolution_latency=0.05))
    deeper, _, _ = _run(tmp_path / "deeper", "pipeline", pipeline_depth="auto", telemetry=tel)
    records, _ = JaxLedgerStore(ledger).load()
    assert jax_auto_depth(records, first.checkpoints.fingerprint)[0] >= 2
    assert deeper._depth_resolved == 2 and "clamped_from" in deeper._depth_info


def test_an_unwritable_ledger_fails_open(tmp_path, capsys):
    ledger = tmp_path / "ledger"
    ledger.mkdir()
    (ledger / store.LEDGER_NAME).mkdir()   # appends to the JSONL fail
    sim, state, history = _run(tmp_path / "run", telemetry=TelemetryConfig(
        ledger_dir=str(ledger)))
    assert sim.telemetry.counters.get("ledger_append_failures") == 1
    assert "[ledger] append failed (run unaffected)" in capsys.readouterr().out
    _, ref, ref_history = _run(tmp_path / "ref", telemetry=TelemetryConfig(ledger=False))
    assert [h["ok"] for h in history] == [h["ok"] for h in ref_history]
    for (key, a), (_, b) in zip(pt.tree_items(state["global_params"]),
                                pt.tree_items(ref["global_params"])):
        assert torch.equal(a, b), key
    kinds = [e["kind"] for e in jsummary.load_events(str(tmp_path / "run"))]
    assert kinds[-2:] == ["counters", "run_end"]


def test_store_sweeps_orphans_and_jax_reads_its_index(tmp_path):
    ledger = tmp_path / "ledger"
    ledger.mkdir()
    (ledger / "index.json.tmp.1.dead").write_text("{")
    sim = Simulator(Config(**SMALL, local_backend="xla", log_path=str(tmp_path),
                           checkpoint_dir=str(tmp_path)), device="cpu")
    assert sim.telemetry.counters.get("orphan_tmp_swept") == 1
    assert not os.path.exists(ledger / "index.json.tmp.1.dead")
    state, _ = sim.run(verbose=False)
    sim.run(num_rounds=4, state=state, verbose=False)
    sim.close()
    ours = store.LedgerStore(str(ledger))
    assert [r["rounds"] for r in ours.load()[0]] == [3, 1]
    assert JaxLedgerStore(str(ledger)).index() == ours.index()
    assert [r["record_id"] for r in ours.index()][1].endswith("-2")
    assert engine.auto_depth_from_records(ours.records(), sim.checkpoints.fingerprint) == \
        jax_auto_depth(ours.records(), sim.checkpoints.fingerprint)
