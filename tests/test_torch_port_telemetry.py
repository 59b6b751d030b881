"""The port's event log, tracer and counters (``attackfl_tpu_torch/telemetry``)
against the JAX package's, on the CPU, at the size of
``test_torch_port_fused_rounds.py`` (TransformerModel on ICU, 8 clients,
2 LIE attackers from broadcast 2, 2 epochs, batch 16).

1. The schema: ``SCHEMA_VERSION``, ``REQUIRED_FIELDS``, every optional
   table and ``KINDS_BY_VERSION`` equal JAX's; ``_jsonable`` turns CPU
   tensors and numpy scalars into numbers and refuses a tensor on the
   card.
2. Event streams: the same config through JAX and through the port under
   ``run`` and ``run_fast`` (the fault plan of
   ``test_torch_port_faults.py``, checkpoints every round or chunk) and
   the pipeline at depth 2 (two NaN storms: a demotion and a
   re-promotion).  Both sides run ``xla`` with dropout off (the wrapper
   models of ``test_torch_port_local.py``) from JAX's initial params, the
   port handed JAX's threefry draws broadcast by broadcast, as
   ``test_torch_port_defense_round.py`` hands one round's.  The port's
   kinds are JAX's (less its ``compile`` events: the port compiles no
   per-program code); the ``round``, ``retry``, ``degrade``, ``fault``,
   ``checkpoint``, ``chunk`` and ``run_end`` fields JAX's, ``phases``
   the same keys, losses and AUCs within 1e-4 (``test_torch_port_round``'s
   loss tolerance, ``test_torch_port_defense_round``'s AUC tolerance);
   every port event passes both packages' ``validate_event``.
3. Telemetry never changes a result: params with telemetry on and off
   bit-equal under each executor and backend; ``enabled: false`` writes
   no file.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch
from _torch_port_threads import one_torch_thread  # noqa: F401

from attackfl_tpu.config import AttackSpec as JaxAttackSpec
from attackfl_tpu.config import Config as JaxConfig
from attackfl_tpu.faults.plan import parse_fault_plan as jax_parse_fault_plan
from attackfl_tpu.telemetry import events as jevents
from attackfl_tpu.training import engine as jengine
from attackfl_tpu_torch.config import Config, TelemetryConfig
from attackfl_tpu_torch.faults.plan import parse_fault_plan
from attackfl_tpu_torch.ops import pytree as pt
from attackfl_tpu_torch.telemetry import events
from attackfl_tpu_torch.training import engine
from attackfl_tpu_torch.training.engine import Simulator
from attackfl_tpu_torch.weights import params_from_jax
from test_torch_port_fused_rounds import LIE, RUN_PLAN, SMALL
from tests.test_torch_port_defense_round import _jax_draws
from tests.test_torch_port_local import JaxDropoutOff, PortDropoutOff

LOSS_TOL, AUC_TOL = 1e-4, 1e-4
DEMOTE_PLAN = "nan_storm@2;nan_storm@3"
# (config overrides, executor, its keyword arguments)
EXECUTORS = {
    "run": (dict(faults=RUN_PLAN), "run", {}),
    "run_fast": (dict(faults=RUN_PLAN), "run_fast", {"chunk_size": 2}),
    "pipeline": (dict(faults=DEMOTE_PLAN, num_round=4, pipeline=True, pipeline_depth=2,
                      pipeline_demote_after=2, pipeline_repromote_after=2), "run", {}),
}
# the fields each kind must share with JAX's (paths and times aside)
FIELDS = {
    "round": ("round", "broadcast", "ok", "attacks_active", "chunk_len", "pipelined",
              "degraded"),
    "retry": ("round", "retries", "reason"),
    "degrade": ("state", "round", "depth", "configured_depth", "consecutive_failures",
                "in_flight", "clean_rounds"),
    "fault": ("fault", "action", "round", "clients", "device_side"),
    "checkpoint": ("round", "background"),
    "chunk": ("chunk_len",),
    "run_end": ("rounds", "ok_rounds"),
    "run_header": ("backend", "mode", "model", "data_name", "total_clients",
                   "pipeline_depth", "pipeline_depth_configured"),
}
COUNTERS = ("rounds_failed", "rounds_retried", "faults_injected", "nan_train_rounds",
            "nan_clients_detected", "executor_demotions", "executor_repromotions",
            "checkpoint_writes")


class JaxNoDropout(JaxDropoutOff):
    """JaxDropoutOff that the JAX engine can also init."""

    def init(self, *args, **kwargs):
        return self.inner.init(*args, **kwargs)


def _read(directory: str) -> list[dict]:
    with open(os.path.join(directory, "events.jsonl")) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def _overrides(kw: dict, plan_parser) -> dict:
    return {**kw, "faults": plan_parser(kw["faults"])}


@pytest.fixture(scope="module")
def jax_streams(tmp_path_factory):
    """Each executor's JAX run (``xla``, dropout off): its events, its
    initial params and its generator key."""
    jax.config.update("jax_platforms", "cpu")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jengine, "get_model", lambda name: JaxNoDropout())
        for name, (kw, method, call) in EXECUTORS.items():
            path = str(tmp_path_factory.mktemp(f"jax-{name}"))
            mp.setenv("ATTACKFL_TELEMETRY_DIR", path)
            shared = {k: v for k, v in SMALL.items() if k != "attacks"}
            jcfg = JaxConfig(**{**shared, **_overrides(kw, jax_parse_fault_plan)},
                             local_backend="xla", prng_impl="threefry2x32", log_path=path,
                             checkpoint_dir=path,
                             attacks=(JaxAttackSpec(mode="LIE", num_clients=2,
                                                    attack_round=2),))
            sim = jengine.Simulator(jcfg)
            init = sim.init_state()
            getattr(sim, method)(verbose=False, **call)
            sim.close()
            out[name] = {"events": _read(path),
                         "params": jax.tree.map(np.asarray, init["global_params"]),
                         "rng": init["rng"]}
    return out


def _port_run(name: str, jax_run: dict, path: str, monkeypatch):
    """The port's run of ``name`` on JAX's draws from JAX's params."""
    kw, method, call = EXECUTORS[name]
    monkeypatch.setenv("ATTACKFL_TELEMETRY_DIR", path)
    monkeypatch.setattr(engine, "get_model", lambda model: PortDropoutOff())
    cfg = Config(**{**SMALL, **_overrides(kw, parse_fault_plan)}, local_backend="xla",
                 log_path=path, checkpoint_dir=path)
    sim = Simulator(cfg, device="cpu")
    num_genuine = cfg.total_clients - LIE.num_clients
    keys = {"rng": jax_run["rng"]}

    def draw_round(gen, leak_pool=None):
        # JAX's schedule: each broadcast splits its key into the next
        # state key, the round's and the aggregate's
        keys["rng"], k_round, _ = jax.random.split(keys["rng"], 3)
        return _jax_draws(k_round, 0.0, num_genuine, max(int(0.5 * num_genuine), 1))

    sim.draw_round = draw_round
    state = sim.init_state()
    state["global_params"] = params_from_jax(jax_run["params"])
    getattr(sim, method)(state=state, verbose=False, **call)
    sim.close()
    return _read(path)


def _close(a, b, tol: float) -> bool:
    return (np.isnan(a) and np.isnan(b)) or abs(a - b) <= tol


def test_schema_tables_equal_jaxs():
    assert events.SCHEMA_VERSION == jevents.SCHEMA_VERSION == 14
    assert events.REQUIRED_FIELDS == jevents.REQUIRED_FIELDS
    assert events.KINDS_BY_VERSION == jevents.KINDS_BY_VERSION
    tables = [n for n in dir(jevents) if n.startswith("_OPTIONAL_") or n == "_COMMON_FIELDS"]
    assert len(tables) == 9
    for table in tables:
        assert getattr(events, table) == getattr(jevents, table), table
    for version in events.KINDS_BY_VERSION:
        assert events.known_kinds(version) == jevents.known_kinds(version)


def test_jsonable_takes_host_values_and_refuses_the_card():
    record = events._jsonable({"loss": torch.tensor(0.25), "n": np.int64(3),
                               "auc": np.float32(0.5), "rows": torch.arange(3),
                               "nested": (np.bool_(True), [torch.tensor(2)])})
    assert record == {"loss": 0.25, "n": 3, "auc": 0.5, "rows": [0, 1, 2],
                      "nested": [True, [2]]}
    assert json.loads(json.dumps(record)) == record

    class OnTheCard:
        is_cuda = True

        def item(self):
            raise AssertionError("read")

    with pytest.raises(TypeError, match="CUDA tensor"):
        events._jsonable({"x": OnTheCard()})


@pytest.mark.parametrize("name", list(EXECUTORS))
def test_event_stream_matches_jax(name, jax_streams, tmp_path, monkeypatch):
    theirs = jax_streams[name]["events"]
    ours = _port_run(name, jax_streams[name], str(tmp_path), monkeypatch)
    assert all(not events.validate_event(e) and not jevents.validate_event(e) for e in ours)
    kinds = [e["kind"] for e in theirs if e["kind"] != "compile"]
    assert [e["kind"] for e in ours] == kinds
    assert kinds[0] == "run_header" and kinds[-3:] == ["counters", "run_end", "ledger"]
    rounds = 0
    for mine, ref in zip(ours, (e for e in theirs if e["kind"] != "compile")):
        for key in FIELDS.get(mine["kind"], ()):
            assert mine.get(key) == ref.get(key), (mine["kind"], key, mine, ref)
        if mine["kind"] == "round":
            rounds += 1
            assert set(mine.get("phases", {})) == set(ref.get("phases", {}))
            assert _close(mine["train_loss"], ref["train_loss"], LOSS_TOL), (mine, ref)
            assert ("roc_auc" in mine) == ("roc_auc" in ref)
            assert _close(mine.get("roc_auc", 0.0), ref.get("roc_auc", 0.0), AUC_TOL), (mine, ref)
        if mine["kind"] == "counters":
            assert {k: mine["counters"].get(k) for k in COUNTERS} == \
                {k: ref["counters"].get(k) for k in COUNTERS}
    assert rounds == {"run": 5, "run_fast": 5, "pipeline": 6}[name]
    if name == "pipeline":
        assert [e["state"] for e in ours if e["kind"] == "degrade"] == ["demoted", "repromoted"]


def _final_params(tmp_path, backend: str, how: str, enabled: bool) -> dict:
    path = tmp_path / f"{how}-{enabled}"
    cfg = Config(**SMALL, local_backend=backend, log_path=str(path), checkpoint_dir=str(path),
                 faults=parse_fault_plan(RUN_PLAN), pipeline=how == "pipeline",
                 pipeline_depth=2, telemetry=TelemetryConfig(enabled=enabled))
    sim = Simulator(cfg, device="cpu")
    if how == "run_fast":
        state, _ = sim.run_fast(state=sim.init_state(), chunk_size=2, verbose=False)
    else:
        state, _ = sim.run(state=sim.init_state(), verbose=False)
    sim.close()
    return state


@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("how", ["run", "run_fast", "pipeline"])
def test_telemetry_never_changes_a_result(how, backend, tmp_path, monkeypatch):
    monkeypatch.delenv("ATTACKFL_TELEMETRY_DIR")
    on = _final_params(tmp_path, backend, how, True)
    off = _final_params(tmp_path, backend, how, False)
    for (key, a), (_, b) in zip(pt.tree_items(on["global_params"]),
                                pt.tree_items(off["global_params"])):
        assert torch.equal(a, b), key
    assert on["broadcasts"] == off["broadcasts"] == 5
    assert {"events.jsonl", "trace.json", "ledger"} <= set(os.listdir(tmp_path / f"{how}-True"))
    written = set(os.listdir(tmp_path / f"{how}-False"))
    assert not written & {"events.jsonl", "trace.json", "ledger"}, written


def test_trace_spans_and_counters_of_a_run(tmp_path, monkeypatch):
    """The Chrome trace holds a round span a broadcast with its phases
    nested, in microseconds; the counters count the failed broadcasts and
    the NaN storm's clients (broadcast 4, where every client drops, is a
    train-failed round with none)."""
    monkeypatch.setenv("ATTACKFL_TELEMETRY_DIR", str(tmp_path))
    sim = Simulator(Config(**SMALL, local_backend="xla", log_path=str(tmp_path),
                           checkpoint_dir=str(tmp_path), faults=parse_fault_plan(RUN_PLAN)),
                    device="cpu")
    _, history = sim.run(verbose=False)
    counters = sim.telemetry.counters.snapshot()
    sim.close()
    with open(tmp_path / "trace.json") as fh:
        trace = json.load(fh)["traceEvents"]
    spans = [e for e in trace if e["ph"] == "X"]
    rounds = [e for e in spans if e["name"] == "round"]
    assert [e["args"]["broadcast"] for e in rounds] == [1, 2, 3, 4, 5]
    assert all(e["dur"] > 0 for e in rounds)
    train = [e for e in spans if e["name"] == "train"]
    assert len(train) == 5 and all(
        r["ts"] <= t["ts"] and t["ts"] + t["dur"] <= r["ts"] + r["dur"] + 1
        for r, t in zip(rounds, train))
    assert counters["rounds_failed"] == counters["rounds_retried"] == 2
    assert counters["nan_train_rounds"] == counters["nan_clients_detected"] == 2
    assert [h.get("nan_clients") for h in history] == [None, 2, None, 0, None]
    assert [h["attacks_active"] for h in history] == [[], ["LIE"], ["LIE"], ["LIE"], ["LIE"]]
    assert all(set(h["phases"]) >= {"train"} for h in history)
