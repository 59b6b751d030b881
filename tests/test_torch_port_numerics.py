"""The port's numerics ring (``attackfl_tpu_torch/ops/metrics.py``,
``telemetry/numerics.py`` and the engine's seams) against the JAX
package's, on the CPU.

1. ``build_layout``'s slot names and ``leaf_names`` on each of the five
   models equal JAX's; ``masked_distribution`` with a random, an empty
   and a NaN-holding cohort; ``compute_row`` on identical inputs with one
   client's leaf poisoned (gauges within 1e-5 relative, counts, the
   histogram and ``first_nonfinite_leaf`` equal), against the global
   params and against per-client (hyper) bases; the ring's wraparound and
   the drainer's k-late order and dropped rows; ``numerics_summary`` and
   ``format_numerics`` on the same events.
2. End to end at ``test_torch_port_telemetry.py``'s size (TransformerModel,
   8 clients, 2 LIE attackers, that file's fault plans), the port on JAX's
   draws from JAX's params, under ``run``, ``run_fast`` and the pipeline:
   one row a round with JAX's rounds, broadcasts and ``ok``; gauges within
   1e-4 relative (1e-4 absolute below 1); histograms equal unless a
   client's norm lies within 1e-4 relative of an edge; the NaN storm's
   clients and first poisoned layer.  JAX's ``derive_record`` on a port
   run gives the port's ``numerics`` join.
3. Numerics never changes the params: on and off bit for bit under each
   executor and backend and in hyper mode; ``numerics_window`` caps
   ``pipeline_depth: auto``; the synchronous path drains in windows.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_threads import one_torch_thread  # noqa: F401

from attackfl_tpu.config import AttackSpec as JaxAttackSpec
from attackfl_tpu.config import Config as JaxConfig
from attackfl_tpu.config import TelemetryConfig as JaxTelemetryConfig
from attackfl_tpu.faults.plan import parse_fault_plan as jax_parse_fault_plan
from attackfl_tpu.ledger.record import derive_record as jax_derive_record
from attackfl_tpu.ops import metrics as jmetrics
from attackfl_tpu.registry import get_model as jax_get_model
from attackfl_tpu.telemetry import Counters as JaxCounters
from attackfl_tpu.telemetry import numerics as jnumerics
from attackfl_tpu.training import engine as jengine
from attackfl_tpu_torch.config import Config, TelemetryConfig
from attackfl_tpu_torch.faults.plan import parse_fault_plan
from attackfl_tpu_torch.ledger import record
from attackfl_tpu_torch.ops import metrics
from attackfl_tpu_torch.ops import pytree as pt
from attackfl_tpu_torch.registry import get_model
from attackfl_tpu_torch.telemetry import numerics
from attackfl_tpu_torch.telemetry.counters import Counters
from attackfl_tpu_torch.telemetry.events import validate_event
from attackfl_tpu_torch.training import engine
from attackfl_tpu_torch.training.engine import Simulator
from attackfl_tpu_torch.weights import params_from_jax
from test_torch_port_fused_rounds import LIE, RUN_PLAN, SMALL
from test_torch_port_telemetry import EXECUTORS, JaxNoDropout, _overrides, _read
from tests.test_torch_port_defense_round import _jax_draws
from tests.test_torch_port_local import PortDropoutOff

ROW_RTOL = 1e-5
RUN_TOL = 1e-4
MODELS = {"CNNModel": "ICU", "RNNModel": "ICU", "TransformerModel": "ICU",
          "TransformerClassifier": "HAR", "ResNet18": "CIFAR10"}


class _RecordingTelemetry:
    """events.emit -> list, real Counters: enough for a drainer."""

    class _Events:
        def __init__(self):
            self.records: list[dict] = []

        def emit(self, kind, **fields):
            self.records.append(dict(kind=kind, **fields))

    def __init__(self, counters):
        self.events = self._Events()
        self.counters = counters


def _gauges_close(ours: dict, theirs: dict, tol: float, floor: float = 0.0) -> list:
    """The gauges of two rows that differ: both None, or within ``tol``
    relative (``tol`` absolute below ``floor``)."""
    bad = []
    for key, want in theirs.items():
        got = ours[key]
        if want is None or got is None:
            if got != want:
                bad.append((key, got, want))
        elif abs(got - want) > tol * max(abs(want), floor):
            bad.append((key, got, want))
    return bad


def _near_edge(norms, tol: float) -> bool:
    edges = np.asarray(metrics.HIST_EDGES)
    return bool(np.any(np.abs(np.asarray(norms)[:, None] - edges[None, :])
                       <= tol * edges[None, :]))


# ---------------------------------------------------------------------------
# 1. the device math against JAX's on identical inputs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(MODELS))
def test_build_layout_matches_jax(name):
    data_name = MODELS[name]
    template = jax.eval_shape(
        lambda key: jax_get_model(name).init(key, *jengine.sample_inputs(data_name))["params"],
        jax.random.key(0))
    ours = get_model(name).init(torch.Generator().manual_seed(0))
    for attackers in (False, True):
        theirs = jmetrics.build_layout(template, attackers)
        mine = metrics.build_layout(ours, attackers)
        assert mine == metrics.MetricsLayout(theirs.names, theirs.leaf_names, theirs.cohorts)
        assert mine.size == theirs.size
    assert metrics.HIST_EDGES == jmetrics.HIST_EDGES
    assert metrics.NUM_HIST_BUCKETS == jmetrics.NUM_HIST_BUCKETS == 16


@pytest.mark.parametrize("case", ["random", "empty", "nan", "one"])
def test_masked_distribution_matches_jax(case):
    rng = np.random.default_rng(7)
    values = rng.uniform(0.0, 10.0, size=32).astype(np.float32)
    mask = rng.random(32) < 0.6
    if case == "empty":
        mask[:] = False
    elif case == "nan":
        values[np.flatnonzero(mask)[3]] = np.nan
    elif case == "one":
        mask[:] = False
        mask[5] = True
    theirs = [float(v) for v in jax.jit(jmetrics.masked_distribution)(
        jnp.asarray(values), jnp.asarray(mask))]
    ours = [float(v) for v in metrics.masked_distribution(torch.from_numpy(values),
                                                          torch.from_numpy(mask))]
    np.testing.assert_allclose(ours, theirs, rtol=ROW_RTOL, equal_nan=True)
    if case == "empty":
        assert all(np.isnan(ours))
    if case == "random":
        kept = values[mask]
        np.testing.assert_allclose(ours, [np.percentile(kept, 50), np.percentile(kept, 95),
                                          kept.max()], rtol=ROW_RTOL)


def _row_inputs(hyper: bool):
    """Seeded client rows over a three-leaf tree, 12 clients with a wide
    lognormal spread of norms, two not reporting, client 4 poisoned in
    ``dense/kernel`` (NaN) and client 7 in ``head/kernel`` (Inf).  In
    hyper mode each client has its own base."""
    rng = np.random.default_rng(21)
    c = 12
    scale = rng.lognormal(0.0, 2.0, size=c).astype(np.float32)

    def leaf(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    old = {"dense": {"kernel": leaf(5, 3), "bias": leaf(3)}, "head": {"kernel": leaf(3, 1)}}
    new = jax.tree.map(lambda x: x + 0.1 * leaf(*x.shape), old)
    base = jax.tree.map(lambda x: x[None] + 0.3 * leaf(c, *x.shape), old) if hyper else old
    noise = jax.tree.map(lambda x: scale.reshape((c,) + (1,) * x.ndim) * leaf(c, *x.shape), old)
    stacked = jax.tree.map(lambda b, n: (b + n).astype(np.float32), base, noise)
    stacked["dense"]["kernel"][4, 1, 2] = np.nan
    stacked["head"]["kernel"][7, 0, 0] = np.inf
    sizes = np.full(c, 30, np.int32)
    sizes[[2, 9]] = 0
    attackers = np.zeros(c, bool)
    attackers[[0, 5, 7, 10]] = True
    return dict(base=base, old=old, new=new, stacked=stacked, sizes=sizes,
                attackers=attackers)


def _jax_row(inp, layout, window=4):
    num = jmetrics.Numerics(layout, ~inp["attackers"], inp["attackers"], window=window)
    args = [jax.tree.map(jnp.asarray, inp[k]) for k in ("base", "old", "new", "stacked")]
    return num, np.asarray(jax.jit(num.compute_row)(
        *args, jnp.asarray(inp["sizes"]), jnp.float32(0.5), jnp.float32(0.4),
        jnp.bool_(True), jnp.int32(3)))


def _port_row(inp, layout, window=4):
    num = metrics.Numerics(layout, ~inp["attackers"], inp["attackers"], window=window)
    args = [pt.tree_map(torch.from_numpy, inp[k]) for k in ("base", "old", "new", "stacked")]
    return num, num.compute_row(*args, torch.from_numpy(inp["sizes"]), torch.tensor(0.5),
                                torch.tensor(0.4), True, 3).numpy()


@pytest.mark.parametrize("hyper", [False, True])
def test_compute_row_matches_jax(hyper):
    inp = _row_inputs(hyper)
    template = inp["old"]
    jlayout = jmetrics.build_layout(template, True)
    layout = metrics.build_layout(pt.tree_map(torch.from_numpy, template), True)
    _, theirs = _jax_row(inp, jlayout)
    _, ours = _port_row(inp, layout)
    names = layout.names
    k = len(names)
    np.testing.assert_allclose(ours[:k], theirs[:k], rtol=ROW_RTOL, equal_nan=True,
                               err_msg=str(list(zip(names, ours[:k], theirs[:k]))))
    # the histogram exact: no client's norm within 1e-5 of an edge here
    diffs = jax.tree.map(lambda x, b: np.asarray(x, np.float64) - b, inp["stacked"],
                         inp["base"])
    norms = np.sqrt(sum(np.nan_to_num(np.square(d), nan=0.0, posinf=0.0).reshape(
        12, -1).sum(1) for d in jax.tree.leaves(diffs)))
    assert not _near_edge(norms, 1e-5)
    np.testing.assert_array_equal(ours[k:], theirs[k:])
    assert ours[k:].sum() == 8  # 12 clients, 2 not reporting, 2 poisoned
    for slot, want in (("nonfinite_count", 2), ("nonfinite_clients", 2),
                       ("first_nonfinite_leaf", layout.leaf_names.index("dense/kernel"))):
        assert ours[layout.index(slot)] == theirs[jlayout.index(slot)] == want
    assert np.isfinite(ours[layout.index("update_norm_all_max")])
    assert np.isfinite(ours[layout.index("sep_l2")])


def test_ring_write_wraps_as_jax():
    """Six steps into a window of four: the ring's rows, cursor and
    prev_loss equal JAX's, and the step leaves the ring it was given as
    it was."""
    inp = _row_inputs(False)
    jlayout = jmetrics.build_layout(inp["old"], True)
    layout = metrics.build_layout(pt.tree_map(torch.from_numpy, inp["old"]), True)
    jnum, _ = _jax_row(inp, jlayout)
    num, _ = _port_row(inp, layout)
    jstate, state = jnum.init_state(), num.init_state()
    jargs = [jax.tree.map(jnp.asarray, inp[k]) for k in ("base", "old", "new", "stacked")]
    args = [pt.tree_map(torch.from_numpy, inp[k]) for k in ("base", "old", "new", "stacked")]
    for b in range(1, 7):
        jstate, _ = jax.jit(jnum.step)(jstate, *jargs, jnp.asarray(inp["sizes"]),
                                       jnp.float32(0.1 * b), jnp.bool_(b % 3 != 0), jnp.int32(b))
        before = state["buffer"].clone()
        new, _ = num.step(state, *args, torch.from_numpy(inp["sizes"]),
                          torch.tensor(0.1 * b), b % 3 != 0, b)
        assert torch.equal(torch.nan_to_num(state["buffer"]), torch.nan_to_num(before))
        state = new
    assert int(state["cursor"]) == int(jstate["cursor"]) == 6
    assert float(state["prev_loss"]) == pytest.approx(float(jstate["prev_loss"]))
    np.testing.assert_allclose(state["buffer"].numpy(), np.asarray(jstate["buffer"]),
                               rtol=ROW_RTOL, equal_nan=True)
    # slots 0 and 1 hold broadcasts 5 and 6, slots 2 and 3 broadcasts 3 and 4
    assert state["buffer"][:, layout.index("broadcast")].tolist() == [5, 6, 3, 4]


def _make_ring(layout, window: int, rounds: int) -> np.ndarray:
    """Row r carries r+1 in every slot, its broadcast among them."""
    buffer = np.full((window, layout.size), np.nan, np.float32)
    for r in range(rounds):
        buffer[r % window] = float(r + 1)
    return buffer


@pytest.mark.parametrize("rounds_between", [(3, 2), (6,)], ids=["k-late", "wraparound"])
def test_drainer_matches_jax(rounds_between):
    """Drains after each batch of rounds: the port's drainer emits JAX's
    events in round order; rows overwritten in the ring are dropped and
    counted alike."""
    layout = metrics.build_layout({"w": torch.zeros(3)}, False)
    jlayout = jmetrics.build_layout({"w": np.zeros(3)}, False)
    tel, jtel = _RecordingTelemetry(Counters()), _RecordingTelemetry(JaxCounters())
    gauges = []
    drainer = numerics.NumericsDrainer(layout, tel, window=4, on_gauges=gauges.append)
    jdrainer = jnumerics.NumericsDrainer(jlayout, jtel, window=4)
    done = 0
    for batch in rounds_between:
        for r in range(done + 1, done + batch + 1):
            drainer.note_round(r, r)
            jdrainer.note_round(r, r)
        done += batch
        ring = _make_ring(layout, 4, done)
        assert drainer.due() == jdrainer.due()
        assert drainer.drain({"buffer": torch.from_numpy(ring)}) == \
            jdrainer.drain({"buffer": ring})
    assert tel.events.records == jtel.events.records
    emitted = [e["round"] for e in tel.events.records]
    assert emitted == ([1, 2, 3, 4, 5] if rounds_between == (3, 2) else [3, 4, 5, 6])
    assert [e["numerics"]["broadcast"] for e in tel.events.records] == emitted
    assert drainer.rows_dropped == jdrainer.rows_dropped == (0 if len(rounds_between) == 2 else 2)
    assert tel.counters.snapshot() == jtel.counters.snapshot()
    assert gauges == [e["numerics"] for e in tel.events.records]
    assert drainer.drain({"buffer": torch.from_numpy(_make_ring(layout, 4, done))}) == 0
    # a row pushed from the host takes the same path
    drainer.push_host_row(9, 9, np.full(layout.size, 9.0, np.float32))
    assert tel.events.records[-1]["round"] == 9


def test_numerics_summary_and_format_match_jax():
    def event(broadcast, run_id="r0", **gauges):
        base = {"update_norm_all_p95": 1.5, "nonfinite_count": 0.0, "sep_margin": 0.25,
                "sep_cosine": 0.1, "sep_l2": 2.0, "global_drift": 0.5, "train_loss": 0.7}
        base.update(gauges)
        return {"kind": "metric", "metric": "numerics", "run_id": run_id,
                "round": broadcast, "broadcast": broadcast, "numerics": base,
                "hist": [0] * 16}

    events = [event(1), event(2, nonfinite_count=3.0, sep_margin=None, sep_cosine=None,
                             sep_l2=None), event(1), event(3, sep_margin=-0.5)]
    ours, theirs = numerics.numerics_summary(events), jnumerics.numerics_summary(events)
    assert ours == theirs
    assert ours["rounds"] == 3 and ours["nonfinite_total"] == 3
    assert numerics.format_numerics(ours, "r0") == jnumerics.format_numerics(theirs, "r0")
    assert numerics.numerics_summary([{"kind": "round"}]) is None


# ---------------------------------------------------------------------------
# 2. end to end against JAX's runs on JAX's draws
# ---------------------------------------------------------------------------


def _numerics_events(events: list) -> list:
    return [e for e in events if e["kind"] == "metric" and e.get("metric") == "numerics"]


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """Each executor's JAX run of ``test_torch_port_telemetry.py`` with
    numerics on: its events, its initial params and its generator key."""
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
                             checkpoint_dir=path, telemetry=JaxTelemetryConfig(numerics=True),
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
    """The port's run of ``name`` on JAX's draws from JAX's params, numerics
    on; returns its events and each row's per-client update norms."""
    kw, method, call = EXECUTORS[name]
    monkeypatch.setenv("ATTACKFL_TELEMETRY_DIR", path)
    monkeypatch.setattr(engine, "get_model", lambda model: PortDropoutOff())
    cfg = Config(**{**SMALL, **_overrides(kw, parse_fault_plan)}, local_backend="xla",
                 log_path=path, checkpoint_dir=path, telemetry=TelemetryConfig(numerics=True))
    sim = Simulator(cfg, device="cpu")
    num_genuine = cfg.total_clients - LIE.num_clients
    keys = {"rng": jax_run["rng"]}

    def draw_round(gen, leak_pool=None):
        keys["rng"], k_round, _ = jax.random.split(keys["rng"], 3)
        return _jax_draws(k_round, 0.0, num_genuine, max(int(0.5 * num_genuine), 1))

    norms = []
    real = sim._numerics.compute_row

    def recording(base, old_ref, new_ref, stacked, sizes, *rest):
        sq = sum(torch.nan_to_num(torch.square(x - b), nan=0.0, posinf=0.0).reshape(
            x.shape[0], -1).sum(1) for x, b in zip(pt.tree_leaves(stacked), pt.tree_leaves(base)))
        norms.append(torch.sqrt(sq).numpy())
        return real(base, old_ref, new_ref, stacked, sizes, *rest)

    sim._numerics.compute_row = recording
    sim.draw_round = draw_round
    state = sim.init_state()
    state["global_params"] = params_from_jax(jax_run["params"])
    getattr(sim, method)(state=state, verbose=False, **call)
    sim.close()
    return sim, _read(path), norms


@pytest.mark.parametrize("name", list(EXECUTORS))
def test_numerics_rows_match_jax(name, jax_runs, tmp_path, monkeypatch):
    sim, events, norms = _port_run(name, jax_runs[name], str(tmp_path), monkeypatch)
    assert all(not validate_event(e) for e in events)
    ours = _numerics_events(events)
    theirs = _numerics_events(jax_runs[name]["events"])
    rounds = [e for e in events if e["kind"] == "round"]
    assert len(ours) == len(theirs) == len(rounds) == len(norms)
    assert [(e["round"], e["broadcast"]) for e in ours] == \
        [(e["round"], e["broadcast"]) for e in theirs] == \
        [(e["round"], e["broadcast"]) for e in rounds]
    edge_rows = []
    for mine, ref, norm in zip(ours, theirs, norms):
        assert mine["numerics"]["ok"] == ref["numerics"]["ok"]
        bad = _gauges_close(mine["numerics"], ref["numerics"], RUN_TOL, floor=1.0)
        assert not bad, (mine["round"], bad)
        if mine["hist"] != ref["hist"]:
            assert _near_edge(norm[np.isfinite(norm)], RUN_TOL), (mine["hist"], ref["hist"])
            edge_rows.append(mine["round"])
    assert len(edge_rows) <= 1, edge_rows
    header = events[0]
    assert header["programs"]["numerics"]["metrics"] == list(sim._numerics.layout.names)
    storms = [e["numerics"] for e in ours if e["numerics"]["nonfinite_count"]]
    if name == "pipeline":
        # nan_storm@2 and @3 poison every client
        assert [s["nonfinite_clients"] for s in storms] == [8.0, 8.0]
    else:
        # nan_storm@2:clients=1,6, in every leaf: the first leaf is named
        assert [s["nonfinite_clients"] for s in storms] == [2.0]
        assert storms[0]["nonfinite_count"] == 2.0 * len(sim._numerics.layout.leaf_names)
    assert all(s["first_nonfinite_leaf"] == 0.0 for s in storms)
    if name == "run":
        # JAX's derive_record on the port's run gives the port's join
        with open(tmp_path / "trace.json") as fh:
            spans = json.load(fh)["traceEvents"]
        theirs_rec = jax_derive_record(events, trace_events=spans,
                                       fingerprint=sim.checkpoints.fingerprint)
        ours_rec = record.derive_record(events, trace_events=spans,
                                        fingerprint=sim.checkpoints.fingerprint)
        assert ours_rec["numerics"] == theirs_rec["numerics"]
        assert ours_rec["numerics"]["rounds"] == len(ours)
        assert ours_rec["numerics"]["nonfinite_total"] == 2 * len(sim._numerics.layout.leaf_names)


# ---------------------------------------------------------------------------
# 3. numerics never changes a result
# ---------------------------------------------------------------------------


def _final_state(tmp_path, how: str, on: bool, **kw) -> dict:
    path = tmp_path / f"{how}-{on}"
    cfg = Config(**{**SMALL, "log_path": str(path), "checkpoint_dir": str(path),
                    "faults": parse_fault_plan(RUN_PLAN), "pipeline": how == "pipeline",
                    "pipeline_depth": 2, **kw,
                    "telemetry": TelemetryConfig(numerics=on, numerics_window=2)})
    sim = Simulator(cfg, device="cpu")
    if how == "run_fast":
        state, _ = sim.run_fast(state=sim.init_state(), chunk_size=2, verbose=False)
    else:
        state, _ = sim.run(state=sim.init_state(), verbose=False)
    sim.close()
    rows = _numerics_events(_read(str(path))) if on else []
    return state, rows


def _assert_same(on: dict, off: dict, keys) -> None:
    for key in keys:
        a, b = on[key], off[key]
        a = a if isinstance(a, dict) else {"": a}
        b = b if isinstance(b, dict) else {"": b}
        for (path, x), (_, y) in zip(pt.tree_items(a), pt.tree_items(b)):
            assert torch.equal(x, y), (key, path)


@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("how", ["run", "run_fast", "pipeline"])
def test_numerics_never_changes_the_params(how, backend, tmp_path, monkeypatch):
    monkeypatch.delenv("ATTACKFL_TELEMETRY_DIR")
    on, rows = _final_state(tmp_path, how, True, local_backend=backend)
    off, _ = _final_state(tmp_path, how, False, local_backend=backend)
    _assert_same(on, off, ("global_params",))
    assert on["broadcasts"] == off["broadcasts"] == 5
    assert "numerics" in on and "numerics" not in off
    assert [e["broadcast"] for e in rows] == [1, 2, 3, 4, 5]
    assert [e["numerics"]["ok"] for e in rows] == [1.0, 0.0, 1.0, 0.0, 1.0]


@pytest.mark.parametrize("how", ["run", "run_fast", "pipeline"])
def test_hyper_numerics_never_changes_the_hypernetwork(how, tmp_path, monkeypatch):
    monkeypatch.delenv("ATTACKFL_TELEMETRY_DIR")
    hyper = dict(mode="hyper", local_backend="xla", num_round=2, epochs=1,
                 num_data_range=(16, 24), faults=parse_fault_plan("nan_storm@2:clients=3"))
    on, rows = _final_state(tmp_path, how, True, **hyper)
    off, _ = _final_state(tmp_path, how, False, **hyper)
    _assert_same(on, off, ("hnet_params",))
    _assert_same(on["hyper_opt_state"], off["hyper_opt_state"], ("m", "v"))
    assert int(on["hyper_opt_state"]["count"]) == int(off["hyper_opt_state"]["count"])
    assert [e["broadcast"] for e in rows] == [1, 2, 3]
    assert [e["numerics"]["nonfinite_clients"] for e in rows] == [0.0, 1.0, 0.0]
    assert rows[1]["numerics"]["global_drift"] == 0.0


def test_sync_path_drains_in_windows_and_resume_starts_a_fresh_ring(tmp_path, monkeypatch):
    """numerics_window 2 over 3 rounds: one ring read at round 2, one at
    the run's end; every round emitted once.  Checkpoints never hold the
    ring, so a resumed run starts a new one."""
    monkeypatch.delenv("ATTACKFL_TELEMETRY_DIR")
    cfg = Config(**{**SMALL, "log_path": str(tmp_path), "checkpoint_dir": str(tmp_path),
                    "telemetry": TelemetryConfig(numerics=True, numerics_window=2)})
    sim = Simulator(cfg, device="cpu")
    reads = []
    real = sim._numerics_drainer.drain
    sim._numerics_drainer.drain = lambda num_state: reads.append(real(num_state)) or reads[-1]
    state, _ = sim.run(verbose=False)
    sim.close()
    assert reads == [2, 1]
    assert sim.telemetry.counters.get("numerics_rows") == 3
    assert sim._numerics_drainer.rows_dropped == 0
    assert "numerics" not in sim.host_state(state)
    resumed = Simulator(dataclasses.replace(cfg, resume=True, num_round=4), device="cpu")
    state2, hist = resumed.run(verbose=False)
    resumed.close()
    assert [h["round"] for h in hist] == [4]
    assert int(state2["numerics"]["cursor"]) == 1
    rows = _numerics_events(_read(str(tmp_path)))
    assert [e["round"] for e in rows] == [1, 2, 3, 4]


def test_numerics_window_caps_auto_depth(tmp_path, monkeypatch):
    monkeypatch.delenv("ATTACKFL_TELEMETRY_DIR")
    monkeypatch.setattr(engine, "auto_depth_from_records", lambda records, fp: (7, {}))
    cfg = Config(**{**SMALL, "log_path": str(tmp_path), "pipeline_depth": "auto",
                    "checkpoint_async": True,
                    "telemetry": TelemetryConfig(numerics=True, numerics_window=3)})
    sim = Simulator(cfg, device="cpu")
    assert sim.resolve_pipeline_depth() == 3
    assert sim._depth_info["clamped_from"] == 7
    sim.close()
    assert os.path.isdir(tmp_path)
