"""The port's depth-k pipelined executor (``Simulator.run(pipeline=True)``,
``_run_pipelined``) and the executors' stop seam on the CPU, at a small
size (TransformerModel on ICU, 8 clients, 2 epochs, batch 16).

1. Against the port's own ``run``: the final state bit for bit
   (``torch.equal`` on every leaf, the generator's state included), the
   same ok sequence, rounds and broadcasts, and the metrics equal
   wherever both report them; at depths 0, 1, 2 and one deeper than the
   rounds, under both backends and under the fault plan of
   ``test_torch_port_faults.py``; for hyper mode (``HyperNetwork``,
   sequential), ``validation_async``, ``validation_every 2``, ``"auto"``
   and the deepest depth the config takes.
2. JAX's edges: a rollback while four rounds are in flight, demotion to
   depth 0 and re-promotion to the configured depth with one fused body
   built, the retry cap, each ok round's own state checkpointed (synchronous writer and
   async) and a resume that continues the numbering, the fallback of the
   host-side modes, ``auto_depth_from_records`` equal to JAX's, the depth
   ``"auto"`` resolves to and its checkpoint cap.
3. Against the JAX package's ``run(pipeline=True)`` under ``xla`` on the
   same config and plan: the same keys in the same order per entry, the
   same ok sequence, rounds and broadcasts.
4. The stop seam on ``run``, ``run_fast`` and the pipeline: where each
   stops, the rounds in flight resolved and checkpointed, the string
   verdict kept as ``_stop_reason``, a raising hook still draining the
   async writer; ``run``'s and the pipeline's stops against JAX's.
"""

import os

import numpy as np
import pytest
import torch
from _torch_port_threads import one_torch_thread  # noqa: F401

from attackfl_tpu_torch.config import MAX_PIPELINE_DEPTH, Config, HyperDetectionConfig
from attackfl_tpu_torch.faults.plan import parse_fault_plan
from attackfl_tpu_torch.ops import pytree as pt
from attackfl_tpu_torch.training import engine
from attackfl_tpu_torch.training.engine import Simulator
from attackfl_tpu_torch.utils import checkpoint as ckpt
from test_torch_port_fused_rounds import RUN_ONLY, RUN_PLAN, SMALL, _assert_same_state, _cfg

# the stop hook of the stop-seam cases: stop once two rounds are done
STOP_AT = 2


def _same_value(a, b) -> bool:
    return a == b or (isinstance(a, float) and isinstance(b, float) and np.isnan(a)
                      and np.isnan(b))


def _drain_stop(done: int):
    return "drain" if done >= STOP_AT else None


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """``run``'s (state, history) of a config, each computed once."""
    memo: dict = {}

    def get(key: str, cfg: Config):
        if key not in memo:
            sim = Simulator(cfg.replace(log_path=str(tmp_path_factory.mktemp("run"))),
                            device="cpu")
            memo[key] = sim.run(state=sim.init_state(), save_checkpoints=False,
                                verbose=False, pipeline=False)
        return memo[key]

    return get


# name: (config overrides, the key of run's reference)
CASES = {
    "depth0": (dict(pipeline_depth=0), "lie"),
    "depth1": (dict(pipeline_depth=1), "lie"),
    "depth2": (dict(pipeline_depth=2), "lie"),
    "deeper": (dict(pipeline_depth=SMALL["num_round"] + 1), "lie"),
    "plan": (dict(pipeline_depth=2, faults=parse_fault_plan(RUN_PLAN)), "plan"),
}
EXTRA = {
    "hyper": (dict(pipeline_depth=2, mode="hyper", epochs=1), "hyper"),
    "validation-async": (dict(pipeline_depth=2, validation_async=True), "async"),
    "validation-every-2": (dict(pipeline_depth=2, validation_every=2, num_round=4),
                           "every2"),
    "auto": (dict(pipeline_depth="auto"), "lie"),
    "max-depth": (dict(pipeline_depth=MAX_PIPELINE_DEPTH), "lie"),
}
PARAMS = ([pytest.param(name, backend, id=f"{name}-{backend}")
           for name in CASES for backend in ("pallas", "xla")]
          + [pytest.param("hyper", "xla", id="hyper-xla"),
             pytest.param("validation-async", "pallas", id="validation-async-pallas"),
             pytest.param("validation-every-2", "xla", id="validation-every-2-xla"),
             pytest.param("auto", "pallas", id="auto-pallas"),
             pytest.param("max-depth", "xla", id="max-depth-xla")])


@pytest.mark.parametrize("name,backend", PARAMS)
def test_pipeline_equals_run_bit_for_bit(name, backend, tmp_path, reference):
    kw, ref = {**CASES, **EXTRA}[name]
    depth_free = {k: v for k, v in kw.items() if k != "pipeline_depth"}
    run_state, run_hist = reference(f"{ref}-{backend}",
                                    _cfg(tmp_path, local_backend=backend, **depth_free))
    sim = Simulator(_cfg(tmp_path, local_backend=backend, pipeline=True, **kw), device="cpu")
    state, hist = sim.run(state=sim.init_state(), save_checkpoints=False, verbose=False)
    _assert_same_state(run_state, state)
    assert [h["ok"] for h in hist] == [h["ok"] for h in run_hist]
    assert [(h["round"], h["broadcast"]) for h in hist] == \
        [(h["round"], h["broadcast"]) for h in run_hist]
    assert all(h["pipelined"] for h in hist)
    for r, p in zip(run_hist, hist):
        shared = [k for k in r if k in p and k != "seconds"]
        assert all(_same_value(r[k], p[k]) for k in shared), (r, p)
        if r["ok"]:
            assert set(r) - {"seconds", *RUN_ONLY} <= set(p), (r, p)
    if name == "plan":
        assert [h["ok"] for h in hist] == [True, False, True, False, True]
    if name == "validation-every-2":
        assert [np.isnan(h["roc_auc"]) for h in hist] == [True, False, True, False]
    if name == "validation-async":
        assert all(h["validation_ok"] for h in hist)
    if name == "auto":
        assert sim._depth_resolved == 1


def test_rollback_mid_queue_matches_run(tmp_path):
    """A failed round while four rounds are in flight (JAX
    ``test_depth_k_rollback_mid_queue_matches_sync``, the fault plan in
    place of its monkeypatch): the rounds dispatched after it trained from
    the kept params, so nothing is dispatched again."""
    kw = dict(num_round=4, validation=False, local_backend="xla",
              faults=parse_fault_plan("nan_storm@3"))
    sync = Simulator(_cfg(tmp_path / "run", **kw), device="cpu")
    run_state, run_hist = sync.run(state=sync.init_state(), save_checkpoints=False,
                                   verbose=False)
    sim = Simulator(_cfg(tmp_path / "pipe", pipeline=True, pipeline_depth=4, **kw),
                    device="cpu")
    state, hist = sim.run(state=sim.init_state(), save_checkpoints=False, verbose=False)
    assert [h["ok"] for h in hist] == [h["ok"] for h in run_hist] == [True, True, False,
                                                                      True, True]
    assert state["completed_rounds"] == 4 and state["broadcasts"] == run_state["broadcasts"] == 5
    _assert_same_state(run_state, state)


def test_demotion_and_repromotion_to_the_configured_depth(tmp_path, monkeypatch, capsys):
    """Broadcasts 2 and 3 fail: after two rollbacks the loop resolves one
    round at a time, and after two clean rounds it returns to depth 3,
    not 1 (JAX ``test_repromotion_targets_configured_depth_without_retracing``).
    Every depth calls the one fused body, built once.  The params are
    ``run``'s."""
    kw = dict(num_round=4, validation=False, local_backend="pallas",
              faults=parse_fault_plan("nan_storm@2;nan_storm@3"))
    sync = Simulator(_cfg(tmp_path / "run", **kw), device="cpu")
    run_state, run_hist = sync.run(state=sync.init_state(), save_checkpoints=False,
                                   verbose=False)
    sim = Simulator(_cfg(tmp_path / "pipe", pipeline=True, pipeline_depth=3,
                         pipeline_demote_after=2, pipeline_repromote_after=2, **kw),
                    device="cpu")
    builds = []
    build = sim._build_fused_body

    def counting(include_eval=True):
        builds.append(include_eval)
        return build(include_eval)

    monkeypatch.setattr(sim, "_build_fused_body", counting)
    state, hist = sim.run(num_rounds=1, state=sim.init_state(), save_checkpoints=False,
                          verbose=False)
    capsys.readouterr()
    state, rest = sim.run(state=state, save_checkpoints=False, verbose=False)
    hist += rest
    assert builds == [False]
    _assert_same_state(run_state, state)
    assert [h["ok"] for h in hist] == [h["ok"] for h in run_hist] == [True, False, False,
                                                                      True, True, True]
    assert [h.get("degraded", False) for h in hist] == [False, False, False, True, True,
                                                        False]
    out = capsys.readouterr().out
    assert ("[pipeline] 2 consecutive rollbacks — demoting from depth-3 to synchronous "
            "(depth-0) resolution") in out
    assert "[pipeline] re-promoted to depth-3 after 2 clean rounds" in out
    assert "re-promoted to depth-1" not in out
    log = (tmp_path / "pipe" / "app.log").read_text()
    assert "Round 2 failed (retry 1)" in log and "Round 2 failed (retry 2)" in log


def test_retry_cap_raises_and_drains(tmp_path, monkeypatch):
    """With the cap at 0 the first failed round raises once it resolves,
    as JAX's loop does; its fault is noted and the async writer drained,
    so the round before it is on disk."""
    monkeypatch.setattr(engine, "MAX_ROUND_RETRIES", 0)
    sim = Simulator(_cfg(tmp_path, local_backend="xla", pipeline=True, pipeline_depth=2,
                         checkpoint_async=True, faults=parse_fault_plan("nan_storm@2")),
                    device="cpu")
    with pytest.raises(RuntimeError, match="Round 2 failed 1 times"):
        sim.run(verbose=False)
    assert [r["round"] for r in sim.fault_injector.records] == [2]
    assert [e["round"] for e in sim.checkpoints.read_manifest()["entries"]] == [1]
    sim.close()


def _entry_states(sim: Simulator) -> dict[int, dict]:
    """Each manifest entry's state, by its round."""
    template = sim.host_state(sim.init_state())
    out = {}
    for entry in sim.checkpoints.read_manifest()["entries"]:
        out[entry["round"]] = ckpt.load_state(
            os.path.join(sim.checkpoints.directory, entry["file"]), template)
    return out


def _assert_same_host_state(a: dict, b: dict) -> None:
    for key in sorted(a):
        x, y = a[key], b[key]
        if isinstance(x, dict):
            assert all(torch.equal(p, q) for p, q in zip(pt.tree_leaves(x), pt.tree_leaves(y)))
        elif isinstance(x, torch.Tensor):
            assert torch.equal(x, y), key
        else:
            assert type(x) is type(y) and x == y, key


@pytest.mark.parametrize("writer", ["sync", "async"])
def test_checkpoints_are_runs_entries_and_resume_continues(writer, tmp_path):
    """Depth 2: each ok round's own state is saved when it resolves, the
    entry ``run`` writes for that round (the async writer may coalesce a
    submit into the next, so its entries end on round 3); a resume
    continues the round numbering and ends on the uninterrupted run's
    bits."""
    sync = Simulator(_cfg(tmp_path / "run", local_backend="xla"), device="cpu")
    sync.run(verbose=False)
    pipe = dict(local_backend="xla", checkpoint_async=writer == "async", pipeline=True,
                pipeline_depth=2)
    sim = Simulator(_cfg(tmp_path / "whole", **pipe), device="cpu")
    whole, _ = sim.run(verbose=False)
    sim.close()
    ours, theirs = _entry_states(sim), _entry_states(sync)
    assert sorted(theirs) == [1, 2, 3] and max(ours) == 3
    assert sorted(ours) == [1, 2, 3] or writer == "async"
    for round_no in ours:
        _assert_same_host_state(ours[round_no], theirs[round_no])

    cut = Simulator(_cfg(tmp_path / "cut", **pipe), device="cpu")
    cut.run(num_rounds=2, verbose=False)
    cut.close()
    resumed_sim = Simulator(_cfg(tmp_path / "cut", resume=True, **pipe), device="cpu")
    resumed, history = resumed_sim.run(verbose=False)
    resumed_sim.close()
    assert [(h["round"], h["broadcast"]) for h in history] == [(3, 3)]
    _assert_same_state(resumed, whole)


@pytest.mark.parametrize("kw,mode", [
    (dict(mode="gmm"), "gmm"),
    (dict(mode="fltracer"), "fltracer"),
    (dict(mode="hyper", epochs=1,
          hyper_detection=HyperDetectionConfig(enable=True, start_round=2)), "hyper"),
])
def test_host_side_modes_fall_back_with_jaxs_line(kw, mode, tmp_path, capsys):
    sim = Simulator(_cfg(tmp_path, num_round=1, local_backend="xla", pipeline=True,
                         pipeline_depth=2, **kw), device="cpu")
    _, history = sim.run(save_checkpoints=False, verbose=False)
    out = capsys.readouterr().out
    assert (f"[pipeline] mode '{mode}' needs host-side per-round work; falling back to the "
            "synchronous path.") in out
    assert len(history) == 1 and "pipelined" not in history[0]
    assert sim._depth_resolved is None


def _depth_records(fingerprint, device, host, n=3, **extra):
    return [{"ledger_schema": 1, "source": "run", "executor": "pipelined",
             "fingerprint": fingerprint, "rounds": 5, "ok_rounds": 5,
             "time_attribution": {}, "counts": {},
             "round_device_time": device, "host_resolution_latency": host, **extra}
            for _ in range(n)]


def test_auto_depth_from_records_equals_jaxs():
    """JAX's ``tests/test_pipeline.py`` cases, then the window and the
    checkpoint term, through both functions."""
    from attackfl_tpu.training.engine import auto_depth_from_records as jax_auto_depth

    records = _depth_records("fp", device=0.1, host=0.35)
    k, info = engine.auto_depth_from_records(records, "fp")
    assert k == 4 and info["ratio"] == 3.5 and info["peers"] == 3
    assert engine.auto_depth_from_records(_depth_records("fp", 0.5, 0.1), "fp")[0] == 1
    k, info = engine.auto_depth_from_records(records, "other")
    assert k is None and info["reason"] == "no_ledger_peers"
    assert engine.auto_depth_from_records([], "fp")[0] is None
    # the window: the newest five of seven; the checkpoint term: 2.0 s over
    # 5 rounds adds 0.4 s a round to the host's latency
    window = (_depth_records("fp", 1.0, 9.0, n=2) + _depth_records("fp", 0.1, 0.05, n=5)
              + _depth_records("other", 0.1, 5.0))
    ckpt_term = _depth_records("fp", 0.2, 0.1, time_attribution={"checkpoint_s": 2.0})
    invalid = [{"fingerprint": "fp", "round_device_time": 0.0, "host_resolution_latency": 1},
               {"fingerprint": "fp", "round_device_time": True, "host_resolution_latency": 1},
               {"fingerprint": "fp", "round_device_time": 0.1, "host_resolution_latency": -1}]
    for recs in (records, window, ckpt_term, invalid, invalid + ckpt_term, []):
        for window_size in (5, 2):
            assert engine.auto_depth_from_records(recs, "fp", window_size) == \
                jax_auto_depth(recs, "fp", window_size)
    assert engine.auto_depth_from_records(window, "fp")[0] == 1
    assert engine.auto_depth_from_records(ckpt_term, "fp") == (3, {
        "round_device_time": 0.2, "host_latency_per_round": 0.5, "ratio": 2.5, "peers": 3})


def test_resolve_pipeline_depth(tmp_path, monkeypatch, capsys):
    """An int is used as it is; ``"auto"`` with no ledger is depth 1 with
    JAX's yellow line; a pick is capped at 2 under a synchronous
    checkpoint every round, and at ``AUTO_DEPTH_CAP``.  The ledger is this
    test's own: the suite's shared one holds the records of earlier runs
    of this config."""
    monkeypatch.setenv("ATTACKFL_LEDGER_DIR", str(tmp_path / "ledger"))
    sim = Simulator(_cfg(tmp_path, pipeline=True, pipeline_depth=3), device="cpu")
    assert sim.resolve_pipeline_depth() == 3
    assert sim._depth_info == {"source": "config", "depth": 3}
    auto = Simulator(_cfg(tmp_path, pipeline=True, pipeline_depth="auto"), device="cpu")
    assert auto.resolve_pipeline_depth(save_checkpoints=True) == 1
    assert auto._depth_info == {"source": "auto", "reason": "no_ledger_peers", "depth": 1}
    assert "[pipeline] depth auto: no ledger measurement for this config yet" in \
        capsys.readouterr().out

    def measured(k):
        return lambda records, fingerprint: (k, {"ratio": k - 0.5, "peers": 3})

    monkeypatch.setattr(engine, "auto_depth_from_records", measured(5))
    assert auto.resolve_pipeline_depth(save_checkpoints=True) == 2
    assert auto._depth_resolved == 2 and auto._depth_info["clamped_from"] == 5
    assert "[pipeline] depth auto -> 2 (measured host/device ratio 4.5 over 3 ledger " \
        "record(s), clamped from 5)" in capsys.readouterr().out
    assert auto.resolve_pipeline_depth(save_checkpoints=False) == 5
    writer = Simulator(_cfg(tmp_path, pipeline=True, pipeline_depth="auto",
                            checkpoint_async=True), device="cpu")
    assert writer.resolve_pipeline_depth(save_checkpoints=True) == 5
    writer.close()
    monkeypatch.setattr(engine, "auto_depth_from_records", measured(12))
    assert auto.resolve_pipeline_depth(save_checkpoints=False) == engine.AUTO_DEPTH_CAP


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX package under ``xla`` on SMALL with RUN_PLAN (one JAX
    Simulator): the pipelined run at depth 2, then from a fresh state the
    pipelined and the synchronous run to 5 rounds with the stop hook."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from attackfl_tpu.config import AttackSpec as JaxAttackSpec
    from attackfl_tpu.config import Config as JaxConfig
    from attackfl_tpu.config import TelemetryConfig as JaxTelemetryConfig
    from attackfl_tpu.faults.plan import parse_fault_plan as jax_parse_fault_plan
    from attackfl_tpu.training.engine import Simulator as JaxSimulator

    path = str(tmp_path_factory.mktemp("jax"))
    shared = {k: v for k, v in SMALL.items() if k != "attacks"}
    jcfg = JaxConfig(**shared, local_backend="xla", log_path=path, checkpoint_dir=path,
                     attacks=(JaxAttackSpec(mode="LIE", num_clients=2, attack_round=2),),
                     faults=jax_parse_fault_plan(RUN_PLAN), pipeline=True, pipeline_depth=2,
                     telemetry=JaxTelemetryConfig(enabled=False))
    jsim = JaxSimulator(jcfg)
    _, full = jsim.run(state=jsim.init_state(), save_checkpoints=False, verbose=False)
    out = {"full": full}
    for how in ("pipeline", "run"):
        jsim._stop_reason = None
        _, hist = jsim.run(num_rounds=5, state=jsim.init_state(), save_checkpoints=False,
                           verbose=False, pipeline=how == "pipeline", stop=_drain_stop)
        out[how] = (hist, jsim._stop_reason)
    jsim.close()
    return out


def test_history_matches_jax_pipeline(tmp_path, jax_runs):
    sim = Simulator(_cfg(tmp_path, local_backend="xla", pipeline=True, pipeline_depth=2,
                         faults=parse_fault_plan(RUN_PLAN)), device="cpu")
    _, hist = sim.run(state=sim.init_state(), save_checkpoints=False, verbose=False)
    jhist = jax_runs["full"]
    assert [list(h) for h in hist] == [list(h) for h in jhist]
    assert [h["ok"] for h in hist] == [h["ok"] for h in jhist] == [True, False, True, False,
                                                                  True]
    assert [(h["round"], h["broadcast"]) for h in hist] == \
        [(h["round"], h["broadcast"]) for h in jhist]
    for ours, theirs in zip(hist, jhist):
        for key in ("roc_auc", "metric"):
            assert np.isnan(ours[key]) == np.isnan(theirs[key])


@pytest.mark.parametrize("how", ["run", "pipeline"])
def test_stop_matches_jax(how, tmp_path, jax_runs):
    """The same hook stops the same round on both packages: the history's
    (round, broadcast, ok) and the kept verdict."""
    sim = Simulator(_cfg(tmp_path, local_backend="xla", pipeline_depth=2,
                         faults=parse_fault_plan(RUN_PLAN)), device="cpu")
    state, hist = sim.run(num_rounds=5, state=sim.init_state(), save_checkpoints=False,
                          verbose=False, pipeline=how == "pipeline", stop=_drain_stop)
    jhist, reason = jax_runs[how]
    key = [(h["round"], h["broadcast"], h["ok"]) for h in hist]
    assert key == [(h["round"], h["broadcast"], h["ok"]) for h in jhist]
    assert sim._stop_reason == reason == "drain"
    assert state["completed_rounds"] == sum(h["ok"] for h in hist) < 5


@pytest.mark.parametrize("how", ["run", "run_fast", "pipeline"])
def test_stop_seam_on_every_loop(how, tmp_path):
    """Stop once two rounds are done: ``run`` stops before round 3,
    ``run_fast`` between its chunks of 1, the pipeline at depth 2 stops
    dispatching and resolves and checkpoints the two rounds in flight.
    A verdict that is not a string is kept as "stopped"."""
    calls = []

    def stop(done):
        calls.append(done)
        return (True if how == "run" else "drain") if done >= STOP_AT else None

    sim = Simulator(_cfg(tmp_path, num_round=6, local_backend="xla",
                         pipeline=how == "pipeline", pipeline_depth=2), device="cpu")
    kwargs = {"chunk_size": 1} if how == "run_fast" else {}
    state, hist = getattr(sim, "run_fast" if how == "run_fast" else "run")(
        verbose=False, stop=stop, **kwargs)
    done = STOP_AT + (2 if how == "pipeline" else 0)
    assert [h["round"] for h in hist] == list(range(1, done + 1))
    assert state["completed_rounds"] == done and state["broadcasts"] == done
    assert calls[-1] == STOP_AT and all(c <= STOP_AT for c in calls)
    assert [e["round"] for e in sim.checkpoints.read_manifest()["entries"]] == \
        list(range(max(1, done - 2), done + 1))
    assert sim._stop_reason == ("stopped" if how == "run" else "drain")


@pytest.mark.parametrize("how", ["run", "run_fast", "pipeline"])
def test_raising_stop_hook_drains_the_async_writer(how, tmp_path):
    """The hook raises once a round is done: the exception leaves the
    loop through its ``finally``, which drains the async writer, so
    round 1's entry is on disk when the call raises."""
    def stop(done):
        if done >= 1:
            raise RuntimeError("worker died")

    sim = Simulator(_cfg(tmp_path, num_round=4, local_backend="xla", checkpoint_async=True,
                         pipeline=how == "pipeline", pipeline_depth=2), device="cpu")
    kwargs = {"chunk_size": 1} if how == "run_fast" else {}
    with pytest.raises(RuntimeError, match="worker died"):
        getattr(sim, "run_fast" if how == "run_fast" else "run")(
            verbose=False, stop=stop, **kwargs)
    assert sim.checkpoint_writer.writes_completed + sim.checkpoint_writer.writes_coalesced == 1
    assert [e["round"] for e in sim.checkpoints.read_manifest()["entries"]] == [1]
    sim.close()
