"""Fault injection in the port against the JAX package, on the CPU.

The plan grammar: every kind's ``describe()`` and every rejection equal
JAX's.  The device-side faults: a 4-broadcast run of each package, each
from its own state (``both_runs``: FedAvg over the reporting clients, a
failed round keeps the params and the leak pool), on the same JAX draws,
under each local backend with dropout off, with the plan

    nan_storm@2:clients=1,6;dropout@3:clients=0,2,7;dropout@4

(client 6 and 7 are LIE attackers): the per-broadcast ``ok`` sequence
equals JAX's, the params after every broadcast are within 2e-4 (the
ROUND_TOL of ``test_torch_port_round.py``; measured 1.3e-4 under pallas
and 1.9e-4 under xla), the stormed rows are NaN, the forced cohort's rows
equal the params it was broadcast bit for bit, and a cohort of every
client fails the broadcast.  One hyper round of each device-side kind
against JAX's in float64, within the same 2e-4.  The host-side faults:
the checkpoint managers of both packages under one plan write, fail open
and fall back alike; then the port's engine end to end.  ``both_runs``
serves ``test_torch_port_bf16.py`` too.
"""

import dataclasses
import json
import os
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_models import (
    JaxDropoutOff, as_t, dropout_off, jax_perms, max_err, seeded_params,
)
from attackfl_tpu.config import AttackSpec as JaxAttackSpec
from attackfl_tpu.config import Config as JaxConfig
from attackfl_tpu.config import MeshConfig as JaxMeshConfig
from attackfl_tpu.config import TelemetryConfig as JaxTelemetryConfig
from attackfl_tpu.data.partition import sample_round_indices as jax_sample_round_indices
from attackfl_tpu.data.synthetic import get_dataset as jax_get_dataset
from attackfl_tpu.faults import inject as jinject
from attackfl_tpu.faults import plan as jplan
from attackfl_tpu.models.icu import TransformerModel as JaxTransformerModel
from attackfl_tpu.ops import aggregators as jagg
from attackfl_tpu.training import round as jround
from attackfl_tpu.utils import checkpoint as jckpt
from attackfl_tpu_torch import cli
from attackfl_tpu_torch.config import AttackSpec, Config, MeshConfig
from attackfl_tpu_torch.data.partition import RoundDraws
from attackfl_tpu_torch.faults import inject, plan
from attackfl_tpu_torch.models.icu import TransformerModel
from attackfl_tpu_torch.ops import aggregators
from attackfl_tpu_torch.ops import pytree as pt
from attackfl_tpu_torch.training import round as tround
from attackfl_tpu_torch.training.engine import Simulator
from attackfl_tpu_torch.utils import checkpoint as ckpt
from test_torch_port_hyper_round import C as HYPER_C
from test_torch_port_hyper_round import LIE, ROUND_TOL, _np, _rounds, _worst

RUN_PLAN = "nan_storm@2:clients=1,6;dropout@3:clients=0,2,7;dropout@4"
STORMED, COHORT = [1, 6], [0, 2, 7]
SMALL = dict(total_clients=6, model="TransformerModel", data_name="ICU",
             num_data_range=(24, 32), epochs=1, batch_size=16, train_size=128, test_size=64,
             local_backend="pallas",
             attacks=(AttackSpec(mode="LIE", num_clients=1, attack_round=2),))


@dataclass
class BothRuns:
    """Per broadcast of :func:`both_runs`: each package's round output,
    the draws, and the global params each side held after it."""

    jax: list           # (stacked, sizes, new_genuine, ok, mean_loss) per broadcast
    port: list
    draws: list
    jax_params: list    # the global params after each broadcast
    port_params: list
    broadcast_params: list   # the port's params each broadcast trained from


def both_runs(jax_model, port_model, train_np: dict, *, data_name: str, backend: str,
              clients: int, epochs: int, batch: int, num_data_range: tuple[int, int],
              broadcasts: int, fault_plan: str = "", compute_dtype: str = "float32",
              attack: dict | None = None, seed: int = 0) -> BothRuns:
    """``broadcasts`` broadcasts of each package, each side from its own
    state as its engine carries it: the round step (under ``backend``,
    dropout off, the plan ``fault_plan``, ``compute_dtype``), and on an ok
    round FedAvg over the reporting clients, the leak pool and
    ``have_genuine``; a failed round keeps the params and the pool.  The
    port's round takes a ``RoundDraws`` record of each broadcast's JAX
    keys (the JAX key of broadcast b is ``fold_in(key, b)``)."""
    lo, hi = num_data_range
    pool = len(train_np["label"])
    shared = dict(total_clients=clients, mode="fedavg", model=type(port_model).__name__,
                  data_name=data_name, num_data_range=num_data_range, epochs=epochs,
                  batch_size=batch, train_size=pool, test_size=16, local_backend=backend,
                  genuine_rate=0.5)
    jcfg = JaxConfig(**shared, prng_impl="threefry2x32",
                     attacks=(JaxAttackSpec(**attack),) if attack else (),
                     faults=jplan.parse_fault_plan(fault_plan),
                     mesh=JaxMeshConfig(compute_dtype=compute_dtype),
                     telemetry=JaxTelemetryConfig(enabled=False))
    tcfg = Config(**shared, attacks=(AttackSpec(**attack),) if attack else (),
                  faults=plan.parse_fault_plan(fault_plan),
                  mesh=MeshConfig(compute_dtype=compute_dtype))
    jgroups, genuine = jround.build_attack_groups(jcfg)
    tgroups, tgenuine = tround.build_attack_groups(tcfg)
    assert [g.indices for g in tgroups] == [g.indices for g in jgroups] and tgenuine == genuine
    G = len(genuine)
    leak_k = max(int(jcfg.genuine_rate * G), 1)
    if backend == "xla":
        jax_model, port_model = JaxDropoutOff(jax_model), dropout_off(port_model)
    jstep = jax.jit(jround.build_round_step(
        jax_model, jcfg, {k: jnp.asarray(v) for k, v in train_np.items()}, jgroups, genuine))
    tstep = tround.build_round_step(port_model, tcfg,
                                    {k: torch.from_numpy(v) for k, v in train_np.items()},
                                    tgroups, tgenuine)
    params = seeded_params(type(port_model)(), seed)
    jparams = pt.tree_map(jnp.asarray, params)
    tparams = pt.tree_map(torch.from_numpy, params)
    jprev = pt.tree_map(lambda x: jnp.zeros((G,) + x.shape, x.dtype), params)
    tprev = pt.tree_map(lambda x: torch.zeros((G,) + x.shape, dtype=torch.float32), params)
    jhave = thave = False
    key = jax.random.key(5 + seed, impl="threefry2x32")
    out = BothRuns([], [], [], [], [], [])
    for b in range(1, broadcasts + 1):
        rng = jax.random.fold_in(key, b)
        jout = jstep(jparams, jprev, jnp.asarray(jhave), rng, jnp.asarray(b))
        k_data, k_train, k_attack = jax.random.split(rng, 3)
        idx, mask, sizes = jax_sample_round_indices(k_data, clients, pool, lo, hi)
        leaks = []
        for gi, grp in enumerate(jgroups):
            keys = jax.random.split(jax.random.fold_in(k_attack, gi), len(grp.indices))
            leaks.append(as_t(jax.vmap(lambda k: jax.random.choice(
                jax.random.split(k)[0], G, (leak_k,), replace=False))(keys)))
        draws = RoundDraws(idx=as_t(idx), mask=torch.from_numpy(np.array(mask)),
                           sizes=as_t(sizes),
                           perms=jax_perms(jax.random.split(k_train, clients), epochs, hi),
                           dropout_seed=0, leaks=tuple(leaks))
        tout = tstep(tparams, tprev, thave, draws, b)
        out.broadcast_params.append(tparams)
        if bool(jout[3]):
            jsizes = jout[1]
            jparams = jagg.fedavg(jout[0], jsizes * (jsizes > 0))
            jhave = True
        jprev = jout[2]
        if bool(tout[3]):
            tsizes = tout[1]
            tparams = aggregators.fedavg(tout[0], tsizes.to(torch.float32) * (tsizes > 0))
            thave = True
        tprev = tout[2]
        out.jax.append(jout)
        out.port.append(tout)
        out.draws.append(draws)
        out.jax_params.append(jparams)
        out.port_params.append(tparams)
    return out


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

def _spec_kwargs(kind: str) -> dict:
    kw = {"kind": kind, "round": 3}
    if kind in jplan.DEVICE_FAULT_KINDS:
        kw["clients"] = (0, 2)
    if kind in ("ckpt_write_error", "submit_flood", "preempt_storm", "estimate_skew"):
        kw["count"] = 2
    return kw


@pytest.mark.parametrize("kind", jplan.FAULT_KINDS)
def test_every_kind_describes_as_jax(kind):
    assert plan.FAULT_KINDS == jplan.FAULT_KINDS
    ours = plan.FaultSpec(**_spec_kwargs(kind))
    assert ours.describe() == jplan.FaultSpec(**_spec_kwargs(kind)).describe()
    grammar = f"{kind}@3" + "".join(
        f":{k}={','.join(map(str, v)) if k == 'clients' else v}"
        for k, v in _spec_kwargs(kind).items() if k in ("clients", "count"))
    assert [s.describe() for s in plan.parse_fault_plan(grammar)] == \
        [s.describe() for s in jplan.parse_fault_plan(grammar)] == [ours.describe()]


@pytest.mark.parametrize("build,match", [
    (lambda m: m.parse_fault_plan("nan_bomb@3"), "Unknown fault kind"),
    (lambda m: m.parse_fault_plan("nan_storm"), "kind@round"),
    (lambda m: m.parse_fault_plan("nan_storm@3:sigma=2"), "unknown option"),
    (lambda m: m.parse_fault_plan("nan_storm@x"), "is not an integer"),
    (lambda m: m.FaultSpec(kind="writer_death", round=2, clients=(0,)), "no client cohort"),
    (lambda m: m.faults_from_config([{"kind": "dropout", "round": 1, "seed": 3}]),
     "unknown key"),
])
def test_garbage_is_rejected_as_jax_rejects_it(build, match):
    messages = []
    for module in (plan, jplan):
        with pytest.raises(ValueError, match=match) as err:
            build(module)
        messages.append(str(err.value))
    assert messages[0] == messages[1]


def test_yaml_and_cli_plans_agree():
    grammar = "nan_storm@3:clients=0,1;ckpt_write_error@2:count=2;writer_death@4"
    mappings = [{"kind": "nan_storm", "round": 3, "clients": [0, 1]},
                {"kind": "ckpt_write_error", "round": 2, "count": 2},
                {"kind": "writer_death", "round": 4}]
    assert plan.faults_from_config(mappings) == plan.parse_fault_plan(grammar)
    assert [s.describe() for s in plan.faults_from_config(mappings)] == \
        [s.describe() for s in jplan.faults_from_config(mappings)]


def test_fire_mask_is_jax_mask():
    specs = plan.parse_fault_plan("dropout@2:clients=1,3;dropout@4;nan_storm@2:clients=0")
    jspecs = jplan.parse_fault_plan("dropout@2:clients=1,3;dropout@4;nan_storm@2:clients=0")
    for kind in jplan.DEVICE_FAULT_KINDS:
        ours = inject.build_client_fault_fn(specs, 5, kind)
        ref = jinject.build_client_fault_fn(jspecs, 5, kind)
        for b in range(1, 6):
            assert ours(b).tolist() == np.asarray(ref(jnp.asarray(b))).tolist()
    assert inject.build_client_fault_fn(plan.parse_fault_plan("ckpt_torn@1"), 5,
                                        "dropout") is None
    with pytest.raises(ValueError, match="out of range"):
        inject.build_client_fault_fn(plan.parse_fault_plan("nan_storm@1:clients=5"), 5,
                                     "nan_storm")


# ---------------------------------------------------------------------------
# device-side faults: a 4-broadcast run of each package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["pallas", "xla"])
def fault_runs(request):
    train_np = jax_get_dataset("ICU", "train", 256, 1)
    return both_runs(JaxTransformerModel(), TransformerModel(), train_np, data_name="ICU",
                     backend=request.param, clients=8, epochs=2, batch=16,
                     num_data_range=(24, 32), broadcasts=4, fault_plan=RUN_PLAN,
                     attack=dict(mode="LIE", num_clients=2, attack_round=1, args=(0.74,)))


def test_fault_run_ok_sequence_is_jax(fault_runs):
    ours = [bool(out[3]) for out in fault_runs.port]
    assert ours == [bool(out[3]) for out in fault_runs.jax] == [True, False, True, False]


def test_fault_run_params_match_jax(fault_runs):
    for ours, ref in zip(fault_runs.port_params, fault_runs.jax_params):
        assert max_err(ours, ref) <= 2e-4
    # the broadcast after the storm retried cleanly from the same params
    assert all(torch.equal(a, b) for a, b in zip(pt.tree_leaves(fault_runs.port_params[0]),
                                                 pt.tree_leaves(fault_runs.port_params[1])))


def test_fault_run_storm_rows_and_leak_pool(fault_runs):
    stacked, _, pool, ok, _ = fault_runs.port[1]
    jstacked = fault_runs.jax[1][0]
    for (path, x), (_, y) in zip(pt.tree_items(stacked), pt.tree_items(_np(jstacked))):
        assert torch.isnan(x[STORMED]).all() and np.isnan(y[STORMED]).all(), path
        others = [c for c in range(8) if c not in STORMED]
        assert torch.isfinite(x[others]).all(), path
    # a failed broadcast leaves the leak pool as it was
    before = fault_runs.port[0][2]
    assert all(torch.equal(a, b) for a, b in zip(pt.tree_leaves(pool), pt.tree_leaves(before)))


def test_fault_run_cohort_rows_are_the_broadcast(fault_runs):
    """Broadcast 3's cohort (two genuine clients and a LIE attacker)
    reports the params it was broadcast, bit for bit, with size 0; JAX's
    sizes agree."""
    stacked, sizes, _, _, _ = fault_runs.port[2]
    sent = fault_runs.broadcast_params[2]
    for (path, x), (_, p) in zip(pt.tree_items(stacked), pt.tree_items(sent)):
        for c in COHORT:
            assert torch.equal(x[c], p), (path, c)
    assert sizes[COHORT].tolist() == [0, 0, 0]
    assert sizes.tolist() == np.asarray(fault_runs.jax[2][1]).tolist()
    assert abs(float(fault_runs.port[2][4]) - float(fault_runs.jax[2][4])) <= 1e-4


def test_fault_run_cohort_of_every_client_fails(fault_runs):
    stacked, sizes, pool, ok, _ = fault_runs.port[3]
    assert not bool(ok) and int(sizes.sum()) == 0
    sent = fault_runs.broadcast_params[3]
    for (path, x), (_, p) in zip(pt.tree_items(stacked), pt.tree_items(sent)):
        assert torch.equal(x, p.expand_as(x)), path
    assert all(torch.equal(a, b) for a, b in zip(pt.tree_leaves(pool),
                                                 pt.tree_leaves(fault_runs.port[2][2])))


@pytest.mark.parametrize("fault_plan,ok", [("nan_storm@1:clients=2", False),
                                           ("dropout@1:clients=1,3", True)])
def test_hyper_round_faults_match_jax(fault_plan, ok):
    """One hyper round (float64) with each device-side kind: ``ok``, every
    row and the leak pool as JAX's within ROUND_TOL; stormed rows NaN,
    the cohort's rows the rows it was broadcast."""
    ours, jout, (hnet, *_, inputs), _ = _rounds("HyperNetwork", (LIE,), plan=fault_plan)
    stacked, sizes, pool, t_ok, _ = ours
    assert bool(t_ok) == bool(jout[3]) == ok
    clients = [int(c) for c in fault_plan.split("=")[1].split(",")]
    rest = [c for c in range(HYPER_C) if c not in clients]
    jstacked = _np(jout[0])
    assert _worst(pt.tree_take(stacked, rest), pt.tree_take(jstacked, rest)) <= ROUND_TOL
    assert _worst(pool, jout[2]) <= ROUND_TOL
    if ok:
        broadcast, _ = hnet.generate_all(inputs[0])
        for (_, a), (_, b) in zip(pt.tree_items(pt.tree_take(stacked, clients)),
                                  pt.tree_items(pt.tree_take(broadcast, clients))):
            assert torch.equal(a, b)
        assert sizes[clients].tolist() == [0] * len(clients)
    else:
        assert all(bool(torch.isnan(x[clients]).all()) for x in pt.tree_leaves(stacked))


# ---------------------------------------------------------------------------
# host-side faults
# ---------------------------------------------------------------------------

class _JaxTelemetryStub:
    """What JAX's HostFaultInjector and CheckpointManager read of the
    telemetry: counters and events that record nothing."""

    class _Sink:
        def inc(self, *a, **k):
            pass

        def emit(self, *a, **k):
            pass

    counters = events = _Sink()


def test_checkpoint_faults_write_fail_open_and_fall_back_as_jax(tmp_path):
    """Rounds 1-4 through each package's manager under one plan: the
    write results, the manifest rounds, the fallback past the torn entry
    and the reasons' kinds are equal."""
    fault_plan = "ckpt_write_error@2:count=6;ckpt_torn@4"
    state = {"w": np.arange(64, dtype=np.float32)}
    results = {}
    for name, module, inj in (
            ("port", ckpt, inject.HostFaultInjector(plan.parse_fault_plan(fault_plan))),
            ("jax", jckpt, jinject.HostFaultInjector(jplan.parse_fault_plan(fault_plan),
                                                     _JaxTelemetryStub()))):
        directory = tmp_path / name
        directory.mkdir()
        suffix = ".pth" if name == "port" else ".msgpack"
        kw = dict(fingerprint="f", keep=3, backoff=0.0, injector=inj)
        manager = module.CheckpointManager(str(directory / f"M{suffix}"), **kw)
        written = []
        for r in range(1, 5):
            tree = {"w": torch.from_numpy(state["w"] + r)} if name == "port" else \
                {"w": state["w"] + r}
            meta = {"round": r, "broadcast": r}
            if name == "port":
                written.append(manager.write(tree, meta))
            else:
                written.append(manager.write(manager.path, tree, meta))
        template = {"w": torch.zeros(64)} if name == "port" else {"w": np.zeros(64, np.float32)}
        loaded = manager.load_latest(template)
        results[name] = (written, [e["round"] for e in manager.read_manifest()["entries"]],
                         loaded.entry["round"], [r.split(":")[0] for _, r in loaded.rejected],
                         float(np.asarray(loaded.state["w"])[0]))
    # round 2's four attempts fail (fail open), round 3 takes the last two
    # failures of the budget and succeeds on its third attempt; round 4 is
    # torn, so the load falls back to round 3
    assert results["port"] == results["jax"]
    assert results["port"] == ([True, False, True, True], [1, 3, 4], 3, ["torn/truncated"],
                               3.0)


def _run_cfg(tmp_path, **kw):
    return Config(**{**SMALL, "num_round": 3, "log_path": str(tmp_path),
                     "checkpoint_dir": str(tmp_path), **kw})


def test_engine_nan_storm_retries_clean(tmp_path):
    """A stormed broadcast fails once; its retry (the next broadcast) runs
    clean, and the injector records the firing once the round resolves."""
    sim = Simulator(_run_cfg(tmp_path, faults=plan.parse_fault_plan("nan_storm@2")),
                    device="cpu")
    state, history = sim.run(verbose=False)
    assert [(h["broadcast"], h["ok"]) for h in history] == \
        [(1, True), (2, False), (3, True), (4, True)]
    assert state["completed_rounds"] == 3
    assert sim.fault_injector.records == [
        {"fault": "nan_storm", "action": "injected", "round": 2, "clients": [],
         "device_side": True}]


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_engine_forced_dropout_from_yaml_and_cli(tmp_path, monkeypatch, capsys, backend):
    """A YAML ``faults:`` section and ``--inject-faults`` give the same
    run; a cohort of every client fails its broadcast and the next one
    succeeds."""
    monkeypatch.chdir(tmp_path)
    runs = {}
    shape = Simulator(Config(**{**SMALL, "attacks": ()}), device="cpu")
    template = shape.host_state(shape.init_state())
    for how in ("yaml", "cli"):
        (tmp_path / how).mkdir()
        faults = ("faults: [{kind: dropout, round: 2, clients: [0, 3]}, "
                  "{kind: dropout, round: 3}]\n" if how == "yaml" else "")
        cfg = tmp_path / how / "cfg.yaml"
        cfg.write_text(
            "server: {num-round: 3, clients: 6, data-name: ICU, model: TransformerModel,\n"
            "         train-size: 128, test-size: 64,\n"
            "         data-distribution: {num-data-range: [16, 24]}}\n"
            "learning: {epoch: 1, batch-size: 16}\n"
            f"tpu: {{local-backend: {backend}}}\n"
            f"log_path: {tmp_path / how}\n" + faults)
        argv = ["run", "--config", str(cfg), "--device", "cpu"]
        if how == "cli":
            argv += ["--inject-faults", "dropout@2:clients=0,3;dropout@3"]
        assert cli.main(argv) == 0
        out = capsys.readouterr().out
        assert "Training failed!" in out and "Finished: 3 successful rounds." in out
        runs[how] = ckpt.load_state(os.path.join(tmp_path, how, "TransformerModel.pth"),
                                    template)
    assert runs["yaml"]["broadcasts"] == runs["cli"]["broadcasts"] == 4
    for a, b in zip(pt.tree_leaves(runs["yaml"]["global_params"]),
                    pt.tree_leaves(runs["cli"]["global_params"])):
        assert torch.equal(a, b)


def test_engine_write_error_retries_then_succeeds(tmp_path):
    sim = Simulator(_run_cfg(tmp_path, faults=plan.parse_fault_plan(
        "ckpt_write_error@1:count=2")), device="cpu")
    sim.checkpoints.backoff = 0.0
    sim.run(verbose=False)
    entries = sim.checkpoints.read_manifest()["entries"]
    assert [e["round"] for e in entries] == [1, 2, 3] and sim.checkpoints.write_failures == 0
    assert [r["fault"] for r in sim.fault_injector.records] == ["ckpt_write_error"] * 2


def test_engine_write_error_beyond_the_retries_fails_open(tmp_path):
    sim = Simulator(_run_cfg(tmp_path, faults=plan.parse_fault_plan(
        "ckpt_write_error@2:count=4")), device="cpu")
    sim.checkpoints.backoff = 0.0
    state, history = sim.run(verbose=False)
    assert all(h["ok"] for h in history) and state["completed_rounds"] == 3
    assert [e["round"] for e in sim.checkpoints.read_manifest()["entries"]] == [1, 3]
    assert sim.checkpoints.write_failures == 1
    assert not any(".tmp" in name for name in os.listdir(tmp_path))


def test_engine_torn_entry_resume_falls_back_bit_identical(tmp_path, capsys):
    """Two rounds with round 2's entry torn, then a resumed Simulator: it
    rejects the torn entry, continues from round 1 and ends on the bits
    of the run without a stop."""
    whole, _ = Simulator(_run_cfg(tmp_path / "whole"), device="cpu").run(verbose=False)
    cut = tmp_path / "cut"
    Simulator(_run_cfg(cut, faults=plan.parse_fault_plan("ckpt_torn@2")),
              device="cpu").run(num_rounds=2, verbose=False)
    resumed_sim = Simulator(_run_cfg(cut, resume=True), device="cpu")
    resumed, history = resumed_sim.run(verbose=False)
    out = capsys.readouterr().out
    assert "torn/truncated" in out and "continuing from round 1" in out
    assert [h["round"] for h in history] == [2, 3]
    for key in ("global_params", "prev_genuine"):
        for a, b in zip(pt.tree_leaves(resumed[key]), pt.tree_leaves(whole[key])):
            assert torch.equal(a, b)
    assert torch.equal(resumed["rng"].get_state(), whole["rng"].get_state())


def test_config_faults_survive_asdict():
    """The plan on the Config flattens as JAX's does (the fingerprint and
    the YAML round trip read ``dataclasses.asdict``), and its records are
    JSON."""
    from attackfl_tpu.config import Config as JaxConfig

    cfg = Config(**SMALL, faults=plan.parse_fault_plan("nan_storm@2:clients=1"))
    jcfg = JaxConfig(total_clients=6, faults=jplan.parse_fault_plan("nan_storm@2:clients=1"))
    assert dataclasses.asdict(cfg)["faults"] == dataclasses.asdict(jcfg)["faults"]
    assert json.dumps([s.describe() for s in cfg.faults]) == \
        '[{"fault": "nan_storm", "round": 2, "clients": [1]}]'
