"""The port's client mesh over two processes against the JAX package's own
two-process run, on the CPU.

1. One session spawns the JAX package's two processes
   (``tests/_torch_port_spmd.py jax-round``: ``jax.distributed`` over
   127.0.0.1 with JAX's gloo CPU collectives switched on in the child, 4
   virtual CPU devices a process) and the port's two (``port-round``: 4
   ``cpu`` shards a process), each at the geometry of JAX's two-process
   driver (``tests/_multihost_driver.py:31-50``: CNNModel on ICU, 16
   clients, 4 LIE attackers), threefry keys (shard_map, the psum'd mean):
   one round step and its aggregate in float64 from the same params and
   leak pool, the port on JAX's draws handed over by the shard suite's
   harness (``tests/test_torch_port_shard.py`` ``_draws``), held at that
   suite's tolerances (``test_sharded_round_matches_jaxs_mesh_round``:
   rows 2e-4, LIE rows 1e-5, the aggregate 2e-4, the AUC 1e-3); and one
   telemetry-on run each, whose layout is JAX's: the per-process file
   names, one ``run_id`` per package, a ``run_header`` per process stamped
   with its ``process_index``, and ``metrics --merge`` reporting JAX's keys
   (the skew numbers differ).
2. JAX's rules, in process, with no spawn: over a mesh whose shards belong
   to two processes, built without a process group, gmm, fltracer,
   ``resume`` and ``reload_parameters_per_round`` are refused and an
   indivisible client count raises, each with JAX's message (JAX's own
   Simulator made to see its 8-device mesh as multi-process), and a
   nonzero ``num-devices`` under two processes raises JAX's ``ValueError``.
"""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_port_spmd as spmd
from _torch_port_models import as_dtype, max_err, seeded_params
from _torch_port_threads import one_torch_thread  # noqa: F401
from test_torch_port_shard import _draws

import attackfl_tpu.parallel.mesh as jax_mesh
import attackfl_tpu.training.engine as jax_engine
from attackfl_tpu.config import AttackSpec as JaxAttackSpec
from attackfl_tpu.config import Config as JaxConfig
from attackfl_tpu.config import TelemetryConfig as JaxTelemetryConfig
from attackfl_tpu.data.synthetic import get_dataset as jax_get_dataset
from attackfl_tpu.eval.validation import evaluate_icu as jax_evaluate_icu
from attackfl_tpu.models.icu import CNNModel as JaxCNN
from attackfl_tpu.telemetry import merge as jax_merge
from attackfl_tpu.training import round as jround
from attackfl_tpu.training.engine import Simulator as JaxSimulator
from attackfl_tpu_torch.config import Config, TelemetryConfig
from attackfl_tpu_torch.eval.validation import evaluate_icu
from attackfl_tpu_torch.models.icu import CNNModel
from attackfl_tpu_torch.ops import pytree as pt
from attackfl_tpu_torch.parallel import mesh as port_mesh
from attackfl_tpu_torch.telemetry import merge as port_merge
from attackfl_tpu_torch.training.engine import Simulator

PRNG = "threefry2x32"
# both packages' ranks; JAX's compile takes most of it (about 50 s here)
TIMEOUT = 900


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    out = tmp_path_factory.mktemp("multiprocess_jax")
    with jax.enable_x64(True):
        jcfg = JaxConfig(**spmd.GEOMETRY, mode="fedavg", prng_impl=PRNG,
                         attacks=(JaxAttackSpec(**spmd.LIE),),
                         telemetry=JaxTelemetryConfig(enabled=False))
        train = as_dtype(jax_get_dataset("ICU", "train", spmd.GEOMETRY["train_size"], 1),
                         np.float64)
        params = as_dtype(seeded_params(CNNModel(), 0), np.float64)
        groups, genuine = jround.build_attack_groups(jcfg)
        noise = np.random.default_rng(1)
        prev = pt.tree_map(lambda x: x[None] + 0.05 * noise.standard_normal(
            (len(genuine),) + x.shape), params)
        draws = _draws(jax.random.key(5, impl=PRNG), train, groups, len(genuine),
                       max(int(jcfg.genuine_rate * len(genuine)), 1),
                       clients=jcfg.total_clients, num_data_range=jcfg.num_data_range,
                       epochs=jcfg.epochs)
    np.save(out / "inputs.npy", {"prng": PRNG, "train": train, "params": params, "prev": prev},
            allow_pickle=True)
    to_port = lambda tree: pt.tree_map(torch.from_numpy, tree)  # noqa: E731
    torch.save({"prng": PRNG, "train": to_port(train), "params": to_port(params),
                "prev": to_port(prev), "draws": draws}, out / "inputs.pt")
    procs = spmd.spawn(spmd.rank_argvs("jax-round", str(out))
                       + spmd.rank_argvs("port-round", str(out)))
    outs = spmd.finish(procs, TIMEOUT)
    spmd.check(outs)
    jax_lines = [json.loads(line.split(" ", 1)[1]) for rc, o, _ in outs[:2]
                 for line in o.splitlines() if line.startswith("JAX_RANK_OK ")]
    return {"dir": out, "params": params, "attackers": list(groups[0].indices),
            "genuine": list(genuine), "jax_ranks": jax_lines,
            "jax": np.load(out / "jax.npy", allow_pickle=True).item(),
            "port": [torch.load(out / f"port{r}.pt", weights_only=False)
                     for r in range(spmd.RANKS)]}


# ---------------------------------------------------------------------------
# 1. the two-process round and its telemetry
# ---------------------------------------------------------------------------

def test_two_process_round_matches_jaxs_two_process_round(both):
    theirs, (ours, other) = both["jax"], both["port"]
    assert theirs["sharded"] and theirs["ok"] and ours["ok"]
    np.testing.assert_array_equal(ours["sizes"].numpy(), np.asarray(theirs["sizes"]))
    assert abs(ours["loss"] - theirs["loss"]) < 1e-4
    assert max_err(ours["stacked"], theirs["stacked"], both["genuine"]) <= 2e-4
    assert max_err(ours["stacked"], theirs["stacked"], both["attackers"]) <= 1e-5
    assert max_err(ours["new_genuine"], theirs["new_genuine"]) <= 2e-4
    assert max_err(ours["new"], theirs["new"]) <= 2e-4
    # both ranks hold the same bits
    for key in ("stacked", "new_genuine", "new"):
        assert all(torch.equal(a, b) for a, b in zip(pt.tree_leaves(ours[key]),
                                                     pt.tree_leaves(other[key])))
    # validation in float32, as the engine runs it
    test_np = jax_get_dataset("ICU", "test", 256, 1)
    j_auc = float(jax_evaluate_icu(JaxCNN(), pt.tree_map(
        lambda x: np.asarray(x).astype(np.float32), theirs["new"]),
        {k: jnp.asarray(v) for k, v in test_np.items()})["roc_auc"])
    t_auc = float(evaluate_icu(CNNModel(), pt.tree_map(lambda x: x.to(torch.float32),
                                                       ours["new"]),
                               {k: torch.from_numpy(v) for k, v in test_np.items()})["roc_auc"])
    assert np.isfinite(t_auc) and abs(t_auc - j_auc) <= 1e-3


def _layout(directory) -> dict:
    names = sorted(n for n in os.listdir(directory) if n.startswith(("events", "trace")))
    headers, run_ids = {}, set()
    for name in names:
        if name.endswith(".jsonl"):
            with open(os.path.join(directory, name)) as fh:
                records = [json.loads(line) for line in fh]
            run_ids |= {r["run_id"] for r in records}
            headers[name] = sorted(r.get("process_index") for r in records
                                   if r["kind"] == "run_header")
    return {"names": names, "headers": headers, "run_ids": run_ids}


def test_two_process_telemetry_layout_is_jaxs(both):
    ours = _layout(both["dir"] / "port-events")
    theirs = _layout(both["dir"] / "jax-events")
    assert ours["names"] == theirs["names"] == ["events.0.jsonl", "events.1.jsonl",
                                                 "trace.0.json", "trace.1.json"]
    assert ours["headers"] == theirs["headers"] == {"events.0.jsonl": [0], "events.1.jsonl": [1]}
    assert len(ours["run_ids"]) == len(theirs["run_ids"]) == 1
    assert ours["run_ids"] == {both["port"][0]["run_id"]} == {both["port"][1]["run_id"]}
    assert theirs["run_ids"] == {r["run_id"] for r in both["jax_ranks"]}
    assert [r["ok"] for r in both["jax_ranks"]] == [p["run_ok"] for p in both["port"]]
    # the merge: JAX's keys, from each package's own files
    port_merged, port_per = port_merge.merge_events(str(both["dir"] / "port-events"))
    jax_merged, jax_per = jax_merge.merge_events(str(both["dir"] / "jax-events"))
    assert sorted(port_per) == sorted(jax_per) == [0, 1]
    port_skew = port_merge.skew_summary(port_merged)
    jax_skew = jax_merge.skew_summary(jax_merged)
    assert sorted(port_skew) == sorted(jax_skew)
    assert sorted(port_skew["phase_lag_s"]) == sorted(jax_skew["phase_lag_s"])
    assert port_skew["rounds_compared"] == jax_skew["rounds_compared"] == 1


# ---------------------------------------------------------------------------
# 2. JAX's rules, in process
# ---------------------------------------------------------------------------

RULES = dict(total_clients=16, model="CNNModel", data_name="ICU", num_data_range=(24, 32),
             epochs=1, batch_size=16, train_size=128, test_size=64)


def _two_process_mesh(shards: int = 8):
    """A mesh whose shards belong to processes 0 and 1, seen from process
    0, with no process group."""
    return port_mesh.ClientMesh(("cpu",) * shards,
                                processes=(0,) * (shards // 2) + (1,) * (shards // 2))


def _jax_refusal(monkeypatch, tmp_path, **kw) -> str:
    """JAX's message for ``kw`` over its 8-device mesh made multi-process."""
    monkeypatch.setattr(jax_engine, "is_multiprocess", lambda mesh: mesh is not None)
    with pytest.raises(ValueError) as theirs:
        JaxSimulator(JaxConfig(**{**RULES, "log_path": str(tmp_path),
                                  "checkpoint_dir": str(tmp_path),
                                  "telemetry": JaxTelemetryConfig(enabled=False), **kw}),
                     use_mesh=True)
    return str(theirs.value)


@pytest.mark.parametrize("kw", [
    {"mode": "gmm"}, {"mode": "fltracer"}, {"resume": True},
    {"reload_parameters_per_round": True, "load_parameters": True}, {"total_clients": 12}],
    ids=["gmm", "fltracer", "resume", "reload", "indivisible"])
def test_multiprocess_refusals_are_jaxs(kw, monkeypatch, tmp_path):
    mesh = _two_process_mesh()
    assert port_mesh.is_multiprocess(mesh) and mesh.local_shards == (0, 1, 2, 3)
    with pytest.raises(ValueError) as ours:
        Simulator(Config(**{**RULES, "log_path": str(tmp_path), "checkpoint_dir": str(tmp_path),
                            "telemetry": TelemetryConfig(enabled=False), **kw}),
                  device="cpu", mesh=mesh)
    assert str(ours.value) == _jax_refusal(monkeypatch, tmp_path, **kw)


def test_num_devices_under_two_processes_is_refused_as_jax(monkeypatch):
    assert port_mesh.make_client_mesh(2, device="cpu").size == 1     # one process: truncated
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    with pytest.raises(ValueError) as theirs:
        jax_mesh.make_client_mesh(2)
    monkeypatch.setattr(port_mesh, "process_count", lambda: 2)
    with pytest.raises(ValueError) as ours:
        port_mesh.make_client_mesh(2, device="cpu")
    assert str(ours.value) == str(theirs.value)
