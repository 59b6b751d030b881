"""The port's client mesh over two processes on the CPU, held to its own
one-process mesh of as many shards: ``parallel/mesh.py``'s multi-process
functions, the cross-process collectives of ``parallel/shard.py``, and the
multi-process branches of the engine, the matrix and the launcher.

One session spawns every process of this file (``tests/_torch_port_spmd.py``,
CNNModel on ICU, 16 clients, 4 LIE attackers, the geometry of JAX's
two-process driver, ``tests/_multihost_driver.py:31-50``):

1. Two ``python -m attackfl_tpu_torch run --device cpu --no-wait
   --coordinator ... --process-id {0,1}`` processes, each in a directory of
   its own and both writing telemetry into one: one ok round, the files
   ``events.0.jsonl`` and ``events.1.jsonl`` under one ``run_id``, each
   with a ``run_header`` stamped with its ``process_index``, ``metrics
   --merge`` over them, and the checkpoint in process 0's directory alone.
2. Two ranks, each with 4 repeated ``cpu`` shards, against one process
   with 8 (computed here while the ranks run): a synchronous round,
   ``run_fast`` over 2 rounds and the pipeline at depth 2 under shard_map,
   one hyper round under gspmd, each bit for bit with the same ``ok``
   sequence, both ranks holding the same bits; every mode of
   ``PSUM_MODES | GATHER_MODES`` on one round's rows, bit for bit, with
   the table's collectives; a 2 x 2 x 1 sweep whose cells equal the
   unsharded sweep's and whose grid checkpoint, process 0's, equals the
   one-process one; ``psum`` and ``all_gather`` differentiated across the
   ranks in float64 against central differences, their gradients within
   float64 noise of the one-process mesh's.
3. Then those ranks restart the launch of 1 with ``load_parameters``: each
   restores process 0's broadcast bytes (rank 1's directory holds no
   checkpoint), with ``completed_rounds`` the launch's ok rounds, as
   ``_multihost_driver.py:90-103`` asserts of JAX.
"""

from __future__ import annotations

import json
import os

import pytest
import torch
import _torch_port_spmd as spmd
from _torch_port_threads import one_torch_thread  # noqa: F401

from attackfl_tpu_torch import cli
from attackfl_tpu_torch.parallel.mesh import make_client_mesh
from attackfl_tpu_torch.parallel.shard import GATHER_MODES, PSUM_MODES
from attackfl_tpu_torch.utils import checkpoint as ckpt

LAUNCH_YAML = """server: {num-round: 1, clients: 16, mode: fedavg, model: CNNModel, data-name: ICU,
         train-size: 128, test-size: 64, genuine-rate: 0.5,
         data-distribution: {num-data-range: [24, 32]}}
learning: {epoch: 1, batch-size: 16}
attack-clients: [{mode: LIE, num-clients: 4, attack-round: 1}]
log_path: .
"""
# a rank's time limit: the ranks take 10-40 s here
TIMEOUT = 600


def _leaves(tree) -> list:
    return [x for x in torch.utils._pytree.tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _same(a, b) -> bool:
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    root = tmp_path_factory.mktemp("multiprocess")
    launch = root / "launch"
    for rank in range(spmd.RANKS):
        (launch / f"rank{rank}").mkdir(parents=True)
    (launch / "cfg.yaml").write_text(LAUNCH_YAML)
    events = launch / "events"
    coordinator = f"127.0.0.1:{spmd.free_port()}"
    argvs = [[spmd.sys.executable, "-m", "attackfl_tpu_torch", "run", "--config",
              str(launch / "cfg.yaml"), "--device", "cpu", "--no-wait", "--coordinator",
              coordinator, "--num-processes", str(spmd.RANKS), "--process-id", str(rank)]
             for rank in range(spmd.RANKS)]
    procs = spmd.spawn(argvs, env=spmd.child_env(ATTACKFL_TELEMETRY_DIR=str(events)),
                       cwds=[str(launch / f"rank{r}") for r in range(spmd.RANKS)])
    try:
        # the one-process references, while the launch runs
        reference = spmd.scenarios(make_client_mesh(devices=["cpu"] * 8), str(root / "one"))
        reference["unsharded"] = spmd._matrix(None, str(root / "unsharded"))
    finally:
        launched = spmd.finish(procs, TIMEOUT)
    spmd.check(launched)
    battery = str(root / "battery")
    spmd.check(spmd.finish(spmd.spawn(spmd.rank_argvs("battery", battery, str(launch))),
                           TIMEOUT))
    ranks = [torch.load(os.path.join(battery, f"rank{r}.pt"), weights_only=False)
             for r in range(spmd.RANKS)]
    return {"launch": launch, "events": events, "launched": launched,
            "reference": reference, "ranks": ranks}


# ---------------------------------------------------------------------------
# 1. the launch
# ---------------------------------------------------------------------------

def _events(path) -> list[dict]:
    with open(path) as fh:
        return [json.loads(line) for line in fh]


def test_launch_writes_per_process_events_under_one_run_id(session):
    for rc, out, _ in session["launched"]:
        assert rc == 0 and "Finished: 1 successful rounds." in out
    names = sorted(os.listdir(session["events"]))
    assert {"events.0.jsonl", "events.1.jsonl", "trace.0.json", "trace.1.json"} <= set(names)
    assert "events.jsonl" not in names
    run_ids = set()
    for rank in range(spmd.RANKS):
        records = _events(session["events"] / f"events.{rank}.jsonl")
        assert {r["process_index"] for r in records} == {rank}
        header, = [r for r in records if r["kind"] == "run_header"]
        assert header["multiprocess"] and header["mesh_devices"] == spmd.RANKS
        assert [r["ok"] for r in records if r["kind"] == "round"] == [True]
        run_ids |= {r["run_id"] for r in records}
    assert len(run_ids) == 1


def test_merge_over_the_launch_reports_skew(session, capsys):
    assert cli.main(["metrics", str(session["events"]), "--merge", "--json"]) == 0
    report = json.loads(capsys.readouterr().out)
    skew = report["skew"]
    assert skew["rounds_compared"] >= 1 and skew["completion_skew_s"] is not None
    assert skew["phase_lag_s"]
    assert sorted(map(int, report["events_per_process"])) == [0, 1]
    assert len(skew["run_headers"]) == 1


def test_process_zero_alone_writes_the_checkpoint(session):
    assert os.path.isfile(session["launch"] / "rank0" / "CNNModel.pth")
    assert os.path.isfile(session["launch"] / "rank0" / "manifest.json")
    assert not [n for n in os.listdir(session["launch"] / "rank1") if n.endswith(".pth")]
    assert not os.path.exists(session["launch"] / "rank1" / "manifest.json")


def test_restart_restores_process_zeros_broadcast_bytes(session):
    path = session["launch"] / "rank0" / "CNNModel.pth"
    restarts = [r["restart"] for r in session["ranks"]]
    saved = ckpt.load_state(str(path), restarts[0]["host"])
    for restart in restarts:
        assert restart["mesh_size"] == spmd.RANKS
        assert restart["completed_rounds"] == 1            # the launch's ok rounds
        assert restart["loaded_bytes"] == os.path.getsize(path)
        assert _same(restart["host"], saved)


# ---------------------------------------------------------------------------
# 2. two ranks against one process of as many shards
# ---------------------------------------------------------------------------

def test_the_mesh_spans_both_processes(session):
    for rank, result in enumerate(session["ranks"]):
        assert result["processes"] == (0,) * 4 + (1,) * 4
        assert result["local_shards"] == tuple(range(4 * rank, 4 * rank + 4))


@pytest.mark.parametrize("executor,strategy", [
    ("run", "shard_map"), ("run_fast", "shard_map"), ("pipeline", "shard_map"),
    ("hyper", "gspmd")])
def test_executors_are_the_one_process_mesh_bit_for_bit(executor, strategy, session):
    want = session["reference"]["executors"][executor]
    assert want["strategy"] == strategy and all(want["ok"])
    for result in session["ranks"]:
        got = result["executors"][executor]
        assert got["strategy"] == strategy
        assert got["ok"] == want["ok"] and got["auc"] == want["auc"]
        assert _same(got["state"], want["state"])


@pytest.mark.parametrize("mode", sorted(PSUM_MODES | GATHER_MODES))
def test_each_defense_is_the_one_process_mesh_bit_for_bit(mode, session):
    want = session["reference"]["defenses"]
    for result in session["ranks"]:
        got = result["defenses"]
        assert _same(got["rows"], want["rows"])
        assert _same(got[mode]["params"], want[mode]["params"])
        assert got[mode]["collectives"] == want[mode]["collectives"]
        assert set(got[mode]["collectives"]) == (
            {"all_gather"} if mode in GATHER_MODES else {"psum"})


def test_matrix_cells_and_grid_checkpoint(session):
    unsharded = session["reference"]["unsharded"]["cells"]
    one = session["reference"]["matrix"]
    assert _same(one["cells"], unsharded)
    for result in session["ranks"]:
        assert _same(result["matrix"]["cells"], unsharded)
        assert result["matrix"]["fold_calls"] == one["fold_calls"]
    assert _same(session["ranks"][0]["matrix"]["checkpoint"], one["checkpoint"])


@pytest.mark.parametrize("collective", ["psum", "all_gather"])
def test_collective_gradients_across_processes(collective, session):
    want = session["reference"]["gradients"][collective]
    assert want["worst"] <= 1e-7
    for result in session["ranks"]:
        got = result["gradients"][collective]
        assert got["worst"] <= 1e-7
        # within float64 noise of the one-process mesh's: autograd adds up
        # the cotangents of one tensor returned to several shards of a
        # process before the backward sees them, so a process of 4 shards
        # and one of 8 associate the same sum differently
        for g, s in zip(got["grads"], result["local_shards"]):
            torch.testing.assert_close(g, want["grads"][s], rtol=1e-12, atol=0)
