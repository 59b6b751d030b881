"""The async checkpoint writer and async validation of the port, on the
CPU, after the JAX package's own tests of them
(``tests/test_checkpoint_async.py``, ``tests/test_faults.py`` on the
writer's supervisor and the crash path, ``tests/test_pipeline.py`` on
async validation): ordering under rapid submits, last-write-wins, the
drain on close, an error surfacing; the async run against the sync run,
bit for bit and resumable; the drain of a crashing run; the supervisor;
and async validation, whose params equal the sync run's bit for bit and
whose verdict gates nothing."""

import os
import time

import pytest
import torch

from _torch_port_threads import one_torch_thread  # noqa: F401

from attackfl_tpu_torch.config import AttackSpec, Config, MeshConfig
from attackfl_tpu_torch.faults.plan import parse_fault_plan
from attackfl_tpu_torch.ops import pytree as pt
from attackfl_tpu_torch.training import engine
from attackfl_tpu_torch.training.engine import Simulator
from attackfl_tpu_torch.utils import checkpoint as ckpt

SMALL = dict(num_round=3, total_clients=6, model="TransformerModel", data_name="ICU",
             num_data_range=(24, 32), epochs=1, batch_size=16, train_size=128, test_size=64,
             local_backend="pallas",
             attacks=(AttackSpec(mode="LIE", num_clients=1, attack_round=2),))


def _cfg(tmp_path, **kw):
    return Config(**{**SMALL, "log_path": str(tmp_path), "checkpoint_dir": str(tmp_path),
                     **kw})


def _load(path):
    return torch.load(path, weights_only=True)


def _leaves(x):
    return [x] if isinstance(x, torch.Tensor) else pt.tree_leaves(x)


def _same(a: dict, b: dict, keys=("global_params", "prev_genuine")) -> bool:
    return all(torch.equal(x, y) for k in keys
               for x, y in zip(_leaves(a[k]), _leaves(b[k])))


# ---------------------------------------------------------------------------
# the writer alone
# ---------------------------------------------------------------------------

def test_ordering_under_rapid_submits(tmp_path):
    writer = ckpt.AsyncCheckpointWriter()
    path = str(tmp_path / "state.pth")
    for i in range(50):
        writer.submit(path, {"step": torch.tensor(i)})
    writer.drain()
    assert int(_load(path)["step"]) == 49 and writer.writes_completed >= 1
    writer.close()


def test_last_write_wins_coalescing(tmp_path, monkeypatch):
    real = ckpt.to_bytes

    def slow_to_bytes(state):
        time.sleep(0.05)
        return real(state)

    monkeypatch.setattr(ckpt, "to_bytes", slow_to_bytes)
    writer = ckpt.AsyncCheckpointWriter()
    path = str(tmp_path / "state.pth")
    n = 20
    for i in range(n):
        writer.submit(path, {"step": torch.tensor(i)})
    writer.drain()
    assert int(_load(path)["step"]) == n - 1
    assert writer.writes_coalesced > 0 and writer.writes_completed < n
    assert writer.writes_completed + writer.writes_coalesced == n
    writer.close()


def test_drain_on_close_flushes_the_final_state(tmp_path):
    writer = ckpt.AsyncCheckpointWriter()
    path = str(tmp_path / "state.pth")
    writer.submit(path, {"step": torch.tensor(7)})
    writer.close()
    assert int(_load(path)["step"]) == 7
    writer.close()
    with pytest.raises(RuntimeError, match="closed"):
        writer.submit(path, {"step": torch.tensor(8)})


def test_write_error_surfaces(tmp_path):
    writer = ckpt.AsyncCheckpointWriter()
    writer.submit(str(tmp_path / "no_such_dir" / "state.pth"), {"step": torch.tensor(0)})
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        writer.drain()
    writer.close()


def test_host_snapshot_is_a_copy():
    """On the CPU ``.cpu()`` is the tensor itself; the snapshot handed to
    the thread must not change when the state is written in place."""
    state = {"w": torch.zeros(4), "count": torch.zeros((), dtype=torch.int64), "n": 3}
    snap = ckpt.host_snapshot(state)
    state["w"].add_(1.0)
    state["count"] += 1
    assert snap["w"].tolist() == [0.0] * 4 and int(snap["count"]) == 0 and snap["n"] == 3


def test_direct_drain_revives_a_dead_writer(tmp_path):
    writer = ckpt.AsyncCheckpointWriter()
    writer.inject_thread_death()
    writer._thread.join(timeout=5)
    assert not writer._thread.is_alive()
    path = str(tmp_path / "state.pth")
    writer.submit(path, {"step": torch.tensor(3)})
    writer.drain()
    assert writer.restarts == 1 and int(_load(path)["step"]) == 3
    writer.close()


# ---------------------------------------------------------------------------
# the engine's writer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["fedavg", "hyper"])
def test_async_checkpoints_bit_identical_and_resumable(tmp_path, mode):
    """The async run's files are the sync run's, byte for byte, and a
    resume from each gives the same state."""
    extra = ({"mode": "hyper", "local_backend": "xla", "model": "CNNModel"}
             if mode == "hyper" else {})
    states = {}
    for name, is_async in (("sync", False), ("async", True)):
        sim = Simulator(_cfg(tmp_path / name, checkpoint_async=is_async, **extra), device="cpu")
        states[name], _ = sim.run(verbose=False)
        sim.close()
    # the alias and the last round's entry; the writer may coalesce an
    # earlier round's submit away (last write wins), and the manifest
    # holds timestamps
    alias = os.path.basename(ckpt.checkpoint_path(_cfg(tmp_path, **extra)))
    for name in (alias, alias.replace(".pth", ".r00000003.pth")):
        assert (tmp_path / "sync" / name).read_bytes() == \
            (tmp_path / "async" / name).read_bytes()
    resumed = {name: Simulator(_cfg(tmp_path / name, resume=True, **extra),
                               device="cpu").load_or_init_state() for name in states}
    assert resumed["sync"]["completed_rounds"] == resumed["async"]["completed_rounds"] == 3
    keys = ("hnet_params", "prev_genuine") if mode == "hyper" else ("global_params",
                                                                     "prev_genuine")
    assert _same(resumed["sync"], resumed["async"], keys)
    assert _same(resumed["async"], states["async"], keys)


def test_run_drains_the_writer_before_returning(tmp_path):
    cfg = _cfg(tmp_path, checkpoint_async=True)
    sim = Simulator(cfg, device="cpu")
    state, _ = sim.run(verbose=False)
    loaded = _load(ckpt.checkpoint_path(cfg))
    assert loaded["completed_rounds"] == state["completed_rounds"] == 3
    assert sim.checkpoint_writer.writes_completed + sim.checkpoint_writer.writes_coalesced == 3
    sim.close()
    sim.close()


def test_run_drains_on_a_crashing_round(tmp_path, monkeypatch):
    """A run that aborts (the retry budget spent) still drains the writer:
    round 1's checkpoint is on disk."""
    monkeypatch.setattr(engine, "MAX_ROUND_RETRIES", 2)
    storms = ";".join(f"nan_storm@{b}" for b in range(2, 9))
    cfg = _cfg(tmp_path, checkpoint_async=True, faults=parse_fault_plan(storms))
    sim = Simulator(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="aborting"):
        sim.run(verbose=False)
    assert _load(ckpt.checkpoint_path(cfg))["completed_rounds"] == 1
    assert [e["round"] for e in sim.checkpoints.read_manifest()["entries"]] == [1]
    sim.close()


def test_writer_death_supervisor_restarts(tmp_path):
    cfg = _cfg(tmp_path, checkpoint_async=True, faults=parse_fault_plan("writer_death@2"))
    sim = Simulator(cfg, device="cpu")
    state, _ = sim.run(verbose=False)
    writer = sim.checkpoint_writer
    sim.close()
    assert writer.restarts == 1
    assert [r["fault"] for r in sim.fault_injector.records] == ["writer_death"]
    assert _load(ckpt.checkpoint_path(cfg))["completed_rounds"] == 3
    assert [e["round"] for e in sim.checkpoints.read_manifest()["entries"]][-1] == 3


# ---------------------------------------------------------------------------
# async validation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extra", [{}, {"mode": "hyper", "local_backend": "xla",
                                        "model": "CNNModel"},
                                   {"local_backend": "xla",
                                    "mesh": MeshConfig(compute_dtype="bfloat16")}],
                         ids=["fedavg", "hyper", "bf16"])
def test_async_validation_matches_sync(tmp_path, extra):
    """Params bit-identical to the sync run's, every entry with the sync
    run's metrics and ``validation_ok``."""
    runs = {}
    for name, is_async in (("sync", False), ("async", True)):
        sim = Simulator(_cfg(tmp_path / name, validation_async=is_async, **extra),
                        device="cpu")
        runs[name] = sim.run(save_checkpoints=False, verbose=False)
    (s_state, s_hist), (a_state, a_hist) = runs["sync"], runs["async"]
    keys = ("hnet_params",) if "mode" in extra else ("global_params",)
    assert _same(s_state, a_state, keys + ("prev_genuine",))
    assert [h["ok"] for h in a_hist] == [h["ok"] for h in s_hist] == [True] * 3
    assert all(h["validation_ok"] for h in a_hist)
    assert [h["roc_auc"] for h in a_hist] == [h["roc_auc"] for h in s_hist]


def test_async_validation_verdict_does_not_gate(tmp_path, monkeypatch):
    """A failing verdict lands in the entry as ``validation_ok`` False and
    the round stays accepted; the sync run retries it."""
    from attackfl_tpu_torch.eval import validation as tval

    def failing(model, params, test_data):
        out = tval.evaluate_icu(model, params, test_data)
        return {**out, "ok": torch.zeros((), dtype=torch.bool)}

    monkeypatch.setitem(tval.EVALUATORS, "ICU", failing)
    sim = Simulator(_cfg(tmp_path, num_round=2, validation_async=True), device="cpu")
    state, history = sim.run(save_checkpoints=False, verbose=False)
    assert [h["ok"] for h in history] == [True, True] and state["completed_rounds"] == 2
    assert [h["validation_ok"] for h in history] == [False, False]
    sync = Simulator(_cfg(tmp_path, num_round=2), device="cpu")
    sync_state = sync.init_state()
    sync_state, metrics = sync.run_round(sync_state)
    assert not metrics["ok"] and sync_state["completed_rounds"] == 0


def test_validation_every_skips_broadcasts(tmp_path):
    sim = Simulator(_cfg(tmp_path, validation_every=2, validation_async=True), device="cpu")
    _, history = sim.run(save_checkpoints=False, verbose=False)
    assert ["roc_auc" in h for h in history] == [False, True, False]
