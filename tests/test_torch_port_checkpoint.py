"""Checkpoints and resume of the port on the CPU, at a small size (C = 8,
the widths of ``test_torch_port_round.py``).

Kill-and-resume is held bit for bit against an uninterrupted run (params,
leak pool, clocks and the round generator's state), under both
``local_backend``s; the manifest, retention, torn-entry fallback,
fail-open writes, ``load_parameters`` and the per-round reload follow the
JAX package's ``utils/checkpoint.py`` and engine; the content hash and
the config fingerprint equal the JAX package's.
"""

import json
import os

import pytest
import torch

from attackfl_tpu.config import AttackSpec as JaxAttackSpec
from attackfl_tpu.config import Config as JaxConfig
from attackfl_tpu.config import MeshConfig as JaxMeshConfig
from attackfl_tpu.utils.atomicio import content_hash as jax_content_hash
from attackfl_tpu.utils.fingerprint import config_fingerprint as jax_config_fingerprint
from attackfl_tpu_torch import cli
from attackfl_tpu_torch.config import AttackSpec, Config, MeshConfig
from attackfl_tpu_torch.ops import pytree as pt
from attackfl_tpu_torch.training.engine import Simulator
from attackfl_tpu_torch.utils import checkpoint as ckpt
from attackfl_tpu_torch.utils.atomicio import content_hash
from attackfl_tpu_torch.utils.fingerprint import config_fingerprint

SMALL = dict(num_round=3, total_clients=8, mode="fedavg", model="TransformerModel",
             data_name="ICU", num_data_range=(24, 32), epochs=2, batch_size=16,
             train_size=256, test_size=128, local_backend="pallas")
LIE = dict(mode="LIE", num_clients=2, attack_round=2)


def _cfg(tmp, **kw):
    return Config(**{**SMALL, "attacks": (AttackSpec(**LIE),), "checkpoint_dir": str(tmp),
                     **kw})


def _assert_states_equal(a, b):
    for key in ("global_params", "prev_genuine"):
        for (path, x), (_, y) in zip(pt.tree_items(a[key]), pt.tree_items(b[key])):
            assert torch.equal(x, y), f"{key}/{path}"
    for key in ("have_genuine", "completed_rounds", "broadcasts"):
        assert a[key] == b[key], key
    assert torch.equal(a["rng"].get_state(), b["rng"].get_state())


def _manifest(directory):
    with open(os.path.join(directory, ckpt.MANIFEST_NAME)) as fh:
        return json.load(fh)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_kill_and_resume_is_bit_identical(tmp_path, backend):
    """Two rounds, a new Simulator with ``resume``, round 3: the same state
    as three rounds without a stop."""
    whole, _ = Simulator(_cfg(tmp_path / "a", local_backend=backend), device="cpu").run(
        verbose=False)
    Simulator(_cfg(tmp_path / "b", local_backend=backend), device="cpu").run(
        num_rounds=2, verbose=False)
    resumed_sim = Simulator(_cfg(tmp_path / "b", local_backend=backend, resume=True),
                            device="cpu")
    resumed, history = resumed_sim.run(verbose=False)
    assert [h["round"] for h in history] == [3]
    _assert_states_equal(resumed, whole)
    manifest = _manifest(tmp_path / "b")
    assert [e["round"] for e in manifest["entries"]] == [1, 2, 3]
    assert manifest["fingerprint"] == config_fingerprint(resumed_sim.cfg)
    assert manifest["base"] == "TransformerModel.pth"


def test_generator_state_continues_after_set_state():
    gen = torch.Generator().manual_seed(7)
    torch.randint(0, 100, (5,), generator=gen)
    saved = gen.get_state()
    expect = torch.randint(0, 1000, (64,), generator=gen)
    again = torch.Generator()
    again.set_state(saved)
    assert torch.equal(torch.randint(0, 1000, (64,), generator=again), expect)


def test_torn_newest_entry_falls_back(tmp_path, capsys):
    Simulator(_cfg(tmp_path), device="cpu").run(verbose=False)
    newest = tmp_path / "TransformerModel.r00000003.pth"
    newest.write_bytes(newest.read_bytes()[:-100])
    sim = Simulator(_cfg(tmp_path, resume=True), device="cpu")
    state = sim.load_or_init_state()
    assert state["completed_rounds"] == 2 and state["broadcasts"] == 2
    assert "torn/truncated" in capsys.readouterr().out
    _, history = sim.run(state=state, verbose=False)
    assert [h["round"] for h in history] == [3]


def test_resume_without_checkpoint_starts_fresh(tmp_path, capsys):
    state = Simulator(_cfg(tmp_path, resume=True), device="cpu").load_or_init_state()
    assert state["completed_rounds"] == 0
    assert "starting fresh" in capsys.readouterr().out


def test_retention_keeps_checkpoint_keep_entries(tmp_path):
    Simulator(_cfg(tmp_path, checkpoint_keep=2), device="cpu").run(verbose=False)
    assert [e["round"] for e in _manifest(tmp_path)["entries"]] == [2, 3]
    assert sorted(os.listdir(tmp_path)) == [
        "TransformerModel.pth", "TransformerModel.r00000002.pth",
        "TransformerModel.r00000003.pth", "manifest.json"]
    # the alias is the newest entry
    assert ((tmp_path / "TransformerModel.pth").read_bytes()
            == (tmp_path / "TransformerModel.r00000003.pth").read_bytes())


def test_fresh_run_drops_the_old_entries(tmp_path):
    Simulator(_cfg(tmp_path), device="cpu").run(verbose=False)
    Simulator(_cfg(tmp_path), device="cpu").run(num_rounds=1, verbose=False)
    assert [e["round"] for e in _manifest(tmp_path)["entries"]] == [1]


def test_failed_writes_fail_open(tmp_path, monkeypatch):
    """A disk that refuses every write: each save retries, then gives up
    with a warning; training goes on and the earlier entry survives."""
    sim = Simulator(_cfg(tmp_path), device="cpu")
    sim.checkpoints.backoff = 0.0
    state, _ = sim.run(num_rounds=1, verbose=False)
    attempts = []

    def refuse(path, data, tmp_suffix=".tmp"):
        attempts.append(path)
        raise OSError("disk full")

    monkeypatch.setattr(ckpt, "_write_bytes", refuse)
    state, history = sim.run(state=state, verbose=False)
    assert [h["ok"] for h in history] == [True, True] and state["completed_rounds"] == 3
    assert sim.checkpoints.write_failures == 2
    assert len(attempts) == 2 * (sim.checkpoints.retries + 1)
    monkeypatch.undo()
    assert [e["round"] for e in _manifest(tmp_path)["entries"]] == [1]
    loaded = sim.checkpoints.load_latest(sim.host_state(sim.init_state()))
    assert loaded.entry["round"] == 1 and not loaded.rejected


def test_load_parameters_runs_only_the_rest(tmp_path):
    Simulator(_cfg(tmp_path), device="cpu").run(num_rounds=2, verbose=False)
    sim = Simulator(_cfg(tmp_path, load_parameters=True), device="cpu")
    assert sim.load_or_init_state()["completed_rounds"] == 2
    state, history = sim.run(verbose=False)
    assert [h["round"] for h in history] == [3] and state["completed_rounds"] == 3
    # a load keeps the manifest's earlier entries
    assert [e["round"] for e in _manifest(tmp_path)["entries"]] == [1, 2, 3]


def test_reload_per_round_rereads_a_rewritten_file(tmp_path, monkeypatch):
    sim = Simulator(_cfg(tmp_path, load_parameters=True, reload_parameters_per_round=True),
                    device="cpu")
    state = sim.init_state()
    reads = []
    real_load = ckpt.load_state
    monkeypatch.setattr(ckpt, "load_state", lambda *a, **k: reads.append(1) or real_load(*a, **k))
    assert sim._reload_params(state) is state and not reads      # no file: a no-op
    saved = dict(state, completed_rounds=1)
    saved["global_params"] = pt.tree_map(lambda x: x + 1.0, state["global_params"])
    sim.save_checkpoint(saved)
    first = sim._reload_params(state)
    second = sim._reload_params(state)
    assert len(reads) == 1                                      # unchanged: a cache hit
    assert second["global_params"] is first["global_params"]
    for a, b in zip(pt.tree_leaves(first["global_params"]),
                    pt.tree_leaves(saved["global_params"])):
        assert torch.equal(a, b)
    saved["global_params"] = pt.tree_map(lambda x: x + 2.0, state["global_params"])
    saved["completed_rounds"] = 2
    sim.save_checkpoint(saved)
    third = sim._reload_params(state)
    assert len(reads) == 2
    for a, b in zip(pt.tree_leaves(third["global_params"]),
                    pt.tree_leaves(saved["global_params"])):
        assert torch.equal(a, b)
    # a run's round reads through the cache, and its save rewrites the file
    _, history = sim.run(num_rounds=3, state=dict(saved), verbose=False)
    assert [h["ok"] for h in history] == [True] and len(reads) == 2
    sim._reload_params(state)
    assert len(reads) == 3


def test_manifest_with_msgpack_entries_is_skipped(tmp_path, monkeypatch):
    """A JAX run's ``.msgpack`` entries in the same manifest are never
    handed to ``torch.load``."""
    sim = Simulator(_cfg(tmp_path), device="cpu")
    state, _ = sim.run(num_rounds=1, verbose=False)
    manifest = _manifest(tmp_path)
    jax_entry = {"round": 5, "broadcast": 5, "file": "TransformerModel.r00000005.msgpack",
                 "sha256": "0" * 64, "bytes": 3, "ts": 0.0}
    (tmp_path / jax_entry["file"]).write_bytes(b"jax")
    manifest["entries"].append(jax_entry)
    (tmp_path / ckpt.MANIFEST_NAME).write_text(json.dumps(manifest))
    loads = []
    real = torch.load
    monkeypatch.setattr(torch, "load", lambda f, **k: loads.append(1) or real(f, **k))
    result = sim.checkpoints.load_latest(sim.host_state(sim.init_state()))
    assert result.entry["round"] == 1 and not result.rejected and len(loads) == 1
    manifest["entries"] = [jax_entry]
    (tmp_path / ckpt.MANIFEST_NAME).write_text(json.dumps(manifest))
    result = sim.checkpoints.load_latest(sim.host_state(sim.init_state()))
    assert result.state is None and not result.rejected and len(loads) == 1


def test_structure_mismatch_is_a_value_error(tmp_path):
    sim = Simulator(_cfg(tmp_path), device="cpu")
    host = sim.host_state(sim.init_state())
    data = ckpt.to_bytes(host)
    assert ckpt.load_state_bytes(data, host)["completed_rounds"] == 0
    other = dict(host, prev_genuine=pt.tree_map(lambda x: x[:3], host["prev_genuine"]))
    with pytest.raises(ValueError, match="does not match"):
        ckpt.load_state_bytes(data, other)
    with pytest.raises(ValueError, match="not a readable state"):
        ckpt.load_state_bytes(data[:-50], host)


def test_orphans_are_swept_at_construction(tmp_path):
    for name in ("TransformerModel.r00000004.pth.tmp", "manifest.json.tmp", "notes.tmp"):
        (tmp_path / name).write_bytes(b"x")
    Simulator(_cfg(tmp_path), device="cpu")
    assert sorted(os.listdir(tmp_path)) == ["notes.tmp"]


def test_content_hash_matches_jax():
    for data in (b"", b"attackfl", bytes(range(256)) * 41):
        assert content_hash(data) == jax_content_hash(data)


@pytest.mark.parametrize("kw", [
    {},
    {**SMALL, "attacks": "LIE"},
    {**SMALL, "partition": "dirichlet", "dirichlet_alpha": 0.3, "client_dropout_rate": 0.1,
     "attacks": "Min-Max", "checkpoint_dir": "/elsewhere", "resume": True},
    {**SMALL, "local_backend": "xla", "mesh": "bfloat16", "checkpoint_async": True},
])
def test_config_fingerprint_matches_jax(kw):
    """Same config, same 16 hex digits; volatile fields do not count."""
    def build(cls, spec, mesh):
        args = dict(kw)
        if "attacks" in args:
            args["attacks"] = (spec(mode=args["attacks"], num_clients=2, attack_round=2),)
        if "mesh" in args:
            args["mesh"] = mesh(compute_dtype=args["mesh"])
        return cls(**args)

    ours = config_fingerprint(build(Config, AttackSpec, MeshConfig))
    assert ours == jax_config_fingerprint(build(JaxConfig, JaxAttackSpec, JaxMeshConfig))
    assert len(ours) == 16
    assert ours == config_fingerprint(build(Config, AttackSpec, MeshConfig).replace(
        log_path="/tmp/x"))


def test_cli_resume(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)      # the run checkpoints into log_path, "."
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(
        "server: {num-round: 2, clients: 6, data-name: ICU, model: TransformerModel,\n"
        "         train-size: 128, test-size: 64,\n"
        "         data-distribution: {num-data-range: [16, 24]}}\n"
        "learning: {epoch: 1, batch-size: 16}\n"
        "tpu: {local-backend: pallas}\n")
    assert cli.main(["run", "--config", str(cfg), "--device", "cpu"]) == 0
    assert "Finished: 2 successful rounds." in capsys.readouterr().out
    assert cli.main(["run", "--config", str(cfg), "--device", "cpu", "--rounds", "3",
                     "--resume"]) == 0
    out = capsys.readouterr().out
    assert "continuing from round 2" in out and "Finished: 1 successful rounds." in out
    assert [e["round"] for e in _manifest(tmp_path)["entries"]] == [1, 2, 3]
