"""Hyper validation and hyper mode through the port's engine on the CPU.

``evaluate_hyper_icu`` within 1e-6 and ``evaluate_hyper_cifar`` (2
clients x 8 images, a narrow ResNet18) within 1e-4 of the JAX package's.
Then ``Simulator`` (JAX ``engine.py:1673-1800``) alone: a run with the
embedding detector, a detector removal rolling the round's update back,
kill-and-resume bit for bit, a CNNHyper checkpoint refused as
HyperNetwork (JAX ``tests/test_e2e.py:117-146``), and a hyper YAML
through the CLI.  The round and the update themselves are held against
the JAX package in ``test_torch_port_hyper_round.py`` and
``test_torch_port_hyper_update.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_threads import one_torch_thread  # noqa: F401

from attackfl_tpu.data.synthetic import get_dataset as jax_get_dataset
from attackfl_tpu.eval.validation import evaluate_hyper_cifar as jax_evaluate_hyper_cifar
from attackfl_tpu.eval.validation import evaluate_hyper_icu as jax_evaluate_hyper_icu
from attackfl_tpu.models import icu as jicu
from attackfl_tpu.models.resnet import ResNet18 as JaxResNet
from attackfl_tpu_torch import cli
from attackfl_tpu_torch.config import AttackSpec, Config, HyperDetectionConfig
from attackfl_tpu_torch.eval.validation import evaluate_hyper_cifar, evaluate_hyper_icu
from attackfl_tpu_torch.models.resnet import ResNet18
from attackfl_tpu_torch.ops import pytree as pt
from attackfl_tpu_torch.registry import get_model
from attackfl_tpu_torch.training.engine import Simulator

LIE = dict(mode="LIE", num_clients=2, attack_round=2, args=(0.74,))


def _stacked_params(model, clients: int, seed: int) -> dict:
    """Per-client params (numpy, JAX layout): the port's init nudged per
    client by a seeded 0.05."""
    rng = np.random.default_rng(seed)
    tree = model.init(torch.Generator().manual_seed(seed))
    return pt.tree_map(lambda x: (x.numpy()[None] + 0.05 * rng.standard_normal(
        (clients,) + tuple(x.shape))).astype(np.float32), tree)


def test_evaluate_hyper_icu_matches_jax():
    test_np = jax_get_dataset("ICU", "test", 96, 1)
    stacked = _stacked_params(get_model("TransformerModel"), 3, 4)
    ref = jax.jit(lambda p, d: jax_evaluate_hyper_icu(jicu.TransformerModel(), p, d))(
        stacked, {k: jnp.asarray(v) for k, v in test_np.items()})
    ours = evaluate_hyper_icu(get_model("TransformerModel"), pt.tree_map(torch.from_numpy, stacked),
                              {k: torch.from_numpy(v) for k, v in test_np.items()})
    assert abs(float(ours["roc_auc"]) - float(ref["roc_auc"])) <= 1e-6
    assert bool(ours["ok"]) and bool(ref["ok"]) and float(ours["metric"]) == float(
        ours["roc_auc"])


def test_evaluate_hyper_cifar_matches_jax():
    narrow = dict(stage_features=(8, 16, 32, 64))
    rng = np.random.default_rng(8)
    test_np = {"x": rng.uniform(-1, 1, (8, 16, 16, 3)).astype(np.float32),
               "label": rng.integers(0, 10, 8).astype(np.int32)}
    stacked = _stacked_params(ResNet18(**narrow), 2, 6)
    ref = jax.jit(lambda p, d: jax_evaluate_hyper_cifar(JaxResNet(**narrow), p, d))(
        stacked, {k: jnp.asarray(v) for k, v in test_np.items()})
    ours = evaluate_hyper_cifar(ResNet18(**narrow), pt.tree_map(torch.from_numpy, stacked),
                                {k: torch.from_numpy(v) for k, v in test_np.items()})
    assert abs(float(ours["nll"]) - float(ref["nll"])) <= 1e-4
    assert abs(float(ours["accuracy"]) - float(ref["accuracy"])) <= 1e-4
    assert bool(ours["ok"]) and bool(ref["ok"])

SMALL = dict(num_round=3, total_clients=8, mode="hyper", model="TransformerModel",
             data_name="ICU", num_data_range=(24, 32), epochs=1, batch_size=16,
             train_size=256, test_size=128)


def _cfg(tmp, **kw):
    return Config(**{**SMALL, "log_path": str(tmp), "checkpoint_dir": str(tmp), **kw})


def test_simulator_runs_with_the_detector(tmp_path):
    """Two rounds with the detector from round 2 and two LIE attackers:
    every round ok, the embeddings saved, the AUC finite; a removal (if
    any) leaves its clients inactive and the round still ok."""
    cfg = _cfg(tmp_path, num_round=2, attacks=(AttackSpec(**LIE),),
               hyper_detection=HyperDetectionConfig(enable=True, start_round=2,
                                                    cosine_search=5))
    sim = Simulator(cfg, device="cpu")
    state, history = sim.run(save_checkpoints=False, verbose=False)
    assert [h["ok"] for h in history] == [True, True]
    assert (tmp_path / "all_embeddings.npy").exists()
    assert all(np.isfinite(h["roc_auc"]) for h in history)
    removed = [c for h in history for c in h.get("removed_clients", [])]
    assert sorted(torch.nonzero(state["active_mask"] == 0)[:, 0].tolist()) == sorted(removed)
    assert int(state["hyper_opt_state"]["count"]) >= 8 - len(removed)


def test_a_removal_rolls_the_update_back(tmp_path, monkeypatch):
    """JAX engine.py:1722-1760: when the detector removes clients, the
    hypernetwork and its Adam state stay those of the round's start, the
    removed clients stay inactive for the rest of the run, the round is
    ok, and validation reads the active clients only."""
    cfg = _cfg(tmp_path, num_round=2,
               hyper_detection=HyperDetectionConfig(enable=True, start_round=2))
    sim = Simulator(cfg, device="cpu")
    state, _ = sim.run(num_rounds=1, save_checkpoints=False, verbose=False)
    seen = {}
    monkeypatch.setattr(sim.detector, "observe",
                        lambda round_number, selected, emb: [2, 5] if round_number == 2 else [])
    test_hyper = sim.validation.test_hyper
    monkeypatch.setattr(sim.validation, "test_hyper", lambda stacked: (
        seen.setdefault("rows", pt.tree_leaves(stacked)[0].shape[0]), test_hyper(stacked))[1])
    new, metrics = sim.run_round(state)
    assert metrics["ok"] and metrics["removed_clients"] == [2, 5]
    assert new["hnet_params"] is state["hnet_params"]
    assert new["hyper_opt_state"] is state["hyper_opt_state"]
    assert new["completed_rounds"] == 2 and seen["rows"] == 6
    assert new["active_mask"].tolist() == [1, 1, 0, 1, 1, 0, 1, 1]
    # the next round trains without them: 6 Adam steps
    count = int(new["hyper_opt_state"]["count"])
    monkeypatch.setattr(sim.detector, "observe", lambda *a: [])
    newer, metrics = sim.run_round(new)
    assert metrics["ok"] and int(newer["hyper_opt_state"]["count"]) == count + 6


@pytest.mark.parametrize("extra", [
    dict(attacks=(AttackSpec(**LIE),),
         client_dropout_rate=0.3),
    dict(hyper_update_mode="batched", hyper_spec_norm=True),
])
def test_kill_and_resume_is_bit_identical(tmp_path, extra):
    """Two rounds without a stop, against one round, a new Simulator with
    ``resume`` and round 2 (attacks fire from round 2)."""
    whole, _ = Simulator(_cfg(tmp_path / "a", num_round=2, **extra), device="cpu").run(
        verbose=False)
    Simulator(_cfg(tmp_path / "b", num_round=1, **extra), device="cpu").run(verbose=False)
    resumed, history = Simulator(_cfg(tmp_path / "b", num_round=2, resume=True, **extra),
                                 device="cpu").run(verbose=False)
    assert [h["round"] for h in history] == [2]
    assert torch.equal(whole["hnet_params"], resumed["hnet_params"])
    for key in ("count", "m", "v"):
        assert torch.equal(whole["hyper_opt_state"][key], resumed["hyper_opt_state"][key])
    for (_, x), (_, y) in zip(pt.tree_items(whole["prev_genuine"]),
                              pt.tree_items(resumed["prev_genuine"])):
        assert torch.equal(x, y)
    assert torch.equal(whole["active_mask"], resumed["active_mask"])
    for key in ("have_genuine", "completed_rounds", "broadcasts"):
        assert whole[key] == resumed[key]
    assert torch.equal(whole["rng"].get_state(), resumed["rng"].get_state())


def test_cnn_hyper_checkpoint_is_refused_as_hypernetwork(tmp_path):
    """JAX tests/test_e2e.py:117-146: a CNNHyper checkpoint resumes as
    CNNHyper, and fails with the structure-mismatch error as HyperNetwork."""
    cfg = _cfg(tmp_path, num_round=1, total_clients=3, model="CNNModel", hyper_class="CNNHyper")
    Simulator(cfg, device="cpu").run(verbose=False)
    again = Simulator(cfg.replace(load_parameters=True, num_round=2), device="cpu")
    state = again.load_or_init_state()
    assert state["completed_rounds"] == 1
    _, history = again.run(state=state, save_checkpoints=False, verbose=False)
    assert [h["round"] for h in history] == [2] and history[0]["ok"]
    bad = Simulator(cfg.replace(load_parameters=True, hyper_class="HyperNetwork"), device="cpu")
    with pytest.raises(ValueError, match="does not match the current state"):
        bad.load_or_init_state()


def test_hyper_yaml_runs_through_the_cli(tmp_path, monkeypatch, capsys):
    path = tmp_path / "hyper.yaml"
    path.write_text(
        "server: {num-round: 2, clients: 3, mode: hyper, model: RNNModel, data-name: ICU,\n"
        "         train-size: 256, test-size: 128, hyper-update-mode: batched,\n"
        "         data-distribution: {num-data-range: [24, 32]}}\n"
        "learning: {epoch: 1, batch-size: 16}\n")
    monkeypatch.chdir(tmp_path)
    assert cli.run_main(["--config", str(path), "--device", "cpu"]) == 0
    assert "Finished: 2 successful rounds." in capsys.readouterr().out
    assert (tmp_path / "RNNModel_hyper_3.pth").exists()
