"""The port's engine, round draws and CLI on the CPU, at a small size."""

import math

import pytest
import torch

from attackfl_tpu_torch import cli
from attackfl_tpu_torch.config import (
    AGGREGATION_MODES, AttackSpec, Config, HyperDetectionConfig, MeshConfig, TelemetryConfig,
)
from attackfl_tpu_torch.data.partition import draw_round
from attackfl_tpu_torch.faults.plan import parse_fault_plan
from attackfl_tpu_torch.ops import fused_step
from attackfl_tpu_torch.ops import pytree as pt
from attackfl_tpu_torch.training.engine import MAX_ROUND_RETRIES, Simulator, check_slice

SMALL = dict(num_round=3, total_clients=8, mode="fedavg", model="TransformerModel",
             data_name="ICU", num_data_range=(24, 32), epochs=2, batch_size=16,
             train_size=256, test_size=128, local_backend="pallas",
             attacks=(AttackSpec(mode="LIE", num_clients=2, attack_round=2),))


def test_simulator_runs_three_rounds_on_cpu():
    sim = Simulator(Config(**SMALL), device="cpu")
    launches = fused_step.run_epoch.launches
    state, history = sim.run(save_checkpoints=False, verbose=False)
    assert [h["ok"] for h in history] == [True, True, True]
    assert state["completed_rounds"] == 3 and state["have_genuine"]
    assert all(math.isfinite(h["roc_auc"]) for h in history)
    assert history[-1]["roc_auc"] > 0.5
    assert all(bool(torch.isfinite(x).all()) for x in pt.tree_leaves(state["global_params"]))
    # the CPU path runs the plain version: no kernel launch is counted
    assert fused_step.run_epoch.launches == launches


def test_same_seed_same_run():
    runs = [Simulator(Config(**{**SMALL, "num_round": 1}), device="cpu").run(
        save_checkpoints=False, verbose=False) for _ in range(2)]
    (s1, h1), (s2, h2) = runs
    assert h1[0]["roc_auc"] == h2[0]["roc_auc"]
    for a, b in zip(pt.tree_leaves(s1["global_params"]), pt.tree_leaves(s2["global_params"])):
        assert torch.equal(a, b)


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Simulator(Config(**SMALL))


@pytest.mark.parametrize("override", [
    {"mesh": MeshConfig(num_devices=2)},
    {"pipeline": True},
    {"telemetry": TelemetryConfig(monitor=True)},
])
def test_outside_the_slice_is_refused(override):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Simulator(Config(**{**SMALL, **override}), device="cpu")


@pytest.mark.parametrize("override", [
    {"local_backend": "xla", "mesh": MeshConfig(compute_dtype="bfloat16")},
    {"checkpoint_async": True, "validation_async": True},
])
def test_mixed_precision_and_the_async_paths_are_in_the_slice(override):
    """bf16 for the xla update (ROADMAP item 3b), the async checkpoint
    writer and async validation (item 13, part) were refused until this
    slice; the Simulator now builds with them."""
    sim = Simulator(Config(**{**SMALL, **override}), device="cpu")
    assert (sim.checkpoint_writer is not None) == bool(override.get("checkpoint_async"))
    sim.close()


@pytest.mark.parametrize("model,data", [("CNNModel", "ICU"), ("RNNModel", "ICU"),
                                        ("TransformerClassifier", "HAR"),
                                        ("ResNet18", "CIFAR10")])
def test_every_model_on_its_dataset_is_in_the_slice(model, data):
    """The models refused until ROADMAP item 11 run under xla on their
    datasets; pallas stays refused for them, and a model on another
    model's dataset is refused."""
    cfg = Config(**{**SMALL, "model": model, "data_name": data, "local_backend": "xla"})
    check_slice(cfg)
    with pytest.raises(ValueError, match="pallas"):
        Config(**{**SMALL, "model": model, "data_name": data})
    other = "HAR" if data != "HAR" else "ICU"
    with pytest.raises(ValueError, match="does not run on"):
        check_slice(Config(**{**SMALL, "model": model, "data_name": other,
                              "local_backend": "xla"}))


@pytest.mark.parametrize("mode", AGGREGATION_MODES)
def test_every_mode_but_hyper_is_in_the_slice(mode):
    """Every aggregation mode runs under xla; hyper joined the slice with
    ROADMAP item 12 (the test keeps its name)."""
    check_slice(Config(**{**SMALL, "mode": mode, "local_backend": "xla"}))


@pytest.mark.parametrize("override", [
    {"hyper_class": "CNNHyper", "model": "CNNModel", "hyper_spec_norm": True},
    {"hyper_update_mode": "batched", "client_dropout_rate": 0.2},
    {"hyper_detection": HyperDetectionConfig(enable=True, start_round=2)},
    {"model": "ResNet18", "data_name": "CIFAR10"},
    {"model": "TransformerClassifier", "data_name": "HAR", "validation": False},
])
def test_hyper_combinations_are_in_the_slice(override):
    """What the JAX package accepts in hyper mode, the port does: both
    classes and update modes, spectral normalization, the detector,
    attackers and stragglers, every model on its dataset."""
    check_slice(Config(**{**SMALL, "mode": "hyper", "local_backend": "xla", **override}))


@pytest.mark.parametrize("override,match", [
    ({"local_backend": "pallas"}, "xla backend only"),
    ({"local_backend": "xla", "hyper_class": "CNNHyper", "model": "RNNModel"},
     "hand-specialized to CNNModel"),
    ({"local_backend": "xla", "model": "TransformerClassifier", "data_name": "HAR"},
     "no HAR evaluator"),
])
def test_hyper_refusals_of_the_jax_package_stay(override, match):
    with pytest.raises(ValueError, match=match):
        Config(**{**SMALL, "mode": "hyper", **override})


def test_hyper_takes_bf16_and_faults_and_keeps_the_pipeline_refusal():
    """Hyper mode takes bf16 and a fault plan as the plain round does;
    the pipelined executor stays refused (ROADMAP queue 1, item 13)."""
    hyper = {**SMALL, "mode": "hyper", "local_backend": "xla"}
    check_slice(Config(**hyper, mesh=MeshConfig(compute_dtype="bfloat16")))
    with pytest.raises(NotImplementedError, match="item 13"):
        check_slice(Config(**hyper, pipeline=True))
    cfg = Config(**hyper, faults=parse_fault_plan("nan_storm@2:clients=1;dropout@3"))
    check_slice(cfg)
    assert [s.kind for s in cfg.faults] == ["nan_storm", "dropout"]


def test_compute_dtype_is_refused_where_it_applies():
    """As in JAX, compute-dtype reaches only the xla local update.  For
    pallas the config itself refuses it (K1 is float32); the xla path
    takes bfloat16 and float16."""
    bf16 = MeshConfig(compute_dtype="bfloat16")
    with pytest.raises(ValueError, match="computes in float32"):
        Config(**{**SMALL, "mesh": bf16})
    check_slice(Config(**{**SMALL, "local_backend": "xla"}))
    for dtype in ("bfloat16", "float16"):
        check_slice(Config(**{**SMALL, "local_backend": "xla",
                              "mesh": MeshConfig(compute_dtype=dtype)}))


def test_failed_round_keeps_params_and_leak_pool():
    """NaN training fails the round: global params stay, the leak pool is
    not refreshed, the broadcast clock still advances (server.py:546-567)."""
    sim = Simulator(Config(**SMALL), device="cpu")
    state = sim.init_state()
    state["global_params"]["fc1"]["bias"][0] = float("nan")
    new, metrics = sim.run_round(state)
    assert not metrics["ok"] and new["broadcasts"] == 1 and new["completed_rounds"] == 0
    assert new["global_params"] is state["global_params"]
    for a, b in zip(pt.tree_leaves(new["prev_genuine"]), pt.tree_leaves(state["prev_genuine"])):
        assert torch.equal(a, b)
    assert not new["have_genuine"]


def test_retry_cap(monkeypatch):
    sim = Simulator(Config(**SMALL), device="cpu")
    monkeypatch.setattr(sim.validation, "test", lambda params: (False, {"roc_auc": 0.5}))
    with pytest.raises(RuntimeError, match="failed"):
        sim.run(num_rounds=1, save_checkpoints=False, verbose=False)
    assert MAX_ROUND_RETRIES == 20


def test_draw_round_semantics():
    gen = torch.Generator().manual_seed(0)
    d = draw_round(gen, num_clients=6, pool_size=50, lo=3, hi=9, epochs=2,
                   num_genuine=4, leak_groups=[2], leak_k=3)
    assert d.idx.shape == (6, 9) and int(d.idx.min()) >= 0 and int(d.idx.max()) < 50
    assert int(d.sizes.min()) >= 3 and int(d.sizes.max()) <= 9
    assert torch.equal(d.mask.sum(1), d.sizes)
    assert torch.equal(torch.sort(d.perms, dim=-1).values,
                       torch.arange(9).expand(2, 6, 9))
    (leaks,) = d.leaks
    assert leaks.shape == (2, 3)
    assert all(len(set(row.tolist())) == 3 for row in leaks)   # without replacement


def test_cli_run_on_cpu(tmp_path, capsys, monkeypatch):
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
