"""``chip_smoke.py`` phase 23 runs the workload of the JAX package's
committed full-scale run, on the CPU.

Phase 23's ``Config`` and the config file it writes, read back through
the port's ``load_config``, equal ``scripts/full_parity_jax.py``
``full_scale_config(30)`` (the run behind ``FULL_PARITY_JAX.json``) field
by field: rounds, clients, attacks, samples a client, epochs, batch,
learning rate, clip, genuine rate, data sizes and seed, under each
backend the phase runs.  The JAX run's final AUC and its rounds 16-30,
which the phase prints beside its own, are read as the artifacts hold
them.
"""

import importlib.util
import json
import os

import pytest

import chip_smoke
from attackfl_tpu_torch.config import load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("num_round", "total_clients", "mode", "model", "data_name", "num_data_range",
          "epochs", "batch_size", "lr", "clip_grad_norm", "genuine_rate", "train_size",
          "test_size", "random_seed", "validation")


def _jax_full_scale_config(log_path: str):
    spec = importlib.util.spec_from_file_location(
        "full_parity_jax", os.path.join(REPO, "scripts", "full_parity_jax.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.full_scale_config(30, log_path)


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_phase_23_config_is_the_jax_full_scale_run(tmp_path, backend):
    ref = _jax_full_scale_config(str(tmp_path))
    cfg = chip_smoke.full_scale_config(backend, 1, str(tmp_path))
    path = chip_smoke.config_yaml(str(tmp_path / "config4_full.yaml"), cfg, str(tmp_path))
    for got in (cfg, load_config(path)):
        for field in FIELDS:
            assert getattr(got, field) == getattr(ref, field), field
        assert [(a.mode, a.num_clients, a.attack_round, tuple(a.args)) for a in got.attacks] \
            == [(a.mode, a.num_clients, a.attack_round, tuple(a.args)) for a in ref.attacks]
        assert got.local_backend == backend
    assert (ref.num_round, ref.total_clients, ref.epochs, ref.num_data_range) \
        == (30, 100, 5, (12000, 15000))


def test_phase_23_reads_the_jax_run_as_committed():
    final, rounds = chip_smoke.jax_full_scale()
    with open(os.path.join(REPO, "FULL_PARITY_JAX.json")) as fh:
        artifact = json.load(fh)
    assert final == artifact["final_roc_auc"] == 0.9228
    assert artifact["ok_rounds"] == artifact["rounds"] == 30
    assert sorted(rounds) == list(range(16, 31))
    assert (rounds[16], rounds[30]) == (0.9285, final)
