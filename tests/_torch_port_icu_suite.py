"""The tests of tests/test_torch_port_models_cnn.py and
tests/test_torch_port_models_rnn.py: the ICU CNNModel and RNNModel of the
port against the JAX package.  Each of those files imports these tests
and defines the module fixture ``name``, the model they run on; the CNN's
file states the tolerances and why.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_models import (
    both_rounds, count_mask_draws, max_err, one_step_both, port_local_update, seeded_params,
)
from attackfl_tpu.data.synthetic import get_dataset as jax_get_dataset
from attackfl_tpu.eval.validation import evaluate_icu as jax_evaluate_icu
from attackfl_tpu.models.icu import CNNModel as JaxCNN
from attackfl_tpu.models.icu import RNNModel as JaxRNN
from attackfl_tpu.ops import aggregators as jagg
from attackfl_tpu_torch.config import AttackSpec, Config
from attackfl_tpu_torch.eval.validation import evaluate_icu
from attackfl_tpu_torch.models.icu import CNNModel, RNNModel
from attackfl_tpu_torch.ops import aggregators
from attackfl_tpu_torch.ops import pytree as pt
from attackfl_tpu_torch.registry import get_model
from attackfl_tpu_torch.training import local
from attackfl_tpu_torch.training.engine import Simulator
from attackfl_tpu_torch.weights import params_from_jax

MODELS = {"CNNModel": (JaxCNN, CNNModel, 203_649), "RNNModel": (JaxRNN, RNNModel, 96_897)}
EPOCHS, BATCH, RANGE = 2, 16, (24, 40)
# (clients, attack, dtype, param tolerance): CNN against LIE, RNN under
# plain FedAvg
ROUNDS = {"CNNModel": (6, dict(mode="LIE", num_clients=2, attack_round=1, args=(0.74,)),
                       np.float64, 2e-4),
          "RNNModel": (4, None, np.float32, 5e-4)}


@pytest.fixture(scope="module")
def train_np():
    return jax_get_dataset("ICU", "train", 256, 1)


def _inputs(n=16, seed=1):
    rng = np.random.default_rng(seed)
    vitals = rng.standard_normal((n, 7)).astype(np.float32)
    vitals[rng.uniform(size=vitals.shape) < 0.1] = -2.0      # RNNModel zeroes the mask value
    return vitals, rng.standard_normal((n, 16)).astype(np.float32)


def test_tree_matches_jax_names_and_shapes(name):
    jax_cls, port_cls, count = MODELS[name]
    ref = jax.eval_shape(jax_cls().init, jax.random.PRNGKey(0), jnp.zeros((1, 7)),
                         jnp.zeros((1, 16)))["params"]
    ref_paths = [("/".join(str(k.key) for k in p), tuple(x.shape))
                 for p, x in jax.tree_util.tree_leaves_with_path(ref)]
    ours = get_model(name).init(torch.Generator().manual_seed(0))
    assert [(p, tuple(x.shape)) for p, x in pt.tree_items(ours)] == ref_paths
    assert sum(x.numel() for x in pt.tree_leaves(ours)) == count


def test_init_follows_flax_distributions(name):
    """lecun-normal kernels (fan-in prod(kernel[:-1]): k * in for a conv),
    orthogonal GRU recurrent kernels, zero biases, LayerNorm ones."""
    tree = dict(pt.tree_items(get_model(name).init(torch.Generator().manual_seed(3))))
    for path, x in tree.items():
        leaf = path.rsplit("/", 1)[1]
        if leaf == "bias":
            assert torch.count_nonzero(x) == 0, path
        elif leaf == "scale":
            assert torch.equal(x, torch.ones_like(x)), path
        elif path.split("/")[-2] in ("hr", "hz", "hn"):
            assert torch.allclose(x.T @ x, torch.eye(x.shape[1]), atol=1e-5), path
        else:
            fan_in = int(np.prod(x.shape[:-1]))
            assert float(x.abs().max()) <= 2.0 / np.sqrt(fan_in) / 0.8796 + 1e-6, path
            if x.numel() >= 1024:
                assert abs(float(x.std()) * np.sqrt(fan_in) - 1.0) < 0.1, path


def test_forward_matches_flax(name):
    jax_cls, port_cls, _ = MODELS[name]
    params = seeded_params(port_cls(), seed=2)
    vitals, labs = _inputs()
    ref = jax.jit(jax_cls().apply)({"params": params}, vitals, labs)
    ours = port_cls().apply(params_from_jax(params, name), torch.from_numpy(vitals),
                            torch.from_numpy(labs))
    assert ours.shape == (16, 1)
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_mask_specs(name, monkeypatch, train_np):
    """Two (B, width) masks a step at 0.3, ids apart, one K3 call a step."""
    model = get_model(name)
    specs = model.mask_specs([(32, 7), (32, 16)], model.dropout_rates)
    width = 512 if name == "CNNModel" else 64
    assert specs == [(16, 32, width, 0.3), (17, 32, width, 0.3)]
    update = local.build_local_update(
        model, "ICU", {k: torch.from_numpy(v) for k, v in train_np.items()},
        epochs=1, batch_size=8, lr=0.004, clip_grad_norm=1.0)
    out = {}
    calls = count_mask_draws(monkeypatch, lambda: out.update(r=update(
        model.init(torch.Generator().manual_seed(0)), torch.arange(32).reshape(2, 16),
        torch.ones((2, 16), dtype=torch.bool), torch.arange(16).expand(1, 2, 16), 3)))
    assert calls == 2 and bool(out["r"][1].all())


@pytest.fixture(scope="module")
def rounds(name, train_np):
    jax_cls, port_cls, _ = MODELS[name]
    clients, attack, dtype, _ = ROUNDS[name]
    return both_rounds(jax_cls(), port_cls(), train_np, data_name="ICU", clients=clients,
                       epochs=EPOCHS, batch=BATCH, num_data_range=RANGE, attack=attack,
                       dtype=dtype)


def test_one_step_loss_and_gradient_match_jax(name, train_np):
    """float32, with a quarter of the rows masked out."""
    jax_cls, port_cls, _ = MODELS[name]
    params = seeded_params(port_cls(), seed=4)
    batch = {k: v[:32] for k, v in train_np.items()}
    mask = (np.arange(32) < 24).astype(np.float32)
    (j_loss, j_grads), (t_loss, t_grads) = one_step_both(jax_cls(), port_cls(), "ICU", batch,
                                                         params, mask)
    assert abs(float(t_loss) - float(j_loss)) <= 1e-6
    scale = max(float(np.abs(np.asarray(g)).max()) for g in jax.tree.leaves(j_grads))
    assert max_err(t_grads, j_grads) <= 1e-5 * scale


def test_local_update_matches_jax(name, rounds, train_np):
    tp, ok, loss = port_local_update(get_model(name), train_np, rounds, data_name="ICU",
                                     epochs=EPOCHS, batch=BATCH)
    assert bool(ok.all())
    assert max_err(tp, rounds.jax[0], rounds.genuine) <= ROUNDS[name][3]
    assert abs(float(loss.mean()) - float(rounds.jax[4])) <= 1e-4


def test_round_matches_jax(name, rounds):
    j_stacked, j_sizes, j_gen, j_ok, j_loss = rounds.jax
    t_stacked, t_sizes, t_gen, t_ok, t_loss = rounds.port
    assert bool(j_ok) and bool(t_ok)
    np.testing.assert_array_equal(t_sizes.numpy(), np.asarray(j_sizes))
    assert abs(float(t_loss) - float(j_loss)) < 1e-4
    tol = ROUNDS[name][3]
    assert max_err(t_stacked, j_stacked, rounds.genuine) <= tol
    if rounds.attackers:
        assert max_err(t_stacked, j_stacked, rounds.attackers) <= 1e-5
    assert max_err(t_gen, j_gen) <= tol
    dtype = pt.tree_leaves(rounds.params)[0].dtype
    with jax.enable_x64(dtype == np.float64):
        j_agg = pt.tree_map(np.asarray, jagg.fedavg(j_stacked, j_sizes.astype(dtype)))
    t_agg = aggregators.fedavg(t_stacked, t_sizes.to(pt.tree_leaves(t_stacked)[0].dtype))
    assert max_err(t_agg, j_agg) <= tol
    # validation in float32, as the engine runs it
    j_agg = pt.tree_map(lambda x: x.astype(np.float32), j_agg)
    t_agg = pt.tree_map(lambda x: x.to(torch.float32), t_agg)
    test_np = jax_get_dataset("ICU", "test", 256, 1)
    j_auc = float(jax_evaluate_icu(MODELS[name][0](), j_agg,
                                   {k: jnp.asarray(v) for k, v in test_np.items()})["roc_auc"])
    t_auc = float(evaluate_icu(get_model(name), t_agg,
                               {k: torch.from_numpy(v) for k, v in test_np.items()})["roc_auc"])
    assert np.isfinite(t_auc) and abs(t_auc - j_auc) <= 1e-3


def test_simulator_runs_on_cpu(name):
    """Two rounds through the engine under xla with dropout on: every round
    ok, AUC above 0.5."""
    cfg = Config(num_round=2, total_clients=3, mode="fedavg", model=name, data_name="ICU",
                 num_data_range=(24, 32), epochs=2, batch_size=16, train_size=256,
                 test_size=128, attacks=(AttackSpec(mode="LIE", num_clients=1,
                                                    attack_round=2),))
    state, history = Simulator(cfg, device="cpu").run(save_checkpoints=False, verbose=False)
    assert [h["ok"] for h in history] == [True, True]
    assert history[-1]["roc_auc"] > 0.5
    assert all(bool(torch.isfinite(x).all()) for x in pt.tree_leaves(state["global_params"]))
