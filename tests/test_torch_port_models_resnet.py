"""ResNet18 on CIFAR-10, its data, loss and evaluation, in the port
against the JAX package.

Same numpy-made inputs into both packages; params are the port's init
nudged by a seeded 0.05, the same arrays on both sides.  Tolerances: the
eval-mode log-probabilities at full width on two 32x32 images 1e-4 (18
convs with GroupNorm in float32); a stride-2 conv 1e-5; one minibatch's
float32 NLL at 1e-6 and gradient at 1e-5 of its largest magnitude; the
local update 2e-4 on the params and 1e-4 on the loss; the round's trained
rows and aggregate 2e-4, the Opt-Fang rows 1e-5; accuracy as the same
rows right, NLL 1e-5.  The training checks run at a narrow width
(stage_features (8, 16, 32, 64)) on 8x8 images, since the JAX package's
CPU compile of the full-width training loop takes minutes, and in
float64 in both packages: there the last stage's GroupNorm sees 2 values
a group (1x1 pixels, 2 channels), where flax's E[x^2] - E[x]^2 variance
and torch's two-pass one differ by float32 cancellation, and Adam's cold
start amplifies it (see tests/test_torch_port_models_icu.py); in float32
the rows parted by 2.1e-2 and the loss by 9.9e-2 (measured), in float64
by 3.2e-5 and 1.1e-5 (JAX rounds the log-probabilities to float32 in its
loss).  The float32 step check runs on 16x16 images (8 values a group).
"""

import pickle

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_threads import one_torch_thread  # noqa: F401

from _torch_port_models import (
    both_rounds, max_err, one_step_both, port_local_update, seeded_params,
)
from attackfl_tpu.data import synthetic as jsyn
from attackfl_tpu.eval.validation import evaluate_cifar as jax_evaluate_cifar
from attackfl_tpu.models.resnet import ResNet18 as JaxResNet
from attackfl_tpu.ops import aggregators as jagg
from attackfl_tpu_torch.data import synthetic
from attackfl_tpu_torch.eval.validation import evaluate_cifar
from attackfl_tpu_torch.models.layers import Conv, same_pads
from attackfl_tpu_torch.models.resnet import ResNet18
from attackfl_tpu_torch.ops import aggregators
from attackfl_tpu_torch.ops import fused_step as tfs
from attackfl_tpu_torch.ops import pytree as pt
from attackfl_tpu_torch.training import local

NARROW = dict(stage_features=(8, 16, 32, 64))
EPOCHS, BATCH, RANGE, CLIENTS = 1, 4, (6, 10), 4
OPT_FANG = dict(mode="Opt-Fang", num_clients=1, attack_round=1, args=(50.0, 1.0))


def _images(n, side, seed=0):
    rng = np.random.default_rng(seed)
    return {"x": rng.uniform(-1, 1, (n, side, side, 3)).astype(np.float32),
            "label": rng.integers(0, 10, n).astype(np.int32)}


def test_tree_matches_jax_names_and_shapes():
    ref = jax.eval_shape(JaxResNet().init, jax.random.PRNGKey(0),
                         jnp.zeros((1, 32, 32, 3)))["params"]
    ref_paths = [("/".join(str(k.key) for k in p), tuple(x.shape))
                 for p, x in jax.tree_util.tree_leaves_with_path(ref)]
    ours = ResNet18().init(torch.Generator().manual_seed(0))
    assert [(p, tuple(x.shape)) for p, x in pt.tree_items(ours)] == ref_paths
    assert sum(x.numel() for x in pt.tree_leaves(ours)) == 11_173_962
    # at a narrow width the first block needs the projection too (64 -> 8)
    narrow = jax.eval_shape(JaxResNet(**NARROW).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8, 8, 3)))["params"]
    assert ([p for p, _ in pt.tree_items(ResNet18(**NARROW).init())]
            == ["/".join(str(k.key) for k in p)
                for p, _ in jax.tree_util.tree_leaves_with_path(narrow)])


def test_init_follows_flax_distributions():
    tree = dict(pt.tree_items(ResNet18().init(torch.Generator().manual_seed(3))))
    for path, x in tree.items():
        leaf = path.rsplit("/", 1)[1]
        if leaf == "bias":
            assert torch.count_nonzero(x) == 0, path
        elif leaf == "scale":
            assert torch.equal(x, torch.ones_like(x)), path
        else:
            fan_in = int(np.prod(x.shape[:-1]))      # kh * kw * in for a conv
            assert float(x.abs().max()) <= 2.0 / np.sqrt(fan_in) / 0.8796 + 1e-6, path
            if x.numel() >= 1024:
                assert abs(float(x.std()) * np.sqrt(fan_in) - 1.0) < 0.1, path


def test_forward_matches_flax_at_full_width():
    params = seeded_params(ResNet18(), seed=2)
    x = _images(2, 32, seed=1)["x"]
    ref = jax.jit(JaxResNet().apply)({"params": params}, x)
    model = ResNet18()
    ours = model.apply(pt.tree_map(torch.from_numpy, params), torch.from_numpy(x))
    assert ours.shape == (2, 10)
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), atol=1e-4, rtol=0)
    # an NCHW batch is taken as it is (JAX resnet.py:49-50)
    nchw = model.apply(pt.tree_map(torch.from_numpy, params),
                       torch.from_numpy(x).permute(0, 3, 1, 2))
    assert torch.equal(nchw, ours)


@pytest.mark.parametrize("kernel,side", [((3, 3), 32), ((3, 3), 7), ((1, 1), 32)])
def test_stride_two_same_padding_matches_flax(kernel, side):
    """flax pads "SAME" at stride 2 by (0, 1) on an even side (32 -> 16),
    not torch's symmetric padding=1; a 1x1 conv needs no pad."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, side, side, 5)).astype(np.float32)
    flax_conv = fnn.Conv(6, kernel, strides=(2, 2), padding="SAME", use_bias=False)
    k = rng.standard_normal(kernel + (5, 6)).astype(np.float32)
    ref = flax_conv.apply({"params": {"kernel": k}}, x)
    conv = Conv(5, 6, kernel, stride=2, use_bias=False)
    with torch.no_grad():
        conv.kernel.copy_(torch.from_numpy(k))
        ours = conv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    assert same_pads((32,), (3,), 2) == [(0, 1)] and same_pads((7,), (3,), 2) == [(1, 1)]
    if kernel == (3, 3) and side == 32:
        # torch's symmetric padding=1 starts the windows one pixel earlier
        sym = torch.nn.functional.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                                         conv.kernel.detach().permute(3, 2, 0, 1),
                                         stride=2, padding=1).permute(0, 2, 3, 1)
        assert float((sym - torch.from_numpy(np.asarray(ref))).abs().max()) > 1e-2


def test_no_dropout_and_no_k3_draw():
    model = ResNet18(**NARROW)
    specs = model.mask_specs([(4, 8, 8, 3)], model.dropout_rates)
    assert model.dropout_rates == () and specs == []
    assert local.step_masks(tfs.client_keys(1, 0, torch.arange(2)), specs) is None


def test_one_step_loss_and_gradient_match_jax():
    """float32 NLL of the log-probabilities, masked mean, on 16x16 images."""
    params = seeded_params(ResNet18(**NARROW), seed=4)
    batch = _images(6, 16, seed=5)
    mask = (np.arange(6) < 5).astype(np.float32)
    (j_loss, j_grads), (t_loss, t_grads) = one_step_both(
        JaxResNet(**NARROW), ResNet18(**NARROW), "CIFAR10", batch, params, mask)
    assert abs(float(t_loss) - float(j_loss)) <= 1e-6
    scale = max(float(np.abs(np.asarray(g)).max()) for g in jax.tree.leaves(j_grads))
    assert max_err(t_grads, j_grads) <= 1e-5 * scale


@pytest.fixture(scope="module")
def train_np():
    return _images(64, 8, seed=1)


@pytest.fixture(scope="module")
def rounds(train_np):
    return both_rounds(JaxResNet(**NARROW), ResNet18(**NARROW), train_np,
                       data_name="CIFAR10", clients=CLIENTS, epochs=EPOCHS, batch=BATCH,
                       num_data_range=RANGE, attack=OPT_FANG, dtype=np.float64)


def test_local_update_matches_jax(rounds, train_np):
    tp, ok, loss = port_local_update(ResNet18(**NARROW), train_np, rounds,
                                     data_name="CIFAR10", epochs=EPOCHS, batch=BATCH)
    assert bool(ok.all())
    assert max_err(tp, rounds.jax[0], rounds.genuine) <= 2e-4
    assert abs(float(loss.mean()) - float(rounds.jax[4])) <= 1e-4


def test_round_with_opt_fang_matches_jax(rounds):
    j_stacked, j_sizes, j_gen, j_ok, j_loss = rounds.jax
    t_stacked, t_sizes, t_gen, t_ok, t_loss = rounds.port
    assert bool(j_ok) and bool(t_ok) and rounds.attackers
    np.testing.assert_array_equal(t_sizes.numpy(), np.asarray(j_sizes))
    assert abs(float(t_loss) - float(j_loss)) < 1e-4
    assert max_err(t_stacked, j_stacked, rounds.genuine) <= 2e-4
    assert max_err(t_stacked, j_stacked, rounds.attackers) <= 1e-5
    assert max_err(t_gen, j_gen) <= 2e-4
    with jax.enable_x64(True):
        j_agg = pt.tree_map(np.asarray, jagg.fedavg(j_stacked, j_sizes.astype(jnp.float64)))
    t_agg = aggregators.fedavg(t_stacked, t_sizes.to(torch.float64))
    assert max_err(t_agg, j_agg) <= 2e-4


def _evaluate_both(params, test_np, jax_eval):
    ref = jax_eval(params, {k: jnp.asarray(v) for k, v in test_np.items()})
    ours = evaluate_cifar(ResNet18(**NARROW), pt.tree_map(torch.from_numpy, params),
                          {k: torch.from_numpy(v) for k, v in test_np.items()})
    return ref, ours


def test_evaluate_cifar_matches_jax_and_gates_the_loss():
    """NLL and accuracy; a NLL above 1e6 fails the round in both."""
    params = seeded_params(ResNet18(**NARROW), seed=6)
    test_np = _images(40, 16, seed=8)
    jax_eval = jax.jit(lambda p, d: jax_evaluate_cifar(JaxResNet(**NARROW), p, d))
    ref, ours = _evaluate_both(params, test_np, jax_eval)
    assert round(float(ours["accuracy"]) * 40) == round(float(ref["accuracy"]) * 40)
    assert abs(float(ours["nll"]) - float(ref["nll"])) <= 1e-5
    assert float(ours["metric"]) == float(ours["accuracy"])
    assert bool(ours["ok"]) and bool(ref["ok"])
    params["classifier"]["kernel"] = params["classifier"]["kernel"] * np.float32(1e9)
    ref, ours = _evaluate_both(params, test_np, jax_eval)
    assert float(ours["nll"]) > 1e6 and float(ref["nll"]) > 1e6
    assert not bool(ours["ok"]) and not bool(ref["ok"])


@pytest.mark.parametrize("split,size,seed", [("train", 12, 1), ("test", 9, 7)])
def test_cifar_arrays_byte_equal(split, size, seed):
    ours = synthetic.get_dataset("CIFAR10", split, size, seed)
    ref = jsyn.get_dataset("CIFAR10", split, size, seed)
    assert sorted(ours) == sorted(ref) == ["label", "x"]
    for k in ref:
        assert ours[k].dtype == ref[k].dtype and ours[k].shape == ref[k].shape, k
        assert ours[k].tobytes() == ref[k].tobytes(), k


def test_cifar_batches_load_as_jax_loads_them(tmp_path, monkeypatch):
    """A fabricated cifar-10-batches-py (five train batches and a test
    batch of uint8 CHW rows); get_dataset reads it from ./data."""
    rng = np.random.default_rng(2)
    root = tmp_path / "data" / "cifar-10-batches-py"
    root.mkdir(parents=True)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(root / name, "wb") as fh:
            pickle.dump({b"data": rng.integers(0, 256, (3, 3072), dtype=np.uint8),
                         b"labels": rng.integers(0, 10, 3).tolist()}, fh)
    for split in ("train", "test"):
        ours = synthetic.load_cifar10_batches(str(tmp_path / "data"), split)
        ref = jsyn.load_cifar10_batches(str(tmp_path / "data"), split)
        assert ours["x"].shape == ((15 if split == "train" else 3), 32, 32, 3)
        for k in ref:
            assert ours[k].dtype == ref[k].dtype and ours[k].tobytes() == ref[k].tobytes(), k
    monkeypatch.chdir(tmp_path)
    got = synthetic.get_dataset("CIFAR10", "test", 99, 0)
    assert got["x"].tobytes() == ours["x"].tobytes()
