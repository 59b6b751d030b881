"""The HAR TransformerClassifier, its data, loss and evaluation, and K3's
per-tensor rows, in the port against the JAX package.

Same numpy-made inputs into both packages; params are the port's init
nudged by a seeded 0.05, the same arrays on both sides.  Tolerances: the
eval-mode forward at full width (L = 561, a batch of 2) 1e-5; one
minibatch's float32 loss at 1e-6 and gradient at 1e-5 of its largest
magnitude; the local update 2e-4 on the params and 1e-4 on the loss; the
round's trained rows and aggregate 2e-4; the same rows classified right.  The training
checks run at a narrow width (d_model 16, ff 32, L 40), since the JAX
package's CPU compile of the full-width training loop takes minutes, and
in float64 in both packages: in float32 the ReLU FFN and Adam's cold
start (lr * g / (|g| + 1e-8) on gradients near float32 noise) part the
two trajectories by 2.8e-3 after two epochs (measured; 7.1e-9 in
float64), see tests/test_torch_port_models_icu.py.  Data are byte-equal;
the reference loaders read files the test writes.
"""

import gzip
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_threads import one_torch_thread  # noqa: F401

from _torch_port_models import (
    both_rounds, count_mask_draws, max_err, one_step_both, port_local_update, seeded_params,
)
from attackfl_tpu.data import synthetic as jsyn
from attackfl_tpu.eval.validation import evaluate_har as jax_evaluate_har
from attackfl_tpu.models.har import TransformerClassifier as JaxHAR
from attackfl_tpu.ops import aggregators as jagg
from attackfl_tpu_torch.config import Config
from attackfl_tpu_torch.data import synthetic
from attackfl_tpu_torch.eval.validation import evaluate_har
from attackfl_tpu_torch.models.har import TransformerClassifier
from attackfl_tpu_torch.models.layers import MultiHeadAttention
from attackfl_tpu_torch.ops import aggregators
from attackfl_tpu_torch.ops import fused_step as tfs
from attackfl_tpu_torch.ops import pytree as pt
from attackfl_tpu_torch.training import local
from attackfl_tpu_torch.training.engine import Simulator

NARROW = dict(d_model=16, ff_dim=32)
L, EPOCHS, BATCH, RANGE, CLIENTS = 40, 2, 8, (12, 20), 3


def _narrow_data(n, seed=0):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((n, L)).astype(np.float32),
            "label": rng.integers(0, 6, n).astype(np.int32)}


def test_tree_matches_jax_names_and_shapes():
    ref = jax.eval_shape(JaxHAR().init, jax.random.PRNGKey(0), jnp.zeros((1, 561)))["params"]
    ref_paths = [("/".join(str(k.key) for k in p), tuple(x.shape))
                 for p, x in jax.tree_util.tree_leaves_with_path(ref)]
    model = TransformerClassifier()
    ours = model.init(torch.Generator().manual_seed(0))
    assert [(p, tuple(x.shape)) for p, x in pt.tree_items(ours)] == ref_paths
    assert sum(x.numel() for x in pt.tree_leaves(ours)) == 104_774
    # the position encoding is a constant, not a leaf
    assert "pe" in dict(model.named_buffers()) and "pe" not in ours


def test_init_follows_flax_distributions():
    tree = dict(pt.tree_items(TransformerClassifier().init(torch.Generator().manual_seed(3))))
    for path, x in tree.items():
        leaf = path.rsplit("/", 1)[1]
        if leaf == "bias":
            assert torch.count_nonzero(x) == 0, path
        elif leaf == "scale":
            assert torch.equal(x, torch.ones_like(x)), path
        else:
            # q/k/v (D, H, dh): fan-in D; out (H, dh, D): H * dh; conv (3, 1, d): 3
            fan_in = 64 if "/out/" in path else int(np.prod(x.shape[:-1]))
            if any(f"/{n}/" in path for n in ("query", "key", "value")):
                fan_in = x.shape[0]
            assert float(x.abs().max()) <= 2.0 / np.sqrt(fan_in) / 0.8796 + 1e-6, path
            if x.numel() >= 1024:
                assert abs(float(x.std()) * np.sqrt(fan_in) - 1.0) < 0.1, path


def test_forward_matches_flax_at_full_width():
    params = seeded_params(TransformerClassifier(), seed=2)
    x = np.random.default_rng(1).standard_normal((2, 561)).astype(np.float32)
    ref = jax.jit(JaxHAR().apply)({"params": params}, x)
    model = TransformerClassifier()
    ours = model.apply(pt.tree_map(torch.from_numpy, params), torch.from_numpy(x))
    assert ours.shape == (2, 6)
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    # the (B, 1, L) torch layout is accepted, as in JAX
    again = model.apply(pt.tree_map(torch.from_numpy, params), torch.from_numpy(x)[:, None])
    assert torch.equal(again, ours)


def test_attention_weight_mask_is_shared_by_batch_and_heads():
    """flax's broadcast dropout: one (L, L) mask multiplies every batch
    row's and every head's softmax weights, after the softmax."""
    gen = torch.Generator().manual_seed(0)
    att = MultiHeadAttention(16, 4)
    for m in att.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(gen)
    x = torch.randn(3, 5, 16, generator=gen)
    mask = (torch.rand(5, 5, generator=gen) > 0.3).float() / 0.7
    q = att.query(x) / 2.0
    w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, att.key(x)), dim=-1)
    want = att.out(torch.einsum("bhqk,bkhd->bqhd", w * mask[None, None], att.value(x)))
    assert torch.allclose(att(x, mask), want, atol=1e-6, rtol=0)


def test_mask_specs_and_one_k3_draw_per_step(monkeypatch):
    """Per layer the (L, L) attention-weight mask and three (B*L, w) token
    masks, then the (B, 64) head mask at 0.3 whatever dropout_rate says;
    nine distinct ids; one fill_masks call per step."""
    model = TransformerClassifier(dropout_rate=0.2)
    specs = model.mask_specs([(128, 561)], model.dropout_rates)
    assert [s[1:] for s in specs] == 2 * [(561, 561, 0.2), (128 * 561, 64, 0.2),
                                          (128 * 561, 256, 0.2), (128 * 561, 64, 0.2)] + [
        (128, 64, 0.3)]
    assert len({s[0] for s in specs}) == 9
    # one client's floats per step: 55,786,178 at full width and B = 128
    assert sum(r * w for _, r, w, _ in specs) == 55_786_178
    small = TransformerClassifier(**NARROW)
    update = local.build_local_update(
        small, "HAR", {k: torch.from_numpy(v) for k, v in _narrow_data(64).items()},
        epochs=2, batch_size=8, lr=0.004, clip_grad_norm=1.0)
    out = {}
    calls = count_mask_draws(monkeypatch, lambda: out.update(r=update(
        small.init(torch.Generator().manual_seed(0)), torch.arange(40).reshape(2, 20),
        torch.ones((2, 20), dtype=torch.bool), torch.arange(20).expand(2, 2, 20), 3)))
    assert calls == 2 * 3 and bool(out["r"][1].all())


def test_k3_rows_per_tensor_at_the_har_set():
    """The plain version of one K3 launch over the HAR set (row counts L,
    B*L and B in one launch) equals one dropout_mask call per tensor."""
    specs = TransformerClassifier(**NARROW).mask_specs([(4, L)], (0.1, 0.1, 0.3))
    keys = tfs.client_keys(9, 2, torch.arange(3))
    for got, (tensor_id, rows, width, rate) in zip(tfs.fill_masks(keys, specs), specs):
        assert got.shape == (3, rows, width)
        assert torch.equal(got, tfs.dropout_mask(keys, tensor_id, rows, width, rate))


def test_one_step_loss_and_gradient_match_jax():
    """float32: softmax cross-entropy with integer labels, masked mean."""
    params = seeded_params(TransformerClassifier(**NARROW), seed=4)
    batch = _narrow_data(16, seed=5)
    mask = (np.arange(16) < 11).astype(np.float32)
    (j_loss, j_grads), (t_loss, t_grads) = one_step_both(
        JaxHAR(**NARROW), TransformerClassifier(**NARROW), "HAR", batch, params, mask)
    assert abs(float(t_loss) - float(j_loss)) <= 1e-6
    scale = max(float(np.abs(np.asarray(g)).max()) for g in jax.tree.leaves(j_grads))
    assert max_err(t_grads, j_grads) <= 1e-5 * scale


def test_fltrust_root_update_trains_on_har_rows(monkeypatch):
    """FLTrust's root training (``build_root_update``) on HAR rows: the
    local update of one client that holds the whole root set, dropout on
    at the model's rates, one K3 draw a step."""
    model = TransformerClassifier(**NARROW)
    root = {k: torch.from_numpy(v) for k, v in _narrow_data(20, seed=3).items()}
    params = model.init(torch.Generator().manual_seed(1))
    perms = torch.stack([torch.randperm(20, generator=torch.Generator().manual_seed(e))
                         for e in range(2)])[:, None]
    kw = dict(epochs=2, batch_size=8, lr=0.004, clip_grad_norm=1.0)
    root_update = local.build_root_update(model, "HAR", root, **kw)
    out = {}
    calls = count_mask_draws(monkeypatch, lambda: out.update(p=root_update(params, perms, 5)))
    assert calls == 2 * 3
    one, ok, _ = local.build_local_update(model, "HAR", root, **kw)(
        params, torch.arange(20)[None], torch.ones((1, 20), dtype=torch.bool), perms, 5)
    assert bool(ok.all())
    for (path, a), (_, b) in zip(pt.tree_items(out["p"]), pt.tree_items(one)):
        assert torch.equal(a, b[0]), path
    assert max_err(out["p"], pt.tree_map(lambda x: x.numpy(), params)) > 1e-4


@pytest.fixture(scope="module")
def train_np():
    return _narrow_data(128, seed=1)


@pytest.fixture(scope="module")
def rounds(train_np):
    return both_rounds(JaxHAR(**NARROW), TransformerClassifier(**NARROW), train_np,
                       data_name="HAR", clients=CLIENTS, epochs=EPOCHS, batch=BATCH,
                       num_data_range=RANGE, dtype=np.float64)


def test_local_update_matches_jax(rounds, train_np):
    tp, ok, loss = port_local_update(TransformerClassifier(**NARROW), train_np, rounds,
                                     data_name="HAR", epochs=EPOCHS, batch=BATCH)
    assert bool(ok.all())
    assert max_err(tp, rounds.jax[0]) <= 2e-4
    assert abs(float(loss.mean()) - float(rounds.jax[4])) <= 1e-4


def test_round_matches_jax(rounds):
    j_stacked, j_sizes, j_gen, j_ok, j_loss = rounds.jax
    t_stacked, t_sizes, t_gen, t_ok, t_loss = rounds.port
    assert bool(j_ok) and bool(t_ok)
    np.testing.assert_array_equal(t_sizes.numpy(), np.asarray(j_sizes))
    assert abs(float(t_loss) - float(j_loss)) < 1e-4
    assert max_err(t_stacked, j_stacked) <= 2e-4 and max_err(t_gen, j_gen) <= 2e-4
    with jax.enable_x64(True):
        j_agg = pt.tree_map(np.asarray, jagg.fedavg(j_stacked, j_sizes.astype(jnp.float64)))
    t_agg = aggregators.fedavg(t_stacked, t_sizes.to(torch.float64))
    assert max_err(t_agg, j_agg) <= 2e-4
    test_np = _narrow_data(300, seed=9)
    j_acc = float(jax_evaluate_har(JaxHAR(**NARROW), pt.tree_map(np.float32, j_agg),
                                   {k: jnp.asarray(v) for k, v in test_np.items()})["accuracy"])
    t_acc = float(evaluate_har(TransformerClassifier(**NARROW),
                               pt.tree_map(lambda x: x.to(torch.float32), t_agg),
                               {k: torch.from_numpy(v) for k, v in test_np.items()})["accuracy"])
    assert round(t_acc * 300) == round(j_acc * 300)       # the same rows right


def test_evaluate_har_matches_jax():
    """Accuracy over 300 rows, evaluated in chunks of 128 by the port."""
    params = seeded_params(TransformerClassifier(**NARROW), seed=6)
    test_np = _narrow_data(300, seed=8)
    ref = jax_evaluate_har(JaxHAR(**NARROW), params,
                           {k: jnp.asarray(v) for k, v in test_np.items()})
    ours = evaluate_har(TransformerClassifier(**NARROW), pt.tree_map(torch.from_numpy, params),
                        {k: torch.from_numpy(v) for k, v in test_np.items()})
    assert TransformerClassifier.eval_chunk < 300
    # the same rows right (the means may part in the last bit)
    assert round(float(ours["accuracy"]) * 300) == round(float(ref["accuracy"]) * 300)
    assert bool(ours["ok"]) and bool(ref["ok"])


@pytest.mark.parametrize("split,size,seed", [("train", 64, 1), ("test", 40, 7)])
def test_har_arrays_byte_equal(split, size, seed):
    ours = synthetic.get_dataset("HAR", split, size, seed)
    ref = jsyn.get_dataset("HAR", split, size, seed)
    assert sorted(ours) == sorted(ref) == ["label", "x"]
    for k in ref:
        assert ours[k].dtype == ref[k].dtype and ours[k].shape == ref[k].shape, k
        assert ours[k].tobytes() == ref[k].tobytes(), k


def _write_pickle(path, rows):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with gzip.open(path, "wb") as fh:
        pickle.dump(rows, fh)


@pytest.mark.parametrize("kind", ["ICU", "HAR", "HAR (1, 561)"])
def test_reference_pickles_load_as_jax_loads_them(tmp_path, monkeypatch, kind):
    """A gzip pickle of (vitals, labs, label) or (x, label) tuples; the
    HAR x may carry torch's channel axis.  get_dataset reads the
    reference's path in preference to synthetic data."""
    rng = np.random.default_rng(3)
    if kind == "ICU":
        rows = [(rng.standard_normal(7), rng.standard_normal(16), float(i % 2)) for i in range(5)]
        path = "data/test_dataset.pkl.gz"
    else:
        shape = (561,) if kind == "HAR" else (1, 561)
        rows = [(rng.standard_normal(shape).astype(np.float32), i % 6) for i in range(5)]
        path = "data/icu_har_train_ds.pkl.gz"
    monkeypatch.chdir(tmp_path)
    _write_pickle(path, rows)
    ours = synthetic.load_reference_pickle(path)
    ref = jsyn.load_reference_pickle(path)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        assert ours[k].dtype == ref[k].dtype and ours[k].tobytes() == ref[k].tobytes(), k
    name, split = ("ICU", "test") if kind == "ICU" else ("HAR", "train")
    got = synthetic.get_dataset(name, split, 99, 0)
    assert all(got[k].tobytes() == ours[k].tobytes() for k in ours)


def test_simulator_runs_on_cpu():
    """Two FedAvg rounds at full width under xla, dropout on: every round
    ok, accuracy reported (the round metric) and finite."""
    cfg = Config(num_round=2, total_clients=2, mode="fedavg", model="TransformerClassifier",
                 data_name="HAR", num_data_range=(4, 8), epochs=1, batch_size=4,
                 train_size=64, test_size=32)
    state, history = Simulator(cfg, device="cpu").run(save_checkpoints=False, verbose=False)
    assert [h["ok"] for h in history] == [True, True]
    assert all(0.0 <= h["accuracy"] <= 1.0 and "roc_auc" not in h for h in history)
    assert all(bool(torch.isfinite(x).all()) for x in pt.tree_leaves(state["global_params"]))
