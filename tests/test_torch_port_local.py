"""The port's torch-autograd local update (``local_backend: xla``,
attackfl_tpu_torch/training/local.py) against the JAX package's
``attackfl_tpu.training.local.build_local_update`` on identical inputs.

The JAX side turns dropout off through a test-side wrapper model whose
``apply`` calls ``TransformerModel().apply(..., train=False)``; the port's
round-level wrapper ignores its masks the same way.  Data, params and the
threefry key schedule (round.py:275,278-293, local.py:139-145) are shared.

Tolerances: params 2e-4 and loss 1e-4 after two epochs of clipped Adam in
float32 summed in another order (the kernel-vs-autodiff bound of
tests/test_pallas_step.py); in the round, the tolerances of
tests/test_torch_port_round.py (genuine rows 2e-4, LIE rows 1e-5,
aggregate 2e-4, AUC 1e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_threads import one_torch_thread  # noqa: F401

from attackfl_tpu.config import AttackSpec as JaxAttackSpec
from attackfl_tpu.config import Config as JaxConfig
from attackfl_tpu.config import TelemetryConfig as JaxTelemetryConfig
from attackfl_tpu.data.partition import sample_round_indices as jax_sample_round_indices
from attackfl_tpu.data.synthetic import get_dataset as jax_get_dataset
from attackfl_tpu.eval.validation import evaluate_icu as jax_evaluate_icu
from attackfl_tpu.models.icu import TransformerModel as JaxTransformerModel
from attackfl_tpu.ops import aggregators as jagg
from attackfl_tpu.training import local as jlocal
from attackfl_tpu.training import round as jround
from attackfl_tpu_torch.config import AttackSpec, Config
from attackfl_tpu_torch.data.partition import RoundDraws
from attackfl_tpu_torch.eval.validation import evaluate_icu
from attackfl_tpu_torch.models.icu import T_BRANCH, T_HEAD, CNNModel, TransformerModel
from attackfl_tpu_torch.models.layers import Seq1Attention
from attackfl_tpu_torch.ops import aggregators, fused_step
from attackfl_tpu_torch.ops import pytree as pt
from attackfl_tpu_torch.training import local
from attackfl_tpu_torch.training import round as tround
from attackfl_tpu_torch.training.engine import Simulator
from attackfl_tpu_torch.weights import params_from_jax

C, B, EPOCHS, LO, HI, POOL = 8, 16, 2, 24, 48, 256
LR, CLIP = 0.004, 1.0


def _specs(rows, rates):
    """TransformerModel's nine mask tensors of a ``rows``-row minibatch."""
    return TransformerModel().mask_specs([(rows, 7), (rows, 16)], rates)


class JaxDropoutOff:
    """The JAX TransformerModel with dropout off: its xla loss calls
    ``apply(..., train=True, rngs=...)``, which this forwards with
    ``train=False``."""

    dropout_rate = 0.3

    def __init__(self):
        self.inner = JaxTransformerModel()

    def apply(self, variables, vitals, labs, *, train=False, rngs=None):
        return self.inner.apply(variables, vitals, labs, train=False)


class PortDropoutOff(TransformerModel):
    """The port's TransformerModel ignoring the masks it is handed."""

    def apply(self, params, vitals, labs, masks=None):
        return super().apply(params, vitals, labs)


def _as_t(x):
    return torch.from_numpy(np.array(x, dtype=np.int64))


def _jax_params(seed=3):
    return JaxTransformerModel().init(jax.random.PRNGKey(seed), jnp.zeros((1, 7)),
                                      jnp.zeros((1, 16)))["params"]


def _perms(train_keys):
    """Per-epoch permutations of jax local_update (local.py:139-142)."""
    eks = jax.vmap(lambda k: jax.random.split(k, EPOCHS))(train_keys)
    out = []
    for e in range(EPOCHS):
        k_perm = jax.vmap(lambda k: jax.random.split(k[e])[0])(eks)
        out.append(jax.vmap(lambda k: jax.random.permutation(k, HI))(k_perm))
    return _as_t(np.stack(out))


def _max_err(ours, ref, rows=None):
    ref_leaves = dict(pt.tree_items(pt.tree_map(np.asarray, ref)))
    worst = 0.0
    for path, x in pt.tree_items(ours):
        a, b = x.detach().numpy(), ref_leaves[path]
        if rows is not None:
            a, b = a[rows], b[rows]
        worst = max(worst, float(np.abs(a - b).max()))
    return worst


@pytest.fixture(scope="module")
def train_np():
    return jax_get_dataset("ICU", "train", POOL, 1)


def test_local_update_matches_jax_with_dropout_off(train_np):
    params = _jax_params()
    k_data, k_train = jax.random.split(jax.random.PRNGKey(11))
    idx, mask, _ = jax_sample_round_indices(k_data, C, POOL, LO, HI)
    train_keys = jax.random.split(k_train, C)
    jupdate = jlocal.build_local_update(
        JaxDropoutOff(), "ICU", {k: jnp.asarray(v) for k, v in train_np.items()},
        epochs=EPOCHS, batch_size=B, lr=LR, clip_grad_norm=CLIP)
    jp, jok, jloss = jax.vmap(jupdate, in_axes=(None, 0, 0, 0))(params, train_keys, idx, mask)

    tupdate = local.build_local_update(
        TransformerModel(), "ICU", {k: torch.from_numpy(v) for k, v in train_np.items()},
        epochs=EPOCHS, batch_size=B, lr=LR, clip_grad_norm=CLIP, dropout=(0.0, 0.0, 0.0))
    tp, tok, tloss = tupdate(params_from_jax(jax.tree.map(np.asarray, params)), _as_t(idx),
                             torch.from_numpy(np.array(mask)), _perms(train_keys), 0)
    assert bool(np.all(np.asarray(jok))) and bool(tok.all())
    assert _max_err(tp, jp) <= 2e-4
    np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), atol=1e-4, rtol=0)
    # the inert attention query/key leaves come back unchanged
    init = params_from_jax(jax.tree.map(np.asarray, params))
    for br in ("vitals", "labs"):
        for leaf in ("query", "key"):
            for name in ("kernel", "bias"):
                got = tp[f"{br}_transformer"]["attention"][leaf][name]
                want = init[f"{br}_transformer"]["attention"][leaf][name]
                assert torch.equal(got, want.expand_as(got))


@pytest.fixture(scope="module")
def both_rounds(train_np):
    n_att = 2
    shared = dict(total_clients=C, mode="fedavg", model="TransformerModel",
                  data_name="ICU", num_data_range=(LO, HI), epochs=EPOCHS,
                  batch_size=B, train_size=POOL, test_size=128, local_backend="xla",
                  genuine_rate=0.5)
    attack = dict(mode="LIE", num_clients=n_att, attack_round=1, args=(0.74,))
    jcfg = JaxConfig(**shared, prng_impl="threefry2x32", attacks=(JaxAttackSpec(**attack),),
                     telemetry=JaxTelemetryConfig(enabled=False))
    tcfg = Config(**shared, attacks=(AttackSpec(**attack),))
    params = _jax_params()
    jgroups, genuine = jround.build_attack_groups(jcfg)
    G = len(genuine)
    rng_np = np.random.default_rng(0)
    prev_np = jax.tree.map(lambda x: (np.asarray(x)[None] + 0.05 * rng_np.standard_normal(
        (G,) + x.shape)).astype(np.float32), params)

    rng = jax.random.key(5, impl="threefry2x32")
    step = jround.build_round_step(JaxDropoutOff(), jcfg,
                                   {k: jnp.asarray(v) for k, v in train_np.items()},
                                   jgroups, genuine)
    jout = step(params, jax.tree.map(jnp.asarray, prev_np), jnp.asarray(True), rng,
                jnp.asarray(1))

    # the draws of jax round_step (round.py:275-307) as a RoundDraws record
    k_data, k_train, k_attack = jax.random.split(rng, 3)
    idx, mask, sizes = jax_sample_round_indices(k_data, C, POOL, LO, HI)
    leak_k = max(int(jcfg.genuine_rate * G), 1)
    keys = jax.random.split(jax.random.fold_in(k_attack, 0), n_att)
    leaks = jax.vmap(lambda key: jax.random.choice(
        jax.random.split(key)[0], G, (leak_k,), replace=False))(keys)
    draws = RoundDraws(idx=_as_t(idx), mask=torch.from_numpy(np.array(mask)),
                       sizes=_as_t(sizes), perms=_perms(jax.random.split(k_train, C)),
                       dropout_seed=0, leaks=(_as_t(leaks),))

    tgroups, tgenuine = tround.build_attack_groups(tcfg)
    tstep = tround.build_round_step(PortDropoutOff(), tcfg,
                                    {k: torch.from_numpy(v) for k, v in train_np.items()},
                                    tgroups, tgenuine)
    tout = tstep(params_from_jax(jax.tree.map(np.asarray, params)), params_from_jax(prev_np),
                 True, draws, 1)
    return {"jax": jout, "port": tout, "attackers": list(jgroups[0].indices),
            "genuine": genuine}


def test_xla_round_matches_jax(both_rounds):
    j_stacked, j_sizes, j_gen, j_ok, j_loss = both_rounds["jax"]
    t_stacked, t_sizes, t_gen, t_ok, t_loss = both_rounds["port"]
    assert bool(j_ok) and bool(t_ok)
    np.testing.assert_array_equal(t_sizes.numpy(), np.asarray(j_sizes))
    assert abs(float(t_loss) - float(j_loss)) < 1e-4
    assert _max_err(t_stacked, j_stacked, both_rounds["genuine"]) <= 2e-4
    assert _max_err(t_stacked, j_stacked, both_rounds["attackers"]) <= 1e-5


def test_xla_round_aggregate_and_auc_match(both_rounds):
    j_stacked, j_sizes = both_rounds["jax"][:2]
    t_stacked, t_sizes = both_rounds["port"][:2]
    j_agg = jagg.fedavg(j_stacked, j_sizes.astype(jnp.float32))
    t_agg = aggregators.fedavg(t_stacked, t_sizes.to(torch.float32))
    assert _max_err(t_agg, j_agg) <= 2e-4
    test_np = jax_get_dataset("ICU", "test", 128, 1)
    j_auc = float(jax_evaluate_icu(JaxTransformerModel(), j_agg,
                                   {k: jnp.asarray(v) for k, v in test_np.items()})["roc_auc"])
    t_auc = float(evaluate_icu(TransformerModel(), t_agg,
                               {k: torch.from_numpy(v) for k, v in test_np.items()})["roc_auc"])
    assert np.isfinite(t_auc) and abs(t_auc - j_auc) <= 1e-3


# ---------------------------------------------------------------------------
# dropout on
# ---------------------------------------------------------------------------

def _port_update(train_np, dropout, **kw):
    data = {k: torch.from_numpy(v) for k, v in train_np.items()}
    args = dict(epochs=EPOCHS, batch_size=B, lr=LR, clip_grad_norm=CLIP)
    args.update(kw)
    return local.build_local_update(TransformerModel(), "ICU", data, dropout=dropout, **args)


def _port_inputs(n_clients=C, hi=HI, seed=0):
    rng = np.random.default_rng(seed)
    params = TransformerModel().init(torch.Generator().manual_seed(seed))
    idx = torch.from_numpy(rng.integers(0, POOL, (n_clients, hi)))
    mask = torch.ones((n_clients, hi), dtype=torch.bool)
    perms = torch.from_numpy(np.stack([[rng.permutation(hi) for _ in range(n_clients)]
                                       for _ in range(EPOCHS)]))
    return params, idx, mask, perms


def test_attention_mask_is_one_scalar_per_head():
    """The attention dropout scales each head's 16 value lanes by one
    Bernoulli scalar (JAX package layers.py:97-104), not elementwise."""
    keys = fused_step.client_keys(3, 0, torch.arange(4))
    masks = local.step_masks(keys, _specs(32, (0.5, 0.1, 0.3)))
    head_mask = masks[0]                                     # vitals' [C, B, 4]
    assert head_mask.shape == (4, 32, 4)
    assert bool((head_mask == 0).any()) and bool((head_mask == 2.0).any())
    att = Seq1Attention(64, 4)
    with torch.no_grad():
        att.value.kernel.copy_(torch.eye(64).reshape(64, 4, 16))
        att.value.bias.zero_()
        att.out.kernel.copy_(torch.eye(64).reshape(4, 16, 64))
        att.out.bias.zero_()
        x = torch.randn(32, 64, generator=torch.Generator().manual_seed(0))
        y = att(x, head_mask[1])
    lanes = (y / x).reshape(32, 4, 16)
    assert torch.equal(lanes, head_mask[1].unsqueeze(-1).expand(32, 4, 16))


def test_masks_differ_by_client_and_tensor():
    keys = fused_step.client_keys(3, 0, torch.arange(4))
    specs = _specs(32, (0.1, 0.1, 0.3))
    masks = local.step_masks(keys, specs)
    assert [tuple(m.shape) for m in masks[4:8]] == [(4, 32, 4), (4, 32, 64), (4, 32, 6),
                                                   (4, 32, 64)]
    attn_out, ffn_out, head = masks[1], masks[3], masks[8]
    assert not torch.equal(attn_out[0], attn_out[1])
    assert not torch.equal(attn_out, ffn_out)
    assert not torch.equal(attn_out, masks[5])
    assert not torch.equal(ffn_out, head)
    # the tensor ids are apart from the fused kernel's 0-8, and distinct
    assert min(T_BRANCH, T_HEAD) > fused_step.T_M4
    assert len(specs) == 9 and len({t for t, *_ in specs}) == 9


def test_dropout_changes_training_and_is_deterministic(train_np):
    params, idx, mask, perms = _port_inputs()
    on = _port_update(train_np, (0.1, 0.1, 0.3))
    off = _port_update(train_np, (0.0, 0.0, 0.0))
    p1, ok1, l1 = on(params, idx, mask, perms, 7)
    p2, ok2, l2 = on(params, idx, mask, perms, 7)
    p0, ok0, l0 = off(params, idx, mask, perms, 7)
    p3, *_ = on(params, idx, mask, perms, 8)
    assert bool(ok1.all()) and bool(ok0.all())
    assert torch.equal(l1, l2)
    for (path, a), (_, b) in zip(pt.tree_items(p1), pt.tree_items(p2)):
        assert torch.equal(a, b), path
    assert _max_err(p1, pt.tree_map(lambda x: x.numpy(), p0)) > 1e-6
    assert _max_err(p1, pt.tree_map(lambda x: x.numpy(), p3)) > 1e-6


def test_rate_zero_draws_no_mask():
    keys = fused_step.client_keys(3, 0, torch.arange(2))
    assert local.step_masks(keys, _specs(8, (0.0, 0.0, 0.0))) is None
    masks = local.step_masks(keys, _specs(8, (0.0, 0.1, 0.0)))
    assert torch.equal(masks[8], torch.ones(2, 8, 64))
    assert torch.equal(masks[4], torch.ones(2, 8, 4))


# ---------------------------------------------------------------------------
# the checks of tests/test_local_training.py, on TransformerModel
# ---------------------------------------------------------------------------

def test_local_update_reduces_loss(train_np):
    params, _, _, _ = _port_inputs()
    idx = torch.arange(128).reshape(1, 128)
    mask = torch.ones((1, 128), dtype=torch.bool)
    perms = torch.stack([torch.randperm(128, generator=torch.Generator().manual_seed(e))
                         for e in range(3)])[:, None]
    update = _port_update(train_np, (0.1, 0.1, 0.3), epochs=3, batch_size=32, lr=3e-3)
    loss_fn = local.make_loss_fn(TransformerModel(), "ICU")
    data = {k: torch.from_numpy(v)[:128] for k, v in train_np.items()}
    args = ((data["vitals"], data["labs"]), data["label"].float(), torch.ones(128), None)
    before = float(loss_fn(params, *args))
    new, ok, _ = update(params, idx, mask, perms, 2)
    after = float(loss_fn(pt.tree_take(new, 0), *args))
    assert bool(ok.all()) and after < before


def test_masked_padding_does_not_contribute(train_np):
    params, _, _, _ = _port_inputs()
    update = _port_update(train_np, (0.1, 0.1, 0.3), epochs=1, batch_size=32, lr=3e-3,
                          clip_grad_norm=0.0)
    real = torch.arange(64)
    mask = torch.cat([torch.ones(64, dtype=torch.bool), torch.zeros(32, dtype=torch.bool)])[None]
    perms = torch.randperm(96, generator=torch.Generator().manual_seed(0))[None, None]
    pa, _, _ = update(params, torch.cat([real, torch.zeros(32, dtype=torch.int64)])[None],
                      mask, perms, 3)
    pb, _, _ = update(params, torch.cat([real, torch.full((32,), 17)])[None], mask, perms, 3)
    assert _max_err(pa, pt.tree_map(lambda x: x.numpy(), pb)) <= 1e-6


def test_clients_differ(train_np):
    params, _, _, _ = _port_inputs()
    idx = torch.arange(192).reshape(3, 64)
    mask = torch.ones((3, 64), dtype=torch.bool)
    perms = torch.arange(64).expand(EPOCHS, 3, 64)
    stacked, ok, _ = _port_update(train_np, (0.1, 0.1, 0.3), epochs=1, batch_size=32)(
        params, idx, mask, perms, 0)
    assert pt.tree_leaves(stacked)[0].shape[0] == 3 and bool(ok.all())
    rows = pt.tree_ravel_stacked(stacked)
    assert float((rows[0] - rows[1]).norm()) > 1e-4


def test_nan_tripwire(train_np):
    bad = dict(train_np, vitals=np.full_like(train_np["vitals"], np.nan))
    params, idx, mask, perms = _port_inputs(n_clients=2)
    _, ok, _ = _port_update(bad, (0.1, 0.1, 0.3), epochs=1)(params, idx, mask, perms, 0)
    assert not bool(ok.any())


def test_other_models_and_data_are_refused(train_np):
    """An unknown dataset is refused; the HAR loss and a local update of
    another model than TransformerModel (both refused until ROADMAP item
    11) now build and run."""
    with pytest.raises(ValueError, match="not valid"):
        local.make_loss_fn(TransformerModel(), "MNIST")
    assert callable(local.make_loss_fn(TransformerModel(), "HAR"))
    update = local.build_local_update(
        CNNModel(), "ICU", {k: torch.from_numpy(v) for k, v in train_np.items()},
        epochs=1, batch_size=8, lr=0.1, clip_grad_norm=1.0)
    params, idx, mask, perms = _port_inputs(n_clients=2, hi=16)
    params = CNNModel().init(torch.Generator().manual_seed(0))
    stacked, ok, loss = update(params, idx, mask, perms, 0)
    assert bool(ok.all()) and bool(torch.isfinite(loss).all())
    assert pt.tree_leaves(stacked)[0].shape[0] == 2


def test_simulator_runs_xla_rounds_on_cpu():
    """The default local_backend through the engine: every round ok, AUC
    above 0.5, no K1 launch and (on the CPU) no K3 launch counted."""
    cfg = Config(num_round=2, total_clients=6, mode="fedavg", model="TransformerModel",
                 data_name="ICU", num_data_range=(24, 32), epochs=2, batch_size=16,
                 train_size=256, test_size=128,
                 attacks=(AttackSpec(mode="LIE", num_clients=2, attack_round=2),))
    assert cfg.local_backend == "xla"
    k1, k3 = fused_step.run_epoch.launches, fused_step.fill_masks.launches
    state, history = Simulator(cfg, device="cpu").run(save_checkpoints=False, verbose=False)
    assert [h["ok"] for h in history] == [True, True]
    assert history[-1]["roc_auc"] > 0.5
    assert all(bool(torch.isfinite(x).all()) for x in pt.tree_leaves(state["global_params"]))
    assert (fused_step.run_epoch.launches, fused_step.fill_masks.launches) == (k1, k3)
