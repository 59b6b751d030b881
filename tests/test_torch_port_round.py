"""One federated round through both packages on identical inputs.

The JAX side is ``attackfl_tpu.training.round.build_round_step`` with
``local_backend="pallas"`` (the fused kernel in interpret mode on the CPU,
dropout off) and threefry keys.  The port's round step, on the CPU with
dropout off by the same rule, runs on a
``RoundDraws`` record built from the same JAX key schedule
(round.py:275,278-293,307-321; fused_step.py:608-617), with the same
initial params, genuine-leak pool and data.  LIE is active (broadcast 1 >=
attack_round 1, a genuine set exists).

Tolerances: trained client params 2e-4 (two epochs of clipped Adam, the
kernel tests' bound); the LIE rows 1e-5 (statistics of the untrained leak
pool); the new genuine pool is the trained genuine rows themselves, so it
is bit-equal to the port's own rows and within the training bound, 2e-4,
of the JAX pool (measured 7.4e-5 at this size); the FedAvg aggregate
2e-4; the validation AUC 1e-3.
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
from attackfl_tpu.training import round as jround
from attackfl_tpu_torch.config import AttackSpec, Config
from attackfl_tpu_torch.data.partition import RoundDraws
from attackfl_tpu_torch.eval.validation import evaluate_icu
from attackfl_tpu_torch.models.icu import TransformerModel
from attackfl_tpu_torch.ops import aggregators
from attackfl_tpu_torch.ops import pytree as pt
from attackfl_tpu_torch.training import round as tround
from attackfl_tpu_torch.weights import params_from_jax

C, N_ATT, EPOCHS, BATCH, LO, HI = 8, 2, 2, 16, 24, 32
SHARED = dict(total_clients=C, mode="fedavg", model="TransformerModel",
              data_name="ICU", num_data_range=(LO, HI), epochs=EPOCHS,
              batch_size=BATCH, train_size=256, test_size=128,
              local_backend="pallas", genuine_rate=0.5)


def _jax_draws(rng, cfg, pool_size, groups, num_genuine, leak_k):
    """The draws of jax round_step, as a port RoundDraws record."""
    k_data, k_train, k_attack = jax.random.split(rng, 3)
    idx, mask, sizes = jax_sample_round_indices(k_data, C, pool_size, LO, HI)
    train_keys = jax.random.split(k_train, C)
    eks = jax.vmap(lambda k: jax.random.split(k, EPOCHS))(train_keys)
    perms = []
    for e in range(EPOCHS):
        k_perm = jax.vmap(lambda k: jax.random.split(k[e])[0])(eks)
        perms.append(jax.vmap(lambda k: jax.random.permutation(k, HI))(k_perm))
    leaks = []
    for gi, grp in enumerate(groups):
        keys = jax.random.split(jax.random.fold_in(k_attack, gi), len(grp.indices))
        leaks.append(jax.vmap(lambda key: jax.random.choice(
            jax.random.split(key)[0], num_genuine, (leak_k,), replace=False))(keys))
    as_t = lambda x: torch.from_numpy(np.array(x, dtype=np.int64))  # noqa: E731
    return RoundDraws(idx=as_t(idx), mask=torch.from_numpy(np.array(mask)),
                      sizes=as_t(sizes), perms=as_t(np.stack(perms)), dropout_seed=0,
                      leaks=tuple(as_t(x) for x in leaks))


@pytest.fixture(scope="module")
def both_rounds():
    attack = dict(mode="LIE", num_clients=N_ATT, attack_round=1, args=(0.74,))
    jcfg = JaxConfig(**SHARED, prng_impl="threefry2x32",
                     attacks=(JaxAttackSpec(**attack),),
                     telemetry=JaxTelemetryConfig(enabled=False))
    tcfg = Config(**SHARED, attacks=(AttackSpec(**attack),))
    train_np = jax_get_dataset("ICU", "train", 256, 1)
    test_np = jax_get_dataset("ICU", "test", 128, 1)

    jmodel = JaxTransformerModel()
    params = jmodel.init(jax.random.PRNGKey(3), jnp.zeros((1, 7)), jnp.zeros((1, 16)))["params"]
    jgroups, genuine = jround.build_attack_groups(jcfg)
    G = len(genuine)
    rng_np = np.random.default_rng(0)
    prev_np = jax.tree.map(lambda x: (np.asarray(x)[None] + 0.05 * rng_np.standard_normal(
        (G,) + x.shape)).astype(np.float32), params)

    rng = jax.random.key(5, impl="threefry2x32")
    step = jround.build_round_step(jmodel, jcfg, {k: jnp.asarray(v) for k, v in train_np.items()},
                                   jgroups, genuine)
    jout = step(params, jax.tree.map(jnp.asarray, prev_np), jnp.asarray(True), rng,
                jnp.asarray(1))
    leak_k = max(int(jcfg.genuine_rate * G), 1)
    draws = _jax_draws(rng, jcfg, 256, jgroups, G, leak_k)

    tmodel = TransformerModel()
    tgroups, tgenuine = tround.build_attack_groups(tcfg)
    assert [g.indices for g in tgroups] == [g.indices for g in jgroups] and tgenuine == genuine
    tstep = tround.build_round_step(tmodel, tcfg, {k: torch.from_numpy(v) for k, v in train_np.items()},
                                    tgroups, tgenuine)
    tout = tstep(params_from_jax(jax.tree.map(np.asarray, params)), params_from_jax(prev_np),
                 True, draws, 1)
    return {"jax": jout, "port": tout, "jmodel": jmodel, "tmodel": tmodel,
            "test": test_np, "attackers": list(jgroups[0].indices), "genuine": genuine}


def _leaves(tree):
    return dict(pt.tree_items(pt.tree_map(np.asarray, tree)))


def _max_err(ours, ref, rows=None):
    ref_leaves = _leaves(ref)
    worst = 0.0
    for path, x in pt.tree_items(ours):
        a, b = x.detach().numpy(), ref_leaves[path]
        if rows is not None:
            a, b = a[rows], b[rows]
        worst = max(worst, float(np.abs(a - b).max()))
    return worst


def test_round_flags_sizes_and_loss(both_rounds):
    j_stacked, j_sizes, j_gen, j_ok, j_loss = both_rounds["jax"]
    t_stacked, t_sizes, t_gen, t_ok, t_loss = both_rounds["port"]
    assert bool(j_ok) and bool(t_ok)
    np.testing.assert_array_equal(t_sizes.numpy(), np.asarray(j_sizes))
    assert abs(float(t_loss) - float(j_loss)) < 1e-4


def test_round_client_params_match(both_rounds):
    """Every client's trained params (genuine rows) at 2e-4, the LIE rows
    at 1e-5."""
    j_stacked, t_stacked = both_rounds["jax"][0], both_rounds["port"][0]
    assert _max_err(t_stacked, j_stacked, both_rounds["genuine"]) <= 2e-4
    assert _max_err(t_stacked, j_stacked, both_rounds["attackers"]) <= 1e-5


def test_round_genuine_pool_matches(both_rounds):
    t_stacked, t_pool = both_rounds["port"][0], both_rounds["port"][2]
    own_rows = pt.tree_take(t_stacked, torch.tensor(both_rounds["genuine"]))
    for (path, a), (_, b) in zip(pt.tree_items(t_pool), pt.tree_items(own_rows)):
        assert torch.equal(a, b), path
    assert _max_err(t_pool, both_rounds["jax"][2]) <= 2e-4


def test_round_aggregate_and_auc_match(both_rounds):
    j_stacked, j_sizes = both_rounds["jax"][:2]
    t_stacked, t_sizes = both_rounds["port"][:2]
    j_agg = jagg.fedavg(j_stacked, j_sizes.astype(jnp.float32))
    t_agg = aggregators.fedavg(t_stacked, t_sizes.to(torch.float32))
    assert _max_err(t_agg, j_agg) <= 2e-4
    test_np = both_rounds["test"]
    j_auc = float(jax_evaluate_icu(both_rounds["jmodel"], j_agg,
                                   {k: jnp.asarray(v) for k, v in test_np.items()})["roc_auc"])
    t_auc = float(evaluate_icu(both_rounds["tmodel"], t_agg,
                               {k: torch.from_numpy(v) for k, v in test_np.items()})["roc_auc"])
    assert np.isfinite(t_auc) and abs(t_auc - j_auc) <= 1e-3
