"""Stragglers and the Dirichlet split of the port, held against the JAX
package on the CPU at a small size (C = 8, the widths of
``test_torch_port_round.py``).

The Dirichlet pools are numpy in both packages and must be byte-equal.
The round runs each package on the same draws: JAX's four-way key split
(round.py:275-290), its Dirichlet pools and its ``bernoulli`` kept bits,
through the JAX ``pallas`` path in interpret mode (dropout off), as
``test_torch_port_round.py`` does.  Tolerances are that file's: trained
rows 2e-4, LIE rows 1e-5, the mean loss 1e-4.  A dropped client's row,
and under ``xla`` too, is the broadcast params bit for bit.
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
from attackfl_tpu.data.partition import dirichlet_label_partition as jax_dirichlet
from attackfl_tpu.data.partition import sample_round_indices as jax_sample_round_indices
from attackfl_tpu.data.synthetic import get_dataset as jax_get_dataset
from attackfl_tpu.models.icu import TransformerModel as JaxTransformerModel
from attackfl_tpu.training import round as jround
from attackfl_tpu_torch.config import AttackSpec, Config
from attackfl_tpu_torch.data.partition import (
    RoundDraws, dirichlet_label_partition, draw_round,
)
from attackfl_tpu_torch.models.icu import TransformerModel
from attackfl_tpu_torch.ops import pytree as pt
from attackfl_tpu_torch.training import round as tround
from attackfl_tpu_torch.training.engine import Simulator
from attackfl_tpu_torch.weights import params_from_jax

C, N_ATT, EPOCHS, BATCH, LO, HI = 8, 2, 2, 16, 24, 32
RATE = 0.4
SHARED = dict(total_clients=C, mode="fedavg", model="TransformerModel",
              data_name="ICU", num_data_range=(LO, HI), epochs=EPOCHS,
              batch_size=BATCH, train_size=256, test_size=128,
              local_backend="pallas", genuine_rate=0.5, client_dropout_rate=RATE,
              partition="dirichlet")
ATTACK = dict(mode="LIE", num_clients=N_ATT, attack_round=1, args=(0.74,))


@pytest.mark.parametrize("alpha", [0.1, 0.5])
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_dirichlet_pools_are_byte_equal(seed, alpha):
    labels = jax_get_dataset("ICU", "train", 2000, 1)["label"]
    ours = dirichlet_label_partition(labels, 20, alpha, seed=seed)
    ref = jax_dirichlet(labels, 20, alpha, seed=seed)
    assert ours.dtype == ref.dtype and ours.tobytes() == ref.tobytes()


def _jax_draws(rng, pools, groups, num_genuine, leak_k):
    """The draws of jax round_step with stragglers, as a RoundDraws."""
    k_data, k_train, k_attack, k_drop = jax.random.split(rng, 4)
    idx, mask, sizes = jax_sample_round_indices(k_data, C, 256, LO, HI, pools)
    kept = jax.random.bernoulli(k_drop, 1.0 - RATE, (C,))
    eks = jax.vmap(lambda k: jax.random.split(k, EPOCHS))(jax.random.split(k_train, C))
    perms = [jax.vmap(lambda k: jax.random.permutation(k, HI))(
        jax.vmap(lambda k: jax.random.split(k[e])[0])(eks)) for e in range(EPOCHS)]
    leaks = []
    for gi, grp in enumerate(groups):
        keys = jax.random.split(jax.random.fold_in(k_attack, gi), len(grp.indices))
        leaks.append(jax.vmap(lambda key: jax.random.choice(
            jax.random.split(key)[0], num_genuine, (leak_k,), replace=False))(keys))
    as_t = lambda x: torch.from_numpy(np.array(x, dtype=np.int64))  # noqa: E731
    return RoundDraws(idx=as_t(idx), mask=torch.from_numpy(np.array(mask)),
                      sizes=as_t(sizes), perms=as_t(np.stack(perms)), dropout_seed=0,
                      leaks=tuple(as_t(x) for x in leaks),
                      kept=torch.from_numpy(np.array(kept)))


@pytest.fixture(scope="module")
def straggler_round():
    jcfg = JaxConfig(**SHARED, prng_impl="threefry2x32", attacks=(JaxAttackSpec(**ATTACK),),
                     telemetry=JaxTelemetryConfig(enabled=False))
    tcfg = Config(**SHARED, attacks=(AttackSpec(**ATTACK),))
    train_np = jax_get_dataset("ICU", "train", 256, 1)
    pools = jax_dirichlet(train_np["label"], C, jcfg.dirichlet_alpha, seed=jcfg.random_seed)
    jmodel = JaxTransformerModel()
    params = jmodel.init(jax.random.PRNGKey(3), jnp.zeros((1, 7)), jnp.zeros((1, 16)))["params"]
    jgroups, genuine = jround.build_attack_groups(jcfg)
    G = len(genuine)
    rng_np = np.random.default_rng(0)
    prev_np = jax.tree.map(lambda x: (np.asarray(x)[None] + 0.05 * rng_np.standard_normal(
        (G,) + x.shape)).astype(np.float32), params)
    # key 3 drops one attacker and some genuine clients (asserted below)
    rng = jax.random.key(3, impl="threefry2x32")
    step = jax.jit(jround.build_round_step(
        jmodel, jcfg, {k: jnp.asarray(v) for k, v in train_np.items()}, jgroups, genuine,
        client_pools=jnp.asarray(pools)))
    jout = step(params, jax.tree.map(jnp.asarray, prev_np), jnp.asarray(True), rng,
                jnp.asarray(1))
    draws = _jax_draws(rng, jnp.asarray(pools), jgroups, G, max(int(jcfg.genuine_rate * G), 1))
    tgroups, tgenuine = tround.build_attack_groups(tcfg)
    assert [g.indices for g in tgroups] == [g.indices for g in jgroups] and tgenuine == genuine
    tstep = tround.build_round_step(TransformerModel(), tcfg,
                                    {k: torch.from_numpy(v) for k, v in train_np.items()},
                                    tgroups, tgenuine)
    tparams, tprev = params_from_jax(jax.tree.map(np.asarray, params)), params_from_jax(prev_np)
    kept = draws.kept.numpy()
    attackers = list(jgroups[0].indices)
    # the draw must hold a dropped attacker, a dropped genuine client and kept ones
    assert not kept[attackers].all() and kept[attackers].any()
    assert not kept[genuine].all() and kept[genuine].any()
    return {"jax": jout, "port": tstep(tparams, tprev, True, draws, 1), "step": tstep,
            "draws": draws, "params": tparams, "prev": tprev, "kept": kept,
            "attackers": attackers, "genuine": genuine}


def _rows_err(ours, ref, rows):
    ref_leaves = dict(pt.tree_items(pt.tree_map(np.asarray, ref)))
    return max(float(np.abs(x.detach().numpy()[rows] - ref_leaves[path][rows]).max())
               for path, x in pt.tree_items(ours))


def _rows_equal(stacked, tree, rows):
    """Each of ``rows`` of ``stacked`` equals the unstacked ``tree``."""
    return all(torch.equal(x[r], y) for (_, x), (_, y) in
               zip(pt.tree_items(stacked), pt.tree_items(tree)) for r in rows)


def test_straggler_round_sizes_flags_and_loss(straggler_round):
    j_stacked, j_sizes, j_gen, j_ok, j_loss = straggler_round["jax"]
    t_stacked, t_sizes, t_gen, t_ok, t_loss = straggler_round["port"]
    assert bool(j_ok) and bool(t_ok)
    np.testing.assert_array_equal(t_sizes.numpy(), np.asarray(j_sizes))
    assert (t_sizes.numpy()[~straggler_round["kept"]] == 0).all()
    # the JAX loss is the mean over kept clients (round.py:378-379)
    assert abs(float(t_loss) - float(j_loss)) < 1e-4


def test_straggler_round_rows(straggler_round):
    """Dropped rows are the broadcast params bit for bit; kept trained
    rows within 2e-4 and kept attacker rows within 1e-5 of JAX."""
    j_stacked, t_stacked = straggler_round["jax"][0], straggler_round["port"][0]
    kept = straggler_round["kept"]
    dropped = [c for c in range(C) if not kept[c]]
    assert _rows_equal(t_stacked, straggler_round["params"], dropped)
    assert _rows_err(t_stacked, j_stacked, dropped) == 0.0
    genuine_kept = [c for c in straggler_round["genuine"] if kept[c]]
    attackers_kept = [c for c in straggler_round["attackers"] if kept[c]]
    assert _rows_err(t_stacked, j_stacked, genuine_kept) <= 2e-4
    assert _rows_err(t_stacked, j_stacked, attackers_kept) <= 1e-5


def test_straggler_round_stale_leak_pool(straggler_round):
    """A dropped genuine client keeps its previous leak-pool row; a kept
    one takes its new row."""
    t_stacked, t_pool = straggler_round["port"][0], straggler_round["port"][2]
    kept, genuine = straggler_round["kept"], straggler_round["genuine"]
    for g, c in enumerate(genuine):
        src, row = (t_stacked, c) if kept[c] else (straggler_round["prev"], g)
        for (path, a), (_, b) in zip(pt.tree_items(t_pool), pt.tree_items(src)):
            assert torch.equal(a[g], b[row]), (c, path)
    assert _rows_err(t_pool, straggler_round["jax"][2], slice(None)) <= 2e-4


def test_straggler_round_before_any_report(straggler_round):
    """Before the pool exists, a dropped genuine client's fresh no-op row
    (the broadcast params) goes in, not the placeholder."""
    out = straggler_round["step"](straggler_round["params"], straggler_round["prev"], False,
                                  straggler_round["draws"], 1)
    kept, genuine = straggler_round["kept"], straggler_round["genuine"]
    dropped = [g for g, c in enumerate(genuine) if not kept[c]]
    assert bool(out[3]) and _rows_equal(out[2], straggler_round["params"], dropped)


def test_round_where_every_client_drops_fails(straggler_round):
    draws = straggler_round["draws"]
    none_kept = RoundDraws(**{**draws.__dict__, "kept": torch.zeros(C, dtype=torch.bool)})
    out = straggler_round["step"](straggler_round["params"], straggler_round["prev"], True,
                                  none_kept, 1)
    assert not bool(out[3]) and int(out[1].sum()) == 0
    # a failed round leaves the leak pool as it was
    assert all(torch.equal(a, b) for a, b in zip(pt.tree_leaves(out[2]),
                                                 pt.tree_leaves(straggler_round["prev"])))


def test_xla_dropped_client_is_an_exact_noop(straggler_round):
    """Under ``xla`` (torch autograd, dropout on) a fully masked client's
    gradient is exactly 0, so Adam leaves its row bit-equal."""
    tcfg = Config(**{**SHARED, "local_backend": "xla"}, attacks=(AttackSpec(**ATTACK),))
    groups, genuine = tround.build_attack_groups(tcfg)
    train_np = jax_get_dataset("ICU", "train", 256, 1)
    step = tround.build_round_step(TransformerModel(), tcfg,
                                   {k: torch.from_numpy(v) for k, v in train_np.items()},
                                   groups, genuine)
    out = step(straggler_round["params"], straggler_round["prev"], True,
               straggler_round["draws"], 1)
    kept = straggler_round["kept"]
    assert bool(out[3])
    assert _rows_equal(out[0], straggler_round["params"], [c for c in range(C) if not kept[c]])
    assert not _rows_equal(out[0], straggler_round["params"], [c for c in range(C) if kept[c]])


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_simulator_runs_config3_and_stragglers(tmp_path, backend):
    """The Dirichlet split and stragglers through the engine: every round
    ok, finite params, a drawn ``kept`` only where stragglers are on."""
    for extra in ({"partition": "dirichlet"}, {"client_dropout_rate": 0.3}):
        cfg = Config(**{**SHARED, "partition": "iid", "client_dropout_rate": 0.0, **extra,
                        "local_backend": backend, "num_round": 2,
                        "checkpoint_dir": str(tmp_path)})
        sim = Simulator(cfg, device="cpu")
        assert (sim.draw_round(torch.Generator().manual_seed(0)).kept is None) == (
            cfg.client_dropout_rate == 0.0)
        state, history = sim.run(save_checkpoints=False, verbose=False)
        assert [h["ok"] for h in history] == [True, True]
        assert all(bool(torch.isfinite(x).all()) for x in pt.tree_leaves(state["global_params"]))


def test_draws_without_stragglers_or_random_are_unchanged():
    """No stragglers and no Random group: the generator is left exactly
    where the draws of the earlier slices left it."""
    kw = dict(num_clients=6, pool_size=50, lo=3, hi=9, epochs=2, num_genuine=4,
              leak_groups=[2], leak_k=3)
    g1, g2 = torch.Generator().manual_seed(0), torch.Generator().manual_seed(0)
    plain = draw_round(g1, **kw)
    with_pools = draw_round(g2, **kw, client_pools=torch.arange(50).reshape(5, 10).repeat(2, 1)[:6])
    assert plain.kept is None and plain.noise == ()
    assert torch.equal(g1.get_state(), g2.get_state())
    assert torch.equal(plain.sizes, with_pools.sizes)
    g3 = torch.Generator().manual_seed(0)
    more = draw_round(g3, **kw, dropout_rate=0.5, noise_groups=[2], num_params=11)
    for name in ("idx", "sizes", "perms"):
        assert torch.equal(getattr(more, name), getattr(plain, name))
    assert more.dropout_seed == plain.dropout_seed and torch.equal(more.leaks[0], plain.leaks[0])
    assert more.kept.shape == (6,) and more.noise[0].shape == (2, 11)
