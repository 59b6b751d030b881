"""The four attacks ported after LIE (Random, Min-Max, Min-Sum, Opt-Fang),
held against the JAX package on the CPU.

Inputs are stacked models shaped like a small parameter tree (2-D
kernels, so ``matrix_spectral`` matters): shared params plus a 0.05
spread per model, made from a seed with numpy.  The γ search is compared
twice: the sequence of γ it tries (recorded on the JAX side by running
its ``lax.while_loop`` body in a Python loop) must be EQUAL, and the
returned rows within 1e-5 (measured gap at most 2.4e-7; LIE's tests use
1e-6).  The decisions are far from a tie on these inputs: the smallest
relative margin between a statistic and its threshold over every
iteration of every case is 4.1e-3 (Min-Max, n = 3, Frobenius, "mixed"
arguments), where float32 noise in the distances is ~1e-7 relative.

The rounds at the end run one round of each package on the same draws
(JAX's key schedule), as ``test_torch_port_round.py`` does, with a
Min-Max group and a Random group of attackers; tolerances are that
file's: trained rows 2e-4, attack rows 1e-5 (Random's relative, 1e-6, as
its rows are ~sigma).
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
from attackfl_tpu.models.icu import TransformerModel as JaxTransformerModel
from attackfl_tpu.ops import attacks as jatt
from attackfl_tpu.ops import pytree as jpt
from attackfl_tpu.training import round as jround
from attackfl_tpu_torch.config import AttackSpec, Config
from attackfl_tpu_torch.data.partition import RoundDraws
from attackfl_tpu_torch.models.icu import TransformerModel
from attackfl_tpu_torch.ops import attacks
from attackfl_tpu_torch.ops import pytree as pt
from attackfl_tpu_torch.training import round as tround
from attackfl_tpu_torch.weights import params_from_jax

ROW_TOL = 1e-5
SEARCHES = ("Min-Max", "Min-Sum", "Opt-Fang")
# (γ0, τ) under which each search both accepts and rejects on these inputs
MIXED_ARGS = {"Min-Max": (2.0, 0.05), "Min-Sum": (2.0, 0.05), "Opt-Fang": (0.25, 0.005)}


def _tree(n, seed=0, lead=()):
    """Stacked models: shared params plus a 0.05 spread per model."""
    rng = np.random.default_rng(seed)
    base = {"dense": {"kernel": rng.standard_normal((6, 5)), "bias": rng.standard_normal(5)},
            "head": {"kernel": rng.standard_normal((5, 3)), "bias": rng.standard_normal(3)},
            "scale": rng.standard_normal(4)}
    return pt.tree_map(lambda x: (x + 0.05 * rng.standard_normal(lead + (n,) + x.shape))
                       .astype(np.float32), base)


def _torch(tree):
    return pt.tree_map(torch.from_numpy, tree)


def _jax(tree):
    return pt.tree_map(jnp.asarray, tree)


def _max_err(ours, ref):
    ref_leaves = dict(pt.tree_items(pt.tree_map(np.asarray, ref)))
    return max(float(np.abs(x.numpy() - ref_leaves[path]).max())
               for path, x in pt.tree_items(ours))


def _jax_gammas(monkeypatch, fn):
    """Run ``fn`` with JAX's while_loop unrolled in Python, recording the
    γ of each iteration."""
    gammas = []

    def while_loop(cond, body, init):
        carry = init
        while bool(cond(carry)):
            gammas.append(np.float32(carry[0]))
            carry = body(carry)
        return carry

    monkeypatch.setattr(jax.lax, "while_loop", while_loop)
    out = fn()
    monkeypatch.undo()
    return out, gammas


@pytest.mark.parametrize("args", ["default", "mixed"])
@pytest.mark.parametrize("spectral", [False, True], ids=["frobenius", "spectral"])
@pytest.mark.parametrize("n", [2, 3, 5])
@pytest.mark.parametrize("mode", SEARCHES)
def test_gamma_search_matches_jax(monkeypatch, mode, n, spectral, args):
    """γ0 = 50 and τ = 1 (the reference's) reject every candidate on these
    inputs; the "mixed" (γ0, τ) make each search accept and reject."""
    args = () if args == "default" else MIXED_ARGS[mode]
    tree = _tree(n, seed=10 * n + SEARCHES.index(mode))
    ref = jatt.apply_attack(mode, None, _jax(tree), None, args, matrix_spectral=spectral)
    ref_loop, jax_gammas = _jax_gammas(monkeypatch, lambda: jatt.apply_attack(
        mode, None, _jax(tree), None, args, matrix_spectral=spectral))
    assert _max_err(pt.tree_map(torch.from_numpy, pt.tree_map(np.asarray, ref_loop)), ref) == 0
    trace = []
    ours = attacks.apply_attack(mode, None, _torch(tree), args, matrix_spectral=spectral,
                                trace=trace)
    assert [np.float32(g) for g, _, _ in trace] == jax_gammas
    assert len(jax_gammas) == 6
    if args:
        accepted = {bool(g2 > g1) for (g1, _, _), (g2, _, _) in zip(trace, trace[1:])}
        assert accepted == {True, False}
    assert _max_err(ours, ref) <= ROW_TOL


@pytest.mark.parametrize("spectral", [False, True], ids=["frobenius", "spectral"])
def test_distances_match_jax(spectral):
    tree = _tree(5, seed=3)
    cand = pt.tree_map(lambda x: x[0] * 1.1, tree)
    pair = pt.pairwise_ref_distance(_torch(tree), spectral).numpy()
    np.testing.assert_allclose(pair, np.asarray(jpt.pairwise_ref_distance(_jax(tree), spectral)),
                               rtol=1e-5, atol=1e-5)
    assert (np.diag(pair) == 0).all()
    np.testing.assert_allclose(
        pt.distance_to_each(_torch(cand), _torch(tree), spectral).numpy(),
        np.asarray(jpt.distance_to_each(_jax(cand), _jax(tree), spectral)), rtol=1e-5, atol=1e-5)
    assert abs(float(pt.ref_distance(_torch(cand), pt.tree_map(lambda x: x[1], _torch(tree)),
                                     spectral))
               - float(jpt.ref_distance(_jax(cand), pt.tree_map(lambda x: x[1], _jax(tree)),
                                        spectral))) <= 1e-5


@pytest.mark.parametrize("sigma", [1.0, 1e6])
def test_random_attack_with_jax_noise(sigma):
    """JAX's own noise (its per-leaf key split) through the port."""
    own = pt.tree_map(lambda x: x[0], _tree(1, seed=4))
    key = jax.random.key(9, impl="threefry2x32")
    ref = jatt.apply_attack("Random", _jax(own), None, key, (sigma,))
    leaves = jax.tree.leaves(_jax(own))
    keys = jax.random.split(key, len(leaves))
    noise = np.concatenate([np.asarray(jax.random.normal(k, x.shape, x.dtype)).reshape(-1)
                            for k, x in zip(keys, leaves)])
    z = pt.unraveler(_torch(own))(torch.from_numpy(noise)[None])
    ours = attacks.apply_attack("Random", pt.tree_broadcast(_torch(own), 1), None, (sigma,),
                                noise=z)
    ref_leaves = dict(pt.tree_items(pt.tree_map(np.asarray, ref)))
    for path, x in pt.tree_items(ours):
        np.testing.assert_allclose(x[0].numpy(), ref_leaves[path], rtol=1e-6, atol=1e-6 * sigma)


@pytest.mark.parametrize("mode", SEARCHES)
def test_one_leaked_model_falls_back_to_own_params(mode):
    own = _torch(pt.tree_map(lambda x: x[0], _tree(1, seed=5)))
    leaked = _tree(1, seed=6)
    assert attacks.apply_attack(mode, own, _torch(leaked)) is own
    ref = jatt.apply_attack(mode, "own", _jax(leaked), None)
    assert ref == "own"


@pytest.mark.parametrize("mode", SEARCHES)
def test_batched_rows_equal_rows_alone(mode):
    """One call over 4 attackers' leak stacks (dim=1) against each stack
    alone: the same γ sequence per row and the same row."""
    stacks = _torch(_tree(5, seed=7, lead=(4,)))
    trace = []
    batched = attacks.apply_attack(mode, None, stacks, dim=1, trace=trace)
    for a in range(4):
        alone_trace = []
        alone = attacks.apply_attack(mode, None, pt.tree_map(lambda x: x[a], stacks),
                                     trace=alone_trace)
        rows = [float(g[a]) for g, _, active in trace if active[a]]
        assert rows == [float(g) for g, _, _ in alone_trace]
        for (path, x), (_, y) in zip(pt.tree_items(batched), pt.tree_items(alone)):
            torch.testing.assert_close(x[a], y, rtol=0, atol=1e-6, msg=path)


def test_gamma_search_loop_length_and_immediate_stop():
    """With one γ0 and τ for all rows, every row's search takes the same
    ⌈log2(γ0/τ)⌉ iterations (|γ_succ - γ| equals the step whether a
    candidate is accepted or not), so the batched loop's freeze of a
    finished row is JAX's ``while_loop``-under-``vmap`` semantics kept as
    a guard.  A search with γ0 <= τ stops before its first iteration and
    returns mean - γ0·p, JAX's initial "last tried" γ."""
    stacks = _torch(_tree(3, seed=8, lead=(2,)))
    mean, std = pt.tree_mean(stacks, dim=1), pt.tree_std(stacks, dim=1)

    def statistic(c):
        return pt.distance_to_each(c, stacks, dim=1).amax(dim=-1)

    threshold = pt.pairwise_ref_distance(stacks, dim=1).amax(dim=(-2, -1))
    for gamma0, tau, steps in ((50.0, 1.0, 6), (50.0, 0.1, 9), (8.0, 1.0, 3)):
        trace = []
        attacks._gamma_search(stacks, std, threshold, statistic, gamma0, tau, dim=1,
                              trace=trace)
        assert len(trace) == steps and all(bool(act.all()) for _, _, act in trace)
    trace = []
    short = attacks._gamma_search(stacks, std, threshold, statistic, 0.5, 1.0, dim=1,
                                  trace=trace)
    assert not trace
    for (_, m), (_, p), (_, x) in zip(pt.tree_items(mean), pt.tree_items(std),
                                      pt.tree_items(short)):
        assert torch.equal(x, m - 0.5 * p)


# ---------------------------------------------------------------------------
# one round through both packages with Min-Max and Random attackers
# ---------------------------------------------------------------------------

C, EPOCHS, BATCH, LO, HI = 8, 1, 16, 24, 32
SHARED = dict(total_clients=C, mode="fedavg", model="TransformerModel",
              data_name="ICU", num_data_range=(LO, HI), epochs=EPOCHS,
              batch_size=BATCH, train_size=256, test_size=128,
              local_backend="pallas", genuine_rate=0.5)
GROUPS = (dict(mode="Min-Max", num_clients=2, attack_round=1, args=()),
          dict(mode="Random", num_clients=2, attack_round=1, args=(1e3,)))


def _jax_draws(rng, groups, num_genuine, leak_k, template):
    """The draws of jax round_step (round.py:275-321), as a RoundDraws:
    samples, shuffles, leaks and, for the Random group, each attacker's
    noise from its per-leaf key split (attacks.py:41-50)."""
    k_data, k_train, k_attack = jax.random.split(rng, 3)
    idx, mask, sizes = jax_sample_round_indices(k_data, C, 256, LO, HI)
    eks = jax.vmap(lambda k: jax.random.split(k, EPOCHS))(jax.random.split(k_train, C))
    perms = [jax.vmap(lambda k: jax.random.permutation(k, HI))(
        jax.vmap(lambda k: jax.random.split(k[e])[0])(eks)) for e in range(EPOCHS)]
    leaves = jax.tree.leaves(template)

    def noise_of(key):
        keys = jax.random.split(jax.random.split(key)[1], len(leaves))
        return jnp.concatenate([jax.random.normal(k, x.shape, x.dtype).reshape(-1)
                                for k, x in zip(keys, leaves)])

    leaks, noise = [], []
    for gi, grp in enumerate(groups):
        keys = jax.random.split(jax.random.fold_in(k_attack, gi), len(grp.indices))
        leaks.append(jax.vmap(lambda key: jax.random.choice(
            jax.random.split(key)[0], num_genuine, (leak_k,), replace=False))(keys))
        if grp.mode == "Random":
            noise.append(torch.from_numpy(np.array(jax.jit(jax.vmap(noise_of))(keys))))
    as_t = lambda x: torch.from_numpy(np.array(x, dtype=np.int64))  # noqa: E731
    return RoundDraws(idx=as_t(idx), mask=torch.from_numpy(np.array(mask)),
                      sizes=as_t(sizes), perms=as_t(np.stack(perms)), dropout_seed=0,
                      leaks=tuple(as_t(x) for x in leaks), noise=tuple(noise))


@pytest.fixture(scope="module")
def attack_rounds():
    jcfg = JaxConfig(**SHARED, prng_impl="threefry2x32",
                     attacks=tuple(JaxAttackSpec(**g) for g in GROUPS),
                     telemetry=JaxTelemetryConfig(enabled=False))
    tcfg = Config(**SHARED, attacks=tuple(AttackSpec(**g) for g in GROUPS))
    train_np = jax_get_dataset("ICU", "train", 256, 1)
    jmodel = JaxTransformerModel()
    params = jmodel.init(jax.random.PRNGKey(3), jnp.zeros((1, 7)), jnp.zeros((1, 16)))["params"]
    jgroups, genuine = jround.build_attack_groups(jcfg)
    G = len(genuine)
    rng_np = np.random.default_rng(0)
    prev_np = jax.tree.map(lambda x: (np.asarray(x)[None] + 0.05 * rng_np.standard_normal(
        (G,) + x.shape)).astype(np.float32), params)
    rng = jax.random.key(5, impl="threefry2x32")
    step = jax.jit(jround.build_round_step(
        jmodel, jcfg, {k: jnp.asarray(v) for k, v in train_np.items()}, jgroups, genuine))
    jout = step(params, jax.tree.map(jnp.asarray, prev_np), jnp.asarray(True), rng,
                jnp.asarray(1))
    draws = _jax_draws(rng, jgroups, G, max(int(jcfg.genuine_rate * G), 1), params)
    tgroups, tgenuine = tround.build_attack_groups(tcfg)
    assert [g.indices for g in tgroups] == [g.indices for g in jgroups] and tgenuine == genuine
    tstep = tround.build_round_step(TransformerModel(), tcfg,
                                    {k: torch.from_numpy(v) for k, v in train_np.items()},
                                    tgroups, tgenuine)
    tout = tstep(params_from_jax(jax.tree.map(np.asarray, params)), params_from_jax(prev_np),
                 True, draws, 1)
    return {"jax": jout, "port": tout, "groups": [list(g.indices) for g in jgroups],
            "genuine": genuine}


def _rows_err(ours, ref, rows, rel=False):
    ref_leaves = dict(pt.tree_items(pt.tree_map(np.asarray, ref)))
    worst = 0.0
    for path, x in pt.tree_items(ours):
        a, b = x.detach().numpy()[rows], ref_leaves[path][rows]
        err = np.abs(a - b) / (np.abs(b) + 1.0) if rel else np.abs(a - b)
        worst = max(worst, float(err.max()))
    return worst


def test_attack_round_matches_jax(attack_rounds):
    (j_stacked, j_sizes, j_gen, j_ok, j_loss) = attack_rounds["jax"]
    (t_stacked, t_sizes, t_gen, t_ok, t_loss) = attack_rounds["port"]
    assert bool(j_ok) and bool(t_ok)
    np.testing.assert_array_equal(t_sizes.numpy(), np.asarray(j_sizes))
    assert abs(float(t_loss) - float(j_loss)) < 1e-4
    min_max, random_rows = attack_rounds["groups"]
    assert _rows_err(t_stacked, j_stacked, attack_rounds["genuine"]) <= 2e-4
    assert _rows_err(t_stacked, j_stacked, min_max) <= ROW_TOL
    assert _rows_err(t_stacked, j_stacked, random_rows, rel=True) <= 1e-6
    assert _rows_err(t_gen, j_gen, slice(None)) <= 2e-4
