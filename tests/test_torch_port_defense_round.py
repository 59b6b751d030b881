"""The port's defended rounds (``training/round.build_aggregator`` and the
engine's host-side filters) against the JAX package's on the same draws,
on the CPU, at the sizes of ``test_torch_port_round.py`` (8 clients, 2 LIE
attackers, 256 train / 128 test samples).

The JAX side runs its ``xla`` round step and its ``build_aggregator``
with dropout off (a wrapper model, as in ``test_torch_port_local.py``),
under threefry keys; for gmm and fltracer its numpy filters on the JAX
rows, as its engine does (engine.py:1576-1610).  The port side is a whole
``Simulator.run_round`` (``local_backend: xla``, a model that ignores its
masks) from the same params and leak pool, handed a ``RoundDraws`` record
of the JAX key schedule, ScionFL's uniforms and FLTrust's root shuffles
included.  FLTrust trains its root set with dropout off on both sides.

Tolerances are ``test_torch_port_round.py``'s for the FedAvg aggregate,
2e-4 on the new global params, and 1e-4 on the AUC; the gmm keep mask and
the fltracer anomalies are equal.
"""

import dataclasses

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
from attackfl_tpu.ops import defenses as jdef
from attackfl_tpu.ops import pytree as jpt
from attackfl_tpu.training import round as jround
from attackfl_tpu_torch.config import AttackSpec, Config
from attackfl_tpu_torch.data.partition import RoundDraws
from attackfl_tpu_torch.ops import pytree as pt
from attackfl_tpu_torch.training import engine
from attackfl_tpu_torch.training.engine import Simulator
from attackfl_tpu_torch.weights import params_from_jax
from tests.test_torch_port_defenses import jax_root_perms
from tests.test_torch_port_local import JaxDropoutOff, PortDropoutOff

C, N_ATT, EPOCHS, BATCH, LO, HI, TEST = 8, 2, 2, 16, 24, 32, 128
RATE = 0.4
SHARED = dict(total_clients=C, model="TransformerModel", data_name="ICU",
              num_data_range=(LO, HI), epochs=EPOCHS, batch_size=BATCH, train_size=256,
              test_size=TEST, local_backend="xla", genuine_rate=0.5, trim_ratio=0.25)
ATTACK = dict(mode="LIE", num_clients=N_ATT, attack_round=1, args=(0.74,))
DEFENSES = ("median", "trimmed_mean", "krum", "shieldfl", "byzantine", "scionfl",
            "FLTrust", "gmm", "fltracer")
PARAM_TOL, AUC_TOL = 2e-4, 1e-4


def _as_t(x):
    return torch.from_numpy(np.array(x, dtype=np.int64))


def _jcfg(**kw):
    return JaxConfig(**{**SHARED, **kw}, prng_impl="threefry2x32",
                     attacks=(JaxAttackSpec(**ATTACK),),
                     telemetry=JaxTelemetryConfig(enabled=False))


def _jax_draws(rng, rate: float, num_genuine: int, leak_k: int) -> RoundDraws:
    """The draws of the JAX round step (round.py:275-321) as a RoundDraws."""
    keys = jax.random.split(rng, 4 if rate > 0 else 3)
    k_data, k_train, k_attack = keys[:3]
    idx, mask, sizes = jax_sample_round_indices(k_data, C, 256, LO, HI)
    eks = jax.vmap(lambda k: jax.random.split(k, EPOCHS))(jax.random.split(k_train, C))
    perms = [jax.vmap(lambda k: jax.random.permutation(k, HI))(
        jax.vmap(lambda k: jax.random.split(k[e])[0])(eks)) for e in range(EPOCHS)]
    att = jax.random.split(jax.random.fold_in(k_attack, 0), N_ATT)
    leaks = jax.vmap(lambda key: jax.random.choice(
        jax.random.split(key)[0], num_genuine, (leak_k,), replace=False))(att)
    kept = None
    if rate > 0:
        kept = torch.from_numpy(np.array(jax.random.bernoulli(keys[3], 1.0 - rate, (C,))))
    return RoundDraws(idx=_as_t(idx), mask=torch.from_numpy(np.array(mask)),
                      sizes=_as_t(sizes), perms=_as_t(np.stack(perms)), dropout_seed=0,
                      leaks=(_as_t(leaks),), kept=kept)


def _agg_draws(draws: RoundDraws, mode: str, k_agg, num_params: int) -> RoundDraws:
    """ScionFL's uniforms (those behind ``jax.random.bernoulli`` under
    ``split(k_agg, C)``) and FLTrust's root shuffles (``k_agg``'s epoch
    schedule, local.py:139-142) on top of ``draws``."""
    extra = {}
    if mode == "scionfl":
        keys = jax.random.split(k_agg, C)
        extra["uniform"] = torch.from_numpy(np.array(
            jax.vmap(lambda k: jax.random.uniform(k, (num_params,)))(keys)))
    if mode == "FLTrust":
        extra["root_perms"] = jax_root_perms(k_agg, EPOCHS, TEST)
    return dataclasses.replace(draws, **extra)


def _round(rate: float, key: int):
    """One JAX round step (dropout off) and its draws."""
    jcfg = _jcfg(mode="fedavg", client_dropout_rate=rate)
    train_np = jax_get_dataset("ICU", "train", 256, 1)
    jmodel = JaxTransformerModel()
    params = jmodel.init(jax.random.PRNGKey(3), jnp.zeros((1, 7)), jnp.zeros((1, 16)))["params"]
    groups, genuine = jround.build_attack_groups(jcfg)
    G = len(genuine)
    rng_np = np.random.default_rng(0)
    prev_np = jax.tree.map(lambda x: (np.asarray(x)[None] + 0.05 * rng_np.standard_normal(
        (G,) + x.shape)).astype(np.float32), params)
    rng = jax.random.key(key, impl="threefry2x32")
    step = jax.jit(jround.build_round_step(
        JaxDropoutOff(), jcfg, {k: jnp.asarray(v) for k, v in train_np.items()}, groups,
        genuine))
    stacked, sizes, _, ok, _ = step(params, jax.tree.map(jnp.asarray, prev_np),
                                    jnp.asarray(True), rng, jnp.asarray(1))
    assert bool(ok)
    return {"params": params, "prev": prev_np, "stacked": stacked, "sizes": sizes,
            "draws": _jax_draws(rng, rate, G, max(int(jcfg.genuine_rate * G), 1)),
            "attackers": list(groups[0].indices), "k_agg": jax.random.key(9, impl="threefry2x32"),
            "test": jax_get_dataset("ICU", "test", TEST, 1)}


@pytest.fixture(scope="module")
def plain_round():
    return _round(0.0, 5)


@pytest.fixture(scope="module")
def straggler_round():
    out = _round(RATE, 3)
    kept = out["draws"].kept.numpy()
    assert 0 < kept.sum() < C
    return out


def _port_sim(monkeypatch, mode: str, rate: float = 0.0) -> Simulator:
    monkeypatch.setattr(engine, "get_model", lambda name: PortDropoutOff())
    return Simulator(Config(**SHARED, mode=mode, client_dropout_rate=rate,
                            attacks=(AttackSpec(**ATTACK),)), device="cpu")


def _port_round(sim: Simulator, rnd: dict, mode: str):
    """``run_round`` from the JAX round's params and leak pool on its draws."""
    draws = _agg_draws(rnd["draws"], mode, rnd["k_agg"], sim.num_params)
    sim.draw_round = lambda gen: draws
    state = sim.init_state()
    state.update(global_params=params_from_jax(jax.tree.map(np.asarray, rnd["params"])),
                 prev_genuine=params_from_jax(rnd["prev"]), have_genuine=True)
    return state, *sim.run_round(state)


def _jax_aggregate(rnd: dict, mode: str, rate: float = 0.0):
    """The JAX engine's defense and aggregate on the JAX rows; returns the
    new params, the host filter's keep mask (None for device modes) and
    the fltracer anomalies."""
    stacked, sizes = rnd["stacked"], rnd["sizes"]
    weights = np.ones(C, np.float32)
    keep = anomalies = None
    if mode in ("gmm", "fltracer"):
        flat = np.asarray(jpt.tree_ravel_stacked(stacked))
        attackers = np.zeros(C, bool)
        attackers[rnd["attackers"]] = True
        if mode == "gmm":
            keep = jdef.gmm_filter(flat, attackers, seed=1)
        else:
            anomalies = jdef.fltracer_anomalies(flat)
            keep = np.ones(C, bool)
            keep[anomalies] = False
        weights = keep.astype(np.float32)
    weights_mask = jnp.asarray(weights) * (sizes > 0)
    aggregate = jround.build_aggregator(JaxDropoutOff(), _jcfg(mode=mode, client_dropout_rate=rate),
                                        rnd["test"])
    new = aggregate(rnd["params"], stacked, sizes, weights_mask, rnd["k_agg"])
    return new, keep, anomalies


def _max_err(ours, ref) -> float:
    ref_leaves = dict(pt.tree_items(pt.tree_map(np.asarray, ref)))
    return max(float(np.abs(x.numpy() - ref_leaves[path]).max())
               for path, x in pt.tree_items(ours))


def _jax_auc(rnd: dict, params) -> float:
    return float(jax_evaluate_icu(JaxTransformerModel(), params,
                                  {k: jnp.asarray(v) for k, v in rnd["test"].items()})["roc_auc"])


@pytest.mark.parametrize("mode", DEFENSES)
def test_defended_round_matches_jax(monkeypatch, plain_round, mode):
    sim = _port_sim(monkeypatch, mode)
    _, new, metrics = _port_round(sim, plain_round, mode)
    want, keep, anomalies = _jax_aggregate(plain_round, mode)
    assert metrics["ok"] and new["completed_rounds"] == 1
    assert _max_err(new["global_params"], want) <= PARAM_TOL
    assert abs(metrics["roc_auc"] - _jax_auc(plain_round, want)) <= AUC_TOL
    if mode == "gmm":
        assert metrics["gmm_kept"] == int(keep.sum())
    if mode == "fltracer":
        assert metrics["fltracer_anomalies"] == anomalies.tolist()


@pytest.mark.parametrize("mode", ["median", "krum"])
def test_straggler_round_under_geometric_defense(monkeypatch, straggler_round, mode):
    """With stragglers median and Krum run over the reporting clients
    (``geo_mask``), in both packages."""
    sim = _port_sim(monkeypatch, mode, RATE)
    _, new, metrics = _port_round(sim, straggler_round, mode)
    want, _, _ = _jax_aggregate(straggler_round, mode, RATE)
    assert metrics["ok"]
    assert _max_err(new["global_params"], want) <= PARAM_TOL
    assert abs(metrics["roc_auc"] - _jax_auc(straggler_round, want)) <= AUC_TOL
    # without the mask the dropped rows would vote: the aggregate differs
    unmasked = jround.build_aggregator(JaxDropoutOff(), _jcfg(mode=mode), None)(
        straggler_round["params"], straggler_round["stacked"], straggler_round["sizes"],
        jnp.ones(C), straggler_round["k_agg"])
    assert _max_err(new["global_params"], unmasked) > PARAM_TOL


def _assert_failed(state, new, metrics):
    assert not metrics["ok"] and new["completed_rounds"] == 0 and new["broadcasts"] == 1
    for a, b in zip(pt.tree_leaves(new["global_params"]), pt.tree_leaves(state["global_params"])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["gmm", "fltracer"])
def test_round_fails_when_the_host_filter_keeps_nobody(monkeypatch, plain_round, mode):
    sim = _port_sim(monkeypatch, mode)
    monkeypatch.setattr(engine.defenses, "gmm_filter", lambda flat, *a, **k: np.zeros(C, bool))
    monkeypatch.setattr(engine.defenses, "fltracer_anomalies", lambda flat: np.arange(C))
    _assert_failed(*_port_round(sim, plain_round, mode))


def test_round_fails_when_the_filter_keeps_only_dropped_clients(monkeypatch, straggler_round):
    """The defense mask meets the reporting clients: a gmm filter that keeps
    only stragglers leaves no weight, and the round fails (JAX
    engine.py:1606-1610)."""
    sim = _port_sim(monkeypatch, "gmm", RATE)
    dropped = ~straggler_round["draws"].kept.numpy()
    monkeypatch.setattr(engine.defenses, "gmm_filter", lambda flat, *a, **k: dropped.copy())
    _assert_failed(*_port_round(sim, straggler_round, "gmm"))


def test_defense_draws_come_last_and_only_when_asked():
    """fedavg draws what the earlier slices drew; ScionFL adds a (C, P)
    uniform draw and FLTrust its root shuffles and seed, after every other
    draw."""
    draws = {}
    for mode in ("fedavg", "scionfl", "FLTrust"):
        sim = Simulator(Config(**SHARED, mode=mode, attacks=(AttackSpec(**ATTACK),)),
                        device="cpu")
        draws[mode] = sim.draw_round(torch.Generator().manual_seed(0))
    base = draws["fedavg"]
    assert base.uniform is None and base.root_perms is None and base.root_seed == 0
    for mode in ("scionfl", "FLTrust"):
        d = draws[mode]
        for name in ("idx", "mask", "sizes", "perms"):
            assert torch.equal(getattr(d, name), getattr(base, name))
        assert d.dropout_seed == base.dropout_seed and torch.equal(d.leaks[0], base.leaks[0])
    assert draws["scionfl"].uniform.shape == (C, sim.num_params)
    assert draws["scionfl"].root_perms is None
    perms = draws["FLTrust"].root_perms
    assert perms.shape == (EPOCHS, 1, TEST) and draws["FLTrust"].uniform is None
    assert all(torch.equal(torch.sort(p[0]).values, torch.arange(TEST)) for p in perms)

