"""The port's sharded round against the JAX package's on its 8-device
virtual CPU mesh (``tests/conftest.py``): the slice as a whole and the
per-defense sharded aggregation (``attackfl_tpu_torch/parallel/shard.py``).

1. One sharded round at JAX's own test configuration
   (``tests/test_sharding.py:24-27, 51-89``: CNNModel on ICU, 8 clients,
   2 LIE attackers, a seeded leak pool, broadcast 1 attacking) through
   the JAX package's mesh round, on the mesh and under the strategy its
   ``Simulator(cfg, use_mesh=True)`` picks, and through the port's round
   over 8 ``cpu`` shards under the strategy the port's Simulator picks:
   ``rbg`` (gspmd: the local update per shard, the unchanged aggregator)
   and ``threefry2x32`` (shard_map: the psum'd mean).  The port gets
   JAX's draws through the harness of ``tests/_torch_port_models.py``
   (the same key schedule; dropout off in both packages) and both run in
   float64, as the CNN suite runs its round
   (``tests/test_torch_port_models_cnn.py``: float32 cold starts part the
   packages).  Against JAX's mesh round, the tolerances of
   ``tests/test_torch_port_round.py``: trained rows 2e-4, LIE rows 1e-5,
   the aggregate 2e-4, the AUC 1e-3; against the port's own meshless
   round, the aggregate within 1e-5, JAX's bound for sharded against
   replicated.
2. Every mode of ``PSUM_MODES | GATHER_MODES`` on 16 clients over 8
   shards (TransformerModel rows, float32): the gather modes bit-identical
   to the port's meshless aggregator; the psum modes within 2e-6 of it
   and within 2e-6 of JAX's ``shard_aggregator`` on JAX's mesh (FLTrust's
   combine half on the same deltas and root delta: its root pass is
   replicated and draws the port's own keys).  JAX's psum modes divide
   after the psum, the port's before it (so that one shard gives the
   meshless bits): one rounding apart.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_models import (
    JaxDropoutOff, as_dtype, as_t, dropout_off, jax_perms, max_err, seeded_params,
)
from _torch_port_threads import one_torch_thread  # noqa: F401

from attackfl_tpu.config import AttackSpec as JaxAttackSpec
from attackfl_tpu.config import Config as JaxConfig
from attackfl_tpu.config import TelemetryConfig as JaxTelemetryConfig
from attackfl_tpu.data.partition import sample_round_indices as jax_sample_round_indices
from attackfl_tpu.data.synthetic import get_dataset as jax_get_dataset
from attackfl_tpu.eval.validation import evaluate_icu as jax_evaluate_icu
from attackfl_tpu.models.icu import CNNModel as JaxCNN
from attackfl_tpu.parallel.mesh import make_constrain as jax_make_constrain
from attackfl_tpu.parallel.shard import shard_aggregator as jax_shard_aggregator
from attackfl_tpu.training import round as jround
from attackfl_tpu.training.engine import Simulator as JaxSimulator
from attackfl_tpu_torch.config import AttackSpec, Config, TelemetryConfig
from attackfl_tpu_torch.data.partition import RoundDraws
from attackfl_tpu_torch.eval.validation import evaluate_icu
from attackfl_tpu_torch.models.icu import CNNModel, TransformerModel
from attackfl_tpu_torch.ops import aggregators
from attackfl_tpu_torch.ops import pytree as pt
from attackfl_tpu_torch.parallel.mesh import make_client_mesh
from attackfl_tpu_torch.parallel.shard import GATHER_MODES, PSUM_MODES, shard_aggregator
from attackfl_tpu_torch.training import round as tround
from attackfl_tpu_torch.training.engine import Simulator

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs the 8-device virtual CPU mesh")

C, EPOCHS, BATCH, LO, HI = 8, 1, 16, 32, 48
BASE = dict(total_clients=C, mode="fedavg", model="CNNModel", data_name="ICU",
            num_data_range=(LO, HI), epochs=EPOCHS, batch_size=BATCH, train_size=128,
            test_size=64, local_backend="xla", genuine_rate=0.5, log_path=".",
            checkpoint_dir=".")
ATTACK = dict(mode="LIE", num_clients=2, attack_round=1, args=(0.74,))


def _port_mesh(n: int = 8):
    return make_client_mesh(devices=["cpu"] * n)


def _draws(rng, train_np, groups, num_genuine: int, leak_k: int, clients: int = C,
           num_data_range: tuple[int, int] = (LO, HI), epochs: int = EPOCHS) -> RoundDraws:
    """JAX round_step's draws (round.py:275-321) as a port RoundDraws, at
    this file's geometry unless another is given."""
    lo, hi = num_data_range
    k_data, k_train, k_attack = jax.random.split(rng, 3)
    idx, mask, sizes = jax_sample_round_indices(k_data, clients, len(train_np["label"]), lo, hi)
    leaks = []
    for gi, grp in enumerate(groups):
        keys = jax.random.split(jax.random.fold_in(k_attack, gi), len(grp.indices))
        leaks.append(as_t(jax.vmap(lambda key: jax.random.choice(
            jax.random.split(key)[0], num_genuine, (leak_k,), replace=False))(keys)))
    return RoundDraws(idx=as_t(idx), mask=torch.from_numpy(np.array(mask)), sizes=as_t(sizes),
                      perms=jax_perms(jax.random.split(k_train, clients), epochs, hi),
                      dropout_seed=0, leaks=tuple(leaks))


def _mesh_round(prng: str) -> dict:
    """Both packages' sharded round in float64, and the port's meshless one."""
    jcfg = JaxConfig(**BASE, prng_impl=prng, attacks=(JaxAttackSpec(**ATTACK),),
                     telemetry=JaxTelemetryConfig(enabled=False))
    tcfg = Config(**BASE, prng_impl=prng, attacks=(AttackSpec(**ATTACK),),
                  telemetry=TelemetryConfig(enabled=False))
    jsim = JaxSimulator(jcfg, use_mesh=True)
    assert jsim.mesh is not None and jsim.mesh.size == 8
    strategy = jsim.mesh_strategy
    mesh = _port_mesh()
    psim = Simulator(tcfg, device="cpu", mesh=mesh)
    assert psim.mesh_strategy == strategy
    psim.close()
    sharded_agg = strategy == "shard_map"

    train_np = as_dtype(jax_get_dataset("ICU", "train", 128, 1), np.float64)
    test_np = jax_get_dataset("ICU", "test", 256, 1)
    params = as_dtype(seeded_params(CNNModel(), 0), np.float64)
    groups, genuine = jround.build_attack_groups(jcfg)
    G = len(genuine)
    noise = np.random.default_rng(1)
    prev = pt.tree_map(lambda x: x[None] + 0.05 * noise.standard_normal((G,) + x.shape), params)
    rng = jax.random.key(5, impl=prng)
    train_j = {k: jnp.asarray(v) for k, v in train_np.items()}
    jmodel = JaxDropoutOff(JaxCNN())
    step = jax.jit(jround.build_round_step(
        jmodel, jcfg, train_j, groups, genuine, None, jax_make_constrain(jsim.mesh),
        mesh=jsim.mesh, use_shard_map=sharded_agg))
    jout = step(params, pt.tree_map(jnp.asarray, prev), jnp.asarray(True), rng, jnp.asarray(1))
    jaggregate = jax.jit(jround.build_aggregator(
        jmodel, jcfg, test_np, mesh=jsim.mesh if sharded_agg else None))
    j_stacked, j_sizes = jout[:2]
    j_new = jaggregate(params, j_stacked, j_sizes, jnp.ones((C,), jnp.float64),
                       jax.random.key(0, impl=prng))
    draws = _draws(rng, train_np, groups, G, max(int(jcfg.genuine_rate * G), 1))

    tgroups, tgenuine = tround.build_attack_groups(tcfg)
    assert [g.indices for g in tgroups] == [g.indices for g in groups] and tgenuine == genuine
    train_t = {k: torch.from_numpy(v) for k, v in train_np.items()}
    to_port = lambda tree: pt.tree_map(torch.from_numpy, tree)  # noqa: E731
    out = {"jax": jout, "jax_new": pt.tree_map(np.asarray, j_new), "params": params,
           "test": test_np, "attackers": list(groups[0].indices), "genuine": list(genuine)}
    for label, round_mesh in (("port", mesh), ("meshless", None)):
        model = dropout_off(CNNModel())
        step = tround.build_round_step(model, tcfg, train_t, tgroups, tgenuine,
                                       mesh=round_mesh)
        aggregate = tround.build_aggregator(
            model, tcfg, None, mesh=round_mesh if sharded_agg else None)
        stacked, sizes, new_genuine, ok, loss = step(to_port(params), to_port(prev), True,
                                                     draws, 1)
        new = aggregate(to_port(params), stacked, sizes,
                        torch.ones(C, dtype=torch.float64), draws)
        out[label] = (stacked, sizes, new_genuine, ok, loss)
        out[f"{label}_new"] = new
    return out


@pytest.fixture(scope="module", params=["rbg", "threefry2x32"])
def mesh_round(request):
    with jax.enable_x64(True):
        return _mesh_round(request.param)


def test_sharded_round_matches_jaxs_mesh_round(mesh_round):
    j_stacked, j_sizes, j_gen, j_ok, j_loss = mesh_round["jax"]
    t_stacked, t_sizes, t_gen, t_ok, t_loss = mesh_round["port"]
    assert bool(j_ok) and bool(t_ok)
    np.testing.assert_array_equal(t_sizes.numpy(), np.asarray(j_sizes))
    assert abs(float(t_loss) - float(j_loss)) < 1e-4
    assert max_err(t_stacked, j_stacked, mesh_round["genuine"]) <= 2e-4
    assert max_err(t_stacked, j_stacked, mesh_round["attackers"]) <= 1e-5
    assert max_err(t_gen, j_gen) <= 2e-4
    assert max_err(mesh_round["port_new"], mesh_round["jax_new"]) <= 2e-4
    # validation in float32, as the engine runs it
    test_np = mesh_round["test"]
    j_auc = float(jax_evaluate_icu(JaxCNN(), pt.tree_map(
        lambda x: x.astype(np.float32), mesh_round["jax_new"]),
        {k: jnp.asarray(v) for k, v in test_np.items()})["roc_auc"])
    t_auc = float(evaluate_icu(CNNModel(), pt.tree_map(
        lambda x: x.to(torch.float32), mesh_round["port_new"]),
        {k: torch.from_numpy(v) for k, v in test_np.items()})["roc_auc"])
    assert np.isfinite(t_auc) and abs(t_auc - j_auc) <= 1e-3


def test_sharded_round_matches_the_meshless_round(mesh_round):
    t_stacked, t_ok = mesh_round["port"][0], mesh_round["port"][3]
    m_stacked, m_ok = mesh_round["meshless"][0], mesh_round["meshless"][3]
    assert bool(t_ok) == bool(m_ok)
    assert max_err(t_stacked, pt.tree_map(lambda x: x.numpy(), m_stacked)) <= 1e-5
    assert max_err(mesh_round["port_new"],
                   pt.tree_map(lambda x: x.numpy(), mesh_round["meshless_new"])) <= 1e-5


# ---------------------------------------------------------------------------
# 2. the per-defense sharded aggregation
# ---------------------------------------------------------------------------

N = 16
AGG = dict(total_clients=N, model="TransformerModel", data_name="ICU", num_data_range=(24, 32),
           epochs=1, batch_size=16, train_size=128, test_size=256, prng_impl="threefry2x32",
           telemetry=TelemetryConfig(enabled=False))


@pytest.fixture(scope="module")
def agg_inputs():
    model = TransformerModel()
    params = model.init(torch.Generator().manual_seed(3))
    noise = np.random.default_rng(7)
    stacked = pt.tree_map(lambda x: torch.from_numpy(
        (x.numpy()[None] + 0.01 * noise.standard_normal((N,) + tuple(x.shape)))
        .astype(np.float32)), params)
    root_delta = pt.tree_map(lambda x: torch.from_numpy(
        (0.01 * noise.standard_normal(tuple(x.shape))).astype(np.float32)), params)
    test = {k: torch.as_tensor(v) for k, v in jax_get_dataset("ICU", "test", 256, 1).items()}
    return {"model": model, "params": params, "stacked": stacked, "root_delta": root_delta,
            "sizes": torch.arange(1, N + 1, dtype=torch.int64),
            "wmask": torch.ones(N, dtype=torch.float32), "test": test}


def _allclose(ours: dict, ref, tol: float = 2e-6) -> None:
    ref = dict(pt.tree_items(pt.tree_map(np.asarray, ref)))
    for path, x in pt.tree_items(ours):
        np.testing.assert_allclose(x.detach().numpy(), ref[path], atol=tol, rtol=tol,
                                   err_msg=path)


@pytest.mark.parametrize("mode", sorted(PSUM_MODES | GATHER_MODES))
def test_sharded_aggregator_per_defense(mode, agg_inputs):
    a = agg_inputs
    cfg = Config(**AGG, mode=mode)
    draws = tround.round_drawer(cfg, [], N, 128, sum(x.numel() for x in pt.tree_leaves(
        a["params"])), 256)(torch.Generator().manual_seed(0))
    mesh = _port_mesh()
    plain = tround.build_aggregator(a["model"], cfg, a["test"])
    sharded = tround.build_aggregator(a["model"], cfg, a["test"], mesh=mesh)
    assert sharded.telemetry_info == {"program": f"aggregate[{mode}]", "sharded": True}
    args = (a["params"], a["stacked"], a["sizes"], a["wmask"], draws)
    want, got = plain(*args), sharded(*args)
    if mode in GATHER_MODES:
        for (path, x), y in zip(pt.tree_items(got), pt.tree_leaves(want)):
            assert torch.equal(x, y), path
        return
    _allclose(got, pt.tree_map(lambda x: x.numpy(), want))
    # the same partial sums on JAX's mesh
    jmesh = JaxSimulator(JaxConfig(total_clients=N, mode=mode, model="TransformerModel",
                                   data_name="ICU", train_size=128, test_size=64,
                                   telemetry=JaxTelemetryConfig(enabled=False)),
                         use_mesh=True).mesh
    assert jmesh.size == 8
    to_jax = lambda tree: pt.tree_map(lambda x: jnp.asarray(x.numpy()), tree)  # noqa: E731
    if mode == "FLTrust":
        deltas = pt.tree_map(lambda s, g: s - g.unsqueeze(0), a["stacked"], a["params"])
        ours = shard_aggregator(None, "FLTrust", mesh)(a["params"], deltas, a["root_delta"])
        theirs = jax.jit(jax_shard_aggregator(None, "FLTrust", jmesh))(
            to_jax(a["params"]), to_jax(deltas), to_jax(a["root_delta"]), jax.random.key(0))
        meshless = aggregators.fltrust_combine(a["params"], deltas, a["root_delta"])
        _allclose(ours, pt.tree_map(lambda x: x.numpy(), meshless))
    else:
        ours = got
        theirs = jax.jit(jax_shard_aggregator(None, mode, jmesh))(
            to_jax(a["params"]), to_jax(a["stacked"]), jnp.asarray(a["sizes"].numpy()),
            jnp.asarray(a["wmask"].numpy()), jax.random.key(0))
    _allclose(ours, theirs)
