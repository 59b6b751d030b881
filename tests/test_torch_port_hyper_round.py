"""Hyper mode's round, validation and engine in the port on the CPU.

One hyper round of each hypernetwork class on CNNModel against the JAX package's
``build_hyper_round`` from the same hypernetwork, leak pool, data and
draws (JAX's key schedule fed through ``RoundDraws``), with dropout off,
one genuine client inactive and one LIE attacker forging from the params
it was broadcast: every row, the new leak pool, ``ok`` and the loss
within 2e-4; and a ``none`` cohort, which reports the rows it was
broadcast in both packages.  Both
sides run in float64 (JAX under ``enable_x64``): in float32 Adam's cold
start turns noise-level gradients into up to ``lr`` (``ROADMAP.md`` §3).  The hyper validation and the engine's hyper round
are in ``test_torch_port_hyper_engine.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_threads import one_torch_thread  # noqa: F401

from _torch_port_models import JaxDropoutOff, as_dtype, as_t, dropout_off, jax_perms
from attackfl_tpu.config import AttackSpec as JaxAttackSpec
from attackfl_tpu.config import Config as JaxConfig
from attackfl_tpu.config import TelemetryConfig as JaxTelemetryConfig
from attackfl_tpu.data.partition import sample_round_indices as jax_sample_round_indices
from attackfl_tpu.data.synthetic import get_dataset as jax_get_dataset
from attackfl_tpu.faults.plan import parse_fault_plan as jax_parse_fault_plan
from attackfl_tpu.models import icu as jicu
from attackfl_tpu.models.hyper import make_cnn_hyper as jax_make_cnn_hyper
from attackfl_tpu.models.hyper import make_hypernetwork as jax_make_hypernetwork
from attackfl_tpu.training import round as jround
from attackfl_tpu.training.hyper import build_hyper_round as jax_build_hyper_round
from attackfl_tpu_torch.config import AttackSpec, Config
from attackfl_tpu_torch.data.partition import RoundDraws
from attackfl_tpu_torch.faults.plan import parse_fault_plan
from attackfl_tpu_torch.models.hyper import make_hypernetwork
from attackfl_tpu_torch.ops import pytree as pt
from attackfl_tpu_torch.registry import get_model
from attackfl_tpu_torch.training import round as tround
from attackfl_tpu_torch.training.hyper import build_hyper_round
from attackfl_tpu_torch.weights import hnet_params_from_jax

C, EPOCHS, BATCH, LO, HI, TRAIN = 4, 2, 8, 12, 16, 128
ROUND_TOL = 2e-4
LIE = dict(mode="LIE", num_clients=1, attack_round=1, args=(0.74,))
JAX_MAKE = {"HyperNetwork": jax_make_hypernetwork, "CNNHyper": jax_make_cnn_hyper}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _hparams(module) -> dict:
    """Seeded float64 hypernetwork parameters from the init distributions
    (embeddings N(0, 1), the rest U(+-1/sqrt(fan_in))), without tracing
    flax's init."""
    rng = np.random.default_rng(1)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.asarray(0))["params"]
    return {name: ({"embedding": rng.standard_normal(leaves["embedding"].shape)}
                   if name == "embeddings" else
                   {k: rng.uniform(-1, 1, x.shape) / np.sqrt(leaves["kernel"].shape[0])
                    for k, x in leaves.items()})
            for name, leaves in shapes.items()}


def _worst(ours: dict, ref: dict) -> float:
    ref = dict(pt.tree_items(_np(ref)))
    return max(float(np.abs(x.numpy() - ref[path]).max()) for path, x in pt.tree_items(ours))


def _rounds(cls: str, specs: tuple[dict, ...], model: str = "CNNModel", plan: str = ""):
    """One hyper round (broadcast 1) of ``cls`` with the attack ``specs``
    (one LIE attacker, and what else they name) and the fault plan
    ``plan`` on both sides from the same state and draws: ``(ours, jax's,
    the port's round step and its inputs, the attack groups)``."""
    shared = dict(total_clients=C, mode="hyper", model=model, data_name="ICU",
                  hyper_class=cls, num_data_range=(LO, HI), epochs=EPOCHS, batch_size=BATCH,
                  train_size=TRAIN, test_size=16, genuine_rate=0.5)
    jcfg = JaxConfig(**shared, prng_impl="threefry2x32",
                     attacks=tuple(JaxAttackSpec(**a) for a in specs),
                     faults=jax_parse_fault_plan(plan),
                     telemetry=JaxTelemetryConfig(enabled=False))
    tcfg = Config(**shared, attacks=tuple(AttackSpec(**a) for a in specs),
                  faults=parse_fault_plan(plan))
    train_np = as_dtype(jax_get_dataset("ICU", "train", TRAIN, 1), np.float64)
    jgroups, genuine = jround.build_attack_groups(jcfg)
    G = len(genuine)
    active = np.array([0.0, 1.0, 1.0, 1.0])          # genuine client 0 inactive
    rng_np = np.random.default_rng(3)
    with jax.enable_x64(True):
        jmodel = getattr(jicu, model)()
        jt = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, 7)),
                            jnp.zeros((1, 16)))["params"]
        module, apply = JAX_MAKE[cls](jt, C)
        hp = _hparams(module)
        prev = jax.tree.map(lambda x: 0.05 * rng_np.standard_normal((G,) + x.shape), jt)
        step, _ = jax_build_hyper_round(
            JaxDropoutOff(jmodel), jcfg, {k: jnp.asarray(v) for k, v in train_np.items()},
            jgroups, genuine, apply)
        rng = jax.random.key(11, impl="threefry2x32")
        jout = jax.jit(step)(hp, prev, jnp.asarray(True), jnp.asarray(active), rng,
                             jnp.asarray(1))
        # the draws of that round (hyper.py:99-164)
        k_data, k_train, k_attack = jax.random.split(rng, 3)
        idx, mask, sizes = jax_sample_round_indices(k_data, C, TRAIN, LO, HI)
        # float32 as the round computes it (the Gumbel draw takes p's dtype)
        leak_p = (active[genuine] / active[genuine].sum()).astype(np.float32)
        (gi,) = [i for i, g in enumerate(jgroups) if g.mode == "LIE"]
        keys = jax.random.split(jax.random.fold_in(k_attack, gi), 1)
        leaks = as_t(np.stack([jax.random.choice(jax.random.split(key)[0], G, (1,),
                                                 replace=False, p=jnp.asarray(leak_p))
                               for key in keys]))
        perms = jax_perms(jax.random.split(k_train, C), EPOCHS, HI)
    draws = RoundDraws(idx=as_t(idx), mask=torch.from_numpy(np.array(mask)), sizes=as_t(sizes),
                       perms=perms, dropout_seed=0, leaks=(leaks,))

    tmpl = get_model(model).init(torch.Generator().manual_seed(0))
    hnet = make_hypernetwork(cls, tmpl, C)
    tgroups, tgenuine = tround.build_attack_groups(tcfg)
    assert tgenuine == genuine and [g.indices for g in tgroups] == [g.indices for g in jgroups]
    tstep = build_hyper_round(dropout_off(get_model(model)), tcfg,
                              {k: torch.from_numpy(v) for k, v in train_np.items()},
                              tgroups, tgenuine, hnet)
    flat = hnet_params_from_jax(hp, hnet, dtype=torch.float64)
    inputs = (flat, pt.tree_map(torch.from_numpy, prev), True, torch.from_numpy(active), draws, 1)
    return tstep(*inputs), jout, (hnet, tcfg, train_np, tgenuine, inputs), jgroups


@pytest.mark.parametrize("cls", ["HyperNetwork", "CNNHyper"])
def test_hyper_round_matches_jax(cls):
    ours, jout, (hnet, _, _, _, (flat, *_)), jgroups = _rounds(cls, (LIE,))
    stacked, tsizes, new_genuine, ok, loss = ours
    jstacked, jsizes, jnew, jok, jloss = jout
    # the attacker (the last client) forged LIE from its own broadcast row:
    # it differs from the row it was broadcast
    broadcast, _ = hnet.generate_all(flat)
    (attacker,) = [list(g.indices) for g in jgroups if g.mode == "LIE"]
    assert _worst(pt.tree_take(stacked, attacker), pt.tree_take(broadcast, attacker)) > 1e-3
    assert _worst(stacked, jstacked) <= ROUND_TOL
    assert _worst(new_genuine, jnew) <= ROUND_TOL
    assert torch.equal(tsizes, torch.from_numpy(np.asarray(jsizes, np.int64)))
    assert bool(ok) == bool(jok) is True
    assert abs(float(loss) - float(jloss)) <= ROUND_TOL


def test_hyper_none_cohort_reports_its_broadcast_rows_as_jax():
    """A ``none`` cohort in hyper mode goes through the attack scatter as
    in JAX's hyper round (hyper.py:143-178): ``apply_attack('none')``
    hands back the rows the cohort was broadcast (attacks.py:173-178), so
    from ``attack_round`` on it reports an untrained model and its ok
    flag is set.  The port replicates that fault of the reference (its
    plain round skips ``none`` cohorts, round.py:296-303).  The cohort's
    rows and every other row equal JAX's within ROUND_TOL."""
    ours, jout, (hnet, tcfg, train_np, genuine, inputs), jgroups = _rounds(
        "HyperNetwork", (LIE, dict(mode="none", num_clients=1, attack_round=1)))
    stacked, jstacked = ours[0], _np(jout[0])
    (cohort,) = [list(g.indices) for g in jgroups if g.mode == "none"]
    others = [i for i in range(C) if i not in cohort]
    broadcast, _ = hnet.generate_all(inputs[0])
    for (_, a), (_, b) in zip(pt.tree_items(pt.tree_take(stacked, cohort)),
                              pt.tree_items(pt.tree_take(broadcast, cohort))):
        assert torch.equal(a, b)
    assert _worst(pt.tree_take(stacked, cohort), pt.tree_take(jstacked, cohort)) <= ROUND_TOL
    assert _worst(pt.tree_take(stacked, others), pt.tree_take(jstacked, others)) <= ROUND_TOL
    assert _worst(ours[2], jout[2]) <= ROUND_TOL
    assert bool(ours[3]) == bool(jout[3]) is True
