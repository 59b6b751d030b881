"""The port's hypernetwork update (``attackfl_tpu_torch/training/hyper.py``
``build_hyper_update``) against the JAX package's (``build_hyper_update``,
``attackfl_tpu/training/hyper.py:219-291``) on the CPU, in float64 (JAX
under ``enable_x64``): both update modes, with and without spectral
normalization, over two consecutive calls from the same hypernetwork and
the same client rows, one client inactive.  The hypernetwork and Adam's
moments within 1e-10 of their largest magnitude, Adam's count equal.  A
batched call with no active client is a no-op.

The target is a small three-leaf tree: the update reads only its shapes,
and the models' templates are held in ``test_torch_port_hyper_models.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_threads import one_torch_thread  # noqa: F401

from attackfl_tpu.config import Config as JaxConfig
from attackfl_tpu.config import TelemetryConfig as JaxTelemetryConfig
from attackfl_tpu.models.hyper import make_hypernetwork as jax_make_hypernetwork
from attackfl_tpu.training.hyper import build_hyper_update as jax_build_hyper_update
from attackfl_tpu_torch.config import Config
from attackfl_tpu_torch.models.hyper import make_hypernetwork
from attackfl_tpu_torch.ops import pytree as pt
from attackfl_tpu_torch.training.hyper import build_hyper_update
from attackfl_tpu_torch.weights import hnet_params_from_jax, hnet_params_to_jax

C = 4
TOL = 1e-10
SHAPES = {"conv": {"kernel": (3, 2, 5), "bias": (5,)}, "out": {"kernel": (5, 1)}}


def _cfgs(mode: str, spec_norm: bool):
    shared = dict(total_clients=C, mode="hyper", model="CNNModel", data_name="ICU",
                  hyper_update_mode=mode, hyper_spec_norm=spec_norm, hyper_lr=0.01,
                  clip_grad_norm=1.0)
    return (JaxConfig(**shared, telemetry=JaxTelemetryConfig(enabled=False)),
            Config(**shared))


def _adam(opt_state):
    """(count, mu, nu) of optax's chain(clip, adam) state."""
    adam = opt_state[1][0]
    return int(adam.count), adam.mu, adam.nu


def _close(ours: dict, ref: dict, what: str) -> float:
    ref = dict(pt.tree_items(jax.tree.map(np.asarray, ref)))
    worst = 0.0
    for path, x in pt.tree_items(ours):
        scale = max(1.0, float(np.abs(ref[path]).max()))
        worst = max(worst, float(np.abs(x - ref[path]).max()) / scale)
    assert worst <= TOL, (what, worst)
    return worst


@pytest.mark.parametrize("mode,spec_norm", [("sequential", False), ("sequential", True),
                                            ("batched", False), ("batched", True)])
def test_update_matches_jax_over_two_calls(mode, spec_norm):
    rng = np.random.default_rng(7)
    jcfg, tcfg = _cfgs(mode, spec_norm)
    with jax.enable_x64(True):
        jtmpl = jax.tree.map(lambda s: jnp.zeros(s, jnp.float64), SHAPES,
                             is_leaf=lambda x: isinstance(x, tuple))
        module, apply = jax_make_hypernetwork(jtmpl, C, spec_norm=spec_norm)
        hp = jax.tree.map(lambda x: jnp.asarray(x, jnp.float64),
                          module.init(jax.random.PRNGKey(0), jnp.asarray(0))["params"])
        update, tx = jax_build_hyper_update(jcfg, apply, C)
        update = jax.jit(update)
        opt = tx.init(hp)
        gen = jax.vmap(lambda i: apply(hp, i)[0])(jnp.arange(C))
        # two rounds of client rows near the generated ones (the clip fires
        # on some steps and not on others); client 1 inactive
        rows = [jax.tree.map(lambda x: np.asarray(x) + s * rng.standard_normal(x.shape), gen)
                for s in (0.05, 0.002)]
        active = np.array([1.0, 0.0, 1.0, 1.0])
        jstates = []
        jp, jo = hp, opt
        for r in rows:
            jp, jo = update(jp, jo, jax.tree.map(jnp.asarray, r), jnp.asarray(active))
            jstates.append((jax.tree.map(np.asarray, jp), _adam(jo)))

    tmpl = jax.tree.map(lambda s: torch.zeros(s, dtype=torch.float64), SHAPES,
                        is_leaf=lambda x: isinstance(x, tuple))
    hnet = make_hypernetwork("HyperNetwork", tmpl, C, spec_norm=spec_norm)
    hyper_update, opt_t = build_hyper_update(tcfg, hnet)
    flat = hnet_params_from_jax(jax.tree.map(np.asarray, hp), hnet, dtype=torch.float64)
    state = opt_t.init(flat)
    steps = int(active.sum()) if mode == "sequential" else 1
    for k, (r, (jparams, (jcount, jmu, jnu))) in enumerate(zip(rows, jstates), 1):
        flat, state = hyper_update(flat, state, pt.tree_map(torch.from_numpy, r),
                                   torch.from_numpy(active))
        assert int(state["count"]) == jcount == k * steps
        _close(hnet_params_to_jax(flat, hnet), jparams, "params")
        _close(hnet_params_to_jax(state["m"], hnet), jmu, "mu")
        _close(hnet_params_to_jax(state["v"], hnet), jnu, "nu")


def test_update_leaves_its_inputs_and_skips_an_all_inactive_round():
    """A batched call with every client inactive takes no step, Adam's
    count included (JAX hyper.py:259-264 selects the old state when no
    client is active); a sequential one skips each inactive client.
    Neither call writes to its inputs."""
    rng = np.random.default_rng(0)
    tmpl = jax.tree.map(lambda s: torch.zeros(s, dtype=torch.float64), SHAPES,
                        is_leaf=lambda x: isinstance(x, tuple))
    hnet = make_hypernetwork("HyperNetwork", tmpl, C)
    flat = hnet.init(torch.Generator().manual_seed(0), dtype=torch.float64)
    rows = pt.tree_map(lambda x: x + torch.from_numpy(0.05 * rng.standard_normal(x.shape)),
                       hnet.generate_all(flat)[0])
    for mode in ("batched", "sequential"):
        hyper_update, opt = build_hyper_update(_cfgs(mode, False)[1], hnet)
        state = opt.init(flat)
        state["count"] += 5
        snapshot = (flat.clone(), {k: v.clone() for k, v in state.items()})
        new, new_state = hyper_update(flat, state, rows, torch.zeros(C, dtype=torch.float64))
        assert torch.equal(new, flat) and int(new_state["count"]) == 5
        assert all(torch.equal(new_state[k], state[k]) for k in state)
        new, new_state = hyper_update(flat, state, rows, torch.ones(C, dtype=torch.float64))
        assert int(new_state["count"]) == 5 + (1 if mode == "batched" else C)
        assert not torch.equal(new, flat)
        assert torch.equal(flat, snapshot[0])
        assert all(torch.equal(state[k], snapshot[1][k]) for k in state)
