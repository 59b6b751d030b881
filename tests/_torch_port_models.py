"""Shared helpers of tests/test_torch_port_models_*.py: one federated round
of each package on the same inputs, with dropout off on both sides.

The JAX side runs ``attackfl_tpu.training.round.build_round_step`` under
``local_backend: xla`` with threefry keys, jitted; dropout is off through
a wrapper whose ``apply`` forwards ``train=False`` (the only switch for
the HAR classifier's fixed 0.3 head dropout).  The port's model gets
rates of 0, so it draws no mask.  The port's round runs on a
``RoundDraws`` record built from the JAX key schedule (round.py:275,
278-293, 307-321; local.py:139-145).
"""

from dataclasses import dataclass
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import torch

from attackfl_tpu.config import AttackSpec as JaxAttackSpec
from attackfl_tpu.config import Config as JaxConfig
from attackfl_tpu.config import TelemetryConfig as JaxTelemetryConfig
from attackfl_tpu.data.partition import sample_round_indices as jax_sample_round_indices
from attackfl_tpu.training import local as jlocal
from attackfl_tpu.training import round as jround
from attackfl_tpu_torch.config import AttackSpec, Config
from attackfl_tpu_torch.data.partition import RoundDraws
from attackfl_tpu_torch.ops import pytree as pt
from attackfl_tpu_torch.training import local
from attackfl_tpu_torch.training import round as tround


class JaxDropoutOff:
    """A JAX model whose training forward is its evaluation forward."""

    def __init__(self, inner):
        self.inner = inner

    def apply(self, variables, *inputs, train=False, rngs=None):
        return self.inner.apply(variables, *inputs, train=False)


def dropout_off(model):
    """The port's ``model`` with every dropout rate 0: it draws no mask."""
    model.dropout_rates = (0.0,) * len(model.dropout_rates)
    return model


def as_t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.int64))


def jax_perms(train_keys, epochs: int, hi: int) -> torch.Tensor:
    """Per-epoch permutations of JAX's local_update (local.py:139-142)."""
    eks = jax.vmap(lambda k: jax.random.split(k, epochs))(train_keys)
    return as_t(np.stack([
        jax.vmap(lambda k: jax.random.permutation(k, hi))(
            jax.vmap(lambda k: jax.random.split(k[e])[0])(eks))
        for e in range(epochs)]))


def max_err(ours, ref, rows=None) -> float:
    """max |ours - ref| over every leaf (the given client rows of stacked
    trees); ``ref`` a JAX or numpy tree."""
    ref_leaves = dict(pt.tree_items(pt.tree_map(np.asarray, ref)))
    worst = 0.0
    for path, x in pt.tree_items(ours):
        a, b = x.detach().numpy(), ref_leaves[path]
        if rows is not None:
            a, b = a[rows], b[rows]
        worst = max(worst, float(np.abs(a - b).max()))
    return worst


def seeded_params(port_model, seed: int = 0, spread: float = 0.05) -> dict:
    """Numpy params in the JAX layout: the port's init nudged by a seeded
    ``spread``, so biases and norms are not at their init values."""
    rng = np.random.default_rng(seed)
    tree = port_model.init(torch.Generator().manual_seed(seed))
    return pt.tree_map(lambda x: (x.numpy() + spread * rng.standard_normal(x.shape)
                                  ).astype(np.float32), tree)


@dataclass
class BothRounds:
    jax: tuple          # (stacked, sizes, new_genuine, ok, mean_loss)
    port: tuple
    draws: RoundDraws
    params: Any         # the broadcast params (numpy, JAX layout)
    attackers: list[int]
    genuine: list[int]


def as_dtype(tree, dtype):
    """Floating leaves of a numpy tree cast to ``dtype``."""
    return pt.tree_map(lambda x: x.astype(dtype) if x.dtype.kind == "f" else x, tree)


def both_rounds(jax_model, port_model, train_np: dict, *, data_name: str, clients: int,
                epochs: int, batch: int, num_data_range: tuple[int, int],
                attack: dict | None = None, seed: int = 0, dtype=np.float32) -> BothRounds:
    """One round of each package from the same params, leak pool and
    draws; LIE or another attack fires when ``attack`` is given (broadcast
    1 >= its attack_round 1, a genuine set exists).  ``dtype`` float64
    runs both packages in float64 (JAX under ``enable_x64``)."""
    with jax.enable_x64(dtype == np.float64):
        return _both_rounds(jax_model, port_model, as_dtype(train_np, dtype),
                            data_name=data_name, clients=clients, epochs=epochs, batch=batch,
                            num_data_range=num_data_range, attack=attack, seed=seed,
                            dtype=dtype)


def _both_rounds(jax_model, port_model, train_np, *, data_name, clients, epochs, batch,
                 num_data_range, attack, seed, dtype):
    lo, hi = num_data_range
    shared = dict(total_clients=clients, mode="fedavg", model=type(port_model).__name__,
                  data_name=data_name, num_data_range=num_data_range, epochs=epochs,
                  batch_size=batch, train_size=len(train_np["label"]), test_size=16,
                  local_backend="xla", genuine_rate=0.5)
    jcfg = JaxConfig(**shared, prng_impl="threefry2x32",
                     attacks=(JaxAttackSpec(**attack),) if attack else (),
                     telemetry=JaxTelemetryConfig(enabled=False))
    tcfg = Config(**shared, attacks=(AttackSpec(**attack),) if attack else ())
    params = as_dtype(seeded_params(port_model, seed), dtype)
    jgroups, genuine = jround.build_attack_groups(jcfg)
    G = len(genuine)
    rng_np = np.random.default_rng(seed + 1)
    prev = pt.tree_map(lambda x: (x[None] + 0.05 * rng_np.standard_normal(
        (G,) + x.shape)).astype(dtype), params)

    rng = jax.random.key(5 + seed, impl="threefry2x32")
    step = jax.jit(jround.build_round_step(
        JaxDropoutOff(jax_model), jcfg, {k: jnp.asarray(v) for k, v in train_np.items()},
        jgroups, genuine))
    jout = step(params, pt.tree_map(jnp.asarray, prev), jnp.asarray(True), rng, jnp.asarray(1))

    k_data, k_train, k_attack = jax.random.split(rng, 3)
    idx, mask, sizes = jax_sample_round_indices(k_data, clients, len(train_np["label"]), lo, hi)
    leak_k = max(int(jcfg.genuine_rate * G), 1)
    leaks = []
    for gi, grp in enumerate(jgroups):
        keys = jax.random.split(jax.random.fold_in(k_attack, gi), len(grp.indices))
        leaks.append(as_t(jax.vmap(lambda key: jax.random.choice(
            jax.random.split(key)[0], G, (leak_k,), replace=False))(keys)))
    draws = RoundDraws(idx=as_t(idx), mask=torch.from_numpy(np.array(mask)),
                       sizes=as_t(sizes),
                       perms=jax_perms(jax.random.split(k_train, clients), epochs, hi),
                       dropout_seed=0, leaks=tuple(leaks))

    tgroups, tgenuine = tround.build_attack_groups(tcfg)
    assert [g.indices for g in tgroups] == [g.indices for g in jgroups] and tgenuine == genuine
    tstep = tround.build_round_step(
        dropout_off(port_model), tcfg, {k: torch.from_numpy(v) for k, v in train_np.items()},
        tgroups, tgenuine)
    to_port = lambda tree: pt.tree_map(torch.from_numpy, tree)  # noqa: E731
    tout = tstep(to_port(params), to_port(prev), True, draws, 1)
    attackers = [i for g in jgroups for i in g.indices]
    return BothRounds(jax=jout, port=tout, draws=draws, params=params,
                      attackers=attackers, genuine=list(genuine))


def port_local_update(port_model, train_np: dict, rounds: BothRounds, *, data_name: str,
                      epochs: int, batch: int):
    """The port's local update of every client on the round's draws, in
    the round's dtype: ``(stacked, ok, loss [C])``."""
    dtype = pt.tree_leaves(rounds.params)[0].dtype
    update = local.build_local_update(
        dropout_off(port_model), data_name,
        {k: torch.from_numpy(v) for k, v in as_dtype(train_np, dtype).items()},
        epochs=epochs, batch_size=batch, lr=Config().lr, clip_grad_norm=Config().clip_grad_norm)
    d = rounds.draws
    return update(pt.tree_map(torch.from_numpy, rounds.params), d.idx, d.mask, d.perms, 0)


def count_mask_draws(monkeypatch, fn) -> int:
    """Calls of ``fused_step.fill_masks`` (K3's wrapper) while ``fn``
    runs: one per minibatch step on a model with dropout."""
    calls = []
    fill = local.fused_step.fill_masks

    def spy(keys, specs):
        calls.append(len(specs))
        return fill(keys, specs)

    monkeypatch.setattr(local.fused_step, "fill_masks", spy)
    fn()
    monkeypatch.undo()
    return len(calls)


def one_step_both(jax_model, port_model, data_name: str, batch_np: dict, params: dict,
                  mask=None):
    """One minibatch's loss and gradient in each package, float32, from
    the same params (numpy, JAX layout): ``((jax_loss, jax_grads),
    (port_loss, port_grads))``; the JAX side through its
    ``make_loss_fn``, the port's through ``local.make_loss_fn``."""
    n = len(batch_np["label"])
    mask = np.ones(n, np.float32) if mask is None else mask
    jloss = jlocal.make_loss_fn(JaxDropoutOff(jax_model), data_name)
    j = jax.jit(jax.value_and_grad(jloss))(
        params, {k: jnp.asarray(v) for k, v in batch_np.items()}, jnp.asarray(mask),
        jax.random.PRNGKey(0))
    data = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    tloss = local.make_loss_fn(dropout_off(port_model), data_name)
    grads, value = torch.func.grad_and_value(tloss)(
        pt.tree_map(torch.from_numpy, params), tuple(data[k] for k in local.INPUTS[data_name]),
        local.labels_of(data, data_name), torch.from_numpy(mask))
    return j, (value, grads)
