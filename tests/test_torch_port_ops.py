"""The port's tree ops, LIE attack, FedAvg and ROC-AUC against the JAX
package on identical numpy inputs, at 1e-6 (float32 reductions over a
handful of rows)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_threads import one_torch_thread  # noqa: F401

from attackfl_tpu.eval.validation import roc_auc as jax_roc_auc
from attackfl_tpu.ops import aggregators as jagg
from attackfl_tpu.ops import attacks as jatt
from attackfl_tpu.ops import pytree as jpt
from attackfl_tpu_torch.eval.validation import roc_auc
from attackfl_tpu_torch.ops import aggregators, attacks
from attackfl_tpu_torch.ops import pytree as pt
from attackfl_tpu_torch.training import round as tround

TOL = 1e-6


def _tree(n, seed=0):
    rng = np.random.default_rng(seed)
    return {"a": {"kernel": rng.standard_normal((n, 4, 3)).astype(np.float32),
                  "bias": rng.standard_normal((n, 3)).astype(np.float32)},
            "b": rng.standard_normal((n, 5)).astype(np.float32)}


def _torch(tree):
    return pt.tree_map(torch.from_numpy, tree)


def _assert_trees_close(ours, ref, atol=TOL):
    ref_leaves = dict(pt.tree_items(pt.tree_map(np.asarray, ref)))
    for path, x in pt.tree_items(ours):
        np.testing.assert_allclose(x.numpy(), ref_leaves[path], atol=atol, rtol=0,
                                   err_msg=path)


@pytest.mark.parametrize("n", [1, 2, 5])
def test_lie_attack_matches(n):
    """mean + z * Bessel std, with the one-model case degrading to the mean."""
    tree = _tree(n)
    ref = jatt.lie_attack(pt.tree_map(jnp.asarray, tree), 0.74)
    _assert_trees_close(attacks.lie_attack(_torch(tree), 0.74), ref)
    _assert_trees_close(attacks.apply_attack("LIE", None, _torch(tree), (0.74,)), ref)


def test_tree_std_and_mean_match():
    tree = _tree(4, seed=2)
    _assert_trees_close(pt.tree_std(_torch(tree)), jpt.tree_std(pt.tree_map(jnp.asarray, tree)))
    _assert_trees_close(pt.tree_mean(_torch(tree)), jpt.tree_mean(pt.tree_map(jnp.asarray, tree)))


def test_fedavg_matches():
    tree = _tree(6, seed=3)
    sizes = np.array([12, 15, 13, 14, 12, 15], np.int32)
    ref = jagg.fedavg(pt.tree_map(jnp.asarray, tree), jnp.asarray(sizes))
    _assert_trees_close(aggregators.fedavg(_torch(tree), torch.from_numpy(sizes)), ref)


def test_tree_take_and_broadcast_match():
    tree = _tree(5, seed=4)
    idx = np.array([4, 0, 2])
    _assert_trees_close(pt.tree_take(_torch(tree), torch.from_numpy(idx)),
                        jpt.tree_take(pt.tree_map(jnp.asarray, tree), idx), atol=0)
    one = pt.tree_map(lambda x: x[0], tree)
    _assert_trees_close(pt.tree_broadcast(_torch(one), 3),
                        jpt.tree_broadcast(pt.tree_map(jnp.asarray, one), 3), atol=0)


@pytest.mark.parametrize("case", ["ties", "random", "single_class"])
def test_roc_auc_matches(case):
    rng = np.random.default_rng(5)
    if case == "ties":
        scores = rng.integers(0, 5, 400).astype(np.float32) / 4.0
        labels = (rng.random(400) < 0.3).astype(np.float32)
    elif case == "random":
        scores = rng.random(1000).astype(np.float32)
        labels = (rng.random(1000) < scores).astype(np.float32)
    else:
        scores = rng.random(50).astype(np.float32)
        labels = np.ones(50, np.float32)
    ours = float(roc_auc(torch.from_numpy(labels), torch.from_numpy(scores)))
    ref = float(jax_roc_auc(jnp.asarray(labels), jnp.asarray(scores)))
    if case == "single_class":
        assert np.isnan(ours) and np.isnan(ref)
    else:
        assert abs(ours - ref) <= TOL


def test_map_attackers_chunks_give_identical_rows(monkeypatch):
    """The gather-budget chunking (round.py:45-83) changes peak memory,
    not results."""
    pool = _torch(_tree(6, seed=6))
    leaks = torch.tensor([[0, 1, 2], [3, 4, 5], [1, 3, 5], [0, 2, 4], [5, 4, 3]])

    def rows(sl):
        return attacks.lie_attack(pt.tree_take(pool, leaks[sl]), 0.74, dim=1)

    whole = tround.map_attackers(rows, 5, 3, pt.tree_map(lambda x: x[0], pool))
    monkeypatch.setattr(tround, "ATTACK_GATHER_BUDGET", 2 * 3 * 20)
    chunked = tround.map_attackers(rows, 5, 3, pt.tree_map(lambda x: x[0], pool))
    for (path, a), (_, b) in zip(pt.tree_items(whole), pt.tree_items(chunked)):
        assert a.shape[0] == 5 and torch.equal(a, b), path
