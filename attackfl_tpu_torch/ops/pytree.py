"""Parameter-tree utilities (the port's ``attackfl_tpu/ops/pytree.py``).

A parameter tree is a nested dict of tensors keyed by the flax names.
Stacked trees carry N clients on the leading axis of every leaf.  Leaves
are always visited in sorted-key order, which is ``jax.tree.leaves``
order for dicts, so flattened (N, P) rows line up column for column with
the JAX package's.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator

import torch

Tree = dict[str, Any]


def tree_items(tree: Tree, prefix: str = "") -> Iterator[tuple[str, torch.Tensor]]:
    """(path, leaf) pairs in sorted-key order; paths read "a/b/kernel"."""
    for key in sorted(tree):
        value = tree[key]
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(value, dict):
            yield from tree_items(value, path)
        else:
            yield path, value


def tree_leaves(tree: Tree) -> list[torch.Tensor]:
    return [leaf for _, leaf in tree_items(tree)]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """Apply ``fn`` leafwise over trees of the same structure."""
    return {k: (tree_map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
                else fn(v, *(r[k] for r in rest)))
            for k, v in tree.items()}


def tree_take(tree: Tree, idx) -> Tree:
    """Index / gather along the leading (client) axis."""
    return tree_map(lambda x: x[idx], tree)


def tree_broadcast(tree: Tree, n: int) -> Tree:
    """Replicate one tree across a new leading client axis of size n."""
    return tree_map(lambda x: x.unsqueeze(0).expand((n,) + tuple(x.shape)), tree)


def tree_ravel_stacked(stacked: Tree) -> torch.Tensor:
    """Flatten a stacked tree to an (N, P) matrix, one row per client."""
    leaves = tree_leaves(stacked)
    n = leaves[0].shape[0]
    return torch.cat([x.reshape(n, -1) for x in leaves], dim=1)


def tree_mean(stacked: Tree, dim: int = 0) -> Tree:
    return tree_map(lambda x: torch.mean(x, dim=dim), stacked)


def tree_std(stacked: Tree, dim: int = 0, ddof: int = 1) -> Tree:
    """Per-element std along ``dim``, Bessel-corrected by default.  With
    no more elements than ``ddof`` the sample std is undefined and this
    returns zeros, so a one-model leak degrades to the mean."""

    def _std(x):
        if x.shape[dim] <= ddof:
            return torch.zeros_like(x.select(dim, 0))
        return torch.std(x, dim=dim, correction=ddof)

    return tree_map(_std, stacked)


def tree_weighted_mean(stacked: Tree, weights: torch.Tensor) -> Tree:
    """Weighted mean along the client axis; weights (N,) are normalized by
    their sum (size-weighted FedAvg, reference server.py:766-772)."""
    w = weights / torch.sum(weights)

    def wmean(x):
        wb = w.reshape((-1,) + (1,) * (x.ndim - 1)).to(x.dtype)
        return torch.sum(x * wb, dim=0)

    return tree_map(wmean, stacked)
