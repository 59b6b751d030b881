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


# ---------------------------------------------------------------------------
# norms and distances (attackfl_tpu/ops/pytree.py:68-155).  ``dim`` is the
# axis of the models compared; the axes before it are a batch (one per
# attacker in the round step), the axes after it the leaf's own.
# ---------------------------------------------------------------------------

def _leaf_norm(diff: torch.Tensor, matrix_spectral: bool, lead: int = 0) -> torch.Tensor:
    """Norm of each leaf difference over its own axes (those after the
    first ``lead``).  The reference takes ``torch.linalg.norm(diff,
    ord=2)`` per tensor (src/Utils.py:47): the vector norm of a 1-D leaf
    and the SPECTRAL norm of a 2-D one.  ``matrix_spectral=True``
    reproduces that; the default is the Frobenius norm of every leaf."""
    if matrix_spectral and diff.ndim - lead == 2:
        return torch.linalg.matrix_norm(diff, ord=2)
    return torch.sqrt(torch.sum(torch.square(diff.reshape(diff.shape[:lead] + (-1,))), dim=-1))


def ref_distance(a: Tree, b: Tree, matrix_spectral: bool = False) -> torch.Tensor:
    """SUM over leaves of the per-leaf norm of (a - b): the reference's
    ``compute_distance`` (src/Utils.py:30-49), not a global L2 norm."""
    total = torch.zeros(())
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        total = total + _leaf_norm(x - y, matrix_spectral)
    return total


def pairwise_ref_distance(stacked: Tree, matrix_spectral: bool = False,
                          dim: int = 0) -> torch.Tensor:
    """(..., N, N) :func:`ref_distance` between all models on ``dim``.

    The Frobenius path uses the Gram identity ``||xi-xj||^2 = ||xi||^2 +
    ||xj||^2 - 2<xi, xj>`` per leaf, with the JAX package's two float32
    guards: rows are centred per leaf first (the distances are
    translation-invariant, and the cancellation error scales with the
    norms, which the shared broadcast params dominate), and the diagonal
    is pinned to exactly 0.  Only the spectral path builds differences."""
    leaves = tree_leaves(stacked)
    n = leaves[0].shape[dim]
    batch = tuple(leaves[0].shape[:dim])
    total = torch.zeros(batch + (n, n), device=leaves[0].device)
    eye = torch.eye(n, dtype=torch.bool, device=leaves[0].device)
    for x in leaves:
        if matrix_spectral and x.ndim - dim - 1 == 2:
            diff = x.unsqueeze(dim + 1) - x.unsqueeze(dim)       # (..., N, N, r, c)
            norms = torch.linalg.matrix_norm(diff, ord=2)
        else:
            flat = x.reshape(batch + (n, -1))
            flat = flat - torch.mean(flat, dim=-2, keepdim=True)
            sq_norms = torch.sum(torch.square(flat), dim=-1)
            gram = flat @ flat.transpose(-1, -2)
            sq = sq_norms[..., :, None] + sq_norms[..., None, :] - 2.0 * gram
            norms = torch.sqrt(torch.where(eye, 0.0, torch.clamp(sq, min=0.0)))
        total = total + norms
    return total


def distance_to_each(candidate: Tree, stacked: Tree, matrix_spectral: bool = False,
                     dim: int = 0) -> torch.Tensor:
    """(..., N) :func:`ref_distance` from ``candidate`` (the batch axes,
    then the leaf's) to each model on ``dim`` of ``stacked``."""
    total = None
    for c, s in zip(tree_leaves(candidate), tree_leaves(stacked)):
        norms = _leaf_norm(s - c.unsqueeze(dim), matrix_spectral, lead=dim + 1)
        total = norms if total is None else total + norms
    return total


def unraveler(template: Tree) -> Callable[[torch.Tensor], Tree]:
    """``unravel(flat [..., P]) -> tree`` of views with leaves [..., *shape],
    the inverse of :func:`tree_ravel_stacked` for trees shaped like
    ``template`` (unstacked).  One ``split``, so under autograd the
    backward writes the flat gradient with one concatenation (a slice per
    leaf would zero-fill and add a whole [C, P] buffer for every leaf)."""
    items = list(tree_items(template))
    sizes = [leaf.numel() for _, leaf in items]

    def unravel(flat: torch.Tensor) -> Tree:
        tree: Tree = {}
        for (path, leaf), part in zip(items, torch.split(flat, sizes, dim=-1)):
            *keys, name = path.split("/")
            node = tree
            for key in keys:
                node = node.setdefault(key, {})
            node[name] = part.reshape(flat.shape[:-1] + tuple(leaf.shape))
        return tree

    return unravel
