"""The sharded round over a client mesh: the local update per shard and the
per-defense collective table (the port's ``attackfl_tpu/parallel/shard.py``).

* **local training** runs per shard on its contiguous block of clients
  (:func:`shard_local_update`): each shard's update trains its ``C/n``
  clients as global clients ``base .. base + C/n``, so the dropout hash,
  keyed by the global client, draws the masks the same clients draw in
  one unsharded call.  It runs no collective;
* **aggregation** becomes collectives between the shards
  (:func:`shard_aggregator`), a psum only where partial sums suffice and
  one all_gather where the defense needs the whole matrix:

  ========================  =============  ==============================
  defense                   collectives    why
  ========================  =============  ==============================
  fedavg / fltracer / gmm   psum           weighted mean = partial sums
  shieldfl                  psum           mean-unit reference + weighted
                                           mean are both partial sums
  FLTrust                   psum           root pass is replicated; trust
                                           scores are per-client locals,
                                           the combine is a partial sum
  median / trimmed_mean     all_gather     per-coordinate order statistics
  krum                      all_gather     pairwise distance matrix
  scionfl                   all_gather     global cosine-distance quantile
  byzantine                 all_gather     anchor row lives on one shard
  ========================  =============  ==============================

The program audit holds this table against the collectives a sharded
program records (:data:`attackfl_tpu_torch.analysis.program_audit.
EXPECTED_COLLECTIVES`).

**The collectives** are the port's own, over the mesh's shards:
:func:`psum` and :func:`all_gather`.  Each sums or concatenates in shard
order on the lead device and copies the result to every shard (a no-op on
a repeated device), so every shard holds the same bits and two runs give
the same bits.  Each is a ``torch.autograd.Function`` whose backward is its
transposition dual, as JAX's AD transposes a collective: psum's cotangent
is a psum, and all_gather's a reduce_scatter, the shards' cotangents of
the gathered matrix summed by a psum with each shard keeping its own rows.
A differentiated gather defense so records {all_gather, psum,
reduce_scatter} and a psum defense {psum}: :func:`grad_collectives`.
Each call records its name in the records opened by
:func:`record_collectives` in the calling thread; a backward records into
the records its forward saw, whichever thread autograd runs it on.

**Bits.**  The gather modes run the unchanged aggregator on the gathered
matrix and give the meshless bits.  The psum modes re-associate the
reduction across shards, a tolerance-level difference, as in JAX; each
divides by the psum'd total before its own partial sum, so on a one-shard
mesh its bits are the meshless aggregator's.  A replicated result is
computed once, on the lead device, where every shard would compute the
same bits.

**Strategies.**  The port draws its randomness from ``torch.Generator``s
and a counter-based hash, so ``prng_impl`` changes none of its bits.  The
rule that picks the strategy is JAX's all the same
(:func:`supports_shard_map`: the JAX package keeps rbg keys off
``shard_map``, whose device-local blocks would draw other hardware bits),
so that one YAML runs alike in both packages.
"""

from __future__ import annotations

import contextlib
import threading
from collections import Counter
from typing import Any, Callable, Sequence

import torch

from attackfl_tpu_torch.ops import aggregators
from attackfl_tpu_torch.ops import pytree as pt
from attackfl_tpu_torch.parallel.mesh import (
    ClientMesh, gather_stacked, replicate_local, shard_stacked,
)

# Defense modes whose aggregation decomposes into per-shard partial sums
# (one or two psum stages, no cross-shard ordering anywhere).
PSUM_MODES = frozenset({"fedavg", "fltracer", "gmm", "shieldfl", "FLTrust"})
# Defense modes that need the full (C, P) matrix in one place: order
# statistics, pairwise distances, global quantiles, or a specific row.
GATHER_MODES = frozenset({"median", "trimmed_mean", "krum", "scionfl",
                          "byzantine"})

# Differentiating a sharded aggregation turns each collective into its
# transposition dual: psum is self-dual, and all_gather's cotangent is a
# reduce_scatter built on a psum of the shards' cotangents (see the module
# doc).  The program audit's `grad` column holds these sets.
_GRAD_COLLECTIVE_DUALS: dict[str, frozenset[str]] = {
    "psum": frozenset({"psum"}),
    "all_gather": frozenset({"all_gather", "psum", "reduce_scatter"}),
}


def grad_collectives(forward: frozenset[str]) -> frozenset[str]:
    """The collective set a differentiated round program may contain,
    derived from its forward set via the transposition duals above."""
    out: set[str] = set()
    for name in forward:
        out |= _GRAD_COLLECTIVE_DUALS.get(name, frozenset({name}))
    return frozenset(out)


def supports_shard_map(cfg) -> bool:
    """True when this config's mesh execution may use shard_map: plain
    (non-hyper) modes under the counter-based ``threefry2x32``, JAX's
    rule (its rbg keys draw batch-shape-dependent bits)."""
    return cfg.prng_impl == "threefry2x32" and cfg.mode != "hyper"


# ---------------------------------------------------------------------------
# the record of collectives
# ---------------------------------------------------------------------------

_LOCAL = threading.local()


def _open_records() -> tuple[Counter, ...]:
    return tuple(getattr(_LOCAL, "records", ()))


def _note(name: str, records: Sequence[Counter]) -> None:
    for record in records:
        record[name] += 1


@contextlib.contextmanager
def record_collectives():
    """Record the collectives this thread runs inside the block, and those
    their backward passes run later: yields a ``Counter`` of name ->
    calls.  Records nest; each open one sees every call."""
    record: Counter = Counter()
    _LOCAL.records = _open_records() + (record,)
    try:
        yield record
    finally:
        _LOCAL.records = tuple(r for r in _open_records() if r is not record)


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------

def _sum_on_lead(parts: Sequence[torch.Tensor | None], mesh: ClientMesh):
    """The parts summed in shard order on the lead device (None parts
    skipped; None when all are)."""
    acc = None
    for part in parts:
        if part is None:
            continue
        part = part.to(mesh.lead)
        acc = part if acc is None else acc + part
    return acc


def _to_shards(value: torch.Tensor | None, mesh: ClientMesh) -> tuple:
    return tuple(None if value is None else value.to(d) for d in mesh.devices)


def _reduce_scatter(grads: Sequence[torch.Tensor | None], rows: Sequence[int],
                    mesh: ClientMesh, records) -> tuple:
    """The shards' cotangents of one gathered matrix summed (a psum) and
    cut back into the blocks the gather took, each on its shard."""
    _note("reduce_scatter", records)
    _note("psum", records)
    total = _sum_on_lead(grads, mesh)
    if total is None:
        return (None,) * mesh.size
    parts = torch.split(total, list(rows))
    return tuple(part.to(d) for part, d in zip(parts, mesh.devices))


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, *parts):
        ctx.mesh, ctx.records = mesh, _open_records()
        ctx.set_materialize_grads(False)
        _note("psum", ctx.records)
        return _to_shards(_sum_on_lead(parts, mesh), mesh)

    @staticmethod
    def backward(ctx, *grads):
        _note("psum", ctx.records)
        return (None, *_to_shards(_sum_on_lead(grads, ctx.mesh), ctx.mesh))


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, *blocks):
        ctx.mesh, ctx.records = mesh, _open_records()
        ctx.rows = [b.shape[0] for b in blocks]
        ctx.set_materialize_grads(False)
        _note("all_gather", ctx.records)
        full = blocks[0] if mesh.size == 1 else torch.cat([b.to(mesh.lead) for b in blocks])
        return _to_shards(full, mesh)

    @staticmethod
    def backward(ctx, *grads):
        return (None, *_reduce_scatter(grads, ctx.rows, ctx.mesh, ctx.records))


def psum(parts: Sequence[torch.Tensor], mesh: ClientMesh) -> list[torch.Tensor]:
    """Each shard's ``parts[i]`` (on its device) summed over the shards:
    one copy of the sum per shard."""
    if len(parts) != mesh.size:
        raise ValueError(f"psum over {mesh.size} shards got {len(parts)} parts")
    return list(_PSum.apply(mesh, *parts))


def all_gather(blocks: Sequence[torch.Tensor], mesh: ClientMesh) -> list[torch.Tensor]:
    """The shards' blocks concatenated along the leading axis in shard
    order (JAX's ``all_gather(tiled=True)``): one copy per shard."""
    if len(blocks) != mesh.size:
        raise ValueError(f"all_gather over {mesh.size} shards got {len(blocks)} blocks")
    return list(_AllGather.apply(mesh, *blocks))


# ---------------------------------------------------------------------------
# the sharded halves of the round
# ---------------------------------------------------------------------------

def shard_local_update(updates: dict[torch.device, Callable], mesh: ClientMesh,
                       stacked_params: bool = False) -> Callable:
    """``batched(params, idx, mask, perms, seed) -> (stacked, ok, losses)``
    over the mesh: each shard trains its block of clients with the local
    update built for its device (``updates``, by device) as global clients
    ``base ..`` (``client_base``), and the blocks come back to the lead
    device in shard order.  ``params`` replicates to every shard, or with
    ``stacked_params`` (hyper mode's generated rows) splits like the
    clients.  It runs no collective.  On a one-shard mesh it is the lead
    update's call."""
    lead = updates[mesh.lead]
    if mesh.size == 1:
        def batched(params, idx, mask, perms, seed):
            return lead(params, idx, mask, perms, seed, client_base=0)
        return batched

    def batched(params, idx, mask, perms, seed):
        blocks = mesh.blocks(idx.shape[0])
        rows_of = (shard_stacked(params, mesh) if stacked_params
                   else replicate_local(params, mesh))
        outs = []
        for device, rows, shard_params in zip(mesh.devices, blocks, rows_of):
            shard_seed = seed.to(device) if isinstance(seed, torch.Tensor) else seed
            outs.append(updates[device](
                shard_params, idx[rows].to(device), mask[rows].to(device),
                perms[:, rows].to(device), shard_seed, client_base=rows.start))
        return (gather_stacked([o[0] for o in outs], mesh),
                gather_stacked([o[1] for o in outs], mesh),
                gather_stacked([o[2] for o in outs], mesh))

    return batched


def _psum_weighted_mean(blocks: list, weights: list, mesh: ClientMesh) -> dict:
    """The weighted mean over ALL clients from the shards' blocks (JAX
    ``_psum_weighted_mean``): the weights' psum'd total, each shard's
    partial sum of its rows times its weights over that total, and a psum
    of the partials, leaf by leaf.  On one shard these are
    ``pytree.tree_weighted_mean``'s operations."""
    totals = psum([torch.sum(w) for w in weights], mesh)

    def leaf(*xs):
        parts = []
        for x, w, total in zip(xs, weights, totals):
            wb = (w / total).reshape((-1,) + (1,) * (x.ndim - 1)).to(x.dtype)
            parts.append(torch.sum(x * wb, dim=0))
        return psum(parts, mesh)[0]

    return pt.tree_map(leaf, *blocks)


def _fltrust_combine(mesh: ClientMesh) -> Callable:
    """FLTrust's combine half over the shards: ``combine(global_params,
    deltas, root_delta)``, the deltas stacked on the lead device, the
    root delta replicated."""
    def combine(global_params, deltas, root_delta):
        blocks = shard_stacked(deltas, mesh)
        roots = replicate_local(root_delta, mesh)
        trusts, scales = [], []
        for block, root in zip(blocks, roots):
            norm_root = torch.linalg.vector_norm(aggregators._flat_root(root))
            trust = aggregators.fltrust_trust(block, root)
            norms = torch.linalg.vector_norm(pt.tree_ravel_stacked(block), dim=1)
            trusts.append(trust)
            scales.append((norm_root / (norms + 1e-6)) * trust)
        total = psum([torch.sum(t) for t in trusts], mesh)[0] + 1e-6

        def leaf(g, *ds):
            parts = [torch.sum(d * s.reshape((-1,) + (1,) * (d.ndim - 1)), dim=0)
                     for d, s in zip(ds, scales)]
            return g + psum(parts, mesh)[0] / total

        return pt.tree_map(leaf, global_params, *blocks)

    return combine


def shard_aggregator(aggregate: Callable | None, mode: str, mesh: ClientMesh) -> Callable:
    """Wrap a ``round.build_aggregator`` callable ``(global_params,
    stacked, sizes, weights_mask, draws) -> new_global`` so that the
    client rows are split over the mesh's shards and reduced by the
    collectives of the module doc's table.  Same signature, the result on
    the lead device.  FLTrust wraps only its combine half:
    ``combine(global_params, deltas, root_delta)``, its root pass running
    once, replicated, outside (``round.build_aggregator``)."""
    if mode == "FLTrust":
        return _fltrust_combine(mesh)
    if mode in ("fedavg", "fltracer"):
        def body(global_params, blocks, sizes, masks, draws):
            return _psum_weighted_mean(
                blocks, [s.to(torch.float32) * m for s, m in zip(sizes, masks)], mesh)
    elif mode == "gmm":
        def body(global_params, blocks, sizes, masks, draws):
            return _psum_weighted_mean(blocks, list(masks), mesh)
    elif mode == "shieldfl":
        def body(global_params, blocks, sizes, masks, draws):
            # stage 1: the replicated reference direction from psum'd unit
            # sums over the reporting clients (JAX's masked form; with the
            # all-ones mask of a round without stragglers it is the mean)
            units, ms = [], []
            for block, m in zip(blocks, masks):
                flat = pt.tree_ravel_stacked(block)
                units.append(flat / (torch.linalg.vector_norm(flat, dim=1, keepdim=True)
                                     + 1e-8))
                ms.append(m.to(flat.dtype))
            count = psum([torch.sum(m) for m in ms], mesh)
            refs = psum([torch.sum(u * m[:, None], dim=0) for u, m in zip(units, ms)], mesh)
            # stage 2: each shard's weights against the reference;
            # stage 3: the psum'd weighted mean
            weights = [m * (1.0 / (1.0 - aggregators._cosine(u, ref / torch.clamp(n, min=1.0))
                                   + 1e-6))
                       for u, m, ref, n in zip(units, ms, refs, count)]
            return _psum_weighted_mean(blocks, weights, mesh)
    elif mode in GATHER_MODES:
        def body(global_params, blocks, sizes, masks, draws):
            full = pt.tree_map(lambda *xs: all_gather(xs, mesh)[0], *blocks)
            return aggregate(global_params, full, all_gather(sizes, mesh)[0],
                             all_gather(masks, mesh)[0], draws)
    else:
        raise ValueError(f"no sharded aggregation for mode {mode!r}")

    def sharded(global_params, stacked, sizes, weights_mask, draws):
        return body(global_params, shard_stacked(stacked, mesh), shard_stacked(sizes, mesh),
                    shard_stacked(weights_mask, mesh), draws)

    return sharded
