"""The scenario matrix's round: every device cell's broadcast, with their
clients trained in one folded local update (the port's counterpart of
``attackfl_tpu/matrix/program.py``, its own design).

JAX vmaps the whole fused body over the cell axis.  The port cannot: K3
launches through ctypes, the γ searches read the card, and each cell
draws from its own ``torch.Generator``.  So one sweep round is:

1. **per cell, in ``expand_cells`` order**: the round's draws from the
   cell's own generator, exactly as ``Simulator.draw_round`` draws them
   for its ``cell_config`` (``training/round.round_drawer``), and the
   round step's ``prepare`` half (stragglers, the plan's forced dropout);
2. **one folded ``train``** (:func:`fold_train`) over every device cell's
   clients: ``R = cells · C`` rows through ``training/local``'s update,
   each row with its cell's params, samples, shuffles and dropout seed and
   its client id within the cell.  The dropout keys are elementwise, so
   every cell's rows draw their standalone masks, all of them in ONE K3
   launch a step; Adam and the sample gathers run once over all rows.  The fold is cut into parts of at most :func:`cells_per_part`
   cells, so that no mask tensor reaches K3's 2^31-element limit; a
   cell's rows never straddle two parts;
3. **per cell**: the ``finish`` half (attacks, NaN storm, leak pool), the
   cell's defense's aggregate, the validation on the cell's own broadcast
   clock and the accept by ``torch.where``: the fused body's own tail
   (``training/engine.build_plain_tail``), numerics included.

Bits.  Each cell's final state must equal its standalone run's.  On the
H100, cuBLAS picks other fp32 GEMM tiles for the batched products under
``vmap(grad_and_value)`` at 1,600 rows than at 100, and the gradients
then differ in the last bits; below 16 rows the clip's row reduction
splits otherwise too (measured, ``PERF.md``).  So the fold issues the
gradient and the clip a cell at a time (``segment`` = C rows, each call
the standalone's shapes, strides and kernels) and folds everything
else.  On the card each cell's
gradient step replays one captured CUDA graph of it
(``training/local.StepGraph``), which runs the eager step's kernels and
gives its bits with one launch in place of ~200; a counted dispatch (the
cost model's first) issues it eagerly, op by op.  Every cell's output
rows are copied into tensors of their own, so the cell's later ops see
the allocation a standalone run's do.  This is fixed in code for both
device groups (batched and mapped), never decided at run time.

Over a client mesh (``matrix run --mesh``, JAX matrix_exec.py:106-131) the
cell axis splits over the shards (:func:`fold_shards`): the device cells
are clone-padded up to a multiple of the shard count, each shard folds its
own block of cells with the local update built for its device (one K3
launch a step and part on its shard), the results come back to the lead
device and the padded ones are dropped.  Cells never exchange anything,
so the sweep runs no collective, and each cell's rows are the ones the
unsharded fold gives it, bit for bit.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Sequence

import numpy as np
import torch

from attackfl_tpu_torch.config import Config
from attackfl_tpu_torch.matrix.grid import Cell, cell_config
from attackfl_tpu_torch.ops import pytree as pt
from attackfl_tpu_torch.ops.metrics import Numerics, build_layout
from attackfl_tpu_torch.parallel.mesh import ClientMesh
from attackfl_tpu_torch.training.engine import build_plain_tail
from attackfl_tpu_torch.training.round import (
    RoundHalves, build_attack_groups, build_round_halves, round_drawer,
)

# K3 refuses a mask tensor of 2^31 elements or more (ops/fused_step.py)
K3_MAX_ELEMENTS = 2 ** 31 - 1


@dataclass
class CellProgram:
    """One device cell's round, built for its ``cell_config``: its draws,
    the round step's halves, the tail (aggregate, validation, accept) and
    its numerics ring."""

    cell: Cell
    cfg: Config
    num_genuine: int
    draw: Callable
    halves: RoundHalves
    tail: Callable
    numerics: Numerics | None


def build_cell_program(model, base: Config, cell: Cell, rounds: int,
                       train_data: dict[str, torch.Tensor], pool_size: int,
                       num_params: int, test_rows: int, update: Callable,
                       aggregate: Callable, validation, device: torch.device,
                       numerics_window: int | None = None) -> CellProgram:
    """``cell``'s round on the sweep's shared data and local ``update``;
    ``aggregate`` is its defense's branch (``round.build_defense_branches``).
    With ``numerics_window`` the cell carries a numerics ring, built as the
    engine builds it for the cell's config."""
    cfg = cell_config(base, cell, rounds=rounds)
    groups, genuine_idx = build_attack_groups(cfg)
    numerics = step = None
    if numerics_window is not None:
        attacker_mask = np.zeros(cfg.total_clients, dtype=bool)
        for grp in groups:
            attacker_mask[list(grp.indices)] = True
        layout = build_layout(model.init(torch.Generator().manual_seed(cfg.random_seed)),
                              bool(groups))
        numerics = Numerics(layout, ~attacker_mask, attacker_mask, window=numerics_window,
                            device=device)

        def step(num_state, old_ref, new_ref, stacked, sizes, loss, ok, broadcast):
            with torch.no_grad():
                return numerics.step(num_state, old_ref, old_ref, new_ref, stacked, sizes,
                                     loss, ok, broadcast)
    return CellProgram(
        cell=cell, cfg=cfg, num_genuine=len(genuine_idx),
        draw=round_drawer(cfg, groups, len(genuine_idx), pool_size, num_params, test_rows),
        halves=build_round_halves(model, cfg, train_data, groups, genuine_idx, update=update),
        tail=build_plain_tail(cfg, device, aggregate, validation, step),
        numerics=numerics)


def cells_per_part(specs: Sequence[tuple], clients: int) -> int:
    """The most cells one part of the fold holds: every mask tensor of
    ``specs`` (``(tensor_id, rows, width, rate)``, a step's) stays below
    K3's limit at ``cells · clients`` rows.  At least 1."""
    widest = max((rows * width for _, rows, width, rate in specs if rate > 0.0), default=1)
    return max(1, K3_MAX_ELEMENTS // widest // clients)


def fold_train(update: Callable, params: Sequence[dict], inputs: Sequence[tuple],
               clients: int, per_part: int) -> list[tuple]:
    """Every cell's local training of one broadcast, folded: ``params``
    each cell's global params, ``inputs`` each cell's ``(draws, mask)``.
    Returns each cell's ``(stacked, ok, losses)`` in tensors of its own,
    as its standalone ``train`` returns them.  One call of ``update`` for
    each part of at most ``per_part`` cells, the gradient and the clip
    issued a cell at a time (see the module doc)."""
    out: list[tuple] = []
    for start in range(0, len(params), per_part):
        part = range(start, min(start + per_part, len(params)))
        stacked = pt.tree_map(lambda *xs: torch.cat(xs),
                              *[pt.tree_broadcast(params[i], clients) for i in part])
        draws = [inputs[i][0] for i in part]
        seed = torch.cat([torch.as_tensor(d.dropout_seed, device=d.idx.device)
                          .reshape(1).expand(clients) for d in draws])
        ids = torch.arange(clients, dtype=torch.int64, device=seed.device).repeat(len(part))
        trained, ok, losses = update(
            stacked, torch.cat([d.idx for d in draws]),
            torch.cat([inputs[i][1] for i in part]),
            torch.cat([d.perms for d in draws], dim=1), seed, ids, segment=clients)
        for j in range(len(part)):
            rows = slice(j * clients, (j + 1) * clients)
            out.append((pt.tree_map(lambda x: x[rows].clone(), trained),
                        ok[rows].clone(), losses[rows].clone()))
    return out


def padded_cells(cells: int, mesh: ClientMesh) -> int:
    """The cell count a mesh's fold trains: ``cells`` clone-padded up to
    a multiple of the shard count."""
    return -(-cells // mesh.size) * mesh.size


def fold_shards(updates: dict, mesh: ClientMesh, params: Sequence[dict],
                inputs: Sequence[tuple], clients: int, per_part: int) -> list[tuple]:
    """:func:`fold_train` over the mesh's shards: the cells clone-padded
    (the last cell repeated) up to :func:`padded_cells`, each shard's
    contiguous block of cells folded on its device by its update
    (``updates``, by device), every result on the lead device in cell
    order, the padded ones dropped."""
    n = len(params)
    order = list(range(n)) + [n - 1] * (padded_cells(n, mesh) - n)
    lead = mesh.lead
    out: list[tuple] = []
    for device, rows in zip(mesh.devices, mesh.blocks(len(order))):
        block = order[rows]
        moved = [(dataclasses.replace(inputs[i][0], idx=inputs[i][0].idx.to(device),
                                      perms=inputs[i][0].perms.to(device),
                                      dropout_seed=_to(inputs[i][0].dropout_seed, device)),
                  inputs[i][1].to(device)) for i in block]
        shard = fold_train(updates[device], [pt.tree_map(lambda x: x.to(device), params[i])
                                             for i in block], moved, clients, per_part)
        out.extend((pt.tree_map(lambda x: x.to(lead), stacked), ok.to(lead), losses.to(lead))
                   for stacked, ok, losses in shard)
    return out[:n]


def _to(value, device: torch.device):
    return value.to(device) if isinstance(value, torch.Tensor) else value


def sweep_round(programs: Sequence[CellProgram], states: Sequence[dict[str, Any]],
                update: Callable, clients: int, per_part: int,
                mesh: ClientMesh | None = None, updates: dict | None = None
                ) -> list[tuple[dict[str, Any], dict[str, Any]]]:
    """One broadcast of every cell in ``programs`` (each cell's fused
    state in ``states``, its generator advanced in place): per cell its
    draws and ``prepare``, one folded ``train`` (over ``mesh``'s shards by
    :func:`fold_shards` when given, ``updates`` its updates by device),
    per cell ``finish`` and the tail.  Returns each cell's ``(new_state,
    metrics)``, the metrics 0-dim device tensors, as the engine's fused
    body returns them."""
    prepared = []
    for prog, state in zip(programs, states):
        b = state["broadcasts"] + 1
        draws = prog.draw(state["rng"])
        sizes, mask, kept = prog.halves.prepare(draws, b)
        prepared.append((b, draws, sizes, mask, kept))
    params = [s["global_params"] for s in states]
    inputs = [(draws, mask) for _, draws, _, mask, _ in prepared]
    trained = (fold_train(update, params, inputs, clients, per_part) if mesh is None
               else fold_shards(updates, mesh, params, inputs, clients, per_part))
    out = []
    for prog, state, (b, draws, sizes, _, kept), result in zip(programs, states, prepared,
                                                               trained):
        outputs = prog.halves.finish(state["global_params"], state["prev_genuine"],
                                     state["have_genuine"], draws, b, sizes, kept, result)
        out.append(prog.tail(state, b, draws, outputs))
    return out
