"""Hyper mode: pFedHN-style personalized FL (the port's
``attackfl_tpu/training/hyper.py``).

The server owns a hypernetwork (``models/hyper.py``) mapping a client's
index to its full model.  Broadcast is generation, ``hnet(i)``; aggregation
is training the hypernetwork: for each client ``delta_theta = hnet(i) -
client_params`` and the gradient is the VJP of the generator applied to
that cotangent, the reference's ``torch.autograd.grad(outputs=weights,
inputs=hnet.params, grad_outputs=delta_theta)`` (server.py:654-659), then
one clipped Adam step along it (server.py:165,644-670).

Clients removed by the embedding detector leave the round through an
``active_mask`` (C,): they still train (the shapes stay static, as in the
JAX package), but their hypernetwork step, leak eligibility and
validation rows are masked out.  Everything random comes from a
``RoundDraws`` record, as in the plain round; a fault plan's forced
dropout and NaN storm enter where the plain round takes them (JAX
hyper.py:94-97,115-119,180-183).
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from attackfl_tpu_torch.config import Config
from attackfl_tpu_torch.data.partition import RoundDraws, apply_client_dropout
from attackfl_tpu_torch.faults.inject import apply_nan_storm, build_client_fault_fn
from attackfl_tpu_torch.models.hyper import HyperNetwork
from attackfl_tpu_torch.ops import pytree as pt
from attackfl_tpu_torch.training import local
from attackfl_tpu_torch.training.round import (
    AttackGroup, _rows, scatter_attacks,
)

B1, B2, EPS = local.B1, local.B2, local.EPS


class HyperOptimizer:
    """optax ``chain(clip_by_global_norm(clip), adam(hyper_lr, 0.9, 0.999,
    1e-8))`` on the flat hypernetwork vector (JAX ``make_hyper_optimizer``,
    hyper.py:39-46): the clip over the WHOLE gradient, with no +1e-6, and
    no clip when ``clip`` is 0.  The state ``{"count", "m", "v"}``
    persists across rounds; ``count`` is a 0-d int64 CPU tensor, so the
    bias corrections are host numbers without a device sync."""

    def __init__(self, lr: float, clip: float):
        self.lr, self.clip = float(lr), float(clip or 0.0)

    @staticmethod
    def init(flat: torch.Tensor) -> dict[str, torch.Tensor]:
        return {"count": torch.zeros((), dtype=torch.int64),
                "m": torch.zeros_like(flat), "v": torch.zeros_like(flat)}

    def step_(self, p: torch.Tensor, state: dict[str, torch.Tensor], g: torch.Tensor) -> None:
        """One clipped Adam step of ``p`` along ``g``, in place (``state``
        too; ``g`` is consumed as scratch)."""
        if self.clip > 0.0:
            norm = torch.linalg.vector_norm(g)
            g.mul_(torch.clamp(self.clip / norm, max=1.0))
        state["count"] += 1
        t = int(state["count"])
        m, v = state["m"], state["v"]
        m.mul_(B1).add_(g, alpha=1.0 - B1)
        v.mul_(B2).addcmul_(g, g, value=1.0 - B2)
        np_dtype = np.float64 if p.dtype == torch.float64 else np.float32
        bc1 = float(np_dtype(1.0 - B1 ** t))
        bc2 = float(np_dtype(1.0 - B2 ** t))
        denom = torch.div(v, bc2, out=g).sqrt_().add_(EPS)
        p.addcdiv_(m, denom, value=-self.lr / bc1)


def build_hyper_update(cfg: Config, hnet: HyperNetwork) -> tuple[Callable, HyperOptimizer]:
    """The server's hypernetwork step (JAX ``build_hyper_update``,
    hyper.py:219-291):

    ``hyper_update(flat, opt_state, stacked, active_mask) -> (flat,
    opt_state)``, new tensors (the inputs stay as they were, so a rollback
    or a failed round keeps them).  ``stacked`` is the clients' trained
    params (a stacked tree), ``active_mask`` (C,) which clients step.

    - ``sequential``: the clients in index order through one shared Adam;
      an inactive client keeps the whole carry, Adam's count included.
    - ``batched``: ONE Adam step on the mean of the active clients'
      gradients, weights normalized by their sum; no step at all when no
      client is active.  One backward of ``sum_i a_i <hnet(i), delta_i> /
      sum_i a_i`` with ``delta`` detached gives that mean without holding
      a gradient per client."""
    # Adam(hyper_lr) behind the configured grad clip (server.py:165,667-668)
    opt = HyperOptimizer(cfg.hyper_lr, cfg.clip_grad_norm)

    def grad_of(flat: torch.Tensor, rows: torch.Tensor, clients: slice,
                weights: torch.Tensor | None = None) -> torch.Tensor:
        q = flat.detach().requires_grad_()
        with torch.enable_grad():
            gen, _ = hnet.generate(q, clients)
            delta = gen.detach() - rows[clients]
            if weights is not None:
                delta = delta * weights[:, None]
            (g,) = torch.autograd.grad(gen, q, grad_outputs=delta)
        return g

    def hyper_update(flat, opt_state, stacked, active_mask):
        rows = pt.tree_ravel_stacked(stacked).to(flat.dtype)
        active = active_mask.to(flat.dtype)
        p, state = flat.clone(), {k: v.clone() for k, v in opt_state.items()}
        if cfg.hyper_update_mode == "batched":
            total = float(active.sum())
            if total > 0:
                opt.step_(p, state, grad_of(flat, rows, slice(None), active / total))
            return p, state
        for i, on in enumerate(active.tolist()):
            if on:
                opt.step_(p, state, grad_of(p, rows, slice(i, i + 1)))
        return p, state

    return hyper_update, opt


def build_hyper_round(model, cfg: Config, train_data: dict[str, torch.Tensor],
                      attack_groups: Sequence[AttackGroup], genuine_idx: Sequence[int],
                      hnet: HyperNetwork) -> Callable:
    """The client phase of a hyper round (JAX ``build_hyper_round``,
    hyper.py:49-216):

    ``round_step(flat, prev_genuine, have_genuine, active_mask, draws,
    broadcast_number) -> (stacked, sizes, new_genuine, ok, loss)``

    Every client trains from its own generated params with the ``xla``
    local update (in ``cfg.mesh.compute_dtype``); an attacker in an attack
    round forges from the params it was broadcast and its leak sample
    (``draws.leaks``, over the active genuine clients), and a ``none``
    cohort reports the params it was broadcast.  An attack fires when
    ``broadcast >= attack_round``, a genuine update has been leaked and
    some genuine client is active.
    ``ok`` is every active client's training finite and at least one
    participant (active and kept); the loss is the participants' mean."""
    local_update = local.build_local_update(
        model, cfg.data_name, train_data, epochs=cfg.epochs, batch_size=cfg.batch_size,
        lr=cfg.lr, clip_grad_norm=cfg.clip_grad_norm,
        compute_dtype=local.resolve_compute_dtype(cfg.mesh.compute_dtype))
    device = next(iter(train_data.values())).device
    genuine_arr = torch.as_tensor(list(genuine_idx), dtype=torch.int64, device=device)
    # every group goes through the attack scatter, ``none`` cohorts too: JAX's
    # hyper round runs them through apply_attack('none') (hyper.py:143-178),
    # which reports the rows they were broadcast, untrained, from
    # attack_round on (attacks.py:173-178); its plain round skips them
    # (round.py:296-303), and so does the port's
    groups = list(attack_groups)
    template = hnet.unravel_target(torch.zeros(hnet.num_target))
    drop_rate = cfg.client_dropout_rate
    forced_drop_fn = build_client_fault_fn(cfg.faults, cfg.total_clients, "dropout", device)
    nan_storm_fn = build_client_fault_fn(cfg.faults, cfg.total_clients, "nan_storm", device)

    def round_step(flat: torch.Tensor, prev_genuine: dict, have_genuine: bool,
                   active_mask: torch.Tensor, draws: RoundDraws, broadcast_number: int):
        with torch.no_grad():
            broadcast, _ = hnet.generate_all(flat)
        sizes, mask, kept = draws.sizes, draws.mask, draws.kept
        if kept is not None:
            sizes, mask = apply_client_dropout(kept, sizes, mask)
        else:
            kept = torch.ones_like(sizes, dtype=torch.bool)
        if forced_drop_fn is not None:
            kept = kept & ~forced_drop_fn(broadcast_number)
            sizes, mask = apply_client_dropout(kept, sizes, mask)
        stacked, ok, losses = local_update(broadcast, draws.idx, mask, draws.perms,
                                           draws.dropout_seed)
        any_active_genuine = bool(torch.any(active_mask[genuine_arr] > 0))
        stacked, ok = scatter_attacks(
            stacked, ok, groups, draws,
            fires=lambda grp: (broadcast_number >= grp.attack_round and have_genuine
                               and any_active_genuine),
            own=lambda ids: pt.tree_take(broadcast, ids),
            prev_genuine=prev_genuine, template=template, kept=kept)
        if nan_storm_fn is not None:
            stacked, ok = apply_nan_storm(nan_storm_fn(broadcast_number), stacked, ok)

        on = active_mask > 0
        participating = active_mask * kept.to(active_mask.dtype)
        ok = torch.all(ok | ~on) & (torch.sum(participating) > 0)
        fresh = pt.tree_take(stacked, genuine_arr)
        if drop_rate > 0.0:
            # dropped genuine clients keep their last REPORTED update in
            # the leak pool (the plain round's rule)
            sel = ok & (kept[genuine_arr] | (not have_genuine))
        else:
            sel = ok.expand(len(genuine_idx))
        new_genuine = pt.tree_map(lambda n, p: torch.where(_rows(sel, n), n, p),
                                  fresh, prev_genuine)
        part = participating.to(losses.dtype)
        loss = torch.sum(losses * part) / torch.clamp(torch.sum(part), min=1.0)
        return stacked, sizes, new_genuine, ok, loss

    return round_step
