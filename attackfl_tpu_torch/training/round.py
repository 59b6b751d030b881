"""The federated round (the port's ``attackfl_tpu/training/round.py``).

    local training of every client -> attackers overwrite their rows with
    an attack on the previous round's leaked genuine updates -> the new
    genuine set -> aggregation.

Fidelity points kept from the JAX package (reference server.py and
RpcClient.py behaviour):
* attackers do not train in attack rounds: their update comes from the
  broadcast params and the genuine models leaked from the *previous*
  round; before any genuine set exists they train genuinely;
* each attacker gets its own leak sample of ``max(int(genuine_rate * G),
  1)`` genuine models drawn without replacement;
* the attack fires when ``broadcast >= attack_round`` and a genuine set
  exists; an attacking row's ok flag is reset (it did not train).  The
  broadcast test is the host's; ``have_genuine`` may be a device flag
  (the fused path's), so the rows are selected by ``kept & have_genuine``
  on the device and the attack is computed whenever the broadcast test
  passes;
* the genuine-leak pool absorbs only rounds whose training was clean;
* stragglers (``RoundDraws.kept``): a dropped client gets size 0 and every
  sample masked, so its row is the broadcast params; a dropped attacker's
  row is not replaced; a dropped genuine client's leak-pool row stays
  stale (once the pool exists); a round where every client drops fails,
  and the loss is the mean over the kept clients;
* a fault plan (``Config.faults``, ``faults/inject.py``): a forced
  ``dropout`` cohort drops after the sampled stragglers, and a
  ``nan_storm`` sets its clients' rows to NaN after the attack scatter, so
  a stormed attacker row is stormed too (JAX round.py:262-271,285-290,
  333-340).  Whenever a forced-dropout cohort exists the round fails when
  nobody is kept and the loss is the kept clients' mean (JAX
  round.py:344,378-379); the leak pool's stale-row rule keys on
  ``client_dropout_rate > 0``, as JAX's does (round.py:351-360).

Randomness enters only through a :class:`~attackfl_tpu_torch.data.partition.RoundDraws`
record, drawn by the engine.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Sequence

import torch

from attackfl_tpu_torch.config import NONE_ATTACK, Config
from attackfl_tpu_torch.data.partition import RoundDraws, apply_client_dropout, draw_round
from attackfl_tpu_torch.faults.inject import apply_nan_storm, build_client_fault_fn
from attackfl_tpu_torch.ops import aggregators, attacks, fused_step
from attackfl_tpu_torch.ops import pytree as pt
from attackfl_tpu_torch.training import local

# Element budget of one chunk of the per-attacker leak gather: each
# attacker materializes its own (leak_k, P) sample, so all of them at once
# is (attackers, leak_k, P) — 3.8e9 floats at 1000 clients.  Attackers are
# processed in chunks that stay under this many elements (~800 MB f32).
ATTACK_GATHER_BUDGET = int(2e8)


def map_attackers(attack_rows: Callable[[slice], dict], n_attackers: int, leak_k: int,
                  params_template: dict) -> dict:
    """``attack_rows(rows: slice) -> stacked (rows, ...)`` over all
    attackers, in chunks whose leak gather stays inside
    ``ATTACK_GATHER_BUDGET``; identical results to one call."""
    p_total = sum(x.numel() for x in pt.tree_leaves(params_template))
    chunk = max(1, ATTACK_GATHER_BUDGET // max(leak_k * p_total, 1))
    if chunk >= n_attackers:
        return attack_rows(slice(0, n_attackers))
    parts = [attack_rows(slice(i, i + chunk)) for i in range(0, n_attackers, chunk)]
    return pt.tree_map(lambda *xs: torch.cat(xs, dim=0), *parts)


@dataclass(frozen=True)
class AttackGroup:
    """Static attacker geometry for one attack spec."""

    mode: str
    indices: tuple[int, ...]
    attack_round: int
    args: tuple[float, ...]


def build_attack_groups(cfg: Config) -> tuple[list[AttackGroup], list[int]]:
    """Resolve config attack specs into (groups, genuine client indices)."""
    assignment = cfg.attacker_assignment()
    by_spec: dict[int, list[int]] = {}
    specs: dict[int, Any] = {}
    for cid, spec in assignment.items():
        by_spec.setdefault(id(spec), []).append(cid)
        specs[id(spec)] = spec
    groups = [AttackGroup(mode=specs[k].mode, indices=tuple(sorted(ids)),
                          attack_round=specs[k].attack_round,
                          args=tuple(specs[k].args))
              for k, ids in by_spec.items()]
    genuine = sorted(set(range(cfg.total_clients)) - set(assignment))
    return groups, genuine


def attacking_groups(groups: Sequence[AttackGroup]) -> list[AttackGroup]:
    """Groups that can fire (``none`` cohorts never do and draw nothing)."""
    return [g for g in groups if g.mode != NONE_ATTACK]


def describe_attack_groups(groups: Sequence[AttackGroup]) -> list[dict[str, Any]]:
    """The attacker geometry for the run header (JAX round.py:134-145)."""
    return [{"mode": g.mode, "num_clients": len(g.indices), "indices": list(g.indices),
             "attack_round": g.attack_round, "args": list(g.args)} for g in groups]


def active_attack_modes(groups: Sequence[AttackGroup], broadcast_number: int,
                        have_genuine: bool) -> list[str]:
    """The attack modes firing at this broadcast, the host's mirror of the
    round step's gate: nothing fires before a genuine set exists (JAX
    round.py:148-157)."""
    if not have_genuine:
        return []
    return sorted({g.mode for g in groups
                   if broadcast_number >= g.attack_round and g.mode != NONE_ATTACK})


def active_attacker_indices(groups: Sequence[AttackGroup], broadcast_number: int,
                            have_genuine: bool) -> list[int]:
    """The clients that attack at this broadcast, the attribution's ground
    truth (JAX round.py:160-170)."""
    if not have_genuine:
        return []
    return sorted({cid for g in groups
                   if broadcast_number >= g.attack_round and g.mode != NONE_ATTACK
                   for cid in g.indices})


def leak_size(cfg: Config, num_genuine: int) -> int:
    """Genuine models leaked to each attacker (reference server.py:599-600)."""
    return min(max(int(cfg.genuine_rate * num_genuine), 1), num_genuine)


def _rows(sel: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-row flag (n,) shaped to broadcast against ``like`` (n, ...)."""
    return sel.reshape((-1,) + (1,) * (like.ndim - 1))


def group_rows(groups: Sequence[AttackGroup], device: torch.device) -> list[torch.Tensor]:
    """Each group's client ids as an int64 tensor on ``device``, made once
    when a round is built: a copy from the host inside a round would wait
    for the card."""
    return [torch.as_tensor(g.indices, dtype=torch.int64, device=device) for g in groups]


def scatter_attacks(stacked: dict, ok: torch.Tensor, groups: Sequence[AttackGroup],
                    rows_of: Sequence[torch.Tensor], draws: RoundDraws,
                    fires: Callable[[AttackGroup], bool],
                    own: Callable[[torch.Tensor], dict], prev_genuine: dict,
                    template: dict, kept: torch.Tensor | None = None,
                    *, have_genuine: bool | torch.Tensor) -> tuple[dict, torch.Tensor]:
    """Overwrite the rows of every attack group that ``fires`` (a host
    test) with its attack, in place: each attacker forges from
    ``own(rows)``, its own params (n, ...) for the attacker ids ``rows``,
    and its leak sample of ``prev_genuine`` (``draws.leaks``); Random
    from ``draws.noise`` shaped like ``template`` (one unstacked tree); a
    ``none`` cohort reports ``own(rows)`` (``apply_attack('none')``) and
    reads no leak.  ``groups`` are in the order of ``draws.leaks``, which
    holds an entry for each group but the ``none`` ones; ``rows_of`` holds
    each group's ids (:func:`group_rows`).  A row is replaced where its
    attacker reported (``kept``; a dropped attacker never reports) and
    ``have_genuine`` holds, a bool or a 0-dim bool tensor on the device
    (JAX round.py:308-332: ``active & kept``).  An attacking row's ok flag
    is set: it did not train.  Returns ``(stacked, ok)``."""
    noise = iter(draws.noise)
    leak_samples = iter(draws.leaks)
    for grp, grp_arr in zip(groups, rows_of):
        leaks = None if grp.mode == NONE_ATTACK else next(leak_samples)
        grp_noise = next(noise) if grp.mode == "Random" else None
        if not fires(grp):
            continue

        def attack_rows(rows, grp=grp, leaks=leaks, grp_noise=grp_noise, grp_arr=grp_arr):
            mine = own(grp_arr[rows])
            if leaks is None:              # a none cohort reports what it was sent
                return attacks.apply_attack(grp.mode, mine, None)
            if grp_noise is not None:      # Random reads no leaked model
                z = pt.unraveler(template)(grp_noise[rows])
                return attacks.apply_attack(grp.mode, mine, None, grp.args, noise=z)
            leaked = pt.tree_take(prev_genuine, leaks[rows])   # (n, k, ...)
            return attacks.apply_attack(grp.mode, mine, leaked, grp.args, dim=1)

        leak_k = 0 if leaks is None else leaks.shape[1]
        attacked = map_attackers(attack_rows, len(grp.indices), leak_k, template)
        active = (torch.ones(len(grp.indices), dtype=torch.bool, device=ok.device)
                  if kept is None else kept[grp_arr]) & have_genuine

        def scatter(s, a, grp_arr=grp_arr, active=active):
            s[grp_arr] = torch.where(_rows(active, a), a, s[grp_arr])
            return s

        stacked = pt.tree_map(scatter, stacked, attacked)
        ok[grp_arr] = ok[grp_arr] | active
    return stacked, ok


def build_client_update(model, cfg: Config, train_data: dict[str, torch.Tensor]) -> Callable:
    """Every client's local training of a round, ``batched(params, idx,
    mask, perms, seed) -> (stacked, ok, losses)``: under ``local_backend``
    ``xla`` torch autograd (``training/local.py``, which also trains many
    runs' clients in one call), under ``pallas`` the fused kernel
    (``ops/fused_step.py``), TransformerModel only.  Dropout is at the
    model's own rates (``model.dropout_rates``)."""
    kw = dict(epochs=cfg.epochs, batch_size=cfg.batch_size, lr=cfg.lr,
              clip_grad_norm=cfg.clip_grad_norm)
    if cfg.local_backend == "xla":
        # dropout on wherever it runs, as the JAX package's xla path
        return local.build_local_update(
            model, cfg.data_name, train_data,
            compute_dtype=local.resolve_compute_dtype(cfg.mesh.compute_dtype), **kw)
    # on the CPU the fused path trains with dropout off, as the JAX
    # package's interpret path does: there it is a correctness path
    device = next(iter(train_data.values())).device
    dropout = (0.0, 0.0, 0.0) if device.type == "cpu" else model.dropout_rates
    return fused_step.build_fused_local_update(train_data, dropout=dropout, **kw)


@dataclass(frozen=True)
class RoundHalves:
    """The round step in its two halves (:func:`build_round_halves`):
    ``prepare(draws, broadcast_number) -> (sizes, mask, kept)``, the
    clients' sizes and sample masks after the stragglers and the plan's
    forced dropout; ``train(global_params, draws, mask) -> (stacked, ok,
    losses)``, the local update (``update``, :func:`build_client_update`);
    ``finish(global_params, prev_genuine, have_genuine, draws,
    broadcast_number, sizes, kept, trained) -> (stacked, sizes,
    new_genuine, ok, mean_loss)``, the attacks, the NaN storm and the
    leak pool.  The round step is ``finish`` of ``train`` of ``prepare``;
    the scenario matrix calls ``train`` once for many runs' clients
    (``matrix/program.py``)."""

    prepare: Callable
    train: Callable
    finish: Callable
    update: Callable


def build_round_halves(model, cfg: Config, train_data: dict[str, torch.Tensor],
                       attack_groups: Sequence[AttackGroup],
                       genuine_idx: Sequence[int],
                       update: Callable | None = None) -> RoundHalves:
    """The halves of :func:`build_round_step` (:class:`RoundHalves`);
    ``update`` is the local update to train with (default: a new
    :func:`build_client_update`)."""
    device = next(iter(train_data.values())).device
    batched_update = update if update is not None else build_client_update(
        model, cfg, train_data)
    genuine_arr = torch.as_tensor(list(genuine_idx), dtype=torch.int64, device=device)
    firing = attacking_groups(attack_groups)
    firing_rows = group_rows(firing, device)
    drop_rate = cfg.client_dropout_rate
    forced_drop_fn = build_client_fault_fn(cfg.faults, cfg.total_clients, "dropout", device)
    nan_storm_fn = build_client_fault_fn(cfg.faults, cfg.total_clients, "nan_storm", device)

    def prepare(draws: RoundDraws, broadcast_number: int):
        sizes, mask, kept = draws.sizes, draws.mask, draws.kept
        if kept is not None:
            sizes, mask = apply_client_dropout(kept, sizes, mask)
        if forced_drop_fn is not None:
            # the plan's cohort drops as a sampled straggler does
            if kept is None:
                kept = torch.ones_like(sizes, dtype=torch.bool)
            kept = kept & ~forced_drop_fn(broadcast_number)
            sizes, mask = apply_client_dropout(kept, sizes, mask)
        return sizes, mask, kept

    def train(global_params: dict, draws: RoundDraws, mask: torch.Tensor):
        return batched_update(global_params, draws.idx, mask, draws.perms, draws.dropout_seed)

    def finish(global_params: dict, prev_genuine: dict, have_genuine: bool | torch.Tensor,
               draws: RoundDraws, broadcast_number: int, sizes: torch.Tensor,
               kept: torch.Tensor | None, trained: tuple):
        # a host bool (the synchronous loop's) as the device flag the
        # fused path carries: a fill, no copy from the host
        if not isinstance(have_genuine, torch.Tensor):
            have_genuine = torch.full((), bool(have_genuine), dtype=torch.bool, device=device)
        stacked, ok, losses = trained
        stacked, ok = scatter_attacks(
            stacked, ok, firing, firing_rows, draws,
            fires=lambda grp: broadcast_number >= grp.attack_round,
            own=lambda ids: pt.tree_broadcast(global_params, ids.numel()),
            prev_genuine=prev_genuine, template=global_params, kept=kept,
            have_genuine=have_genuine)
        if nan_storm_fn is not None:
            stacked, ok = apply_nan_storm(nan_storm_fn(broadcast_number), stacked, ok)

        train_ok = torch.all(ok)
        if kept is None:
            sel = train_ok.expand(len(genuine_idx))
            mean_loss = torch.mean(losses)
        else:
            # a round where every client drops has no update at all: it fails
            train_ok = train_ok & torch.any(kept)
            if drop_rate > 0.0:
                # a dropped genuine client never reports, so its last reported
                # row stays in the leak pool (stale); before any report the
                # pool rows are placeholders and its fresh no-op row is used
                sel = train_ok & (kept[genuine_arr] | ~have_genuine)
            else:
                sel = train_ok.expand(len(genuine_idx))
            keptf = kept.to(losses.dtype)
            mean_loss = torch.sum(losses * keptf) / torch.clamp(torch.sum(keptf), min=1.0)
        fresh = pt.tree_take(stacked, genuine_arr)
        new_genuine = pt.tree_map(lambda n, p: torch.where(_rows(sel, n), n, p),
                                  fresh, prev_genuine)
        return stacked, sizes, new_genuine, train_ok, mean_loss

    return RoundHalves(prepare=prepare, train=train, finish=finish, update=batched_update)


def build_round_step(model, cfg: Config, train_data: dict[str, torch.Tensor],
                     attack_groups: Sequence[AttackGroup],
                     genuine_idx: Sequence[int]) -> Callable:
    """Build ``round_step(global_params, prev_genuine, have_genuine, draws,
    broadcast_number) -> (stacked, sizes, new_genuine, ok, mean_loss)``:
    ``have_genuine`` a bool or a 0-dim bool tensor on the round's device,
    ``ok`` and ``mean_loss`` 0-dim device tensors.  The step reads nothing
    back from the card (on config 4's path; the γ searches still do,
    ROADMAP.md item 3a).  It is ``finish(train(...))``
    of :func:`build_round_halves`.

    ``train_data`` lies on the device the round runs on; the local update
    is :func:`build_client_update`'s."""
    halves = build_round_halves(model, cfg, train_data, attack_groups, genuine_idx)

    def round_step(global_params: dict, prev_genuine: dict,
                   have_genuine: bool | torch.Tensor, draws: RoundDraws,
                   broadcast_number: int):
        sizes, mask, kept = halves.prepare(draws, broadcast_number)
        trained = halves.train(global_params, draws, mask)
        return halves.finish(global_params, prev_genuine, have_genuine, draws,
                             broadcast_number, sizes, kept, trained)

    return round_step


def round_drawer(cfg: Config, attack_groups: Sequence[AttackGroup], num_genuine: int,
                 pool_size: int, num_params: int, test_rows: int,
                 client_pools: torch.Tensor | None = None) -> Callable:
    """``draw(gen, leak_pool=None) -> RoundDraws``: one round's draws for
    ``cfg`` (``data/partition.draw_round``), what the engine's
    ``Simulator.draw_round`` draws; ``test_rows`` is the test set's size
    (FLTrust's root set is its first ``ROOT_SIZE`` rows)."""
    lo, hi = cfg.num_data_range
    firing = attacking_groups(attack_groups)
    leak_k = leak_size(cfg, num_genuine)

    def draw(gen: torch.Generator, leak_pool: torch.Tensor | None = None) -> RoundDraws:
        return draw_round(
            gen, num_clients=cfg.total_clients, pool_size=pool_size,
            lo=lo, hi=hi, epochs=cfg.epochs, num_genuine=num_genuine,
            leak_groups=[len(g.indices) for g in firing], leak_k=leak_k,
            client_pools=client_pools, dropout_rate=cfg.client_dropout_rate,
            noise_groups=[len(g.indices) for g in firing if g.mode == "Random"],
            num_params=num_params, quantize=cfg.mode == "scionfl",
            root_size=min(ROOT_SIZE, test_rows) if cfg.mode == "FLTrust" else 0,
            leak_pool=leak_pool)

    return draw


# FLTrust's root set: the first ROOT_SIZE test samples, trained at batch
# ROOT_BATCH (reference server.py:290-293)
ROOT_SIZE, ROOT_BATCH = 200, 100


def build_aggregator(model, cfg: Config,
                     test_data: dict[str, torch.Tensor] | None = None) -> Callable:
    """``aggregate(global_params, stacked, sizes, weights_mask, draws) ->
    new_global`` for the configured mode (JAX ``round.py:459-513``).

    ``weights_mask`` (C,) soft-excludes clients: the host-side filters'
    rejects (gmm, fltracer) and the clients that did not report.  fedavg,
    fltracer and scionfl weight by ``sizes * weights_mask``; gmm takes the
    unweighted mean over ``weights_mask``.  Under stragglers
    (``client_dropout_rate > 0``) median, trimmed-mean, Krum, ShieldFL and
    byzantine operate over the reporting clients only (``geo_mask``): a
    dropped client's row is the broadcast params and would otherwise vote
    "no change".  ScionFL reads ``draws.uniform``, FLTrust
    ``draws.root_perms`` and ``draws.root_seed``; FLTrust trains its root
    set, the first ``ROOT_SIZE`` rows of ``test_data``, with the autograd
    update (``local.build_root_update``) whatever ``local_backend`` is."""
    mode = cfg.mode
    geo = cfg.client_dropout_rate > 0.0

    def geo_mask(weights_mask):
        return weights_mask if geo else None

    def weighted(sizes, weights_mask):
        return sizes.to(torch.float32) * weights_mask

    if mode in ("fedavg", "fltracer"):
        def aggregate(global_params, stacked, sizes, weights_mask, draws):
            return aggregators.fedavg(stacked, weighted(sizes, weights_mask))
    elif mode == "gmm":
        def aggregate(global_params, stacked, sizes, weights_mask, draws):
            return aggregators.mean_aggregation(stacked, weights_mask)
    elif mode == "median":
        def aggregate(global_params, stacked, sizes, weights_mask, draws):
            return aggregators.median_aggregation(stacked, geo_mask(weights_mask))
    elif mode == "trimmed_mean":
        def aggregate(global_params, stacked, sizes, weights_mask, draws):
            return aggregators.trimmed_mean(stacked, cfg.trim_ratio, geo_mask(weights_mask))
    elif mode == "krum":
        def aggregate(global_params, stacked, sizes, weights_mask, draws):
            return aggregators.krum(stacked, cfg.krum_f, geo_mask(weights_mask))
    elif mode == "shieldfl":
        def aggregate(global_params, stacked, sizes, weights_mask, draws):
            return aggregators.shieldfl(stacked, mask=geo_mask(weights_mask))
    elif mode == "scionfl":
        def aggregate(global_params, stacked, sizes, weights_mask, draws):
            return aggregators.scionfl(stacked, weighted(sizes, weights_mask), draws.uniform)
    elif mode == "byzantine":
        def aggregate(global_params, stacked, sizes, weights_mask, draws):
            return aggregators.byzantine_tolerance(stacked, cfg.byzantine_threshold,
                                                   geo_mask(weights_mask))
    elif mode == "FLTrust":
        if test_data is None:
            raise ValueError("FLTrust requires test data for root training")
        root = {k: v[:ROOT_SIZE] for k, v in test_data.items()}
        root_update = local.build_root_update(
            model, cfg.data_name, root, epochs=cfg.epochs, batch_size=ROOT_BATCH, lr=cfg.lr,
            clip_grad_norm=cfg.clip_grad_norm)

        def aggregate(global_params, stacked, sizes, weights_mask, draws):
            root_params = root_update(global_params, draws.root_perms, draws.root_seed)
            root_delta = pt.tree_map(torch.sub, root_params, global_params)
            deltas = pt.tree_map(lambda s, g: s - g.unsqueeze(0), stacked, global_params)
            return aggregators.fltrust_combine(global_params, deltas, root_delta)
    elif mode == "hyper":
        raise ValueError("hyper mode aggregates by training its hypernetwork: "
                         "training/hyper.build_hyper_update")
    else:
        raise ValueError(f"Server mode '{mode}' is not valid.")
    return aggregate


def build_defense_branches(model, cfg: Config, test_data: dict[str, torch.Tensor] | None,
                           modes: Sequence[str]) -> list[Callable]:
    """One aggregate per mode of ``modes`` (JAX ``build_defense_branches``,
    round.py:516-531), each built by :func:`build_aggregator` under the base
    config with only the mode swapped: the defense knobs (krum_f,
    trim_ratio, byzantine_threshold) every standalone run of that mode
    reads.  The scenario matrix calls a cell's branch directly."""
    return [build_aggregator(model, cfg.replace(mode=mode), test_data) for mode in modes]


def build_attribution_fn(model, cfg: Config,
                         test_data: dict[str, torch.Tensor] | None = None) -> Callable | None:
    """The defense's per-client verdict (JAX ``build_attribution_fn``,
    round.py:534-641): ``attribution(global_params, stacked, sizes,
    weights_mask, draws) -> (keep [C] bool, scores [C] float)``, device
    tensors.

    It recomputes the decision the aggregate applies, from the same
    round's ``draws`` (ScionFL's ``uniform``, FLTrust's ``root_perms`` and
    ``root_seed``): it draws nothing, so the rounds after it see the same
    generator.  Krum keeps its selected client, ShieldFL the clients
    weighted at least half an average share, ScionFL and byzantine the
    clients of positive weight, FLTrust those of positive trust.
    Trimmed-mean and median keep a client whose share of coordinates
    inside the kept window (its survival fraction) is at least half the
    nominal share.  None for modes with no such decision (fedavg, and
    gmm and fltracer, whose host filter is the decision)."""
    mode = cfg.mode
    n = cfg.total_clients
    geo = cfg.client_dropout_rate > 0.0

    if mode == "krum":
        def attribution(global_params, stacked, sizes, weights_mask, draws):
            sel = aggregators.krum_select(stacked, cfg.krum_f, weights_mask if geo else None)
            keep = torch.zeros(n, dtype=torch.bool, device=sizes.device)
            keep[sel] = True
            return keep, keep.to(torch.float32)
    elif mode in ("trimmed_mean", "median"):
        ratio = cfg.trim_ratio

        def attribution(global_params, stacked, sizes, weights_mask, draws):
            flat = pt.tree_ravel_stacked(stacked)
            mask = weights_mask if geo else torch.ones(n, dtype=flat.dtype, device=flat.device)
            valid = mask > 0
            v = torch.sum(mask).to(torch.int64)
            if mode == "median":
                lo = torch.div(v - 1, 2, rounding_mode="floor")
                hi = lo + 1
            else:
                kd = torch.floor(v.to(torch.float32) * ratio).to(torch.int64)
                lo, hi = kd, v - kd
            # each client's rank per coordinate, masked rows sorted last as
            # the aggregator's +inf sentinel sorts them
            order = torch.argsort(torch.where(valid[:, None], flat, torch.inf), dim=0,
                                  stable=True)
            ranks = torch.argsort(order, dim=0, stable=True)
            frac = torch.mean(((ranks >= lo) & (ranks < hi)).to(torch.float32), dim=1)
            nominal = (hi - lo).to(torch.float32) / torch.clamp(v, min=1).to(torch.float32)
            return (frac >= 0.5 * nominal) & valid, frac
    elif mode == "shieldfl":
        def attribution(global_params, stacked, sizes, weights_mask, draws):
            weights = aggregators.shieldfl_weights(stacked, mask=weights_mask if geo else None)
            valid = (weights_mask > 0 if geo
                     else torch.ones(n, dtype=torch.bool, device=weights.device))
            mean_w = torch.sum(weights * valid) / torch.clamp(torch.sum(valid), min=1)
            return (weights >= 0.5 * mean_w) & valid, weights
    elif mode == "scionfl":
        def attribution(global_params, stacked, sizes, weights_mask, draws):
            weights = aggregators.scionfl_weights(
                stacked, sizes.to(torch.float32) * weights_mask, draws.uniform)
            return weights > 0, weights
    elif mode == "byzantine":
        def attribution(global_params, stacked, sizes, weights_mask, draws):
            keep = aggregators.byzantine_keep(stacked, cfg.byzantine_threshold,
                                              weights_mask if geo else None)
            return keep > 0, keep
    elif mode == "FLTrust":
        if test_data is None:
            return None
        root = {k: v[:ROOT_SIZE] for k, v in test_data.items()}
        root_update = local.build_root_update(
            model, cfg.data_name, root, epochs=cfg.epochs, batch_size=ROOT_BATCH, lr=cfg.lr,
            clip_grad_norm=cfg.clip_grad_norm)

        def attribution(global_params, stacked, sizes, weights_mask, draws):
            root_params = root_update(global_params, draws.root_perms, draws.root_seed)
            root_delta = pt.tree_map(torch.sub, root_params, global_params)
            deltas = pt.tree_map(lambda s, g: s - g.unsqueeze(0), stacked, global_params)
            trust = aggregators.fltrust_trust(deltas, root_delta)
            return trust > 0, trust
    else:
        return None
    return attribution
