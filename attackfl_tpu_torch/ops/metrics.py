"""Device-side numerics: the on-device half of the numerics ring (the
port's copy of ``attackfl_tpu/ops/metrics.py``).

One ``(M,)`` float32 row a round, computed on the card from the round's
client updates and the server params before and after its accepted
outcome: per-cohort update-norm distributions, the genuine-vs-malicious
separation, the global weight norm and drift, the loss and its change,
non-finite provenance (count, clients, first poisoned layer) and a
fixed-bucket histogram of the update norms.  The row is written into a
ring buffer carried in the simulation state.

Nothing here reads a value of the card on the host: every index, count
and select stays a device tensor (an index is picked with
``index_select``, the histogram is a one-hot sum, the ring write an
``index_copy`` at ``cursor % window``), and host scalars enter as fills,
not copies.  The host half, the k-rounds-late drainer that turns ring
rows into ``metric`` events, is :mod:`attackfl_tpu_torch.telemetry.numerics`.

The layout is resolved once per configuration into a static slot
:class:`MetricsLayout`, and the step draws no randomness and writes no
tensor it is given, so turning it on cannot change the params.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from attackfl_tpu_torch.ops import pytree as pt

# Fixed log-spaced histogram bucket edges for per-client update norms.
# 15 internal edges -> 16 buckets: (-inf, 1e-3), [1e-3, ..), ..,
# [1e3, inf).  Static, so rows of different rounds and runs compare.
HIST_EDGES = tuple(np.logspace(-3.0, 3.0, 15).tolist())
NUM_HIST_BUCKETS = len(HIST_EDGES) + 1


@dataclass(frozen=True)
class MetricsLayout:
    """Static slot layout of one numerics row (host-side metadata only).

    A row is ``len(names)`` scalar gauge slots followed by
    ``NUM_HIST_BUCKETS`` histogram-count slots.  ``leaf_names`` maps the
    ``first_nonfinite_leaf`` slot's index back to a parameter-tree layer
    name; ``cohorts`` records which client cohorts have update-norm
    distribution slots.
    """

    names: tuple[str, ...]
    leaf_names: tuple[str, ...]
    cohorts: tuple[str, ...]
    hist_edges: tuple[float, ...] = field(default=HIST_EDGES)

    @property
    def size(self) -> int:
        return len(self.names) + NUM_HIST_BUCKETS

    def index(self, name: str) -> int:
        return self.names.index(name)


def build_layout(params_template, has_attackers: bool) -> MetricsLayout:
    """Resolve the metric registry for one configuration.

    ``params_template`` is the (unstacked) client or target params tree;
    only its leaf paths are read, in the JAX package's leaf order
    ("a/b/kernel").  ``has_attackers`` adds the malicious cohort and the
    separation-margin slots.
    """
    leaf_names = tuple(path for path, _ in pt.tree_items(params_template))
    cohorts = ("all", "genuine") + (("malicious",) if has_attackers else ())
    names: list[str] = ["broadcast", "ok", "train_loss", "loss_delta"]
    for cohort in cohorts:
        names += [f"update_norm_{cohort}_p50", f"update_norm_{cohort}_p95",
                  f"update_norm_{cohort}_max"]
    if has_attackers:
        names += ["sep_cosine", "sep_l2", "sep_margin"]
    names += ["global_norm", "global_drift",
              "nonfinite_count", "nonfinite_clients", "first_nonfinite_leaf"]
    return MetricsLayout(tuple(names), leaf_names, cohorts)


def masked_distribution(values: torch.Tensor, mask: torch.Tensor):
    """p50 / p95 / max of ``values[mask]`` with a device mask and static
    shapes: masked entries sort to +inf, percentiles use numpy's linear
    interpolation over the first ``n = sum(mask)`` sorted entries.  An
    empty cohort yields NaN on every statistic.
    """
    c = values.shape[0]
    n = torch.sum(mask.to(torch.int32))
    order = torch.sort(torch.where(mask, values, torch.inf)).values

    def pick(i):
        return order.index_select(0, torch.clamp(i, 0, c - 1).reshape(1)).reshape(())

    def pct(q):
        rank = (n - 1).to(torch.float32) * q
        lo = torch.floor(rank).to(torch.int64)
        hi = torch.minimum(lo + 1, n - 1)
        frac = rank - lo.to(torch.float32)
        value = pick(lo) * (1.0 - frac) + pick(hi) * frac
        return torch.where(n > 0, value, torch.nan)

    maximum = torch.where(n > 0, pick(n - 1), torch.nan)
    return pct(0.5), pct(0.95), maximum


def _leaves(tree) -> list[torch.Tensor]:
    """A params tree's leaves in the layout's order; a flat tensor (the
    hypernetwork's parameter vector) is its own one leaf."""
    return [tree] if isinstance(tree, torch.Tensor) else pt.tree_leaves(tree)


class Numerics:
    """The numerics step of one Simulator configuration.

    ``genuine_mask`` / ``attacker_mask`` are host (C,) bool arrays, the
    static attacker geometry, placed on ``device`` once here together
    with the histogram edges.  ``window`` is the ring's depth: the host
    drainer may resolve rows up to ``window`` rounds late; older rows are
    overwritten (counted, see
    :class:`attackfl_tpu_torch.telemetry.numerics.NumericsDrainer`).
    """

    def __init__(self, layout: MetricsLayout, genuine_mask, attacker_mask,
                 window: int, device: torch.device | str = "cpu"):
        self.layout = layout
        self.device = torch.device(device)
        self.has_attackers = bool(np.any(attacker_mask))
        self.window = int(window)
        self._genuine = torch.as_tensor(np.asarray(genuine_mask, bool), device=self.device)
        self._attacker = torch.as_tensor(np.asarray(attacker_mask, bool), device=self.device)
        self._edges = torch.tensor(layout.hist_edges, dtype=torch.float32, device=self.device)
        self._buckets = torch.arange(NUM_HIST_BUCKETS, device=self.device)

    def _scalar(self, value) -> torch.Tensor:
        """A 0-dim float32 device tensor: a tensor cast, a host number
        filled (a fill, never a copy from the host)."""
        if isinstance(value, torch.Tensor):
            return value.to(torch.float32)
        return torch.full((), float(value), dtype=torch.float32, device=self.device)

    # ------------------------------------------------------------------
    # ring buffer
    # ------------------------------------------------------------------

    def init_state(self) -> dict:
        """A fresh ring, carried in the round state."""
        return {
            "buffer": torch.full((self.window, self.layout.size), torch.nan,
                                 dtype=torch.float32, device=self.device),
            "cursor": torch.zeros((), dtype=torch.int32, device=self.device),
            "prev_loss": torch.full((), torch.nan, dtype=torch.float32, device=self.device),
        }

    def write(self, num_state: dict, row: torch.Tensor, loss) -> dict:
        """Write one row at ``cursor % window`` and advance the cursor (the
        cursor's host mirror is the drainer's round count).  The ring
        given is left as it was."""
        cursor = num_state["cursor"]
        slot = torch.remainder(cursor, self.window).to(torch.int64).reshape(1)
        buffer = num_state["buffer"].index_copy(0, slot, row[None, :])
        return {"buffer": buffer, "cursor": cursor + 1, "prev_loss": self._scalar(loss)}

    # ------------------------------------------------------------------
    # the metric row
    # ------------------------------------------------------------------

    def compute_row(self, base, old_ref, new_ref, stacked, sizes,
                    prev_loss, loss, ok, broadcast) -> torch.Tensor:
        """One round's (M,) float32 metrics row.

        ``base`` is the reference the per-client updates are measured
        against, with the same leaves as ``stacked``: the global params
        (leaves broadcast across the client axis) on the plain path, or
        the per-client generated params (stacked leaves) in hyper mode.
        ``old_ref`` / ``new_ref`` are the server-side params (global or
        hypernetwork) before and after the round's ACCEPTED outcome, so a
        failed round shows zero drift.

        The reductions stream LEAF BY LEAF, never building the (C, P)
        update matrix.  Pass 1 is a bare Σd² per (leaf, client): a
        non-finite element makes its leaf's partial sum non-finite, so
        the (L, C) partial sums double as the provenance signal at
        (client, layer) granularity.  Pass 2 (attacked runs only) folds
        the genuine and malicious cohort means into three Gram scalars,
        from which the cosine and L2 separation follow without a mean
        vector.
        """
        layout = self.layout
        leaves = _leaves(stacked)
        base_leaves = _leaves(base)
        c = leaves[0].shape[0]
        reporting = sizes > 0

        # ---- pass 1: per-(leaf, client) Σd² --------------------------------
        sq_mat = torch.stack([
            torch.sum(torch.square((x - b).to(torch.float32).reshape(c, -1)), dim=1)
            for x, b in zip(leaves, base_leaves)])  # (L, C)
        # a poisoned (leaf, client) block contributes 0 to the client's
        # norm; the client leaves every cohort through `valid` and shows
        # in the provenance slots instead
        leaf_finite = torch.isfinite(sq_mat)
        norms = torch.sqrt(torch.sum(torch.where(leaf_finite, sq_mat, 0.0), dim=0))
        bad_mat = ~leaf_finite
        leaf_bad = torch.sum(bad_mat, dim=1)        # (L,) clients hit a leaf
        bad_per_client = torch.sum(bad_mat, dim=0)  # (C,) leaves hit a client
        finite = bad_per_client == 0
        valid = reporting & finite

        genuine = valid & self._genuine
        train_loss = self._scalar(loss)
        slots: dict[str, torch.Tensor] = {
            "broadcast": self._scalar(broadcast),
            "ok": self._scalar(ok),
            "train_loss": train_loss,
            "loss_delta": train_loss - prev_loss,
        }
        cohort_masks = {"all": valid, "genuine": genuine}
        if self.has_attackers:
            cohort_masks["malicious"] = valid & self._attacker
        for cohort in layout.cohorts:
            p50, p95, mx = masked_distribution(norms, cohort_masks[cohort])
            slots[f"update_norm_{cohort}_p50"] = p50
            slots[f"update_norm_{cohort}_p95"] = p95
            slots[f"update_norm_{cohort}_max"] = mx

        if self.has_attackers:
            malicious = cohort_masks["malicious"]
            n_gen = torch.sum(genuine.to(torch.float32))
            n_mal = torch.sum(malicious.to(torch.float32))
            # ---- pass 2: cohort mean geometry as Gram scalars --------------
            # s_x = Σ_c mask_c · d_c, so every separation quantity is a
            # function of <s_gen,s_gen>, <s_mal,s_mal>, <s_gen,s_mal>; an
            # invalid client's row is zeroed (a 0-weight dot against a NaN
            # row would still be NaN)
            weights = torch.stack([genuine.to(torch.float32), malicious.to(torch.float32)])
            gram = torch.zeros((2, 2), dtype=torch.float32, device=norms.device)
            for x, b in zip(leaves, base_leaves):
                d = (x - b).to(torch.float32).reshape(c, -1)
                s = weights @ torch.where(valid[:, None], d, 0.0)
                gram = gram + s @ s.T
            gg, gm, mm = gram[0, 0], gram[0, 1], gram[1, 1]
            both = (n_gen > 0) & (n_mal > 0)
            cos = gm / torch.clamp(torch.sqrt(gg * mm), min=1e-30)  # scale-free
            l2_sq = (gg / torch.clamp(n_gen, min=1.0) ** 2
                     - 2.0 * gm / torch.clamp(n_gen * n_mal, min=1.0)
                     + mm / torch.clamp(n_mal, min=1.0) ** 2)
            gen_norm = torch.sum(norms * genuine.to(norms.dtype)) / torch.clamp(n_gen, min=1.0)
            mal_norm = torch.sum(norms * malicious.to(norms.dtype)) / torch.clamp(n_mal, min=1.0)
            slots["sep_cosine"] = torch.where(both, cos, torch.nan)
            slots["sep_l2"] = torch.where(both, torch.sqrt(torch.clamp(l2_sq, min=0.0)),
                                          torch.nan)
            # how much louder the attacker cohort is than the genuine one
            slots["sep_margin"] = torch.where(both, mal_norm - gen_norm, torch.nan)

        # server-side norms: per-leaf sums, again without a concat
        new_leaves, old_leaves = _leaves(new_ref), _leaves(old_ref)
        new_sq = sum(torch.sum(torch.square(x.to(torch.float32))) for x in new_leaves)
        drift_sq = sum(torch.sum(torch.square(n.to(torch.float32) - o.to(torch.float32)))
                       for n, o in zip(new_leaves, old_leaves))
        slots["global_norm"] = torch.sqrt(new_sq)
        slots["global_drift"] = torch.sqrt(drift_sq)

        # non-finite provenance: total (client, layer) hits, the clients
        # hit, and the FIRST leaf holding one (layout.leaf_names names it)
        total_bad = torch.sum(leaf_bad)
        slots["nonfinite_count"] = total_bad
        slots["nonfinite_clients"] = torch.sum(reporting & ~finite)
        slots["first_nonfinite_leaf"] = torch.where(
            total_bad > 0, torch.argmax((leaf_bad > 0).to(torch.float32)), -1)

        scalar = torch.stack([slots[name].to(torch.float32) for name in layout.names])
        bucket = torch.searchsorted(self._edges, norms.to(torch.float32), right=True)
        hist = torch.sum((bucket[:, None] == self._buckets[None, :]).to(torch.float32)
                         * valid[:, None].to(torch.float32), dim=0)
        return torch.cat([scalar, hist])

    def step(self, num_state, base, old_ref, new_ref, stacked, sizes, loss, ok, broadcast):
        """compute_row and the ring write in one call.  Returns
        ``(new_num_state, row)``: the fused and pipelined paths surface the
        row through their metrics (read by the path's existing late copy),
        the synchronous path drains the ring in batches."""
        row = self.compute_row(base, old_ref, new_ref, stacked, sizes,
                               num_state["prev_loss"], loss, ok, broadcast)
        return self.write(num_state, row, loss), row
