"""Robust aggregation rules over the stacked client axis (the port's
``attackfl_tpu/ops/aggregators.py``).

Each aggregator is a plain function ``(stacked, ...) -> params`` on the
port's stacked dicts.  The per-element rules (median, trimmed mean) run on
the flat ``(C, P)`` matrix of ``pytree.tree_ravel_stacked``, one sort for
the whole model; the rest reduce per leaf or over the flat rows as the JAX
package does.  Data-dependent counts (valid clients, the trim window, the
chosen index) stay device tensors, so no aggregator waits on the card.
"""

from __future__ import annotations

import torch

from attackfl_tpu_torch.ops import pytree as pt

# Element budget of one chunk of Krum's pairwise differences: all at once
# they are (C, C, P) floats, 1.9 GB at config 4 and 191 GB at 1000
# clients.  Rows are processed in chunks that stay under this many
# elements (~800 MB f32).
KRUM_DIFF_BUDGET = int(2e8)


def fedavg(stacked: dict, sizes: torch.Tensor) -> dict:
    """Size-weighted mean (reference avg_all_parameters, server.py:751-775)."""
    return pt.tree_weighted_mean(stacked, sizes.to(torch.float32))


def mean_aggregation(stacked: dict, mask: torch.Tensor | None = None) -> dict:
    """Unweighted mean of the (optionally mask-selected) clients (reference
    avg_selected_parameters, server.py:777-797; gmm's survivors)."""
    if mask is None:
        return pt.tree_mean(stacked)
    return pt.tree_weighted_mean(stacked, mask)


def _per_element(fn, stacked: dict) -> dict:
    """``fn(flat (C, P)) -> (P,)`` as a tree shaped like one client."""
    out = fn(pt.tree_ravel_stacked(stacked))
    template = pt.tree_map(lambda x: x[0], stacked)
    return pt.tree_map(torch.clone, pt.unraveler(template)(out))


def _row_mask(mask: torch.Tensor) -> torch.Tensor:
    """A (C,) client mask as a (C, 1) bool column of the flat matrix."""
    return mask.to(torch.bool)[:, None]


def _valid_bad(mask: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    """Per element: some VALID client holds a non-finite value.  The
    masked rules sort masked rows to +inf and neutralise only those
    sentinels; a diverged valid client must poison the aggregate, as it
    would unmasked."""
    return torch.any(~torch.isfinite(flat) & _row_mask(mask), dim=0)


def _valid_count(mask: torch.Tensor) -> torch.Tensor:
    return torch.sum(mask).to(torch.int64)


def median_aggregation(stacked: dict, mask: torch.Tensor | None = None) -> dict:
    """Per-element median across clients (reference median_aggregation,
    src/Utils.py:344-357): the lower middle ``sorted[(n - 1) // 2]``, as
    torch.median picks, by sort and index so that a NaN row sorts last
    instead of propagating.  With ``mask`` (C,) the masked rows sort to
    +inf and the index is taken over the valid count."""
    if mask is None:
        def med(flat):
            return torch.sort(flat, dim=0).values[(flat.shape[0] - 1) // 2]
    else:
        def med(flat):
            sorted_x = torch.sort(torch.where(_row_mask(mask), flat, torch.inf), dim=0).values
            # v = 0 never reaches here (the engine fails such rounds); the
            # clamp keeps the index in range, where every entry is +inf
            at = torch.clamp(torch.div(_valid_count(mask) - 1, 2, rounding_mode="floor"),
                             min=0)
            out = torch.index_select(sorted_x, 0, at.reshape(1))[0]
            return torch.where(_valid_bad(mask, flat), torch.nan, out)
    return _per_element(med, stacked)


def trimmed_mean(stacked: dict, trim_ratio: float = 0.1,
                 mask: torch.Tensor | None = None) -> dict:
    """Per-element sort, drop k = floor(n * ratio) at each end, mean the
    rest (reference trimmed_mean_aggregation, src/Utils.py:267-302).

    With ``mask`` the trim runs over the valid rows (masked rows sort to
    +inf) with a window of device tensors; an over-trimmed valid count
    (2k >= v) gives 0/0 = NaN, which fails the round downstream."""
    n = pt.tree_leaves(stacked)[0].shape[0]
    if mask is None:
        k = int(n * trim_ratio)
        if 2 * k >= n:
            raise ValueError("Too few clients for the chosen trim ratio.")

        def trim(flat):
            return torch.mean(torch.sort(flat, dim=0).values[k:n - k], dim=0)
    else:
        def trim(flat):
            v = _valid_count(mask)
            # float32 product, as the JAX package's int32 * python float
            kd = torch.floor(v.to(torch.float32) * trim_ratio).to(torch.int64)
            sorted_x = torch.sort(torch.where(_row_mask(mask), flat, torch.inf), dim=0).values
            i = torch.arange(n, device=flat.device)[:, None]
            w = ((i >= kd) & (i < v - kd)).to(flat.dtype)
            finite = torch.where(torch.isfinite(sorted_x), sorted_x, 0.0)
            out = torch.sum(finite * w, dim=0) / (v - 2 * kd).to(flat.dtype)
            return torch.where(_valid_bad(mask, flat), torch.nan, out)
    return _per_element(trim, stacked)


def pairwise_sq_distances(flat: torch.Tensor) -> torch.Tensor:
    """(N, N) squared L2 distances between the rows of ``flat`` (N, P)
    from direct differences, as the JAX package forms them.  Rows one
    local step apart from the same broadcast differ little against a
    large |w|, where the Gram form |a|^2 + |b|^2 - 2ab (torch.cdist's for
    large inputs) cancels.  Chunked by ``KRUM_DIFF_BUDGET``."""
    n, p = flat.shape
    chunk = max(1, KRUM_DIFF_BUDGET // max(n * p, 1))
    parts = [torch.sum(torch.square(flat[i:i + chunk, None, :] - flat[None, :, :]), dim=-1)
             for i in range(0, n, chunk)]
    return torch.cat(parts, dim=0)


def krum_select(stacked: dict, f: int = 0, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Krum's argmin (Blanchard et al. 2017) as a 0-d device tensor:
    score_i = sum of the n - f - 2 smallest squared distances to the other
    clients (reference krum, src/Utils.py:326-342).

    With ``mask`` (C,) dropped clients are excluded on both sides: their
    distances sort last outside a window of v - f - 2 over the valid count
    v, and they are never chosen.  A candidate whose own params are
    non-finite gets an infinite score (JAX aggregators.py:150-164)."""
    flat = pt.tree_ravel_stacked(stacked)
    n = flat.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=flat.device)
    sq = torch.where(eye, torch.inf, pairwise_sq_distances(flat))
    if mask is None:
        closest = torch.sort(sq, dim=1).values[:, :max(n - f - 2, 1)]
        return torch.argmin(torch.sum(closest, dim=1))
    valid = mask.to(torch.bool)
    m_neigh = torch.clamp(_valid_count(mask) - f - 2, min=1)
    sorted_sq = torch.sort(torch.where(valid[None, :], sq, torch.inf), dim=1).values
    w = (torch.arange(n, device=flat.device)[None, :] < m_neigh).to(flat.dtype)
    finite = torch.where(torch.isfinite(sorted_sq), sorted_sq, 0.0)
    scores = torch.sum(finite * w, dim=1)
    bad = torch.any(~torch.isfinite(flat), dim=1)
    scores = torch.where(bad, torch.inf, scores)
    return torch.argmin(torch.where(valid, scores, torch.inf))


def krum(stacked: dict, f: int = 0, mask: torch.Tensor | None = None) -> dict:
    """The selected client's parameter tree."""
    at = krum_select(stacked, f, mask).reshape(1)
    return pt.tree_map(lambda x: torch.index_select(x, 0, at)[0], stacked)


def _cosine(rows: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """cos(rows_i, ref) with the JAX package's +1e-12 in the denominator."""
    return (rows @ ref) / (torch.linalg.vector_norm(rows, dim=1)
                           * torch.linalg.vector_norm(ref) + 1e-12)


def shieldfl_weights(stacked: dict, eps: float = 1e-6,
                     mask: torch.Tensor | None = None) -> torch.Tensor:
    """ShieldFL's per-client weights: unit client vectors, reference =
    their (masked) mean, weight_i = 1 / (1 - cos_i + eps), zero where
    masked."""
    flat = pt.tree_ravel_stacked(stacked)
    unit = flat / (torch.linalg.vector_norm(flat, dim=1, keepdim=True) + 1e-8)
    if mask is None:
        ref = torch.mean(unit, dim=0)
    else:
        ref = torch.sum(unit * mask[:, None], dim=0) / torch.clamp(torch.sum(mask), min=1.0)
    weights = 1.0 / (1.0 - _cosine(unit, ref) + eps)
    return weights if mask is None else weights * mask


def shieldfl(stacked: dict, eps: float = 1e-6, mask: torch.Tensor | None = None) -> dict:
    """ShieldFL-style cosine-deviation weighting (reference inline code,
    server.py:306-350): the weighted mean under :func:`shieldfl_weights`."""
    return pt.tree_weighted_mean(stacked, shieldfl_weights(stacked, eps, mask))


def byzantine_keep(stacked: dict, threshold: float = 0.9,
                   mask: torch.Tensor | None = None) -> torch.Tensor:
    """The byzantine-tolerance keep weights: cosine against the anchor (the
    first valid client) at least ``threshold``; all valid clients when
    none passes; all clients, unweighted, when every client is masked."""
    flat = pt.tree_ravel_stacked(stacked)
    maskf = (torch.ones(flat.shape[0], dtype=flat.dtype, device=flat.device)
             if mask is None else mask.to(flat.dtype))
    anchor = torch.index_select(flat, 0, torch.argmax(maskf).reshape(1))[0]
    keep = (_cosine(flat, anchor) >= threshold).to(flat.dtype) * maskf
    keep = torch.where(torch.sum(keep) > 0, keep, maskf)
    return torch.where(torch.sum(maskf) > 0, keep, torch.ones_like(maskf))


def byzantine_tolerance(stacked: dict, threshold: float = 0.9,
                        mask: torch.Tensor | None = None) -> dict:
    """Cosine-threshold filter and unweighted mean of the survivors
    (reference byzantine_tolerance_aggregation, src/Utils.py:228-248)."""
    return pt.tree_weighted_mean(stacked, byzantine_keep(stacked, threshold, mask))


# ---------------------------------------------------------------------------
# ScionFL
# ---------------------------------------------------------------------------

def quantize_vector(uniform: torch.Tensor, vec: torch.Tensor):
    """Stochastic 1-bit quantization of each row of ``vec`` (N, P)
    (reference quantize_vector, src/Utils.py:372-376): bit = ``uniform <
    probs`` on the min-max-normalised values, which is
    ``jax.random.bernoulli`` given its uniforms.  Returns (sigma, smin,
    smax), the last two (N,)."""
    smin, smax = torch.amin(vec, dim=1), torch.amax(vec, dim=1)
    probs = (vec - smin[:, None]) / (smax - smin + 1e-6)[:, None]
    return (uniform < probs).to(vec.dtype), smin, smax


def quantized_l2(sigma: torch.Tensor, smin: torch.Tensor, smax: torch.Tensor) -> torch.Tensor:
    """L2 norm of each dequantized row from its bit counts (reference
    l2_norm, src/Utils.py:378-381)."""
    ones = torch.sum(sigma, dim=1)
    zeros = sigma.shape[1] - ones
    return torch.sqrt(zeros * torch.square(smin) + ones * torch.square(smax))


def dequantize(sigma: torch.Tensor, smin: torch.Tensor, smax: torch.Tensor) -> torch.Tensor:
    return smin[:, None] + sigma * (smax - smin)[:, None]


def scionfl_distances(stacked: dict, uniform: torch.Tensor,
                      mu_threshold: float = 3.0) -> torch.Tensor:
    """Each client's cosine distance (C,) to the mean dequantized direction:
    quantize with the (C, P) ``uniform`` draw, clip the norms at
    ``mu_threshold`` x their mean, dequantize."""
    flat = pt.tree_ravel_stacked(stacked)
    sigma, smin, smax = quantize_vector(uniform, flat)
    l2 = quantized_l2(sigma, smin, smax)
    l2_avg = torch.mean(l2)
    factor = torch.where(l2 > mu_threshold * l2_avg, (mu_threshold * l2_avg) / l2, 1.0)
    deq = dequantize(sigma, smin * factor, smax * factor)
    return 1.0 - _cosine(deq, torch.mean(deq, dim=0))


def scionfl_threshold(dist: torch.Tensor, topk_ratio: float = 0.5) -> torch.Tensor:
    """The reference's cut: the distances sorted descending, the element at
    ``int(topk_ratio * n)``."""
    n = dist.shape[0]
    return torch.sort(dist).values.flip(0)[min(int(topk_ratio * n), n - 1)]


def scionfl_weights(stacked: dict, sizes: torch.Tensor, uniform: torch.Tensor,
                    mu_threshold: float = 3.0, topk_ratio: float = 0.5) -> torch.Tensor:
    """ScionFL's per-client weights: keep the clients whose
    :func:`scionfl_distances` lie ABOVE :func:`scionfl_threshold`, the
    most dissimilar ones, as the reference does (server.py:466; JAX
    aggregators.py:294-296).  Their sizes are the weights; all sizes when
    the filter empties."""
    dist = scionfl_distances(stacked, uniform, mu_threshold)
    sizes = sizes.to(torch.float32)
    weights = torch.where(dist > scionfl_threshold(dist, topk_ratio), sizes, 0.0)
    return torch.where(torch.sum(weights) > 0, weights, sizes)


def scionfl(stacked: dict, sizes: torch.Tensor, uniform: torch.Tensor,
            mu_threshold: float = 3.0, topk_ratio: float = 0.5) -> dict:
    """ScionFL aggregation (reference server.py:436-492): the size-weighted
    mean under :func:`scionfl_weights`."""
    return pt.tree_weighted_mean(
        stacked, scionfl_weights(stacked, sizes, uniform, mu_threshold, topk_ratio))


# ---------------------------------------------------------------------------
# FLTrust combine (the root training is training/local.build_root_update)
# ---------------------------------------------------------------------------

def _flat_root(root_delta: dict) -> torch.Tensor:
    return torch.cat([x.reshape(-1) for x in pt.tree_leaves(root_delta)])


def fltrust_trust(client_deltas: dict, root_delta: dict) -> torch.Tensor:
    """trust_i = ReLU(cos(delta_i, delta_root)); 0 for an all-zero delta
    (a dropped client), through the +1e-12."""
    return torch.clamp(_cosine(pt.tree_ravel_stacked(client_deltas), _flat_root(root_delta)),
                       min=0.0)


def fltrust_combine(global_params: dict, client_deltas: dict, root_delta: dict) -> dict:
    """Trust-weighted combination (reference train_FLTrust,
    server.py:703-743): each client delta scaled to the root delta's norm,
    global += sum_i trust_i scaled_i / (sum trust + 1e-6)."""
    trust = fltrust_trust(client_deltas, root_delta)
    norm_root = torch.linalg.vector_norm(_flat_root(root_delta))
    norms = torch.linalg.vector_norm(pt.tree_ravel_stacked(client_deltas), dim=1)
    scale = (norm_root / (norms + 1e-6)) * trust
    total = torch.sum(trust) + 1e-6

    def combine(g, d):
        s = scale.reshape((-1,) + (1,) * (d.ndim - 1))
        return g + torch.sum(d * s, dim=0) / total

    return pt.tree_map(combine, global_params, client_deltas)
