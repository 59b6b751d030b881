"""Model-poisoning attacks on stacked parameter trees (the port's
``attackfl_tpu/ops/attacks.py``).

Each attack is a function of the leaked genuine models, stacked on axis
``dim`` of every leaf; the axes before ``dim`` are a batch (one entry per
attacker in the round step), so one call serves a chunk of attackers.

Parity notes, as in the JAX package:
* distances are the reference's ``compute_distance``, a SUM of per-leaf
  norms (``ops/pytree.ref_distance``), Frobenius unless
  ``matrix_spectral``;
* statistics use the Bessel-corrected std (Utils.py:90);
* the γ search returns the candidate of the LAST iteration whether or not
  it was accepted (Utils.py:118-131,152-165,190-203), and judges the
  candidates against the unmodified genuine set.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from attackfl_tpu_torch.ops import pytree as pt

DEFAULT_RANDOM_SIGMA = 1e6  # reference Utils.py:52
DEFAULT_LIE_Z = 0.74  # reference Utils.py:207
DEFAULT_GAMMA = 50.0  # reference Utils.py:101,135,169
DEFAULT_TAU = 1.0


def random_attack(own_params: Any, noise: Any,
                  perturbation: float = DEFAULT_RANDOM_SIGMA) -> Any:
    """``own + noise * perturbation`` leafwise, with ``noise`` standard
    normal (reference create_random_base_model, Utils.py:52-57).  The
    noise is drawn by the caller (``RoundDraws.noise``) and may carry a
    leading attacker axis."""
    return pt.tree_map(lambda p, z: p + z * perturbation, own_params, noise)


def lie_attack(genuine_stacked: dict, z: float = DEFAULT_LIE_Z, dim: int = 0) -> dict:
    """Little-Is-Enough: per-element mean + z * std (Bessel) over the
    leaked models on ``dim`` (reference create_LIE_state_dict,
    Utils.py:207-214)."""
    mean = pt.tree_mean(genuine_stacked, dim=dim)
    std = pt.tree_std(genuine_stacked, dim=dim, ddof=1)
    return pt.tree_map(lambda m, s: m + z * s, mean, std)


def _gamma_search(genuine_stacked: dict, perturbation: dict, threshold: torch.Tensor,
                  statistic: Callable[[dict], torch.Tensor], gamma0: float, tau: float,
                  dim: int = 0, trace: list | None = None) -> dict:
    """The γ binary search (reference loop shape, Utils.py:115-131),
    batched over the axes before ``dim``.

    A candidate ``mean - γ·perturbation`` is accepted when
    ``statistic(candidate) < threshold``; accepted, γ grows by half the
    step, else it shrinks by it, and the step halves.  A row stops once
    ``|γ_succ - γ| <= tau``; the loop runs until every row has stopped
    and freezes a stopped row's carry, as JAX's ``while_loop`` under
    ``vmap`` does.  γ, γ_succ and the step are float32, as in JAX.
    Returns the candidate of each row's last iteration.  ``trace``, if
    given, receives ``(γ, statistic, active rows)`` per iteration."""
    mean = pt.tree_mean(genuine_stacked, dim=dim)
    shape, device = threshold.shape, threshold.device

    def candidate_for(gamma):
        def one(m, p):
            return m - gamma.reshape(shape + (1,) * (m.ndim - len(shape))) * p
        return pt.tree_map(one, mean, perturbation)

    gamma = torch.full(shape, gamma0, dtype=torch.float32, device=device)
    succ = torch.zeros(shape, dtype=torch.float32, device=device)
    step = torch.full(shape, gamma0, dtype=torch.float32, device=device)
    last = torch.full(shape, gamma0, dtype=torch.float32, device=device)
    active = torch.abs(succ - gamma) > tau
    while bool(torch.any(active)):
        stat = statistic(candidate_for(gamma))
        if trace is not None:
            trace.append((gamma.clone(), stat.clone(), active.clone()))
        ok = stat < threshold
        half = step / 2.0
        new_gamma = torch.where(ok, gamma + half, gamma - half)
        succ = torch.where(active & ok, gamma, succ)
        last = torch.where(active, gamma, last)
        step = torch.where(active, half, step)
        gamma = torch.where(active, new_gamma, gamma)
        active = torch.abs(succ - gamma) > tau
    return candidate_for(last)


def min_max_attack(genuine_stacked: dict, gamma0: float = DEFAULT_GAMMA,
                   tau: float = DEFAULT_TAU, matrix_spectral: bool = False,
                   dim: int = 0, trace: list | None = None) -> dict:
    """Min-Max (Shejwalkar & Houmansadr 2021): mean - γ·std with the
    largest γ that keeps the largest distance to any genuine model below
    the largest pairwise genuine distance (reference create_min_max_model,
    Utils.py:135-166)."""
    std = pt.tree_std(genuine_stacked, dim=dim, ddof=1)
    pair = pt.pairwise_ref_distance(genuine_stacked, matrix_spectral, dim=dim)
    threshold = torch.amax(pair, dim=(-2, -1))

    def statistic(candidate):
        d = pt.distance_to_each(candidate, genuine_stacked, matrix_spectral, dim=dim)
        return torch.amax(d, dim=-1)

    return _gamma_search(genuine_stacked, std, threshold, statistic, gamma0, tau, dim, trace)


def min_sum_attack(genuine_stacked: dict, gamma0: float = DEFAULT_GAMMA,
                   tau: float = DEFAULT_TAU, matrix_spectral: bool = False,
                   dim: int = 0, trace: list | None = None) -> dict:
    """Min-Sum: the SUM of squared distances to the genuine models against
    the largest such sum of a genuine model (reference
    create_min_sum_model, Utils.py:169-204)."""
    std = pt.tree_std(genuine_stacked, dim=dim, ddof=1)
    pair = pt.pairwise_ref_distance(genuine_stacked, matrix_spectral, dim=dim)
    # each model's sum of squared distances to the others (the diagonal is 0)
    threshold = torch.amax(torch.sum(torch.square(pair), dim=-1), dim=-1)

    def statistic(candidate):
        d = pt.distance_to_each(candidate, genuine_stacked, matrix_spectral, dim=dim)
        return torch.sum(torch.square(d), dim=-1)

    return _gamma_search(genuine_stacked, std, threshold, statistic, gamma0, tau, dim, trace)


def opt_fang_attack(genuine_stacked: dict, gamma0: float = DEFAULT_GAMMA,
                    tau: float = DEFAULT_TAU, matrix_spectral: bool = False,
                    dim: int = 0, trace: list | None = None) -> dict:
    """Opt-Fang (Fang et al. 2020, optimised): the direction sign(mean)
    under the Min-Max acceptance rule (reference create_opt_fang_model,
    Utils.py:101-132)."""
    sign = pt.tree_map(torch.sign, pt.tree_mean(genuine_stacked, dim=dim))
    pair = pt.pairwise_ref_distance(genuine_stacked, matrix_spectral, dim=dim)
    threshold = torch.amax(pair, dim=(-2, -1))

    def statistic(candidate):
        d = pt.distance_to_each(candidate, genuine_stacked, matrix_spectral, dim=dim)
        return torch.amax(d, dim=-1)

    return _gamma_search(genuine_stacked, sign, threshold, statistic, gamma0, tau, dim, trace)


GAMMA_SEARCHES = {"Min-Max": min_max_attack, "Min-Sum": min_sum_attack,
                  "Opt-Fang": opt_fang_attack}


def apply_attack(mode: str, own_params: Any, genuine_stacked: dict,
                 args: tuple[float, ...] = (), dim: int = 0, noise: Any = None,
                 matrix_spectral: bool = False, trace: list | None = None) -> Any:
    """Dispatch by attack-mode string (reference RpcClient.py:119-145).

    ``own_params`` is what the attacker would send unattacked (the
    broadcast params in the round step); Random perturbs it with
    ``noise``, and the γ-search attacks fall back to it when at most one
    genuine model leaked (Utils.py:102,136,170)."""
    if mode == "none":
        return own_params
    if mode == "Random":
        return random_attack(own_params, noise, args[0] if args else DEFAULT_RANDOM_SIGMA)
    if mode == "LIE":
        return lie_attack(genuine_stacked, args[0] if args else DEFAULT_LIE_Z, dim=dim)
    if mode in GAMMA_SEARCHES:
        if pt.tree_leaves(genuine_stacked)[0].shape[dim] <= 1:
            return own_params
        gamma0 = args[0] if len(args) > 0 else DEFAULT_GAMMA
        tau = args[1] if len(args) > 1 else DEFAULT_TAU
        return GAMMA_SEARCHES[mode](genuine_stacked, gamma0, tau, matrix_spectral, dim=dim,
                               trace=trace)
    raise ValueError(f"Attack client not contain '{mode}' algorithm.")
