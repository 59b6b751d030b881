"""Model-poisoning attacks on stacked parameter trees (the port's
``attackfl_tpu/ops/attacks.py``).  Ported: ``LIE`` and the ``none``
clean-baseline sentinel; the others raise until they are ported."""

from __future__ import annotations

from typing import Any

from attackfl_tpu_torch.ops import pytree as pt

DEFAULT_LIE_Z = 0.74  # reference Utils.py:207


def lie_attack(genuine_stacked: dict, z: float = DEFAULT_LIE_Z, dim: int = 0) -> dict:
    """Little-Is-Enough: per-element mean + z * std (Bessel) over the
    leaked models on ``dim`` (reference create_LIE_state_dict,
    Utils.py:207-214)."""
    mean = pt.tree_mean(genuine_stacked, dim=dim)
    std = pt.tree_std(genuine_stacked, dim=dim, ddof=1)
    return pt.tree_map(lambda m, s: m + z * s, mean, std)


def apply_attack(mode: str, own_params: Any, genuine_stacked: dict,
                 args: tuple[float, ...] = (), dim: int = 0) -> Any:
    """Dispatch by attack-mode string (reference RpcClient.py:119-145)."""
    if mode == "none":
        return own_params
    if mode == "LIE":
        return lie_attack(genuine_stacked, args[0] if args else DEFAULT_LIE_Z, dim=dim)
    if mode in ("Random", "Min-Max", "Min-Sum", "Opt-Fang"):
        raise NotImplementedError(
            f"attack {mode!r} is not ported yet (ROADMAP.md queue 1, item 9)")
    raise ValueError(f"Attack client not contain '{mode}' algorithm.")
