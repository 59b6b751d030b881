"""Per-round client data assignment (the port's
``attackfl_tpu/data/partition.py:21-51``).

Quantity skew over a shared pool (reference src/RpcClient.py:97,166-169):
every round every client draws ``size ~ U[lo, hi]`` (inclusive) samples
from the whole train set, with replacement, as a padded (C, hi) index
matrix plus a validity mask.

All random draws of one round go through :func:`draw_round`, which returns
one :class:`RoundDraws` record.  The round step reads nothing random
besides it, so a test can hand it a record built from the JAX package's
key schedule and compare the two packages on identical draws.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch


@dataclass(frozen=True)
class RoundDraws:
    """Everything random in one round."""

    idx: torch.Tensor          # (C, hi) int64 sample indices
    mask: torch.Tensor         # (C, hi) bool, first `sizes[c]` slots valid
    sizes: torch.Tensor        # (C,) int64
    perms: torch.Tensor        # (epochs, C, hi) int64 per-epoch shuffles
    dropout_seed: int          # kernel dropout seed of epoch 0 (+e per epoch)
    leaks: tuple[torch.Tensor, ...]   # per attack group: (attackers, leak_k) int64


def sample_round_indices(gen: torch.Generator, num_clients: int, pool_size: int,
                         lo: int, hi: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(indices (C, hi), mask (C, hi), sizes (C,))`` on the generator's
    device: ``sizes ~ U[lo, hi]`` inclusive, indices uniform with
    replacement, mask marking each client's first ``size`` slots."""
    dev = gen.device
    sizes = torch.randint(lo, hi + 1, (num_clients,), generator=gen, device=dev)
    idx = torch.randint(0, pool_size, (num_clients, hi), generator=gen, device=dev)
    mask = torch.arange(hi, device=dev)[None, :] < sizes[:, None]
    return idx, mask, sizes


def random_permutations(gen: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
    """Independent uniform permutations of range(shape[-1]) for every
    leading index."""
    keys = torch.rand(tuple(shape), generator=gen, device=gen.device)
    return torch.argsort(keys, dim=-1)


def draw_round(gen: torch.Generator, *, num_clients: int, pool_size: int,
               lo: int, hi: int, epochs: int, num_genuine: int,
               leak_groups: Sequence[int], leak_k: int) -> RoundDraws:
    """Draw one round: client samples, per-epoch shuffles, the kernel's
    dropout seed and, for each attack group of ``leak_groups[g]``
    attackers, a leak sample of ``leak_k`` genuine indices per attacker
    drawn without replacement."""
    idx, mask, sizes = sample_round_indices(gen, num_clients, pool_size, lo, hi)
    perms = random_permutations(gen, (epochs, num_clients, hi))
    seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=gen, device=gen.device))
    leaks = tuple(random_permutations(gen, (n, num_genuine))[:, :leak_k]
                  for n in leak_groups)
    return RoundDraws(idx=idx, mask=mask, sizes=sizes, perms=perms,
                      dropout_seed=seed, leaks=leaks)
