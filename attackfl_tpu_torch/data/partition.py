"""Per-round client data assignment (the port's
``attackfl_tpu/data/partition.py``).

Quantity skew over a shared pool (reference src/RpcClient.py:97,166-169):
every round every client draws ``size ~ U[lo, hi]`` (inclusive) samples
from the whole train set, with replacement, as a padded (C, hi) index
matrix plus a validity mask.  Under a non-IID split each client draws
from its own pool instead (:func:`dirichlet_label_partition`), and with
stragglers each client drops out of the round with probability
``client_dropout_rate`` (:func:`apply_client_dropout`).

All random draws of one round go through :func:`draw_round`, which returns
one :class:`RoundDraws` record.  The round step reads nothing random
besides it, so a test can hand it a record built from the JAX package's
key schedule and compare the two packages on identical draws.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch


@dataclass(frozen=True)
class RoundDraws:
    """Everything random in one round."""

    idx: torch.Tensor          # (C, hi) int64 sample indices
    mask: torch.Tensor         # (C, hi) bool, first `sizes[c]` slots valid
    sizes: torch.Tensor        # (C,) int64
    perms: torch.Tensor        # (epochs, C, hi) int64 per-epoch shuffles
    # dropout seed of epoch 0 (+e per epoch): a 0-dim int64 tensor on the
    # round's device as drawn (an int from a caller is hashed alike)
    dropout_seed: int | torch.Tensor
    leaks: tuple[torch.Tensor, ...]   # per attack group: (attackers, leak_k) int64
    kept: torch.Tensor | None = None  # (C,) bool; None without stragglers
    noise: tuple[torch.Tensor, ...] = ()  # per Random group: (attackers, P) N(0, 1)
    uniform: torch.Tensor | None = None   # (C, P) U[0, 1): ScionFL's quantization bits
    root_perms: torch.Tensor | None = None  # (epochs, 1, n_root) int64: FLTrust's root shuffles
    root_seed: int = 0                    # FLTrust's root dropout seed of epoch 0 (+e per epoch)


def sample_round_indices(gen: torch.Generator, num_clients: int, pool_size: int,
                         lo: int, hi: int, client_pools: torch.Tensor | None = None,
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(indices (C, hi), mask (C, hi), sizes (C,))`` on the generator's
    device: ``sizes ~ U[lo, hi]`` inclusive, indices uniform with
    replacement, mask marking each client's first ``size`` slots.  With
    ``client_pools`` (C, width), client c draws uniformly from its row."""
    dev = gen.device
    sizes = torch.randint(lo, hi + 1, (num_clients,), generator=gen, device=dev)
    if client_pools is not None:
        slot = torch.randint(0, client_pools.shape[1], (num_clients, hi),
                             generator=gen, device=dev)
        idx = torch.gather(client_pools, 1, slot)
    else:
        idx = torch.randint(0, pool_size, (num_clients, hi), generator=gen, device=dev)
    mask = torch.arange(hi, device=dev)[None, :] < sizes[:, None]
    return idx, mask, sizes


def apply_client_dropout(kept: torch.Tensor, sizes: torch.Tensor, mask: torch.Tensor,
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Straggler injection: a dropped client (``kept`` False) gets zero
    samples, so every batch is masked and its local update is an exact
    no-op, and round size 0, so size-weighted aggregation excludes it.
    Returns ``(sizes, mask)``."""
    return sizes * kept, mask & kept[:, None]


def dirichlet_label_partition(labels: np.ndarray, num_clients: int, alpha: float,
                              seed: int = 0) -> np.ndarray:
    """Non-IID label split: per-class Dirichlet(alpha) proportions over
    clients (Hsu et al. 2019), byte for byte the JAX package's numpy code.

    Returns an int32 matrix (num_clients, width) where row c lists the
    sample indices client c may draw from, padded by repetition."""
    rng = np.random.default_rng(seed)
    labels = np.asarray(labels).astype(np.int64)
    classes = np.unique(labels)
    client_indices: list[list[int]] = [[] for _ in range(num_clients)]
    for cls in classes:
        cls_idx = np.flatnonzero(labels == cls)
        rng.shuffle(cls_idx)
        props = rng.dirichlet(np.full(num_clients, alpha))
        cuts = (np.cumsum(props) * len(cls_idx)).astype(int)[:-1]
        for c, part in enumerate(np.split(cls_idx, cuts)):
            client_indices[c].extend(part.tolist())
    # non-empty pools, then padded by repetition to a rectangle
    for c in range(num_clients):
        if not client_indices[c]:
            client_indices[c].append(int(rng.integers(len(labels))))
    width = max(len(ci) for ci in client_indices)
    out = np.zeros((num_clients, width), dtype=np.int32)
    for c, ci in enumerate(client_indices):
        reps = -(-width // len(ci))
        out[c] = np.tile(np.asarray(ci, dtype=np.int32), reps)[:width]
    return out


def random_permutations(gen: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
    """Independent uniform permutations of range(shape[-1]) for every
    leading index."""
    keys = torch.rand(tuple(shape), generator=gen, device=gen.device)
    return torch.argsort(keys, dim=-1)


def draw_round(gen: torch.Generator, *, num_clients: int, pool_size: int,
               lo: int, hi: int, epochs: int, num_genuine: int,
               leak_groups: Sequence[int], leak_k: int,
               client_pools: torch.Tensor | None = None, dropout_rate: float = 0.0,
               noise_groups: Sequence[int] = (), num_params: int = 0,
               quantize: bool = False, root_size: int = 0,
               leak_pool: torch.Tensor | None = None) -> RoundDraws:
    """Draw one round: client samples (from ``client_pools`` where given),
    per-epoch shuffles, the kernel's dropout seed and, for each attack
    group of ``leak_groups[g]`` attackers, a leak sample of ``leak_k``
    genuine indices per attacker drawn without replacement.  Under hyper
    mode's embedding detector, which can shrink the pool below ``leak_k``,
    ``leak_pool`` holds the positions (in ``range(num_genuine)``) of the
    active genuine clients, and each leak sample is drawn from it with
    replacement; an empty pool draws nothing (JAX
    ``training/hyper.py:138-164``).  Then, only where
    asked: the kept clients (each kept with probability ``1 -
    dropout_rate``); for each Random group of ``noise_groups[g]``
    attackers an (attackers, ``num_params``) standard normal draw; with
    ``quantize`` (ScionFL) a (C, ``num_params``) uniform draw; with
    ``root_size`` (FLTrust) the root set's per-epoch shuffles and its
    dropout seed.  A run without stragglers, Random attackers, ScionFL or
    FLTrust draws nothing more."""
    idx, mask, sizes = sample_round_indices(gen, num_clients, pool_size, lo, hi,
                                            client_pools)
    perms = random_permutations(gen, (epochs, num_clients, hi))
    # the dropout seed stays on the device: the kernels read it there
    seed = torch.randint(0, 2 ** 31 - 1, (), generator=gen, device=gen.device)
    if leak_pool is None:
        leaks = tuple(random_permutations(gen, (n, num_genuine))[:, :leak_k]
                      for n in leak_groups)
    elif leak_pool.numel() == 0:
        leaks = tuple(torch.zeros((n, 0), dtype=torch.int64, device=gen.device)
                      for n in leak_groups)
    else:
        leaks = tuple(leak_pool[torch.randint(0, leak_pool.numel(), (n, leak_k),
                                              generator=gen, device=gen.device)]
                      for n in leak_groups)
    kept = None
    if dropout_rate > 0.0:
        kept = torch.rand((num_clients,), generator=gen, device=gen.device) < 1.0 - dropout_rate
    noise = tuple(torch.randn((n, num_params), generator=gen, device=gen.device)
                  for n in noise_groups)
    uniform = root_perms = None
    root_seed = 0
    if quantize:
        uniform = torch.rand((num_clients, num_params), generator=gen, device=gen.device)
    if root_size:
        root_perms = random_permutations(gen, (epochs, 1, root_size))
        root_seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=gen, device=gen.device))
    return RoundDraws(idx=idx, mask=mask, sizes=sizes, perms=perms,
                      dropout_seed=seed, leaks=leaks, kept=kept, noise=noise,
                      uniform=uniform, root_perms=root_perms, root_seed=root_seed)
