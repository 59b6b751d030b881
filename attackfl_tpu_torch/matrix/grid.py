"""Grid spec: the (attack × defense × seed) cross product, made static
(the port's copy of ``attackfl_tpu/matrix/grid.py``, whole).

A :class:`GridSpec` names the sweep's three axes; :func:`expand_cells`
turns it into the flat cell list the executor partitions into groups.
The groups keep the JAX package's names and members:

* **batched** — the defenses JAX vmaps over its cell axis; **mapped** —
  FLTrust, which JAX runs cell by cell inside the same program.  In the
  port both are the DEVICE cells: each round their clients train in one
  folded local update (``matrix/program.py``), and each cell's aggregate
  is its defense's, called directly (a cell's defense is known on the
  host).
* **host** — gmm / fltracer filter with numpy between training and
  aggregation; their cells fall back to per-cell synchronous runs with a
  warning, as the pipelined executor does.
* **special** — hyper: its state (the hypernetwork and its Adam state)
  is not the plain cells', so each hyper cell runs per cell on its own
  fused path (``run_fast``).

:meth:`GridSpec.validate_base` refuses what JAX's refuses, with its
messages, so that one YAML is refused by both packages (the parity
contract).  JAX needs ``prng_impl`` ``threefry2x32`` because only
threefry keys keep their bits under ``vmap``; the port's draws come from
one ``torch.Generator`` per cell and need no such key, but a sweep config
stays portable.  ``partition`` must be ``iid``: Dirichlet pools derive
from ``random_seed``, the grid's per-cell axis.  ``local_backend`` must be
``xla``: the fused kernel is a single-workload path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from attackfl_tpu_torch.config import ATTACK_MODES, AttackSpec, Config

# Defense classification (see module doc).  byzantine and fltracer were
# dead code in the reference but are live modes here, so the full grid a
# user can request is every non-hyper AGGREGATION_MODE.
BATCHED_DEFENSES = ("fedavg", "median", "trimmed_mean", "krum", "shieldfl",
                    "scionfl", "byzantine")
MAPPED_DEFENSES = ("FLTrust",)
HOST_DEFENSES = ("gmm", "fltracer")
SPECIAL_DEFENSES = ("hyper",)
ALL_DEFENSES = (BATCHED_DEFENSES + MAPPED_DEFENSES + HOST_DEFENSES
                + SPECIAL_DEFENSES)


def defense_group(defense: str) -> str:
    if defense in BATCHED_DEFENSES:
        return "batched"
    if defense in MAPPED_DEFENSES:
        return "mapped"
    if defense in HOST_DEFENSES:
        return "host"
    if defense in SPECIAL_DEFENSES:
        return "special"
    raise ValueError(
        f"unknown defense {defense!r}; choose from {ALL_DEFENSES}")


@dataclass(frozen=True)
class Cell:
    """One grid cell: an attack spec, a defense mode, a seed."""

    attack: AttackSpec
    defense: str
    seed: int

    @property
    def key(self) -> str:
        """Flat cell identity, stable across processes — the ledger's
        ``cell`` key and the per-cell directory name."""
        return f"{self.attack.mode}x{self.defense}.s{self.seed}"

    @property
    def group(self) -> str:
        return defense_group(self.defense)

    def describe(self) -> dict[str, Any]:
        return {"attack": self.attack.mode, "defense": self.defense,
                "seed": self.seed, "group": self.group}


@dataclass(frozen=True)
class GridSpec:
    """The sweep's static geometry.

    ``attacks`` fix everything about the attacker cohort EXCEPT the mode
    (indices, activation round, args may differ per spec) — the cohort
    SIZE must match across specs so every cell shares one state
    structure (same genuine count => same leak-pool shape).
    """

    attacks: tuple[AttackSpec, ...]
    defenses: tuple[str, ...]
    seeds: tuple[int, ...]
    rounds: int = 3
    chunk: int = 4  # rounds per chunk (one read of the card)

    def __post_init__(self):
        if not self.attacks or not self.defenses or not self.seeds:
            raise ValueError("matrix grid needs >= 1 attack, defense, seed")
        for defense in self.defenses:
            defense_group(defense)  # raises on unknown
        if len(set(self.defenses)) != len(self.defenses):
            raise ValueError(f"duplicate defenses in {self.defenses}")
        if len(set(self.seeds)) != len(self.seeds):
            raise ValueError(f"duplicate seeds in {self.seeds}")
        modes = [a.mode for a in self.attacks]
        if len(set(modes)) != len(modes):
            raise ValueError(f"duplicate attack modes in {modes}")
        sizes = {len(a.client_ids) or a.num_clients for a in self.attacks}
        if len(sizes) != 1:
            raise ValueError(
                "every attack spec must claim the same number of clients "
                f"(one shared state structure per sweep), got {sizes}")
        if self.rounds < 1 or self.chunk < 1:
            raise ValueError("rounds and chunk must be >= 1")

    @property
    def n_cells(self) -> int:
        return len(self.attacks) * len(self.defenses) * len(self.seeds)

    def describe(self) -> dict[str, Any]:
        return {
            "attacks": [a.mode for a in self.attacks],
            "defenses": list(self.defenses),
            "seeds": list(self.seeds),
            "rounds": self.rounds,
            "n_cells": self.n_cells,
        }

    def validate_base(self, cfg: Config) -> None:
        """The parity-contract preconditions (see module doc)."""
        if cfg.prng_impl != "threefry2x32":
            raise ValueError(
                f"matrix sweeps need prng_impl 'threefry2x32', got "
                f"{cfg.prng_impl!r}: threefry keys are vmap-invariant; rbg "
                "keys return different bits under vmap, so a batched cell "
                "could never match its standalone run bit-for-bit")
        if cfg.partition != "iid":
            raise ValueError(
                "matrix sweeps need partition 'iid': dirichlet pools "
                "derive from random_seed, which is the grid's per-cell "
                "seed axis")
        if cfg.local_backend != "xla":
            raise ValueError(
                "matrix sweeps run on local_backend 'xla' (the pallas "
                "kernel is a single-workload fast path)")
        if cfg.hyper_detection.enable and any(
                d == "hyper" for d in self.defenses):
            raise ValueError(
                "hyper-detection runs DBSCAN on host per round; drop "
                "'hyper' from the grid or disable hyper-detection")
        if cfg.validation_async:
            raise ValueError(
                "matrix sweeps validate in-program (the fused-body "
                "cadence); validation_async does not apply")


def expand_cells(spec: GridSpec) -> list[Cell]:
    """The flat cell list, attack-major then defense then seed — a
    deterministic order every consumer (ledger, status, parity tests)
    shares."""
    return [Cell(attack=a, defense=d, seed=s)
            for a in spec.attacks for d in spec.defenses for s in spec.seeds]


def cell_config(base: Config, cell: Cell, rounds: int | None = None,
                **overrides: Any) -> Config:
    """The standalone config a cell's parity twin runs with: the base
    workload, this cell's defense as the mode, this cell's attack as the
    only attacker spec, this cell's seed.  ``attackfl-tpu run`` on this
    config must produce bit-identical final params to the cell's slice
    of the sweep.  ``data_seed`` is pinned to the sweep's base seed: the
    grid's seed axis varies the simulation stream only — every cell saw
    the ONE shared dataset."""
    return base.replace(
        mode=cell.defense,
        attacks=(cell.attack,),
        random_seed=cell.seed,
        data_seed=(base.data_seed if base.data_seed is not None
                   else base.random_seed),
        num_round=rounds if rounds is not None else base.num_round,
        **overrides,
    )


def _attack_from_entry(entry: Any, default_clients: int,
                       default_round: int) -> AttackSpec:
    if isinstance(entry, str):
        return AttackSpec(mode=entry, num_clients=default_clients,
                          attack_round=default_round)
    if isinstance(entry, dict):
        # AttackSpec normalizes args to floats itself (config.py)
        return AttackSpec(
            mode=str(entry.get("mode", "LIE")),
            num_clients=int(entry.get("num-clients", default_clients)),
            client_ids=tuple(entry.get("client-ids", []) or []),
            attack_round=int(entry.get("attack-round", default_round)),
            args=tuple(entry.get("args", []) or []),
        )
    raise ValueError(f"bad matrix attack entry {entry!r}")


def grid_from_dict(raw: dict[str, Any]) -> GridSpec:
    """Parse a ``matrix:`` config section (or a standalone grid file)::

        matrix:
          attacks: [LIE, Random, Min-Max]      # or full mappings
          attack-clients: 1                    # shorthand cohort size
          attack-round: 2                      # shorthand activation
          defenses: [fedavg, krum, median]
          seeds: [1, 2]
          rounds: 5
          chunk: 4
    """
    if not isinstance(raw, dict):
        raise ValueError(f"matrix grid must be a mapping, got {type(raw)}")
    default_clients = int(raw.get("attack-clients", 1))
    default_round = int(raw.get("attack-round", 2))
    attacks = tuple(_attack_from_entry(e, default_clients, default_round)
                    for e in (raw.get("attacks") or list(ATTACK_MODES)))
    defenses = tuple(str(d) for d in (raw.get("defenses") or ["fedavg"]))
    seeds = tuple(int(s) for s in (raw.get("seeds") or [1]))
    kw: dict[str, Any] = {}
    if "rounds" in raw:
        kw["rounds"] = int(raw["rounds"])
    if "chunk" in raw:
        kw["chunk"] = int(raw["chunk"])
    return GridSpec(attacks=attacks, defenses=defenses, seeds=seeds, **kw)
