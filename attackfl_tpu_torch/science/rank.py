"""Leaderboards, rank stability, and the rank-regression gate (the
port's copy of ``attackfl_tpu/science/rank.py``).

Scores read the outcome table (:mod:`attackfl_tpu_torch.science.outcomes`):

* a defense's **robustness score** is its mean attack damage over every
  attacked cell (lower = more robust), aggregated first per seed so the
  bootstrap resamples the experiment's actual replication unit;
* the **bootstrap CI** resamples SEEDS with replacement (seeded PRNG —
  deterministic, test-pinned): inter-seed spread is the only replication
  noise a sweep measures, so it is also the only honest CI;
* **worst-case ranking** is max per-attack mean damage (the min-over-
  attacks quality view the paper cares about: a defense is only as good
  as its worst matchup);
* **Kendall tau-b** compares two sweeps' defense orderings over their
  COMMON defenses (tie-aware; None when fewer than two are shared);
* the **gate** (:func:`rank_diff`) fails a defense whose rank worsened
  or whose damage regressed — but only past a noise floor derived from
  the two sweeps' inter-seed spread (the paired-means lesson: a gate
  tighter than its own noise cries wolf on every rerun).  An identical
  pair of sweeps always passes; a genuine ranking flip always fails.
"""

from __future__ import annotations

import math
import random
import statistics
from typing import Any, Iterable

from attackfl_tpu_torch.science.outcomes import BASELINE_ATTACK

DEFAULT_BOOTSTRAP = 1000


def _mean(values: list[float]) -> float | None:
    return sum(values) / len(values) if values else None


def _seed_means(rows: list[dict[str, Any]], field: str
                ) -> dict[int, float]:
    """Per-seed mean of ``field`` over a defense's attacked cells — the
    replication unit every CI and noise floor resamples."""
    by_seed: dict[int, list[float]] = {}
    for row in rows:
        value = row.get(field)
        if value is None:
            continue
        by_seed.setdefault(row["seed"], []).append(float(value))
    return {seed: _mean(vals) for seed, vals in by_seed.items()
            if vals}


def bootstrap_ci(seed_means: dict[int, float],
                 n_boot: int = DEFAULT_BOOTSTRAP,
                 boot_seed: int = 0,
                 level: float = 95.0) -> tuple[float, float] | None:
    """Percentile bootstrap CI of the mean, resampling seeds with
    replacement.  Deterministic for a given ``boot_seed`` (the tests pin
    the exact interval).  None with no seeds; a single seed collapses to
    a zero-width interval (no replication = no spread evidence)."""
    values = [seed_means[s] for s in sorted(seed_means)]
    if not values:
        return None
    if len(values) == 1:
        return values[0], values[0]
    rng = random.Random(boot_seed)
    n = len(values)
    means = sorted(
        sum(values[rng.randrange(n)] for _ in range(n)) / n
        for _ in range(max(int(n_boot), 1)))
    lo_q = (100.0 - level) / 200.0
    lo = means[min(int(lo_q * len(means)), len(means) - 1)]
    hi = means[min(int((1.0 - lo_q) * len(means)), len(means) - 1)]
    return round(lo, 6), round(hi, 6)


def seed_spread(seed_means: dict[int, float]) -> float:
    """Population stdev of the per-seed means — the gate's noise-floor
    input.  0.0 with fewer than two seeds (a single observation carries
    no self-noise estimate; compare.rate_noise_pct's rule)."""
    values = list(seed_means.values())
    if len(values) < 2:
        return 0.0
    return statistics.pstdev(values)


def defense_scores(rows: list[dict[str, Any]],
                   n_boot: int = DEFAULT_BOOTSTRAP,
                   boot_seed: int = 0) -> list[dict[str, Any]]:
    """Per-defense leaderboard rows, most robust first.

    Ranking key: mean damage ascending when any damage was measured
    (requires the ``none`` baseline cells), else mean quality descending
    — a sweep without baselines still ranks, just on raw quality, and
    the rows say which key ranked them (``ranked_by``).
    """
    attacked = [r for r in rows if r["attack"] != BASELINE_ATTACK]
    defenses = sorted({r["defense"] for r in attacked})
    have_damage = any(r.get("damage") is not None for r in attacked)
    out: list[dict[str, Any]] = []
    for defense in defenses:
        mine = [r for r in attacked if r["defense"] == defense]
        damage_means = _seed_means(mine, "damage")
        quality_means = _seed_means(mine, "quality")
        # worst case: per-attack mean damage, take the max
        per_attack: dict[str, list[float]] = {}
        for row in mine:
            if row.get("damage") is not None:
                per_attack.setdefault(row["attack"], []).append(
                    float(row["damage"]))
        attack_means = {a: _mean(v) for a, v in per_attack.items()}
        worst_attack = (max(attack_means, key=lambda a: attack_means[a])
                        if attack_means else None)
        damage_mean = _mean(list(damage_means.values()))
        entry = {
            "defense": defense,
            "cells": len(mine),
            "seeds": len(damage_means or quality_means),
            "damage_mean": (round(damage_mean, 6)
                            if damage_mean is not None else None),
            "damage_ci95": bootstrap_ci(damage_means, n_boot, boot_seed),
            "damage_worst": (round(attack_means[worst_attack], 6)
                             if worst_attack is not None else None),
            "worst_attack": worst_attack,
            "seed_spread": round(seed_spread(damage_means), 6),
            "quality_mean": (
                round(_mean(list(quality_means.values())), 6)
                if quality_means else None),
            "tpr_mean": _mean([r["tpr"] for r in mine
                               if r.get("tpr") is not None]),
            "fpr_mean": _mean([r["fpr"] for r in mine
                               if r.get("fpr") is not None]),
            "ranked_by": "damage" if have_damage else "quality",
        }
        if entry["tpr_mean"] is not None:
            entry["tpr_mean"] = round(entry["tpr_mean"], 6)
        if entry["fpr_mean"] is not None:
            entry["fpr_mean"] = round(entry["fpr_mean"], 6)
        out.append(entry)

    def sort_key(entry: dict[str, Any]):
        if have_damage:
            dm = entry["damage_mean"]
            dw = entry["damage_worst"]
            return (dm if dm is not None else math.inf,
                    dw if dw is not None else math.inf,
                    entry["defense"])
        qm = entry["quality_mean"]
        return (-(qm if qm is not None else -math.inf), entry["defense"])

    out.sort(key=sort_key)
    for i, entry in enumerate(out):
        entry["rank"] = i + 1
    return out


def attack_scores(rows: list[dict[str, Any]]) -> list[dict[str, Any]]:
    """Per-attack effectiveness: mean damage over defenses × seeds, most
    effective first, with the defense it hurts most."""
    attacked = [r for r in rows if r["attack"] != BASELINE_ATTACK]
    out: list[dict[str, Any]] = []
    for attack in sorted({r["attack"] for r in attacked}):
        mine = [r for r in attacked if r["attack"] == attack
                and r.get("damage") is not None]
        per_defense: dict[str, list[float]] = {}
        for row in mine:
            per_defense.setdefault(row["defense"], []).append(
                float(row["damage"]))
        defense_means = {d: _mean(v) for d, v in per_defense.items()}
        hardest = (max(defense_means, key=lambda d: defense_means[d])
                   if defense_means else None)
        mean = _mean([float(r["damage"]) for r in mine])
        out.append({
            "attack": attack,
            "cells": len(mine),
            "damage_mean": round(mean, 6) if mean is not None else None,
            "most_damaged_defense": hardest,
        })
    out.sort(key=lambda e: (-(e["damage_mean"]
                              if e["damage_mean"] is not None
                              else -math.inf), e["attack"]))
    return out


def leaderboard(rows: list[dict[str, Any]],
                sweep_id: str | None = None,
                n_boot: int = DEFAULT_BOOTSTRAP,
                boot_seed: int = 0) -> dict[str, Any]:
    """The full sweep summary: defense leaderboard + attack
    effectiveness + the identity/counts header the science event and
    SCOREBOARD.json carry."""
    sweep = sweep_id or next((r.get("sweep_id") for r in rows
                              if r.get("sweep_id")), None)
    return {
        "sweep_id": sweep,
        "quality_key": next((r.get("quality_key") for r in rows
                             if r.get("quality_key")), None),
        "baseline": BASELINE_ATTACK,
        "has_baseline": any(r["attack"] == BASELINE_ATTACK for r in rows),
        "cells": len(rows),
        "attacks": len({r["attack"] for r in rows
                        if r["attack"] != BASELINE_ATTACK}),
        "defenses": len({r["defense"] for r in rows}),
        "seeds": len({r["seed"] for r in rows}),
        "leaderboard": defense_scores(rows, n_boot, boot_seed),
        "attack_effectiveness": attack_scores(rows),
    }


def kendall_tau(a: dict[str, float], b: dict[str, float]) -> float | None:
    """Kendall tau-b over the two mappings' COMMON keys (tie-aware).
    None with fewer than two common keys or when either side is all
    ties (an ordering with no order has no correlation)."""
    common = sorted(set(a) & set(b))
    if len(common) < 2:
        return None
    xs = [a[k] for k in common]
    ys = [b[k] for k in common]
    concordant = discordant = 0
    for i in range(len(common)):
        for j in range(i + 1, len(common)):
            dx = xs[i] - xs[j]
            dy = ys[i] - ys[j]
            prod = dx * dy
            if prod > 0:
                concordant += 1
            elif prod < 0:
                discordant += 1

    def tie_term(values: list[float]) -> int:
        groups: dict[float, int] = {}
        for v in values:
            groups[v] = groups.get(v, 0) + 1
        return sum(t * (t - 1) // 2 for t in groups.values())

    n0 = len(common) * (len(common) - 1) // 2
    denom = math.sqrt((n0 - tie_term(xs)) * (n0 - tie_term(ys)))
    if denom == 0:
        return None
    return round((concordant - discordant) / denom, 6)


def rank_diff(old: dict[str, Any], new: dict[str, Any],
              damage_floor: float = 0.0) -> dict[str, Any]:
    """Diff two leaderboards (``leaderboard()`` outputs) and gate.

    Per common defense, the noise floor is ``max(seed_spread_old,
    seed_spread_new, damage_floor)`` — the measured inter-seed wobble of
    the very quantity being gated.  Violations:

    * ``rank_flip`` — the defense's rank worsened AND its damage moved
      past the noise floor (rank jitter between statistically tied
      defenses never fires the gate);
    * ``damage_regression`` — damage worsened past the noise floor even
      with the rank intact (every defense degrading together flips no
      ranks but is still a regression).

    ``ok`` is False when any violation fired.  Identical inputs always
    pass (every delta is exactly 0).
    """
    old_rows = {e["defense"]: e for e in old.get("leaderboard") or []}
    new_rows = {e["defense"]: e for e in new.get("leaderboard") or []}
    common = sorted(set(old_rows) & set(new_rows))
    per_defense: list[dict[str, Any]] = []
    violations: list[dict[str, Any]] = []
    for defense in common:
        o, n = old_rows[defense], new_rows[defense]
        noise = max(float(o.get("seed_spread") or 0.0),
                    float(n.get("seed_spread") or 0.0),
                    float(damage_floor))
        delta = None
        if o.get("damage_mean") is not None \
                and n.get("damage_mean") is not None:
            delta = round(n["damage_mean"] - o["damage_mean"], 6)
        rank_worsened = n["rank"] > o["rank"]
        beyond_noise = delta is not None and delta > noise
        entry = {
            "defense": defense,
            "rank_old": o["rank"], "rank_new": n["rank"],
            "damage_old": o.get("damage_mean"),
            "damage_new": n.get("damage_mean"),
            "damage_delta": delta,
            "noise_floor": round(noise, 6),
        }
        if rank_worsened and beyond_noise:
            entry["violation"] = "rank_flip"
            violations.append(dict(entry))
        elif beyond_noise:
            entry["violation"] = "damage_regression"
            violations.append(dict(entry))
        per_defense.append(entry)

    tau = kendall_tau(
        {d: float(old_rows[d]["rank"]) for d in common},
        {d: float(new_rows[d]["rank"]) for d in common})
    return {
        "old_sweep": old.get("sweep_id"),
        "new_sweep": new.get("sweep_id"),
        "common_defenses": common,
        "only_old": sorted(set(old_rows) - set(new_rows)),
        "only_new": sorted(set(new_rows) - set(old_rows)),
        "kendall_tau": tau,
        "per_defense": per_defense,
        "violations": violations,
        "ok": not violations,
    }


def format_leaderboard(board: dict[str, Any]) -> str:
    lines = [
        f"sweep {board.get('sweep_id') or '?'}: "
        f"{board.get('defenses')} defense(s) x {board.get('attacks')} "
        f"attack(s) x {board.get('seeds')} seed(s), "
        f"{board.get('cells')} cell row(s), quality="
        f"{board.get('quality_key') or '?'}"
        + ("" if board.get("has_baseline")
           else "  [no 'none' baseline cells: ranking on raw quality, "
                "damage unmeasured]")]
    rows = board.get("leaderboard") or []
    if rows:
        lines.append(
            f"{'rank':<6}{'defense':<14}{'damage':>9}{'ci95':>19}"
            f"{'worst':>9}{'worst-attack':>14}{'quality':>9}{'tpr':>7}")
        for entry in rows:
            ci = entry.get("damage_ci95")
            ci_text = (f"[{ci[0]:.4f},{ci[1]:.4f}]"
                       if isinstance(ci, (list, tuple)) else "-")

            def fmt(value: Any, nd: int = 4) -> str:
                return (f"{value:.{nd}f}"
                        if isinstance(value, (int, float))
                        and not isinstance(value, bool) else "-")

            lines.append(
                f"{entry['rank']:<6}{entry['defense']:<14}"
                f"{fmt(entry.get('damage_mean')):>9}{ci_text:>19}"
                f"{fmt(entry.get('damage_worst')):>9}"
                f"{str(entry.get('worst_attack') or '-'):>14}"
                f"{fmt(entry.get('quality_mean')):>9}"
                f"{fmt(entry.get('tpr_mean'), 2):>7}")
    attacks = board.get("attack_effectiveness") or []
    if attacks:
        lines.append("attack effectiveness (mean damage, most harmful "
                     "first):")
        for entry in attacks:
            dm = entry.get("damage_mean")
            lines.append(
                f"  {entry['attack']:<12}"
                + (f"{dm:+.4f}" if isinstance(dm, (int, float)) else "-")
                + (f"  (hurts {entry['most_damaged_defense']} most)"
                   if entry.get("most_damaged_defense") else ""))
    return "\n".join(lines)


def format_diff(diff: dict[str, Any]) -> str:
    tau = diff.get("kendall_tau")
    lines = [
        f"rank diff {diff.get('old_sweep')} -> {diff.get('new_sweep')}: "
        + ("STABLE" if diff.get("ok") else "RANK REGRESSION")
        + (f" (kendall tau {tau:+.3f}" if tau is not None
           else " (tau n/a")
        + f", {len(diff.get('common_defenses') or [])} common "
          "defense(s))"]
    for side, key in (("old", "only_old"), ("new", "only_new")):
        extra = diff.get(key)
        if extra:
            lines.append(f"  only in {side}: {', '.join(extra)}")
    for entry in diff.get("per_defense") or []:
        delta = entry.get("damage_delta")
        lines.append(
            f"  {entry['defense']:<14} rank {entry['rank_old']}->"
            f"{entry['rank_new']}  damage "
            + (f"{entry['damage_old']:.4f}->{entry['damage_new']:.4f} "
               f"({delta:+.4f})"
               if delta is not None else "n/a")
            + f"  noise floor {entry['noise_floor']:.4f}"
            + (f"  FAIL {entry['violation']}"
               if entry.get("violation") else ""))
    return "\n".join(lines)
