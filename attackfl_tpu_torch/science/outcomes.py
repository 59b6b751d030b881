"""The outcome join: ledger records -> one tidy row per matrix cell (the
port's copy of ``attackfl_tpu/science/outcomes.py``).

A sweep's per-cell ledger records (source ``matrix``, shared
``sweep_id``) each carry the cell identity, final quality, and — when
the sweep's telemetry measured them — forensics rates, lifecycle counts
and numerics separation margins.  :func:`outcome_rows` joins them into
the flat table every ranking question reads:

* **attack damage** is the paired measurement the ``none`` attack-axis
  value exists for: ``damage = clean-baseline
  quality − cell quality``, where the baseline is the ``none`` cell
  sharing the SAME defense and seed (same cohort geometry, same data,
  same simulation stream — the only difference is the attack).  When a
  seed's own baseline is missing the defense's per-seed baselines are
  averaged; with no ``none`` cells at all damage is None, never 0.
* quality is read from ONE key per table (roc_auc preferred, then
  accuracy — both higher-better), chosen over the whole record set so
  every row is comparable.

Torch-free and merge-aware: rows are built from plain record dicts —
records from several stores can be concatenated before the join, and
records predating a column (e.g. pre-v13 cells without forensics)
simply carry None there.
"""

from __future__ import annotations

from typing import Any, Iterable

# The clean-baseline attack-axis value (config.NONE_ATTACK — restated
# here because the string IS the schema: ledger records store it
# literally).
BASELINE_ATTACK = "none"

# Quality keys the scores may read, in preference order (higher-better
# only: nll/train_loss would flip every ranking sign).
QUALITY_KEYS = ("roc_auc", "accuracy")


def _num(value: Any) -> float | None:
    if isinstance(value, (int, float)) and not isinstance(value, bool) \
            and value == value:
        return float(value)
    return None


def parse_cell_key(key: str) -> tuple[str, str, int] | None:
    """(attack, defense, seed) from a flat cell key
    ``{attack}x{defense}.s{seed}``.  The attack mode itself may contain
    ``x`` (``Min-Max``), so the split is on the LAST ``.s`` for the seed
    and the FIRST ``x`` that leaves a known-shaped remainder — callers
    should prefer the record's ``cell_detail`` block (authoritative);
    this parser serves records imported without one."""
    if not isinstance(key, str) or "x" not in key:
        return None
    head, sep, seed_text = key.rpartition(".s")
    if not sep:
        return None
    try:
        seed = int(seed_text)
    except ValueError:
        return None
    # longest-known-attack-prefix first so "Min-Max"x... never splits at
    # the mode's own trailing 'x'
    known = sorted(("Random", "Min-Max", "Min-Sum", "Opt-Fang", "LIE",
                    BASELINE_ATTACK), key=len, reverse=True)
    for mode in known:
        if head.startswith(mode + "x"):
            return mode, head[len(mode) + 1:], seed
    attack, sep, defense = head.partition("x")
    if not sep or not attack or not defense:
        return None
    return attack, defense, seed


def _identity(record: dict[str, Any]) -> tuple[str, str, int] | None:
    detail = record.get("cell_detail")
    if isinstance(detail, dict):
        attack, defense = detail.get("attack"), detail.get("defense")
        seed = detail.get("seed")
        if isinstance(attack, str) and isinstance(defense, str) \
                and isinstance(seed, int) and not isinstance(seed, bool):
            return attack, defense, seed
    return parse_cell_key(record.get("cell") or "")


def sweep_ids(records: Iterable[dict[str, Any]]) -> list[str]:
    """Distinct sweep ids among matrix records, oldest first (ledger
    append order)."""
    seen: list[str] = []
    for record in records:
        sid = record.get("sweep_id")
        if record.get("source") == "matrix" and isinstance(sid, str) \
                and sid not in seen:
            seen.append(sid)
    return seen


def pick_quality_key(records: Iterable[dict[str, Any]]) -> str | None:
    """One quality key for the whole table: the most-preferred key any
    record carries (mixing keys across rows would rank apples against
    oranges)."""
    present: set[str] = set()
    for record in records:
        final = record.get("final") or {}
        for key in QUALITY_KEYS:
            if _num(final.get(key)) is not None:
                present.add(key)
    for key in QUALITY_KEYS:
        if key in present:
            return key
    return None


def outcome_rows(records: Iterable[dict[str, Any]],
                 sweep_id: str | None = None,
                 baseline_attack: str = BASELINE_ATTACK
                 ) -> list[dict[str, Any]]:
    """The tidy per-cell outcome table for one sweep (or for whatever
    record set is passed when ``sweep_id`` is None — merge-aware: feed
    it records concatenated from several stores).

    Row schema (every value None when unmeasured):
    ``sweep_id, cell, attack, defense, seed, rounds, ok_rounds,
    quality_key, quality, baseline_quality, damage, tpr, fpr,
    precision, rollbacks, degrades, rounds_failed, sep_margin_mean,
    sep_margin_min``.
    """
    pool = [r for r in records if r.get("source") == "matrix"
            and isinstance(r.get("cell"), str)]
    if sweep_id is not None:
        pool = [r for r in pool if r.get("sweep_id") == sweep_id]
    # a re-run sweep can append a second record per cell; the newest
    # (last-appended) verdict wins, like the ledger's rolling baseline
    by_cell: dict[tuple[str | None, str], dict[str, Any]] = {}
    for record in pool:
        by_cell[(record.get("sweep_id"), record["cell"])] = record
    pool = list(by_cell.values())
    quality_key = pick_quality_key(pool)

    def quality_of(record: dict[str, Any]) -> float | None:
        if quality_key is None:
            return None
        return _num((record.get("final") or {}).get(quality_key))

    # clean baselines: (defense, seed) -> quality, plus per-defense means
    baseline_exact: dict[tuple[str, int], float] = {}
    baseline_by_defense: dict[str, list[float]] = {}
    for record in pool:
        ident = _identity(record)
        if ident is None or ident[0] != baseline_attack:
            continue
        value = quality_of(record)
        if value is None:
            continue
        baseline_exact[(ident[1], ident[2])] = value
        baseline_by_defense.setdefault(ident[1], []).append(value)

    rows: list[dict[str, Any]] = []
    for record in pool:
        ident = _identity(record)
        if ident is None:
            continue
        attack, defense, seed = ident
        quality = quality_of(record)
        baseline = baseline_exact.get((defense, seed))
        if baseline is None and baseline_by_defense.get(defense):
            values = baseline_by_defense[defense]
            baseline = sum(values) / len(values)
        damage = None
        if attack == baseline_attack:
            damage = 0.0 if quality is not None else None
        elif baseline is not None and quality is not None:
            damage = round(baseline - quality, 6)
        forensics = record.get("forensics") or {}
        counts = record.get("counts") or {}
        numerics = record.get("numerics") or {}
        rows.append({
            "sweep_id": record.get("sweep_id"),
            "cell": record["cell"],
            "attack": attack,
            "defense": defense,
            "seed": seed,
            "rounds": record.get("rounds"),
            "ok_rounds": record.get("ok_rounds"),
            "quality_key": quality_key,
            "quality": quality,
            "baseline_quality": (round(baseline, 6)
                                 if baseline is not None else None),
            "damage": damage,
            "tpr": _num(forensics.get("tpr")),
            "fpr": _num(forensics.get("fpr")),
            "precision": _num(forensics.get("precision")),
            "rollbacks": counts.get("rollbacks"),
            "degrades": counts.get("degrades"),
            "rounds_failed": counts.get("rounds_failed"),
            "sep_margin_mean": _num(numerics.get("sep_margin_mean")),
            "sep_margin_min": _num(numerics.get("sep_margin_min")),
        })
    # deterministic order: attack-major then defense then seed, the
    # grid's own expansion order
    rows.sort(key=lambda r: (str(r["attack"]), str(r["defense"]),
                             r["seed"] if isinstance(r["seed"], int) else 0))
    return rows


def format_outcomes(rows: list[dict[str, Any]]) -> str:
    """The human table (one row per cell)."""
    if not rows:
        return "no outcome rows"
    qkey = rows[0].get("quality_key") or "quality"

    def fmt(value: Any, nd: int = 4) -> str:
        number = _num(value)
        return f"{number:.{nd}f}" if number is not None else "-"

    lines = [f"{'cell':<30}{qkey:>9}{'damage':>9}{'tpr':>7}{'fpr':>7}"
             f"{'sep_min':>9}{'ok':>6}"]
    for row in rows:
        ok = (f"{row['ok_rounds']}/{row['rounds']}"
              if isinstance(row.get("ok_rounds"), int)
              and isinstance(row.get("rounds"), int) else "-")
        lines.append(
            f"{str(row['cell'])[:29]:<30}{fmt(row['quality']):>9}"
            f"{fmt(row['damage']):>9}{fmt(row['tpr'], 2):>7}"
            f"{fmt(row['fpr'], 2):>7}{fmt(row['sep_margin_min'], 3):>9}"
            f"{ok:>6}")
    return "\n".join(lines)
