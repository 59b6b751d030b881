"""Defense forensics: TPR/FPR of a defense from ``attribution`` events
(the port's copy of ``attackfl_tpu/telemetry/forensics.py``).

Every per-round-path round with attackers configured writes an
``attribution`` event: the clients that attacked this broadcast against
the defense's kept/removed decision (``training/round.build_attribution_fn``).
This module turns those events back into detection quality,
micro-averaged over rounds:

* **TPR** (recall) = removed attackers / attackers present,
* **FPR** = removed honest clients / honest clients present,
* **precision** = removed attackers / all removed.
"""

from __future__ import annotations

from typing import Any


def confusion_counts(attackers: list[int], kept: list[int],
                     removed: list[int]) -> dict[str, int]:
    """One round's confusion matrix.  "Positive" = the defense removed the
    client; ground truth = the client attacked this round.  Clients absent
    from both ``kept`` and ``removed`` (non-reporting) are excluded."""
    attacker_set = set(attackers)
    removed_set = set(removed)
    kept_set = set(kept)
    return {
        "tp": len(removed_set & attacker_set),
        "fp": len(removed_set - attacker_set),
        "fn": len(kept_set & attacker_set),
        "tn": len(kept_set - attacker_set),
    }


def rates(tp: int, fp: int, fn: int, tn: int) -> dict[str, float | None]:
    """Detection-quality rates; None when the denominator is empty (e.g.
    FPR of a round with no honest clients present)."""
    return {
        "tpr": round(tp / (tp + fn), 6) if (tp + fn) else None,
        "fpr": round(fp / (fp + tn), 6) if (fp + tn) else None,
        "precision": round(tp / (tp + fp), 6) if (tp + fp) else None,
    }


def forensics_summary(events: list[dict[str, Any]]) -> dict[str, Any] | None:
    """Aggregate one run's ``attribution`` events.

    Multi-process merged streams carry one attribution event per process
    for the same broadcast (the computation is SPMD-identical); those are
    deduplicated keeping the first occurrence.  Retried rounds keep one
    verdict per broadcast — each broadcast is a distinct defense decision.
    Returns None when the run recorded no attribution events (no attackers
    configured, fused path, or a pre-v2 artifact).
    """
    seen: set[tuple[Any, Any, Any]] = set()
    per_round: list[dict[str, Any]] = []
    totals = {"tp": 0, "fp": 0, "fn": 0, "tn": 0}
    mode = None
    source = None
    attack_rounds = 0
    # hyper-detection: its attribution events carry
    # source="hyper_detection", and a removal there also ROLLS THE ROUND
    # BACK — surface the rollback count next to the detection quality
    rollbacks = sum(1 for e in events if e.get("kind") == "rollback")
    for event in events:
        if event.get("kind") != "attribution":
            continue
        key = (event.get("run_id"), event.get("round"),
               event.get("broadcast"))
        if key in seen:
            continue
        seen.add(key)
        mode = event.get("mode", mode)
        source = event.get("source", source)
        counts = confusion_counts(event.get("attackers") or [],
                                  event.get("kept") or [],
                                  event.get("removed") or [])
        for name in totals:
            totals[name] += counts[name]
        if event.get("attackers"):
            attack_rounds += 1
        per_round.append({
            "round": event.get("round"),
            "attackers": len(event.get("attackers") or []),
            "removed": len(event.get("removed") or []),
            **counts,
            **rates(**counts),
        })
    if not per_round:
        return None
    return {
        "mode": mode,
        "source": source,
        "rounds": len(per_round),
        "attack_rounds": attack_rounds,
        "rollbacks": rollbacks,
        **totals,
        **rates(**totals),
        "per_round": per_round,
    }


def forensics_by_defense(events: list[dict[str, Any]]
                         ) -> dict[str, Any] | None:
    """Cross-stream aggregate for a MERGED spool.

    ``metrics --merge --forensics`` used to keep only the last run of
    the merged stream; a service spool or a sweep's merged cell spools
    carry MANY runs with different defenses.  This aggregates the whole
    merged event list (the dedup key is already ``(run_id, round,
    broadcast)``-aware, so SPMD duplicates still collapse while distinct
    runs all count) and adds a per-defense breakdown grouped by each
    attribution event's ``mode`` stamp.  Returns None when no stream
    recorded attribution events.
    """
    overall = forensics_summary(events)
    if overall is None:
        return None
    by_mode: dict[str, list[dict[str, Any]]] = {}
    for event in events:
        if event.get("kind") == "attribution":
            by_mode.setdefault(str(event.get("mode")), []).append(event)
    defenses: dict[str, dict[str, Any]] = {}
    for mode, chunk in sorted(by_mode.items()):
        summary = forensics_summary(chunk)
        if summary is not None:
            defenses[mode] = {k: summary.get(k) for k in
                              ("rounds", "attack_rounds", "tp", "fp",
                               "fn", "tn", "tpr", "fpr", "precision")}
    if len(defenses) > 1:
        overall["mode"] = "+".join(sorted(defenses))
    overall["runs"] = len({e.get("run_id") for e in events
                           if e.get("kind") == "attribution"})
    overall["by_defense"] = defenses
    return overall


def format_forensics(summary: dict[str, Any],
                     run_id: str | None = None) -> str:
    def fmt(value: float | None) -> str:
        return "n/a" if value is None else f"{value:.4f}"

    lines = [
        f"defense forensics — mode={summary['mode']}"
        + (f" [{summary['source']}]" if summary.get("source") else "")
        + (f" run {run_id}" if run_id else ""),
        f"rounds with attribution: {summary['rounds']} "
        f"({summary['attack_rounds']} under active attack)",
        f"confusion (micro): tp={summary['tp']} fp={summary['fp']} "
        f"fn={summary['fn']} tn={summary['tn']}",
        f"TPR={fmt(summary['tpr'])} FPR={fmt(summary['fpr'])} "
        f"precision={fmt(summary['precision'])}",
    ]
    if summary.get("rollbacks"):
        lines.append(f"rollbacks: {summary['rollbacks']} round(s) rolled "
                     "back by detection removals")
    by_defense = summary.get("by_defense") or {}
    if by_defense:
        lines.append(
            f"per-defense breakdown ({summary.get('runs', '?')} "
            f"stream(s)):")
        lines.append(f"  {'defense':<14}{'rounds':>7}{'attack':>7}"
                     f"{'TPR':>8}{'FPR':>8}{'prec':>8}")
        for mode, row in by_defense.items():
            lines.append(
                f"  {mode:<14}{row['rounds']:>7}{row['attack_rounds']:>7}"
                f"{fmt(row['tpr']):>8}{fmt(row['fpr']):>8}"
                f"{fmt(row['precision']):>8}")
    flagged = [r for r in summary["per_round"] if r["attackers"]]
    if flagged:
        lines.append(f"{'round':<8}{'attackers':>10}{'removed':>9}"
                     f"{'tp':>5}{'fp':>5}{'TPR':>8}{'FPR':>8}")
        for row in flagged:
            lines.append(
                f"{row['round']:<8}{row['attackers']:>10}{row['removed']:>9}"
                f"{row['tp']:>5}{row['fp']:>5}"
                f"{fmt(row['tpr']):>8}{fmt(row['fpr']):>8}")
    return "\n".join(lines)
