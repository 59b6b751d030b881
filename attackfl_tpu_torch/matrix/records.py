"""Per-cell ledger records: one sweep submit -> k×45 records (the
port's copy of ``attackfl_tpu/matrix/records.py``).

Distills the executor's per-cell round histories (already host Python —
the chunk resolution materialized them) into one ledger record per cell,
all sharing a ``sweep_id``.  Torch-free and sync-free by construction:
this is pure dict-shaping over values the executor hands in.

Cell records join the cross-run ledger on TWO keys:

* ``fingerprint`` — the fingerprint of the cell's STANDALONE config
  (:func:`attackfl_tpu_torch.matrix.grid.cell_config`), so a matrix cell and
  its standalone parity twin share a baseline pool (their params are
  bit-identical by contract, like sync/pipelined runs today);
* ``cell`` — the flat cell key.  The rolling-baseline selector
  (JAX's ``ledger/compare.rolling_baseline``) matches peers
  on it, so two cells that happen to share a config fingerprint can
  never cross-contaminate each other's baselines.
"""

from __future__ import annotations

from typing import Any

from attackfl_tpu_torch.ledger.record import LEDGER_SCHEMA_VERSION
from attackfl_tpu_torch.matrix.grid import Cell, cell_config
from attackfl_tpu_torch.utils.fingerprint import config_fingerprint

# final-quality keys lifted from a cell's last ok round, when present
_QUALITY_KEYS = ("roc_auc", "accuracy", "nll", "train_loss")


def summarize_cell_events(events: list[dict[str, Any]]
                          ) -> dict[str, Any]:
    """Forensics / numerics / lifecycle-count blocks for ONE cell's
    event slice, shaped exactly like ``derive_record``'s
    (:mod:`attackfl_tpu_torch.ledger.record`) so the science outcome join
    reads matrix cells and standalone runs with one code path.  Returns
    ``{}`` when the slice measured nothing (telemetry off, batched cell
    without numerics, pre-v13 artifact)."""
    from attackfl_tpu_torch.telemetry.forensics import forensics_summary
    from attackfl_tpu_torch.telemetry.numerics import numerics_summary

    out: dict[str, Any] = {}
    forensics = forensics_summary(events)
    if forensics is not None:
        out["forensics"] = {k: forensics.get(k) for k in
                            ("tpr", "fpr", "precision", "rounds",
                             "attack_rounds", "rollbacks")}
    numerics = numerics_summary(events)
    if numerics is not None:
        numerics_out: dict[str, Any] = {
            "rounds": numerics.get("rounds"),
            "nonfinite_total": numerics.get("nonfinite_total"),
            **(numerics.get("final") or {}),
        }
        separation = numerics.get("separation")
        if separation:
            numerics_out["sep_margin_mean"] = separation.get("margin_mean")
            numerics_out["sep_margin_min"] = separation.get("margin_min")
        out["numerics"] = numerics_out
    counts = {
        "rollbacks": sum(1 for e in events
                         if e.get("kind") == "rollback"),
        "degrades": sum(1 for e in events if e.get("kind") == "degrade"),
    }
    if any(counts.values()):
        out["counts"] = counts
    return out


def cell_event_summaries(events: list[dict[str, Any]]
                         ) -> dict[str, dict[str, Any]]:
    """Group a sweep spool's events by their ``cell`` stamp and
    summarize each slice.  Batched cells' drainer events arrive already
    stamped (``matrix_exec._CellTelemetry``); a fallback cell's own
    spool is not — the executor stamps those at read time before
    calling this."""
    by_cell: dict[str, list[dict[str, Any]]] = {}
    for event in events:
        cell = event.get("cell")
        if isinstance(cell, str):
            by_cell.setdefault(cell, []).append(event)
    out: dict[str, dict[str, Any]] = {}
    for cell, chunk in by_cell.items():
        summary = summarize_cell_events(chunk)
        if summary:
            out[cell] = summary
    return out


def _final_quality(history: list[dict[str, Any]]) -> dict[str, float]:
    final: dict[str, float] = {}
    for entry in history:
        for key in _QUALITY_KEYS:
            value = entry.get(key)
            if (isinstance(value, (int, float))
                    and not isinstance(value, bool) and value == value):
                final[key] = round(value, 6)
    return final


def cell_record(
    *,
    sweep_id: str,
    cell: Cell,
    base_cfg,
    rounds: int,
    history: list[dict[str, Any]],
    run_id: str | None,
    ts: float | None,
    wall_s: float,
    n_cells: int,
    executor: str = "matrix",
    resumed: bool = False,
    provenance: dict[str, Any] | None = None,
    programs: dict[str, Any] | None = None,
    event_summary: dict[str, Any] | None = None,
) -> dict[str, Any]:
    """One cell's ledger record (``ledger_schema`` 1, ``source``
    "matrix").  ``wall_s`` is the SWEEP wall clock: cells share every
    dispatch, so the honest per-cell attribution is the amortized share
    — recorded as such, never dressed up as a standalone measurement.
    ``programs`` is the sweep's program-profile capture — the
    grid program covers every device cell, so each cell record carries
    the SHARED profile (flops/bytes/peak memory of the whole grid
    dispatch), folded into a static ``utilization`` block.
    ``event_summary`` is :func:`summarize_cell_events`'s
    output for this cell — forensics/numerics blocks plus extra
    lifecycle counts, merged in so the science outcome join sees the
    same columns a standalone run's record carries."""
    cfg = cell_config(base_cfg, cell, rounds=rounds)
    ok_rounds = sum(1 for h in history if h.get("ok"))
    amortized = wall_s / max(n_cells, 1)
    record: dict[str, Any] = {
        "ledger_schema": LEDGER_SCHEMA_VERSION,
        "ts": ts,
        "source": "matrix",
        "run_id": run_id,
        "executor": executor,
        "resumed": resumed,
        "fingerprint": config_fingerprint(cfg),
        "sweep_id": sweep_id,
        "cell": cell.key,
        "cell_detail": cell.describe(),
        "mode": cell.defense,
        "model": base_cfg.model,
        "data_name": base_cfg.data_name,
        "total_clients": base_cfg.total_clients,
        "rounds": len(history),
        "ok_rounds": ok_rounds,
        "wall_seconds": round(wall_s, 6),
        "rounds_per_sec_steady": (
            round(len(history) / wall_s, 6) if wall_s > 0 else None),
        "time_attribution": {
            "wall_s": round(wall_s, 6),
            "amortized_cell_wall_s": round(amortized, 6),
        },
        "counts": {
            "rounds_failed": len(history) - ok_rounds,
        },
        "final": _final_quality(history),
    }
    if event_summary:
        for section in ("forensics", "numerics"):
            if event_summary.get(section):
                record[section] = dict(event_summary[section])
        record["counts"].update(event_summary.get("counts") or {})
    if programs:
        from attackfl_tpu_torch.costmodel.roofline import utilization_summary

        record["programs"] = programs
        device_kind = next((p.get("device_kind") for p in programs.values()
                            if isinstance(p, dict)
                            and p.get("device_kind")), "")
        utilization = utilization_summary(programs, None, device_kind)
        if utilization is not None:
            record["utilization"] = utilization
    record.update(provenance or {})
    return record


def sweep_records(
    *,
    sweep_id: str,
    cells: list[Cell],
    histories: dict[str, list[dict[str, Any]]],
    base_cfg,
    rounds: int,
    run_id: str | None,
    ts: float | None,
    wall_s: float,
    resumed: bool = False,
    provenance: dict[str, Any] | None = None,
    programs: dict[str, Any] | None = None,
    event_summaries: dict[str, dict[str, Any]] | None = None,
) -> list[dict[str, Any]]:
    """Records for every cell that has a history, in grid order."""
    summaries = event_summaries or {}
    return [
        cell_record(
            sweep_id=sweep_id, cell=cell, base_cfg=base_cfg, rounds=rounds,
            history=histories.get(cell.key) or [], run_id=run_id, ts=ts,
            wall_s=wall_s, n_cells=len(cells), resumed=resumed,
            provenance=provenance, programs=programs,
            event_summary=summaries.get(cell.key))
        for cell in cells if cell.key in histories
    ]
