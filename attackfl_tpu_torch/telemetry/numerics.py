"""Host-side half of the numerics ring: the k-rounds-late drainer and
the ``metrics --numerics`` report (the port's copy of
``attackfl_tpu/telemetry/numerics.py``).

The device half (:mod:`attackfl_tpu_torch.ops.metrics`) writes one
``(M,)`` float32 row a round into a ring buffer carried in the round
state.  This module turns those rows back into schema-v3 ``metric``
events without fencing the round loop:

* **Fused / pipelined paths** -- the round's row rides the path's
  EXISTING late copy (the chunk's one read in ``run_fast``, the
  pipelined round's pinned copy behind its event), so
  :meth:`NumericsDrainer.push_host_row` receives host numpy and makes
  **no** new read of the card.
* **Synchronous path** -- rows stay on the card in the ring;
  :meth:`NumericsDrainer.drain` reads the whole buffer in ONE
  device-to-host copy every ``window`` rounds (and once at the run's
  end).  That copy is the one read this subsystem adds.

Rows older than ``window`` rounds at drain time have been overwritten
(ring wraparound); they are counted into the ``numerics_rows_dropped``
counter rather than silently lost.  Emitted events carry the full gauge
mapping (non-finite values become ``null``) plus the fixed-bucket
histogram; ``numerics_summary`` / ``format_numerics`` power the
``python -m attackfl_tpu_torch metrics --numerics`` report.  Everything
below the drain call is torch-free, like the rest of the metrics tooling.
"""

from __future__ import annotations

import math
from typing import Any, Callable

import numpy as np


class NumericsDrainer:
    """Resolve device-side numerics rows into ``metric`` events, late."""

    def __init__(self, layout, telemetry, window: int,
                 on_gauges: Callable[[dict], None] | None = None):
        self.layout = layout
        self.window = int(window)
        self._tel = telemetry
        self._on_gauges = on_gauges
        # (round, broadcast) labels of rows still in the device ring,
        # oldest first — the host mirror of the ring cursor, appended by
        # note_round() in the same order the device writes rows
        self._pending: list[tuple[int, int]] = []
        self._written = 0   # rows written device-side (== ring cursor)
        self._drained = 0   # rows already emitted (or dropped)
        self.rows_emitted = 0
        self.rows_dropped = 0

    # ------------------------------------------------------------------
    # fused / pipelined paths: rows arrive already materialized
    # ------------------------------------------------------------------

    def push_host_row(self, round_no: int, broadcast: int, row) -> None:
        """Emit one row that the caller ALREADY holds as host numpy (it
        rode the path's existing late sync) — no device transfer here."""
        self._emit_row(round_no, broadcast, np.ascontiguousarray(row))

    # ------------------------------------------------------------------
    # synchronous path: batched ring drain
    # ------------------------------------------------------------------

    def note_round(self, round_no: int, broadcast: int) -> None:
        """Record that the device wrote one more ring row (the engine
        calls this right after dispatching the numerics step)."""
        self._pending.append((int(round_no), int(broadcast)))
        self._written += 1

    def due(self) -> bool:
        return self._written - self._drained >= self.window

    def maybe_drain(self, num_state) -> int:
        return self.drain(num_state) if self.due() else 0

    def drain(self, num_state) -> int:
        """Materialize every un-emitted ring row and emit it, in cursor
        order.  Returns the number of rows emitted.  Rows overwritten by
        ring wraparound (more than ``window`` rounds since the last
        drain) are dropped and counted."""
        if num_state is None or self._written == self._drained:
            return 0
        # the subsystem's one read of the card: one copy of the whole
        # ring, amortized over up to `window` rounds of metrics
        buffer = num_state["buffer"].cpu().numpy()
        fresh = self._written - self._drained
        dropped = max(0, fresh - self.window)
        if dropped:
            self.rows_dropped += dropped
            self._tel.counters.inc("numerics_rows_dropped", dropped)
            del self._pending[:dropped]
            self._drained += dropped
        while self._drained < self._written:
            round_no, broadcast = self._pending.pop(0)
            self._emit_row(round_no, broadcast,
                           buffer[self._drained % self.window])
            self._drained += 1
        return fresh - dropped

    # ------------------------------------------------------------------
    # emission
    # ------------------------------------------------------------------

    def _emit_row(self, round_no: int, broadcast: int,
                  row: np.ndarray) -> None:
        names = self.layout.names
        gauges: dict[str, float | None] = {}
        for i, name in enumerate(names):
            value = row[i].item()
            gauges[name] = round(value, 6) if math.isfinite(value) else None
        hist = [int(round(row[len(names) + j].item()))
                for j in range(row.shape[0] - len(names))]
        headline = gauges.get("update_norm_all_p95")
        self._tel.events.emit(
            "metric", metric="numerics",
            value=headline if headline is not None else 0.0, unit="l2",
            round=int(round_no), broadcast=int(broadcast),
            numerics=gauges, hist=hist)
        self._tel.counters.inc("numerics_rows")
        self.rows_emitted += 1
        if self._on_gauges is not None:
            self._on_gauges(gauges)


# ---------------------------------------------------------------------------
# the `metrics --numerics` report (jax-free, like summary/forensics)
# ---------------------------------------------------------------------------

def numerics_rows(events: list[dict[str, Any]]) -> list[dict[str, Any]]:
    """One run's numerics ``metric`` events, deduplicated per broadcast
    (multi-process merged streams carry one SPMD-identical row per
    process) and ordered by broadcast."""
    seen: set[tuple[Any, Any]] = set()
    rows: list[dict[str, Any]] = []
    for event in events:
        if event.get("kind") != "metric" or event.get("metric") != "numerics":
            continue
        key = (event.get("run_id"), event.get("broadcast"))
        if key in seen:
            continue
        seen.add(key)
        rows.append(event)
    rows.sort(key=lambda e: (e.get("broadcast") or 0))
    return rows


def _finite(value: Any) -> bool:
    return (isinstance(value, (int, float)) and not isinstance(value, bool)
            and math.isfinite(value))


def numerics_summary(events: list[dict[str, Any]]) -> dict[str, Any] | None:
    """Aggregate one run's numerics events: per-round gauge rows plus the
    attack-separation summary.  Returns None when the run recorded no
    numerics (telemetry.numerics off, or a pre-v3 artifact)."""
    rows = numerics_rows(events)
    if not rows:
        return None
    per_round = [{
        "round": event.get("round"),
        "broadcast": event.get("broadcast"),
        **(event.get("numerics") or {}),
    } for event in rows]
    nonfinite_total = sum(int(r["nonfinite_count"]) for r in per_round
                          if _finite(r.get("nonfinite_count")))
    summary: dict[str, Any] = {
        "rounds": len(per_round),
        "nonfinite_total": nonfinite_total,
        "per_round": per_round,
    }
    separated = [r for r in per_round if _finite(r.get("sep_margin"))]
    if separated:
        margins = [r["sep_margin"] for r in separated]
        cosines = [r["sep_cosine"] for r in separated
                   if _finite(r.get("sep_cosine"))]
        l2s = [r["sep_l2"] for r in separated if _finite(r.get("sep_l2"))]
        summary["separation"] = {
            "rounds": len(separated),
            "margin_mean": round(sum(margins) / len(margins), 6),
            "margin_min": round(min(margins), 6),
            "margin_max": round(max(margins), 6),
            "cosine_mean": (round(sum(cosines) / len(cosines), 6)
                            if cosines else None),
            "l2_mean": round(sum(l2s) / len(l2s), 6) if l2s else None,
        }
    last = per_round[-1]
    summary["final"] = {k: last.get(k) for k in
                        ("update_norm_all_p50", "update_norm_all_p95",
                         "update_norm_all_max", "global_norm",
                         "global_drift", "train_loss")
                        if _finite(last.get(k))}
    return summary


def format_numerics(summary: dict[str, Any],
                    run_id: str | None = None) -> str:
    def fmt(value: Any, width: int = 10) -> str:
        if not _finite(value):
            return f"{'-':>{width}}"
        return f"{value:>{width}.4g}"

    lines = [
        "numerics — device-side round metrics"
        + (f" run {run_id}" if run_id else ""),
        f"rounds with numerics: {summary['rounds']}, "
        f"non-finite client-layer blocks: {summary['nonfinite_total']}",
    ]
    lines.append(f"{'round':<7}{'unorm p50':>10}{'unorm p95':>10}"
                 f"{'unorm max':>10}{'drift':>10}{'loss':>10}"
                 f"{'sep margin':>11}{'nonfinite':>10}")
    for row in summary["per_round"]:
        lines.append(
            f"{row.get('round', '?'):<7}"
            f"{fmt(row.get('update_norm_all_p50'))}"
            f"{fmt(row.get('update_norm_all_p95'))}"
            f"{fmt(row.get('update_norm_all_max'))}"
            f"{fmt(row.get('global_drift'))}"
            f"{fmt(row.get('train_loss'))}"
            f"{fmt(row.get('sep_margin'), 11)}"
            f"{fmt(row.get('nonfinite_count'))}")
    sep = summary.get("separation")
    if sep:
        lines.append(
            f"attack separation over {sep['rounds']} round(s): "
            f"margin mean={sep['margin_mean']:.4g} "
            f"[{sep['margin_min']:.4g}, {sep['margin_max']:.4g}]"
            + (f", cosine mean={sep['cosine_mean']:.4g}"
               if sep.get("cosine_mean") is not None else "")
            + (f", L2 mean={sep['l2_mean']:.4g}"
               if sep.get("l2_mean") is not None else ""))
    else:
        lines.append("attack separation: n/a (no round had both cohorts "
                     "reporting)")
    if summary.get("final"):
        lines.append("final: " + " ".join(
            f"{k}={v:.4g}" for k, v in summary["final"].items()))
    return "\n".join(lines)
