"""Static profiles × measured device time -> achieved rates + roofline
(the port's copy of ``attackfl_tpu/costmodel/roofline.py``).

The capture layer records what a program's dispatch counted (flops,
bytes, peak memory); the ledger records what the device *measured*
(``round_device_time``).  This module joins them:

* :func:`per_round_cost` normalizes a run's program profiles to
  per-round totals.  A chunked scan program (``fused_scan[16]``) IS the whole round×chunk, so the largest chunk's
  profile divided by its length wins over summing (which would double
  count the length-1 retry-tail program of the same body); a per-round
  program set (sync ``round_step`` + ``aggregate``, the pipelined
  ``pipeline_step``) sums.
* :func:`utilization_summary` divides the per-round totals by the
  measured per-round device seconds into achieved FLOP/s and bytes/s,
  and — when :mod:`~attackfl_tpu_torch.costmodel.peaks` knows the device kind
  — into roofline utilization fractions.  Unknown kinds (CPU) report
  achieved-only by design.

Torch-free: pure arithmetic over JSON-shaped dicts, importable by the
ledger CLI and the monitor alike.
"""

from __future__ import annotations

from typing import Any

from attackfl_tpu_torch.costmodel.peaks import peak_for


def _value(profile: dict[str, Any], key: str) -> int | None:
    value = profile.get(key)
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        return None
    return int(value)


def _rounds(profile: dict[str, Any]) -> int:
    value = profile.get("rounds_per_dispatch")
    if isinstance(value, bool) or not isinstance(value, int) or value < 1:
        return 1
    return value


def per_round_cost(programs: dict[str, dict[str, Any]]
                   ) -> dict[str, Any] | None:
    """Per-round flops / bytes-accessed / transcendentals totals from a
    run's program profiles (see module doc for the chunk-vs-sum rule).
    ``basis`` names the programs the figure came from.  None when no
    profile carries a usable flops or bytes figure."""
    usable = {name: p for name, p in (programs or {}).items()
              if isinstance(p, dict)
              and (_value(p, "flops") is not None
                   or _value(p, "bytes_accessed") is not None)}
    if not usable:
        return None
    chunked = {name: p for name, p in usable.items() if _rounds(p) > 1}
    if chunked:
        name = max(chunked, key=lambda n: _rounds(chunked[n]))
        profile, rounds = chunked[name], _rounds(chunked[name])
        basis = [name]
        totals = {key: _value(profile, key) for key in
                  ("flops", "bytes_accessed", "transcendentals")}
        out = {key: (value / rounds if value is not None else None)
               for key, value in totals.items()}
    else:
        basis = sorted(usable)
        out = {}
        for key in ("flops", "bytes_accessed", "transcendentals"):
            values = [_value(p, key) for p in usable.values()]
            values = [v for v in values if v is not None]
            out[key] = sum(values) if values else None
    return {
        "flops_per_round": out.get("flops"),
        "bytes_per_round": out.get("bytes_accessed"),
        "transcendentals_per_round": out.get("transcendentals"),
        "basis": basis,
    }


def utilization_summary(programs: dict[str, dict[str, Any]],
                        round_device_time: Any,
                        device_kind: Any,
                        mesh_devices: Any = None) -> dict[str, Any] | None:
    """Achieved FLOP/s + bytes/s (and, with a known peak, utilization
    fractions) for one run.  ``round_device_time`` is the ledger's
    measured device seconds per round; None/0 yields the static
    per-round totals with no rates (a crashed run still reports what it
    compiled).

    ``mesh_devices``: on an N-device slice the per-round
    totals are the WHOLE program's work, so the roofline denominator is
    N single-chip peaks — utilization is ``achieved / (N · peak)``.
    Without it a perfectly-scaled 8-chip run would report 8x a chip's
    ceiling.  ``achieved_*_per_sec`` stays the whole-slice rate (the
    scaling-curve quantity); the fraction is what normalizes per chip.
    None/0/1 keeps the single-device math byte-for-byte."""
    cost = per_round_cost(programs)
    if cost is None:
        return None
    out: dict[str, Any] = dict(cost)
    out["device_kind"] = device_kind if isinstance(device_kind, str) else ""
    devices = mesh_devices
    if isinstance(devices, bool) or not isinstance(devices, int) \
            or devices < 2:
        devices = 1
    if devices > 1:
        out["mesh_devices"] = devices
    seconds = round_device_time
    if isinstance(seconds, bool) or not isinstance(seconds, (int, float)) \
            or seconds <= 0:
        seconds = None
    peak = peak_for(device_kind)
    if peak is not None:
        out["peak_flops_per_sec"] = peak["flops_per_sec"]
        out["peak_bytes_per_sec"] = peak["bytes_per_sec"]
    if seconds is not None:
        flops = cost.get("flops_per_round")
        if flops is not None:
            achieved = flops / seconds
            out["achieved_flops_per_sec"] = round(achieved, 3)
            if peak is not None and peak["flops_per_sec"] > 0:
                # 12 decimals: toy CPU programs land at ~1e-6 of a TPU
                # peak — 6 decimals would round a real fraction to zero
                out["utilization_flops"] = round(
                    achieved / (devices * peak["flops_per_sec"]), 12)
        size = cost.get("bytes_per_round")
        if size is not None:
            achieved = size / seconds
            out["achieved_bytes_per_sec"] = round(achieved, 3)
            if peak is not None and peak["bytes_per_sec"] > 0:
                out["utilization_bytes"] = round(
                    achieved / (devices * peak["bytes_per_sec"]), 12)
    return out
