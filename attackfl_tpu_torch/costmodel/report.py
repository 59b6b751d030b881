"""``metrics --programs``: the cost model's offline report (the port's
copy of ``attackfl_tpu/costmodel/report.py``).

Turns a run's schema-v9 ``program_profile`` events back into the
per-program table (flops, bytes accessed, peak scheduled memory,
rounds/dispatch) plus the per-round roofline summary — achieved FLOP/s
and utilization when the run also carries enough ``round``/``chunk``
events to estimate per-round device seconds.

**Multi-process dedup** (the numerics broadcast-dedup discipline,
:func:`attackfl_tpu_torch.telemetry.numerics.numerics_summary`): under a DCN
mesh every process compiles — and therefore profiles — the SAME program,
so a merged event stream carries one profile per host.  Profiles are
deduplicated on (run_id, program, fingerprint): a DCN run reports one
profile per program, not one per host.

Torch-free, like every reader in :mod:`attackfl_tpu_torch.telemetry`.
"""

from __future__ import annotations

from typing import Any

_PROFILE_FIELDS = ("flops", "transcendentals", "bytes_accessed",
                   "rounds_per_dispatch", "cells", "memory")


def profiles_from_events(events: list[dict[str, Any]]
                         ) -> dict[str, dict[str, Any]]:
    """``program_profile`` events -> {program: profile}, deduplicated per
    (run_id, program, fingerprint) — first record wins, so a merged
    multi-process stream yields one profile per program."""
    seen: set[tuple] = set()
    programs: dict[str, dict[str, Any]] = {}
    for event in events:
        if event.get("kind") != "program_profile":
            continue
        name = event.get("program")
        if not isinstance(name, str):
            continue
        key = (event.get("run_id"), name, event.get("fingerprint"))
        if key in seen:
            continue
        seen.add(key)
        profile = {field: event[field] for field in _PROFILE_FIELDS
                   if field in event}
        profile["fingerprint"] = event.get("fingerprint")
        if isinstance(event.get("device_kind"), str):
            profile["device_kind"] = event["device_kind"]
        programs.setdefault(name, profile)
    return programs


def programs_summary(events: list[dict[str, Any]]) -> dict[str, Any] | None:
    """One run's (or one merged stream's) program-cost summary, or None
    when it carries no ``program_profile`` events (a pre-v9 artifact or a
    costmodel-off run)."""
    from attackfl_tpu_torch.costmodel.roofline import utilization_summary
    from attackfl_tpu_torch.telemetry.summary import summarize

    programs = profiles_from_events(events)
    if not programs:
        return None
    device_kind = next((p["device_kind"] for p in programs.values()
                        if p.get("device_kind")), "")
    summary = summarize(events)
    # seconds_per_round_steady is WALL cadence, not pure device time — an
    # upper bound on device seconds, so the achieved rates it yields are
    # lower bounds.  The ledger record (derive_record) uses the mined
    # round_device_time instead; this offline report says which it used.
    seconds = (summary.get("rates") or {}).get("seconds_per_round_steady")
    utilization = utilization_summary(programs, seconds, device_kind)
    if utilization is not None and seconds is not None:
        utilization["denominator"] = "seconds_per_round_steady"
    return {
        "programs": programs,
        "device_kind": device_kind,
        "utilization": utilization,
        "rounds": summary.get("rounds_attempted"),
    }


def _fmt_bytes(value: Any) -> str:
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        return "-"
    size = value + 0.0
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if size < 1024 or unit == "TB":
            return f"{size:.1f}{unit}" if unit != "B" else f"{int(size)}B"
        size /= 1024
    return "-"  # pragma: no cover — loop always returns


def _fmt_count(value: Any) -> str:
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        return "-"
    size = value + 0.0
    for unit in ("", "K", "M", "G", "T", "P"):
        if abs(size) < 1000 or unit == "P":
            return f"{size:.4g}{unit}"
        size /= 1000
    return "-"  # pragma: no cover


def format_programs(summary: dict[str, Any],
                    run_id: str | None = None) -> str:
    lines = [f"program profiles — run {run_id or '<merged>'}"
             + (f" [{summary['device_kind']}]"
                if summary.get("device_kind") else "")]
    lines.append(f"{'program':<28}{'flops':>10}{'bytes':>10}"
                 f"{'peak mem':>10}{'r/disp':>8}")
    for name in sorted(summary.get("programs") or {}):
        profile = summary["programs"][name]
        memory = profile.get("memory") or {}
        lines.append(
            f"{name[:27]:<28}"
            f"{_fmt_count(profile.get('flops')):>10}"
            f"{_fmt_bytes(profile.get('bytes_accessed')):>10}"
            f"{_fmt_bytes(memory.get('peak')):>10}"
            f"{profile.get('rounds_per_dispatch', 1):>8}")
    utilization = summary.get("utilization")
    if utilization:
        parts = [f"flops/round={_fmt_count(utilization.get('flops_per_round'))}",
                 f"bytes/round={_fmt_bytes(utilization.get('bytes_per_round'))}"]
        if utilization.get("achieved_flops_per_sec") is not None:
            parts.append("achieved="
                         + _fmt_count(utilization["achieved_flops_per_sec"])
                         + "FLOP/s")
        if utilization.get("utilization_flops") is not None:
            parts.append(
                f"roofline={100 * utilization['utilization_flops']:.2f}% "
                f"of {_fmt_count(utilization.get('peak_flops_per_sec'))}"
                "FLOP/s peak")
        elif utilization.get("achieved_flops_per_sec") is not None:
            parts.append("(no peak spec for "
                         f"{summary.get('device_kind') or 'this device'}"
                         " — achieved-only)")
        if utilization.get("denominator"):
            parts.append(f"[per-round s = {utilization['denominator']}]")
        lines.append("per-round: " + " ".join(parts))
    return "\n".join(lines)
