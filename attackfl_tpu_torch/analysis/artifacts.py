"""Event-schema artifact rule: every committed ``events*.jsonl`` validates
(the port's copy of ``attackfl_tpu/analysis/artifacts.py``).

Per-process multi-host files (``events.<i>.jsonl``) are globbed too, and
every line validates through the port's
:func:`attackfl_tpu_torch.telemetry.events.validate_event`, the one its
writers use (schema 14), so tooling and writers cannot disagree.  Older
artifacts stay green: each schema version only adds kinds and optional
fields.
"""

from __future__ import annotations

import json
from pathlib import Path

from attackfl_tpu_torch.analysis.findings import Finding, relativize
from attackfl_tpu_torch.analysis.registry import AuditContext, register

EVENT_SCHEMA_HINT = (
    "regenerate the artifact with the current writers, or — for a new "
    "kind/field — extend REQUIRED_FIELDS in attackfl_tpu_torch/telemetry/events.py and bump "
    "SCHEMA_VERSION")


def find_event_files(path: Path) -> list[Path]:
    path = Path(path)
    if path.is_file():
        return [path]
    return sorted(set(path.rglob("events.jsonl")) |
                  set(path.rglob("events.*.jsonl")) |
                  set(path.rglob("*.events.jsonl")))


def event_schema_findings(path: Path, root: Path | None = None) -> list[Finding]:
    """Validate one JSONL file; one finding per invalid line/field."""
    from attackfl_tpu_torch.telemetry.events import validate_event

    path = Path(path)
    rel = relativize(path, root) if root is not None else str(path)
    findings: list[Finding] = []
    with open(path) as fh:
        for lineno, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            try:
                record = json.loads(line)
            except json.JSONDecodeError as e:
                findings.append(Finding(
                    rule="event-schema", file=rel, line=lineno,
                    message=f"not JSON ({e})", hint=EVENT_SCHEMA_HINT))
                continue
            for problem in validate_event(record):
                findings.append(Finding(
                    rule="event-schema", file=rel, line=lineno,
                    message=problem, hint=EVENT_SCHEMA_HINT))
    return findings


@register(
    "event-schema",
    "every committed events*.jsonl line validates against the telemetry "
    "event schema (telemetry/events.py validate_event)",
    EVENT_SCHEMA_HINT,
)
def _event_schema_rule(ctx: AuditContext) -> list[Finding]:
    findings: list[Finding] = []
    for path in find_event_files(ctx.root):
        findings.extend(event_schema_findings(path, ctx.root))
    return findings
