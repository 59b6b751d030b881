"""The audit (the port's counterpart of ``attackfl_tpu/analysis``):
machine-checked guarantees over the invariants the port's performance
claims rest on, behind ``python -m attackfl_tpu_torch audit``.

* :mod:`~attackfl_tpu_torch.analysis.registry` — the lint framework: rule
  registry, audit context, structured findings.
* :mod:`~attackfl_tpu_torch.analysis.ast_rules` — source-level rules:
  host-sync (with live allowlist resolution), donation-after-use,
  retrace-hazard, emit-kind.
* :mod:`~attackfl_tpu_torch.analysis.artifacts` — event-schema validation
  of committed telemetry JSONL.
* :mod:`~attackfl_tpu_torch.analysis.program_audit` — each round program
  run once under a dispatch mode: no host sync, no float64, no in-place
  write to an input it does not consume, and the transfer budget.
* :mod:`~attackfl_tpu_torch.analysis.retrace` — the recompile guard.
* :mod:`~attackfl_tpu_torch.analysis.cli` — the ``audit`` command.
"""

from attackfl_tpu_torch.analysis.findings import Finding, sort_findings
from attackfl_tpu_torch.analysis.registry import (
    AuditContext, Rule, describe_rules, load_rules, run_rules)

__all__ = [
    "AuditContext",
    "Finding",
    "Rule",
    "describe_rules",
    "load_rules",
    "run_rules",
    "sort_findings",
]
