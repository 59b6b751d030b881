"""``python -m attackfl_tpu_torch audit``: one command over every audit pass
(the port's counterpart of ``attackfl_tpu/analysis/cli.py``).

Runs the AST rules (host-sync, donation-after-use, retrace-hazard,
emit-kind), the event-schema artifact check and the program audit (each
round program run once under a dispatch mode, on ``--device``), then
prints a report: text by default, the JAX package's schema-2 JSON document
with ``--json`` (its keys: ``schema, tool, rules, findings, programs,
grad_programs, dataflow, transfer_budget, ok``).  Exit 0 when the tree is
clean, 1 otherwise.

``--retrace`` also runs the recompile guard (it runs a few rounds on each
executor, so it is opt-in).  Not ported yet, and said so in the report's
rule table: the transform-safety auditor (``--grad``, refused; the
``grad_programs`` and ``dataflow`` sections stay empty; ROADMAP.md queue 1,
item 16e) and the sharded programs (``--skip-sharded`` is accepted; item
14).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any

from attackfl_tpu_torch.analysis.findings import Finding, sort_findings
from attackfl_tpu_torch.analysis.program_audit import GRAD_ITEM, SHARDED_ITEM
from attackfl_tpu_torch.analysis.registry import AuditContext, describe_rules, run_rules

REPORT_SCHEMA = 2


def build_report(skip_programs: bool = False, retrace: bool = False,
                 rule_ids: list[str] | None = None, device: str = "cuda") -> dict[str, Any]:
    """Run the selected passes and assemble the audit report."""
    ctx = AuditContext()
    findings: list[Finding] = run_rules(ctx, rule_ids)
    programs: list[dict[str, Any]] = []
    budget: dict[str, Any] = {}
    if not skip_programs:
        from attackfl_tpu_torch.analysis import program_audit

        reports = (program_audit.audit_default_programs(device=device)
                   + program_audit.audit_matrix_program(device=device))
        programs = [r.to_dict() for r in reports]
        findings.extend(program_audit.reports_to_findings(reports))
        budget = program_audit.transfer_budget()
    if retrace:
        from attackfl_tpu_torch.analysis.retrace import guard_findings

        findings.extend(guard_findings(device=device))
    findings = sort_findings(findings)
    return {
        "schema": REPORT_SCHEMA,
        "tool": "attackfl_tpu_torch audit",
        "rules": describe_rules(),
        "findings": [f.to_dict() for f in findings],
        "programs": programs,
        "grad_programs": [],
        "dataflow": [],
        "transfer_budget": budget,
        "ok": not findings,
    }


def _format_program(p: dict[str, Any]) -> str:
    status = "OK" if p["ok"] else "FAIL"
    launches = ", ".join(f"{k} {v}" for k, v in p["launches"].items())
    return (f"program {p['name']} [{p['executor']}, {p['device']}]: {status} — "
            f"{p['eqns']} ops, syncs {p['syncs']}, f64 {p['f64_outputs']}, inputs "
            f"written {p['aliased_leaves']} (consumed leaves {p['donated_leaves']}), "
            f"launches {launches}, {p['wall_ms']:.1f} ms")


def format_report(report: dict[str, Any]) -> str:
    lines = [Finding(**f).format() for f in report["findings"]]
    lines.extend(_format_program(p) for p in report["programs"])
    budget = report.get("transfer_budget") or {}
    if budget:
        lines.append(f"transfer budget: {budget['total']} audited host function(s), "
                     f"allowlist {'resolved' if budget['resolved'] else 'STALE'}")
    lines.append(f"not ported yet: the grad audit and the dataflow table ({GRAD_ITEM}); "
                 f"the sharded programs ({SHARDED_ITEM})")
    n = len(report["findings"])
    lines.append(f"audit: {len(report['rules'])} rule(s), {len(report['programs'])} "
                 f"program(s), {n} finding(s) — {'OK' if report['ok'] else 'FAIL'}")
    return "\n".join(lines)


def audit_main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m attackfl_tpu_torch audit",
        description="The port's audit: AST rules + event-schema artifacts + "
                    "the round programs' invariants.")
    parser.add_argument("--json", action="store_true",
                        help="the schema-2 JSON report on stdout")
    parser.add_argument("--skip-programs", action="store_true",
                        help="AST/artifact rules only (no program runs — fast)")
    parser.add_argument("--retrace", action="store_true",
                        help="also run the recompile guard (RUNS 3 rounds on each "
                             "executor)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="where the programs run: cuda (default) or cpu")
    parser.add_argument("--skip-sharded", action="store_true",
                        help="accepted: the sharded programs are not ported yet "
                             f"({SHARDED_ITEM})")
    parser.add_argument("--grad", action="store_true",
                        help=f"the transform-safety auditor: not ported yet ({GRAD_ITEM})")
    parser.add_argument("--rules", nargs="*", default=None, metavar="RULE",
                        help="run only these rule ids (default: all)")
    args = parser.parse_args(list(sys.argv[1:] if argv is None else argv))

    if args.grad:
        print(f"audit --grad, the transform-safety auditor, is not ported yet ({GRAD_ITEM})",
              file=sys.stderr)
        return 2
    if not args.skip_programs or args.retrace:
        from attackfl_tpu_torch.device import resolve_device

        resolve_device(args.device)
    report = build_report(skip_programs=args.skip_programs, retrace=args.retrace,
                          rule_ids=args.rules, device=args.device)
    print(json.dumps(report, indent=2) if args.json else format_report(report))
    return 0 if report["ok"] else 1
