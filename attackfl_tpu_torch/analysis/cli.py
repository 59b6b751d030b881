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
executor, so it is opt-in).

The transform-safety auditor runs by default whenever the programs do, as
JAX's (``analysis/grad_audit.py``: the gradient of the post-defense damage
objective, sync and fused, for each representative defense, and the
double backward; ``analysis/dataflow.py``: the per-defense
differentiability table; the transposed collectives of each defense's
sharded gradient).  ``--grad`` runs it even with ``--skip-programs``;
``--skip-grad`` leaves it out.

With the programs the audit also runs the programs of a client mesh
(``program_audit.audit_sharded_programs`` and
``audit_sharded_matrix_program``), held to the per-defense collective
table; ``--skip-sharded`` leaves them out, as JAX's.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any

from attackfl_tpu_torch.analysis.findings import Finding, sort_findings
from attackfl_tpu_torch.analysis.registry import AuditContext, describe_rules, run_rules

REPORT_SCHEMA = 2


def build_report(skip_programs: bool = False, retrace: bool = False,
                 rule_ids: list[str] | None = None, device: str = "cuda",
                 grad: bool | None = None, skip_sharded: bool = False) -> dict[str, Any]:
    """Run the selected passes and assemble the audit report.  ``grad``
    defaults to following the program audit (on unless ``skip_programs``);
    True or False forces it either way.  ``skip_sharded`` leaves the
    programs of a client mesh out of the program audit."""
    ctx = AuditContext()
    findings: list[Finding] = run_rules(ctx, rule_ids)
    programs: list[dict[str, Any]] = []
    grad_programs: list[dict[str, Any]] = []
    dataflow_table: list[dict[str, Any]] = []
    budget: dict[str, Any] = {}
    if grad is None:
        grad = not skip_programs
    if not skip_programs:
        from attackfl_tpu_torch.analysis import program_audit

        reports = (program_audit.audit_default_programs(device=device)
                   + program_audit.audit_matrix_program(device=device))
        if not skip_sharded:
            # the client mesh's programs, against the per-defense
            # collective table, and the cell-sharded sweep (collective-free)
            reports += (program_audit.audit_sharded_programs(device=device)
                        + program_audit.audit_sharded_matrix_program(device=device))
        programs = [r.to_dict() for r in reports]
        findings.extend(program_audit.reports_to_findings(reports))
        budget = program_audit.transfer_budget()
    if grad:
        from attackfl_tpu_torch.analysis.grad_audit import grad_report

        document = grad_report(device=device)
        grad_programs, dataflow_table = document["programs"], document["dataflow"]
        findings.extend(Finding(**f) for f in document["findings"])
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
        "grad_programs": grad_programs,
        "dataflow": dataflow_table,
        "transfer_budget": budget,
        "ok": not findings,
    }


def _format_program(p: dict[str, Any], prefix: str = "program") -> str:
    if p.get("skipped"):
        return f"{prefix} {p['name']} [{p['executor']}]: SKIPPED — {p['skipped']}"
    status = "OK" if p["ok"] else "FAIL"
    launches = ", ".join(f"{k} {v}" for k, v in p["launches"].items()) or "none"
    return (f"{prefix} {p['name']} [{p['executor']}, {p['device']}]: {status} — "
            f"{p['eqns']} ops, syncs {p['syncs']}, f64 {p['f64_outputs']}, inputs "
            f"written {len(p['inplace_inputs'])} (consumed leaves {p['donated_leaves']}"
            + (f", gradient tree {p['aliased_leaves']}/{p['expected_aliases']} leaves"
               if prefix != "program" and p['donated_leaves'] else "")
            + f"), launches {launches}"
            + (f", collectives {','.join(p['collectives'])}" if p.get("collectives") else "")
            + f", {p['wall_ms']:.1f} ms")


def format_report(report: dict[str, Any]) -> str:
    lines = [Finding(**f).format() for f in report["findings"]]
    lines.extend(_format_program(p) for p in report["programs"])
    lines.extend(_format_program(p, prefix="grad program")
                 for p in report.get("grad_programs") or [])
    for d in report.get("dataflow") or []:
        cliffs = ",".join(sorted({c["primitive"] for c in d["cliffs"]}))
        lines.append(
            f"dataflow {d['name']}: {d['verdict']} — reachability "
            f"{d['reachability']:.3f} ({d['live_eqns']}/{d['touched_eqns']} path ops), "
            f"piecewise={','.join(d['piecewise']) or 'none'}, cliffs={cliffs or 'none'}")
    budget = report.get("transfer_budget") or {}
    if budget:
        lines.append(f"transfer budget: {budget['total']} audited host function(s), "
                     f"allowlist {'resolved' if budget['resolved'] else 'STALE'}")
    n = len(report["findings"])
    lines.append(f"audit: {len(report['rules'])} rule(s), {len(report['programs'])} "
                 f"program(s), {len(report.get('grad_programs') or [])} grad program(s), "
                 f"{len(report.get('dataflow') or [])} dataflow verdict(s), "
                 f"{n} finding(s) — {'OK' if report['ok'] else 'FAIL'}")
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
                        help="skip the programs of a client mesh (the per-defense "
                             "collective table and the cell-sharded sweep)")
    parser.add_argument("--grad", action="store_true",
                        help="run the transform-safety auditor (the damage objectives' "
                             "gradient and double-backward programs and the per-defense "
                             "differentiability table): on by default whenever programs "
                             "are audited; this flag forces it even with --skip-programs")
    parser.add_argument("--skip-grad", action="store_true",
                        help="skip the transform-safety auditor")
    parser.add_argument("--rules", nargs="*", default=None, metavar="RULE",
                        help="run only these rule ids (default: all)")
    args = parser.parse_args(list(sys.argv[1:] if argv is None else argv))

    if args.grad and args.skip_grad:
        parser.error("--grad and --skip-grad are mutually exclusive")
    grad = True if args.grad else (False if args.skip_grad else None)
    if not args.skip_programs or args.retrace or args.grad:
        from attackfl_tpu_torch.device import resolve_device

        resolve_device(args.device)
    report = build_report(skip_programs=args.skip_programs, retrace=args.retrace,
                          rule_ids=args.rules, device=args.device, grad=grad,
                          skip_sharded=args.skip_sharded)
    print(json.dumps(report, indent=2) if args.json else format_report(report))
    return 0 if report["ok"] else 1
