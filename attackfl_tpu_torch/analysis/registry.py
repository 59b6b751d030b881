"""Rule registry + audit context: the lint-framework half of the auditor
(the port's copy of ``attackfl_tpu/analysis/registry.py``).

A *rule* is a named, documented pass producing :class:`~.findings.Finding`
objects.  Rules register themselves via :func:`register` at import time
(importing :mod:`attackfl_tpu_torch.analysis.ast_rules` /
:mod:`attackfl_tpu_torch.analysis.artifacts` populates the registry); the
``audit`` command and the tests run them through :func:`run_rules`.

The :class:`AuditContext` carries what every rule needs — the repo root,
the package root, and a parse cache so the AST rules over one module cost
one ``ast.parse``.  Per-rule allowlists live with the rule that owns them
(the host-sync audited-function allowlist in ``ast_rules``); every rule
declares a ``fix_hint`` that says how to allowlist and why a comment is
required.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Iterable

from attackfl_tpu_torch.analysis.findings import Finding, sort_findings

REPO_ROOT = Path(__file__).resolve().parent.parent.parent
PACKAGE_ROOT = Path(__file__).resolve().parent.parent


@dataclass
class AuditContext:
    """Shared state for one audit run: roots + a per-file parse cache."""

    root: Path = REPO_ROOT
    package: Path = PACKAGE_ROOT
    _trees: dict[Path, ast.Module] = field(default_factory=dict)

    def tree(self, path: Path) -> ast.Module:
        path = Path(path).resolve()
        cached = self._trees.get(path)
        if cached is None:
            cached = ast.parse(path.read_text(), filename=str(path))
            self._trees[path] = cached
        return cached

    def package_sources(self) -> list[Path]:
        """Every package module, analysis/ included (the auditor audits
        itself), stable-sorted for deterministic reports."""
        return sorted(self.package.rglob("*.py"))


@dataclass(frozen=True)
class Rule:
    """One registered pass: id, docs, and the runner."""

    rule_id: str
    description: str
    fix_hint: str
    runner: Callable[[AuditContext], list[Finding]]

    def run(self, ctx: AuditContext) -> list[Finding]:
        return self.runner(ctx)


RULES: dict[str, Rule] = {}
# Passes that run OUTSIDE run_rules (the program auditor and the
# recompile guard run programs, so the command drives them behind
# --skip-programs / --retrace) still declare their rule ids here so
# describe_rules() and the report's rule table document every id a
# Finding can carry.
INFO_RULES: dict[str, Rule] = {}


def register(rule_id: str, description: str, fix_hint: str):
    """Decorator: add a ``Callable[[AuditContext], list[Finding]]`` to the
    registry under ``rule_id``.  Ids are unique by construction."""
    def deco(fn: Callable[[AuditContext], list[Finding]]):
        if rule_id in RULES:
            raise ValueError(f"duplicate rule id {rule_id!r}")
        RULES[rule_id] = Rule(rule_id, description, fix_hint, fn)
        return fn
    return deco


def register_info(rule_id: str, description: str, fix_hint: str) -> None:
    """Document a rule id whose pass runs outside :func:`run_rules`.
    Idempotent re-registration with identical docs is allowed (modules
    re-import); a conflicting id is an error."""
    existing = INFO_RULES.get(rule_id)
    if existing is not None:
        if (existing.description, existing.fix_hint) != (description, fix_hint):
            raise ValueError(f"conflicting info rule id {rule_id!r}")
        return
    if rule_id in RULES:
        raise ValueError(f"duplicate rule id {rule_id!r}")
    INFO_RULES[rule_id] = Rule(rule_id, description, fix_hint, lambda ctx: [])


def load_rules() -> dict[str, Rule]:
    """Import every rule module (idempotent) and return the registry.
    The program and recompile passes only *document* their ids here
    (register_info); their modules import the engine lazily, so this stays
    cheap for --skip-programs runs."""
    from attackfl_tpu_torch.analysis import (  # noqa: F401
        artifacts, ast_rules, dataflow, grad_audit, program_audit, retrace)

    return RULES


def run_rules(ctx: AuditContext | None = None,
              rule_ids: Iterable[str] | None = None) -> list[Finding]:
    """Run the selected rules (default: all) and return sorted findings."""
    rules = load_rules()
    ctx = ctx or AuditContext()
    ids = list(rule_ids) if rule_ids is not None else sorted(rules)
    unknown = [i for i in ids if i not in rules]
    if unknown:
        raise KeyError(f"unknown rule id(s) {unknown}; known: {sorted(rules)}")
    findings: list[Finding] = []
    for rule_id in ids:
        findings.extend(rules[rule_id].run(ctx))
    return sort_findings(findings)


def describe_rules() -> list[dict[str, str]]:
    """Machine-readable rule table for the report: the AST/artifact rules
    run_rules drives plus the documented program and recompile pass ids
    (:func:`register_info`)."""
    load_rules()
    merged = dict(RULES)
    merged.update(INFO_RULES)
    return [{"id": r.rule_id, "description": r.description, "fix_hint": r.fix_hint}
            for _, r in sorted(merged.items())]
