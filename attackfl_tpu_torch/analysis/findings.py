"""Structured findings: the one output type every audit pass produces (the
port's copy of ``attackfl_tpu/analysis/findings.py``).

A :class:`Finding` is one violation at one source location — rule id,
severity, repo-relative file, 1-based line, human message and a fix hint.
AST rules, the event-schema artifact check, the program auditor and the
recompile guard all emit this shape, so the ``audit`` command can render
one report (text or ``--json``) and the tests can assert on exact
``(rule, file, line)`` triples.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Any, Iterable

SEVERITIES = ("error", "warning")


@dataclass(frozen=True)
class Finding:
    """One audit violation.

    ``file`` is repo-relative wherever possible (fixture files under a tmp
    dir stay absolute); ``line`` is 1-based (0 = whole-file / program-level
    finding with no single source line).
    """

    rule: str
    file: str
    line: int
    message: str
    severity: str = "error"
    hint: str = ""

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(
                f"severity must be one of {SEVERITIES}, got {self.severity!r}")

    def to_dict(self) -> dict[str, Any]:
        return asdict(self)

    def format(self) -> str:
        loc = f"{self.file}:{self.line}" if self.line else self.file
        text = f"{loc}: [{self.rule}] {self.message}"
        if self.hint:
            text += f"  (fix: {self.hint})"
        return text


def relativize(path: Path | str, root: Path) -> str:
    """Repo-relative POSIX path when ``path`` is under ``root``; the
    original path otherwise (fixtures in tmp dirs, absolute inputs)."""
    p = Path(path)
    try:
        return p.resolve().relative_to(root.resolve()).as_posix()
    except ValueError:
        return str(path)


def sort_findings(findings: Iterable[Finding]) -> list[Finding]:
    """Stable report order: errors first, then by file / line / rule."""
    return sorted(findings, key=lambda f: (f.severity != "error", f.file,
                                           f.line, f.rule, f.message))
