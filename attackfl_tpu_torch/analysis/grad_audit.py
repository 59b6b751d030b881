"""Grad-program audit: the round's invariants survive the gradient (the
port's ``attackfl_tpu/analysis/grad_audit.py``).

A learned attacker differentiates a scalar post-defense damage objective
through the round: local training, the attack templates, aggregation, the
defense.  The engine exposes those objectives
(:meth:`Simulator.damage_objective`: ``sync_damage``, the round step then
the aggregate, and ``fused_damage[2]``, two fused broadcasts, local Adam
training included).  For each mode of :data:`GRAD_MODES` and each
objective, :func:`audit_grad_programs` checks:

* **the first-order program** — ``torch.autograd.grad`` of the objective
  with respect to argument 0 (:func:`first_order`; autograd, not
  ``torch.func.grad``, so that the round's in-place writes into its own
  tensors stay legal) runs once through the program audit
  (``program_audit.audit_program``): no host sync, no float64 output, no
  input written in place.  JAX lowers the program and checks that the
  donated perturbation aliases its gradient 1:1; the port has no donation,
  and checks what makes the aliasing possible: the gradient has the
  perturbation's exact tree (paths, shapes, dtypes, device), reported as
  ``aliased_leaves`` against ``expected_aliases``.
* **the double backward** (:func:`double_backward`, the gradient of
  ½‖g‖²) of each mode's ``sync_damage``, traced on fake tensors
  (``FakeTensorMode``; K3's wrapper returns its masks' shapes there) and
  not run, as JAX audits it at the jaxpr level only: its syncs (a
  data-dependent read, which fake tensors cannot answer, counts as one
  and ends the trace) and float64 outputs.  One trace a mode; the fused
  objective's double backward, third order through local training when
  its first broadcast attacks, traces too (tests/test_torch_port_grad_audit.py).

The mesh half (:func:`audit_grad_collectives`, JAX's transposed
collective table) is not ported: its reports are marked skipped, naming
ROADMAP item 14, as the sharded programs are.  Not checked either: JAX's
scan/while fixpoint of the dataflow pass, which has no counterpart in an
unrolled recording (``analysis/dataflow.py``).
"""

from __future__ import annotations

import functools
import operator
import tempfile
import time
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from attackfl_tpu_torch.analysis.program_audit import (
    SHARDED_ITEM, WIDE_DTYPES, ProgramReport, _site, _tensor_leaves, audit_program,
    reports_to_findings,
)
from attackfl_tpu_torch.analysis.registry import register_info
from attackfl_tpu_torch.ops import pytree as pt

# a mean defense, an order-statistic defense, an anchor/trust defense
GRAD_MODES = ("fedavg", "median", "FLTrust")

GRAD_AUDIT_HINT = (
    "the grad/double-backward program broke a round invariant — look for "
    "a host read on the differentiated path (.item(), int(), bool() of a "
    "tensor), an f64 promotion, an in-place write into an input, or a "
    "gradient whose tree is not the perturbation's")

register_info(
    "grad-audit",
    "the gradient of the post-defense damage objective (sync + fused, per "
    "representative defense) runs with no host sync, no float64 output and "
    "no input written in place, its tree the perturbation's; the double "
    "backward traces on fake tensors sync-free and f64-free; the mesh "
    f"collective duals are skipped: not ported yet ({SHARDED_ITEM})",
    GRAD_AUDIT_HINT,
)


def _with_grad(perturb: dict) -> tuple[dict, list[torch.Tensor]]:
    """``perturb`` as fresh leaves requiring grad (aliases: nothing is
    written), and those leaves."""
    p = pt.tree_map(lambda x: x.detach().requires_grad_(), perturb)
    return p, pt.tree_leaves(p)


def _as_tree(p: dict, leaves: list[torch.Tensor], grads) -> dict:
    """The gradient as ``p``'s tree, zeros where a leaf is unused."""
    by_leaf = {id(x): g for x, g in zip(leaves, grads)}
    return pt.tree_map(lambda x: torch.zeros_like(x) if by_leaf[id(x)] is None
                       else by_leaf[id(x)], p)


def value_and_grad(objective: Callable) -> Callable:
    """``value_and_grad(perturb, *rest) -> (value, tree)``: the value of
    ``objective(perturb, *rest)`` (detached) and its gradient with respect
    to ``perturb``."""
    def both(perturb, *rest):
        p, leaves = _with_grad(perturb)
        with torch.enable_grad():
            value = objective(p, *rest)
            grads = torch.autograd.grad(value, leaves, allow_unused=True)
        return value.detach(), _as_tree(p, leaves, grads)
    return both


def first_order(objective: Callable) -> Callable:
    """``grad(perturb, *rest) -> tree``: the gradient of
    ``objective(perturb, *rest)`` with respect to ``perturb``."""
    both = value_and_grad(objective)
    return lambda perturb, *rest: both(perturb, *rest)[1]


def double_backward(objective: Callable) -> Callable:
    """``grad`` of the squared gradient norm, ½‖∇objective‖²: the
    canonical second-order program (JAX ``double_backward``)."""
    def grad2(perturb, *rest):
        p, leaves = _with_grad(perturb)
        with torch.enable_grad():
            value = objective(p, *rest)
            g = torch.autograd.grad(value, leaves, create_graph=True, allow_unused=True)
            half = 0.5 * functools.reduce(
                operator.add, [torch.sum(x * x) for x in g if x is not None])
            grads = (torch.autograd.grad(half, leaves, allow_unused=True)
                     if half.requires_grad else [None] * len(leaves))
        return _as_tree(p, leaves, grads)
    return grad2


def tree_check(perturb: dict) -> Callable[[Any], list[str]]:
    """``check(grad) -> problems``: the gradient must have ``perturb``'s
    exact tree, every leaf at its path with its shape, dtype and device."""
    want = [(path, tuple(x.shape), x.dtype, x.device) for path, x in pt.tree_items(perturb)]

    def check(grad) -> list[str]:
        got = ([(path, tuple(x.shape), x.dtype, x.device) for path, x in pt.tree_items(grad)]
               if isinstance(grad, dict) else [])
        check.matched = len(set(got) & set(want))
        if got == want:
            return []
        wrong = [w for w in want if w not in got][:3]
        return [f"the gradient's tree is not the perturbation's: {len(got)} leaves against "
                f"{len(want)}, first differing {wrong}"]
    check.matched = 0
    return check


class _TraceMode(TorchDispatchMode):
    """Counts the ops of a fake-tensor trace and its float64 outputs, and
    records a data-dependent read, which fake tensors refuse, as a sync."""

    def __init__(self):
        super().__init__()
        self.ops = 0
        self.distinct: set[str] = set()
        self.syncs: list[str] = []
        self.f64: list[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import (
            DataDependentOutputException, DynamicOutputShapeException,
        )

        name = str(func.overloadpacket.__name__)
        try:
            out = func(*args, **(kwargs or {}))
        except (DataDependentOutputException, DynamicOutputShapeException) as e:
            self.syncs.append(f"aten.{name} ({type(e).__name__}: the trace stopped) @ {_site()}")
            raise
        if func.namespace == "prim":
            return out
        self.ops += 1
        self.distinct.add(name)
        for _, t in _tensor_leaves(out):
            if t.dtype in WIDE_DTYPES:
                self.f64.append(f"aten.{name} -> {t.dtype} @ {_site()}")
                break
        return out


def trace_program(name: str, executor: str, fn: Callable, args: tuple,
                  device: torch.device | str) -> ProgramReport:
    """Trace ``fn(*args)`` on fake tensors (nothing runs on the device):
    its syncs and float64 outputs, as JAX's ``audit_jaxpr_program``."""
    from torch._subclasses.fake_tensor import (
        DataDependentOutputException, DynamicOutputShapeException, FakeTensorMode,
    )

    mode = _TraceMode()
    t0 = time.perf_counter()
    with FakeTensorMode(allow_non_fake_inputs=True):
        try:
            with mode:
                fn(*args)
        except (DataDependentOutputException, DynamicOutputShapeException):
            pass   # recorded by the mode as a sync
    report = ProgramReport(
        name=name, executor=executor, device=torch.device(device).type, ops=mode.ops,
        distinct_ops=len(mode.distinct), syncs=mode.syncs, f64=mode.f64, donated_args=(),
        donated_leaves=0, writes={}, launches={}, wall_ms=(time.perf_counter() - t0) * 1e3)
    if report.syncs:
        report.problems.append(
            f"{len(report.syncs)} host sync(s) in a grad program: " + "; ".join(report.syncs[:5]))
    if report.f64:
        report.problems.append(
            f"{len(report.f64)} float64/complex output(s) in the grad program — unexpected "
            "wide-dtype promotion under autograd: " + "; ".join(report.f64[:5]))
    return report


def audit_objectives(sim, mode: str) -> list[ProgramReport]:
    """The grad reports of one Simulator's damage objectives, named
    ``{mode}:grad[...]`` and ``{mode}:grad2[sync_damage]``."""
    reports: list[ProgramReport] = []
    for entry in sim.damage_objective():
        perturb = entry["args"][0]
        check = tree_check(perturb)
        report = audit_program(
            f"{mode}:grad[{entry['name']}]", entry["executor"],
            first_order(entry["objective"]), entry["args"], entry["donate"],
            device=sim.device, check_output=check)
        report.aliased = check.matched
        reports.append(report)
        if entry["name"] == "sync_damage":
            reports.append(trace_program(
                f"{mode}:grad2[{entry['name']}]", entry["executor"],
                double_backward(entry["objective"]), entry["args"], sim.device))
    return reports


def audit_grad_programs(modes: tuple[str, ...] = GRAD_MODES,
                        device: str = "cuda") -> list[ProgramReport]:
    """For each mode: the first-order gradient of every damage objective
    the engine exposes, run once under the program audit with its tree
    checked, and the double backward of ``sync_damage`` traced on fake
    tensors, at :func:`config.audit_config` on ``device``."""
    from attackfl_tpu_torch.config import audit_config
    from attackfl_tpu_torch.training.engine import Simulator

    reports: list[ProgramReport] = []
    for mode in modes:
        with tempfile.TemporaryDirectory(prefix="attackfl_audit_") as scratch:
            sim = Simulator(audit_config(scratch, mode=mode), device=device)
            try:
                reports.extend(audit_objectives(sim, mode))
            finally:
                sim.close()
    return reports


def audit_grad_collectives(modes: tuple[str, ...] = GRAD_MODES,
                           device: str = "cuda") -> list[ProgramReport]:
    """The mesh half (JAX: the transposed collectives of each defense's
    sharded gradient): not ported, each report marked skipped."""
    return [ProgramReport(
        name=f"sharded-{mode}:grad[aggregate]", executor="sync",
        device=torch.device(device).type, ops=0, distinct_ops=0, syncs=[], f64=[],
        donated_args=(), donated_leaves=0, writes={}, launches={}, wall_ms=0.0,
        skipped=f"the sharded programs are not ported yet ({SHARDED_ITEM})")
        for mode in modes]


def grad_report(modes: tuple[str, ...] = GRAD_MODES,
                dataflow_modes: tuple[str, ...] | None = None,
                device: str = "cuda") -> dict[str, Any]:
    """The transform-safety document (JAX ``grad_report``): the grad and
    double-backward reports, the skipped mesh reports and the per-defense
    dataflow table; ``findings`` (dicts) are the programs' problems under
    the rule ``grad-audit`` and the table's findings, which ``audit``
    merges into its report."""
    from attackfl_tpu_torch.analysis import dataflow

    programs = audit_grad_programs(modes, device) + audit_grad_collectives(modes, device)
    reports = dataflow.defense_dataflow_reports(dataflow_modes, device=device)
    findings = (reports_to_findings(programs, rule="grad-audit")
                + dataflow.defense_findings(reports))
    return {
        "grad_modes": list(modes),
        "programs": [p.to_dict() for p in programs],
        "dataflow": [r.to_dict() for r in reports],
        "findings": [f.to_dict() for f in findings],
        "ok": (not findings) and all(p.ok for p in programs),
    }
