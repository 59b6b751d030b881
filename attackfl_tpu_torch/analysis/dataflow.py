"""Differentiability dataflow: which defenses can a learned adversary
differentiate through?  (The port's ``attackfl_tpu/analysis/dataflow.py``.)

The grad-program audit (:mod:`attackfl_tpu_torch.analysis.grad_audit`)
runs the gradient of the round and checks its invariants, but a program
can run cleanly and still hand the attacker an all-zeros gradient: krum
routes the update through an ``argmin`` index, trimmed-mean through sort
order, and one stray ``detach`` or float->int cast flattens the whole
objective.  This module answers the question from the op graph.

**The graph.**  JAX traces a jaxpr; the port records torch's: the
objective runs once under a ``TorchDispatchMode`` (as the program audit's
``_AuditMode``) that passes every aten op through and records its inputs,
its outputs, whether grad mode was on, and its source line, the innermost
frame outside torch and this module (what the mode's stack gives on any
torch, with no tracer's stack-trace option needed).  Values are tensors
by identity, versioned: an op that writes an argument in place (its
schema says so) makes a new version of it, and of the tensor it is a view
of.  The recording runs the objective; the graph is unrolled, Python
loops and all, so JAX's scan/while liveness fixpoint has no counterpart
here: every iteration is in the graph as its own ops.

**The pass** is JAX's ``_analyze_jaxpr`` over that graph:

* a value *carries gradient* iff it is reachable from the seed (argument
  0's tensors) through ops whose derivative is not identically zero AND
  its dtype can hold one (floating and complex only: an int64 index or a
  bool predicate is a gradient sink by construction);
* :data:`ZERO_GRAD_OPS` (``round``, ``floor``, ``ceil``, ``sign``,
  ``trunc``) and the stop-gradient ops (``detach``, or any op recorded
  under ``no_grad``) kill it even float->float;
* a backward pass marks the values that reach the objective's output
  (neededness), so a dead side output (the values half of an ``argsort``'s
  ``sort``) is no surviving path;
* ops whose needed outputs are all boolean are *control* (the predicate
  of a ``where``) and stay out of the path count;
* a **cliff** is an op where gradient arrives (a live input) and dies (no
  live needed output), classed ``stop_gradient`` / ``integer_cast``
  (``_to_copy`` or ``to`` into an integer or bool dtype) / ``zero_grad``
  and reported as :data:`RULE_STOP_GRADIENT` / :data:`RULE_INTEGER_CAST` /
  :data:`RULE_ZERO_PATH`, but only when the objective's output ends up dead
  (verdict ``flat``).  A defense with selection structure (krum's argmin)
  reports cliffs and a reachability below 1 with no finding: that is the
  per-defense table, not an error.

:data:`PIECEWISE_OPS` are the aten counterparts of JAX's piecewise
primitives (``where``, ``clamp*``, ``maximum``, ``minimum``, ``abs``,
``relu``, ``sort``, ``topk``, ``remainder``, ``index.Tensor``,
``index_select``, ``gather``, ``argmin``, ``argmax``, ``median``,
``kthvalue``).  Op counts differ from JAX's equation counts by
construction; the verdicts are the comparable result.

:func:`defense_dataflow_reports` runs the pass over each defense's
aggregation chain with the attackers' stacked-delta perturbation as the
seed; gmm's and fltracer's keep masks come from the host filter and enter
as the round feeds them, constants (the weights mask).  JAX's committed
table is ``tests/data/grad_audit_report.json``.
"""

from __future__ import annotations

import os
import sys
import sysconfig
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from attackfl_tpu_torch.analysis.findings import Finding, relativize
from attackfl_tpu_torch.analysis.registry import register_info
from attackfl_tpu_torch.ops import pytree as pt

REPO = Path(__file__).resolve().parent.parent.parent

# float->float ops whose derivative is zero almost everywhere
ZERO_GRAD_OPS = frozenset({"round", "floor", "ceil", "sign", "trunc"})
STOP_GRADIENT_OPS = frozenset({"detach"})
CAST_OPS = frozenset({"_to_copy", "to"})
# piecewise-smooth structure: differentiable almost everywhere, with kinks
# or region switches a learned attacker must expect (``index`` is
# ``index.Tensor``, the only overload of the packet)
PIECEWISE_OPS = frozenset({
    "where", "clamp", "clamp_min", "clamp_max", "maximum", "minimum", "abs", "relu",
    "sort", "topk", "remainder", "index", "index_select", "gather", "argmin", "argmax",
    "median", "kthvalue"})

RULE_STOP_GRADIENT = "grad-stop-gradient"
RULE_INTEGER_CAST = "grad-integer-cast"
RULE_ZERO_PATH = "grad-zero-path"

STOP_GRADIENT_HINT = (
    "remove the stop_gradient from the attack-params->objective path (or "
    "move it off the differentiated branch) — it zeroes every cotangent "
    "flowing through it")
INTEGER_CAST_HINT = (
    "a float value on the differentiated path is cast to an integer "
    "dtype; keep a float carrier alongside the index (straight-through "
    "estimator) or restructure so the objective reads float values")
ZERO_PATH_HINT = (
    "the objective only depends on the attack params through zero-"
    "derivative structure (sort order / argmin-argmax indices / round-"
    "floor-ceil-sign); use the selected VALUES, a soft relaxation, or a "
    "different objective")

register_info(
    RULE_STOP_GRADIENT,
    "no stop_gradient on the attack-params->objective path may flatten "
    "the whole damage objective (grad would silently return zeros)",
    STOP_GRADIENT_HINT,
)
register_info(
    RULE_INTEGER_CAST,
    "no float->int cast on the attack-params->objective path may flatten "
    "the whole damage objective (an integer carries no cotangent)",
    INTEGER_CAST_HINT,
)
register_info(
    RULE_ZERO_PATH,
    "the damage objective must keep at least one nonzero-derivative path "
    "from the attack params (sort order / argmin indices / round-floor-"
    "ceil-sign alone is a flat objective)",
    ZERO_PATH_HINT,
)

_CLIFF_RULES = {
    "stop_gradient": (RULE_STOP_GRADIENT, STOP_GRADIENT_HINT),
    "integer_cast": (RULE_INTEGER_CAST, INTEGER_CAST_HINT),
    "zero_grad": (RULE_ZERO_PATH, ZERO_PATH_HINT),
}
# when the objective is flat, report the most specific cause first and
# only that class: a stop_gradient upstream makes every downstream
# zero-grad cliff noise
_CLIFF_PRIORITY = ("stop_gradient", "integer_cast", "zero_grad")

# torch's frames and the standard library's
_SKIP_DIRS = (os.path.dirname(os.path.abspath(torch.__file__)) + os.sep,
              sysconfig.get_paths()["stdlib"] + os.sep)


def _site() -> tuple[str, int]:
    """The innermost frame outside torch, the standard library and this
    module: where the op was issued."""
    frame = sys._getframe(2)
    while frame is not None:
        name = frame.f_code.co_filename
        if name != __file__ and not name.startswith(_SKIP_DIRS) and not name.startswith("<"):
            return name, frame.f_lineno
        frame = frame.f_back
    return "<unknown>", 0


def _tensors(obj: Any) -> list[torch.Tensor]:
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (list, tuple)):
        return [t for x in obj for t in _tensors(x)]
    if isinstance(obj, dict):
        return [t for x in obj.values() for t in _tensors(x)]
    return []


@dataclass
class _Node:
    name: str
    inputs: list[int]
    outputs: list[int]
    site: tuple[str, int]
    no_grad: bool


class _Recorder(TorchDispatchMode):
    """Records every aten op as a node over versioned values; passes the op
    through unchanged."""

    def __init__(self):
        super().__init__()
        self.nodes: list[_Node] = []
        self.dtype: dict[int, torch.dtype] = {}
        self._version: dict[int, int] = {}     # id(tensor) -> current value
        self._base: dict[int, torch.Tensor] = {}  # id(view) -> the tensor it views
        self._keep: list[torch.Tensor] = []    # every tensor seen, so ids stay unique

    def value(self, t: torch.Tensor) -> int:
        """The current value of ``t``: a constant the first time it is seen."""
        key = id(t)
        if key not in self._version:
            self._keep.append(t)
            return self._new(t)
        return self._version[key]

    def _new(self, t: torch.Tensor) -> int:
        vid = len(self.dtype)
        self.dtype[vid] = t.dtype
        self._version[id(t)] = vid
        return vid

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "prim":
            return out
        schema = func._schema
        inputs, written = [], []
        for i, arg in enumerate(schema.arguments):
            value = kwargs.get(arg.name) if arg.kwarg_only or i >= len(args) else args[i]
            ts = _tensors(value)
            inputs.extend(self.value(t) for t in ts)
            if arg.alias_info is not None and arg.alias_info.is_write:
                written.extend(ts)
        outputs = []
        for t in written:
            outputs.append(self._new(t))
            base = self._base.get(id(t))
            if base is not None:   # a write into a view writes the tensor it views
                inputs.append(self.value(base))
                outputs.append(self._new(base))
        seen = {id(t) for t in written}
        views = [r.alias_info is not None and not r.alias_info.is_write for r in schema.returns]
        first = next(iter(_tensors(args)), None)
        for k, t in enumerate(_tensors(out)):
            if id(t) in seen:
                continue
            self._keep.append(t)
            outputs.append(self._new(t))
            if first is not None and (views[k] if k < len(views) else any(views)):
                self._base[id(t)] = self._base.get(id(first), first)
        self.nodes.append(_Node(str(func.overloadpacket.__name__), inputs, outputs, _site(),
                                not torch.is_grad_enabled()))
        return out


def _inexact(dtype: torch.dtype) -> bool:
    return dtype.is_floating_point or dtype.is_complex


class _Collector:
    """Path accounting and cliff records."""

    def __init__(self):
        self.touched = 0
        self.live = 0
        self.cliffs: list[dict[str, Any]] = []
        self.piecewise: set[str] = set()

    def record(self, node: _Node, live_out: bool, dtype: dict[int, torch.dtype]) -> None:
        self.touched += 1
        if node.name in PIECEWISE_OPS:
            self.piecewise.add(node.name)
        if live_out:
            self.live += 1
            return
        if node.name in STOP_GRADIENT_OPS or node.no_grad:
            kind = "stop_gradient"
        elif node.name in CAST_OPS and any(
                not _inexact(dtype[v]) for v in node.outputs):
            kind = "integer_cast"
        else:
            kind = "zero_grad"
        file, line = node.site
        self.cliffs.append({"kind": kind, "primitive": node.name, "file": file, "line": line})


def _analyze(rec: _Recorder, seeds: list[int], outputs: list[int], col: _Collector) -> bool:
    """Forward gradient liveness from ``seeds`` with the backward
    neededness of ``outputs``; True when an output carries gradient."""
    needed = set(outputs)
    for node in reversed(rec.nodes):
        if any(v in needed for v in node.outputs):
            needed.update(node.inputs)
    live = {v for v in seeds if _inexact(rec.dtype[v])}
    for node in rec.nodes:
        in_live = any(v in live for v in node.inputs)
        if (in_live and node.name not in ZERO_GRAD_OPS and node.name not in STOP_GRADIENT_OPS
                and not node.no_grad):
            live.update(v for v in node.outputs if _inexact(rec.dtype[v]))
        needed_outs = [v for v in node.outputs if v in needed]
        if (in_live and needed_outs
                and not all(rec.dtype[v] == torch.bool for v in needed_outs)):
            col.record(node, any(v in live for v in needed_outs), rec.dtype)
    return any(v in live for v in outputs)


@dataclass
class DataflowReport:
    """Differentiability verdict for one attack-params->objective path
    (JSON-ready via ``to_dict``, JAX's keys; ``live_eqns`` and
    ``touched_eqns`` count aten ops)."""

    name: str
    verdict: str            # smooth | piecewise | partial | flat
    reachability: float     # live path ops / touched path ops
    live_eqns: int
    touched_eqns: int
    piecewise: list[str]
    cliffs: list[dict[str, Any]] = field(default_factory=list)

    @property
    def flat(self) -> bool:
        return self.verdict == "flat"

    def to_dict(self) -> dict[str, Any]:
        return {
            "name": self.name, "verdict": self.verdict,
            "reachability": self.reachability,
            "live_eqns": self.live_eqns, "touched_eqns": self.touched_eqns,
            "piecewise": list(self.piecewise),
            "cliffs": [dict(c) for c in self.cliffs],
        }


def analyze_objective(name: str, objective: Callable, args: tuple) -> DataflowReport:
    """Record ``objective(*args)`` (a 0-dim tensor) and run the pass with
    argument 0's tensors as the gradient seed.  The objective runs once,
    on the arguments' device."""
    rec = _Recorder()
    seeds = [rec.value(t) for t in _tensors(args[0])]
    with rec:
        out = objective(*args)
    col = _Collector()
    out_live = _analyze(rec, seeds, [rec.value(t) for t in _tensors(out)], col)
    # one source site can surface several times (a loop, a helper called
    # per leaf): report it once
    seen: set[tuple] = set()
    cliffs = []
    for c in col.cliffs:
        c = dict(c, file=relativize(c["file"], REPO))
        key = (c["kind"], c["primitive"], c["file"], c["line"])
        if key not in seen:
            seen.add(key)
            cliffs.append(c)
    if not out_live:
        verdict = "flat"
    elif cliffs:
        verdict = "partial"
    elif col.piecewise:
        verdict = "piecewise"
    else:
        verdict = "smooth"
    reach = 1.0 if col.touched == 0 else col.live / col.touched
    return DataflowReport(
        name=name, verdict=verdict, reachability=round(reach, 4),
        live_eqns=col.live, touched_eqns=col.touched,
        piecewise=sorted(col.piecewise), cliffs=cliffs)


def dataflow_findings(report: DataflowReport) -> list[Finding]:
    """Findings for one report: only a FLAT objective is an error (the
    attack params reach the objective through no nonzero-derivative path,
    so its gradient is exact zeros).  The most specific cliff class present
    is reported (stop_gradient > integer_cast > zero_grad)."""
    if not report.flat:
        return []
    for kind in _CLIFF_PRIORITY:
        culprits = [c for c in report.cliffs if c["kind"] == kind]
        if culprits:
            break
    else:
        culprits, kind = [], "zero_grad"
    rule, hint = _CLIFF_RULES[kind]
    if not culprits:
        return [Finding(
            rule=RULE_ZERO_PATH, file=f"<objective:{report.name}>", line=0,
            message=f"objective {report.name!r} is flat in the attack "
                    "params: no gradient-carrying path reaches the output",
            hint=ZERO_PATH_HINT)]
    return [Finding(
        rule=rule, file=c["file"], line=c["line"],
        message=f"objective {report.name!r} is flat in the attack params: "
                f"gradient dies at `{c['primitive']}` ({c['kind']})",
        hint=hint)
        for c in culprits]


def analyze_fixture(path: Path) -> tuple[DataflowReport, list[Finding]]:
    """Run the pass on a fixture module exposing ``objective`` and
    ``example_args()``."""
    import importlib.util

    path = Path(path)
    spec = importlib.util.spec_from_file_location(path.stem, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    report = analyze_objective(path.stem, module.objective, tuple(module.example_args()))
    return report, dataflow_findings(report)


# the defense modes of the table (JAX's PSUM_MODES | GATHER_MODES)
DEFENSE_MODES = ("FLTrust", "byzantine", "fedavg", "fltracer", "gmm", "krum", "median",
                 "scionfl", "shieldfl", "trimmed_mean")


def damage(aggregate: Callable) -> Callable:
    """The aggregate-level damage objective of JAX's table:
    ``damage(perturb, params, stacked, sizes, wmask, draws)``, the
    aggregate of ``stacked + perturb`` and the sum of squares of its move
    from ``params``."""
    def objective(perturb, params, stacked, sizes, wmask, draws):
        new = aggregate(params, pt.tree_map(torch.add, stacked, perturb), sizes, wmask, draws)
        return pt.sq_distance(new, params)
    return objective


def defense_inputs(cfg, params: dict | None = None, device: str = "cpu",
                   perturb: dict | None = None) -> tuple[dict[str, torch.Tensor], tuple]:
    """The table's inputs for ``cfg`` (:func:`config.audit_config`): its
    test set on ``device``, and ``(perturb, params, stacked, sizes, wmask,
    draws)``: ``params`` (default: the model's init at seed 0) broadcast
    to ``total_clients`` rows, sizes and the weights mask all ones (JAX
    dataflow.py:352-366), ``perturb`` zeros unless given, and one round's
    draws from a generator seeded 0 (ScionFL's uniforms, FLTrust's root
    shuffles and seed)."""
    from attackfl_tpu_torch.data.partition import draw_round
    from attackfl_tpu_torch.data.synthetic import get_dataset
    from attackfl_tpu_torch.registry import get_model
    from attackfl_tpu_torch.training.round import ROOT_SIZE

    device = torch.device(device)
    model = get_model(cfg.model)
    test = {k: torch.as_tensor(v, device=device)
            for k, v in get_dataset(cfg.data_name, "test", cfg.test_size,
                                    cfg.random_seed).items()}
    if params is None:
        params = model.init(torch.Generator().manual_seed(0), device)
    n = cfg.total_clients
    stacked = pt.tree_broadcast(params, n)
    sizes = torch.ones(n, dtype=torch.int64, device=device)
    wmask = torch.ones(n, dtype=torch.float32, device=device)
    if perturb is None:
        perturb = pt.tree_map(lambda x: torch.zeros(x.shape, dtype=x.dtype, device=device),
                              stacked)
    draws = draw_round(
        torch.Generator(device=device).manual_seed(0), num_clients=n,
        pool_size=cfg.train_size, lo=cfg.num_data_range[0], hi=cfg.num_data_range[1],
        epochs=cfg.epochs, num_genuine=n, leak_groups=(), leak_k=1,
        num_params=sum(x.numel() for x in pt.tree_leaves(params)), quantize=True,
        root_size=min(ROOT_SIZE, test["label"].shape[0]))
    return test, (perturb, params, stacked, sizes, wmask, draws)


def defense_dataflow_reports(modes: tuple[str, ...] | None = None, device: str = "cpu",
                             params: dict | None = None) -> list[DataflowReport]:
    """The per-defense gradient-reachability table: for every defense
    mode, the pass over attacker-perturbed stacked deltas -> aggregate ->
    post-defense damage (JAX ``defense_dataflow_reports``) on
    :func:`defense_inputs`, recorded on ``device``."""
    import tempfile

    from attackfl_tpu_torch.config import audit_config
    from attackfl_tpu_torch.registry import get_model
    from attackfl_tpu_torch.training.round import build_aggregator

    modes = DEFENSE_MODES if modes is None else modes
    with tempfile.TemporaryDirectory(prefix="attackfl_audit_") as scratch:
        cfg0 = audit_config(scratch)
        test, args = defense_inputs(cfg0, params, device)
        model = get_model(cfg0.model)
        return [analyze_objective(f"defense:{mode}", damage(build_aggregator(
                    model, cfg0.replace(mode=mode), test)), args)
                for mode in modes]


def defense_findings(reports: list[DataflowReport] | None = None,
                     device: str = "cpu") -> list[Finding]:
    """Clean-tree gate: findings across the per-defense table (a defense
    whose damage objective went flat fails the audit)."""
    if reports is None:
        reports = defense_dataflow_reports(device=device)
    return [f for report in reports for f in dataflow_findings(report)]
