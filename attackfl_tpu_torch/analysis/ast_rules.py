"""AST rules: the source-level half of the auditor (the port's counterpart
of ``attackfl_tpu/analysis/ast_rules.py``, with its four rule ids).

Four rules over the port's Python sources:

* ``host-sync`` — no host-device sync on the round's hot path outside the
  audited allowlist.  The sync shapes are torch's: ``.item()``,
  ``.tolist()``, ``.cpu()``, ``.numpy()``, ``float|int|bool(<expr>)``,
  ``np.asarray``/``np.array``, ``torch.cuda.synchronize`` and
  ``<event or stream>.synchronize()``.  The linted file set is
  *discovered*: every source under ``attackfl_tpu_torch/`` must classify
  against the TRACED_ONLY / HOST_SIDE prefix registries, each entry with
  its reason, and an unclassified file is itself a finding.  The
  allowlist is *resolved against the live modules*: an allowlisted
  qualified name that no longer exists is itself a finding.
* ``donation-after-use`` — the port expresses JAX's donation as a
  program writing its inputs in place.  A file declares what its programs
  consume in a module-level ``DONATION_SPEC`` literal (program name ->
  argument positions, the engine's :meth:`Simulator.donation_spec`); a
  read, after a ``._dispatch("<program>", fn, *args)`` call, of an
  argument the spec says that program consumes is a finding (a rebind in
  between makes the read refer to the call's result).  The engine's spec
  is empty, so on the tree the rule finds nothing.
* ``retrace-hazard`` — patterns that rebuild a program after round 1: a
  call that builds a program (``_build_fused_body``,
  ``build_local_update``, ``StepGraph(...)``, a kernel library's
  ``load_library``) inside a loop; a Python scalar conversion (``float()``/``int()``/``bool()``)
  used as the key of a cached program; iteration over a ``set`` (an
  order that can differ between processes shaping a program).
* ``emit-kind`` — every ``.emit("<kind>", ...)`` literal exists in the
  port's telemetry schema (:data:`attackfl_tpu_torch.telemetry.events.
  KINDS_BY_VERSION`).

Every check is also exposed as a per-file function so the tests can run it
on fixture files with seeded violations and assert exact rule id + line.
"""

from __future__ import annotations

import ast
import importlib
from pathlib import Path

from attackfl_tpu_torch.analysis.findings import Finding, relativize
from attackfl_tpu_torch.analysis.registry import AuditContext, register

REPO = Path(__file__).resolve().parent.parent.parent
PACKAGE = REPO / "attackfl_tpu_torch"

# ---------------------------------------------------------------------------
# host-sync
# ---------------------------------------------------------------------------

# Every .py under attackfl_tpu_torch/ is DISCOVERED (rglob) and must
# classify into exactly one of two prefix registries.  Keys are
# package-relative POSIX paths; a trailing "/" marks a directory prefix; the
# LONGEST matching prefix wins across both tables.
#
# TRACED_ONLY files are linted: any sync shape outside ALLOWED_FUNCTIONS is
# a finding.  HOST_SIDE files are exempt, each with the reason the exemption
# is sound.
TRACED_ONLY: dict[str, str] = {
    "__init__.py": "top-level package marker — import-time code may never "
                   "read a device value",
    "__main__.py": "python -m entry stub (delegates to the CLI)",
    "registry.py": "name -> model constructor tables read at build time",
    "training/": "the round's build functions, executors and the engine hot path — "
                 "deliberate reads are audited resolve points",
    "models/": "model init and forward run inside the round programs",
    "faults/__init__.py": "re-export stub",
    "faults/inject.py": "the plan's device-side masks run inside the round "
                        "program; the host injector touches host values only",
    "matrix/__init__.py": "re-export stub",
    "matrix/program.py": "the sweep's round body (fold_train, sweep_round) "
                         "runs inside the matrix program; the sweep's one "
                         "read is in training/matrix_exec.py",
    "ops/__init__.py": "re-export stub",
    "ops/aggregators.py": "defense aggregation runs inside the round program",
    "ops/attacks.py": "attack templates run inside the round program",
    "ops/pytree.py": "tree flatten / mask helpers used inside programs",
    "parallel/": "the client mesh's placement and collectives run inside the "
                 "round programs (a collective within a process is device to "
                 "device; the one copy to the host, the transport between "
                 "processes, is allowed below)",
    "ops/fused_step.py": "K1's and K3's wrappers and plain versions, inside "
                         "the round program",
    "ops/metrics.py": "the numerics row's compute runs inside the programs",
    "data/__init__.py": "re-export stub",
    "data/partition.py": "round_drawer draws every round's randomness on "
                         "the device, inside the round program",
    "costmodel/__init__.py": "re-export stub",
    "costmodel/capture.py": "the counting mode runs inside a counted "
                            "dispatch and reads shapes only",
    "profiler/__init__.py": "re-export stub",
    "profiler/capture.py": "the hotspot window's start/stop seams sit on "
                           "the dispatch loop",
    "telemetry/numerics.py": "NumericsDrainer.drain is the numerics ring's "
                             "single audited device->host copy",
}
HOST_SIDE: dict[str, str] = {
    "cli.py": "the command line — parses argv, files and HTTP text",
    "config.py": "config parsing coerces YAML/env host scalars before any "
                 "program exists",
    "device.py": "device resolution at the entry points, before any program",
    "weights.py": "weight file I/O on the host",
    "profile_round.py": "a standalone timing tool: its syncs bound the "
                        "timed region by design",
    "validate_kernels.py": "a standalone kernel validator: it reads results "
                           "to compare them",
    "analysis/": "the auditor runs programs and compares their inputs on "
                 "the host, outside any round program",
    "costmodel/": "estimate/report/roofline/peaks and the cost command are "
                  "JSON arithmetic over profiles and records",
    "data/synthetic.py": "dataset synthesis — host numpy producing the "
                         "arrays rounds consume",
    "eval/": "validation resolve points: Validation.test/resolve_async are "
             "the designed synchronous reads, one per round or chunk",
    "faults/plan.py": "fault-plan parsing: host strings and numbers before "
                      "any program exists",
    "ledger/": "run-ledger JSON I/O over already-resolved host values",
    "matrix/cli.py": "the matrix command line",
    "matrix/grid.py": "grid parsing and cell expansion on host values",
    "matrix/records.py": "per-cell ledger records from resolved histories",
    "ops/build.py": "nvcc builds and ctypes loads: no device value",
    "ops/defenses.py": "host-side statistical defense halves (gmm, "
                       "fltracer, the hyper detector) reached only through "
                       "the engine's allowlisted resolve points",
    "ops/stats.py": "numpy statistical kernels (PCA, GMM, DBSCAN, MAD) "
                    "backing the host defense halves",
    "profiler/": "trace mining and the hotspots command: stdlib JSON",
    "scheduler/": "job admission and pricing over resolved ledger JSON and "
                  "spool state: float() on host scalars",
    "service/": "the run service's queue, workers, daemon and client: int() "
                "and bool() of spool JSON, HTTP bodies and the host counts "
                "the engine returns; it holds no device tensor",
    "science/": "outcome analytics over the ledger's resolved host values",
    "telemetry/": "host-side observability over values the audited reads "
                  "already brought to the host (numerics.py is traced-only "
                  "above)",
    "utils/": "host utilities; checkpoint.host_state is the checkpoint's "
              "device->host gather, called from the engine's save",
}

# Call shapes that read device values on the host.
SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "synchronize"}
SYNC_NAMES = {"float", "int", "bool"}
SYNC_NP_ATTRS = {"asarray", "array"}
NP_MODULES = {"np", "numpy"}
# roots whose calls give host values (an argument built from them is no
# device read)
HOST_MODULES = NP_MODULES | {"math", "statistics", "os", "time"}
HOST_BUILTINS = {"len", "round", "range", "str", "repr", "type"}

# package-relative file -> audited functions, by their full nested
# qualified names as Python spells them (``Class.method``,
# ``builder.<locals>.closure``): an entry covers its own body only, never the
# closures defined inside it, so a program builder's entry (its build-time
# config reads) does not exempt the round program it returns.  Every entry is
# a deliberate read of the card or a host-value coercion, with its reason.
# The reads ROADMAP.md item 3a names come first.
ALLOWED_FUNCTIONS: dict[str, dict[str, str]] = {
    "ops/attacks.py": {
        "_gamma_search": "item 3a: the γ searches' while bool(torch.any(active))",
    },
    "data/partition.py": {
        "dirichlet_label_partition": "host numpy partitioning at build time",
    },
    "training/hyper.py": {
        "HyperOptimizer.step_": "item 3a: int(state['count']), Adam's host step "
                                "count, and its host bias corrections",
        "build_hyper_update.<locals>.hyper_update":
            "item 3a: float(active.sum()) and active.tolist(), the sequential "
            "update's active clients",
        "build_hyper_round.<locals>.round_step":
            "item 3a: any_active_genuine, the leak gate; a host leak flag as a "
            "device fill",
        "HyperOptimizer.__init__": "host config scalars at build time",
    },
    "training/engine.py": {
        "Simulator._build_fused_body.<locals>.body":
            "item 3a: the fused hyper body's select of Adam's host count on "
            "bool(ok)",
        "Simulator._run_plain_round": "item 3a: the synchronous round reads ok "
                                      "and the loss by design, the survivors' "
                                      "count, and ends aggregate in a sync",
        "Simulator._run_hyper_round": "item 3a: the hyper round's ok, loss and "
                                      "detector embeddings; hyper_update ends in "
                                      "a sync",
        "Simulator.run_round": "the synchronous round ends in a device sync: its "
                               "wall time is the round's",
        "Simulator._synchronize": "the synchronous round's syncs (run_round, the "
                                  "aggregate and hyper_update phases) over every "
                                  "device of the client mesh",
        "host_filter": "item 3a: gmm's and fltracer's one copy of the client "
                       "matrix (engine.py host_filter)",
        "Simulator._read_chunk": "item 3a: run_fast's one read of the card a chunk",
        "Simulator._resolve_pipeline_round": "item 3a: the pipeline's resolve — "
                                             "the round's event and its pinned copy",
        "Simulator._emit_attribution": "the defense's verdict, read for the "
                                       "attribution event (synchronous path only)",
        "Simulator._count_nan_clients": "the failure path's NaN count",
        "Simulator.run_fast": "host ints of the state after the chunk's read",
        "Simulator._run_pipelined": "host ints of the resolved state",
        "Simulator.run": "the host count of the state between rounds",
        "Simulator._fused_state": "the carry's host clock and fills from host "
                                  "values",
        "Simulator._require_fused": "a resumed hyper state's active mask, once a "
                                    "call, before any dispatch",
        "Simulator.restore_state": "a checkpoint's host tensors at resume",
        "Simulator._load_resume_state": "the resumed state's host counters",
        "Simulator._consult_stop": "the stop hook's host count",
        "Simulator._emit_program_profile": "the profile's host numbers",
        "Simulator._emit_run_header": "host config values",
        "Simulator.__init__": "host config flags at build time",
    },
    "training/matrix_exec.py": {
        "MatrixRun._resolve_chunk": "item 3a: MatrixRun's chunk read, the sweep's "
                                    "one read of the card a chunk",
        "MatrixRun.run": "host ints of the cells' resolved states",
        "MatrixRun.host_state": "the grid checkpoint's host snapshot",
        "MatrixRun.restore_state": "a resumed grid's host tensors",
        "MatrixRun.load_or_init_state": "a resumed grid's host counters",
        "MatrixRun._dispatch_chunk": "the profile's host numbers",
        "MatrixRun._run_fallback_cells": "host ints of the fallback runs' states",
        "MatrixRun._consult_stop": "the stop hook's host count",
        "MatrixRun.__init__": "host config flags at build time",
    },
    "training/local.py": {
        "build_local_update": "host config scalars at build time",
    },
    "training/round.py": {
        "build_round_halves.<locals>.finish": "a host leak flag (the synchronous "
                                              "loop's) as a device fill",
        "leak_size": "host config arithmetic",
    },
    "matrix/program.py": {
        "build_cell_program": "a host flag at build time",
    },
    "parallel/mesh.py": {
        "_packed": "the transport between processes: gloo exchanges host "
                   "bytes, so each tensor crosses through the host (never "
                   "runs over one process)",
        "gather_to_host": "a checkpoint's or the attribution's state on the "
                          "host, which is what it gathers",
        "broadcast_bytes": "process 0's checkpoint bytes and their length, "
                           "host values at a restart",
    },
    "models/icu.py": {
        "CNNModel.__init__": "host config at build time",
        "RNNModel.__init__": "host config at build time",
        "TransformerModel.__init__": "host config at build time",
    },
    "models/har.py": {
        "TransformerClassifier.__init__": "host config at build time",
    },
    "ops/aggregators.py": {
        "trimmed_mean": "the trim count from the host row count",
        "scionfl_threshold": "the rank from the host row count",
    },
    "ops/fused_step.py": {
        "drop_params": "host dropout rates at build time",
        "fill_masks": "host mask specs",
        "_run_epoch": "host config scalars and the host step clock",
        "_seed_tensor": "a host seed as a device fill",
        "build_fused_local_update": "host config scalars at build time",
        "mask_work": "host shape arithmetic",
    },
    "ops/metrics.py": {
        "Numerics.__init__": "host masks and window at build time",
        "Numerics._scalar": "a host constant as a device fill",
    },
    "costmodel/capture.py": {
        "counting": "a host flag",
        "_numel": "shape arithmetic: sizes and strides, never a value",
        "ProgramCounter.add": "host counts",
        "ProgramCounter.count": "torch's flop formulas over shapes",
    },
    "profiler/capture.py": {
        "_profiler_active": "a host flag",
        "HotspotCapture.maybe_stop": "the host round count",
    },
    "telemetry/numerics.py": {
        "NumericsDrainer.drain": "the numerics ring's single device->host copy",
        "NumericsDrainer._emit_row": "a host row the drain already copied",
        "NumericsDrainer.note_round": "host round numbers",
        "NumericsDrainer.__init__": "host config at build time",
        "numerics_summary": "events' host numbers",
    },
}

HOST_SYNC_HINT = (
    "move the read into an audited resolve function, or add the function "
    "to ALLOWED_FUNCTIONS in attackfl_tpu_torch/analysis/ast_rules.py WITH "
    "a reason saying why it must block (allowlist entries are resolved "
    "against the live module, so they cannot outlive the code)")


def _qualname(stack: list[str]) -> str:
    return ".".join(stack) if stack else "<module>"


def _root_name(node: ast.AST) -> str | None:
    """The leftmost Name of an Attribute/Call/Subscript chain."""
    while True:
        if isinstance(node, ast.Attribute):
            node = node.value
        elif isinstance(node, ast.Call):
            node = node.func
        elif isinstance(node, ast.Subscript):
            node = node.value
        else:
            break
    return node.id if isinstance(node, ast.Name) else None


def _host_evident(node: ast.AST) -> bool:
    """Whether an expression is plainly a host value: a literal, an
    f-string, a host builtin's or a host module's call, or arithmetic of
    those."""
    if isinstance(node, (ast.Constant, ast.JoinedStr)):
        return True
    if isinstance(node, ast.Call):
        if isinstance(node.func, ast.Name) and node.func.id in HOST_BUILTINS:
            return True
        return _root_name(node.func) in HOST_MODULES
    if isinstance(node, ast.BinOp):
        return _host_evident(node.left) and _host_evident(node.right)
    if isinstance(node, ast.UnaryOp):
        return _host_evident(node.operand)
    return False


def _sync_call_name(node: ast.Call) -> str | None:
    func = node.func
    if isinstance(func, ast.Name) and func.id in SYNC_NAMES:
        if node.args and not _host_evident(node.args[0]):
            return func.id
        return None
    if isinstance(func, ast.Attribute):
        if func.attr in SYNC_METHODS and _root_name(func.value) not in HOST_MODULES:
            return f".{func.attr}()"
        if (func.attr in SYNC_NP_ATTRS and isinstance(func.value, ast.Name)
                and func.value.id in NP_MODULES):
            return f"{func.value.id}.{func.attr}"
    return None


class _SyncFinder(ast.NodeVisitor):
    def __init__(self, allowed):
        self.allowed = allowed
        self.stack: list[str] = []  # the enclosing scope's __qualname__ parts
        self.in_function = False
        self.hits: list[tuple[int, str, str]] = []  # (line, call, qualname)

    def _visit_scope(self, node, name: str, function: bool) -> None:
        # a scope defined inside a function sits under its <locals>
        parts = (["<locals>"] if self.in_function else []) + [name]
        saved = self.in_function
        self.stack.extend(parts)
        self.in_function = function
        self.generic_visit(node)
        self.in_function = saved
        del self.stack[-len(parts):]

    def visit_FunctionDef(self, node) -> None:
        self._visit_scope(node, node.name, True)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node) -> None:
        self._visit_scope(node, "<lambda>", True)

    def visit_ClassDef(self, node) -> None:
        self._visit_scope(node, node.name, False)

    def visit_Call(self, node: ast.Call) -> None:
        name = _sync_call_name(node)
        if name is not None:
            # the full nested qualname: an allowlisted builder does not
            # exempt the closures it returns
            qual = _qualname(self.stack)
            if qual not in self.allowed:
                self.hits.append((node.lineno, name, qual))
        self.generic_visit(node)


def host_sync_findings(path: Path, tree: ast.Module | None = None,
                       root: Path = REPO, rel: str | None = None) -> list[Finding]:
    """Host-sync violations in one file; ``rel`` (its package-relative
    path) selects its allowlist."""
    path = Path(path)
    tree = tree if tree is not None else ast.parse(path.read_text(), filename=str(path))
    finder = _SyncFinder(ALLOWED_FUNCTIONS.get(rel or "", {}))
    finder.visit(tree)
    return [
        Finding(rule="host-sync", file=relativize(path, root), line=line,
                message=f"host sync `{name}` in {qual} — reads a device value "
                        "on the round's hot path",
                hint=HOST_SYNC_HINT)
        for line, name, qual in finder.hits
    ]


def _resolve_qualname(module, qual: str):
    """The live object (or, past a ``<locals>``, the code object) that
    ``qual`` names in ``module``, or None.  A closure has no attribute to
    look up, so its code object is found among its enclosing function's
    constants."""
    obj = module
    parts = qual.split(".")
    for i, part in enumerate(parts):
        if part == "<locals>":
            continue
        if i and parts[i - 1] == "<locals>":
            code = getattr(obj, "co_consts", None)
            if code is None:
                func = getattr(obj, "fget", obj)  # a property's getter
                code = getattr(getattr(func, "__code__", None), "co_consts", ())
            obj = next((c for c in code if hasattr(c, "co_name") and c.co_name == part),
                       None)
        else:
            obj = getattr(obj, part, None)
        if obj is None:
            return None
    return obj


def resolve_host_sync_allowlist(allowed: dict[str, dict[str, str]] | None = None,
                                root: Path = REPO) -> list[Finding]:
    """Resolve every allowlist entry against the live module (the
    allowlist drift check).  A missing symbol is an error finding pointing
    at the allowlist itself."""
    allowed = ALLOWED_FUNCTIONS if allowed is None else allowed
    findings: list[Finding] = []
    here = relativize(Path(__file__), root)
    for rel, quals in allowed.items():
        module_name = "attackfl_tpu_torch." + rel[:-3].replace("/", ".")
        try:
            module = importlib.import_module(module_name)
        except Exception as e:  # noqa: BLE001 — import failure IS drift
            findings.append(Finding(
                rule="host-sync", file=here, line=0,
                message=f"allowlist module {module_name} failed to import: "
                        f"{type(e).__name__}: {e}",
                hint="fix the module or drop its allowlist entries"))
            continue
        for qual in sorted(quals):
            if _resolve_qualname(module, qual) is None:
                findings.append(Finding(
                    rule="host-sync", file=here, line=0,
                    message=f"audited allowlist entry {qual!r} no longer exists in "
                            f"{module_name} — the allowlist has drifted from the "
                            "code it audits",
                    hint="remove the stale entry, or re-point it at the renamed "
                         "audited function (with its reason)"))
    return findings


def classify_host_sync(rel: str) -> tuple[str, str] | None:
    """``("traced-only" | "host-side", reason)`` for a package-relative
    POSIX path, or None when the coverage registry does not know the file.
    Longest matching prefix wins across both registries."""
    best: tuple[int, str, str] | None = None
    for kind, table in (("traced-only", TRACED_ONLY), ("host-side", HOST_SIDE)):
        for prefix, reason in table.items():
            if rel == prefix or (prefix.endswith("/") and rel.startswith(prefix)):
                if best is None or len(prefix) > best[0]:
                    best = (len(prefix), kind, reason)
    return (best[1], best[2]) if best is not None else None


def host_sync_coverage(package: Path = PACKAGE, root: Path = REPO
                       ) -> tuple[list[Path], list[Finding]]:
    """Discovery: every ``*.py`` under the package, classified against the
    coverage registry.  Returns ``(traced-only files to lint, findings)``
    where each unclassified file is a finding — new code fails the audit
    until someone decides which side of the sync contract it lives on."""
    traced: list[Path] = []
    findings: list[Finding] = []
    here = relativize(Path(__file__), root)
    for path in sorted(package.rglob("*.py")):
        rel = path.relative_to(package).as_posix()
        cls = classify_host_sync(rel)
        if cls is None:
            findings.append(Finding(
                rule="host-sync", file=here, line=0,
                message=f"source file {package.name}/{rel} is not classified in "
                        "the host-sync coverage registry — it would silently "
                        "escape the lint",
                hint="add the file (or its package) to TRACED_ONLY if its code "
                     "runs inside a round program, or to HOST_SIDE with the "
                     "reason the exemption is sound"))
        elif cls[0] == "traced-only":
            traced.append(path)
    return traced, findings


@register(
    "host-sync",
    "no host-device sync (.item / .tolist / .cpu / .numpy / float|int|bool "
    "of a device value / np.asarray / synchronize) on the round's hot path "
    "outside the audited allowlist; allowlist entries must resolve against "
    "the live module",
    HOST_SYNC_HINT,
)
def _host_sync_rule(ctx: AuditContext) -> list[Finding]:
    findings = resolve_host_sync_allowlist(root=ctx.root)
    traced, coverage = host_sync_coverage(ctx.package, ctx.root)
    findings.extend(coverage)
    for path in traced:
        rel = path.relative_to(ctx.package).as_posix()
        findings.extend(host_sync_findings(path, ctx.tree(path), ctx.root, rel=rel))
    return findings


# ---------------------------------------------------------------------------
# donation-after-use
# ---------------------------------------------------------------------------

DONATION_HINT = (
    "re-order so the consuming call is the LAST reader of the tensor, "
    "rebind the name from the call's result, or drop the argument from "
    "DONATION_SPEC (a program that writes an input in place must own it)")


def _dotted(node: ast.AST) -> str | None:
    """`a.b.c` -> "a.b.c" for Name/Attribute chains; None otherwise."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _int_tuple(node: ast.AST) -> tuple[int, ...] | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return (node.value,)
    if isinstance(node, (ast.Tuple, ast.List)):
        out = []
        for el in node.elts:
            if not (isinstance(el, ast.Constant) and isinstance(el.value, int)):
                return None
            out.append(el.value)
        return tuple(out)
    return None


def module_donation_spec(tree: ast.Module) -> dict[str, tuple[int, ...]]:
    """A module-level ``DONATION_SPEC = {"<program>": (argnums), ...}``
    literal, or {}."""
    for node in tree.body:
        target = value = None
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target, value = node.targets[0], node.value
        elif isinstance(node, ast.AnnAssign):
            target, value = node.target, node.value
        if not (isinstance(target, ast.Name) and target.id == "DONATION_SPEC"
                and isinstance(value, ast.Dict)):
            continue
        spec = {}
        for k, v in zip(value.keys, value.values):
            argnums = _int_tuple(v)
            if isinstance(k, ast.Constant) and isinstance(k.value, str) and argnums:
                spec[k.value] = argnums
        return spec
    return {}


# the engine's dispatch labels -> its programs' names in DONATION_SPEC
_LABEL_PROGRAMS = {"fused_scan": "fused_chunk"}


def _dispatch_program(call: ast.Call) -> str | None:
    """The program a ``*._dispatch("<label>", fn, *args)`` call runs: its
    label before any ``[``, an f-string's literal head included."""
    if not (isinstance(call.func, ast.Attribute) and call.func.attr == "_dispatch"
            and len(call.args) >= 2):
        return None
    label = call.args[0]
    if isinstance(label, ast.JoinedStr) and label.values and isinstance(
            label.values[0], ast.Constant):
        label = label.values[0]
    if not (isinstance(label, ast.Constant) and isinstance(label.value, str)):
        return None
    name = label.value.split("[", 1)[0]
    return _LABEL_PROGRAMS.get(name, name)


def _function_hits(fn_node: ast.AST, spec: dict[str, tuple[int, ...]]
                   ) -> list[tuple[int, str, str, int]]:
    """(use_line, name, program, call_line) for one function body."""
    calls = []
    for node in ast.walk(fn_node):
        if isinstance(node, ast.Call):
            program = _dispatch_program(node)
            if program is None or program not in spec:
                continue
            donated = [name for i in spec[program] if i + 2 < len(node.args)
                       for name in [_dotted(node.args[i + 2])] if name]
            if donated:
                calls.append((node, program, donated))
    hits = []
    if not calls:
        return hits
    stores: dict[str, list[int]] = {}
    for node in ast.walk(fn_node):
        name = _dotted(node)
        if name is not None and isinstance(getattr(node, "ctx", None), ast.Store):
            stores.setdefault(name, []).append(node.lineno)
    for call, program, donated in calls:
        inside = {id(n) for n in ast.walk(call)}
        end = getattr(call, "end_lineno", call.lineno)
        for name in donated:
            rebinds = [s for s in stores.get(name, []) if s >= call.lineno]
            first_rebind = min(rebinds) if rebinds else None
            for node in sorted((n for n in ast.walk(fn_node) if hasattr(n, "lineno")),
                               key=lambda n: (n.lineno, n.col_offset)):
                if id(node) in inside or _dotted(node) != name:
                    continue
                if not isinstance(getattr(node, "ctx", None), ast.Load):
                    continue
                if node.lineno <= end:
                    continue
                if first_rebind is not None and node.lineno > first_rebind:
                    continue
                hits.append((node.lineno, name, program, call.lineno))
                break  # one finding per (call, name) is enough
    return hits


def donation_after_use_findings(path: Path, tree: ast.Module | None = None,
                                root: Path = REPO) -> list[Finding]:
    tree = tree if tree is not None else ast.parse(Path(path).read_text(),
                                                  filename=str(path))
    spec = module_donation_spec(tree)
    hits: list[tuple[int, str, str, int]] = []
    if spec:
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                hits.extend(_function_hits(node, spec))
    rel = relativize(path, root)
    return [
        Finding(rule="donation-after-use", file=rel, line=use_line,
                message=f"`{name}` is read after being consumed by the program "
                        f"{program!r} at line {call_line} — DONATION_SPEC lets that "
                        "program write it in place",
                hint=DONATION_HINT)
        for use_line, name, program, call_line in sorted(set(hits))
    ]


@register(
    "donation-after-use",
    "a tensor a program consumes (DONATION_SPEC, the engine's "
    "Simulator.donation_spec: the program may write it in place) must not "
    "be read after the consuming dispatch (training/ and ops/)",
    DONATION_HINT,
)
def _donation_rule(ctx: AuditContext) -> list[Finding]:
    findings: list[Finding] = []
    for sub in ("training", "ops"):
        for path in sorted((ctx.package / sub).glob("*.py")):
            findings.extend(donation_after_use_findings(path, ctx.tree(path), ctx.root))
    return findings


# ---------------------------------------------------------------------------
# retrace-hazard
# ---------------------------------------------------------------------------

RETRACE_HINT = (
    "build the program once and cache it (the engine's _fused_body, the "
    "local update's graph per segment), key caches by host-stable values "
    "rather than fresh Python scalars of device values, and sort any set "
    "before it shapes a program")

# what builds a program the Simulator keeps for the rest of the run
PROGRAM_BUILDERS = frozenset({"_build_fused_body", "build_local_update", "StepGraph",
                              "load_library"})
# the dicts that cache built programs, and the getter that fills one
PROGRAM_CACHES = frozenset({"_fused_bodies", "graphs", "_program_profiles"})
CACHE_GETTERS = frozenset({"_fused_body"})
_SCALARS = frozenset({"float", "int", "bool"})


def _scalar_call(node: ast.AST | None) -> str | None:
    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
            and node.func.id in _SCALARS):
        return node.func.id
    return None


def _last_name(node: ast.AST) -> str | None:
    name = _dotted(node)
    return name.rsplit(".", 1)[-1] if name else None


class _RetraceScanner(ast.NodeVisitor):
    def __init__(self):
        self.loop_depth = 0
        self.hits: list[tuple[int, str]] = []

    def _visit_function(self, node) -> None:
        # a def inside a loop runs its body when called, not per iteration
        saved, self.loop_depth = self.loop_depth, 0
        self.generic_visit(node)
        self.loop_depth = saved

    visit_FunctionDef = _visit_function
    visit_AsyncFunctionDef = _visit_function
    visit_Lambda = _visit_function

    def _visit_loop(self, node) -> None:
        self._check_iter(getattr(node, "iter", None))
        self.loop_depth += 1
        self.generic_visit(node)
        self.loop_depth -= 1

    visit_For = _visit_loop
    visit_AsyncFor = _visit_loop
    visit_While = _visit_loop

    def visit_comprehension(self, node: ast.comprehension) -> None:
        self._check_iter(node.iter)
        self.generic_visit(node)

    def _check_iter(self, it: ast.AST | None) -> None:
        if it is None:
            return
        if isinstance(it, ast.Set) or (isinstance(it, ast.Call)
                                       and _dotted(it.func) == "set"):
            self.hits.append((
                it.lineno,
                "iteration over a set: an order that can differ between "
                "processes can reshape a program (a rebuild, and results that "
                "depend on the process)"))

    def visit_Subscript(self, node: ast.Subscript) -> None:
        kind = _scalar_call(node.slice)
        if kind is not None and _last_name(node.value) in PROGRAM_CACHES:
            self.hits.append((
                node.lineno,
                f"Python scalar `{kind}(...)` as the key of the program cache "
                f"{_dotted(node.value)}: every distinct value builds a new program"))
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        callee = _last_name(node.func)
        if callee in PROGRAM_BUILDERS and self.loop_depth > 0:
            self.hits.append((
                node.lineno,
                f"`{callee}` builds a program inside a loop: every iteration "
                "builds a fresh one"))
        key = node.args[0] if node.args else None
        kind = _scalar_call(key)
        if kind is not None:
            owner = (_last_name(node.func.value) if isinstance(node.func, ast.Attribute)
                     else None)
            if callee in CACHE_GETTERS or (callee in ("get", "setdefault", "pop")
                                           and owner in PROGRAM_CACHES):
                self.hits.append((
                    key.lineno,
                    f"Python scalar `{kind}(...)` as the key of a cached program "
                    f"({_dotted(node.func)}): every distinct value builds a new "
                    "program"))
        self.generic_visit(node)


def retrace_hazard_findings(path: Path, tree: ast.Module | None = None,
                            root: Path = REPO) -> list[Finding]:
    tree = tree if tree is not None else ast.parse(Path(path).read_text(),
                                                  filename=str(path))
    scanner = _RetraceScanner()
    scanner.visit(tree)
    rel = relativize(path, root)
    return [Finding(rule="retrace-hazard", file=rel, line=line, message=message,
                    hint=RETRACE_HINT)
            for line, message in sorted(scanner.hits)]


@register(
    "retrace-hazard",
    "no pattern that rebuilds a program after round 1: a program built in "
    "a loop, a Python scalar as a cached program's key, set-order-dependent "
    "structure",
    RETRACE_HINT,
)
def _retrace_rule(ctx: AuditContext) -> list[Finding]:
    findings: list[Finding] = []
    for path in ctx.package_sources():
        findings.extend(retrace_hazard_findings(path, ctx.tree(path), ctx.root))
    return findings


# ---------------------------------------------------------------------------
# emit-kind
# ---------------------------------------------------------------------------

EMIT_KIND_HINT = (
    "fix the typo, or add the new kind to REQUIRED_FIELDS and "
    "KINDS_BY_VERSION in attackfl_tpu_torch/telemetry/events.py (bump the "
    "schema version when the kind is new)")


class _EmitKindScanner(ast.NodeVisitor):
    def __init__(self, known: frozenset[str]):
        self.known = known
        self.hits: list[tuple[int, str]] = []

    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        if isinstance(func, ast.Attribute) and func.attr == "emit":
            kind_node: ast.AST | None = node.args[0] if node.args else None
            if kind_node is None:
                kind_node = next((kw.value for kw in node.keywords if kw.arg == "kind"),
                                 None)
            if (isinstance(kind_node, ast.Constant) and isinstance(kind_node.value, str)
                    and kind_node.value not in self.known):
                self.hits.append((kind_node.lineno, kind_node.value))
        self.generic_visit(node)


def emit_kind_findings(path: Path, tree: ast.Module | None = None, root: Path = REPO,
                       known: frozenset[str] | None = None) -> list[Finding]:
    if known is None:
        from attackfl_tpu_torch.telemetry.events import known_kinds

        known = known_kinds()
    tree = tree if tree is not None else ast.parse(Path(path).read_text(),
                                                  filename=str(path))
    scanner = _EmitKindScanner(known)
    scanner.visit(tree)
    rel = relativize(path, root)
    return [
        Finding(rule="emit-kind", file=rel, line=line,
                message=f"emit kind {kind!r} is not in the telemetry schema "
                        f"(known kinds: {', '.join(sorted(known))})",
                hint=EMIT_KIND_HINT)
        for line, kind in sorted(scanner.hits)
    ]


@register(
    "emit-kind",
    "every .emit(\"<kind>\") literal exists in the telemetry event schema "
    "(attackfl_tpu_torch/telemetry/events.py KINDS_BY_VERSION)",
    EMIT_KIND_HINT,
)
def _emit_kind_rule(ctx: AuditContext) -> list[Finding]:
    from attackfl_tpu_torch.telemetry.events import known_kinds

    known = known_kinds()
    findings: list[Finding] = []
    for path in ctx.package_sources():
        findings.extend(emit_kind_findings(path, ctx.tree(path), ctx.root, known))
    return findings
