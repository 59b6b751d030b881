"""Program audit: the invariants of the round programs themselves (the
port's counterpart of ``attackfl_tpu/analysis/program_audit.py``).

The JAX package traces each jitted round program to a jaxpr and lowers it;
the port has no program to trace, so it runs each one once, on the audit's
device, under a ``TorchDispatchMode`` that sees every aten op below
autograd and ``vmap`` (the cost model's counting mode,
``costmodel/capture.py``, is the model) and passes each through unchanged.
For every program the engine exposes (:meth:`Simulator.audit_programs`:
``round_step`` and ``aggregate`` (or ``hyper_update``), ``fused_chunk[2]``
and ``pipeline_step[eval=...]``, and the sweep's ``matrix_chunk`` through
:func:`audit_matrix_program`) it records:

* **sync-freedom** — no ``aten._local_scalar_dense`` (``.item()``,
  ``bool()``, ``float()`` of a tensor) and no device-to-host copy inside
  the program.  On the card the program also runs under
  ``torch.cuda.set_sync_debug_mode("warn")``, whose warnings give the site
  of each synchronizing CUDA call (the ``"error"`` mode would stop at the
  first).  The sites are the port's source lines.  The mode must see
  every op, so that run replays no captured graph
  (``costmodel/capture.op_by_op``: the matrix fold's ``StepGraph`` steps
  dispatch eagerly); on the card the program then runs once more as the
  card runs it, its graphs captured and replayed, under the sync warnings
  and the inputs' bitwise comparison below, which need no mode.
* **dtype discipline** — no float64 or complex output of any op.
* **in-place writes to inputs** — the torch counterpart of JAX's donation
  check: a program may write in place only the arguments its
  :meth:`Simulator.donation_spec` entry names.  Writes are seen two ways:
  an aten op whose schema writes an argument that shares an input's
  storage (with the op's name), and a bitwise comparison of every input
  tensor before and after the run, which also sees a hand-written
  kernel's writes (the dispatch mode does not see a ctypes launch).
* **the transfer budget** — the resolved host-sync allowlist, as JAX
  reports it: every read of the card happens in host code, which the
  ``host-sync`` rule bounds to that allowlist.
* **the collectives** — the names the mesh's collectives
  (``parallel/shard.py``) record during the audited run, held to the
  program's exact expected set: none for a meshless program, and for the
  sharded programs (:func:`audit_sharded_programs`, over a client mesh of
  :data:`AUDIT_SHARDS` shards) the defense's row of
  :data:`EXPECTED_COLLECTIVES`, none for ``round_step`` (the local update
  per shard is collective-free) and none for the cell-sharded sweep
  (:func:`audit_sharded_matrix_program`).

Each program's K1 and K3 launches in the audited run (``ops/fused_step``'s
counts) and its wall milliseconds (the host clock around the run, a device
sync at each end on the card; ``live_ms`` for the second run on the card)
are recorded beside them, and on the card the allocator's peak over both
runs (``peak_gib``; its peak statistic is reset before the audited run).
Program arguments are the engine's own; the run advances no generator the
engine keeps.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
import time
import traceback
import warnings
from dataclasses import dataclass, field
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from attackfl_tpu_torch import device as devices
from attackfl_tpu_torch.analysis.findings import Finding
from attackfl_tpu_torch.analysis.registry import register_info
from attackfl_tpu_torch.costmodel.capture import op_by_op
from attackfl_tpu_torch.parallel.shard import record_collectives

_aten = torch.ops.aten
WIDE_DTYPES = frozenset({torch.float64, torch.complex64, torch.complex128})
PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FORBIDDEN_HINT = (
    "host reads must live in the engine's audited resolve points (see the "
    "host-sync rule), never inside a round program")
INPLACE_HINT = (
    "the program wrote an input it does not consume (Simulator.donation_spec): "
    "write a fresh tensor, or declare the argument in DONATION_SPEC and make "
    "sure no caller reads it afterwards")
F64_HINT = (
    "keep round math in float32/bf16: find the promotion (a float64 numpy "
    "scalar, a .double(), torch.float64) and cast it explicitly")

# defense mode -> the exact collective sets its sharded aggregation may
# record, per transform (parallel/shard.shard_aggregator's design table,
# JAX program_audit.py:64-98): the "forward" column is the round program
# as dispatched — partial-sum defenses reduce with psum only; order-
# statistic/pairwise/quantile/anchor defenses reassemble the full client
# matrix with all_gather and nothing else.  The "grad" column is the
# differentiated program: each collective and its transposition dual
# (parallel/shard.grad_collectives).  Training itself
# (shard_local_update) is collective-free, so these sets describe the
# WHOLE round program under either transform.
_PSUM_FWD = frozenset({"psum"})
_GATHER_FWD = frozenset({"all_gather"})
_PSUM_GRAD = frozenset({"psum"})
_GATHER_GRAD = frozenset({"all_gather", "psum", "reduce_scatter"})
EXPECTED_COLLECTIVES: dict[str, dict[str, frozenset[str]]] = {
    "fedavg": {"forward": _PSUM_FWD, "grad": _PSUM_GRAD},
    "fltracer": {"forward": _PSUM_FWD, "grad": _PSUM_GRAD},
    "gmm": {"forward": _PSUM_FWD, "grad": _PSUM_GRAD},
    "shieldfl": {"forward": _PSUM_FWD, "grad": _PSUM_GRAD},
    "FLTrust": {"forward": _PSUM_FWD, "grad": _PSUM_GRAD},
    "median": {"forward": _GATHER_FWD, "grad": _GATHER_GRAD},
    "trimmed_mean": {"forward": _GATHER_FWD, "grad": _GATHER_GRAD},
    "krum": {"forward": _GATHER_FWD, "grad": _GATHER_GRAD},
    "scionfl": {"forward": _GATHER_FWD, "grad": _GATHER_GRAD},
    "byzantine": {"forward": _GATHER_FWD, "grad": _GATHER_GRAD},
}

# shards of the audits' client mesh: the run's devices of its type, each
# repeated in turn up to this count (one card gives two shards of it)
AUDIT_SHARDS = 2


register_info(
    "program-audit",
    "every round program (sync, fused, pipelined, matrix; meshless and over "
    "a client mesh) runs once under a dispatch mode with no host sync, no "
    "float64 or complex output, no in-place write to an input outside "
    "Simulator.donation_spec(), and exactly the collectives its defense's "
    "row of EXPECTED_COLLECTIVES allows (none for round_step, a meshless "
    "program or the cell-sharded sweep)",
    FORBIDDEN_HINT,
)


def _tensor_leaves(obj: Any, path: str = "") -> list[tuple[str, torch.Tensor]]:
    """``(path, tensor)`` for every tensor in nested dicts, lists, tuples
    and dataclasses (the round draws)."""
    if isinstance(obj, torch.Tensor):
        return [(path, obj)]
    if isinstance(obj, dict):
        items = [(f"{path}[{k!r}]", v) for k, v in obj.items()]
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        items = [(f"{path}.{f.name}", getattr(obj, f.name)) for f in dataclasses.fields(obj)]
    elif isinstance(obj, (list, tuple)):
        items = [(f"{path}[{i}]", v) for i, v in enumerate(obj)]
    else:
        return []
    return [leaf for p, v in items for leaf in _tensor_leaves(v, p)]


def _site() -> str:
    """The innermost frame of the port's own code outside this module and
    torch: where the op was issued."""
    for frame in reversed(traceback.extract_stack()):
        name = frame.filename
        if name.startswith(PACKAGE_DIR) and os.sep + "analysis" + os.sep not in name:
            return f"{os.path.relpath(name, os.path.dirname(PACKAGE_DIR))}:{frame.lineno}"
    return "<unknown>"


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point() or a.is_complex():
        nan_a, nan_b = torch.isnan(a), torch.isnan(b)
        return bool(torch.equal(nan_a, nan_b)) and bool(torch.equal(
            torch.where(nan_a, torch.zeros_like(a), a), torch.where(nan_b, torch.zeros_like(b), b)))
    return bool(torch.equal(a, b))


class _AuditMode(TorchDispatchMode):
    """Passes every op through; records syncs, wide outputs and writes into
    the inputs' storages."""

    def __init__(self, inputs: dict[int, str]):
        super().__init__()
        self.inputs = inputs            # storage data_ptr -> first input path
        self.ops = 0
        self.distinct: set[str] = set()
        self.syncs: list[str] = []      # "op @ site"
        self.f64: list[str] = []
        self.writes: dict[str, str] = {}  # input path -> "op @ site"

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "prim":
            return out
        self.ops += 1
        name = str(func.overloadpacket.__name__)
        self.distinct.add(name)
        if func.overloadpacket is _aten._local_scalar_dense:
            self.syncs.append(f"aten.{name} @ {_site()}")
        flat_in = [t for _, t in _tensor_leaves((args, kwargs))]
        flat_out = [t for _, t in _tensor_leaves(out)]
        if (any(t.device.type == "cuda" for t in flat_in)
                and any(t.device.type == "cpu" for t in flat_out)):
            self.syncs.append(f"aten.{name} (device-to-host copy) @ {_site()}")
        for t in flat_out:
            if t.dtype in WIDE_DTYPES:
                self.f64.append(f"aten.{name} -> {t.dtype} @ {_site()}")
                break
        if func._schema.is_mutable:
            for i, arg in enumerate(func._schema.arguments):
                info = arg.alias_info
                if info is None or not info.is_write:
                    continue
                value = kwargs.get(arg.name) if arg.kwarg_only or i >= len(args) else args[i]
                for _, t in _tensor_leaves(value):
                    path = self.inputs.get(t.untyped_storage().data_ptr())
                    if path is not None and path not in self.writes:
                        self.writes[path] = f"aten.{name} @ {_site()}"
        return out


def _launches() -> dict[str, int]:
    from attackfl_tpu_torch.ops import fused_step

    return {"fused_step": fused_step.run_epoch.launches,
            "dropout_mask": fused_step.fill_masks.launches}


def _arg_index(path: str) -> int:
    """The argument position of an input path ``[i]...``."""
    return int(path[1:path.index("]")])


@dataclass
class ProgramReport:
    """Audit result for one round program (JSON-ready via ``to_dict``, with
    the JAX report's keys: ``eqns`` are the aten ops run,
    ``forbidden_primitives`` the syncing ops, ``aliased_leaves`` the input
    tensors written in place, ``expected_aliases`` the tensors of the
    consumed arguments that may be).  A gradient program sets ``aliased``,
    its gradient's leaves that match the perturbation's 1:1, the port's
    counterpart of JAX's donation aliasing (``analysis/grad_audit.py``),
    which ``aliased_leaves`` then reports; ``skipped`` names why a program
    was not audited."""

    name: str
    executor: str
    device: str
    ops: int
    distinct_ops: int
    syncs: list[str]
    f64: list[str]
    donated_args: tuple[int, ...]
    donated_leaves: int
    writes: dict[str, str]
    launches: dict[str, int]
    wall_ms: float
    live_ms: float | None = None
    peak_gib: float | None = None
    aliased: int | None = None
    skipped: str | None = None
    collectives: list[str] = field(default_factory=list)
    expected_collectives: list[str] = field(default_factory=list)
    problems: list[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.problems

    def to_dict(self) -> dict[str, Any]:
        return {
            "name": self.name, "executor": self.executor, "ok": self.ok,
            "eqns": self.ops, "distinct_primitives": self.distinct_ops,
            "forbidden_primitives": sorted({s.split(" @ ")[0] for s in self.syncs}),
            "donated_args": list(self.donated_args),
            "donated_leaves": self.donated_leaves,
            "expected_aliases": self.donated_leaves,
            "aliased_leaves": len(self.writes) if self.aliased is None else self.aliased,
            "f64_outputs": len(self.f64),
            "collectives": list(self.collectives),
            "expected_collectives": list(self.expected_collectives),
            "problems": self.problems,
            "device": self.device, "syncs": len(self.syncs), "sync_sites": self.syncs,
            "f64_sites": self.f64, "inplace_inputs": self.writes,
            "launches": self.launches, "wall_ms": round(self.wall_ms, 3),
            "live_ms": None if self.live_ms is None else round(self.live_ms, 3),
            "peak_gib": None if self.peak_gib is None else round(self.peak_gib, 4),
            "skipped": self.skipped,
        }


def _run_watched(fn: Callable, args: tuple, device: torch.device,
                 mode: TorchDispatchMode | None = None) -> tuple[float, list[str], Any]:
    """Run ``fn(*args)`` once, under ``mode`` when given: its wall ms, on
    the card the site of each sync ``set_sync_debug_mode("warn")`` reports
    (the caller's mode is restored), and its result."""
    on_card = device.type == "cuda"
    if on_card:
        devices.synchronize(device)
        previous = torch.cuda.get_sync_debug_mode()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if on_card:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            with mode if mode is not None else contextlib.nullcontext():
                out = fn(*args)
        finally:
            if on_card:
                torch.cuda.set_sync_debug_mode(previous)
    if on_card:
        devices.synchronize(device)
    wall_ms = (time.perf_counter() - t0) * 1e3
    root = os.path.dirname(PACKAGE_DIR)
    return wall_ms, [f"cuda sync @ {os.path.relpath(w.filename, root)}:{w.lineno}"
                     for w in caught if "synchronizing CUDA operation" in str(w.message)], out


def audit_program(name: str, executor: str, fn: Callable, args: tuple,
                  donate: tuple[int, ...] = (), device: torch.device | str | None = None,
                  check_output: Callable[[Any], list[str]] | None = None,
                  expected_collectives: frozenset[str] = frozenset()) -> ProgramReport:
    """Run ``fn(*args)`` once under the audit mode (see the module doc).
    The mode needs every op dispatched, so the run replays no captured
    graph (``costmodel/capture.op_by_op``); on the card the program then
    runs once more as the card runs it, its graphs replayed, under the
    sync warnings and the inputs' bitwise comparison, which need no mode.
    ``check_output(out)`` gives the audited run's result's problems;
    ``expected_collectives`` is the exact set of collectives the audited
    run must record."""
    leaves = _tensor_leaves(args)
    device = torch.device(device) if device is not None else (
        leaves[0][1].device if leaves else torch.device("cpu"))
    storages: dict[int, str] = {}
    for path, t in leaves:
        storages.setdefault(t.untyped_storage().data_ptr(), path)
    before = [(path, t, t.detach().clone()) for path, t in leaves]
    mode = _AuditMode(storages)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    launches0 = _launches()
    with op_by_op(), record_collectives() as recorded:
        wall_ms, card_syncs, out = _run_watched(fn, args, device, mode)
    launches = {k: v - launches0[k] for k, v in _launches().items()}
    writes = dict(mode.writes)

    def compare_inputs(how: str) -> None:
        for path, t, snap in before:
            if path not in writes and not _same_bits(t.detach(), snap):
                writes[path] = how

    compare_inputs("a write the dispatch mode did not see (a kernel launch)")
    live_ms = peak_gib = None
    if device.type == "cuda":
        live_ms, live_syncs, _ = _run_watched(fn, args, device)
        card_syncs += [f"{s} (graphs replayed)" for s in live_syncs]
        compare_inputs("a write with the captured graphs replayed")
        peak_gib = torch.cuda.max_memory_allocated(device) / 2 ** 30
    donated = [p for p, _ in leaves if _arg_index(p) in donate]
    report = ProgramReport(
        name=name, executor=executor, device=device.type, ops=mode.ops,
        distinct_ops=len(mode.distinct), syncs=mode.syncs + card_syncs, f64=mode.f64,
        donated_args=tuple(donate), donated_leaves=len(donated), writes=writes,
        launches=launches, wall_ms=wall_ms, live_ms=live_ms, peak_gib=peak_gib,
        collectives=sorted(recorded), expected_collectives=sorted(expected_collectives))
    if report.syncs:
        report.problems.append(
            f"{len(report.syncs)} host sync(s) inside the program: "
            + "; ".join(report.syncs[:5]))
    if report.f64:
        report.problems.append(
            f"{len(report.f64)} float64/complex output(s) in the program: "
            + "; ".join(report.f64[:5]))
    undeclared = {p: how for p, how in writes.items() if _arg_index(p) not in donate}
    if undeclared:
        report.problems.append(
            f"in-place write to {len(undeclared)} input(s) the program does not consume "
            "(donation_spec): " + "; ".join(f"args{p} by {how}"
                                             for p, how in list(undeclared.items())[:5]))
    if set(report.collectives) != set(expected_collectives):
        report.problems.append(
            f"collective set mismatch: program contains "
            f"[{', '.join(report.collectives) or 'none'}], expected "
            f"[{', '.join(sorted(expected_collectives)) or 'none'}] "
            "(see EXPECTED_COLLECTIVES / parallel/shard's design table)")
    if check_output is not None:
        report.problems.extend(check_output(out))
    return report


def audit_simulator(sim, expected: frozenset[str] = frozenset()) -> list[ProgramReport]:
    """Audit every program the Simulator's audit hook exposes; every
    program but ``round_step`` (collective-free) must record exactly
    ``expected``."""
    return [audit_program(p["name"], p["executor"], p["fn"], p["args"], p["donate"],
                          device=sim.device,
                          expected_collectives=(frozenset() if p["name"] == "round_step"
                                                else expected))
            for p in sim.audit_programs()]


def audit_mesh(device: str | torch.device, shards: int = AUDIT_SHARDS):
    """The audits' client mesh: the visible devices of ``device``'s type
    (the CPU: one), each repeated in turn up to ``shards`` shards, or all
    of them where there are more."""
    from attackfl_tpu_torch.parallel.mesh import make_client_mesh

    visible = make_client_mesh(0, device=device).devices
    count = max(shards, len(visible))
    return make_client_mesh(devices=[visible[i % len(visible)] for i in range(count)])


def audit_sharded_programs(device: str = "cuda", modes: tuple[str, ...] = (
        "fedavg", "median", "FLTrust"), shards: int = AUDIT_SHARDS) -> list[ProgramReport]:
    """The programs of a Simulator over a client mesh (JAX
    ``audit_sharded_programs``, program_audit.py:345-386): for each mode,
    :func:`config.audit_config` at two clients a shard with threefry keys
    (the shard_map strategy) over :func:`audit_mesh`, and its
    ``round_step``, ``aggregate``, ``fused_chunk[2]`` and
    ``pipeline_step`` held to the meshless programs' invariants and to the
    defense's collective set.  Named ``sharded-<mode>[<n> shards]:...``."""
    from attackfl_tpu_torch.config import audit_config
    from attackfl_tpu_torch.training.engine import Simulator

    mesh = audit_mesh(device, shards)
    reports: list[ProgramReport] = []
    for mode in modes:
        with tempfile.TemporaryDirectory(prefix="attackfl_audit_") as scratch:
            cfg = audit_config(scratch, mode=mode, prng_impl="threefry2x32",
                               total_clients=2 * mesh.size)
            sim = Simulator(cfg, device=mesh.lead, mesh=mesh)
            try:
                if sim.mesh_strategy != "shard_map":
                    raise AssertionError(f"{mode}: mesh strategy {sim.mesh_strategy}")
                for report in audit_simulator(sim, EXPECTED_COLLECTIVES[mode]["forward"]):
                    report.name = f"sharded-{mode}[{mesh.size} shards]:{report.name}"
                    reports.append(report)
            finally:
                sim.close()
    return reports


def audit_sharded_matrix_program(device: str = "cuda",
                                 shards: int = AUDIT_SHARDS) -> list[ProgramReport]:
    """The cell-sharded sweep program (JAX
    ``audit_sharded_matrix_program``, program_audit.py:389-416): LIE x
    fedavg, krum and FLTrust at seed 1 over :func:`audit_mesh`, each
    shard folding its own cells.  The cells are independent, so the
    program must record no collective at all."""
    from attackfl_tpu_torch.config import audit_config
    from attackfl_tpu_torch.matrix.grid import grid_from_dict
    from attackfl_tpu_torch.training.matrix_exec import MatrixRun

    mesh = audit_mesh(device, shards)
    grid = grid_from_dict({"attacks": ["LIE"], "attack-clients": 1, "attack-round": 2,
                           "defenses": ["fedavg", "krum", "FLTrust"], "seeds": [1],
                           "rounds": 2})
    with tempfile.TemporaryDirectory(prefix="attackfl_audit_") as scratch:
        runner = MatrixRun(audit_config(scratch, prng_impl="threefry2x32"), grid,
                           device=mesh.lead, mesh=mesh)
        try:
            reports = [audit_program(p["name"], p["executor"], p["fn"], p["args"],
                                     p["donate"], device=runner.device)
                       for p in runner.audit_programs()]
        finally:
            runner.close()
    for report in reports:
        report.name = f"sharded[{mesh.size} shards]:{report.name}"
    return reports


def audit_default_programs(device: str = "cuda") -> list[ProgramReport]:
    """Build the representative Simulator (:func:`config.audit_config`,
    fedavg) and audit its programs, named ``fedavg:<program>``."""
    from attackfl_tpu_torch.config import audit_config
    from attackfl_tpu_torch.training.engine import Simulator

    with tempfile.TemporaryDirectory(prefix="attackfl_audit_") as scratch:
        cfg = audit_config(scratch)
        sim = Simulator(cfg, device=device)
        try:
            reports = audit_simulator(sim)
        finally:
            sim.close()
    for report in reports:
        report.name = f"{cfg.mode}:{report.name}"
    return reports


def audit_matrix_program(device: str = "cuda", cfg=None, grid=None) -> list[ProgramReport]:
    """Audit the scenario matrix's sweep program (JAX
    ``audit_matrix_program``, program_audit.py:421-447): one sweep round
    (``matrix/program.py`` ``sweep_round`` with ``fold_train``) of every
    device cell, dispatched as ``matrix_chunk[1]``, on a grid of 2 x 2 x
    1 cells by default (LIE and ``none`` x fedavg and median, seed 1,
    2 rounds) over :func:`config.audit_config` with threefry keys, as
    a sweep needs."""
    from attackfl_tpu_torch.config import audit_config
    from attackfl_tpu_torch.matrix.grid import grid_from_dict
    from attackfl_tpu_torch.training.matrix_exec import MatrixRun

    grid = grid if grid is not None else grid_from_dict({
        "attacks": ["LIE", "none"], "attack-clients": 1, "attack-round": 1,
        "defenses": ["fedavg", "median"], "seeds": [1], "rounds": 2})
    with tempfile.TemporaryDirectory(prefix="attackfl_audit_") as scratch:
        runner = MatrixRun(cfg if cfg is not None else
                           audit_config(scratch, prng_impl="threefry2x32"), grid, device=device)
        try:
            return [audit_program(p["name"], p["executor"], p["fn"], p["args"], p["donate"],
                                  device=runner.device)
                    for p in runner.audit_programs()]
        finally:
            runner.close()


def reports_to_findings(reports: list[ProgramReport],
                        rule: str = "program-audit") -> list[Finding]:
    """Program-level problems as findings under ``rule`` (the 'file' is the
    program name: there is no single source line; the sites are in the
    message)."""
    findings = []
    for report in reports:
        for problem in report.problems:
            hint = FORBIDDEN_HINT
            if "in-place" in problem:
                hint = INPLACE_HINT
            elif "float64" in problem:
                hint = F64_HINT
            findings.append(Finding(rule=rule, file=f"<program:{report.name}>", line=0,
                                    message=problem, hint=hint))
    return findings


def transfer_budget() -> dict[str, Any]:
    """The audited device->host transfer budget: the programs make no
    read of the card (checked above), so every read originates in an
    allowlisted host function.  Returns the resolved allowlist, per file."""
    from attackfl_tpu_torch.analysis.ast_rules import (
        ALLOWED_FUNCTIONS, resolve_host_sync_allowlist)

    drift = resolve_host_sync_allowlist()
    return {
        "audited_functions": {name: sorted(quals)
                              for name, quals in sorted(ALLOWED_FUNCTIONS.items())},
        "total": sum(len(q) for q in ALLOWED_FUNCTIONS.values()),
        "resolved": not drift,
    }
