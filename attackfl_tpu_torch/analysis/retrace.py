"""The recompile guard: the dynamic half of the auditor (the port's
counterpart of ``attackfl_tpu/analysis/retrace.py``).

A JAX round program must compile on round 1 and never again.  The port
compiles no per-program code, but it builds things once that a silent
rebuild would pay for every round: the fused bodies (the fused and
pipelined executors' program, one per ``include_eval``), a sweep's cell
programs and the ``StepGraph``s its folded local update captures, the
CUDA kernel libraries loaded through ``ops/build.load_library`` (an
``nvcc`` build the first time), the validation evaluators, the synchronous
programs and the cost model's counted program profiles.
:func:`built_programs` snapshots all of them after round 1 (objects by
identity, counts by value), and the guard fails if anything is built,
rebuilt, captured or loaded over the rest of the run (``run``,
``run_fast``, the pipeline, or a ``MatrixRun``).  The static
``retrace-hazard`` rule catches the *patterns*; this catches the *fact*.
"""

from __future__ import annotations

import tempfile
from typing import Any, Callable

from attackfl_tpu_torch.analysis.findings import Finding
from attackfl_tpu_torch.analysis.registry import register_info

RETRACE_GUARD_HINT = (
    "find what is built again after round 1 (a cache keyed by a value that "
    "changes, a body or graph rebuilt per call, a cleared cache) and build it "
    "once — the static retrace-hazard rule lists the usual sources")

register_info(
    "retrace-guard",
    "nothing a run builds once (fused bodies, a sweep's cell programs and "
    "captured step graphs, kernel libraries, validation evaluators, "
    "synchronous programs, the cost model's counted programs) is built, "
    "rebuilt or loaded after round 1 of a run, run_fast, pipelined run or "
    "sweep",
    RETRACE_GUARD_HINT,
)


def built_programs(sim) -> dict[str, Any]:
    """Everything ``sim`` (a Simulator or a MatrixRun) has built, by a
    stable name: objects (compared by identity) and counts (compared by
    value)."""
    from attackfl_tpu_torch.ops import build

    out: dict[str, Any] = {}
    for name in ("round_step", "aggregate", "hyper_update"):
        fn = getattr(sim, name, None)
        if fn is not None:
            out[name] = fn
    for key, body in getattr(sim, "_fused_bodies", {}).items():
        out[f"fused_body[eval={key}]"] = body
    # a sweep's cell programs and its folded local update's captured
    # gradient steps (the Simulator captures none)
    for key, program in getattr(sim, "programs", {}).items():
        out[f"cell_program[{key}]"] = program
    for segment, graph in getattr(getattr(sim, "update", None), "graphs", {}).items():
        out[f"step_graph[segment={segment}]"] = graph
    out["kernel_libraries"] = build.load_library.cache_info().misses
    if sim.validation is not None:
        out["validation"] = sim.validation
        out["validation.evaluate"] = sim.validation.evaluate
    for label, profile in sim._program_profiles.items():
        out[f"costmodel:{label}"] = profile
    return out


class RetraceGuard:
    """Snapshot-then-check over one Simulator's built programs."""

    def __init__(self, sim):
        self.sim = sim
        self.baseline: dict[str, Any] | None = None

    def snapshot(self) -> dict[str, Any]:
        """Record what is built now (call after round 1)."""
        self.baseline = built_programs(self.sim)
        return dict(self.baseline)

    def violations(self) -> list[str]:
        """What was built, rebuilt, captured or loaded since :meth:`snapshot`."""
        if self.baseline is None:
            raise RuntimeError("snapshot() the guard before checking it")
        problems = []
        for name, value in built_programs(self.sim).items():
            if name not in self.baseline:
                problems.append(f"{name}: built after round 1")
                continue
            before = self.baseline[name]
            if isinstance(value, int):
                if value != before:
                    problems.append(f"{name}: {before} -> {value} after round 1")
            elif value is not before:
                problems.append(f"{name}: rebuilt after round 1")
        return problems


def _runner(executor: str, chunk_size: int | None) -> Callable:
    """``runner(sim, state, target_rounds) -> state`` for one executor:
    ``run``, ``run_fast`` (chunks of ``chunk_size``) or ``pipeline``
    (``run(pipeline=True)`` at the config's depth)."""
    def runner(sim, state, target):
        kw = dict(num_rounds=target, state=state, save_checkpoints=False, verbose=False)
        if executor == "run_fast":
            return sim.run_fast(chunk_size=chunk_size, **kw)[0]
        return sim.run(pipeline=executor == "pipeline", **kw)[0]
    return runner


def run_with_guard(sim, executor: str = "run", first_rounds: int = 1, num_rounds: int = 3,
                   chunk_size: int | None = None, runner: Callable | None = None
                   ) -> list[str]:
    """Run ``first_rounds`` rounds, snapshot, run to ``num_rounds``, return
    what was built after the snapshot.  ``runner(sim, state, target)``
    overrides the executor's."""
    runner = runner or _runner(executor, chunk_size)
    state = runner(sim, None, first_rounds)
    guard = RetraceGuard(sim)
    guard.snapshot()
    runner(sim, state, num_rounds)
    return guard.violations()


def run_matrix_with_guard(sweep, first_rounds: int = 1) -> list[str]:
    """Run a sweep (its grid's chunk at most ``first_rounds``), snapshot at
    its stop hook once ``first_rounds`` rounds are done, return what was
    built after the snapshot."""
    guard = RetraceGuard(sweep)

    def stop(completed):
        if guard.baseline is None and completed >= first_rounds:
            guard.snapshot()

    sweep.run(stop=stop, save_checkpoints=False, verbose=False)
    return guard.violations()


GUARD_GRID = {"attacks": ["LIE", "none"], "attack-clients": 1, "attack-round": 1,
              "defenses": ["fedavg", "median"], "seeds": [1], "rounds": 3, "chunk": 1}


def guard_findings(device: str = "cuda",
                   executors: tuple[tuple[str, dict[str, Any]], ...] = (
                       ("run", {}), ("run_fast", {"chunk_size": 1}),
                       ("pipeline", {"pipeline_depth": 2}), ("matrix", {}))) -> list[Finding]:
    """The ``audit --retrace`` pass: the guard over 3 rounds of
    :func:`config.audit_config` on each executor (``run``, ``run_fast`` in
    chunks of 1, the pipeline at depth 2, and a sweep of GUARD_GRID's
    2 x 2 x 1 cells in chunks of 1).  It RUNS rounds: seconds on the
    CPU."""
    from attackfl_tpu_torch.config import audit_config
    from attackfl_tpu_torch.matrix.grid import grid_from_dict
    from attackfl_tpu_torch.training.engine import Simulator
    from attackfl_tpu_torch.training.matrix_exec import MatrixRun

    findings = []
    for executor, overrides in executors:
        chunk_size = overrides.get("chunk_size")
        with tempfile.TemporaryDirectory(prefix="attackfl_audit_") as scratch:
            if executor == "matrix":
                cfg = audit_config(scratch, prng_impl="threefry2x32", **overrides)
                runner = MatrixRun(cfg, grid_from_dict(GUARD_GRID), device=device)
            else:
                cfg = audit_config(scratch, **{k: v for k, v in overrides.items()
                                               if k != "chunk_size"})
                runner = Simulator(cfg, device=device)
            try:
                problems = (run_matrix_with_guard(runner) if executor == "matrix"
                            else run_with_guard(runner, executor, chunk_size=chunk_size))
            finally:
                runner.close()
        findings.extend(Finding(rule="retrace-guard", file=f"<run:{cfg.mode}:{executor}>",
                                line=0, message=problem, hint=RETRACE_GUARD_HINT)
                        for problem in problems)
    return findings
