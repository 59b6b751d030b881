"""The port's audit (``attackfl_tpu_torch/analysis``, the ``audit``
command) on the CPU, against the JAX package where both have the pass.

1. ``Simulator.audit_programs()`` names the JAX package's programs with its
   executors on ``audit_config()``, for fedavg and for hyper, and
   ``donation_spec()`` has JAX's program names, every entry empty.
2. ``emit-kind`` on ``tests/data/analysis_fixtures/emit_kind.py`` finds
   what JAX's ``emit_kind_findings`` finds, and the committed event files'
   artifact findings are JAX's.
3. Each rule fires at its exact line on a fixture written into
   ``tmp_path``: an unclassified file, a stale allowlist entry and a
   ``.item()`` on a TRACED_ONLY path (host-sync); a read after a declared
   consuming dispatch (donation-after-use); a program built in a loop, a scalar
   cache key and a set's order (retrace-hazard); a typo'd kind
   (emit-kind).  The tree itself is clean under every rule.
4. The program audit flags a program that emits float64, syncs, or writes
   an input in place (through an aten op or behind the dispatch mode's
   back), and passes one that writes an input it consumes.
5. The recompile guard passes ``run``, ``run_fast``, the pipeline, a
   sweep and the sharded runs at mesh sizes 1 and 2, and flags a body
   rebuilt, or a step graph captured, after round 1.
6. ``audit --json --device cpu --skip-grad`` exits 0 on the tree with the
   keys of ``tests/data/audit_report.json``, the programs of a 2-shard
   client mesh among them with their defenses' collective sets
   (``EXPECTED_COLLECTIVES``); ``audit --grad`` runs the
   transform-safety auditor (tests/test_torch_port_grad_audit.py holds its
   report) and ``--grad --skip-grad`` is refused, as JAX's.
"""

import json
from pathlib import Path

import pytest
import torch
from _torch_port_threads import one_torch_thread  # noqa: F401

from attackfl_tpu.analysis.artifacts import event_schema_findings as jax_event_schema_findings
from attackfl_tpu.analysis.ast_rules import emit_kind_findings as jax_emit_kind_findings
from attackfl_tpu.config import audit_config as jax_audit_config
from attackfl_tpu.training.engine import Simulator as JaxSimulator
from attackfl_tpu_torch import cli as port_cli
from attackfl_tpu_torch.analysis import ast_rules, program_audit, retrace
from attackfl_tpu_torch.analysis.artifacts import event_schema_findings, find_event_files
from attackfl_tpu_torch.analysis.registry import AuditContext, run_rules
from attackfl_tpu_torch.config import audit_config
from attackfl_tpu_torch.training.engine import Simulator

REPO = Path(__file__).resolve().parent.parent
DATA = REPO / "tests" / "data"


def _key(f):
    return (f.rule, f.file, f.line, f.message)


@pytest.mark.parametrize("mode", ["fedavg", "hyper"])
def test_audit_programs_as_jaxs(mode, tmp_path):
    jsim = JaxSimulator(jax_audit_config(mode=mode))
    try:
        theirs = [(p["name"], p["executor"]) for p in jsim.audit_programs()]
        their_spec = jsim.donation_spec()
    finally:
        jsim.close()
    sim = Simulator(audit_config(str(tmp_path), mode=mode), device="cpu")
    try:
        programs = sim.audit_programs()
        assert [(p["name"], p["executor"]) for p in programs] == theirs
        assert sorted(sim.donation_spec()) == sorted(their_spec)
        assert all(v == () for v in sim.donation_spec().values())
        assert all(p["donate"] == () and callable(p["fn"]) for p in programs)
    finally:
        sim.close()


def test_emit_kind_as_jaxs_on_the_fixture():
    path = DATA / "analysis_fixtures" / "emit_kind.py"
    ours = ast_rules.emit_kind_findings(path, root=REPO)
    assert [f.line for f in ours] == [10, 11]
    assert [_key(f) for f in ours] == [_key(f) for f in jax_emit_kind_findings(path, root=REPO)]


def test_artifact_findings_as_jaxs():
    files = find_event_files(DATA)
    assert len(files) >= 12
    for path in files:
        ours = [_key(f) for f in event_schema_findings(path, REPO)]
        assert ours == [_key(f) for f in jax_event_schema_findings(path, REPO)], path


def test_the_tree_is_clean_under_every_rule():
    assert run_rules(AuditContext()) == []


def _write(tmp_path, rel, text):
    path = tmp_path / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)
    return path


def test_host_sync_fires_on_an_unclassified_file(tmp_path):
    _write(tmp_path, "training/engine.py", "x = 1\n")
    _write(tmp_path, "newpkg/thing.py", "x = 1\n")
    traced, findings = ast_rules.host_sync_coverage(tmp_path, root=tmp_path)
    assert [p.name for p in traced] == ["engine.py"]
    assert [(f.rule, f.line) for f in findings] == [("host-sync", 0)]
    assert "newpkg/thing.py is not classified" in findings[0].message


def test_host_sync_fires_on_a_stale_allowlist_entry():
    stale = {"training/engine.py": {"Simulator.no_such_method": "renamed away",
                                    "Simulator._read_chunk": "the chunk read"}}
    findings = ast_rules.resolve_host_sync_allowlist(stale)
    assert [(f.rule, f.line) for f in findings] == [("host-sync", 0)]
    assert "'Simulator.no_such_method' no longer exists" in findings[0].message
    assert ast_rules.resolve_host_sync_allowlist() == []


SYNC_FIXTURE = '''import numpy as np
import torch


def traced_step(x):
    y = x * 2
    return y.sum().item()


def host_filter(stacked):
    return stacked.cpu().numpy()


def more(x, event):
    a = float(x.mean())
    b = int(3.0 * 2)
    event.synchronize()
    return np.asarray(x), a, b, len(x), float(np.float32(1.0))
'''


def test_host_sync_fires_at_its_lines_on_a_traced_path(tmp_path):
    path = _write(tmp_path, "training/engine.py", SYNC_FIXTURE)
    assert ast_rules.classify_host_sync("training/engine.py")[0] == "traced-only"
    found = ast_rules.host_sync_findings(path, root=tmp_path, rel="training/engine.py")
    # host_filter is an audited resolve point of training/engine.py
    assert [(f.rule, f.line, f.message.split("`")[1]) for f in found] == [
        ("host-sync", 7, ".item()"), ("host-sync", 15, "float"),
        ("host-sync", 17, ".synchronize()"), ("host-sync", 18, "np.asarray")]
    unlisted = ast_rules.host_sync_findings(path, root=tmp_path, rel="training/other.py")
    assert [f.line for f in unlisted] == [7, 11, 11, 15, 17, 18]


CLOSURE_FIXTURE = '''def build_local_update(model, lr):
    rate = float(lr)

    def batched(params):
        scale = params.sum().item()
        return params * scale * rate

    return batched


def build_round_halves(flag):
    def finish(have_genuine):
        return bool(have_genuine)

    def other(x):
        return float(x), (lambda y: y.item())(x)

    return finish, other
'''


def test_host_sync_fires_in_an_allowlisted_builders_closure(tmp_path):
    path = _write(tmp_path, "training/local.py", CLOSURE_FIXTURE)
    # the builder's entry covers its build-time body, not the closure it
    # returns; the allowlisted closure is covered, its sibling is not
    allowed = ast_rules.ALLOWED_FUNCTIONS["training/local.py"]
    assert "build_local_update" in allowed and "build_local_update.<locals>.batched" not in allowed
    found = ast_rules.host_sync_findings(path, root=tmp_path, rel="training/local.py")
    assert [(f.line, f.message.split("`")[1]) for f in found] == [(5, ".item()"), (13, "bool"),
                                                                 (16, "float"), (16, ".item()")]
    assert "build_local_update.<locals>.batched" in found[0].message
    assert "build_round_halves.<locals>.other.<locals>.<lambda>" in found[3].message
    round_py = ast_rules.host_sync_findings(path, root=tmp_path, rel="training/round.py")
    assert [f.line for f in round_py] == [2, 5, 16, 16]
    stale = {"training/hyper.py": {"build_hyper_update.<locals>.hyper_update": "the read",
                                   "build_hyper_update.<locals>.renamed": "renamed away"}}
    findings = ast_rules.resolve_host_sync_allowlist(stale)
    assert len(findings) == 1 and "'build_hyper_update.<locals>.renamed'" in findings[0].message


DONATION_FIXTURE = '''DONATION_SPEC = {"aggregate": (1,), "round_step": ()}


class Sim:
    def round(self, params, stacked, sizes):
        new = self._dispatch("aggregate", self.aggregate, params, stacked, sizes)
        keep = stacked
        self._dispatch("round_step", self.step, params, sizes)
        return new, keep, sizes

    def rebound(self, params, stacked):
        stacked = self._dispatch("aggregate", self.aggregate, params, stacked)
        return stacked
'''


def test_donation_after_use_fires_at_its_line(tmp_path):
    path = _write(tmp_path, "training/fixture.py", DONATION_FIXTURE)
    found = ast_rules.donation_after_use_findings(path, root=tmp_path)
    assert [(f.rule, f.line) for f in found] == [("donation-after-use", 7)]
    assert "`stacked`" in found[0].message and "line 6" in found[0].message


RETRACE_FIXTURE = '''def run(self, rounds, modes):
    for r in range(rounds):
        body = self._build_fused_body(True)
    while rounds:
        lib = build.load_library("fused_step")
        rounds -= 1
    cached = self._fused_bodies[int(rounds)]
    other = self._fused_body(bool(rounds))
    for mode in set(modes):
        pass

    def inner():
        return StepGraph(1, 2)
    return body, lib, cached, other, inner
'''


def test_retrace_hazard_fires_at_its_lines(tmp_path):
    path = _write(tmp_path, "fixture.py", RETRACE_FIXTURE)
    found = ast_rules.retrace_hazard_findings(path, root=tmp_path)
    assert [(f.rule, f.line) for f in found] == [("retrace-hazard", n)
                                                 for n in (3, 5, 7, 8, 9)]


def test_emit_kind_fires_on_a_typo(tmp_path):
    path = _write(tmp_path, "fixture.py", 'tel.events.emit("round")\ntel.events.emit("rond")\n')
    assert [f.line for f in ast_rules.emit_kind_findings(path, root=tmp_path)] == [2]


def _audit(fn, *args, donate=()):
    return program_audit.audit_program("fixture", "sync", fn, args, donate, device="cpu")


def test_program_audit_flags_float64_syncs_and_input_writes():
    x = torch.ones(4)
    clean = _audit(lambda t: (t * 2).sum(), x)
    assert clean.ok and clean.to_dict()["eqns"] == 2
    wide = _audit(lambda t: t.double() * 2, x)
    assert not wide.ok and len(wide.f64) == 2 and "float64" in wide.problems[0]
    sync = _audit(lambda t: t.sum().item() + bool(t.any()), x)
    assert not sync.ok and len(sync.syncs) == 2
    assert sync.to_dict()["forbidden_primitives"] == ["aten._local_scalar_dense"]
    written = _audit(lambda d: d["w"].add_(1), {"w": torch.zeros(3)})
    assert not written.ok and list(written.writes) == ["[0]['w']"]
    assert "aten.add_" in written.writes["[0]['w']"]

    def behind_its_back(t):
        t.numpy()[0] = 5.0    # no aten op: only the bitwise comparison sees it
        return t

    hidden = _audit(behind_its_back, torch.zeros(3))
    assert not hidden.ok and "did not see" in hidden.writes["[0]"]
    consumed = _audit(lambda a, b: a.mul_(b), torch.ones(3), torch.ones(3), donate=(0,))
    assert consumed.ok and consumed.to_dict()["aliased_leaves"] == 1
    finding, = program_audit.reports_to_findings([written])
    assert (finding.rule, finding.file) == ("program-audit", "<program:fixture>")


@pytest.mark.parametrize("executor,overrides", [
    ("run", {}), ("run_fast", {"chunk_size": 1}), ("pipeline", {"pipeline_depth": 2}),
    ("matrix", {}), ("sharded", {})])
def test_recompile_guard_passes_each_executor(executor, overrides):
    findings = retrace.guard_findings(device="cpu", executors=((executor, overrides),))
    assert findings == []


def test_recompile_guard_flags_a_step_graph_captured_after_round_1(tmp_path):
    from attackfl_tpu_torch.matrix.grid import grid_from_dict
    from attackfl_tpu_torch.training.matrix_exec import MatrixRun

    sweep = MatrixRun(audit_config(str(tmp_path), prng_impl="threefry2x32"),
                      grid_from_dict(retrace.GUARD_GRID), device="cpu")
    real = sweep._run_chunk

    def chunk(cells, states, n, histories):
        # the CPU replays no graph: stand one in for a capture in round 2
        if sweep.update.graphs == {} and int(states[0]["completed_rounds"]) == 1:
            sweep.update.graphs[4] = object()
        return real(cells, states, n, histories)

    sweep._run_chunk = chunk
    try:
        problems = retrace.run_matrix_with_guard(sweep)
    finally:
        sweep.close()
    assert problems == ["step_graph[segment=4]: built after round 1"]


def test_recompile_guard_flags_a_rebuilt_body(tmp_path):
    sim = Simulator(audit_config(str(tmp_path), pipeline_depth=2), device="cpu")
    calls = []

    def runner(sim, state, target):
        if calls:
            sim._fused_bodies.clear()      # the rest of the run rebuilds it
        calls.append(target)
        return sim.run(num_rounds=target, state=state, save_checkpoints=False,
                       verbose=False, pipeline=True)[0]

    try:
        problems = retrace.run_with_guard(sim, runner=runner)
    finally:
        sim.close()
    assert calls == [1, 3]
    assert problems == ["fused_body[eval=True]: rebuilt after round 1"]


def test_audit_command_is_clean_with_jaxs_keys(capsys):
    assert port_cli.main(["audit", "--json", "--device", "cpu", "--skip-grad"]) == 0
    report = json.loads(capsys.readouterr().out)
    golden = json.loads((DATA / "audit_report.json").read_text())
    assert list(report) == list(golden)
    assert report["ok"] is True and report["findings"] == []
    assert report["schema"] == golden["schema"] == 2
    assert report["grad_programs"] == report["dataflow"] == []
    names = [p["name"] for p in report["programs"]]
    programs = ("round_step", "aggregate", "fused_chunk[2]", "pipeline_step[eval=True]")
    sharded = [f"sharded-{m}[2 shards]:{p}" for m in ("fedavg", "median", "FLTrust")
               for p in programs]
    assert names == ["fedavg:round_step", "fedavg:aggregate", "fedavg:fused_chunk[2]",
                     "fedavg:pipeline_step[eval=True]", "matrix_step[4 cells]",
                     *sharded, "sharded[2 shards]:matrix_step[3 cells]"]
    for p in report["programs"]:
        assert set(golden["programs"][0]) <= set(p)
        assert p["ok"] and p["syncs"] == 0 and p["f64_outputs"] == 0
        # the client mesh's programs record their defense's collectives,
        # round_step and every meshless or cell-sharded program none
        mode = p["name"].split("[")[0].removeprefix("sharded-")
        want = (sorted(program_audit.EXPECTED_COLLECTIVES[mode]["forward"])
                if p["name"] in sharded and not p["name"].endswith("round_step") else [])
        assert p["collectives"] == p["expected_collectives"] == want, p["name"]
    assert set(report["transfer_budget"]) == set(golden["transfer_budget"])
    assert report["transfer_budget"]["resolved"] is True
    rules = {r["id"]: r["description"] for r in report["rules"]}
    assert {"host-sync", "donation-after-use", "retrace-hazard", "emit-kind",
            "event-schema", "program-audit", "retrace-guard"} <= set(rules)
    assert "not ported" not in rules["grad-audit"] + rules["program-audit"]
    assert "EXPECTED_COLLECTIVES" in rules["grad-audit"] and "collectives" in rules[
        "program-audit"]


def test_audit_grad_runs_and_skip_grad_excludes_it(capsys):
    with pytest.raises(SystemExit) as refused:
        port_cli.main(["audit", "--grad", "--skip-grad"])
    assert refused.value.code == 2
    assert "--grad and --skip-grad are mutually exclusive" in capsys.readouterr().err
    assert port_cli.main(["audit", "--grad", "--skip-programs", "--device", "cpu"]) == 0
    assert capsys.readouterr().out.splitlines()[-1].endswith(
        "0 program(s), 12 grad program(s), 10 dataflow verdict(s), 0 finding(s) — OK")
    assert port_cli.main(["audit", "--skip-programs", "--skip-sharded"]) == 0
    assert capsys.readouterr().out.splitlines()[-1].endswith("0 finding(s) — OK")

