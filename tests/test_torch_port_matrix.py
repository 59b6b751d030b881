"""The port's scenario matrix (``matrix/``, ``training/matrix_exec.py``)
on the CPU, at the size of ``test_torch_port_fused_rounds.py``
(TransformerModel on ICU, 8 clients, 2 epochs, batch 16, 3 rounds).

1. Per-cell bit-identity: a sweep of LIE, Random (cohort 2, from round 2)
   and ``none`` x fedavg, krum, median, FLTrust, gmm and hyper x seeds 1
   and 2 under ``xla``, with stragglers at rate 0.5 and a fault plan that
   forces six clients out at broadcasts 2 and 3 (a cell fails there when
   its own draw drops the other two, so cells fail at different
   broadcasts and finish in different chunks) and storms a client at
   broadcast 4.  Every cell's final state, the generator's included,
   equals ``Simulator.run_fast`` of its cell_config (``run`` for the gmm
   cells, whose executor it is); one cell of each group also equals
   ``Simulator.run``.
2. The folded local update against the unfolded one, bit for bit: the
   masks, the gradients and the updated rows.
3. Kill and resume: stopped at each chunk boundary and after a fallback
   cell, the resumed grid equals the uninterrupted one, byte for byte.
4. Quarantine: a Random attack at sigma 1e39 makes every fedavg
   aggregate NaN (a storm that never recovers): that cell is aborted
   (``cell_aborted``) where its standalone run raises, and the median
   cell completes.
5. The grid module against JAX's on the same inputs, and the JAX
   package's ``MatrixRun`` on one tiny grid (its cells, groups, ok
   sequences and ``matrix`` event actions).
6. JAX's torch-free code on the port's output: ``validate_event``,
   ``sweep_records`` and ``cell_event_summaries``, ``outcome_rows`` and
   ``leaderboard``, ``matrix status``.
7. ``--mesh``, refused until ROADMAP item 14a was ported, runs the sweep
   over the client mesh of the visible devices (one on the CPU), and a
   2-shard mesh gives every cell the unsharded sweep's bits
   (tests/test_torch_port_mesh.py holds the cell axis at more sizes).
"""

from __future__ import annotations

import dataclasses
import json
import os
import unittest.mock

import numpy as np
import pytest
import torch
from _torch_port_threads import one_torch_thread  # noqa: F401

from attackfl_tpu_torch import cli
from attackfl_tpu_torch.config import AttackSpec, Config, TelemetryConfig
from attackfl_tpu_torch.faults.plan import parse_fault_plan
from attackfl_tpu_torch.ledger.store import LedgerStore
from attackfl_tpu_torch.matrix import grid as mgrid
from attackfl_tpu_torch.matrix.grid import GridSpec, cell_config, expand_cells
from attackfl_tpu_torch.models.icu import TransformerModel
from attackfl_tpu_torch.ops import fused_step
from attackfl_tpu_torch.ops import pytree as pt
from attackfl_tpu_torch.telemetry.summary import load_events
from attackfl_tpu_torch.training import local
from attackfl_tpu_torch.training.engine import Simulator
from attackfl_tpu_torch.training.matrix_exec import MAX_CELL_RETRIES, MatrixRun

SMALL = dict(num_round=3, total_clients=8, mode="fedavg", model="TransformerModel",
             data_name="ICU", num_data_range=(24, 32), epochs=2, batch_size=16,
             train_size=256, test_size=128, prng_impl="threefry2x32")
PLAN = ("dropout@2:clients=0,1,2,3,4,5;dropout@3:clients=0,1,2,3,4,5;"
        "nan_storm@4:clients=1")
LIE = AttackSpec(mode="LIE", num_clients=2, attack_round=2)
RANDOM = AttackSpec(mode="Random", num_clients=2, attack_round=2)
NONE = AttackSpec(mode="none", num_clients=2, attack_round=2)
DEFENSES = ("fedavg", "krum", "median", "FLTrust", "gmm", "hyper")
GRID = GridSpec(attacks=(LIE, RANDOM, NONE), defenses=DEFENSES, seeds=(1, 2), rounds=3,
                chunk=2)
CELLS = expand_cells(GRID)


def _telemetry(root, enabled: bool = True) -> TelemetryConfig:
    return TelemetryConfig(enabled=enabled, events_path=os.path.join(root, "events.jsonl"),
                           trace_path=os.path.join(root, "trace.json"),
                           ledger_dir=os.path.join(root, "ledger"))


def _base(root, **kw) -> Config:
    return Config(**{**SMALL, "log_path": str(root), "checkpoint_dir": str(root),
                     "telemetry": _telemetry(str(root)), **kw})


def _sweep_base(root) -> Config:
    return _base(root, client_dropout_rate=0.5, faults=parse_fault_plan(PLAN))


def _run(base: Config, grid: GridSpec, **kw):
    sweep = MatrixRun(base, grid, device="cpu")
    try:
        params, histories = sweep.run(verbose=False, **kw)
    finally:
        sweep.close()
    return sweep, params, histories


def _grid_state(sweep: MatrixRun, params: dict) -> dict:
    """The final grid as host values: every device cell's checkpointed
    state, every fallback cell's final params."""
    out = sweep.host_state(sweep.state)
    for cell in sweep.fallback_cells:
        out[cell.key] = {"params": params.get(cell.key)}
    return out


def _assert_same(a, b, where: str = "") -> None:
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), where
        for key in a:
            _assert_same(a[key], b[key], f"{where}/{key}")
    elif isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype, where
        assert torch.equal(a, b), where
    else:
        assert a == b, where


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    """The sweep of GRID, run once for the module."""
    root = tmp_path_factory.mktemp("sweep")
    base = _sweep_base(root)
    runner, params, histories = _run(base, GRID, save_checkpoints=False)
    return {"root": str(root), "base": base, "sweep": runner, "params": params,
            "histories": histories}


def _standalone(base: Config, cell, root, executor: str):
    cfg = cell_config(base, cell, rounds=GRID.rounds, log_path=str(root),
                      checkpoint_dir=str(root), faults=base.faults,
                      telemetry=TelemetryConfig(enabled=False))
    sim = Simulator(cfg, device="cpu")
    run = sim.run_fast if executor == "run_fast" else sim.run
    state, history = run(state=sim.init_state(), save_checkpoints=False, verbose=False)
    return sim, state, history


def _check_cell(sweep, cell, executor: str, root) -> None:
    runner = sweep["sweep"]
    sim, state, history = _standalone(sweep["base"], cell, root, executor)
    assert [h["ok"] for h in history] == [h["ok"] for h in sweep["histories"][cell.key]]
    if cell.group in ("batched", "mapped"):
        mine = dict(runner.host_state(runner.state)[cell.key])
        mine.pop("failures")
        theirs = sim.host_state(dict(state, completed_rounds=int(state["completed_rounds"]),
                                     have_genuine=bool(state["have_genuine"])))
        _assert_same(mine, theirs, cell.key)
    else:
        key = "hnet_params" if cell.group == "special" else "global_params"
        _assert_same({"p": sweep["params"][cell.key]}, {"p": state[key]}, cell.key)


@pytest.mark.parametrize("key", [c.key for c in CELLS])
def test_every_cell_equals_its_run_fast(sweep, key, tmp_path):
    """A cell's final state (params, leak pool, generator, clocks) is its
    standalone run_fast's (run's for gmm, which has no fused path)."""
    cell = next(c for c in CELLS if c.key == key)
    _check_cell(sweep, cell, "run" if cell.group == "host" else "run_fast", tmp_path)


@pytest.mark.parametrize("key", ["LIExkrum.s2", "RandomxFLTrust.s1", "nonexgmm.s2",
                                 "LIExhyper.s1"])
def test_one_cell_of_each_group_equals_its_run(sweep, key, tmp_path):
    cell = next(c for c in CELLS if c.key == key)
    _check_cell(sweep, cell, "run", tmp_path)


def test_the_plan_spreads_the_cells_over_chunks(sweep):
    """The forced dropout fails a cell where its own draw drops the two
    clients left: the device cells fail different broadcasts, need
    different numbers of broadcasts and leave the sweep in different
    chunks; the sweep's chunks are capped by the fewest rounds a live
    cell still needs."""
    runner, histories = sweep["sweep"], sweep["histories"]
    device = [c.key for c in runner.device_cells]
    failed = {tuple(i for i, h in enumerate(histories[k]) if not h["ok"]) for k in device}
    lengths = {len(histories[k]) for k in device}
    assert len(failed) > 1 and len(lengths) > 1
    events = load_events(os.path.join(sweep["root"], "events.jsonl"))
    chunks = [e for e in events if e["kind"] == "matrix" and e["action"] == "chunk"]
    assert [e["chunk_len"] for e in chunks][0] == 2 and len(chunks) >= 3
    assert all(len(histories[k]) >= GRID.rounds for k in histories)
    assert runner.fold_calls == sum(e["chunk_len"] for e in chunks)


def test_the_fold_equals_the_unfolded_update():
    """Three runs' 8 clients each, trained in one call of the local
    update (per-row seeds and client ids), against each run alone: the
    masks of a step, the gradients and the updated rows, bit for bit;
    with the gradient a run at a time (the matrix's) and in one call."""
    torch.manual_seed(0)
    model = TransformerModel()
    cfg = Config(**SMALL)
    from attackfl_tpu_torch.data.synthetic import get_dataset
    from attackfl_tpu_torch.training.round import build_attack_groups, round_drawer

    data = {k: torch.as_tensor(v) for k, v in
            get_dataset("ICU", "train", cfg.train_size, 1).items()}
    update = local.build_local_update(model, "ICU", data, epochs=2, batch_size=16, lr=0.004,
                                      clip_grad_norm=1.0)
    groups, genuine = build_attack_groups(cfg)
    draw = round_drawer(cfg, groups, len(genuine), cfg.train_size, 1, cfg.test_size)
    C, cells = 8, 3
    runs = []
    for seed in range(cells):
        gen = torch.Generator().manual_seed(seed + 11)
        runs.append((model.init(torch.Generator().manual_seed(seed + 1)), draw(gen)))
    alone = [update(p, d.idx, d.mask, d.perms, d.dropout_seed) for p, d in runs]
    stacked = pt.tree_map(lambda *xs: torch.cat(xs), *[pt.tree_broadcast(p, C) for p, _ in runs])
    seed = torch.cat([d.dropout_seed.reshape(1).expand(C) for _, d in runs])
    ids = torch.arange(C).repeat(cells)
    args = (stacked, torch.cat([d.idx for _, d in runs]), torch.cat([d.mask for _, d in runs]),
            torch.cat([d.perms for _, d in runs], dim=1), seed, ids)
    for segment in (C, None):
        fold = update(*args, segment=segment)
        for c, (a_params, a_ok, a_loss) in enumerate(alone):
            rows = slice(c * C, (c + 1) * C)
            _assert_same(a_params, pt.tree_map(lambda x: x[rows], fold[0]), f"cell {c}")
            assert torch.equal(a_ok, fold[1][rows]) and torch.equal(a_loss, fold[2][rows])
    specs = model.mask_specs([(16,)], model.dropout_rates)
    keys = fused_step.client_keys(seed + 1, 5, ids)
    folded = local.step_masks(keys, specs)
    template = pt.tree_map(lambda x: x[0], stacked)
    step = local.build_step_grad(model, "ICU", template)
    flat = pt.tree_ravel_stacked(stacked)
    idx = args[1][:, :16]
    inputs, label = (data["vitals"][idx], data["labs"][idx]), data["label"][idx].float()
    mask = args[2][:, :16].float()
    grads, loss = step(flat, inputs, label, mask, folded)
    for c, (_, d) in enumerate(runs):
        rows = slice(c * C, (c + 1) * C)
        own = local.step_masks(fused_step.client_keys(d.dropout_seed + 1, 5, torch.arange(C)),
                               specs)
        assert all(torch.equal(a, b[rows]) for a, b in zip(own, folded))
        g, v = step(flat[rows], tuple(x[rows] for x in inputs), label[rows], mask[rows], own)
        assert torch.equal(g, grads[rows]) and torch.equal(v, loss[rows])


@pytest.mark.cuda
def test_the_fold_replays_the_eager_step_on_the_card():
    """On the card, at 8 clients a cell (below the 16 rows where the
    clip's row reduction keeps its split), the fold's gradient issued a
    cell at a time and replayed from one captured graph: the same bits
    as each cell's own update."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the captured graph has no CPU mode")
    from attackfl_tpu_torch.data.synthetic import get_dataset

    model, C, cells = TransformerModel(), 8, 3
    data = {k: torch.as_tensor(v, device="cuda")
            for k, v in get_dataset("ICU", "train", 256, 1).items()}
    update = local.build_local_update(model, "ICU", data, epochs=2, batch_size=16, lr=0.004,
                                      clip_grad_norm=1.0)
    gen = torch.Generator(device="cuda").manual_seed(5)
    params = [model.init(torch.Generator().manual_seed(i + 1), "cuda") for i in range(cells)]
    idx = torch.randint(0, 256, (C * cells, 32), generator=gen, device="cuda")
    mask = torch.rand((C * cells, 32), generator=gen, device="cuda") < 0.8
    perms = torch.argsort(torch.rand((2, C * cells, 32), generator=gen, device="cuda"), dim=-1)
    seed = torch.arange(cells, device="cuda").repeat_interleave(C) * 977 + 3
    ids = torch.arange(C, device="cuda").repeat(cells)
    stacked = pt.tree_map(lambda *xs: torch.cat(xs), *[pt.tree_broadcast(p, C) for p in params])
    fold = update(stacked, idx, mask, perms, seed, ids, segment=C)
    with unittest.mock.patch.object(local, "counting", lambda: True):
        eager = update(stacked, idx, mask, perms, seed, ids, segment=C)
    for c in range(cells):
        r = slice(c * C, (c + 1) * C)
        alone = update(params[c], idx[r], mask[r], perms[:, r], seed[c * C])
        for label, got in (("eager", eager), ("replayed", fold)):
            _assert_same(alone[0], pt.tree_map(lambda x: x[r], got[0]), f"{label} cell {c}")
            assert torch.equal(alone[2], got[2][r]), f"{label} cell {c}"


RESUME_GRID = GridSpec(attacks=(LIE,), defenses=("fedavg", "FLTrust", "gmm"), seeds=(1, 2),
                       rounds=3, chunk=1)


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    root = tmp_path_factory.mktemp("whole")
    runner, params, histories = _run(_base(root, telemetry=_telemetry(str(root), False)),
                                     RESUME_GRID)
    return _grid_state(runner, params)


@pytest.mark.parametrize("consult", [2, 3, 5])
def test_a_stopped_sweep_resumes_to_the_same_grid(uninterrupted, consult, tmp_path):
    """The stop hook at the sweep's ``consult``-th boundary: after the
    first chunk, after the second, after the first fallback cell; the
    resumed sweep ends on the uninterrupted grid, byte for byte, and a
    fallback cell completed before the stop runs zero rounds."""
    calls = []
    real = MatrixRun._consult_stop

    def counted(self, hook, completed):
        calls.append(completed)
        return real(self, hook, completed)

    base = _base(tmp_path, telemetry=_telemetry(str(tmp_path), False))
    MatrixRun._consult_stop = counted
    try:
        first, _, done = _run(base, RESUME_GRID,
                              stop=lambda _: "drain" if len(calls) >= consult else None)
    finally:
        MatrixRun._consult_stop = real
    assert first.interrupted and first.stop_reason == "drain"
    runner, params, histories = _run(base.replace(resume=True), RESUME_GRID)
    for key, history in done.items():
        if key in {c.key for c in runner.fallback_cells}:
            assert histories[key] == []
    _assert_same(_grid_state(runner, params), uninterrupted)
    manifest = json.load(open(tmp_path / "manifest.json"))
    assert all(e["file"].startswith("matrix.r") for e in manifest["entries"])


def test_a_cell_that_never_recovers_is_quarantined(tmp_path, capsys):
    """Random at sigma 1e39: every fedavg aggregate is NaN and fails its
    validation; after MAX_CELL_RETRIES the cell is aborted, as its
    standalone run_fast aborts, and the median cell completes."""
    grid = GridSpec(attacks=(AttackSpec(mode="Random", num_clients=2, attack_round=2,
                                        args=(1e39,)),),
                    defenses=("fedavg", "median"), seeds=(1,), rounds=3, chunk=2)
    base = _base(tmp_path)
    runner, params, histories = _run(base, grid)
    aborted, median = "Randomxfedavg.s1", "Randomxmedian.s1"
    events = load_events(os.path.join(str(tmp_path), "events.jsonl"))
    quarantined = [e for e in events if e["kind"] == "matrix" and e["action"] == "cell_aborted"]
    failures = len(histories[aborted]) - 1
    assert [(e["cell"], e["consecutive_failures"]) for e in quarantined] == [(aborted, failures)]
    assert failures > MAX_CELL_RETRIES and "quarantined" in capsys.readouterr().out
    assert [h["ok"] for h in histories[aborted]] == [True] + [False] * failures
    assert sum(h["ok"] for h in histories[median]) == 3
    assert runner.state[median]["completed_rounds"] == 3
    assert runner.state[aborted]["failures"] == failures
    with pytest.raises(RuntimeError, match="times in a row"):
        _standalone(base, expand_cells(grid)[0], tmp_path / "alone", "run_fast")


def test_numerics_windows_and_the_cost_model_keep_the_bits(tmp_path, monkeypatch):
    """Numerics on, a hotspot window over round 1 and the cost model on:
    one numerics metric event a cell and round, stamped with its cell,
    a `hotspot` event of the matrix seam, one `matrix_chunk[2]` profile
    with its rounds and cells; every cell's state the bits of the sweep
    with all three off."""
    grid = GridSpec(attacks=(LIE,), defenses=("fedavg", "FLTrust"), seeds=(1,), rounds=2,
                    chunk=2)
    off, _, _ = _run(_base(tmp_path / "off", telemetry=_telemetry(str(tmp_path / "off"),
                                                                   False)), grid)
    monkeypatch.setenv("ATTACKFL_COSTMODEL", "1")
    root = str(tmp_path / "on")
    telemetry = dataclasses.replace(_telemetry(root), numerics=True, numerics_window=2,
                                    hotspots="1:1")
    on, _, histories = _run(_base(root, telemetry=telemetry), grid)
    _assert_same(on.host_state(on.state), off.host_state(off.state))
    events = load_events(os.path.join(root, "events.jsonl"))
    rows = [(e["cell"], e["round"]) for e in events
            if e["kind"] == "metric" and e.get("metric") == "numerics"]
    assert sorted(rows) == sorted((k, h["round"]) for k, v in histories.items() for h in v)
    (profile,) = [e for e in events if e["kind"] == "program_profile"]
    assert (profile["program"], profile["rounds_per_dispatch"], profile["cells"]) == \
        ("matrix_chunk[2]", 2, 2) and profile["flops"] > 0
    assert [e["program"] for e in events if e["kind"] == "hotspot"] == ["matrix"]


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

def _jax():
    import jax

    jax.config.update("jax_platforms", "cpu")
    from attackfl_tpu import config as jconfig
    from attackfl_tpu.matrix import grid as jgrid

    return jconfig, jgrid


GRID_DICTS = [
    {"attacks": ["LIE", {"mode": "Min-Max", "num-clients": 1, "attack-round": 3,
                         "args": [50, 1]}],
     "attack-clients": 1, "defenses": ["fedavg", "median"], "seeds": [1, 2, 3], "rounds": 5,
     "chunk": 2},
    {"attacks": ["none", "Random"], "defenses": ["gmm", "hyper", "FLTrust", "byzantine"]},
    {},
]


@pytest.mark.parametrize("raw", GRID_DICTS)
def test_the_grid_module_as_jaxs(raw):
    """grid_from_dict, expand_cells, the groups and cell_config on the same
    inputs: the same cells and the same standalone configs."""
    jconfig, jgrid = _jax()
    ours, theirs = mgrid.grid_from_dict(raw), jgrid.grid_from_dict(raw)
    assert ours.describe() == theirs.describe()
    cells, jcells = expand_cells(ours), jgrid.expand_cells(theirs)
    assert [(c.key, c.group, c.describe()) for c in cells] == \
        [(c.key, c.group, c.describe()) for c in jcells]
    base = Config(**SMALL, data_seed=None)
    jbase = jconfig.Config(**SMALL)
    for cell, jcell in zip(cells, jcells):
        a = dataclasses.asdict(cell_config(base, cell, rounds=4))
        b = dataclasses.asdict(jgrid.cell_config(jbase, jcell, rounds=4))
        assert {k: a[k] for k in b if k in a} == {k: b[k] for k in b if k in a}


REFUSALS = [
    ({"prng_impl": "rbg"}, ("fedavg",)),
    ({"partition": "dirichlet"}, ("fedavg",)),
    ({"local_backend": "pallas"}, ("fedavg",)),
    ({"validation_async": True}, ("fedavg",)),
    ({"hyper_detection": "on"}, ("fedavg", "hyper")),
]


@pytest.mark.parametrize("kw, defenses", REFUSALS)
def test_validate_base_refuses_as_jaxs(kw, defenses):
    jconfig, jgrid = _jax()
    from attackfl_tpu_torch.config import HyperDetectionConfig

    mine, theirs = dict(kw), dict(kw)
    if "hyper_detection" in kw:
        mine["hyper_detection"] = HyperDetectionConfig(enable=True)
        theirs["hyper_detection"] = jconfig.HyperDetectionConfig(enable=True)
    grid = GridSpec(attacks=(LIE,), defenses=defenses, seeds=(1,))
    jgrid_spec = jgrid.GridSpec(attacks=(jconfig.AttackSpec(mode="LIE", num_clients=2),),
                                defenses=defenses, seeds=(1,))
    with pytest.raises(ValueError) as ours:
        grid.validate_base(Config(**{**SMALL, **mine}))
    with pytest.raises(ValueError) as jax_error:
        jgrid_spec.validate_base(jconfig.Config(**{**SMALL, **theirs}))
    assert str(ours.value) == str(jax_error.value)
    with pytest.raises(ValueError) as ours:
        GridSpec(attacks=(LIE, AttackSpec(mode="Random", num_clients=3)), defenses=("fedavg",),
                 seeds=(1,))
    with pytest.raises(ValueError) as jax_error:
        jgrid.GridSpec(attacks=(jconfig.AttackSpec(mode="LIE", num_clients=2),
                                jconfig.AttackSpec(mode="Random", num_clients=3)),
                       defenses=("fedavg",), seeds=(1,))
    assert str(ours.value) == str(jax_error.value)


def test_the_same_sweep_as_jaxs_matrix_run(tmp_path):
    """LIE x fedavg, FLTrust x seeds 1, 2, 2 rounds (CNNModel, one epoch,
    no validation) through both packages' MatrixRun: the same cells and groups, ok sequences and
    sequence of matrix event actions."""
    jconfig, jgrid = _jax()
    from attackfl_tpu.training.matrix_exec import MatrixRun as JaxMatrixRun

    # CNNModel, one epoch, no validation: the JAX package compiles the
    # sweep's program
    small = {**{k: v for k, v in SMALL.items() if k != "num_round"}, "model": "CNNModel",
             "epochs": 1, "validation": False}
    grid = GridSpec(attacks=(LIE,), defenses=("fedavg", "FLTrust"), seeds=(1, 2), rounds=2)
    jgrid_spec = jgrid.GridSpec(attacks=(jconfig.AttackSpec(mode="LIE", num_clients=2,
                                                            attack_round=2),),
                                defenses=("fedavg", "FLTrust"), seeds=(1, 2), rounds=2)
    jroot = tmp_path / "jax"
    jcfg = jconfig.Config(**small, num_round=2, log_path=str(jroot), checkpoint_dir=str(jroot),
                          telemetry=jconfig.TelemetryConfig(
                              events_path=str(jroot / "events.jsonl"),
                              trace_path=str(jroot / "trace.json"), ledger=False))
    jrun = JaxMatrixRun(jcfg, jgrid_spec)
    _, jhist = jrun.run(verbose=False, save_checkpoints=False)
    jrun.close()
    runner, _, hist = _run(_base(tmp_path / "port", num_round=2, model="CNNModel", epochs=1,
                                 validation=False), grid, save_checkpoints=False)
    assert [(c.key, c.group) for c in runner.cells] == [(c.key, c.group) for c in jrun.cells]
    assert {k: [h["ok"] for h in v] for k, v in hist.items()} == \
        {k: [h["ok"] for h in v] for k, v in jhist.items()}
    assert {k: [sorted(h) for h in v] for k, v in hist.items()} == \
        {k: [sorted(h) for h in v] for k, v in jhist.items()}

    def actions(path):
        return [e["action"] for e in load_events(str(path)) if e["kind"] == "matrix"]

    assert actions(tmp_path / "port" / "events.jsonl") == actions(jroot / "events.jsonl") == \
        ["started", "chunk", "completed"]


def test_jaxs_code_reads_the_ports_sweep(sweep, capsys):
    """JAX's validate_event accepts every matrix and science event;
    JAX's sweep_records and cell_event_summaries give the port's ledger
    records from the port's histories; JAX's outcome_rows and
    leaderboard give the port's science event; JAX's matrix status
    prints the port's table on the port's ledger."""
    _jax()
    from attackfl_tpu.matrix import cli as jcli
    from attackfl_tpu.matrix import grid as jgrid
    from attackfl_tpu.matrix import records as jrecords
    from attackfl_tpu.science.outcomes import outcome_rows
    from attackfl_tpu.science.rank import leaderboard
    from attackfl_tpu.telemetry.events import validate_event

    from attackfl_tpu_torch.telemetry.events import validate_event as our_validate

    root, runner = sweep["root"], sweep["sweep"]
    events = load_events(os.path.join(root, "events.jsonl"))
    kinds = [e for e in events if e["kind"] in ("matrix", "science")]
    assert {e["kind"] for e in kinds} == {"matrix", "science"}
    assert all(not validate_event(e) and not our_validate(e) for e in events)
    ours = [r for r in LedgerStore(os.path.join(root, "ledger")).load()[0]
            if r.get("source") == "matrix"]
    assert len(ours) == len(CELLS) and len({r["sweep_id"] for r in ours}) == 1
    jconfig, _ = _jax()
    jbase = jconfig.Config(**{**SMALL, "client_dropout_rate": 0.5})
    jcells = jgrid.expand_cells(jgrid.grid_from_dict(
        {"attacks": [{"mode": a.mode, "num-clients": 2, "attack-round": 2}
                     for a in (LIE, RANDOM, NONE)],
         "defenses": list(DEFENSES), "seeds": [1, 2], "rounds": 3, "chunk": 2}))
    summaries = jrecords.cell_event_summaries(
        events + [dict(e, cell=c.key) for c in runner.fallback_cells
                  for e in load_events(os.path.join(root, "cells", c.key, "events.jsonl"))])
    volatile = ("ts", "record_id", "wall_seconds", "rounds_per_sec_steady",
                "time_attribution", "programs", "utilization", "torch_version", "backend",
                "mesh_devices", "run_id", "fingerprint", "resumed")
    theirs = jrecords.sweep_records(
        sweep_id=runner.sweep_id, cells=jcells, histories=sweep["histories"], base_cfg=jbase,
        rounds=3, run_id=None, ts=None, wall_s=1.0, event_summaries=summaries)
    assert [{k: v for k, v in r.items() if k not in volatile} for r in ours] == \
        [{k: v for k, v in r.items() if k not in volatile} for r in theirs]
    (science,) = [e for e in events if e["kind"] == "science"]
    board = leaderboard(outcome_rows(ours, sweep_id=runner.sweep_id),
                        sweep_id=runner.sweep_id, n_boot=200)
    assert [(e["defense"], e["rank"], e["damage_mean"]) for e in board["leaderboard"]] == \
        [(e["defense"], e["rank"], e["damage_mean"]) for e in science["leaderboard"]]
    argv = ["status", "--dir", os.path.join(root, "ledger")]
    capsys.readouterr()
    assert jcli.main(argv) == 0
    jax_table = capsys.readouterr().out
    assert cli.main(["matrix", *argv]) == 0
    assert capsys.readouterr().out == jax_table


def test_mesh_is_refused_naming_item_14(tmp_path, capsys, monkeypatch):
    """``--mesh`` was refused until the client mesh (ROADMAP item 14a) was
    ported: it now runs, and ``use_mesh`` builds the mesh of the visible
    devices, which the run header records."""
    config = tmp_path / "sweep.yaml"
    config.write_text(
        "server: {clients: 4, model: TransformerModel, data-name: ICU, num-round: 1, "
        "train-size: 128, test-size: 64, data-distribution: {num-data-range: [16, 24]}}\n"
        "learning: {epoch: 1, batch-size: 16}\n"
        "matrix: {attacks: [none], attack-clients: 1, defenses: [fedavg], seeds: [1], "
        "rounds: 1}\n")
    monkeypatch.setenv("ATTACKFL_TELEMETRY_DIR", str(tmp_path / "sweep"))
    assert cli.main(["matrix", "run", "--config", str(config), "--mesh", "--device", "cpu",
                     "--sweep-dir", str(tmp_path / "sweep")]) == 0
    assert "finished: 1/1 cells ran" in capsys.readouterr().out
    with open(tmp_path / "sweep" / "events.jsonl") as fh:
        header, = [e for e in map(json.loads, fh) if e["kind"] == "run_header"]
    assert header["mesh_devices"] == 1
    sweep = MatrixRun(_base(tmp_path), GridSpec(attacks=(LIE,), defenses=("fedavg",),
                                                seeds=(1,)), use_mesh=True, device="cpu")
    assert sweep.mesh.size == 1 and sweep.mesh.lead == torch.device("cpu")
    sweep.close()


def test_status_and_usage(sweep, capsys):
    root = sweep["root"]
    assert cli.main(["matrix"]) == 2
    assert cli.main(["matrix", "--help"]) == 0
    assert "run|status" in capsys.readouterr().out
    assert cli.main(["matrix", "status", "--dir", os.path.join(root, "ledger"), "--json"]) == 0
    records = json.loads(capsys.readouterr().out)
    assert {r["cell"] for r in records} == {c.key for c in CELLS}
    assert np.all([r["sweep_id"] == sweep["sweep"].sweep_id for r in records])
    assert cli.main(["matrix", "status", "--dir", os.path.join(root, "nothing")]) == 2
