"""MatrixRun: the scenario-matrix executor (the port's
``attackfl_tpu/training/matrix_exec.py``).

Runs a whole (attack × defense × seed) grid on one card.  The device
cells (the batched and mapped groups, ``matrix/grid.py``) advance
together, one sweep round a broadcast (``matrix/program.sweep_round``:
per cell its draws, one folded local update for every cell's clients,
per cell its finish, aggregate, validation and accept).  The host
defenses (gmm, fltracer) and hyper fall back to per-cell child
Simulators, as JAX runs them: gmm and fltracer per cell through ``run``
with a warning, hyper through ``run_fast``.

Executor contract, as JAX's:

* **bit-identity** — every cell's final state equals a standalone
  ``Simulator.run`` / ``run_fast`` of its ``cell_config``
  (``tests/test_torch_port_matrix.py``).  A torch.Generator cannot be
  frozen by a ``where`` as JAX freezes a finished cell, so no cell is
  ever frozen: each chunk is capped at the fewest rounds any live cell
  still needs (and at ``grid.chunk``), every live cell runs every
  broadcast of the chunk, and a cell that has reached the target takes
  no part in later chunks (no draws, no training).  Every cell's
  generator and clocks are then its standalone run's at every chunk
  boundary.  The ``chunk`` events' lengths therefore differ from JAX's.
* **one read of the card a chunk** — ``_resolve_chunk`` copies every
  live cell's metrics for every round of the chunk, the numerics rows
  among them, and their completed-round counts and leak flags, in one
  float64 copy, as ``Simulator._read_chunk`` does for one run.  A
  γ-search attack in the grid (Min-Max, Min-Sum, Opt-Fang) adds its own
  reads (ROADMAP item 3a).
* **crash safety** — the device cells' states (generators included, as
  their ``get_state()``; the consecutive failures of each) are saved
  after every chunk through the port's ``CheckpointManager``
  (``matrix.r<round>.pth`` and the manifest; a JAX ``.msgpack`` entry is
  skipped); fallback cells checkpoint through their own Simulators.
  ``resume=True`` restores the newest valid entry and re-runs the
  fallback cells with ``resume`` (a completed one reloads its final state
  and runs zero rounds), so a killed sweep resumes to the same grid,
  byte for byte.
* **observability** — the schema-v7 ``matrix`` events (started, chunk,
  fallback, cell_done, cell_aborted, resumed, interrupted, completed)
  with JAX's fields, per-cell numerics rows riding the chunk's read
  (each cell's drainer stamps its events with the cell), a hotspot
  window at the chunk seam with ``program="matrix"``, the cost model's
  ``matrix_chunk[n]`` ``program_profile`` counted on its first dispatch,
  one ledger record a cell sharing the ``sweep_id``, and the schema-v13
  ``science`` event; the distillation is fail-open, as in JAX.
* **quarantine, not collapse** — a cell that fails more than
  ``MAX_CELL_RETRIES`` rounds in a row (where its standalone run would
  abort) is quarantined with a ``cell_aborted`` event and leaves the
  sweep; the other cells complete.

* **the cell axis over a client mesh** — ``use_mesh`` (or ``mesh``, JAX
  matrix_exec.py:106-131): the device cells split over the mesh's shards,
  clone-padded up to the shard count, each shard folding its own cells
  with the local update built for its device (``matrix/program.py``
  ``fold_shards``); every cell's state stays on the lead device, and each
  cell's bits are the unsharded sweep's.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import time
import uuid
from typing import Any, Callable

import torch

from attackfl_tpu_torch.config import Config, parse_profile_rounds
from attackfl_tpu_torch.costmodel.capture import count_program, warm
from attackfl_tpu_torch.data.synthetic import get_dataset
from attackfl_tpu_torch.device import resolve_device
from attackfl_tpu_torch.eval.validation import Validation
from attackfl_tpu_torch.ledger.record import git_revision
from attackfl_tpu_torch.ledger.store import LedgerStore, resolve_ledger_dir
from attackfl_tpu_torch.matrix.grid import Cell, GridSpec, cell_config, expand_cells
from attackfl_tpu_torch.matrix.program import (
    CellProgram, build_cell_program, cells_per_part, padded_cells, sweep_round,
)
from attackfl_tpu_torch.matrix.records import cell_event_summaries, sweep_records
from attackfl_tpu_torch.ops import build
from attackfl_tpu_torch.ops import pytree as pt
from attackfl_tpu_torch.parallel.mesh import (
    ClientMesh, build_per_device, canonical, make_client_mesh,
)
from attackfl_tpu_torch.profiler.capture import HotspotCapture
from attackfl_tpu_torch.registry import get_model
from attackfl_tpu_torch.telemetry.console import print_with_color
from attackfl_tpu_torch.telemetry.core import Telemetry
from attackfl_tpu_torch.telemetry.numerics import NumericsDrainer
from attackfl_tpu_torch.training.engine import Simulator, check_slice
from attackfl_tpu_torch.training.local import INPUTS
from attackfl_tpu_torch.training.round import build_client_update, build_defense_branches
from attackfl_tpu_torch.utils import checkpoint as ckpt
from attackfl_tpu_torch.utils.fingerprint import config_fingerprint

MAX_CELL_RETRIES = 20  # per-cell consecutive-failure abort, like run_fast

MATRIX_STATE_FILE = "matrix.pth"


class _CellTelemetry:
    """Per-cell facade over the sweep telemetry: every emitted event is
    stamped with the cell key (the numerics drainers emit through this,
    so their ``metric`` events are per-cell attributable)."""

    def __init__(self, telemetry, cell_key: str):
        self._tel = telemetry
        self.counters = telemetry.counters
        self.events = self
        self._cell = cell_key

    def emit(self, kind: str, **fields: Any):
        return self._tel.events.emit(kind, cell=self._cell, **fields)


class MatrixRun:
    """One sweep: a base workload Config and a GridSpec, on ``device``, its
    cell axis over a client mesh with ``use_mesh`` (from
    ``tpu.num-devices``) or ``mesh`` (its lead device ``device``)."""

    def __init__(self, cfg: Config, grid: GridSpec, sweep_id: str | None = None,
                 telemetry: Telemetry | None = None, use_mesh: bool = False,
                 device: str | torch.device = "cuda", mesh: ClientMesh | None = None):
        grid.validate_base(cfg)
        check_slice(cfg)
        self.cfg = cfg
        self.grid = grid
        self.device = resolve_device(device)
        self.mesh = mesh
        if use_mesh and mesh is None:
            self.mesh = make_client_mesh(cfg.mesh.num_devices, cfg.mesh.axis_name,
                                         device=self.device)
        if self.mesh is not None and self.mesh.lead != canonical(self.device):
            raise ValueError(f"the mesh's lead device {self.mesh.lead} is not the sweep's "
                             f"device {self.device}")
        self.sweep_id = sweep_id or uuid.uuid4().hex[:12]
        self.cells = expand_cells(grid)
        self.device_cells = [c for c in self.cells if c.group in ("batched", "mapped")]
        self.fallback_cells = [c for c in self.cells if c.group in ("host", "special")]
        self.telemetry = telemetry if telemetry is not None else Telemetry.from_config(cfg)
        self.model = get_model(cfg.model)

        # the cells share one dataset: cell_config pins data_seed
        data_seed = cfg.data_seed if cfg.data_seed is not None else cfg.random_seed
        train_np = get_dataset(cfg.data_name, "train", cfg.train_size, data_seed)
        test_np = get_dataset(cfg.data_name, "test", cfg.test_size, data_seed)
        self.train_data = {k: torch.as_tensor(v, device=self.device)
                           for k, v in train_np.items()}
        self.test_data = {k: torch.as_tensor(v, device=self.device) for k, v in test_np.items()}
        pool_size = next(iter(train_np.values())).shape[0]
        num_params = sum(x.numel() for x in self.model.parameters())

        # ---- shared programs -------------------------------------------
        # one local update for every cell (the cells differ in attack,
        # defense and seed only), each defense's aggregate built once
        self.update = build_client_update(self.model, cfg, self.train_data)
        # under a mesh, one local update for each distinct device of it
        self.updates = None if self.mesh is None else build_per_device(
            self.mesh, lambda d: build_client_update(
                self.model, cfg, {k: v.to(d) for k, v in self.train_data.items()}),
            lead=self.update)
        defenses = tuple(dict.fromkeys(c.defense for c in self.device_cells))
        branches = dict(zip(defenses, build_defense_branches(self.model, cfg, self.test_data,
                                                             defenses)))
        self.validation = (Validation(self.model, cfg.data_name, test_np, self.device)
                           if cfg.validation else None)
        self._numerics_on = bool(self.telemetry.enabled and cfg.telemetry.numerics)
        window = cfg.telemetry.numerics_window if self._numerics_on else None
        self.programs: dict[str, CellProgram] = {
            c.key: build_cell_program(self.model, cfg, c, grid.rounds, self.train_data,
                                      pool_size, num_params, self.test_data["label"].shape[0],
                                      self.update, branches[c.defense], self.validation,
                                      self.device, window)
            for c in self.device_cells}
        # the fold's parts: every mask tensor of a step below K3's limit
        columns = [self.train_data[k] for k in INPUTS[cfg.data_name]]
        specs = self.model.mask_specs([(cfg.batch_size,) + tuple(x.shape[1:])
                                       for x in columns], self.model.dropout_rates)
        self.cells_per_part = cells_per_part(specs, cfg.total_clients)
        # the folded local updates dispatched: each launches K3 once a
        # minibatch step
        self.fold_calls = 0

        # ATTACKFL_COSTMODEL=0 = the harness kill switch (see the engine)
        self._costmodel_on = bool(self.telemetry.enabled and cfg.telemetry.costmodel
                                  and os.environ.get("ATTACKFL_COSTMODEL", "1") != "0")
        self._program_profiles: dict[str, dict[str, Any]] = {}
        if self._costmodel_on:
            warm()

        # ---- persistence ------------------------------------------------
        self._resumed = False
        # set by run(): True when a stop hook cut the sweep short
        self.interrupted = False
        # extra run_header fields a wrapping executor records (the run
        # service's worker stamps its scheduler provenance, schema v11)
        self.header_extra: dict[str, Any] = {}
        # which seam cut it short, when the stop hook returned a string
        self.stop_reason: str | None = None
        # quarantined cells: past the per-cell retry budget
        self._aborted: set[str] = set()
        os.makedirs(cfg.checkpoint_dir or ".", exist_ok=True)
        self._ckpt_manager = ckpt.CheckpointManager(
            os.path.join(cfg.checkpoint_dir or ".", MATRIX_STATE_FILE),
            fingerprint=self.sweep_fingerprint(), keep=cfg.checkpoint_keep,
            telemetry=self.telemetry, fresh=not cfg.resume)

        # ---- cross-run ledger (per-cell records) ------------------------
        self._ledger = None
        if self.telemetry.enabled and cfg.telemetry.ledger:
            self._ledger = LedgerStore(resolve_ledger_dir(cfg.telemetry.ledger_dir or None,
                                                          base=self.telemetry.base_dir))

        # per-cell numerics drainers, built at their first row
        self._drainers: dict[str, NumericsDrainer] = {}
        # the device cells' states after run(), by cell key
        self.state: dict[str, dict[str, Any]] = {}

        # the sweep's profiling window, at the chunk seam
        self._hotspots = HotspotCapture(
            self.telemetry,
            parse_profile_rounds(cfg.telemetry.hotspots or cfg.telemetry.profile_rounds),
            device=self.device.type)

    # ------------------------------------------------------------------
    # identity
    # ------------------------------------------------------------------

    def sweep_fingerprint(self) -> str:
        """Checkpoint/resume identity: the base config fingerprint plus
        the grid geometry (a resumed sweep must be the SAME sweep)."""
        blob = config_fingerprint(self.cfg) + "|" + repr(self.grid.describe())
        return "matrix-" + hashlib.sha256(blob.encode()).hexdigest()[:12]

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------

    def _cell_state(self, cell: Cell) -> dict[str, Any]:
        """One device cell's fresh state as its fused run carries it:
        ``Simulator.init_state`` for the cell's config (params from a CPU
        generator at the cell's seed, the round generator on the card),
        the completed-round count and the leak flag as device tensors,
        the broadcast clock a host int, and the consecutive failures."""
        seed = cell.seed
        prog = self.programs[cell.key]
        params = self.model.init(torch.Generator().manual_seed(seed), self.device)
        state = {
            "global_params": params,
            "prev_genuine": pt.tree_map(
                lambda x: torch.zeros((prog.num_genuine,) + tuple(x.shape), dtype=x.dtype,
                                      device=x.device), params),
            "have_genuine": torch.full((), False, dtype=torch.bool, device=self.device),
            "rng": torch.Generator(device=self.device).manual_seed(seed),
            "completed_rounds": torch.full((), 0, dtype=torch.int64, device=self.device),
            "broadcasts": 0,
            "failures": 0,
        }
        if prog.numerics is not None:
            state["numerics"] = prog.numerics.init_state()
        return state

    def init_state(self) -> dict[str, dict[str, Any]]:
        """The grid state: every device cell's fresh state, by cell key."""
        return {c.key: self._cell_state(c) for c in self.device_cells}

    def audit_programs(self, state: dict[str, dict[str, Any]] | None = None
                       ) -> list[dict[str, Any]]:
        """The sweep's program for the program audit, in
        ``Simulator.audit_programs``'s form (JAX ``MatrixRun.audit_programs``,
        matrix_exec.py:519-541): one sweep round of every device cell
        (:meth:`_chunk` of 1, dispatched as ``matrix_chunk[1]``), from
        ``state`` (default: a fresh grid) at the broadcast where every
        attack fires, its leak pool present.  It consumes nothing."""
        state = state if state is not None else self.init_state()
        cells = list(self.device_cells)
        b = max([a.attack_round for a in self.grid.attacks] or [1])
        states = [dict(state[c.key], broadcasts=b - 1, have_genuine=torch.full(
            (), True, dtype=torch.bool, device=self.device)) for c in cells]
        return [dict(name=f"matrix_step[{len(cells)} cells]", executor="matrix",
                     fn=lambda states: self._chunk(cells, states, 1), args=(states,),
                     donate=())]

    @staticmethod
    def host_state(state: dict[str, dict[str, Any]]) -> dict[str, dict[str, Any]]:
        """The grid state as a checkpoint holds it: per cell the
        generator as its ``get_state()``, the counts and the leak flag as
        host values, no numerics ring (observability state, never
        checkpointed)."""
        out = {}
        for key, sub in state.items():
            host = {k: v for k, v in sub.items() if k != "numerics"}
            host["rng"] = sub["rng"].get_state()
            host["completed_rounds"] = int(sub["completed_rounds"])
            host["have_genuine"] = bool(sub["have_genuine"])
            out[key] = host
        return out

    def restore_state(self, host: dict[str, dict[str, Any]]) -> dict[str, dict[str, Any]]:
        """The inverse of :meth:`host_state`, on the sweep's device, with
        a fresh numerics ring where numerics are on."""
        out = {}
        for key, sub in host.items():
            state = {k: (pt.tree_map(lambda x: x.to(self.device), v) if isinstance(v, dict)
                         else v) for k, v in sub.items()}
            state["rng"] = torch.Generator(device=self.device)
            state["rng"].set_state(sub["rng"].cpu())
            state["completed_rounds"] = torch.full((), int(sub["completed_rounds"]),
                                                   dtype=torch.int64, device=self.device)
            state["have_genuine"] = torch.full((), bool(sub["have_genuine"]),
                                               dtype=torch.bool, device=self.device)
            numerics = self.programs[key].numerics
            if numerics is not None:
                state["numerics"] = numerics.init_state()
            out[key] = state
        return out

    def load_or_init_state(self) -> dict[str, dict[str, Any]]:
        """Fresh grid state, or, under ``cfg.resume``, the newest valid
        checkpoint entry (torn entries fall back, the engine's resume
        semantics)."""
        if not self.cfg.resume:
            return self.init_state()
        result = self._ckpt_manager.load_latest(self.host_state(self.init_state()))
        if result.state is None:
            print_with_color("[matrix] no valid sweep checkpoint; starting fresh", "yellow")
            return self.init_state()
        for entry, reason in result.rejected:
            self.telemetry.counters.inc("checkpoint_fallbacks")
            print_with_color(f"[matrix] rejected checkpoint {entry.get('file')}: "
                             f"{reason[:120]}", "yellow")
        self._resumed = True
        self._aborted = {key for key, sub in result.state.items()
                         if sub["failures"] > MAX_CELL_RETRIES}
        self.telemetry.events.emit(
            "matrix", sweep_id=self.sweep_id, action="resumed",
            round=int(result.entry.get("round", 0)) if result.entry else 0)
        return self.restore_state(result.state)

    # ------------------------------------------------------------------
    # run
    # ------------------------------------------------------------------

    def _emit_header(self) -> None:
        tel = self.telemetry
        if not tel.enabled:
            return
        backend = "gpu" if self.device.type == "cuda" else "cpu"
        tel.events.emit(
            "run_header", backend=backend,
            num_devices=torch.cuda.device_count() if self.device.type == "cuda" else 1,
            mesh_devices=self.mesh.size if self.mesh is not None else 0, mode="matrix",
            model=self.cfg.model, data_name=self.cfg.data_name,
            total_clients=self.cfg.total_clients, torch_version=torch.__version__,
            platform=backend, git_rev=git_revision(), sweep_id=self.sweep_id,
            grid=self.grid.describe(), config=dataclasses.asdict(self.cfg),
            **self.header_extra)

    def _live(self, done: dict[str, int]) -> list[Cell]:
        """The device cells still running: below the round target and
        not quarantined, in grid order."""
        return [c for c in self.device_cells
                if done[c.key] < self.grid.rounds and c.key not in self._aborted]

    def _min_completed(self, done: dict[str, int]) -> int:
        """The sweep's progress: the fewest completed rounds over the
        device cells that are not quarantined."""
        values = [v for key, v in done.items() if key not in self._aborted]
        return min(values) if values else self.grid.rounds

    def _chunk(self, cells: list[Cell], states: list[dict[str, Any]], n: int):
        """``n`` sweep rounds of ``cells`` from ``states``: the new states
        and each cell's metrics, each a ``(n,)`` device tensor."""
        programs = [self.programs[c.key] for c in cells]
        rows: list[list[dict[str, Any]]] = [[] for _ in cells]
        for _ in range(n):
            results = sweep_round(programs, states, self.update, self.cfg.total_clients,
                                  self.cells_per_part, mesh=self.mesh, updates=self.updates)
            states = [new for new, _ in results]
            for row, (_, metrics) in zip(rows, results):
                row.append(metrics)
        return states, [{k: torch.stack([r[k] for r in row]) for k in sorted(row[0])}
                        for row in rows]

    def _dispatch_chunk(self, cells: list[Cell], states: list[dict[str, Any]], n: int):
        """:meth:`_chunk` as the program ``matrix_chunk[n]``: under its
        ``record_function`` label and, on its first dispatch with the
        cost model on, counted into a ``program_profile`` event with
        ``rounds_per_dispatch`` and ``cells`` (JAX matrix_exec.py:477-516)."""
        label = f"matrix_chunk[{n}]"
        if self.mesh is None:
            parts = -(-len(cells) // self.cells_per_part)
        else:
            per_shard = padded_cells(len(cells), self.mesh) // self.mesh.size
            parts = self.mesh.size * -(-per_shard // self.cells_per_part)
        self.fold_calls += n * parts
        with torch.profiler.record_function(label):
            if not self._costmodel_on or label in self._program_profiles:
                return self._chunk(cells, states, n)
            result, counted = count_program(self._chunk, cells, states, n, device=self.device)
        self.telemetry.tracer.discount("costmodel", counted["overhead_s"], program=label,
                                       ops=counted["ops"])
        profile = {k: counted[k] for k in ("flops", "transcendentals", "bytes_accessed",
                                          "memory") if k in counted}
        profile["rounds_per_dispatch"] = int(n)
        profile["cells"] = len(self.device_cells)
        profile["device_kind"] = (torch.cuda.get_device_name(self.device)
                                  if self.device.type == "cuda" else "cpu")
        self._program_profiles[label] = profile
        self.telemetry.events.emit("program_profile", program=label,
                                   fingerprint=self.sweep_fingerprint(), **profile)
        return result

    def _resolve_chunk(self, cells: list[Cell], states: list[dict[str, Any]],
                       metrics: list[dict[str, torch.Tensor]],
                       histories: dict[str, list[dict[str, Any]]]) -> list[int]:
        """THE sweep's one read of the card a chunk: every cell's metrics
        for every round of the chunk (the numerics rows among them), its
        completed-round count and its leak flag, in one float64 copy to
        the host.  Each cell's state keeps those two as device tensors;
        the history entries and the consecutive failures are filled
        here.  Returns each cell's completed rounds."""
        parts = []
        for state, rows in zip(states, metrics):
            parts += [rows[k].to(torch.float64).reshape(-1) for k in rows]
            parts.append(torch.stack([state["completed_rounds"].to(torch.float64),
                                      state["have_genuine"].to(torch.float64)]))
        values = torch.cat(parts).cpu().numpy()
        at, done = 0, []
        for cell, state, rows in zip(cells, states, metrics):
            host = {}
            for k, v in rows.items():
                host[k] = values[at:at + v.numel()].reshape(tuple(v.shape))
                at += v.numel()
            done.append(int(values[at]))
            at += 2
            numerics_rows = host.pop("numerics_row", None)
            history = histories.setdefault(cell.key, [])
            for i in range(len(host["ok"])):
                entry = {k: (bool(v[i]) if k == "ok" else float(v[i])) for k, v in host.items()}
                entry["round"] = len(history) + 1
                entry["cell"] = cell.key
                history.append(entry)
                if entry["ok"]:
                    state["failures"] = 0
                else:
                    state["failures"] += 1
                    self.telemetry.counters.inc("rounds_failed")
                if numerics_rows is not None:
                    broadcast = state["broadcasts"] - len(host["ok"]) + i + 1
                    self._drainer_for(cell).push_host_row(entry["round"], broadcast,
                                                          numerics_rows[i])
        return done

    def _run_chunk(self, cells: list[Cell], states: list[dict[str, Any]], n: int,
                   histories: dict[str, list[dict[str, Any]]]
                   ) -> tuple[list[dict[str, Any]], list[int]]:
        """One chunk of ``cells``: its dispatch and its one read; the new
        states and each cell's completed rounds."""
        states, metrics = self._dispatch_chunk(cells, states, n)
        return states, self._resolve_chunk(cells, states, metrics, histories)

    def _drainer_for(self, cell: Cell) -> NumericsDrainer:
        drainer = self._drainers.get(cell.key)
        if drainer is None:
            drainer = NumericsDrainer(self.programs[cell.key].numerics.layout,
                                      _CellTelemetry(self.telemetry, cell.key),
                                      self.cfg.telemetry.numerics_window)
            self._drainers[cell.key] = drainer
        return drainer

    def _save_checkpoint(self, state: dict[str, dict[str, Any]], completed: int) -> None:
        self._ckpt_manager.write(self.host_state(state),
                                 {"round": completed, "broadcast": completed})

    def run(self, stop: Callable[[int], Any] | None = None, save_checkpoints: bool = True,
            verbose: bool = True
            ) -> tuple[dict[str, Any], dict[str, list[dict[str, Any]]]]:
        """Run the sweep to completion (or a graceful ``stop``).

        Returns ``(final_params, histories)``: per cell key, the final
        global params (a hyper cell's hypernetwork) and the per-round
        history.  ``stop`` is consulted between chunks and between
        fallback cells, and passed to the fallback cells' runs.  The
        final grid state is kept as :attr:`state`."""
        tel = self.telemetry
        t_start = time.perf_counter()
        self._emit_header()
        tel.events.emit("matrix", sweep_id=self.sweep_id, action="started",
                        grid=self.grid.describe(), device_cells=len(self.device_cells),
                        fallback_cells=len(self.fallback_cells), resumed=self._resumed)
        state = self.load_or_init_state()
        done = {key: int(sub["completed_rounds"]) for key, sub in state.items()}
        histories: dict[str, list[dict[str, Any]]] = {}
        interrupted = False
        completed = self._min_completed(done) if self.device_cells else 0
        final_params: dict[str, Any] = {}
        try:
            while True:
                live = self._live(done)
                if not live:
                    break
                if self._consult_stop(stop, completed):
                    interrupted = True
                    break
                n = min(self.grid.chunk, min(self.grid.rounds - done[c.key] for c in live))
                libraries = build.load_library.cache_info().currsize
                profiles = len(self._program_profiles)
                t0 = time.perf_counter()
                self._hotspots.maybe_start(completed + 1, completed + n, program="matrix")
                with tel.tracer.span("chunk", chunk_len=n, matrix=True):
                    states, counts = self._run_chunk(live, [state[c.key] for c in live], n,
                                                     histories)
                elapsed = time.perf_counter() - t0
                for cell, new, count in zip(live, states, counts):
                    state[cell.key], done[cell.key] = new, count
                completed = self._min_completed(done)
                self._hotspots.maybe_stop(completed)
                tel.events.emit(
                    "matrix", sweep_id=self.sweep_id, action="chunk", chunk_len=n,
                    seconds=round(elapsed, 6),
                    includes_compile=build.load_library.cache_info().currsize > libraries
                    or len(self._program_profiles) > profiles,
                    min_completed=completed)
                for cell in live:
                    failures = state[cell.key]["failures"]
                    if failures > MAX_CELL_RETRIES and cell.key not in self._aborted:
                        # quarantine, don't kill: the standalone run would
                        # abort HERE (run_fast's retry cap)
                        self._aborted.add(cell.key)
                        tel.counters.inc("matrix_cells_aborted")
                        tel.events.emit("matrix", sweep_id=self.sweep_id,
                                        action="cell_aborted", cell=cell.key,
                                        consecutive_failures=failures)
                        print_with_color(
                            f"[matrix] cell {cell.key} failed {failures} rounds in a row — "
                            "quarantined (the standalone run would abort here); the sweep "
                            "continues", "red")
                completed = self._min_completed(done)
                if save_checkpoints:
                    self._save_checkpoint(state, completed)
                if verbose:
                    print_with_color(
                        f"[matrix] {completed}/{self.grid.rounds} rounds x "
                        f"{len(self.device_cells)} device cells, chunk of {n} "
                        f"({len(live)} cells) in {elapsed:.2f}s", "green")
            self.state = state
            final_params = {key: sub["global_params"] for key, sub in state.items()}
            if not interrupted:
                interrupted = self._run_fallback_cells(final_params, histories, stop)
        finally:
            self.interrupted = interrupted
            self._finish(histories, t_start, interrupted)
        return final_params, histories

    # ------------------------------------------------------------------
    # fallback cells (host defenses / hyper)
    # ------------------------------------------------------------------

    def _cell_dir(self, cell: Cell) -> str:
        return os.path.join(self.cfg.checkpoint_dir or ".", "cells", cell.key)

    def _fallback_config(self, cell: Cell) -> Config:
        cell_dir = self._cell_dir(cell)
        telemetry = dataclasses.replace(
            self.cfg.telemetry,
            events_path=os.path.join(cell_dir, "events.jsonl"),
            trace_path=os.path.join(cell_dir, "trace.json"),
            monitor=False,
            # one ledger record per cell comes from the SWEEP's
            # distillation: the child must not append its own
            ledger=False)
        return cell_config(self.cfg, cell, rounds=self.grid.rounds, log_path=cell_dir,
                           checkpoint_dir=cell_dir, telemetry=telemetry,
                           resume=self._resumed)

    def _run_fallback_cells(self, final_params: dict[str, Any],
                            histories: dict[str, list[dict[str, Any]]],
                            stop: Callable[[int], Any] | None) -> bool:
        """Per-cell fallback runs.  Returns True when stopped early."""
        for cell in self.fallback_cells:
            if self._consult_stop(stop, self.grid.rounds):
                return True
            os.makedirs(self._cell_dir(cell), exist_ok=True)
            if cell.group == "host":
                print_with_color(
                    f"[matrix] defense '{cell.defense}' filters on host — cell {cell.key} "
                    "falls back to a per-cell synchronous run", "yellow")
            self.telemetry.events.emit("matrix", sweep_id=self.sweep_id, action="fallback",
                                       cell=cell.key, group=cell.group)
            sim = Simulator(self._fallback_config(cell), device=self.device)
            sim.header_extra = {"sweep_id": self.sweep_id, "cell": cell.key,
                                **self.header_extra}
            try:
                if sim.supports_fused():
                    # per-cell specialization: the cell's own fused path
                    # (hyper without detection)
                    state, history = sim.run_fast(verbose=False, stop=stop)
                else:
                    state, history = sim.run(verbose=False, stop=stop)
            finally:
                sim.close()
            final_params[cell.key] = state.get("hnet_params", state.get("global_params"))
            for entry in history:
                entry["cell"] = cell.key
            histories[cell.key] = history
            self.telemetry.events.emit("matrix", sweep_id=self.sweep_id, action="cell_done",
                                       cell=cell.key, rounds=len(history),
                                       ok_rounds=sum(1 for h in history if h.get("ok")))
            if int(state["completed_rounds"]) < self.grid.rounds:
                # the stop hook cut this cell short mid-run; re-consult it
                # for the reason (the hook is a level check)
                self._consult_stop(stop, int(state["completed_rounds"]))
                return True
        return False

    # ------------------------------------------------------------------
    # terminal work
    # ------------------------------------------------------------------

    def _consult_stop(self, stop, completed) -> bool:
        """One stop-hook consultation (the engine's rule): a truthy
        verdict stops the sweep at this chunk or cell boundary, and a
        string verdict is kept as :attr:`stop_reason`."""
        if stop is None:
            return False
        verdict = stop(int(completed))
        if not verdict:
            return False
        self.stop_reason = verdict if isinstance(verdict, str) else "stopped"
        return True

    def _finish(self, histories: dict[str, list[dict[str, Any]]], t_start: float,
                interrupted: bool) -> None:
        tel = self.telemetry
        wall = time.perf_counter() - t_start
        self._hotspots.maybe_stop(force=True)
        records = self._distill_records(histories, wall)
        self._append_ledger_records(records)
        if tel.enabled:
            tel.events.emit(
                "matrix", sweep_id=self.sweep_id,
                action="interrupted" if interrupted else "completed",
                cells_done=len(histories), seconds=round(wall, 6),
                **({"stop_reason": self.stop_reason}
                   if interrupted and self.stop_reason else {}))
            self._emit_science(records)
            tel.events.emit("counters", counters=tel.counters.snapshot())
            total = sum(len(h) for h in histories.values())
            tel.events.emit("run_end", rounds=total,
                            ok_rounds=sum(1 for h in histories.values()
                                          for e in h if e.get("ok")),
                            seconds=round(wall, 6))
            tel.flush()

    def _mine_cell_summaries(self) -> dict[str, dict[str, Any]]:
        """Per-cell forensics and numerics blocks mined from the sweep's
        telemetry: device cells' drainer events sit cell-stamped in the
        sweep's spool; each fallback cell ran against its own spool under
        ``cells/<key>/``, whose events are stamped here at read time."""
        from attackfl_tpu_torch.telemetry.summary import load_events

        events: list[dict[str, Any]] = []
        spool = self.telemetry.events.path
        if spool and os.path.exists(spool):
            self.telemetry.events.flush()
            events.extend(load_events(spool))
        for cell in self.fallback_cells:
            path = os.path.join(self._cell_dir(cell), "events.jsonl")
            if not os.path.exists(path):
                continue
            for event in load_events(path):
                event.setdefault("cell", cell.key)
                events.append(event)
        return cell_event_summaries(events)

    def _distill_records(self, histories: dict[str, list[dict[str, Any]]],
                         wall: float) -> list[dict[str, Any]]:
        """The sweep's per-cell ledger records (also the science event's
        input).  Fail-open: distillation is observability."""
        if not histories:
            return []
        try:
            backend = "gpu" if self.device.type == "cuda" else "cpu"
            return sweep_records(
                sweep_id=self.sweep_id, cells=self.cells, histories=histories,
                base_cfg=self.cfg, rounds=self.grid.rounds,
                run_id=self.telemetry.events.run_id, ts=time.time(), wall_s=wall,
                resumed=self._resumed,
                provenance={"torch_version": torch.__version__, "backend": backend,
                            "mesh_devices": self.mesh.size if self.mesh is not None else 0},
                programs=dict(self._program_profiles) or None,
                event_summaries=self._mine_cell_summaries())
        except Exception as e:  # noqa: BLE001 — observability, fail open
            self.telemetry.counters.inc("ledger_append_failures")
            print_with_color(f"[matrix] record distillation failed (sweep unaffected): "
                             f"{type(e).__name__}: {e}", "yellow")
            return []

    def _append_ledger_records(self, records: list[dict[str, Any]]) -> None:
        if self._ledger is None or not records:
            return
        try:
            for record in records:
                self._ledger.append(record)
            self.telemetry.counters.inc("ledger_records_appended", len(records))
        except Exception as e:  # noqa: BLE001 — observability, fail open
            self.telemetry.counters.inc("ledger_append_failures")
            print_with_color(f"[matrix] ledger append failed (sweep unaffected): "
                             f"{type(e).__name__}: {e}", "yellow")

    def _emit_science(self, records: list[dict[str, Any]]) -> None:
        """The sweep-level ``science`` event (schema v13): the defense
        leaderboard, stamped into the spool so the ranking travels with
        the sweep's artifacts.  Fail-open: ranking never fails the
        sweep."""
        try:
            from attackfl_tpu_torch.science.outcomes import BASELINE_ATTACK, outcome_rows
            from attackfl_tpu_torch.science.rank import leaderboard

            rows = outcome_rows(records, sweep_id=self.sweep_id)
            if not rows:
                return
            board = leaderboard(rows, sweep_id=self.sweep_id, n_boot=200)
            fields: dict[str, Any] = {
                "cells": board["cells"], "attacks": board["attacks"],
                "defenses": board["defenses"], "seeds": board["seeds"],
                "baseline": BASELINE_ATTACK,
                "leaderboard": [
                    {"defense": e["defense"], "rank": e["rank"],
                     "damage_mean": e["damage_mean"], "damage_worst": e["damage_worst"],
                     "quality_mean": e["quality_mean"], "seed_spread": e["seed_spread"]}
                    for e in board["leaderboard"]],
            }
            if board.get("quality_key"):
                fields["quality_key"] = board["quality_key"]
            self.telemetry.events.emit("science", sweep_id=self.sweep_id, **fields)
        except Exception as e:  # noqa: BLE001 — observability, fail open
            self.telemetry.counters.inc("science_emit_failures")
            print_with_color(f"[matrix] science summary failed (sweep unaffected): "
                             f"{type(e).__name__}: {e}", "yellow")

    def close(self) -> None:
        self.telemetry.close()
