"""The Simulator: the in-process federation engine (the port's
``attackfl_tpu/training/engine.py``, synchronous executor).

One Python loop around the round program: sample -> train -> attack ->
defend and aggregate -> validate -> accept or retry.  A failed round
(client NaN, no client left after the defense, or failed validation) is
retried without decrementing the remaining-round counter (reference
server.py:546-563), at most ``MAX_ROUND_RETRIES`` times in a row; the
attack clock advances per broadcast (the client-side counter,
RpcClient.py:72).

The port draws its randomness from ``torch.Generator``s: model init from
a CPU generator seeded with ``random_seed`` (so CPU and GPU runs start
from the same weights), round draws from a generator on the run's device.

Over a client mesh of one process (``use_mesh`` or ``mesh``, a
``parallel.mesh.ClientMesh``; JAX engine.py:202-273) every executor trains
each shard's block of clients on its device and, under the ``shard_map``
strategy, aggregates by the per-defense collectives
(``parallel/shard.py``); the run's state, the draws, the attacks and the
validation stay on the mesh's lead device.  JAX's rule picks or refuses
the strategy, and a client count that does not divide falls back to no
mesh.  ``run`` builds ``Simulator(cfg, use_mesh=True)``: on one card a
one-device mesh, whose local update is the meshless call.

``run`` saves a checkpoint after every ok round by default (reference
server.py:549-553) through ``utils/checkpoint.CheckpointManager``:
``{model}.pth``, round-stamped entries and ``manifest.json`` under
``checkpoint_dir``.  ``resume`` continues from the newest valid entry,
``load_parameters`` from the ``{model}.pth`` alias.

The gmm and fltracer defenses filter on the host, as in the JAX engine
(``_run_plain_round``, ``attackfl_tpu/training/engine.py:1551-1612``): one
device-to-host copy of the flat client matrix a round, then numpy
(``ops/defenses.py``).

Hyper mode (``_run_hyper_round``, JAX engine.py:1673-1800) trains a
hypernetwork in place of aggregating: generate every client's params,
train them, attack, then one hypernetwork update (``training/hyper.py``);
with ``hyper_detection`` the embedding detector may remove clients and
roll the round's update back; validation pools the active clients'
generated models.

A fault plan (``cfg.faults``) builds a host-side injector that the
checkpoint manager consults and that records each broadcast's device-side
injections once the round resolves (JAX engine.py:565-573,1431-1439).
``checkpoint_async`` saves through a supervised background writer: the
copy to the host stays on the round loop, the serialization and the
write move to its thread (JAX engine.py:600-607,1441-1480).
``validation_async`` starts each validation without a sync and folds
its metrics and ``validation_ok`` into the round's history entry when it
resolves, at the start of the next round or at the end of the run; the
verdict never gates the round (JAX engine.py:1358-1373,1628-1635).
Every exit of :meth:`Simulator.run`, a crashing round included, resolves
the validations in flight and drains the writer (``_finish_run``).

``{log_path}/app.log`` is the reference's file log (``telemetry.Logger``,
src/Log.py): ``run`` writes ``### Application start ###`` and each failed
round's ``Round N failed (retry k)``, and each synchronous validation
writes its metrics line (JAX engine.py:163,2689,2726).

The fused multi-round path (:meth:`Simulator.run_fast` over
:meth:`Simulator.run_scan`, JAX engine.py:1812-2248) runs a chunk of
broadcasts as device-side steps over the state: ``ok``, the metrics, the
leak flag and the completed-round count stay device tensors through the
chunk, a failed round keeps the old params by ``torch.where`` (the
aggregate and the hypernetwork update are computed on every broadcast),
validation is inlined and gates the round, and the host reads each
chunk's outcome once.  On config 4's path (fedavg with LIE under either
backend) a chunk makes no other read of the card.

The depth-k pipelined executor (``run(pipeline=True)``,
:meth:`Simulator._run_pipelined`, JAX engine.py:2254-2628) dispatches
every round as one call of the same fused body and resolves each round up
to k rounds later, in dispatch order: a round's metrics are copied into
pinned host memory behind a CUDA event when it is dispatched, and the
resolve waits on that event alone, never on the rounds queued after it.
Acceptance is the body's ``torch.where``, so a rollback anywhere in the
queue needs no re-dispatch and the final state is ``run``'s bit for bit
at every depth.  After ``pipeline_demote_after`` consecutive rollbacks it
resolves each round before the next dispatch (depth 0), and returns to
the configured depth after ``pipeline_repromote_after`` clean rounds.

Every executor takes a ``stop`` hook (``run``, ``run_fast``,
``_run_pipelined``): called with the completed-round count between
rounds (between chunks under ``run_fast``, before each dispatch in the
pipeline), a truthy verdict ends the run at that boundary, the rounds in
flight still resolving and checkpointing, and a string verdict is kept
as ``_stop_reason``.

Telemetry (JAX engine.py:1066-1356): with ``telemetry.enabled``, the
default, every executor writes the JAX package's event stream to
``{log_path}/events.jsonl`` (``ATTACKFL_TELEMETRY_DIR`` overrides the
directory), its host spans to ``trace.json``, and one record a run to the
cross-run ledger (``{log_path}/ledger``), which ``pipeline_depth: auto``
reads.  Only values the host already holds are recorded: a synchronous
round's phases end in a sync only where JAX's block (``aggregate``,
``hyper_update``), and the fused and pipelined paths read nothing more.
A round's ``attacks_active`` and ``phases`` are in its history entry
whatever the setting, as in JAX.

Hotspot windows and the cost model (JAX engine.py:316-359, 776-857):
``telemetry.hotspots: A:B`` (or ``profile_rounds``) opens one
``torch.profiler`` window over those rounds at the executor's dispatch
seam (``profiler/capture.py``), which writes a ``*.trace.json.gz`` and a
``hotspot`` event.  Each dispatch runs under a ``record_function`` label
named as JAX's programs (``round_step``, ``aggregate``, ``hyper_update``,
``fused_scan[n]``, ``pipeline_step[eval=...]``), which the miner reads as
the rows' program.  With ``telemetry.costmodel``, the default, each
program is counted on its first dispatch in a Simulator
(``costmodel/capture.py``; the counter's own bookkeeping kept out of the
round's spans) and written as a
``program_profile`` event; ``ATTACKFL_COSTMODEL=0`` switches it off, as in
JAX.  Neither changes the params.

With ``telemetry.numerics`` every executor computes the JAX package's
numerics row on the card each round (``ops/metrics.py``, a ``numerics``
phase on the synchronous path, inside the body on the fused and
pipelined ones) and writes it into a ring carried in the state; the
drainer (``telemetry/numerics.py``) turns the rows into ``metric`` events
late, on the paths' existing reads or one ring copy every
``numerics_window`` synchronous rounds (JAX engine.py:483-534).  With
``telemetry.monitor`` the run serves ``/healthz``, ``/metrics`` and
``/last-round`` and its watchdog writes a ``stall`` event when no round
completes in time (``telemetry/monitor.py``, JAX engine.py:333-348).
Neither changes the params.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
import statistics
import time
from collections import deque
from typing import Any, Callable

import numpy as np
import torch

from attackfl_tpu_torch import device as devices
from attackfl_tpu_torch.config import Config, parse_profile_rounds
from attackfl_tpu_torch.costmodel.capture import count_program, warm
from attackfl_tpu_torch.data.partition import dirichlet_label_partition
from attackfl_tpu_torch.data.synthetic import get_dataset
from attackfl_tpu_torch.device import resolve_device
from attackfl_tpu_torch.eval.validation import METRIC_KEYS, Validation
from attackfl_tpu_torch.faults.inject import HostFaultInjector
from attackfl_tpu_torch.ledger.record import derive_record, git_revision
from attackfl_tpu_torch.ledger.store import LedgerStore, resolve_ledger_dir
from attackfl_tpu_torch.models.hyper import make_hypernetwork
from attackfl_tpu_torch.ops import build, defenses, fused_step
from attackfl_tpu_torch.ops import pytree as pt
from attackfl_tpu_torch.ops.metrics import Numerics, build_layout
from attackfl_tpu_torch.parallel.mesh import ClientMesh, canonical, make_client_mesh
from attackfl_tpu_torch.parallel.shard import supports_shard_map
from attackfl_tpu_torch.profiler.capture import HotspotCapture
from attackfl_tpu_torch.registry import get_model
from attackfl_tpu_torch.telemetry.console import Logger, print_with_color
from attackfl_tpu_torch.telemetry.core import Telemetry
from attackfl_tpu_torch.telemetry.monitor import RunMonitor
from attackfl_tpu_torch.telemetry.numerics import NumericsDrainer
from attackfl_tpu_torch.telemetry.timing import RoundTimer
from attackfl_tpu_torch.training.hyper import build_hyper_round, build_hyper_update
from attackfl_tpu_torch.training.round import (
    active_attack_modes, active_attacker_indices, build_aggregator, build_attack_groups,
    build_attribution_fn, build_round_step, describe_attack_groups, leak_size, round_drawer,
)
from attackfl_tpu_torch.utils import checkpoint as ckpt
from attackfl_tpu_torch.utils.fingerprint import config_fingerprint

MAX_ROUND_RETRIES = 20
# run_fast's chunk length when none is given (JAX engine.py:75)
DEFAULT_SCAN_CHUNK = 16
# the ceiling of `pipeline_depth: auto` (JAX engine.py:76-79)
AUTO_DEPTH_CAP = 8
log = logging.getLogger("attackfl_tpu_torch")


def auto_depth_from_records(records, fingerprint: str, window: int = 5
                            ) -> tuple[int | None, dict[str, Any]]:
    """The pipeline depth the ledger's measurements propose, before the
    clamps (JAX ``auto_depth_from_records``, engine.py:82-134).

    Each record of this config's fingerprint gives ``round_device_time``
    D (device seconds a round) and ``host_resolution_latency`` H (host
    seconds a round spent resolving), H plus the record's foreground
    checkpoint seconds a round (``time_attribution.checkpoint_s`` over
    ``rounds``).  Over the medians of the newest ``window`` such records
    the pick is ``k = ceil(H / D)``, at least 1.  Returns ``(k, info)``,
    ``(None, {"reason": "no_ledger_peers"})`` when no record carries the
    inputs."""
    peers: list[tuple[float, float]] = []

    def number(value) -> float | None:
        if isinstance(value, (int, float)) and not isinstance(value, bool):
            return value + 0.0
        return None

    for record in records:
        if record.get("fingerprint") != fingerprint:
            continue
        device = number(record.get("round_device_time"))
        host = number(record.get("host_resolution_latency"))
        if device is None or device <= 0 or host is None or host < 0:
            continue
        rounds = number(record.get("rounds"))
        ckpt_fg = number((record.get("time_attribution") or {}).get("checkpoint_s"))
        if ckpt_fg is not None and rounds and rounds > 0:
            host += ckpt_fg / rounds
        peers.append((device, host))
    if not peers:
        return None, {"reason": "no_ledger_peers"}
    peers = peers[-window:]
    device = statistics.median([d for d, _ in peers])
    host = statistics.median([h for _, h in peers])
    ratio = host / device
    return max(1, math.ceil(ratio)), {
        "round_device_time": round(device, 6),
        "host_latency_per_round": round(host, 6),
        "ratio": round(ratio, 4),
        "peers": len(peers),
    }


# What each round program consumes: the positions of the arguments it may
# write in place (the JAX package donates them to XLA, JAX engine.py:614-636).
# None: every program of the port leaves its inputs as they were, which
# run_scan's contract, the pipeline's kept slot state and the synchronous
# retry rely on.  analysis/program_audit checks it; the donation-after-use
# rule reads this literal.
DONATION_SPEC: dict[str, tuple[int, ...]] = {
    "round_step": (), "aggregate": (), "generate_all": (), "hyper_update": (),
    "fused_chunk": (), "pipeline_step": ()}


def _refuse(what: str, item: str) -> None:
    raise NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md queue 1, {item})")


# the models of the slice, each on its dataset
MODEL_DATA = {"CNNModel": "ICU", "RNNModel": "ICU", "TransformerModel": "ICU",
              "TransformerClassifier": "HAR", "ResNet18": "CIFAR10"}


def check_slice(cfg: Config) -> None:
    """Refuse what the port cannot run yet, naming the ROADMAP item that
    will port it.  The slice: CNNModel, RNNModel and TransformerModel on
    ICU, TransformerClassifier on HAR, ResNet18 on CIFAR10; every
    aggregation mode, hyper included (either hypernetwork class and
    update mode, the embedding detector), every attack, stragglers and the
    Dirichlet split, fault plans, checkpoints with the synchronous or the
    async writer, the synchronous executor with synchronous or async
    validation, local_backend xla (in float32, bfloat16 or float16) or,
    for TransformerModel, pallas (the config refuses it for the others,
    for hyper and for a compute-dtype other than float32); the
    synchronous, fused and pipelined executors, each over a client mesh
    of one process's devices too (``tpu.num-devices``); the event log,
    trace, counters and ledger, the numerics ring, the live monitor, the
    profiling and hotspot windows and the cost model.  A mesh over more
    than one process is ROADMAP item 14b (``--coordinator`` refuses it)."""
    if MODEL_DATA.get(cfg.model) != cfg.data_name:
        raise ValueError(f"model {cfg.model!r} does not run on {cfg.data_name!r}; the "
                         f"models and their datasets: {MODEL_DATA}")


def host_filter(mode: str, stacked: dict, attacker_mask: np.ndarray,
                seed: int) -> tuple[np.ndarray, dict[str, Any]]:
    """The gmm or fltracer keep mask (C,) bool of a round's client rows,
    and its metrics: one device-to-host copy of the flat (C, P) matrix,
    then the numpy filter (JAX engine.py:1576-1604).  ``attacker_mask``
    marks every configured attacker; gmm calibrates on the others."""
    flat = pt.tree_ravel_stacked(stacked).cpu().numpy()
    if mode == "gmm":
        keep = defenses.gmm_filter(flat, attacker_mask, seed=seed)
        return keep, {"gmm_kept": int(keep.sum())}
    anomalies = defenses.fltracer_anomalies(flat)
    keep = np.ones(flat.shape[0], dtype=bool)
    keep[anomalies] = False
    return keep, {"fltracer_anomalies": anomalies.tolist()}


def validation_gate(cfg: Config, device: torch.device, validation: Validation | None
                    ) -> Callable:
    """``validate(b, train_ok, ok, loss, evaluate) -> (ok, metrics)``, the
    fused body's validation gate (JAX engine.py:1856-1876): when the
    broadcast ``b`` is due, ``evaluate()`` starts the evaluation (no
    sync), its ``ok`` gates the round and a train-failed round reports
    NaN metrics; a skipped broadcast reports NaN metrics and carries no
    gate.  The metrics hold ``train_loss`` and ``ok``."""
    val_every = cfg.validation_every
    metric_keys = METRIC_KEYS[cfg.data_name] if validation is not None else ()
    nan = torch.full((), float("nan"), device=device)

    def validate(b: int, train_ok, ok, loss, evaluate: Callable):
        metrics = {"train_loss": loss}
        if validation is not None:
            if b % val_every == 0:
                ev = dict(evaluate())
                ok = ok & ev.pop("ok")
                metrics.update({k: torch.where(train_ok, v, nan) for k, v in ev.items()})
            else:
                metrics.update({k: nan for k in metric_keys})
        metrics["ok"] = ok
        return ok, metrics

    return validate


def build_plain_tail(cfg: Config, device: torch.device, aggregate: Callable,
                     validation: Validation | None,
                     numerics_step: Callable | None = None) -> Callable:
    """The rest of an aggregating mode's fused broadcast once its round
    step has run: ``tail(state, b, draws, outputs) -> (state, metrics)``,
    ``outputs`` the round step's ``(stacked, sizes, new_genuine, train_ok,
    loss)`` at broadcast ``b`` (JAX engine.py:1877-1984, plain branch).
    The aggregate over the clients that reported, ``ok`` (training ok,
    some client reported, the validation gate), the accept by
    ``torch.where`` and, with ``numerics_step``, the numerics row measured
    against the accepted params.  The fused body and the scenario
    matrix's cells (``matrix/program.py``) run this one function."""
    validate = validation_gate(cfg, device, validation)
    weights = torch.ones(cfg.total_clients, device=device)

    def accept(flag, new, old):
        return pt.tree_map(lambda n, o: torch.where(flag, n, o), new, old)

    def tail(state: dict[str, Any], b: int, draws, outputs: tuple):
        stacked, sizes, new_gen, train_ok, loss = outputs
        params = state["global_params"]
        # the clients that reported: a round where none did fails
        round_mask = weights * (sizes > 0)
        new_global = aggregate(params, stacked, sizes, round_mask, draws)
        ok = train_ok & torch.any(round_mask > 0)
        ok, metrics = validate(b, train_ok, ok, loss, lambda: validation.test_async(new_global))
        new_state = dict(
            state, global_params=accept(ok, new_global, params), prev_genuine=new_gen,
            have_genuine=state["have_genuine"] | train_ok,
            completed_rounds=state["completed_rounds"] + ok.to(torch.int64),
            broadcasts=b)
        if numerics_step is not None:
            # measured against the ACCEPTED params, as the synchronous round
            new_state["numerics"], metrics["numerics_row"] = numerics_step(
                state["numerics"], params, new_state["global_params"], stacked, sizes, loss,
                ok, b)
        return new_state, metrics

    return tail


class Simulator:
    """End-to-end federated simulation of one Config on one device, or
    over a client mesh of one process's devices (``use_mesh`` builds it
    from ``tpu.num-devices``; ``mesh`` gives one, its lead device the
    run's ``device``; ``mesh_strategy`` ``shard_map`` or ``gspmd``, by
    JAX's rule when None)."""

    def __init__(self, cfg: Config, device: str | torch.device = "cuda",
                 logger: Logger | None = None, use_mesh: bool = False,
                 mesh: ClientMesh | None = None, mesh_strategy: str | None = None):
        check_slice(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self._resolve_mesh(use_mesh, mesh, mesh_strategy)
        # opened once the config and the device are accepted
        self.logger = logger or Logger(f"{cfg.log_path}/app.log")
        # the event log, tracer and counters (JAX engine.py:275-296); inert
        # with telemetry.enabled false
        self.telemetry = Telemetry.from_config(cfg)
        # the live monitor (JAX engine.py:333-348): never built with
        # telemetry off; bound at the run's start
        self.monitor = None
        if self.telemetry.enabled and cfg.telemetry.monitor:
            self.monitor = RunMonitor(self.telemetry, port=cfg.telemetry.monitor_port,
                                      stall_factor=cfg.telemetry.stall_factor,
                                      stall_grace_seconds=cfg.telemetry.stall_grace_seconds)
        # the hotspot window (JAX engine.py:349-359): fail-open capture at
        # the dispatch seams, each closed window mined into a `hotspot`
        # event; traces land under <telemetry base>/profile
        self._hotspots = HotspotCapture(
            self.telemetry,
            parse_profile_rounds(cfg.telemetry.hotspots or cfg.telemetry.profile_rounds),
            monitor=self.monitor, device=self.device.type)
        # the cost model (JAX engine.py:316-331): each program counted on
        # its first dispatch into a `program_profile` event.
        # ATTACKFL_COSTMODEL=0 is the harness's switch (the test suite
        # builds hundreds of Simulators); runs keep the config default, on
        self._costmodel_on = bool(self.telemetry.enabled and cfg.telemetry.costmodel
                                  and os.environ.get("ATTACKFL_COSTMODEL", "1") != "0")
        self._program_profiles: dict[str, dict[str, Any]] = {}
        if self._costmodel_on:
            warm()
        self._header_emitted = False
        self._header_record: dict[str, Any] | None = None
        # the cross-run ledger (JAX engine.py:363-386): one record per run,
        # derived from this run's slice of events.jsonl and of the spans
        self._ledger = None
        self._ledger_events_offset = 0
        self._ledger_trace_offset = 0
        if self.telemetry.enabled and cfg.telemetry.ledger:
            self._ledger = LedgerStore(resolve_ledger_dir(cfg.telemetry.ledger_dir or None,
                                                          base=self.telemetry.base_dir))
            if self._ledger.swept_orphans:
                self.telemetry.counters.inc("orphan_tmp_swept", len(self._ledger.swept_orphans))
            if self.monitor is not None:
                self.monitor.set_ledger(self._ledger)
            try:
                self._ledger_events_offset = os.path.getsize(self.telemetry.events.path)
            except OSError:
                self._ledger_events_offset = 0
        self.model = get_model(cfg.model)
        data_seed = cfg.data_seed if cfg.data_seed is not None else cfg.random_seed
        train_np = get_dataset(cfg.data_name, "train", cfg.train_size, data_seed)
        test_np = get_dataset(cfg.data_name, "test", cfg.test_size, data_seed)
        self.train_data = {k: torch.as_tensor(v, device=self.device)
                           for k, v in train_np.items()}
        self.test_data = {k: torch.as_tensor(v, device=self.device)
                          for k, v in test_np.items()}
        self.pool_size = next(iter(train_np.values())).shape[0]
        self.client_pools = None
        if cfg.partition == "dirichlet":
            pools = dirichlet_label_partition(train_np["label"], cfg.total_clients,
                                              cfg.dirichlet_alpha, seed=cfg.random_seed)
            self.client_pools = torch.as_tensor(pools, dtype=torch.int64, device=self.device)
        self.attack_groups, self.genuine_idx = build_attack_groups(cfg)
        self.leak_k = leak_size(cfg, len(self.genuine_idx))
        # every configured attacker, `none` cohorts included (JAX round.py:119-131)
        self.attacker_mask = np.zeros(cfg.total_clients, dtype=bool)
        for grp in self.attack_groups:
            self.attacker_mask[list(grp.indices)] = True
        self.validation = (Validation(self.model, cfg.data_name, test_np, self.device,
                                      self.logger, telemetry=self.telemetry)
                           if cfg.validation else None)
        self.num_params = sum(x.numel() for x in self.model.parameters())
        self._drawer = round_drawer(cfg, self.attack_groups, len(self.genuine_idx),
                                    self.pool_size, self.num_params,
                                    self.test_data["label"].shape[0], self.client_pools)
        self.is_hyper = cfg.mode == "hyper"
        self.detector = None
        if self.is_hyper:
            # the JAX engine sizes its hypernetwork from a template inited
            # at random_seed (engine.py:402-411); only the shapes matter
            self.target_template = self.model.init(
                torch.Generator().manual_seed(cfg.random_seed))
            self.hnet = make_hypernetwork(cfg.hyper_class, self.target_template,
                                          cfg.total_clients, embedding_dim=8, hidden_dim=100,
                                          spec_norm=cfg.hyper_spec_norm, n_hidden=2)
            self.round_step = build_hyper_round(self.model, cfg, self.train_data,
                                                self.attack_groups, self.genuine_idx, self.hnet,
                                                mesh=self.mesh)
            self.hyper_update, self.hyper_opt = build_hyper_update(cfg, self.hnet)
            if cfg.hyper_detection.enable:
                hd = cfg.hyper_detection
                self.detector = defenses.HyperDetector(
                    cfg.total_clients, hd.cosine_search, hd.n_components, hd.eps,
                    hd.min_samples, hd.start_round,
                    save_path=os.path.join(cfg.log_path, "all_embeddings.npy"))
        else:
            self.round_step = build_round_step(self.model, cfg, self.train_data,
                                               self.attack_groups, self.genuine_idx,
                                               mesh=self.mesh)
            # gspmd keeps the unchanged aggregator over the gathered rows
            self.aggregate = build_aggregator(
                self.model, cfg, self.test_data,
                mesh=self.mesh if self.mesh_strategy == "shard_map" else None)
        # the defense's per-round verdict against the attackers, built only
        # when its events are recorded (JAX engine.py:470-481); gmm and
        # fltracer hold their keep mask on the host already
        self._attribution = None
        if (not self.is_hyper and self.telemetry.enabled and self.attack_groups
                and cfg.mode not in ("gmm", "fltracer")):
            self._attribution = build_attribution_fn(self.model, cfg, self.test_data)
        # the numerics ring (JAX engine.py:483-534): the layout from the
        # client params' leaves, or the target model's in hyper mode; the
        # step draws nothing and writes no tensor it is given
        self._numerics = None
        self._numerics_drainer = None
        if self.telemetry.enabled and cfg.telemetry.numerics:
            template = (self.target_template if self.is_hyper else
                        self.model.init(torch.Generator().manual_seed(cfg.random_seed)))
            layout = build_layout(template, bool(self.attack_groups))
            self._numerics = Numerics(layout, ~self.attacker_mask, self.attacker_mask,
                                      window=cfg.telemetry.numerics_window, device=self.device)
            self._numerics_drainer = NumericsDrainer(
                layout, self.telemetry, cfg.telemetry.numerics_window,
                on_gauges=self.monitor.update_numerics if self.monitor is not None else None)
        # the plan's host-side faults (the device-side ones are in round_step)
        self.fault_injector = (HostFaultInjector(cfg.faults, self.telemetry)
                               if cfg.faults else None)
        # temp files of killed writes go before any new checkpoint activity
        swept = ckpt.sweep_orphans(cfg.checkpoint_dir)
        if swept:
            self.telemetry.counters.inc("orphan_tmp_swept", len(swept))
            print(f"[checkpoint] swept {len(swept)} orphaned temp file(s) from "
                  f"{cfg.checkpoint_dir or '.'}", flush=True)
        self.checkpoints = ckpt.CheckpointManager(
            ckpt.checkpoint_path(cfg), fingerprint=config_fingerprint(cfg),
            keep=cfg.checkpoint_keep, fresh=not (cfg.resume or cfg.load_parameters),
            injector=self.fault_injector, telemetry=self.telemetry)
        # the `resume` event's payload, written after the run header
        self._resume_info: dict[str, Any] | None = None
        self.checkpoint_writer = None
        if cfg.checkpoint_async:
            self.checkpoint_writer = ckpt.AsyncCheckpointWriter(
                write_fn=lambda path, state, meta: self.checkpoints.write(state, meta),
                on_restart=self._on_writer_restart)
        # validation_async: (history entry, its round, the evaluation in flight)
        self._inflight_validations: list[tuple[dict[str, Any], int, dict]] = []
        # reload_parameters_per_round: ((st_mtime_ns, st_size), params) of
        # the last read, so an unchanged file costs a stat
        self._reload_cache: tuple[tuple[int, int], dict] | None = None
        # the fused body, built once for each value of include_eval
        self._fused_bodies: dict[bool, Callable] = {}
        # the stop hook's string verdict (JAX engine.py:306), the pipeline
        # depth this run resolved and how (JAX engine.py:557-558)
        self._stop_reason: str | None = None
        self._depth_resolved: int | None = None
        self._depth_info: dict[str, Any] | None = None
        # extra run_header fields a wrapping executor records (the matrix
        # stamps its fallback cells' runs with sweep_id and cell, schema v7)
        self.header_extra: dict[str, Any] = {}

    def _resolve_mesh(self, use_mesh: bool, mesh: ClientMesh | None,
                      mesh_strategy: str | None) -> None:
        """``self.mesh`` and ``self.mesh_strategy`` (JAX engine.py:202-273):
        ``use_mesh`` builds the mesh from ``tpu.num-devices`` on the run's
        device type; a client count the mesh size does not divide runs
        without a mesh, with JAX's message; ``shard_map`` where
        :func:`~attackfl_tpu_torch.parallel.shard.supports_shard_map`
        allows it, else ``gspmd``, and a forced ``shard_map`` it does not
        allow is refused."""
        cfg = self.cfg
        self.mesh = mesh
        if use_mesh and mesh is None:
            self.mesh = make_client_mesh(cfg.mesh.num_devices, cfg.mesh.axis_name,
                                         device=self.device)
        if self.mesh is not None and self.mesh.lead != canonical(self.device):
            raise ValueError(f"the mesh's lead device {self.mesh.lead} is not the run's "
                             f"device {self.device}")
        if self.mesh is not None and cfg.total_clients % self.mesh.size != 0:
            print_with_color(
                f"[mesh] {cfg.total_clients} clients not divisible by "
                f"{self.mesh.size} devices; running replicated.", "yellow")
            self.mesh = None
        self.mesh_strategy: str | None = None
        if self.mesh is not None:
            if mesh_strategy is None:
                self.mesh_strategy = "shard_map" if supports_shard_map(cfg) else "gspmd"
            else:
                if mesh_strategy not in ("shard_map", "gspmd"):
                    raise ValueError(f"unknown mesh_strategy {mesh_strategy!r}; choose "
                                     "'shard_map' or 'gspmd'")
                if mesh_strategy == "shard_map" and not supports_shard_map(cfg):
                    raise ValueError(
                        "mesh_strategy 'shard_map' needs prng_impl threefry2x32 on a plain "
                        "(non-hyper) mode: rbg hardware keys draw batch-shape-dependent "
                        "bits, so device-local client blocks cannot reproduce the "
                        "single-program trajectory (parallel/shard)")
                self.mesh_strategy = mesh_strategy

    def _synchronize(self) -> None:
        """Wait for the run's device, every device of its mesh."""
        for device in (self.mesh.distinct if self.mesh is not None else (self.device,)):
            devices.synchronize(device)

    def _place_on_mesh(self, state: dict[str, Any]) -> dict[str, Any]:
        """A run-entry state in its canonical mesh placement (JAX
        ``_place_on_mesh``, engine.py:874-892): every tensor on a device of
        the mesh's type moved to the lead device, where the round
        programs' replicated state lives.  The host's own state (hyper
        mode's active mask and Adam count on the CPU) stays where it is,
        and a state from this Simulator is returned as the same tensors."""
        if self.mesh is None:
            return state
        lead = self.mesh.lead

        def place(value):
            if isinstance(value, dict):
                return {k: place(v) for k, v in value.items()}
            if isinstance(value, torch.Tensor) and value.device.type == lead.type:
                return value.to(lead)
            return value

        return {k: place(v) for k, v in state.items()}

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------

    def init_state(self, seed: int | None = None) -> dict[str, Any]:
        """Fresh simulation state (the reference's fresh-init path,
        server.py:160-162)."""
        seed = self.cfg.random_seed if seed is None else seed
        num_genuine = len(self.genuine_idx)
        rng = torch.Generator(device=self.device).manual_seed(seed)
        if self.is_hyper:
            # JAX engine.py:916-930: the hypernetwork and its Adam state,
            # the leak pool shaped like the target model, the active mask
            flat = self.hnet.init(torch.Generator().manual_seed(seed), self.device)
            params = pt.tree_map(lambda x: x.to(self.device), self.target_template)
            state = {"hnet_params": flat, "hyper_opt_state": self.hyper_opt.init(flat),
                     "active_mask": torch.ones(self.cfg.total_clients)}
        else:
            params = self.model.init(torch.Generator().manual_seed(seed), self.device)
            state = {"global_params": params}
        return {
            **state,
            "prev_genuine": pt.tree_map(
                lambda x: torch.zeros((num_genuine,) + tuple(x.shape),
                                      dtype=x.dtype, device=x.device), params),
            "have_genuine": False,
            "rng": rng,
            "completed_rounds": 0,
            "broadcasts": 0,
        }

    def host_state(self, state: dict[str, Any]) -> dict[str, Any]:
        """``state`` as a checkpoint holds it: the generator as its
        ``get_state()`` (a CPU uint8 tensor); in hyper mode the
        hypernetwork and Adam's moments as flax-named trees, so a
        checkpoint of the other class fails the structure check.  The
        numerics ring is observability state and never checkpointed (JAX
        engine.py:1031-1042, 1463-1466): a resumed run starts a fresh one."""
        host = {k: v for k, v in state.items() if k != "numerics"}
        host["rng"] = state["rng"].get_state()
        if self.is_hyper:
            opt = state["hyper_opt_state"]
            host["hnet_params"] = self.hnet.tree(state["hnet_params"])
            host["hyper_opt_state"] = {"count": opt["count"], "m": self.hnet.tree(opt["m"]),
                                       "v": self.hnet.tree(opt["v"])}
        return host

    def restore_state(self, host: dict[str, Any]) -> dict[str, Any]:
        """The inverse of :meth:`host_state`, on the run's device."""
        state = {k: (pt.tree_map(lambda x: x.to(self.device), v) if isinstance(v, dict) else v)
                 for k, v in host.items()}
        state["rng"] = torch.Generator(device=self.device)
        state["rng"].set_state(host["rng"].cpu())
        if self.is_hyper:
            opt = host["hyper_opt_state"]
            state["hnet_params"] = self.hnet.from_tree(host["hnet_params"], self.device)
            state["hyper_opt_state"] = {
                "count": opt["count"].cpu(), "m": self.hnet.from_tree(opt["m"], self.device),
                "v": self.hnet.from_tree(opt["v"], self.device)}
            state["active_mask"] = host["active_mask"].cpu()
        return state

    def _load_resume_state(self) -> dict[str, Any] | None:
        """``resume``: the newest valid manifest entry (a torn one falls
        back to the entry before), or None when there is none."""
        result = self.checkpoints.load_latest(self.host_state(self.init_state()))
        rejected = [{"file": entry.get("file"), "round": entry.get("round"),
                     "reason": reason[:200]} for entry, reason in result.rejected]
        if rejected:
            self.telemetry.counters.inc("checkpoint_fallbacks", len(rejected))
        for item in rejected:
            print(f"[resume] rejected checkpoint {item['file']}: {item['reason']}", flush=True)
        if result.state is None:
            print("[resume] no valid checkpoint entry found under "
                  f"{self.checkpoints.directory!r}; starting fresh", flush=True)
            self._resume_info = None
            return None
        manifest = result.manifest or {}
        fingerprint_match = (manifest["fingerprint"] == self.checkpoints.fingerprint
                             if manifest.get("fingerprint") else None)
        if fingerprint_match is False:
            log.warning("[resume] config fingerprint mismatch: this checkpoint was written "
                        "under another experiment config; resuming because the state "
                        "structure matched, but verify the config")
        state = self.restore_state(result.state)
        self._resume_info = {
            "round": int(state["completed_rounds"]), "broadcast": int(state["broadcasts"]),
            "path": os.path.join(self.checkpoints.directory,
                                 str((result.entry or {}).get("file", ""))),
            "source_run_id": manifest.get("run_id", ""),
            "fingerprint_match": fingerprint_match, "rejected": rejected}
        print(f"[resume] continuing from round {state['completed_rounds']} "
              f"({(result.entry or {}).get('file')})", flush=True)
        return state

    def load_or_init_state(self) -> dict[str, Any]:
        """The starting state (reference server.py:144-163,578-586):
        ``resume`` restores through the manifest and the round numbering
        continues; ``load_parameters`` reads the ``{model}.pth`` alias; a
        missing checkpoint starts fresh."""
        if self.cfg.resume:
            state = self._load_resume_state()
            return state if state is not None else self.init_state()
        state = self.init_state()
        if self.cfg.load_parameters:
            path = ckpt.checkpoint_path(self.cfg)
            try:
                state = self.restore_state(ckpt.load_state(path, self.host_state(state)))
                print(f"Load state from checkpoint: {path}", flush=True)
            except FileNotFoundError:
                pass
        return state

    def _ensure_numerics_state(self, state: dict[str, Any]) -> dict[str, Any]:
        """Attach a fresh numerics ring to a state that lacks one (a fresh
        init, a resume, a state built with numerics off; JAX
        engine.py:894-903)."""
        if self._numerics is not None and "numerics" not in state:
            state = dict(state, numerics=self._numerics.init_state())
        return state

    def _numerics_step(self, num_state: dict, old_ref, new_ref, stacked: dict,
                       sizes: torch.Tensor, loss, ok, broadcast: int):
        """The numerics step of a round (JAX engine.py:513-534): the client
        updates measured against the global params ``old_ref``, or in
        hyper mode against the params the hypernetwork ``old_ref``
        generates for each client this broadcast.  ``new_ref`` is the
        round's accepted outcome."""
        with torch.no_grad():
            base = self.hnet.generate_all(old_ref)[0] if self.is_hyper else old_ref
            return self._numerics.step(num_state, base, old_ref, new_ref, stacked, sizes,
                                       loss, ok, broadcast)

    def save_checkpoint(self, state: dict[str, Any]) -> bool:
        """Persist ``state`` as a round-stamped entry, the alias and the
        manifest record; False when the write failed open.  With
        ``checkpoint_async`` the host snapshot is taken here, on the round
        loop, and handed to the writer's thread: True once submitted."""
        meta = {"round": state["completed_rounds"], "broadcast": state["broadcasts"]}
        writer = self.checkpoint_writer
        tel = self.telemetry
        if self.fault_injector is not None:
            self.fault_injector.maybe_kill_writer(meta["round"], writer)
        # the span's `background` says which writer ran (JAX engine.py:1462-1479)
        with tel.tracer.span("checkpoint", background=writer is not None):
            if writer is None:
                written = self.checkpoints.write(self.host_state(state), meta)
            else:
                writer.submit(self.checkpoints.path,
                              ckpt.host_snapshot(self.host_state(state)), meta)
                tel.counters.inc("checkpoint_submits")
                written = True
        tel.events.emit("checkpoint", path=self.checkpoints.path, round=meta["round"],
                        background=writer is not None)
        return written

    def _on_writer_restart(self, restarts: int) -> None:
        """The writer's supervisor revived a dead thread."""
        log.warning("fault %s", json.dumps({"fault": "writer_death", "action": "recovered",
                                             "restarts": restarts}))
        self.telemetry.counters.inc("checkpoint_writer_restarts")
        self.telemetry.events.emit("fault", fault="writer_death", action="recovered",
                                   restarts=restarts)

    def close(self) -> None:
        """Stop the monitor's threads, drain and stop the async checkpoint
        writer and close the event log.  Safe to call twice; the
        Simulator still runs afterwards, saving synchronously (its
        telemetry then writes nothing)."""
        if self.monitor is not None:
            self.monitor.stop()
        if self.checkpoint_writer is not None:
            self.checkpoint_writer.close()
            self.checkpoint_writer = None
        self.telemetry.close()

    def _reload_params(self, state: dict[str, Any]) -> dict[str, Any]:
        """``reload_parameters_per_round`` (reference server.py:578-586):
        each broadcast re-reads the global params from ``{model}.pth``; an
        unchanged file (same mtime and size) costs one stat, a missing
        one nothing."""
        path = ckpt.checkpoint_path(self.cfg)
        try:
            st = os.stat(path)
        except FileNotFoundError:
            return state
        key = (st.st_mtime_ns, st.st_size)
        if self._reload_cache is None or self._reload_cache[0] != key:
            host = ckpt.load_state(path, self.host_state(state), self.device)
            self._reload_cache = (key, host["global_params"])
            self.telemetry.counters.inc("reload_cache_misses")
        else:
            self.telemetry.counters.inc("reload_cache_hits")
        return dict(state, global_params=self._reload_cache[1])

    # ------------------------------------------------------------------
    # audit hooks (analysis/program_audit)
    # ------------------------------------------------------------------

    def donation_spec(self) -> dict[str, tuple[int, ...]]:
        """The round programs' consumed arguments, by the JAX package's
        program names (JAX ``donation_spec``, engine.py:614-636): each
        entry of :data:`DONATION_SPEC` this mode runs, all empty."""
        names = (("round_step", "generate_all", "hyper_update") if self.is_hyper
                 else ("round_step", "aggregate")) + ("fused_chunk", "pipeline_step")
        return {name: DONATION_SPEC[name] for name in names}

    def audit_programs(self, state: dict[str, Any] | None = None) -> list[dict[str, Any]]:
        """Every round program with example arguments, for the program
        audit (JAX ``audit_programs``, engine.py:638-704): ``{name,
        executor, fn, args, donate}`` per program, ``fn(*args)`` the
        callable :meth:`_dispatch` runs under that program's label and
        ``donate`` its :meth:`donation_spec` entry.  The JAX package's
        names and executors: ``round_step`` and ``aggregate`` (or
        ``hyper_update``), ``fused_chunk[2]`` (``run_scan``'s chunk of 2,
        dispatched as ``fused_scan[2]``) and ``pipeline_step[eval=...]``
        where :meth:`supports_fused`.

        The arguments are those of the broadcast where every attacker
        fires (a leak pool present), from ``state`` (default: a fresh
        one).  Each program gets its own copy of the generator, so
        nothing here advances ``state``'s; the second synchronous
        program's inputs come from one unaudited call of the first."""
        state = self._ensure_numerics_state(state if state is not None else self.init_state())
        spec = self.donation_spec()
        b = max([g.attack_round for g in self.attack_groups] or [1])
        state = dict(state, have_genuine=True, broadcasts=b - 1)

        def rng():
            gen = torch.Generator(device=self.device)
            gen.set_state(state["rng"].get_state())
            return gen

        programs: list[dict[str, Any]] = []
        if self.is_hyper:
            active = state["active_mask"].to(self.device)
            args = (state["hnet_params"], state["prev_genuine"], True, rng(), b, active, None)
            _, (stacked, sizes, *_) = self._drawn_round_step(*args[:3], rng(), *args[4:])
            programs.append(dict(name="round_step", executor="sync",
                                 fn=self._drawn_round_step, args=args,
                                 donate=spec["round_step"]))
            programs.append(dict(name="hyper_update", executor="sync", fn=self.hyper_update,
                                 args=(state["hnet_params"], state["hyper_opt_state"],
                                       stacked, active * (sizes > 0)),
                                 donate=spec["hyper_update"]))
        else:
            args = (state["global_params"], state["prev_genuine"], True, rng(), b)
            draws, (stacked, sizes, *_) = self._drawn_round_step(*args[:3], rng(), b)
            weights = torch.ones(self.cfg.total_clients, device=self.device) * (sizes > 0)
            programs.append(dict(name="round_step", executor="sync",
                                 fn=self._drawn_round_step, args=args,
                                 donate=spec["round_step"]))
            programs.append(dict(name="aggregate", executor="sync", fn=self.aggregate,
                                 args=(state["global_params"], stacked, sizes, weights, draws),
                                 donate=spec["aggregate"]))
        if self.supports_fused():
            self._require_fused(state)
            programs.append(dict(name="fused_chunk[2]", executor="fused",
                                 fn=self._scan_chunk(2), args=(self._fused_state(state),),
                                 donate=spec["fused_chunk"]))
            include_eval = self.validation is not None and not self.cfg.validation_async
            programs.append(dict(name=f"pipeline_step[eval={include_eval}]",
                                 executor="pipelined", fn=self._fused_body(include_eval),
                                 args=(self._fused_state(state),),
                                 donate=spec["pipeline_step"]))
        return programs

    def damage_objective(self, state: dict[str, Any] | None = None) -> list[dict[str, Any]]:
        """Scalar post-defense damage objectives for the transform-safety
        auditor (JAX ``damage_objective``, engine.py:706-780): ``{name,
        executor, objective, args, donate}`` per executor path, JAX's keys
        and names.  Each ``objective(*args) -> 0-dim tensor`` measures how
        far the defended aggregate moves under an additive perturbation,
        argument 0, a tree of the shape the gradient has:

        * ``sync_damage(perturb, global_params, prev_genuine, have_genuine,
          draws, broadcast_number)``: broadcast 1's round step (under
          ``no_grad``: the perturbation enters after it, and it runs
          ``run``'s in-place path, so ``run``'s bits), ``perturb`` times the
          attacker mask added to the stacked rows, the aggregate over the
          clients that reported, and the sum of squares of the move.  Its
          ``draws`` are the round's, drawn before the call from a copy of
          ``state``'s generator, so no draw reads the card inside it.
        * ``fused_damage[2]`` (where :meth:`supports_fused`):
          ``(pool_perturb, scan_state)``, two broadcasts of the fused body
          from ``scan_state`` with ``perturb`` added to its leak pool
          ``prev_genuine``; the body draws from its own copy of the state's
          generator, so every call sees the same draws.  The gradient runs
          through the second broadcast's local training when the first
          one attacks (the update is out of place, ``local.adam_step``).

        ``state`` defaults to :meth:`init_state`, as in JAX, where the
        first broadcast does not attack and overwrites the perturbed pool
        before the second reads it: the fused gradient is exactly 0 there.
        ``donate`` is ``(0,)``: the gradient has the perturbation's tree.
        The perturbations in ``args`` are zeros; callers put their own in
        their place.  Under ``local_backend: pallas`` the fused objective's
        gradient is refused, as ``jax.grad`` of it raises (K1 has no
        backward); ``sync_damage``'s runs, as JAX's does."""
        if self.is_hyper:
            raise NotImplementedError(
                "hyper mode has no attack-perturbation damage objective "
                "(no per-client aggregate to perturb)")
        state = self._ensure_numerics_state(state if state is not None else self.init_state())
        device, n = self.device, self.cfg.total_clients
        gen = torch.Generator(device=device)
        gen.set_state(state["rng"].get_state())
        draws = self.draw_round(gen)
        attacker_sel = torch.as_tensor(self.attacker_mask, dtype=torch.float32, device=device)
        wmask = torch.ones(n, dtype=torch.float32, device=device)
        round_step, aggregate = self.round_step, self.aggregate

        def sync_damage(perturb, global_params, prev_genuine, have_genuine, draws,
                        broadcast_number):
            with torch.no_grad():
                stacked, sizes, _, _, _ = round_step(global_params, prev_genuine, have_genuine,
                                                     draws, broadcast_number)
            stacked = pt.tree_map(
                lambda s, p: s + p * attacker_sel.reshape((-1,) + (1,) * (s.ndim - 1)),
                stacked, perturb)
            new_global = aggregate(global_params, stacked, sizes, wmask * (sizes > 0), draws)
            return pt.sq_distance(new_global, global_params)

        perturb = pt.tree_map(lambda x: torch.zeros((n,) + tuple(x.shape), dtype=x.dtype,
                                                    device=x.device), state["global_params"])
        entries: list[dict[str, Any]] = [dict(
            name="sync_damage", executor="sync", objective=sync_damage,
            args=(perturb, state["global_params"], state["prev_genuine"],
                  state["have_genuine"], draws, 1),
            donate=(0,))]
        if self.supports_fused():
            body = self._build_fused_body()
            pallas = self.cfg.local_backend == "pallas"

            def fused_damage(pool_perturb, scan_state):
                if pallas and pt.under_gradient(pool_perturb):
                    # JAX's body computes the attack at every broadcast and
                    # selects it, so the second broadcast's kernel is on the
                    # differentiated path whatever the state
                    raise NotImplementedError(fused_step.NO_BACKWARD)
                rng = torch.Generator(device=device)
                rng.set_state(scan_state["rng"].get_state())
                s = dict(scan_state, rng=rng, prev_genuine=pt.tree_map(
                    torch.add, scan_state["prev_genuine"], pool_perturb))
                for _ in range(2):
                    s, _ = body(s)
                return pt.sq_distance(s["global_params"], scan_state["global_params"])

            entries.append(dict(
                name="fused_damage[2]", executor="fused", objective=fused_damage,
                args=(pt.tree_map(torch.zeros_like, state["prev_genuine"]),
                      self._fused_state(state)),
                donate=(0,)))
        return entries

    # ------------------------------------------------------------------
    # telemetry
    # ------------------------------------------------------------------

    def _emit_run_header(self) -> None:
        """The run's first event (JAX ``_emit_run_header``,
        engine.py:1069-1152): the config, the backend under JAX's names
        (``gpu`` on the card, ``cpu``), the attackers and the resolved
        pipeline depth; then the ``resume`` event of a resumed run.
        Host-known values only."""
        tel = self.telemetry
        if self._header_emitted or not tel.enabled:
            return
        self._header_emitted = True
        # bound before the header goes out, which records the ACTUAL port
        # (`monitor-port: 0` binds an ephemeral one)
        self._start_monitor()
        programs = {}
        if self._numerics is not None:
            programs["numerics"] = {
                "program": "numerics_step",
                "slots": self._numerics.layout.size,
                "window": self._numerics.window,
                "metrics": list(self._numerics.layout.names),
                "leaf_names": list(self._numerics.layout.leaf_names),
            }
        backend = "gpu" if self.device.type == "cuda" else "cpu"
        depth = ({"pipeline_depth": int(self._depth_resolved),
                  "pipeline_depth_configured": str(self.cfg.pipeline_depth)}
                 if self._depth_resolved is not None else {})
        mesh = ({"mesh_devices": self.mesh.size, "mesh_strategy": self.mesh_strategy}
                if self.mesh is not None else {"mesh_devices": 0})
        self._header_record = tel.events.emit(
            "run_header", backend=backend,
            num_devices=torch.cuda.device_count() if self.device.type == "cuda" else 1,
            **mesh, mode=self.cfg.mode,
            model=self.cfg.model, data_name=self.cfg.data_name,
            total_clients=self.cfg.total_clients,
            attacks=describe_attack_groups(self.attack_groups), programs=programs,
            torch_version=torch.__version__, platform=backend, git_rev=git_revision(),
            fault_plan=[spec.describe() for spec in self.cfg.faults],
            config=dataclasses.asdict(self.cfg),
            **({"monitor_port": int(self.monitor.port)}
               if self.monitor is not None and self.monitor.port is not None else {}),
            **depth, **self.header_extra)
        if self._resume_info is not None:
            # the boundary the resumed run continues from: its own round
            # events start at round + 1
            tel.events.emit("resume", **self._resume_info)
            self._resume_info = None

    def _start_monitor(self) -> None:
        """Bind the health endpoint (idempotent) and arm the watchdog for
        this run (JAX engine.py:1375-1390)."""
        if self.monitor is None:
            return
        first = self.monitor.port is None
        if self.mesh is not None:
            self.monitor.set_mesh(self.mesh.size, self.mesh_strategy)
        self.monitor.start().run_started()
        if first:
            print_with_color(f"[monitor] http://localhost:{self.monitor.port} "
                             "(/healthz /metrics /last-round — poll with "
                             "`python -m attackfl_tpu_torch watch`)", "cyan")

    def _maybe_start_profile(self, first_round: int, last_round: int | None = None,
                             program: str = "sync") -> None:
        """Open the profiling window when the upcoming round(s)
        [first_round, last_round] overlap ``hotspots``/``profile_rounds``
        (JAX engine.py:1390-1400).  Fused chunks pass their whole round
        range; ``program`` names the dispatch seam on the ``hotspot``
        event."""
        self._hotspots.maybe_start(first_round, last_round, program=program)

    def _maybe_stop_profile(self, completed_rounds: int = 0, force: bool = False) -> None:
        self._hotspots.maybe_stop(completed_rounds, force=force)

    def _dispatch(self, label: str, fn: Callable, *args, rounds_per_dispatch: int = 1):
        """``fn(*args)``, one dispatch of the program ``label``, under its
        ``record_function`` label (the hotspot miner's program).  With the
        cost model on, the program's first dispatch in this Simulator is
        counted (``costmodel/capture.count_program``) and written as a
        ``program_profile`` event (JAX engine.py:811-857); the counter's
        own bookkeeping is taken out of the open spans into a ``costmodel``
        span, so no round's span holds it.  A program over a client mesh
        is counted too: JAX skips its capture there because an AOT compile
        pins input shardings (engine.py:838-842), which an eager count does
        not, and ``run``, which always builds a mesh, keeps its profiles."""
        with torch.profiler.record_function(label):
            if not self._costmodel_on or label in self._program_profiles:
                return fn(*args)
            result, profile = count_program(fn, *args, device=self.device)
            self.telemetry.tracer.discount("costmodel", profile["overhead_s"], program=label,
                                           ops=profile["ops"])
            self._emit_program_profile(label, profile, rounds_per_dispatch)
            return result

    def _emit_program_profile(self, name: str, counted: dict[str, Any],
                              rounds_per_dispatch: int = 1) -> None:
        """One counted program's profile as a ``program_profile`` event
        (schema v9), fed to the monitor's cost gauges (JAX
        ``_emit_program_profile``, engine.py:811-829)."""
        profile = {k: counted[k] for k in ("flops", "transcendentals", "bytes_accessed",
                                          "memory") if k in counted}
        profile["rounds_per_dispatch"] = int(rounds_per_dispatch)
        profile["device_kind"] = (torch.cuda.get_device_name(self.device)
                                  if self.device.type == "cuda" else "cpu")
        self._program_profiles[name] = profile
        self.telemetry.events.emit("program_profile", program=name,
                                   fingerprint=self.checkpoints.fingerprint, **profile)
        if self.monitor is not None:
            self.monitor.set_cost_model(dict(self._program_profiles))

    def _note_round_faults(self, round_no: int, broadcast: int) -> None:
        """A resolved round's host-side fault bookkeeping (JAX
        engine.py:1431-1439): the plan's device-side injections of its
        broadcast, then any armed monitor stall."""
        if self.fault_injector is None:
            return
        self.fault_injector.note_round_resolved(broadcast)
        self.fault_injector.maybe_stall_monitor(round_no, self.monitor)

    def _emit_attribution(self, metrics: dict[str, Any], global_params: dict, stacked: dict,
                          sizes: torch.Tensor, weights_mask: torch.Tensor,
                          broadcast_number: int, have_genuine: bool,
                          defense_mask: np.ndarray | None, draws, timer: RoundTimer) -> None:
        """The defense's verdict against the round's attackers, the
        ``attribution`` event (JAX ``_emit_attribution``,
        engine.py:1154-1200): gmm's and fltracer's host mask, or the
        attribution function on this round's own ``draws``.  The per-round
        path only: a fused chunk is one opaque dispatch."""
        tel = self.telemetry
        if not (tel.enabled and self.attack_groups):
            return
        if self._attribution is None and defense_mask is None:
            return
        with timer.phase("attribution"):
            if self._attribution is not None:
                keep, scores = self._attribution(global_params, stacked, sizes, weights_mask,
                                                 draws)
                keep, scores = keep.cpu().numpy(), scores.to(torch.float64).cpu().numpy()
            else:
                keep = scores = defense_mask
            keep = np.asarray(keep).astype(bool)
            scores = np.asarray(scores, dtype=np.float64)
            reporting = sizes.cpu().numpy() > 0
        active = active_attacker_indices(self.attack_groups, broadcast_number, have_genuine)
        removed = [int(i) for i in np.flatnonzero(reporting & ~keep)]
        metrics["defense_removed"] = len(removed)
        tel.events.emit(
            "attribution", round=metrics["round"], broadcast=broadcast_number,
            mode=self.cfg.mode, attackers=[int(i) for i in active if reporting[i]],
            kept=[int(i) for i in np.flatnonzero(reporting & keep)], removed=removed,
            non_reporting=[int(i) for i in np.flatnonzero(~reporting)],
            scores={str(i): round(float(v), 6) for i, v in enumerate(scores)})

    @staticmethod
    def _count_nan_clients(stacked: dict) -> int:
        """How many clients' rows hold a non-finite value: the failure
        path only (JAX engine.py:1202-1211)."""
        flat = pt.tree_ravel_stacked(stacked)
        return int(torch.sum(~torch.all(torch.isfinite(flat), dim=1)))

    def _emit_run_end(self, history: list[dict[str, Any]], t_start: float) -> None:
        """The counters and ``run_end`` (with the stop hook's reason), then
        the trace file (JAX ``_emit_run_end``, engine.py:1248-1285)."""
        tel = self.telemetry
        if not tel.enabled:
            return
        self._maybe_stop_profile(force=True)
        if self.monitor is not None:
            self.monitor.run_ended()
        tel.events.emit("counters", counters=tel.counters.snapshot())
        tel.events.emit("run_end", rounds=len(history),
                        ok_rounds=sum(1 for h in history if h.get("ok")),
                        seconds=round(time.perf_counter() - t_start, 6),
                        **({"stop_reason": self._stop_reason} if self._stop_reason else {}))
        tel.flush()

    def _append_ledger_record(self) -> None:
        """Distill this run's slice of ``events.jsonl`` and of the spans
        into one ledger record and append it (JAX ``_append_ledger_record``,
        engine.py:1286-1356).  The byte and span offsets taken after the
        previous append isolate each ``run`` call's slice.  It fails open:
        a ledger that cannot be written raises ``ledger_append_failures``
        and prints a yellow line, and the run's result stands."""
        if self._ledger is None or not self.telemetry.enabled:
            return
        try:
            with open(self.telemetry.events.path, "rb") as fh:
                fh.seek(self._ledger_events_offset)
                tail = fh.read().decode("utf-8", errors="replace")
                self._ledger_events_offset = fh.tell()
            slice_events = []
            for line in tail.splitlines():
                try:
                    record = json.loads(line)
                except ValueError:
                    continue
                if isinstance(record, dict):
                    slice_events.append(record)
            if (self._header_record is not None
                    and not any(e.get("kind") == "run_header" for e in slice_events)):
                slice_events.insert(0, self._header_record)
            spans = self.telemetry.tracer._events
            trace_events = spans[self._ledger_trace_offset:]
            self._ledger_trace_offset = len(spans)
            # the corpus feeds the hotspot join's prediction (this run is
            # not appended yet)
            try:
                corpus = self._ledger.records()
            except Exception:  # noqa: BLE001 — the join is optional
                corpus = None
            record = derive_record(slice_events, trace_events=trace_events,
                                   fingerprint=self.checkpoints.fingerprint,
                                   ledger_records=corpus)
            if record is None:
                return
            rid = self._ledger.append(record)
            self.telemetry.counters.inc("ledger_records_appended")
            self.telemetry.events.emit("ledger", record_id=rid, ledger_path=self._ledger.path)
        except Exception as e:  # noqa: BLE001 — observability fails open
            self.telemetry.counters.inc("ledger_append_failures")
            print_with_color(f"[ledger] append failed (run unaffected): "
                             f"{type(e).__name__}: {e}", "yellow")

    def draw_round(self, gen: torch.Generator, leak_pool: torch.Tensor | None = None):
        """One round's draws (``training/round.round_drawer``);
        ``leak_pool``: under hyper mode's detector, the active genuine
        positions, drawn with replacement (JAX hyper.py:138-164)."""
        return self._drawer(gen, leak_pool)

    def _drawn_round_step(self, params, prev_genuine, have_genuine, rng: torch.Generator,
                          broadcast_number: int, active_mask=None, leak_pool=None):
        """``(draws, round_step's outputs)``: the round's draws and its
        round step, the program JAX names ``round_step`` (whose draws are
        inside it); ``active_mask`` and ``leak_pool`` in hyper mode."""
        if self.is_hyper:
            draws = self.draw_round(rng, leak_pool)
            return draws, self.round_step(params, prev_genuine, have_genuine, active_mask,
                                          draws, broadcast_number)
        draws = self.draw_round(rng)
        return draws, self.round_step(params, prev_genuine, have_genuine, draws,
                                      broadcast_number)

    # ------------------------------------------------------------------
    # one round
    # ------------------------------------------------------------------

    def _validation_due(self, broadcast_number: int) -> bool:
        return (self.validation is not None
                and broadcast_number % self.cfg.validation_every == 0)

    def _resolve_inflight_validations(self) -> None:
        """Read the async validations in flight and fold each into its
        round's history entry, with ``validation_ok``, and into a
        ``validation`` event; the verdict does not gate the round (JAX
        engine.py:1358-1373)."""
        while self._inflight_validations:
            entry, round_no, out = self._inflight_validations.pop(0)
            val_ok, val_metrics = self.validation.resolve_async(out)
            entry.update(val_metrics)
            entry["validation_ok"] = val_ok
            if not val_ok:
                log.warning("async validation of round %d failed: %s", round_no, val_metrics)
                self.telemetry.counters.inc("validation_failures")
            self.telemetry.events.emit("validation", ok=val_ok, round=round_no,
                                       data_name=self.validation.data_name, background=True,
                                       **val_metrics)

    def run_round(self, state: dict[str, Any]) -> tuple[dict[str, Any], dict[str, Any]]:
        """Broadcast -> train -> attack -> defend and aggregate -> validate.

        Returns (new_state, metrics).  On failure (``metrics["ok"]``
        False) the new state keeps the previous global params but advances
        the generator, the broadcast clock and the genuine-leak pool
        (reference retry path, server.py:546-567).  The round runs under a
        ``round`` span and writes a ``round`` event."""
        self._emit_run_header()
        # the validations started last round resolve here, after the card
        # had the host's window between rounds to run them
        self._resolve_inflight_validations()
        t0 = time.perf_counter()
        # hyper mode never reloads (reference gate server.py:580)
        if self.cfg.reload_parameters_per_round and not self.is_hyper:
            state = self._reload_params(state)
        broadcast_number = state["broadcasts"] + 1
        metrics: dict[str, Any] = {"round": state["completed_rounds"] + 1,
                                   "broadcast": broadcast_number}
        with self.telemetry.tracer.span("round", round=metrics["round"],
                                        broadcast=broadcast_number):
            if self.is_hyper:
                new_state, metrics = self._run_hyper_round(state, broadcast_number, metrics)
            else:
                new_state, metrics = self._run_plain_round(state, broadcast_number, metrics)
            self._synchronize()
        metrics["seconds"] = time.perf_counter() - t0
        self.telemetry.events.round_event(metrics)
        return new_state, metrics

    def _note_nan_round(self, metrics: dict[str, Any], stacked: dict) -> None:
        """A train-failed round's counters and its ``nan_clients`` (JAX
        engine.py:1565-1572): counted on the failure path only."""
        tel = self.telemetry
        tel.counters.inc("nan_train_rounds")
        if tel.enabled:
            metrics["nan_clients"] = self._count_nan_clients(stacked)
            tel.counters.inc("nan_clients_detected", metrics["nan_clients"])

    def _run_plain_round(self, state: dict[str, Any], broadcast_number: int,
                         metrics: dict[str, Any]) -> tuple[dict[str, Any], dict[str, Any]]:
        """One round of an aggregating mode, its phases timed as JAX's
        (engine.py:1551-1672): ``train`` ends in the read of ``ok``,
        ``defense`` is gmm's or fltracer's host filter, ``attribution``
        the defense's verdict, ``aggregate`` ends in a sync where JAX
        blocks, ``validate`` in the validation's read."""
        tel = self.telemetry
        timer = RoundTimer(tracer=tel.tracer)
        if self.attack_groups:
            metrics["attacks_active"] = active_attack_modes(
                self.attack_groups, broadcast_number, bool(state["have_genuine"]))
        with timer.phase("train"):
            draws, (stacked, sizes, new_genuine, ok, loss) = self._dispatch(
                "round_step", self._drawn_round_step, state["global_params"],
                state["prev_genuine"], state["have_genuine"], state["rng"], broadcast_number)
            ok = train_ok = bool(ok)
        metrics["train_loss"] = float(loss)
        if not train_ok:
            self._note_nan_round(metrics, stacked)

        weights_mask = torch.ones(self.cfg.total_clients, device=self.device)
        defense_mask = None
        if ok and self.cfg.mode in ("gmm", "fltracer"):
            with timer.phase("defense"):
                keep, filter_metrics = host_filter(self.cfg.mode, stacked, self.attacker_mask,
                                                   self.cfg.random_seed)
            tel.counters.inc("defense_transfer_bytes", sum(
                x.numel() * x.element_size() for x in pt.tree_leaves(stacked)))
            tel.counters.inc("anomalies_removed", self.cfg.total_clients - int(keep.sum()))
            metrics.update(filter_metrics)
            # the round fails when no client survives (server.py:369-372)
            ok = bool(keep.any())
            defense_mask = keep
            weights_mask = torch.as_tensor(keep, dtype=torch.float32, device=self.device)
        # the defense's survivors that reported: with stragglers a filter can
        # keep only dropped (size-0) clients, and a weighted mean would be 0/0
        weights_mask = weights_mask * (sizes > 0)
        if ok and not bool(torch.any(weights_mask > 0)):
            ok = False
        if ok:
            self._emit_attribution(metrics, state["global_params"], stacked, sizes,
                                   weights_mask, broadcast_number, bool(state["have_genuine"]),
                                   defense_mask, draws, timer)
        new_global = state["global_params"]
        if ok:
            with timer.phase("aggregate"):
                new_global = self._dispatch("aggregate", self.aggregate,
                                            state["global_params"], stacked, sizes,
                                            weights_mask, draws)
                self._synchronize()
            if self._validation_due(broadcast_number):
                if self.cfg.validation_async:
                    self._inflight_validations.append(
                        (metrics, metrics["round"], self.validation.test_async(new_global)))
                else:
                    with timer.phase("validate"):
                        val_ok, val_metrics = self.validation.test(new_global)
                    metrics.update(val_metrics)
                    ok = ok and val_ok

        metrics["ok"] = ok
        metrics["phases"] = timer.durations
        new_state = dict(state)
        new_state["broadcasts"] = broadcast_number
        # the leak pool absorbs clean training only (selected inside the
        # round step); validation-failed rounds still leak (server.py:596-616)
        new_state["prev_genuine"] = new_genuine
        if train_ok:
            new_state["have_genuine"] = True
        if ok:
            new_state["global_params"] = new_global
            new_state["completed_rounds"] = state["completed_rounds"] + 1
        if self._numerics is not None:
            with timer.phase("numerics"):
                # dispatch only: the row lands in the ring; a failed round
                # is measured against the params it kept (zero drift)
                accepted = new_global if ok else state["global_params"]
                new_state["numerics"], _ = self._numerics_step(
                    state["numerics"], state["global_params"], accepted, stacked, sizes, loss,
                    ok, broadcast_number)
            self._numerics_drainer.note_round(metrics["round"], broadcast_number)
            self._numerics_drainer.maybe_drain(new_state["numerics"])
        return new_state, metrics

    def _run_hyper_round(self, state: dict[str, Any], broadcast_number: int,
                         metrics: dict[str, Any]) -> tuple[dict[str, Any], dict[str, Any]]:
        """Generate -> train -> attack -> hypernetwork update -> detect ->
        validate (JAX engine.py:1673-1800).  The hypernetwork and its Adam
        state change only when the round is ok; a detector removal rolls
        the round's update back and leaves the removed clients inactive
        for the rest of the run, and the round stays ok.  Its phases are
        JAX's ``train``, ``hyper_update`` (ending in a sync where JAX
        blocks), ``detect`` and ``validate``; a removal writes a
        ``rollback`` event and the detector's verdict an ``attribution``
        event (JAX engine.py:1715-1760)."""
        tel = self.telemetry
        timer = RoundTimer(tracer=tel.tracer)
        if self.attack_groups:
            metrics["attacks_active"] = active_attack_modes(
                self.attack_groups, broadcast_number, bool(state["have_genuine"]))
        with timer.phase("train"):
            leak_pool = None
            if self.detector is not None:
                # removed clients leave the leak pool; without the detector none is
                genuine = torch.as_tensor(self.genuine_idx, dtype=torch.int64)
                leak_pool = torch.nonzero(state["active_mask"][genuine] > 0)[:, 0].to(
                    self.device)
            active_mask = state["active_mask"].to(self.device)
            draws, (stacked, sizes, new_genuine, ok, loss) = self._dispatch(
                "round_step", self._drawn_round_step, state["hnet_params"],
                state["prev_genuine"], state["have_genuine"], state["rng"], broadcast_number,
                active_mask, leak_pool)
            ok = train_ok = bool(ok)
        metrics["train_loss"] = float(loss)
        if not train_ok:
            self._note_nan_round(metrics, stacked)

        hnet, opt = state["hnet_params"], state["hyper_opt_state"]
        new_active = state["active_mask"].clone()
        if ok:
            with timer.phase("hyper_update"):
                # dropped clients (size 0) skip their step
                hnet, opt = self._dispatch("hyper_update", self.hyper_update, hnet, opt,
                                           stacked, active_mask * (sizes > 0))
                self._synchronize()
            gen = None
            if self.detector is not None:
                with timer.phase("detect"):
                    gen, embeddings = self.hnet.generate_all(hnet)
                    selected = torch.nonzero(new_active > 0)[:, 0].tolist()
                    emb_np = embeddings[selected].cpu().numpy()
                    removals = self.detector.observe(broadcast_number, selected, emb_np)
                norms = np.linalg.norm(emb_np, axis=1)
                if tel.enabled:
                    metrics["embedding_norms"] = {
                        cid: round(float(v), 6) for cid, v in zip(selected, norms)}
                if removals:
                    print(f"Removing anomalies {removals}, rolling back", flush=True)
                    metrics["removed_clients"] = removals
                    tel.counters.inc("anomalies_removed", len(removals))
                    tel.events.emit("rollback", removed=list(removals),
                                    broadcast=broadcast_number)
                    new_active[removals] = 0.0
                    hnet, opt = state["hnet_params"], state["hyper_opt_state"]
                    gen = None
                if tel.enabled and self.attack_groups:
                    # the detector's verdict on the round's active clients; a
                    # round without removals is a negative verdict
                    active = set(active_attacker_indices(
                        self.attack_groups, broadcast_number, bool(state["have_genuine"])))
                    removed = {int(c) for c in removals}
                    metrics["defense_removed"] = len(removed)
                    tel.events.emit(
                        "attribution", round=metrics["round"], broadcast=broadcast_number,
                        mode=self.cfg.mode, source="hyper_detection",
                        attackers=[c for c in selected if c in active],
                        kept=[c for c in selected if c not in removed],
                        removed=sorted(removed),
                        non_reporting=[c for c in range(self.cfg.total_clients)
                                       if c not in set(selected)],
                        scores={str(c): round(float(v), 6) for c, v in zip(selected, norms)})
            if self._validation_due(broadcast_number):
                if gen is None:
                    gen, _ = self.hnet.generate_all(hnet)
                ids = torch.nonzero(new_active > 0)[:, 0].to(self.device)
                taken = pt.tree_take(gen, ids)
                if self.cfg.validation_async:
                    self._inflight_validations.append(
                        (metrics, metrics["round"], self.validation.test_hyper_async(taken)))
                else:
                    with timer.phase("validate"):
                        val_ok, val_metrics = self.validation.test_hyper(taken)
                    metrics.update(val_metrics)
                    ok = ok and val_ok

        metrics["ok"] = ok
        metrics["phases"] = timer.durations
        new_state = dict(state)
        new_state["broadcasts"] = broadcast_number
        new_state["prev_genuine"] = new_genuine
        if train_ok:
            new_state["have_genuine"] = True
        new_state["active_mask"] = new_active
        if ok:
            new_state["hnet_params"] = hnet
            new_state["hyper_opt_state"] = opt
            new_state["completed_rounds"] = state["completed_rounds"] + 1
        if self._numerics is not None:
            with timer.phase("numerics"):
                # `hnet` already reflects a rollback (zero drift); a failed
                # round keeps the old hypernetwork
                accepted = hnet if ok else state["hnet_params"]
                new_state["numerics"], _ = self._numerics_step(
                    state["numerics"], state["hnet_params"], accepted, stacked, sizes, loss,
                    ok, broadcast_number)
            self._numerics_drainer.note_round(metrics["round"], broadcast_number)
            self._numerics_drainer.maybe_drain(new_state["numerics"])
        return new_state, metrics

    # ------------------------------------------------------------------
    # the loop
    # ------------------------------------------------------------------

    def _consult_stop(self, stop: Callable[[int], Any] | None, completed_rounds) -> bool:
        """One consultation of the stop hook, shared by every executor
        (JAX engine.py:1050-1063): a truthy verdict stops the run, and a
        string verdict is kept as ``_stop_reason`` ("stopped" for any
        other).  The hook may raise; the run's ``finally`` drains."""
        if stop is None:
            return False
        verdict = stop(int(completed_rounds))
        if not verdict:
            return False
        self._stop_reason = verdict if isinstance(verdict, str) else "stopped"
        return True

    def run(self, num_rounds: int | None = None, state: dict[str, Any] | None = None,
            save_checkpoints: bool = True, verbose: bool = True, pipeline: bool | None = None,
            stop: Callable[[int], Any] | None = None,
            ) -> tuple[dict[str, Any], list[dict[str, Any]]]:
        """Run until ``num_rounds`` rounds complete (reference main loop,
        server.py:559-567), from ``state`` or else from
        :meth:`load_or_init_state`, saving a checkpoint after every ok
        round unless ``save_checkpoints`` is False.  Every exit, a
        crashing round included, goes through ``_finish_run`` (JAX
        engine.py:2634-2736).

        ``pipeline`` (default ``cfg.pipeline``) takes the depth-k
        pipelined executor (:meth:`_run_pipelined`, the depth resolved
        first by :meth:`resolve_pipeline_depth`); the modes without
        :meth:`supports_fused` fall back to this loop with a warning.
        ``stop``, if given, is called with the completed-round count
        before each round: a truthy verdict ends the run there."""
        num_rounds = num_rounds if num_rounds is not None else self.cfg.num_round
        state = self._place_on_mesh(self._ensure_numerics_state(
            state if state is not None else self.load_or_init_state()))
        self._stop_reason = None
        use_pipeline = self.cfg.pipeline if pipeline is None else pipeline
        depth = None
        if use_pipeline and self.supports_fused():
            # resolved before the run header, which records it
            depth = self.resolve_pipeline_depth(save_checkpoints)
        self._emit_run_header()
        if use_pipeline:
            if self.supports_fused():
                return self._run_pipelined(num_rounds, state, save_checkpoints, verbose,
                                           stop=stop, depth=depth)
            print_with_color(f"[pipeline] mode '{self.cfg.mode}' needs host-side per-round "
                             "work; falling back to the synchronous path.", "yellow")
        tel = self.telemetry
        history: list[dict[str, Any]] = []
        retries = 0
        t_start = time.perf_counter()
        self.logger.log_info("### Application start ###")
        self._start_monitor()
        try:
            while state["completed_rounds"] < num_rounds:
                if self._consult_stop(stop, state["completed_rounds"]):
                    break
                round_no = state["completed_rounds"] + 1
                self._maybe_start_profile(round_no, program="sync")
                state, metrics = self.run_round(state)
                history.append(metrics)
                self._note_round_faults(round_no, metrics["broadcast"])
                if self.monitor is not None:
                    self.monitor.record_round(metrics)
                self._maybe_stop_profile(int(state["completed_rounds"]))
                if metrics["ok"]:
                    retries = 0
                    if save_checkpoints:
                        self.save_checkpoint(state)
                    if verbose:
                        keys = [k for k in ("roc_auc", "accuracy", "nll", "train_loss")
                                if k in metrics]
                        msg = " ".join(f"{k}={metrics[k]:.4f}" for k in keys)
                        print(f"Round {round_no} done in {metrics['seconds']:.2f}s {msg}",
                              flush=True)
                else:
                    retries += 1
                    tel.counters.inc("rounds_failed")
                    tel.counters.inc("rounds_retried")
                    tel.events.emit("retry", round=round_no, retries=retries)
                    if verbose:
                        print("Training failed!", flush=True)
                    self.logger.log_warning(f"Round {round_no} failed (retry {retries})")
                    if retries > MAX_ROUND_RETRIES:
                        raise RuntimeError(
                            f"Round {round_no} failed {retries} times; aborting "
                            "(the reference would retry forever, server.py:546-556)")
        finally:
            self._finish_run(history, t_start, state)
        return state, history

    # ------------------------------------------------------------------
    # the fused multi-round path
    # ------------------------------------------------------------------

    def supports_fused(self) -> bool:
        """True when a broadcast needs no host-side work between its
        training and its acceptance (JAX engine.py:1812-1829): gmm and
        fltracer filter on the host, the hyper detector runs DBSCAN and a
        rollback on the host, and ``reload_parameters_per_round`` reads a
        file before every broadcast (hyper mode never reloads, so it
        keeps the fused path)."""
        if self.cfg.mode in ("gmm", "fltracer"):
            return False
        if self.is_hyper and self.detector is not None:
            return False
        if self.cfg.reload_parameters_per_round and not self.is_hyper:
            return False
        return True

    def _build_fused_body(self, include_eval: bool = True) -> Callable:
        """One broadcast as a step over the fused state (JAX
        ``_build_fused_body``, engine.py:1831-1984): ``body(state) ->
        (state, metrics)``, every metric a 0-dim device tensor.
        ``include_eval=False`` leaves the validation out (the pipeline
        under ``validation_async`` starts it beside the body): the
        metrics are then the train loss and ``ok``.

        The whole round runs: draws, the round step, then the aggregate
        (or the hypernetwork update) and, when the broadcast is due, the
        validation of its result.  ``ok`` is training ok, some client
        reported and the validation passed; a failed round keeps the old
        params by ``torch.where``, never by a host branch.  A train-failed
        round reports NaN metrics (the synchronous loop does not validate
        it); with ``validation_every > 1`` a skipped broadcast reports NaN
        metrics and carries no gate.  Validation gates the round here
        even under ``validation_async``, as JAX's fused chunk does.  The
        broadcast clock is a host int: it advances by one a broadcast.
        With numerics on, the metrics hold the round's ``numerics_row``
        (JAX engine.py:1925-1981)."""
        cfg = self.cfg
        validation = self.validation if include_eval else None
        # the numerics row is computed in the body, carried in the state's
        # ring and returned as metrics["numerics_row"], which the chunk's
        # and the pipelined round's existing copies bring to the host
        numerics = self._numerics is not None

        if not self.is_hyper:
            tail = build_plain_tail(cfg, self.device, self.aggregate, validation,
                                    self._numerics_step if numerics else None)

            def body(state):
                b = state["broadcasts"] + 1
                draws = self.draw_round(state["rng"])
                outputs = self.round_step(state["global_params"], state["prev_genuine"],
                                          state["have_genuine"], draws, b)
                return tail(state, b, draws, outputs)
            return body

        validate = validation_gate(cfg, self.device, validation)

        def body(state):
            b = state["broadcasts"] + 1
            draws = self.draw_round(state["rng"])
            active = state["active_mask"]
            hnet, opt = state["hnet_params"], state["hyper_opt_state"]
            stacked, sizes, new_gen, train_ok, loss = self.round_step(
                hnet, state["prev_genuine"], state["have_genuine"], active, draws, b)
            # dropped clients (size 0) skip their step
            new_hnet, new_opt = self.hyper_update(hnet, opt, stacked, active * (sizes > 0))
            ok, metrics = validate(
                b, train_ok, train_ok, loss,
                lambda: validation.test_hyper_async(self.hnet.generate_all(new_hnet)[0]))
            # Adam's step count is a host int, so that its bias
            # corrections are host floats: its select reads ok
            count = new_opt["count"] if bool(ok) else opt["count"]
            new_state = dict(
                state, hnet_params=torch.where(ok, new_hnet, hnet),
                hyper_opt_state={"count": count, "m": torch.where(ok, new_opt["m"], opt["m"]),
                                 "v": torch.where(ok, new_opt["v"], opt["v"])},
                prev_genuine=new_gen, have_genuine=state["have_genuine"] | train_ok,
                completed_rounds=state["completed_rounds"] + ok.to(torch.int64),
                broadcasts=b)
            if numerics:
                new_state["numerics"], metrics["numerics_row"] = self._numerics_step(
                    state["numerics"], hnet, new_state["hnet_params"], stacked, sizes, loss,
                    ok, b)
            return new_state, metrics
        return body

    def _fused_body(self, include_eval: bool) -> Callable:
        """The body for ``include_eval``, built on its first use only."""
        if include_eval not in self._fused_bodies:
            self._fused_bodies[include_eval] = self._build_fused_body(include_eval)
        return self._fused_bodies[include_eval]

    def _require_fused(self, state: dict[str, Any]) -> None:
        """Refuse the fused body where it would not run ``run``'s round."""
        if not self.supports_fused():
            raise ValueError(
                f"mode '{self.cfg.mode}' (hyper-detection="
                f"{self.is_hyper and self.detector is not None}) "
                "needs host-side per-round work; use run_round/run instead")
        if "active_mask" in state and not bool(torch.all(state["active_mask"] > 0)):
            # the fused hyper body validates every client's generated model;
            # the per-round path validates only the active ones
            raise ValueError(
                "state has inactive clients (resumed from a hyper-detection "
                "run?); use run_round/run for active-mask-aware validation")

    def _fused_state(self, state: dict[str, Any]) -> dict[str, Any]:
        """The fused carry of ``state`` without touching it: its own
        generator (a copy of the caller's), the completed-round count and
        the leak flag as device tensors (made by fills, not copies from
        the host), the broadcast clock a host int, the active mask on the
        device."""
        out = dict(state)
        rng = torch.Generator(device=self.device)
        rng.set_state(state["rng"].get_state())
        out["rng"] = rng
        done, have = state["completed_rounds"], state["have_genuine"]
        out["completed_rounds"] = (done if isinstance(done, torch.Tensor) else torch.full(
            (), int(done), dtype=torch.int64, device=self.device))
        out["have_genuine"] = (have if isinstance(have, torch.Tensor) else torch.full(
            (), bool(have), dtype=torch.bool, device=self.device))
        out["broadcasts"] = int(state["broadcasts"])
        if "active_mask" in out:
            out["active_mask"] = state["active_mask"].to(self.device)
        if self._numerics is None:
            # a state from a Simulator with numerics on
            out.pop("numerics", None)
        return out

    def _scan_chunk(self, num_broadcasts: int) -> Callable:
        """The program of a chunk: ``chunk(carry) -> (carry, rows)``,
        ``num_broadcasts`` calls of the fused body, one metrics row each."""
        body = self._fused_body(include_eval=True)

        def chunk(carry):
            rows = []
            for _ in range(num_broadcasts):
                carry, metrics = body(carry)
                rows.append(metrics)
            return carry, rows
        return chunk

    def run_scan(self, state: dict[str, Any], num_broadcasts: int
                 ) -> tuple[dict[str, Any], dict[str, torch.Tensor]]:
        """Run ``num_broadcasts`` broadcasts as device-side steps (JAX
        ``run_scan``, engine.py:2069-2103).  Returns ``(new_state,
        metrics)``: each metric a ``(num_broadcasts,)`` device tensor, the
        keys sorted as JAX's; in ``new_state`` the completed-round count
        and ``have_genuine`` are device tensors.  Failed rounds keep the
        previous params and the broadcast clock still advances, as in
        :meth:`run_round`.  The caller's ``state`` is left as it was."""
        self._require_fused(state)
        # the chunk is one program of num_broadcasts rounds (JAX engine.py:2016-2036)
        carry, rows = self._dispatch(f"fused_scan[{num_broadcasts}]",
                                     self._scan_chunk(num_broadcasts),
                                     self._fused_state(state),
                                     rounds_per_dispatch=num_broadcasts)
        if "active_mask" in carry:
            carry["active_mask"] = state["active_mask"]
        return carry, {k: torch.stack([r[k] for r in rows]) for k in sorted(rows[0])}

    @staticmethod
    def _read_chunk(state: dict[str, Any], metrics: dict[str, torch.Tensor]
                    ) -> tuple[dict[str, Any], dict[str, np.ndarray]]:
        """The chunk's one read of the card: its metrics (the numerics
        rows among them), the completed-round count and the leak flag in
        one float64 copy to the host (every value is exact in float64).
        Returns the state with those two as host values, as :meth:`run`
        keeps them, and the metrics as host arrays of their shapes."""
        keys = list(metrics)
        packed = torch.cat([metrics[k].to(torch.float64).reshape(-1) for k in keys]
                           + [torch.stack([state["completed_rounds"].to(torch.float64),
                                           state["have_genuine"].to(torch.float64)])]).cpu()
        values = packed.numpy()
        host, at = {}, 0
        for k in keys:
            size = metrics[k].numel()
            host[k] = values[at:at + size].reshape(tuple(metrics[k].shape))
            at += size
        state = dict(state, completed_rounds=int(values[-2]), have_genuine=bool(values[-1]))
        return state, host

    def run_fast(self, num_rounds: int | None = None, state: dict[str, Any] | None = None,
                 chunk_size: int | None = None, save_checkpoints: bool = True,
                 verbose: bool = True, progress: dict[str, Any] | None = None,
                 stop: Callable[[int], Any] | None = None,
                 ) -> tuple[dict[str, Any], list[dict[str, Any]]]:
        """Like :meth:`run`, on the fused path: chunks of broadcasts by
        :meth:`run_scan`, one read of the card per chunk (JAX ``run_fast``,
        engine.py:2105-2248).  Checkpoints land per chunk, not per round
        (``chunk_size=1`` for the reference's cadence); the retry cap is
        applied after each chunk.

        The chunk policy is JAX's: ``chunk_size`` chunks when given, else
        a first chunk of ``min(DEFAULT_SCAN_CHUNK, remaining)``, then full
        chunks while they fit, then chunks of one.  Each history entry
        holds the round's metrics and ``ok``, ``chunk_seconds`` (the
        chunk's wall time: a round's own time is not observed inside a
        chunk), ``chunk_len``, ``round`` (the attempt's index, continuing
        from a resumed state) and ``broadcast``.  ``progress``, if given,
        gets ``ok_rounds`` and ``interim_rounds_per_sec_incl_compile``
        after every chunk.  ``stop`` (see :meth:`run`) is consulted
        between chunks.  Writes nothing to ``app.log``, as JAX's.

        Each chunk runs under a ``chunk`` span and writes a ``chunk`` event
        and a ``round`` event per entry (JAX engine.py:2177-2221); its time
        ends at its one read of the card.  ``includes_compile`` is True
        for a chunk during which a CUDA kernel library was built or
        loaded or the cost model counted its program: the port compiles
        no per-program code.  A hotspot window opens at the chunk that
        reaches its first round and closes after the chunk that completes
        its last."""
        num_rounds = num_rounds if num_rounds is not None else self.cfg.num_round
        state = self._place_on_mesh(self._ensure_numerics_state(
            state if state is not None else self.load_or_init_state()))
        tel = self.telemetry
        self._stop_reason = None
        self._emit_run_header()
        history: list[dict[str, Any]] = []
        consecutive_failures = 0
        first_dispatch = True
        round_offset = int(state["completed_rounds"])
        t_start = time.perf_counter()
        self._start_monitor()
        try:
            while int(state["completed_rounds"]) < num_rounds:
                if self._consult_stop(stop, state["completed_rounds"]):
                    break
                remaining = num_rounds - int(state["completed_rounds"])
                cap = chunk_size if chunk_size else DEFAULT_SCAN_CHUNK
                if chunk_size:
                    n = min(chunk_size, remaining)
                elif first_dispatch or remaining >= cap:
                    n = min(cap, remaining)
                else:
                    n = 1
                first_dispatch = False
                libraries = build.load_library.cache_info().currsize
                profiles = len(self._program_profiles)
                done_before = int(state["completed_rounds"])
                self._maybe_start_profile(done_before + 1, done_before + n, program="fused")
                t0 = time.perf_counter()
                with tel.tracer.span("chunk", chunk_len=n):
                    state, metrics = self.run_scan(state, n)
                    state, host = self._read_chunk(state, metrics)
                elapsed = time.perf_counter() - t0
                tel.events.emit("chunk", chunk_len=n, seconds=round(elapsed, 6),
                                includes_compile=build.load_library.cache_info().currsize
                                > libraries or len(self._program_profiles) > profiles)
                # one numerics row a round, host values already (the
                # chunk's one read brought them)
                numerics_rows = host.pop("numerics_row", None)
                for i in range(n):
                    entry = {k: (bool(v[i]) if k == "ok" else float(v[i]))
                             for k, v in host.items()}
                    entry["chunk_seconds"] = elapsed
                    entry["chunk_len"] = n
                    entry["round"] = round_offset + len(history) + 1
                    entry["broadcast"] = state["broadcasts"] - n + i + 1
                    if numerics_rows is not None:
                        self._numerics_drainer.push_host_row(entry["round"], entry["broadcast"],
                                                             numerics_rows[i])
                    history.append(entry)
                    tel.events.round_event(entry)
                    self._note_round_faults(entry["round"], entry["broadcast"])
                    if self.monitor is not None:
                        # the chunk is one dispatch: its amortized per-round
                        # time feeds the stall median
                        self.monitor.record_round(entry, duration=elapsed / n)
                    if entry["ok"]:
                        consecutive_failures = 0
                    else:
                        consecutive_failures += 1
                        tel.counters.inc("rounds_failed")
                self._maybe_stop_profile(int(state["completed_rounds"]))
                if consecutive_failures > MAX_ROUND_RETRIES:
                    raise RuntimeError(
                        f"round failed {consecutive_failures} times in a row; aborting "
                        "(the reference would retry forever, server.py:546-556)")
                if progress is not None:
                    ok_so_far = sum(1 for h in history if h["ok"])
                    progress["ok_rounds"] = ok_so_far
                    progress["interim_rounds_per_sec_incl_compile"] = round(
                        ok_so_far / (time.perf_counter() - t_start), 4)
                if save_checkpoints:
                    self.save_checkpoint(state)
                if verbose:
                    last = history[-1]
                    keys = [k for k in ("roc_auc", "accuracy", "nll", "train_loss") if k in last]
                    msg = " ".join(f"{k}={last[k]:.4f}" for k in keys)
                    print_with_color(
                        f"[fast] {state['completed_rounds']}/{num_rounds} rounds, chunk of {n} "
                        f"in {elapsed:.2f}s ({elapsed / n:.3f}s/round) {msg}", "green")
        finally:
            self._finish_run(history, t_start, state)
        return state, history

    # ------------------------------------------------------------------
    # the pipelined executor
    # ------------------------------------------------------------------

    def resolve_pipeline_depth(self, save_checkpoints: bool = True) -> int:
        """``cfg.pipeline_depth`` as the depth of this run (JAX
        engine.py:2254-2328).  An int is used as it is.  ``"auto"`` takes
        :func:`auto_depth_from_records` over the cross-run ledger's
        records (this Simulator's store, else the ledger directory when it
        exists; a read that fails is kept in ``_depth_info["error"]``):
        with no measurement it is depth 1, said in a yellow line.  The
        pick is capped by :data:`AUTO_DEPTH_CAP`, by ``numerics_window``
        with numerics on (the rows resolve up to k rounds late), and by 2
        under a synchronous checkpoint every round (a deeper queue waits
        behind the write).  The depth and how it was found stay in
        ``_depth_resolved`` and ``_depth_info``."""
        configured = self.cfg.pipeline_depth
        if isinstance(configured, int):
            self._depth_resolved = configured
            self._depth_info = {"source": "config", "depth": configured}
            return configured
        info: dict[str, Any] = {"source": "auto"}
        k: int | None = None
        try:
            if self._ledger is not None:
                records, _ = self._ledger.load()
            else:
                directory = resolve_ledger_dir(self.cfg.telemetry.ledger_dir or None,
                                               base=self.telemetry.base_dir)
                # never create a ledger directory to find it empty
                records = (LedgerStore(directory).load()[0] if os.path.isdir(directory)
                           else [])
            k, measured = auto_depth_from_records(records, self.checkpoints.fingerprint)
            info.update(measured)
        except Exception as e:  # noqa: BLE001 — auto must never fail the run
            info["error"] = f"{type(e).__name__}: {e}"[:200]
        if k is None:
            k = 1
            print_with_color(
                "[pipeline] depth auto: no ledger measurement for this config yet — "
                "defaulting to depth-1 (a run with telemetry.ledger on feeds the "
                "auto-tuner)", "yellow")
        cap = AUTO_DEPTH_CAP
        if self._numerics is not None:
            cap = min(cap, self.cfg.telemetry.numerics_window)
        if save_checkpoints and not self.cfg.checkpoint_async:
            cap = min(cap, 2)
        if k > cap:
            info["clamped_from"] = k
            k = cap
        info["depth"] = k
        self._depth_resolved = k
        self._depth_info = info
        if "ratio" in info:
            print_with_color(
                f"[pipeline] depth auto -> {k} (measured host/device ratio {info['ratio']} "
                f"over {info['peers']} ledger record(s)"
                + (f", clamped from {info['clamped_from']}" if "clamped_from" in info else "")
                + ")", "cyan")
        return k

    def _dispatch_pipeline_round(self, body: Callable, carry: dict[str, Any],
                                 keep_state: bool, include_eval: bool
                                 ) -> tuple[dict[str, Any], dict[str, Any]]:
        """Issue one round (``body`` on ``carry``) and, under
        ``validation_async`` on a due broadcast, its evaluation; then
        copy the round's metrics, the evaluation's, the leak flag and the
        numerics row into host memory behind an event, without waiting.  Returns the new
        carry and the queue slot.  With ``keep_state`` the slot keeps the
        round's state for its checkpoint: the body writes no tensor of
        the state it is given, and the generator, which it advances in
        place, is kept as its state after this round.  The body is the
        program ``pipeline_step[eval=...]`` (JAX engine.py:2358-2376)."""
        carry, metrics = self._dispatch(f"pipeline_step[eval={include_eval}]", body, carry)
        b = carry["broadcasts"]
        val: dict[str, torch.Tensor] = {}
        if (self.validation is not None and self.cfg.validation_async
                and b % self.cfg.validation_every == 0):
            if self.is_hyper:
                gen, _ = self.hnet.generate_all(carry["hnet_params"])
                val = self.validation.test_hyper_async(gen)
            else:
                val = self.validation.test_async(carry["global_params"])
        row = metrics.pop("numerics_row", None)
        keys, val_keys = sorted(metrics), sorted(val)
        packed = torch.stack([t.to(torch.float64) for t in (
            [metrics[k] for k in keys] + [val[k] for k in val_keys] + [carry["have_genuine"]])])
        if row is not None:
            packed = torch.cat([packed, row.to(torch.float64)])
        # a blocking read would wait for every round queued after this one
        # as well: the copy goes to pinned memory and the resolve waits on
        # this round's event alone (on the CPU the copy is done at once)
        on_card = packed.device.type == "cuda"
        host = torch.empty(packed.shape, dtype=torch.float64, pin_memory=on_card)
        host.copy_(packed, non_blocking=True)
        event = None
        if on_card:
            event = torch.cuda.Event()
            event.record()
        slot = {"keys": keys, "val_keys": val_keys, "host": host, "event": event,
                "broadcast": b,
                "state": dict(carry, rng=carry["rng"].get_state()) if keep_state else None}
        return carry, slot

    def _resolve_pipeline_round(self, pending: dict[str, Any], round_no: int
                                ) -> tuple[dict[str, Any], bool]:
        """One round's history entry, and its leak flag, once its copy has
        landed (JAX ``_resolve_pipeline_round``, engine.py:2380-2404): the
        metrics (``ok`` a bool, the rest floats), ``round``,
        ``broadcast``, ``pipelined``; the numerics row goes to the drainer
        from the same copy; an async validation is folded in through
        ``_inflight_validations``, its verdict not gating the round."""
        if pending["event"] is not None:
            pending["event"].synchronize()
        values = pending["host"].tolist()
        keys, val_keys = pending["keys"], pending["val_keys"]
        entry: dict[str, Any] = {k: (bool(v) if k == "ok" else float(v))
                                 for k, v in zip(keys, values)}
        entry["round"] = round_no
        entry["broadcast"] = pending["broadcast"]
        entry["pipelined"] = True
        n = len(keys) + len(val_keys)
        if len(values) > n + 1:
            self._numerics_drainer.push_host_row(round_no, pending["broadcast"],
                                                 np.asarray(values[n + 1:]))
        if val_keys:
            out = dict(zip(val_keys, values[len(keys):n]))
            self._inflight_validations.append((entry, round_no, out))
            self._resolve_inflight_validations()
        return entry, bool(values[n])

    def _checkpoint_slot(self, slot_state: dict[str, Any], completed: int,
                         have_genuine: bool, active_mask) -> None:
        """Save a resolved round's own state as ``run`` holds it: the
        round count from the host's resolved count, the generator as it
        was after that round."""
        rng = torch.Generator(device=self.device)
        rng.set_state(slot_state["rng"])
        state = dict(slot_state, rng=rng, completed_rounds=completed,
                     have_genuine=have_genuine)
        if active_mask is not None:
            state["active_mask"] = active_mask
        self.save_checkpoint(state)

    def _run_pipelined(self, num_rounds: int, state: dict[str, Any], save_checkpoints: bool,
                       verbose: bool, stop: Callable[[int], Any] | None = None,
                       depth: int | None = None,
                       ) -> tuple[dict[str, Any], list[dict[str, Any]]]:
        """The depth-k software-pipelined round loop (JAX
        ``_run_pipelined``, engine.py:2406-2628).

        Every round is one call of the one cached fused body (validation
        inlined, unless ``validation_async`` starts it beside the body),
        and up to ``depth`` rounds stay in flight beyond the oldest
        unresolved one; rounds resolve in dispatch order.  Acceptance is
        the body's ``torch.where``, so the rounds dispatched after a
        rollback already trained from the kept params, as ``run``'s retry
        does: the final state equals ``run``'s at every depth.  Depth 0
        resolves each round before the next dispatch; None resolves the
        depth from the config (:meth:`resolve_pipeline_depth`).  Each ok
        round's own state is checkpointed when it resolves.

        After ``cfg.pipeline_demote_after`` consecutive rollbacks the loop
        demotes to depth 0: no dispatch until the queue drains, then one
        round at a time; after ``cfg.pipeline_repromote_after`` clean
        rounds it returns to the configured depth.  Neither builds
        anything: every depth calls the same body.  ``stop`` is consulted
        before each dispatch; once it says stop, nothing more is
        dispatched and the rounds in flight resolve and checkpoint.
        Returns the state as ``run`` returns it (the round count and the
        leak flag host values) and the history.

        Each dispatch and each resolve runs under its span; a round's
        ``round`` event and a failed round's ``retry`` are written when it
        resolves, and each demotion and re-promotion writes a ``degrade``
        event (JAX engine.py:2498-2610).  Nothing is read on the dispatch
        side."""
        cfg = self.cfg
        tel = self.telemetry
        if depth is None:
            depth = self.resolve_pipeline_depth(save_checkpoints)
        self._require_fused(state)
        history: list[dict[str, Any]] = []
        t_start = time.perf_counter()
        include_eval = self.validation is not None and not cfg.validation_async
        body = self._fused_body(include_eval)
        carry = self._fused_state(state)
        completed = int(state["completed_rounds"])
        have_genuine = bool(state["have_genuine"])
        active_mask = state.get("active_mask")
        # unresolved rounds in dispatch order: at most overlap() + 1 slots
        queue: deque[dict[str, Any]] = deque()
        consecutive_failures = 0
        degraded = False
        clean_streak = 0
        last_resolve = time.perf_counter()
        self._start_monitor()
        if self.monitor is not None:
            self.monitor.set_pipeline_depth(depth)

        def overlap() -> int:
            """Rounds allowed in flight beyond the resolving one."""
            return 0 if degraded else depth

        stopping = False
        try:
            while completed < num_rounds or queue:
                stopping = stopping or self._consult_stop(stop, completed)
                if stopping and not queue:
                    break
                want_more = completed + len(queue) < num_rounds and not stopping
                if want_more and len(queue) <= overlap():
                    target_round = completed + len(queue) + 1
                    self._maybe_start_profile(target_round, program="pipelined")
                    with tel.tracer.span("dispatch", round=target_round,
                                         broadcast=carry["broadcasts"] + 1):
                        carry, slot = self._dispatch_pipeline_round(body, carry,
                                                                    save_checkpoints,
                                                                    include_eval)
                    queue.append(slot)
                    want_more = completed + len(queue) < num_rounds and not stopping
                # resolve the oldest round once the queue is past its
                # overlap, or while draining (the stop hook or the tail)
                if queue and (len(queue) > overlap() or not want_more):
                    pending = queue.popleft()
                    round_no = completed + 1
                    with tel.tracer.span("resolve", round=round_no):
                        entry, have_genuine = self._resolve_pipeline_round(pending, round_no)
                    now = time.perf_counter()
                    entry["seconds"] = now - last_resolve
                    last_resolve = now
                    if degraded:
                        entry["degraded"] = True
                    history.append(entry)
                    tel.events.round_event(entry)
                    self._note_round_faults(round_no, pending["broadcast"])
                    if self.monitor is not None:
                        self.monitor.record_round(entry)
                    if entry["ok"]:
                        completed += 1
                        consecutive_failures = 0
                        if save_checkpoints:
                            self._checkpoint_slot(pending["state"], completed, have_genuine,
                                                  active_mask)
                        if degraded:
                            clean_streak += 1
                            if clean_streak >= cfg.pipeline_repromote_after:
                                degraded = False
                                clean_streak = 0
                                tel.counters.inc("executor_repromotions")
                                tel.events.emit("degrade", state="repromoted", round=round_no,
                                                depth=depth,
                                                clean_rounds=cfg.pipeline_repromote_after)
                                if self.monitor is not None:
                                    self.monitor.set_degraded(None)
                                    self.monitor.set_pipeline_depth(depth)
                                print_with_color(
                                    f"[pipeline] re-promoted to depth-{depth} after "
                                    f"{cfg.pipeline_repromote_after} clean rounds", "cyan")
                        if verbose:
                            keys = [k for k in ("roc_auc", "accuracy", "nll", "train_loss")
                                    if k in entry and entry[k] == entry[k]]
                            msg = " ".join(f"{k}={entry[k]:.4f}" for k in keys)
                            print_with_color(f"[pipeline] round {round_no} resolved in "
                                             f"{entry['seconds']:.2f}s {msg}", "green")
                    else:
                        consecutive_failures += 1
                        clean_streak = 0
                        tel.counters.inc("rounds_failed")
                        tel.counters.inc("rounds_retried")
                        tel.events.emit("retry", round=round_no, retries=consecutive_failures)
                        print_with_color("Training failed!", "yellow")
                        self.logger.log_warning(
                            f"Round {round_no} failed (retry {consecutive_failures})")
                        if not degraded and consecutive_failures >= cfg.pipeline_demote_after:
                            degraded = True
                            info = {"round": round_no,
                                    "consecutive_failures": consecutive_failures, "depth": 0,
                                    "configured_depth": depth, "in_flight": len(queue)}
                            tel.counters.inc("executor_demotions")
                            tel.events.emit("degrade", state="demoted", **info)
                            if self.monitor is not None:
                                self.monitor.set_degraded(info)
                                self.monitor.set_pipeline_depth(0)
                            print_with_color(
                                f"[pipeline] {consecutive_failures} consecutive rollbacks — "
                                f"demoting from depth-{depth} to synchronous (depth-0) "
                                "resolution", "yellow")
                        if consecutive_failures > MAX_ROUND_RETRIES:
                            raise RuntimeError(
                                f"Round {round_no} failed {consecutive_failures} times; "
                                "aborting (the reference would retry forever, "
                                "server.py:546-556)")
                self._maybe_stop_profile(completed)
        finally:
            if self.monitor is not None and degraded:
                self.monitor.set_degraded(None)
            self._finish_run(history, t_start, carry)
        out = dict(carry, completed_rounds=completed, have_genuine=have_genuine)
        if active_mask is not None:
            out["active_mask"] = active_mask
        return out, history

    def _finish_run(self, history: list[dict[str, Any]], t_start: float,
                    state: dict[str, Any] | None = None) -> None:
        """The end of every run (JAX engine.py:1213-1246): resolve the
        validations in flight, drain the numerics rows still in
        ``state``'s ring (the synchronous path's), drain the async writer,
        so the last submitted state is on disk when ``run`` returns or
        raises, then write the counters, ``run_end`` and the trace and
        append the ledger record, a crashing run's included.  A drain
        error is raised after the rest is done."""
        drain_error: BaseException | None = None
        try:
            self._resolve_inflight_validations()
            if self._numerics_drainer is not None and state is not None:
                self._numerics_drainer.drain(state.get("numerics"))
        finally:
            if self.checkpoint_writer is not None:
                try:
                    self.checkpoint_writer.drain()
                except BaseException as e:  # noqa: BLE001 — raised below
                    drain_error = e
            try:
                self._emit_run_end(history, t_start)
                self._append_ledger_record()
            finally:
                if drain_error is not None:
                    raise drain_error
