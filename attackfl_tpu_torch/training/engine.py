"""The Simulator: the in-process federation engine (the port's
``attackfl_tpu/training/engine.py``, synchronous executor).

One Python loop around the round program: sample -> train -> attack ->
defend and aggregate -> validate -> accept or retry.  A failed round
(client NaN, no client left after the defense, or failed validation) is
retried without decrementing the remaining-round counter (reference
server.py:546-563), at most ``MAX_ROUND_RETRIES`` times in a row; the
attack clock advances per broadcast (the client-side counter,
RpcClient.py:72).

The port runs on one device and draws its randomness from
``torch.Generator``s: model init from a CPU generator seeded with
``random_seed`` (so CPU and GPU runs start from the same weights), round
draws from a generator on the run's device.

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
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any

import numpy as np
import torch

from attackfl_tpu_torch.config import Config
from attackfl_tpu_torch.data.partition import dirichlet_label_partition, draw_round
from attackfl_tpu_torch.data.synthetic import get_dataset
from attackfl_tpu_torch.device import resolve_device
from attackfl_tpu_torch.eval.validation import Validation
from attackfl_tpu_torch.faults.inject import HostFaultInjector
from attackfl_tpu_torch.models.hyper import make_hypernetwork
from attackfl_tpu_torch.ops import defenses
from attackfl_tpu_torch.ops import pytree as pt
from attackfl_tpu_torch.registry import get_model
from attackfl_tpu_torch.training.hyper import build_hyper_round, build_hyper_update
from attackfl_tpu_torch.training.round import (
    ROOT_SIZE, attacking_groups, build_aggregator, build_attack_groups, build_round_step,
    leak_size,
)
from attackfl_tpu_torch.utils import checkpoint as ckpt
from attackfl_tpu_torch.utils.fingerprint import config_fingerprint

MAX_ROUND_RETRIES = 20
log = logging.getLogger("attackfl_tpu_torch")


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
    for hyper and for a compute-dtype other than float32).  The pipelined
    executor is queue 1, item 13."""
    if MODEL_DATA.get(cfg.model) != cfg.data_name:
        raise ValueError(f"model {cfg.model!r} does not run on {cfg.data_name!r}; the "
                         f"models and their datasets: {MODEL_DATA}")
    if cfg.pipeline:
        _refuse("the pipelined executor", "item 13")
    if cfg.mesh.num_devices > 1:
        _refuse("the multi-GPU client axis", "item 14")
    tel = cfg.telemetry
    if tel.monitor or tel.numerics or tel.profile_rounds or tel.hotspots:
        _refuse("telemetry (monitor, numerics, profiling windows)", "item 16")


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


class Simulator:
    """End-to-end federated simulation of one Config on one device."""

    def __init__(self, cfg: Config, device: str | torch.device = "cuda"):
        check_slice(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
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
        self.validation = (Validation(self.model, cfg.data_name, test_np, self.device, log)
                           if cfg.validation else None)
        self.num_params = sum(x.numel() for x in self.model.parameters())
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
                                                self.attack_groups, self.genuine_idx, self.hnet)
            self.hyper_update, self.hyper_opt = build_hyper_update(cfg, self.hnet)
            if cfg.hyper_detection.enable:
                hd = cfg.hyper_detection
                self.detector = defenses.HyperDetector(
                    cfg.total_clients, hd.cosine_search, hd.n_components, hd.eps,
                    hd.min_samples, hd.start_round,
                    save_path=os.path.join(cfg.log_path, "all_embeddings.npy"))
        else:
            self.round_step = build_round_step(self.model, cfg, self.train_data,
                                               self.attack_groups, self.genuine_idx)
            self.aggregate = build_aggregator(self.model, cfg, self.test_data)
        # the plan's host-side faults (the device-side ones are in round_step)
        self.fault_injector = HostFaultInjector(cfg.faults) if cfg.faults else None
        # temp files of killed writes go before any new checkpoint activity
        swept = ckpt.sweep_orphans(cfg.checkpoint_dir)
        if swept:
            print(f"[checkpoint] swept {len(swept)} orphaned temp file(s) from "
                  f"{cfg.checkpoint_dir or '.'}", flush=True)
        self.checkpoints = ckpt.CheckpointManager(
            ckpt.checkpoint_path(cfg), fingerprint=config_fingerprint(cfg),
            keep=cfg.checkpoint_keep, fresh=not (cfg.resume or cfg.load_parameters),
            injector=self.fault_injector)
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
        checkpoint of the other class fails the structure check."""
        host = {**state, "rng": state["rng"].get_state()}
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
        for entry, reason in result.rejected:
            print(f"[resume] rejected checkpoint {entry.get('file')}: {reason[:200]}",
                  flush=True)
        if result.state is None:
            print("[resume] no valid checkpoint entry found under "
                  f"{self.checkpoints.directory!r}; starting fresh", flush=True)
            return None
        manifest = result.manifest or {}
        if manifest.get("fingerprint") and manifest["fingerprint"] != self.checkpoints.fingerprint:
            log.warning("[resume] config fingerprint mismatch: this checkpoint was written "
                        "under another experiment config; resuming because the state "
                        "structure matched, but verify the config")
        state = self.restore_state(result.state)
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

    def save_checkpoint(self, state: dict[str, Any]) -> bool:
        """Persist ``state`` as a round-stamped entry, the alias and the
        manifest record; False when the write failed open.  With
        ``checkpoint_async`` the host snapshot is taken here, on the round
        loop, and handed to the writer's thread: True once submitted."""
        meta = {"round": state["completed_rounds"], "broadcast": state["broadcasts"]}
        writer = self.checkpoint_writer
        if self.fault_injector is not None:
            self.fault_injector.maybe_kill_writer(meta["round"], writer)
        if writer is None:
            return self.checkpoints.write(self.host_state(state), meta)
        writer.submit(self.checkpoints.path, ckpt.host_snapshot(self.host_state(state)), meta)
        return True

    def _on_writer_restart(self, restarts: int) -> None:
        """The writer's supervisor revived a dead thread."""
        log.warning("fault %s", json.dumps({"fault": "writer_death", "action": "recovered",
                                             "restarts": restarts}))

    def close(self) -> None:
        """Drain and stop the async checkpoint writer.  Safe to call twice;
        the Simulator still runs afterwards, saving synchronously."""
        if self.checkpoint_writer is not None:
            self.checkpoint_writer.close()
            self.checkpoint_writer = None

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
        return dict(state, global_params=self._reload_cache[1])

    def draw_round(self, gen: torch.Generator, leak_pool: torch.Tensor | None = None):
        """One round's draws; ``leak_pool``: under hyper mode's detector,
        the active genuine positions, drawn with replacement (JAX
        hyper.py:138-164)."""
        lo, hi = self.cfg.num_data_range
        firing = attacking_groups(self.attack_groups)
        return draw_round(
            gen, num_clients=self.cfg.total_clients, pool_size=self.pool_size,
            lo=lo, hi=hi, epochs=self.cfg.epochs, num_genuine=len(self.genuine_idx),
            leak_groups=[len(g.indices) for g in firing], leak_k=self.leak_k,
            client_pools=self.client_pools, dropout_rate=self.cfg.client_dropout_rate,
            noise_groups=[len(g.indices) for g in firing if g.mode == "Random"],
            num_params=self.num_params, quantize=self.cfg.mode == "scionfl",
            root_size=(min(ROOT_SIZE, self.test_data["label"].shape[0])
                       if self.cfg.mode == "FLTrust" else 0),
            leak_pool=leak_pool)

    # ------------------------------------------------------------------
    # one round
    # ------------------------------------------------------------------

    def _validation_due(self, broadcast_number: int) -> bool:
        return (self.validation is not None
                and broadcast_number % self.cfg.validation_every == 0)

    def _resolve_inflight_validations(self) -> None:
        """Read the async validations in flight and fold each into its
        round's history entry, with ``validation_ok``; the verdict does
        not gate the round (JAX engine.py:1358-1373)."""
        while self._inflight_validations:
            entry, round_no, out = self._inflight_validations.pop(0)
            val_ok, val_metrics = self.validation.resolve_async(out)
            entry.update(val_metrics)
            entry["validation_ok"] = val_ok
            if not val_ok:
                log.warning("async validation of round %d failed: %s", round_no, val_metrics)

    def run_round(self, state: dict[str, Any]) -> tuple[dict[str, Any], dict[str, Any]]:
        """Broadcast -> train -> attack -> defend and aggregate -> validate.

        Returns (new_state, metrics).  On failure (``metrics["ok"]``
        False) the new state keeps the previous global params but advances
        the generator, the broadcast clock and the genuine-leak pool
        (reference retry path, server.py:546-567)."""
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
        if self.is_hyper:
            new_state, metrics = self._run_hyper_round(state, broadcast_number, metrics)
        else:
            new_state, metrics = self._run_plain_round(state, broadcast_number, metrics)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        metrics["seconds"] = time.perf_counter() - t0
        return new_state, metrics

    def _run_plain_round(self, state: dict[str, Any], broadcast_number: int,
                         metrics: dict[str, Any]) -> tuple[dict[str, Any], dict[str, Any]]:
        draws = self.draw_round(state["rng"])
        stacked, sizes, new_genuine, ok, loss = self.round_step(
            state["global_params"], state["prev_genuine"], state["have_genuine"],
            draws, broadcast_number)
        ok = train_ok = bool(ok)
        metrics["train_loss"] = float(loss)

        weights_mask = torch.ones(self.cfg.total_clients, device=self.device)
        if ok and self.cfg.mode in ("gmm", "fltracer"):
            keep, filter_metrics = host_filter(self.cfg.mode, stacked, self.attacker_mask,
                                               self.cfg.random_seed)
            metrics.update(filter_metrics)
            # the round fails when no client survives (server.py:369-372)
            ok = bool(keep.any())
            weights_mask = torch.as_tensor(keep, dtype=torch.float32, device=self.device)
        # the defense's survivors that reported: with stragglers a filter can
        # keep only dropped (size-0) clients, and a weighted mean would be 0/0
        weights_mask = weights_mask * (sizes > 0)
        if ok and not bool(torch.any(weights_mask > 0)):
            ok = False
        new_global = state["global_params"]
        if ok:
            new_global = self.aggregate(state["global_params"], stacked, sizes,
                                        weights_mask, draws)
            if self._validation_due(broadcast_number):
                if self.cfg.validation_async:
                    self._inflight_validations.append(
                        (metrics, metrics["round"], self.validation.test_async(new_global)))
                else:
                    val_ok, val_metrics = self.validation.test(new_global)
                    metrics.update(val_metrics)
                    ok = ok and val_ok

        metrics["ok"] = ok
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
        return new_state, metrics

    def _run_hyper_round(self, state: dict[str, Any], broadcast_number: int,
                         metrics: dict[str, Any]) -> tuple[dict[str, Any], dict[str, Any]]:
        """Generate -> train -> attack -> hypernetwork update -> detect ->
        validate (JAX engine.py:1673-1800).  The hypernetwork and its Adam
        state change only when the round is ok; a detector removal rolls
        the round's update back and leaves the removed clients inactive
        for the rest of the run, and the round stays ok."""
        leak_pool = None
        if self.detector is not None:
            # removed clients leave the leak pool; without the detector none is
            genuine = torch.as_tensor(self.genuine_idx, dtype=torch.int64)
            leak_pool = torch.nonzero(state["active_mask"][genuine] > 0)[:, 0].to(self.device)
        draws = self.draw_round(state["rng"], leak_pool)
        active_mask = state["active_mask"].to(self.device)
        stacked, sizes, new_genuine, ok, loss = self.round_step(
            state["hnet_params"], state["prev_genuine"], state["have_genuine"], active_mask,
            draws, broadcast_number)
        ok = train_ok = bool(ok)
        metrics["train_loss"] = float(loss)

        hnet, opt = state["hnet_params"], state["hyper_opt_state"]
        new_active = state["active_mask"].clone()
        if ok:
            # dropped clients (size 0) skip their step
            hnet, opt = self.hyper_update(hnet, opt, stacked, active_mask * (sizes > 0))
            gen = None
            if self.detector is not None:
                gen, embeddings = self.hnet.generate_all(hnet)
                selected = torch.nonzero(new_active > 0)[:, 0].tolist()
                removals = self.detector.observe(broadcast_number, selected,
                                                 embeddings[selected].cpu().numpy())
                if removals:
                    print(f"Removing anomalies {removals}, rolling back", flush=True)
                    metrics["removed_clients"] = removals
                    new_active[removals] = 0.0
                    hnet, opt = state["hnet_params"], state["hyper_opt_state"]
                    gen = None
            if self._validation_due(broadcast_number):
                if gen is None:
                    gen, _ = self.hnet.generate_all(hnet)
                ids = torch.nonzero(new_active > 0)[:, 0].to(self.device)
                taken = pt.tree_take(gen, ids)
                if self.cfg.validation_async:
                    self._inflight_validations.append(
                        (metrics, metrics["round"], self.validation.test_hyper_async(taken)))
                else:
                    val_ok, val_metrics = self.validation.test_hyper(taken)
                    metrics.update(val_metrics)
                    ok = ok and val_ok

        metrics["ok"] = ok
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
        return new_state, metrics

    # ------------------------------------------------------------------
    # the loop
    # ------------------------------------------------------------------

    def run(self, num_rounds: int | None = None, state: dict[str, Any] | None = None,
            save_checkpoints: bool = True, verbose: bool = True,
            ) -> tuple[dict[str, Any], list[dict[str, Any]]]:
        """Run until ``num_rounds`` rounds complete (reference main loop,
        server.py:559-567), from ``state`` or else from
        :meth:`load_or_init_state`, saving a checkpoint after every ok
        round unless ``save_checkpoints`` is False.  Every exit, a
        crashing round included, goes through ``_finish_run`` (JAX
        engine.py:2634-2736)."""
        num_rounds = num_rounds if num_rounds is not None else self.cfg.num_round
        state = state if state is not None else self.load_or_init_state()
        history: list[dict[str, Any]] = []
        retries = 0
        try:
            while state["completed_rounds"] < num_rounds:
                round_no = state["completed_rounds"] + 1
                state, metrics = self.run_round(state)
                history.append(metrics)
                if self.fault_injector is not None:
                    self.fault_injector.note_round_resolved(metrics["broadcast"])
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
                    if verbose:
                        print("Training failed!", flush=True)
                    log.warning("Round %d failed (retry %d)", round_no, retries)
                    if retries > MAX_ROUND_RETRIES:
                        raise RuntimeError(
                            f"Round {round_no} failed {retries} times; aborting "
                            "(the reference would retry forever, server.py:546-556)")
        finally:
            self._finish_run()
        return state, history

    def _finish_run(self) -> None:
        """The end of every run (JAX engine.py:1213-1246): resolve the
        validations in flight, then drain the async writer, so the last
        submitted state is on disk when ``run`` returns or raises.  A
        drain error is raised after the rest is done."""
        try:
            self._resolve_inflight_validations()
        finally:
            if self.checkpoint_writer is not None:
                self.checkpoint_writer.drain()
