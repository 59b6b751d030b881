"""Two-process runs for the port's multi-process tests: spawning the ranks,
and the ranks' own code.

The tests start each rank as a fresh interpreter (``python
tests/_torch_port_spmd.py <command> ...``), every rank on one torch thread
(the one-thread fixture of ``_torch_port_threads.py`` does not reach a
child), with a finite ``communicate`` timeout and a kill in ``finally``,
as ``tests/test_multihost.py`` does, so a rank that dies never leaves the
suite waiting.  A rank writes what it computed with ``torch.save`` into
the directory it was given; the test compares.

Commands (each run by every rank, ``<coordinator> <rank> <out>`` first):

* ``battery`` -- the port over a mesh of 2 processes x 4 ``cpu`` shards
  (:func:`scenarios`): run, run_fast, the pipeline, one hyper round, every
  defense's sharded aggregation on one round's rows, a 2 x 2 x 1 sweep
  with its grid checkpoint, and the collectives' gradients checked in
  float64; then, given a launch directory of ``cli`` ranks, a
  ``load_parameters`` restart from process 0's broadcast bytes;
* ``port-round`` -- the port's two-process round step at the JAX
  driver's geometry in float64 on the draws a file hands over, and one
  telemetry-on run (``tests/test_torch_port_multiprocess_jax.py``);
* ``jax-round`` -- the JAX package's two-process run of the same step and
  the same telemetry-on run, over ``jax.distributed`` with its gloo CPU
  collectives switched on (4 virtual CPU devices a process).
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
RANKS = 2
# shards a rank holds in the port's battery: 2 x 4 against one process of 8
LOCAL_SHARDS = 4
# JAX's two-process driver geometry (tests/_multihost_driver.py:31-50)
GEOMETRY = dict(total_clients=16, model="CNNModel", data_name="ICU", num_data_range=(24, 32),
                epochs=1, batch_size=16, train_size=128, test_size=64, validation=True)
LIE = dict(mode="LIE", num_clients=4, attack_round=1)


# ---------------------------------------------------------------------------
# spawning (the test process)
# ---------------------------------------------------------------------------

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def child_env(**extra: str) -> dict:
    """The rank's environment: one thread for torch and OpenMP, the repo
    and the tests on the path, JAX on the CPU, telemetry where each
    config puts it (the suite's own telemetry directory left out)."""
    env = {**os.environ, "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
           "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join([REPO, HERE, os.environ.get("PYTHONPATH", "")])}
    env.pop("ATTACKFL_TELEMETRY_DIR", None)
    env.update(extra)
    return env


def spawn(argvs: list[list[str]], env: dict | None = None, cwds: list | None = None
          ) -> list[subprocess.Popen]:
    """One process per argv, started together."""
    return [subprocess.Popen(argv, env=env or child_env(), cwd=(cwds or [None] * len(argvs))[i],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for i, argv in enumerate(argvs)]


def finish(procs: list[subprocess.Popen], timeout: float) -> list[tuple[int, str, str]]:
    """Each process's (returncode, stdout, stderr); every one still
    running at the end is killed."""
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def rank_argvs(command: str, out: str, *extra: str) -> list[list[str]]:
    """``command``'s argv for every rank, one fresh coordinator port."""
    coordinator = f"127.0.0.1:{free_port()}"
    return [[sys.executable, os.path.abspath(__file__), command, coordinator, str(rank), out,
             *extra] for rank in range(RANKS)]


def check(outs: list[tuple[int, str, str]]) -> None:
    for rank, (rc, out, err) in enumerate(outs):
        if rc != 0:
            raise AssertionError(f"rank {rank} failed (rc={rc}):\n{out[-2000:]}\n{err[-4000:]}")


# ---------------------------------------------------------------------------
# the port's scenarios: one code for the two-process mesh and for the one
# process mesh of as many shards it is held to
# ---------------------------------------------------------------------------

def port_config(workdir: str, **kw):
    from attackfl_tpu_torch.config import AttackSpec, Config, TelemetryConfig

    base = dict(GEOMETRY, num_round=1, mode="fedavg", attacks=(AttackSpec(**LIE),),
                log_path=workdir, checkpoint_dir=workdir,
                telemetry=TelemetryConfig(enabled=False))
    return Config(**{**base, **kw})


def _final(state: dict) -> dict:
    keep = ("global_params", "prev_genuine", "hnet_params", "completed_rounds", "broadcasts")
    out = {k: state[k] for k in keep if k in state}
    out["rng"] = state["rng"].get_state()
    return out


def _executors(mesh, workdir: str) -> dict:
    """run (1 round), run_fast (2 rounds, one chunk) and the pipeline at
    depth 2 (2 rounds), threefry keys (shard_map); one hyper round
    (gspmd)."""
    from attackfl_tpu_torch.training.engine import Simulator

    out = {}
    kw = dict(save_checkpoints=False, verbose=False)
    runs = (("run", dict(num_round=1), lambda sim: sim.run(**kw)),
            ("run_fast", dict(num_round=2), lambda sim: sim.run_fast(chunk_size=2, **kw)),
            ("pipeline", dict(num_round=2, pipeline_depth=2),
             lambda sim: sim.run(pipeline=True, **kw)))
    for name, cfg_kw, execute in runs:
        cfg = port_config(workdir, prng_impl="threefry2x32", **cfg_kw)
        sim = Simulator(cfg, device="cpu", mesh=mesh)
        state, history = execute(sim)
        sim.close()
        out[name] = {"strategy": sim.mesh_strategy, "state": _final(state),
                     "ok": [bool(h["ok"]) for h in history],
                     "auc": [float(h["roc_auc"]) for h in history]}
    cfg = port_config(workdir, mode="hyper", attacks=())
    sim = Simulator(cfg, device="cpu", mesh=mesh)
    state, history = sim.run(**kw)
    sim.close()
    out["hyper"] = {"strategy": sim.mesh_strategy, "state": _final(state),
                    "ok": [bool(h["ok"]) for h in history],
                    "auc": [float(h["roc_auc"]) for h in history]}
    return out


def _defenses(mesh, workdir: str) -> dict:
    """Every mode of PSUM_MODES | GATHER_MODES aggregating one round's
    rows (the run's first round step) over the mesh, with the
    collectives each records."""
    import torch

    from attackfl_tpu_torch.parallel.shard import GATHER_MODES, PSUM_MODES, record_collectives
    from attackfl_tpu_torch.training import round as tround
    from attackfl_tpu_torch.training.engine import Simulator

    sim = Simulator(port_config(workdir, prng_impl="threefry2x32"), device="cpu", mesh=mesh)
    state = sim.init_state()
    _, (stacked, sizes, *_) = sim._drawn_round_step(
        state["global_params"], state["prev_genuine"], state["have_genuine"], state["rng"], 1)
    weights = torch.ones(sim.cfg.total_clients) * (sizes > 0)
    out = {"rows": stacked}
    for mode in sorted(PSUM_MODES | GATHER_MODES):
        cfg = sim.cfg.replace(mode=mode)
        draws = tround.round_drawer(cfg, [], cfg.total_clients, sim.pool_size, sim.num_params,
                                    sim.test_data["label"].shape[0])(
            torch.Generator().manual_seed(5))
        aggregate = tround.build_aggregator(sim.model, cfg, sim.test_data, mesh=mesh)
        with record_collectives() as recorded:
            new = aggregate(state["global_params"], stacked, sizes, weights, draws)
        out[mode] = {"params": new, "collectives": dict(recorded)}
    sim.close()
    return out


def _matrix(mesh, workdir: str) -> dict:
    """A 2 x 2 x 1 sweep's cell axis over the mesh: every cell's final
    state and the grid checkpoint's."""
    from attackfl_tpu_torch.config import AttackSpec
    from attackfl_tpu_torch.matrix.grid import GridSpec
    from attackfl_tpu_torch.training.matrix_exec import MATRIX_STATE_FILE, MatrixRun
    from attackfl_tpu_torch.utils import checkpoint as ckpt

    grid = GridSpec(attacks=(AttackSpec(mode="LIE", num_clients=4, attack_round=2),
                             AttackSpec(mode="none", num_clients=4, attack_round=2)),
                    defenses=("fedavg", "median"), seeds=(1,), rounds=2, chunk=1)
    base = port_config(workdir, prng_impl="threefry2x32", num_round=2)
    sweep = MatrixRun(base, grid, device="cpu", mesh=mesh)
    sweep.run(verbose=False)
    cells = MatrixRun.host_state(sweep.state)
    path = os.path.join(workdir, MATRIX_STATE_FILE)
    saved = ckpt.load_state(path, cells)
    sweep.close()
    return {"cells": cells, "checkpoint": saved, "fold_calls": sweep.fold_calls}


def _gradients(mesh) -> dict:
    """``psum`` and ``all_gather`` differentiated over the mesh in
    float64: each shard's part drawn from one seed (the same on every
    process), a scalar objective that every process computes alike and
    counts once (process 0's term; the others' weigh 0), its gradient by
    backward against central differences of the objective, every
    process perturbing the same entry at a time."""
    import torch

    from attackfl_tpu_torch.parallel.shard import all_gather, psum

    gen = torch.Generator().manual_seed(0)
    parts = [torch.randn(3, dtype=torch.float64, generator=gen) for _ in range(mesh.size)]
    blocks = [torch.randn(2, 3, dtype=torch.float64, generator=gen) for _ in range(mesh.size)]
    weights = [torch.randn(3, dtype=torch.float64, generator=gen) for _ in range(mesh.size)]
    mine = mesh.local_shards
    counted = 1.0 if mesh.process_index == 0 else 0.0

    def summed(xs):
        outs = psum(xs, mesh)
        terms = [torch.sum(weights[s] * out) for s, out in zip(mine, outs)]
        return psum(terms, mesh)[0]

    def gathered(xs):
        outs = all_gather(xs, mesh)
        terms = [torch.sum(out * (s + 1.0)) ** 2 for s, out in zip(mine, outs)]
        return psum(terms, mesh)[0]

    out = {}
    for name, fn, values in (("psum", summed, parts), ("all_gather", gathered, blocks)):
        local = [values[s].clone().requires_grad_(True) for s in mine]
        (counted * fn(local)).backward()
        analytic = [x.grad for x in local]
        worst, eps = 0.0, 1e-6
        for s in range(mesh.size):
            for k in range(values[s].numel()):
                diffs = []
                for sign in (1.0, -1.0):
                    moved = [values[t].clone() for t in mine]
                    if s in mine:
                        moved[mine.index(s)].view(-1)[k] += sign * eps
                    with torch.no_grad():
                        diffs.append(float(fn(moved)))
                if s in mine:
                    numeric = (diffs[0] - diffs[1]) / (2 * eps)
                    got = float(analytic[mine.index(s)].view(-1)[k])
                    worst = max(worst, abs(got - numeric) / max(1.0, abs(numeric)))
        out[name] = {"worst": worst, "grads": analytic}
    return out


def scenarios(mesh, workdir: str) -> dict:
    """Every scenario over ``mesh``, each in its own directory."""
    parts = {}
    for name, fn in (("executors", _executors), ("defenses", _defenses), ("matrix", _matrix)):
        directory = os.path.join(workdir, name)
        os.makedirs(directory, exist_ok=True)
        parts[name] = fn(mesh, directory)
    parts["gradients"] = _gradients(mesh)
    return parts


def restart(yaml_path: str) -> dict:
    """A ``load_parameters`` restart of the launch's config in this
    rank's directory (the cwd), over the mesh ``run`` builds: the state
    every process restored and the bytes it was broadcast."""
    from attackfl_tpu_torch.config import load_config
    from attackfl_tpu_torch.training.engine import Simulator

    sim = Simulator(load_config(yaml_path).replace(load_parameters=True), device="cpu",
                    use_mesh=True)
    state = sim.load_or_init_state()
    sim.close()
    return {"completed_rounds": int(state["completed_rounds"]),
            "loaded_bytes": sim.loaded_bytes, "mesh_size": sim.mesh.size,
            "host": sim.host_state(state)}


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def battery(coordinator: str, rank: int, out: str, launch: str | None = None) -> None:
    import torch
    import torch.distributed as dist

    from attackfl_tpu_torch.parallel.mesh import distributed_init, make_client_mesh

    distributed_init(coordinator, RANKS, rank)
    mesh = make_client_mesh(devices=["cpu"] * LOCAL_SHARDS)
    result = {"processes": mesh.processes, "local_shards": mesh.local_shards,
              **scenarios(mesh, os.path.join(out, f"rank{rank}"))}
    if launch is not None:
        os.chdir(os.path.join(launch, f"rank{rank}"))
        result["restart"] = restart(os.path.join(launch, "cfg.yaml"))
    torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()


def port_round(coordinator: str, rank: int, out: str) -> None:
    """The port's two-process round step at the driver's geometry in
    float64 on the draws ``out/inputs.pt`` hands over, and its aggregate;
    then one telemetry-on run into ``out/port-events``."""
    import torch
    import torch.distributed as dist

    from attackfl_tpu_torch.config import AttackSpec, Config, TelemetryConfig
    from attackfl_tpu_torch.models.icu import CNNModel
    from attackfl_tpu_torch.ops import pytree as pt
    from attackfl_tpu_torch.parallel.mesh import distributed_init, make_client_mesh
    from attackfl_tpu_torch.training import round as tround
    from attackfl_tpu_torch.training.engine import Simulator

    distributed_init(coordinator, RANKS, rank)
    mesh = make_client_mesh(devices=["cpu"] * LOCAL_SHARDS)
    given = torch.load(os.path.join(out, "inputs.pt"), weights_only=False)
    cfg = Config(**GEOMETRY, mode="fedavg", prng_impl=given["prng"],
                 attacks=(AttackSpec(**LIE),), log_path=out, checkpoint_dir=out,
                 telemetry=TelemetryConfig(enabled=False))
    groups, genuine = tround.build_attack_groups(cfg)
    model = CNNModel()
    model.dropout_rates = (0.0,) * len(model.dropout_rates)
    step = tround.build_round_step(model, cfg, given["train"], groups, genuine, mesh=mesh)
    aggregate = tround.build_aggregator(model, cfg, None, mesh=(
        mesh if given["prng"] == "threefry2x32" else None))
    stacked, sizes, new_genuine, ok, loss = step(given["params"], given["prev"], True,
                                                 given["draws"], 1)
    new = aggregate(given["params"], stacked, sizes,
                    torch.ones(cfg.total_clients, dtype=torch.float64), given["draws"])
    result = {"stacked": stacked, "sizes": sizes, "new_genuine": new_genuine, "ok": bool(ok),
              "loss": float(loss), "new": pt.tree_map(lambda x: x.detach(), new)}
    events = os.path.join(out, "port-events")
    sim = Simulator(Config(**GEOMETRY, num_round=1, mode="fedavg",
                           attacks=(AttackSpec(**LIE),), log_path=events,
                           checkpoint_dir=events), device="cpu", mesh=mesh)
    _, history = sim.run(save_checkpoints=False, verbose=False)
    result["run_id"] = sim.telemetry.events.run_id
    sim.close()
    result["run_ok"] = [bool(h["ok"]) for h in history]
    torch.save(result, os.path.join(out, f"port{rank}.pt"))
    dist.destroy_process_group()


def jax_round(coordinator: str, rank: int, out: str) -> None:
    """The JAX package's two-process run of :func:`port_round`'s step (its
    own draws from the same key) and the same telemetry-on run into
    ``out/jax-events``."""
    os.environ["XLA_FLAGS"] = " ".join(
        [f for f in os.environ.get("XLA_FLAGS", "").split()
         if "host_platform_device_count" not in f]
        + [f"--xla_force_host_platform_device_count={LOCAL_SHARDS}"])
    os.environ["ATTACKFL_TELEMETRY_DIR"] = os.path.join(out, "jax-events")
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    import jax.numpy as jnp
    import numpy as np

    from attackfl_tpu.parallel.mesh import (
        distributed_init, gather_to_host, make_client_mesh, make_constrain, replicate_to_mesh,
    )

    distributed_init(coordinator, RANKS, rank)
    from _torch_port_models import JaxDropoutOff

    from attackfl_tpu.config import AttackSpec, Config, TelemetryConfig
    from attackfl_tpu.models.icu import CNNModel
    from attackfl_tpu.training import round as jround
    from attackfl_tpu.training.engine import Simulator

    mesh = make_client_mesh()
    given = np.load(os.path.join(out, "inputs.npy"), allow_pickle=True).item()
    prng = given["prng"]
    with jax.enable_x64(True):
        cfg = Config(**GEOMETRY, mode="fedavg", prng_impl=prng, attacks=(AttackSpec(**LIE),),
                     log_path=out, checkpoint_dir=out, telemetry=TelemetryConfig(enabled=False))
        sharded = Simulator(cfg, mesh=mesh).mesh_strategy == "shard_map"
        groups, genuine = jround.build_attack_groups(cfg)
        train = {k: jnp.asarray(v) for k, v in given["train"].items()}
        params, prev = given["params"], given["prev"]
        step = jax.jit(jround.build_round_step(
            JaxDropoutOff(CNNModel()), cfg, train, groups, genuine, None, make_constrain(mesh),
            mesh=mesh, use_shard_map=sharded))
        aggregate = jax.jit(jround.build_aggregator(
            JaxDropoutOff(CNNModel()), cfg, None, mesh=mesh if sharded else None))
        placed = replicate_to_mesh((params, prev, jax.random.key(5, impl=prng),
                                    jax.random.key(0, impl=prng)), mesh)
        outs = step(placed[0], placed[1], jnp.asarray(True), placed[2], jnp.asarray(1))
        new = aggregate(placed[0], outs[0], outs[1],
                        replicate_to_mesh(np.ones(16, np.float64), mesh), placed[3])
        stacked, sizes, new_genuine, ok, loss = gather_to_host(outs)
        new = gather_to_host(new)
    sim = Simulator(Config(**GEOMETRY, num_round=1, mode="fedavg",
                           attacks=(AttackSpec(**LIE),), log_path=out, checkpoint_dir=out),
                    mesh=mesh)
    _, history = sim.run(save_checkpoints=False, verbose=False)
    run_id = sim.telemetry.events.run_id
    sim.close()
    if rank == 0:
        np.save(os.path.join(out, "jax.npy"), {
            "stacked": stacked, "sizes": sizes, "new_genuine": new_genuine, "ok": bool(ok),
            "loss": float(loss), "new": new, "sharded": sharded}, allow_pickle=True)
    print("JAX_RANK_OK " + json.dumps({"rank": rank, "run_id": run_id,
                                       "ok": [bool(h["ok"]) for h in history]}), flush=True)


def main(argv: list[str]) -> int:
    command, coordinator, rank, out, *rest = argv
    os.makedirs(out, exist_ok=True)
    if command == "jax-round":
        jax_round(coordinator, int(rank), out)
        return 0
    import torch

    torch.set_num_threads(1)
    if command == "battery":
        battery(coordinator, int(rank), out, *rest)
    elif command == "port-round":
        port_round(coordinator, int(rank), out)
    else:
        raise SystemExit(f"unknown command {command!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
