"""The port's client mesh in one process (``attackfl_tpu_torch/parallel``,
the mesh branches of ``training/round.py``, ``training/engine.py`` and
``training/matrix_exec.py``) on the CPU, on meshes of repeated ``cpu``
shards (the port's counterpart of JAX's 8 virtual CPU devices).

1. Placement (JAX ``tests/test_sharding.py:29-35``): 16 clients over 8
   shards give 2 rows each and come back in order; ``make_client_mesh``
   truncates to the visible devices, as JAX's does.
2. JAX's rules, held against the JAX package's own: the strategy by
   config (``supports_shard_map``), the forced ``shard_map`` refused with
   a ``ValueError`` (:191-203), the fallback to no mesh when the clients
   do not divide (:148-153).
3. A one-device mesh is the meshless program bit for bit under ``run``,
   ``run_fast`` and the pipeline, under both strategies: its local update
   is the meshless call and a psum over one shard divides and sums as the
   meshless mean does.
4. ``run_fast`` and the pipeline at depths 0 and 2 on 8 shards under
   ``shard_map``: the meshless run's ``ok`` sequence, params within 5e-3
   (JAX's trajectory bound, :252-288).  The comparison is port against
   port at TransformerModel, whose float32 rounds keep to 1e-4 of each
   other here (measured 2.9e-5 after two rounds); the float64 of the CNN
   suite is for the comparison against the JAX package
   (tests/test_torch_port_shard.py).  Hyper mode on 8 shards (gspmd):
   the hypernetwork within ``2 * hyper_lr * C + 1e-4`` (:129-145).
5. The kernels' plain versions by global client: K1's plain version
   (``run_epoch_reference``) on two halves at bases 0 and C/2 against one
   call; the ``xla`` update's halves likewise; K3's masks by global ids
   equal the rows of the unsharded masks, bit for bit.  On the CPU the
   halves' rows part from the whole in the last bits (6e-8 measured):
   torch's CPU row reductions (the clip's norm) and batched products
   pick their split by the row count, as ``matrix/program.py`` records
   for the card below 16 rows; the loss sums, and the masks, are
   bit-equal.  The hash is what the base keys: the second half at base 0
   draws other masks and moves its rows by orders more.  K1 itself, one
   block a client, is bit-equal on the card (``chip_smoke.py`` phase 21a).
6. The collectives: ``gradcheck`` of ``psum`` and ``all_gather`` in
   float64 over 3 shards; their records, forward and backward.
7. The matrix's cell axis: a 2 x 2 x 1 sweep over 2 and 3 shards (the
   latter clone-padded from 4 cells to 6) gives every cell the unsharded
   sweep's final state bit for bit and records no collective.
8. The monitor's mesh fields and gauge, and ``watch``'s ``mesh=``, equal
   the JAX package's.
"""

from __future__ import annotations

import pytest
import torch
from _torch_port_threads import one_torch_thread  # noqa: F401
from test_torch_port_monitor import _both_watch, _same, make_pair, monitor  # noqa: F401

from attackfl_tpu.config import Config as JaxConfig
from attackfl_tpu.parallel.shard import supports_shard_map as jax_supports_shard_map
from attackfl_tpu_torch.config import AttackSpec, Config, TelemetryConfig
from attackfl_tpu_torch.data.synthetic import get_dataset
from attackfl_tpu_torch.matrix.grid import GridSpec
from attackfl_tpu_torch.models.icu import TransformerModel
from attackfl_tpu_torch.ops import fused_step as tfs
from attackfl_tpu_torch.ops import pytree as pt
from attackfl_tpu_torch.parallel.mesh import (
    client_sharding, gather_stacked, leading_axis_spec, make_client_mesh, make_constrain,
    replicate, shard_stacked,
)
from attackfl_tpu_torch.parallel.shard import (
    all_gather, psum, record_collectives, supports_shard_map,
)
from attackfl_tpu_torch.training import local
from attackfl_tpu_torch.training.engine import Simulator
from attackfl_tpu_torch.training.matrix_exec import MatrixRun

SMALL = dict(num_round=2, total_clients=8, mode="fedavg", model="TransformerModel",
             data_name="ICU", num_data_range=(24, 32), epochs=1, batch_size=16,
             train_size=256, test_size=128, local_backend="xla",
             attacks=(AttackSpec(mode="LIE", num_clients=2, attack_round=2),),
             telemetry=TelemetryConfig(enabled=False))


def _cfg(tmp_path, **kw) -> Config:
    return Config(**{**SMALL, "log_path": str(tmp_path), "checkpoint_dir": str(tmp_path),
                     **kw})


def _mesh(n: int):
    return make_client_mesh(devices=["cpu"] * n)


def _gap(a: dict, b: dict) -> float:
    return max(float((x - y).abs().max()) for x, y in zip(pt.tree_leaves(a),
                                                           pt.tree_leaves(b)))


def _same_tree(a: dict, b: dict) -> bool:
    return all(torch.equal(x, y) for x, y in zip(pt.tree_leaves(a), pt.tree_leaves(b)))


# ---------------------------------------------------------------------------
# 1-2. placement and JAX's rules
# ---------------------------------------------------------------------------

def test_mesh_and_placement():
    mesh = _mesh(8)
    assert mesh.size == 8 and mesh.distinct == (torch.device("cpu"),)
    tree = {"w": torch.arange(64.0).reshape(16, 4), "b": {"c": torch.arange(16)}}
    blocks = shard_stacked(tree, mesh)
    assert [tuple(b["w"].shape) for b in blocks] == [(2, 4)] * 8   # 16 clients / 8 shards
    assert torch.equal(blocks[3]["b"]["c"], torch.tensor([6, 7]))
    assert _same_tree(gather_stacked(blocks, mesh), tree)
    assert all(_same_tree(r, tree) for r in replicate(mesh).place(tree))
    assert [tuple(b["w"].shape) for b in client_sharding(mesh).place(tree)] == [(2, 4)] * 8
    assert leading_axis_spec(tree["w"]) == ("clients", None)
    assert make_constrain(None)(tree) is tree
    assert make_client_mesh(3, device="cpu").size == 1     # truncated to what is visible
    with pytest.raises(ValueError, match="do not divide"):
        mesh.blocks(12)


@pytest.mark.parametrize("prng", ["rbg", "unsafe_rbg", "threefry2x32"])
@pytest.mark.parametrize("mode", ["fedavg", "median", "hyper"])
def test_mesh_strategy_rule_is_jaxs(prng, mode, tmp_path):
    ours = supports_shard_map(_cfg(tmp_path, prng_impl=prng, mode=mode, attacks=()))
    assert ours == jax_supports_shard_map(JaxConfig(prng_impl=prng, mode=mode))


def test_mesh_strategy_auto_rules(tmp_path):
    """shard_map exactly under threefry on a plain mode; rbg and hyper stay
    on gspmd; forcing shard_map on rbg is an error (JAX's messages)."""
    mesh = _mesh(8)
    assert Simulator(_cfg(tmp_path), device="cpu", mesh=mesh).mesh_strategy == "gspmd"
    tf = _cfg(tmp_path, prng_impl="threefry2x32")
    assert Simulator(tf, device="cpu", mesh=mesh).mesh_strategy == "shard_map"
    hyper = _cfg(tmp_path, prng_impl="threefry2x32", mode="hyper", attacks=())
    assert Simulator(hyper, device="cpu", mesh=mesh).mesh_strategy == "gspmd"
    with pytest.raises(ValueError, match="shard_map"):
        Simulator(_cfg(tmp_path), device="cpu", mesh=mesh, mesh_strategy="shard_map")
    with pytest.raises(ValueError, match="unknown mesh_strategy"):
        Simulator(tf, device="cpu", mesh=mesh, mesh_strategy="pjit")
    assert Simulator(tf, device="cpu", mesh=mesh, mesh_strategy="gspmd").mesh_strategy == "gspmd"


def test_indivisible_clients_fall_back(tmp_path, capsys):
    sim = Simulator(_cfg(tmp_path, total_clients=5, num_round=1), device="cpu", mesh=_mesh(8))
    assert sim.mesh is None and sim.mesh_strategy is None   # 5 % 8 != 0 -> no mesh
    assert "5 clients not divisible by 8 devices; running replicated." in capsys.readouterr().out
    _, history = sim.run(save_checkpoints=False, verbose=False)
    assert history[-1]["ok"]


# ---------------------------------------------------------------------------
# 3-4. the executors over the mesh
# ---------------------------------------------------------------------------

def _execute(sim, executor: str):
    kw = dict(save_checkpoints=False, verbose=False)
    if executor == "run_fast":
        return sim.run_fast(chunk_size=2, **kw)
    return sim.run(pipeline=executor.startswith("pipeline"), **kw)


def _final(state) -> tuple:
    return state["global_params"], state["prev_genuine"], state["rng"].get_state()


@pytest.mark.parametrize("executor", ["run", "run_fast", "pipeline"])
@pytest.mark.parametrize("prng", ["rbg", "threefry2x32"])
def test_one_device_mesh_is_the_meshless_program(executor, prng, tmp_path):
    cfg = _cfg(tmp_path, prng_impl=prng, pipeline_depth=2)
    plain_state, plain = _execute(Simulator(cfg, device="cpu"), executor)
    sim = Simulator(cfg, device="cpu", mesh=_mesh(1))
    assert sim.mesh_strategy == ("shard_map" if prng == "threefry2x32" else "gspmd")
    state, history = _execute(sim, executor)
    assert [h["ok"] for h in history] == [h["ok"] for h in plain] == [True, True]
    (p0, g0, r0), (p1, g1, r1) = _final(plain_state), _final(state)
    assert _same_tree(p0, p1) and _same_tree(g0, g1) and torch.equal(r0, r1)
    assert [h["roc_auc"] for h in history] == [h["roc_auc"] for h in plain]


@pytest.mark.parametrize("executor,mode,depth", [
    ("run_fast", "fedavg", 1), ("pipeline0", "median", 0), ("pipeline2", "median", 2)])
def test_sharded_executors_track_the_meshless_run(executor, mode, depth, tmp_path):
    cfg = _cfg(tmp_path, prng_impl="threefry2x32", mode=mode, pipeline_depth=depth)
    plain_state, plain = _execute(Simulator(cfg, device="cpu"), executor)
    sim = Simulator(cfg, device="cpu", mesh=_mesh(8))
    assert sim.mesh_strategy == "shard_map"
    state, history = _execute(sim, executor)
    assert [h["ok"] for h in history] == [h["ok"] for h in plain]
    assert _gap(state["global_params"], plain_state["global_params"]) < 5e-3


def test_sharded_hyper_matches_replicated(tmp_path):
    cfg = _cfg(tmp_path, mode="hyper", attacks=(), num_round=1)
    plain_state, plain = Simulator(cfg, device="cpu").run(save_checkpoints=False,
                                                          verbose=False)
    sim = Simulator(cfg, device="cpu", mesh=_mesh(8))
    assert sim.mesh_strategy == "gspmd"
    state, history = sim.run(save_checkpoints=False, verbose=False)
    assert history[-1]["ok"] == plain[-1]["ok"]
    assert abs(history[-1]["roc_auc"] - plain[-1]["roc_auc"]) < 2e-2
    bound = 2 * cfg.hyper_lr * cfg.total_clients + 1e-4
    assert float((state["hnet_params"] - plain_state["hnet_params"]).abs().max()) < bound


# ---------------------------------------------------------------------------
# 5. the kernels' plain versions by global client
# ---------------------------------------------------------------------------

C_K1, NB, B_K1 = 4, 2, 8


def _k1_inputs():
    gen = torch.Generator().manual_seed(0)
    params = TransformerModel().init(torch.Generator().manual_seed(1))
    groups = tfs.pack_params(pt.tree_broadcast(params, C_K1))
    batches = torch.randn(C_K1, NB, B_K1, 32, generator=gen)
    batches[..., tfs.COL_LABEL] = (batches[..., tfs.COL_LABEL] > 0).float()
    batches[..., tfs.COL_MASK] = 1.0
    batches[..., tfs.COL_MASK + 1:] = 0.0
    return groups, batches


def _k1(groups, batches, rows: slice, base: int):
    p = {k: v[rows].clone() for k, v in groups.items()}
    return tfs.run_epoch_reference(p, tfs.zeros_like_groups(p), tfs.zeros_like_groups(p),
                                   batches[rows].contiguous(), 7, 0, lr=0.004, clip=1.0,
                                   client_base=base)


def test_k1_plain_halves_by_client_base_equal_the_whole():
    groups, batches = _k1_inputs()
    whole = _k1(groups, batches, slice(0, C_K1), 0)
    half = C_K1 // 2
    first = _k1(groups, batches, slice(0, half), 0)
    second = _k1(groups, batches, slice(half, C_K1), half)
    wrong = _k1(groups, batches, slice(half, C_K1), 0)
    assert torch.equal(torch.cat([first[3], second[3]]), whole[3])   # the loss sums
    for k in tfs.GROUP_ORDER:
        side_by_side = torch.cat([first[0][k], second[0][k]])
        assert float((side_by_side - whole[0][k]).abs().max()) <= 1e-6, k
    # the masks are the base's: at base 0 the second half moves far more
    moved = max(float((wrong[0][k] - whole[0][k][half:]).abs().max()) for k in tfs.GROUP_ORDER)
    assert moved > 1e-4


def test_xla_masks_and_update_by_global_ids():
    keys = tfs.client_keys(5, 3, torch.arange(8))
    spec = [(16, 8, 64, 0.1), (17, 8, 16, 0.3)]
    whole = tfs.dropout_masks(keys, spec)
    for base in (0, 4):
        part = tfs.dropout_masks(tfs.client_keys(5, 3, torch.arange(base, base + 4)), spec)
        assert all(torch.equal(w[base:base + 4], p) for w, p in zip(whole, part))
    model = TransformerModel()
    train = {k: torch.as_tensor(v) for k, v in get_dataset("ICU", "train", 256, 1).items()}
    update = local.build_local_update(model, "ICU", train, epochs=2, batch_size=8, lr=0.004,
                                      clip_grad_norm=1.0)
    gen = torch.Generator().manual_seed(2)
    params = model.init(torch.Generator().manual_seed(1))
    idx = torch.randint(0, 256, (4, 16), generator=gen)
    mask = torch.ones(4, 16, dtype=torch.bool)
    perms = torch.stack([torch.stack([torch.randperm(16, generator=gen) for _ in range(4)])
                         for _ in range(2)])
    stacked, ok, loss = update(params, idx, mask, perms, 5)
    halves = [update(params, idx[r], mask[r], perms[:, r], 5, client_base=r.start)
              for r in (slice(0, 2), slice(2, 4))]
    assert bool(ok.all()) and torch.equal(torch.cat([h[1] for h in halves]), ok)
    joined = pt.tree_map(lambda a, b: torch.cat([a, b]), halves[0][0], halves[1][0])
    assert _gap(joined, stacked) <= 1e-6
    assert float((torch.cat([h[2] for h in halves]) - loss).abs().max()) <= 1e-6


# ---------------------------------------------------------------------------
# 6. the collectives
# ---------------------------------------------------------------------------

def test_psum_and_all_gather_gradcheck():
    mesh = _mesh(3)
    gen = torch.Generator().manual_seed(0)
    parts = [torch.randn(5, dtype=torch.float64, generator=gen, requires_grad=True)
             for _ in range(3)]
    blocks = [torch.randn(2, 3, dtype=torch.float64, generator=gen, requires_grad=True)
              for _ in range(3)]
    weights = [torch.randn(5, dtype=torch.float64, generator=gen) for _ in range(3)]

    def summed(*xs):
        # every shard's copy enters, each with its own cotangent
        return sum(torch.sum(w * out) for w, out in zip(weights, psum(xs, mesh)))

    def gathered(*xs):
        return sum(torch.sum(out * (i + 1.0)) ** 2 for i, out in enumerate(all_gather(xs, mesh)))

    assert torch.autograd.gradcheck(summed, parts)
    assert torch.autograd.gradcheck(gathered, blocks)
    out = psum([torch.full((2,), float(i)) for i in range(3)], mesh)
    assert all(torch.equal(o, torch.full((2,), 3.0)) for o in out)


def test_collectives_record_their_names_and_their_duals():
    mesh = _mesh(2)
    x = [torch.ones(3, requires_grad=True), torch.ones(3, requires_grad=True)]
    with record_collectives() as outer:
        with record_collectives() as inner:
            loss = torch.sum(all_gather(x, mesh)[0]) + torch.sum(psum(x, mesh)[1])
        assert inner == {"all_gather": 1, "psum": 1}
    # the backward runs after the block and records into its forward's records
    loss.backward()
    assert outer == inner == {"all_gather": 1, "psum": 3, "reduce_scatter": 1}
    assert torch.equal(x[0].grad, torch.full((3,), 2.0))


# ---------------------------------------------------------------------------
# 7. the matrix's cell axis
# ---------------------------------------------------------------------------

def test_matrix_cells_over_the_mesh_are_bit_identical(tmp_path):
    grid = GridSpec(attacks=(AttackSpec(mode="LIE", num_clients=2, attack_round=2),
                             AttackSpec(mode="none", num_clients=2, attack_round=2)),
                    defenses=("fedavg", "median"), seeds=(1,), rounds=2, chunk=1)
    states = {}
    for shards in (None, 2, 3):
        base = _cfg(tmp_path / f"s{shards}", prng_impl="threefry2x32")
        sweep = MatrixRun(base, grid, device="cpu",
                          mesh=None if shards is None else _mesh(shards))
        with record_collectives() as recorded:
            sweep.run(save_checkpoints=False, verbose=False)
        assert not recorded
        if shards == 3:
            assert sweep.fold_calls == 2 * 3    # 4 cells padded to 6, one part a shard
        states[shards] = MatrixRun.host_state(sweep.state)
        sweep.close()
    for key, plain in states[None].items():
        for shards in (2, 3):
            cell = states[shards][key]
            assert _same_tree(cell["global_params"], plain["global_params"]), (key, shards)
            assert torch.equal(cell["rng"], plain["rng"])
            assert cell["completed_rounds"] == plain["completed_rounds"] == 2


# ---------------------------------------------------------------------------
# 8. the monitor and watch
# ---------------------------------------------------------------------------

def test_monitor_mesh_fields_are_jaxs(tmp_path, monitor, capsys):  # noqa: F811
    ours, theirs = make_pair(tmp_path)
    _same(ours, theirs, lambda m: m.record_round({"round": 1, "broadcast": 1, "ok": True,
                                                  "seconds": 0.2}))
    _same(ours, theirs, lambda m: m.set_mesh(8, "shard_map"))
    assert ours.last_round()["mesh_devices"] == 8
    assert "attackfl_mesh_devices 8" in ours.metrics_text()
    _same(ours, theirs, lambda m: m.set_mesh(None))
    assert "mesh_devices" not in ours.last_round()
    url = f"http://127.0.0.1:{monitor.port}"
    monitor.run_started()
    monitor.record_round({"round": 3, "broadcast": 3, "ok": True, "seconds": 0.1})
    for devices, strategy, shown in ((8, "shard_map", "mesh=8sm"), (2, "gspmd", "mesh=2g")):
        monitor.set_mesh(devices, strategy)
        rc, out = _both_watch(url, capsys)
        assert rc == 0 and shown in out
