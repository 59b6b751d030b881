"""The port's fused multi-round path (``Simulator.run_scan`` and
``run_fast``) on the CPU, at a small size (TransformerModel on ICU, 8
clients, 2 epochs, batch 16).

1. Against the port's own ``run``: the final state bit for bit
   (``torch.equal`` on every leaf, the generator's state included), the
   same ok sequence and broadcasts, and the metrics equal wherever both
   report them, for fedavg + LIE at chunk lengths 1, 2 and the default,
   the fault plan of ``test_torch_port_faults.py``
   (``nan_storm@2:clients=1,6;dropout@3:clients=0,2,7;dropout@4``),
   stragglers, FLTrust and Krum under both backends; bf16 under ``xla``;
   hyper mode with ``HyperNetwork`` (sequential, TransformerModel) and
   ``CNNHyper`` (batched, CNNModel), without the detector.  ``run``'s
   ``round`` is the round being attempted, ``run_fast``'s the attempt's
   index, as JAX's (``engine.py:2200``).
2. The history against the JAX package's ``run_fast`` on the same config
   under the same plan, under each backend (JAX's ``pallas`` in interpret
   mode, ~10 s of the file's time): the same keys in the same order per
   entry, the same ``chunk_len`` sequence (3, 3, 3, 1, 1 from the default
   policy) and the same ok sequence, T, F, T, F, T.
3. JAX's behaviour at the edges: NaN metrics for skipped validations and
   train-failed rounds, the refusals and their messages, the caller's
   state untouched, the retry cap raised after the chunk, one checkpoint
   entry per chunk, a resume continuing the round numbering.
4. The dropout seed as a 0-dim int64 device tensor (the draw's, which
   the kernels read on the card) gives the bits of the int it holds, in
   ``client_keys``, K3's plain masks and K1's plain epoch.
"""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch
from _torch_port_threads import one_torch_thread  # noqa: F401

from attackfl_tpu_torch.config import AttackSpec, Config, HyperDetectionConfig, MeshConfig
from attackfl_tpu_torch.data.partition import draw_round
from attackfl_tpu_torch.faults.plan import parse_fault_plan
from attackfl_tpu_torch.models.icu import TransformerModel
from attackfl_tpu_torch.ops import fused_step
from attackfl_tpu_torch.ops import pytree as pt
from attackfl_tpu_torch.training import engine
from attackfl_tpu_torch.training.engine import Simulator

RUN_PLAN = "nan_storm@2:clients=1,6;dropout@3:clients=0,2,7;dropout@4"
LIE = AttackSpec(mode="LIE", num_clients=2, attack_round=2)
SMALL = dict(num_round=3, total_clients=8, mode="fedavg", model="TransformerModel",
             data_name="ICU", num_data_range=(24, 32), epochs=2, batch_size=16,
             train_size=256, test_size=128, attacks=(LIE,))
# the keys of a synchronous round's entry that are not metrics (the
# attack modes, the phases' times, a failed round's NaN clients and the
# defense's removals are the per-round path's, as in JAX's
# engine.py:1555-1572,1642,1186)
RUN_ONLY = ("round", "broadcast", "seconds", "ok", "attacks_active", "phases",
            "nan_clients", "defense_removed")


def _cfg(tmp_path, **kw) -> Config:
    return Config(**{**SMALL, "log_path": str(tmp_path), "checkpoint_dir": str(tmp_path), **kw})


def _leaves(state: dict) -> list[tuple[str, object]]:
    """Every leaf of a simulation state, the generator as its state."""
    out = []
    for key in sorted(state):
        value = state[key]
        if key == "rng":
            out.append((key, value.get_state()))
        elif isinstance(value, dict):
            out.extend((f"{key}/{p}", leaf) for p, leaf in pt.tree_items(value))
        else:
            out.append((key, value))
    return out


def _assert_same_state(a: dict, b: dict) -> None:
    la, lb = _leaves(a), _leaves(b)
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (key, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert isinstance(y, torch.Tensor) and torch.equal(x, y), key
        else:
            assert type(x) is type(y) and x == y, key


def _copy(state: dict) -> dict:
    out = {}
    for key, value in state.items():
        if key == "rng":
            out[key] = value.get_state()
        elif isinstance(value, dict):
            out[key] = pt.tree_map(torch.clone, value)
        elif isinstance(value, torch.Tensor):
            out[key] = value.clone()
        else:
            out[key] = value
    return out


def _run_and_fast(cfg: Config, chunk_size=None):
    sim = Simulator(cfg, device="cpu")
    run_state, run_hist = sim.run(state=sim.init_state(), save_checkpoints=False,
                                  verbose=False)
    fast = Simulator(cfg, device="cpu")
    fast_state, fast_hist = fast.run_fast(state=fast.init_state(), chunk_size=chunk_size,
                                          save_checkpoints=False, verbose=False)
    return run_state, run_hist, fast_state, fast_hist


CASES = {
    "lie-chunk1": (dict(), 1),
    "lie-chunk2": (dict(), 2),
    "lie-default": (dict(), None),
    "fault-plan": (dict(faults=parse_fault_plan(RUN_PLAN)), 2),
    "stragglers": (dict(client_dropout_rate=0.25), 2),
    "fltrust": (dict(mode="FLTrust"), 2),
    "krum": (dict(mode="krum"), 2),
}
PARAMS = ([pytest.param(name, backend, id=f"{name}-{backend}")
           for name in CASES for backend in ("pallas", "xla")]
          + [pytest.param("bf16", "xla", id="bf16-xla"),
             pytest.param("hyper-sequential", "xla", id="hyper-sequential-xla"),
             pytest.param("cnnhyper-batched", "xla", id="cnnhyper-batched-xla")])
EXTRA = {
    "bf16": (dict(mesh=MeshConfig(compute_dtype="bfloat16")), 2),
    "hyper-sequential": (dict(mode="hyper", epochs=1), 2),
    "cnnhyper-batched": (dict(mode="hyper", model="CNNModel", hyper_class="CNNHyper",
                              hyper_update_mode="batched", epochs=1, total_clients=6), 2),
}


@pytest.mark.parametrize("name,backend", PARAMS)
def test_run_fast_equals_run_bit_for_bit(name, backend, tmp_path):
    kw, chunk = {**CASES, **EXTRA}[name]
    cfg = _cfg(tmp_path, local_backend=backend, **kw)
    run_state, run_hist, fast_state, fast_hist = _run_and_fast(cfg, chunk)
    _assert_same_state(run_state, fast_state)
    assert [h["ok"] for h in fast_hist] == [h["ok"] for h in run_hist]
    assert [h["broadcast"] for h in fast_hist] == [h["broadcast"] for h in run_hist]
    assert [h["round"] for h in fast_hist] == list(range(1, len(run_hist) + 1))
    # run's round: the one attempted, 1 + the ok rounds before it
    oks = [h["ok"] for h in fast_hist]
    assert [h["round"] for h in run_hist] == [1 + sum(oks[:i]) for i in range(len(oks))]
    for r, f in zip(run_hist, fast_hist):
        shared = [k for k in r if k not in RUN_ONLY]
        assert shared and all(r[k] == f[k] for k in shared), (r, f)
    if name == "fault-plan":
        assert oks == [True, False, True, False, True]


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_history_matches_jax_run_fast(backend, tmp_path):
    """The history's shape against JAX's ``run_fast`` under the fault plan
    (the default chunk policy)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from attackfl_tpu.config import AttackSpec as JaxAttackSpec
    from attackfl_tpu.config import Config as JaxConfig
    from attackfl_tpu.config import TelemetryConfig as JaxTelemetryConfig
    from attackfl_tpu.faults.plan import parse_fault_plan as jax_parse_fault_plan
    from attackfl_tpu.training.engine import Simulator as JaxSimulator

    shared = {k: v for k, v in SMALL.items() if k != "attacks"}
    shared.update(local_backend=backend, log_path=str(tmp_path / "jax"),
                  checkpoint_dir=str(tmp_path / "jax"))
    jcfg = JaxConfig(**shared, attacks=(JaxAttackSpec(mode="LIE", num_clients=2,
                                                      attack_round=2),),
                     faults=jax_parse_fault_plan(RUN_PLAN),
                     telemetry=JaxTelemetryConfig(enabled=False))
    jsim = JaxSimulator(jcfg)
    _, jhist = jsim.run_fast(state=jsim.init_state(), save_checkpoints=False, verbose=False)
    sim = Simulator(_cfg(tmp_path, local_backend=backend, faults=parse_fault_plan(RUN_PLAN)),
                    device="cpu")
    _, hist = sim.run_fast(state=sim.init_state(), save_checkpoints=False, verbose=False)
    assert [list(h) for h in hist] == [list(h) for h in jhist]
    assert [h["chunk_len"] for h in hist] == [h["chunk_len"] for h in jhist] == [3, 3, 3, 1, 1]
    assert [h["ok"] for h in hist] == [h["ok"] for h in jhist] == [True, False, True, False,
                                                                  True]
    assert [(h["round"], h["broadcast"]) for h in hist] == \
        [(h["round"], h["broadcast"]) for h in jhist]
    for ours, theirs in zip(hist, jhist):
        for key in ("roc_auc", "metric"):
            assert np.isnan(ours[key]) == np.isnan(theirs[key])


def test_skipped_and_train_failed_rounds_report_nan(tmp_path):
    """validation_every 2: the odd broadcasts report NaN and carry no
    gate; the stormed broadcast's training fails, so its metrics are NaN
    though it was due.  The params are run's, bit for bit."""
    cfg = _cfg(tmp_path, local_backend="xla", validation_every=2, num_round=4,
               faults=parse_fault_plan("nan_storm@4"))
    run_state, run_hist, fast_state, fast_hist = _run_and_fast(cfg, 3)
    _assert_same_state(run_state, fast_state)
    assert [h["ok"] for h in fast_hist] == [True, True, True, False, True]
    for h in fast_hist:
        due = h["broadcast"] % 2 == 0 and h["ok"]
        assert np.isfinite(h["roc_auc"]) == due and np.isfinite(h["metric"]) == due
        assert np.isfinite(h["train_loss"]) or not h["ok"]
    assert [("roc_auc" in h) for h in run_hist] == [False, True, False, False, False]


@pytest.mark.parametrize("kw,message", [
    (dict(mode="gmm"), r"mode 'gmm' \(hyper-detection=False\) needs host-side per-round "
                       r"work; use run_round/run instead"),
    (dict(mode="fltracer"), r"mode 'fltracer' \(hyper-detection=False\) needs host-side"),
    (dict(mode="hyper", hyper_detection=HyperDetectionConfig(enable=True, start_round=2)),
     r"mode 'hyper' \(hyper-detection=True\) needs host-side"),
    (dict(reload_parameters_per_round=True, load_parameters=True), r"mode 'fedavg' \(hyper-detection=False\)"),
])
def test_host_side_modes_are_refused_as_jax(kw, message, tmp_path):
    sim = Simulator(_cfg(tmp_path, **kw), device="cpu")
    assert not sim.supports_fused()
    with pytest.raises(ValueError, match=message):
        sim.run_fast(state=sim.init_state(), save_checkpoints=False, verbose=False)


def test_inactive_clients_are_refused_and_hyper_reload_is_fused(tmp_path):
    sim = Simulator(_cfg(tmp_path, mode="hyper", reload_parameters_per_round=True,
                                   load_parameters=True, epochs=1),
                    device="cpu")
    assert sim.supports_fused()
    state = sim.init_state()
    state["active_mask"][3] = 0.0
    with pytest.raises(ValueError, match=re.escape(
            "state has inactive clients (resumed from a hyper-detection run?); use "
            "run_round/run for active-mask-aware validation")):
        sim.run_scan(state, 1)


def test_run_scan_leaves_the_callers_state(tmp_path):
    sim = Simulator(_cfg(tmp_path, local_backend="xla"), device="cpu")
    state = sim.init_state()
    before = _copy(state)
    new, metrics = sim.run_scan(state, 2)
    for key, value in before.items():
        if key == "rng":
            assert torch.equal(state["rng"].get_state(), value)
        elif isinstance(value, dict):
            assert all(torch.equal(a, b) for a, b in zip(pt.tree_leaves(state[key]),
                                                         pt.tree_leaves(value)))
        else:
            assert state[key] == value
    assert sorted(metrics) == ["metric", "ok", "roc_auc", "train_loss"]
    assert all(v.shape == (2,) for v in metrics.values())
    assert new["broadcasts"] == 2 and int(new["completed_rounds"]) == 2
    assert new["completed_rounds"].dtype == torch.int64 and bool(new["have_genuine"])


def test_retry_cap_raises_after_the_chunk(tmp_path, monkeypatch):
    """With the cap at 0, a chunk that ends on a failed broadcast raises
    once the chunk is in the history: its faults are noted, its
    checkpoint is not written."""
    monkeypatch.setattr(engine, "MAX_ROUND_RETRIES", 0)
    sim = Simulator(_cfg(tmp_path, local_backend="xla", faults=parse_fault_plan("nan_storm@3")),
                    device="cpu")
    with pytest.raises(RuntimeError, match="round failed 1 times in a row"):
        sim.run_fast(state=sim.init_state(), chunk_size=3, verbose=False)
    assert [r["round"] for r in sim.fault_injector.records] == [3]
    assert sim.checkpoints.read_manifest() is None or \
        sim.checkpoints.read_manifest()["entries"] == []


def test_one_checkpoint_a_chunk_and_resume_continues(tmp_path, capsys):
    """Checkpoints after every chunk; a resumed Simulator's run_fast
    continues the round numbering and ends on the uninterrupted run's
    bits.  The chunk's progress dict and its console line are JAX's."""
    whole_sim = Simulator(_cfg(tmp_path / "whole", local_backend="xla", num_round=4),
                          device="cpu")
    whole, _ = whole_sim.run_fast(chunk_size=2, verbose=False)
    progress = {}
    cut = Simulator(_cfg(tmp_path / "cut", local_backend="xla", num_round=4), device="cpu")
    cut.run_fast(num_rounds=3, chunk_size=2, progress=progress)
    out = capsys.readouterr().out
    assert "[fast] 2/3 rounds, chunk of 2 in" in out and "[fast] 3/3 rounds, chunk of 1 in" in out
    assert progress["ok_rounds"] == 3 and progress["interim_rounds_per_sec_incl_compile"] > 0
    assert [e["round"] for e in cut.checkpoints.read_manifest()["entries"]] == [2, 3]
    resumed_sim = Simulator(_cfg(tmp_path / "cut", local_backend="xla", num_round=4,
                                 resume=True), device="cpu")
    resumed, history = resumed_sim.run_fast(chunk_size=2, verbose=False)
    assert [(h["round"], h["broadcast"]) for h in history] == [(4, 4)]
    _assert_same_state(resumed, whole)


def test_run_fast_writes_nothing_to_app_log(tmp_path):
    sim = Simulator(_cfg(tmp_path, local_backend="xla", num_round=1), device="cpu")
    sim.run_fast(save_checkpoints=False, verbose=False)
    log_file = tmp_path / "app.log"
    assert not log_file.exists() or log_file.read_text() == ""


# ---------------------------------------------------------------------------
# the dropout seed on the device
# ---------------------------------------------------------------------------

def test_client_keys_and_plain_masks_from_a_tensor_seed():
    clients = torch.arange(6)
    steps = torch.arange(3)[:, None]
    for seed in (0, 5, 2 ** 31 - 2):
        t = torch.tensor(seed, dtype=torch.int64)
        assert torch.equal(fused_step.client_keys(t + 1, steps, clients),
                           fused_step.client_keys(seed + 1, steps, clients))
        keys_int = fused_step.client_keys(seed, 2, clients)
        keys_t = fused_step.client_keys(t, 2, clients)
        specs = [(1, 4, 6, 0.1), (5, 3, 8, 0.3)]
        for a, b in zip(fused_step.fill_masks(keys_t, specs),
                        fused_step.fill_masks(keys_int, specs)):
            assert torch.equal(a, b)


def test_plain_epoch_from_a_tensor_seed():
    C, nb, B = 3, 2, 8
    rng = np.random.default_rng(4)
    params = TransformerModel().init(torch.Generator().manual_seed(0))
    groups = fused_step.pack_params(pt.tree_broadcast(params, C))
    batches = torch.from_numpy(rng.standard_normal((C, nb, B, 32)).astype(np.float32))
    batches[..., 23] = (batches[..., 23] > 0).float()
    batches[..., 24] = 1.0
    out = []
    for seed in (7, torch.tensor(7)):
        p = {k: v.clone() for k, v in groups.items()}
        m, v = fused_step.zeros_like_groups(p), fused_step.zeros_like_groups(p)
        out.append(fused_step.run_epoch_reference(p, m, v, batches, seed, 2, lr=0.004, clip=1.0,
                                                  seed_offset=1))
    for a, b in zip(out[0][:3], out[1][:3]):
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(out[0][3], out[1][3])
    # the wrapper takes the tensor on the CPU too, and refuses another dtype
    p = {k: v.clone() for k, v in groups.items()}
    fused_step.run_epoch(p, fused_step.zeros_like_groups(p), fused_step.zeros_like_groups(p),
                         batches, torch.tensor(7), 2, lr=0.004, clip=1.0, seed_offset=1)
    assert all(torch.equal(p[k], out[0][0][k]) for k in p)
    with pytest.raises(ValueError, match="int64"):
        fused_step.run_epoch(p, fused_step.zeros_like_groups(p),
                             fused_step.zeros_like_groups(p), batches,
                             torch.tensor(7.0), 2, lr=0.004, clip=1.0)


def test_draw_round_keeps_the_seed_on_the_device():
    """The draw's seed is a 0-dim int64 tensor holding the int the
    generator gives at that point of the draw."""
    kw = dict(num_clients=6, pool_size=50, lo=3, hi=9, epochs=2, num_genuine=4,
              leak_groups=[2], leak_k=3)
    d = draw_round(torch.Generator().manual_seed(3), **kw)
    g = torch.Generator().manual_seed(3)
    torch.randint(3, 10, (6,), generator=g)
    torch.randint(0, 50, (6, 9), generator=g)
    torch.rand((2, 6, 9), generator=g)
    expected = int(torch.randint(0, 2 ** 31 - 1, (), generator=g))
    assert isinstance(d.dropout_seed, torch.Tensor)
    assert d.dropout_seed.dtype == torch.int64 and d.dropout_seed.shape == ()
    assert int(d.dropout_seed) == expected
    # the draws after the seed are those of the int-seed draw
    assert torch.equal(d.leaks[0], torch.argsort(torch.rand((2, 4), generator=g), dim=-1)[:, :3])


def test_round_step_is_unchanged_by_the_tensor_seed(tmp_path):
    """The round step under either backend gives the same rows from the
    draw's tensor seed as from its int."""
    for backend in ("pallas", "xla"):
        sim = Simulator(_cfg(tmp_path, local_backend=backend), device="cpu")
        state = sim.init_state()
        draws = sim.draw_round(torch.Generator().manual_seed(2))
        as_int = dataclasses.replace(draws, dropout_seed=int(draws.dropout_seed))
        a = sim.round_step(state["global_params"], state["prev_genuine"], False, draws, 1)
        b = sim.round_step(state["global_params"], state["prev_genuine"], False, as_int, 1)
        assert all(torch.equal(x, y) for x, y in zip(pt.tree_leaves(a[0]), pt.tree_leaves(b[0])))
        assert torch.equal(a[4], b[4])
    assert os.path.exists(tmp_path / "app.log")
