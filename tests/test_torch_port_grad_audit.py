"""The port's differentiable round and its grad-program audit
(``training/local.adam_step``, ``Simulator.damage_objective``,
``analysis/grad_audit.py``, ``audit --grad``) on the CPU, against the JAX
package.

1. Bits: ``adam_step`` (out of place) equals the in-place form of the
   same optax step on p, m and v over several steps; the local update
   under a gradient equals the update without one bit for bit and refuses
   a segment; each objective's value under a gradient equals its value
   under ``no_grad``; FLTrust's root seed, now a 0-dim device tensor,
   gives the root update of the int it holds.
2. The objectives' shape: entry names, executors and ``donate`` as JAX's
   ``damage_objective`` for fedavg, median and FLTrust; hyper raises as
   JAX does.
3. Gradients against ``jax.grad`` at ``audit_config()`` (CNNModel, dropout
   off in both packages, whose masks come from different generators) in
   float64, as tests/test_torch_port_models_cnn.py runs the CNN (in
   float32 Adam's first step from m = v = 0 parts the two packages'
   trajectories by 1e-2), on JAX's draws and JAX's initial params:
   ``sync_damage`` within 2e-4 of the gradient's largest magnitude (JAX's
   loss rounds the model's output to float32; measured 7.8e-5);
   ``fused_damage[2]`` at JAX's default state exactly 0 in both, and at
   the attacking state (``have_genuine``, broadcast 1) with the same
   non-finite entries (Adam's ``sqrt(v)`` differentiated at ``v = 0``) and
   the finite ones within 1e-6 of their largest magnitude (measured
   2.2e-8).  One JAX gradient compile of each kind.
4. Under ``local_backend: pallas`` the port refuses the fused gradient
   naming K1's missing backward, where ``jax.grad`` raises
   ``NotImplementedError``; both differentiate ``sync_damage``.
5. The grad programs: the six first-order programs and the three double
   backward traces of ``audit --grad --json --device cpu`` are ok (no
   ``_local_scalar_dense``, FLTrust's included, no float64, no input
   written, the gradient the perturbation's tree), the mesh reports are
   marked skipped, and the report has JAX's schema-2 keys.  The fused
   objective's double backward traces at the attacking state too (third
   order through local training, on fake tensors).
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_models import as_t, jax_perms
from _torch_port_threads import one_torch_thread  # noqa: F401

from attackfl_tpu.config import audit_config as jax_audit_config
from attackfl_tpu.data.partition import sample_round_indices as jax_sample_round_indices
from attackfl_tpu.models.icu import CNNModel as JaxCNNModel
from attackfl_tpu.training import engine as jengine
from attackfl_tpu.training import round as jround
from attackfl_tpu_torch import cli as port_cli
from attackfl_tpu_torch.analysis import grad_audit
from attackfl_tpu_torch.config import audit_config
from attackfl_tpu_torch.data.partition import RoundDraws, draw_round
from attackfl_tpu_torch.models.icu import CNNModel
from attackfl_tpu_torch.ops import pytree as pt
from attackfl_tpu_torch.training import engine, local
from attackfl_tpu_torch.training import round as tround
from attackfl_tpu_torch.training.engine import Simulator
from attackfl_tpu_torch.weights import params_from_jax

DATA = Path(__file__).resolve().parent / "data"
# of max |g|, float64: JAX's loss rounds the model's output to float32,
# which parts the two packages' trained rows by up to ~5e-6 (as in
# tests/test_torch_port_models_cnn.py); measured 7.8e-5 for sync_damage,
# 2.2e-8 over the fused gradient's finite entries
SYNC_TOL = 2e-4
FUSED_TOL = 1e-6
VALUE_TOL = 1e-6     # relative, sync_damage's value
PERTURB_STD = 1e-2


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        as_int = {torch.float32: torch.int32, torch.float64: torch.int64}[a.dtype]
        return torch.equal(a.contiguous().view(as_int), b.contiguous().view(as_int))
    return torch.equal(a, b)


def _trees_equal(a: dict, b: dict) -> bool:
    return all(p == q and _same_bits(x, y) for (p, x), (q, y) in
               zip(pt.tree_items(a), pt.tree_items(b)))


# ---------------------------------------------------------------------------
# 1. bits
# ---------------------------------------------------------------------------

def _adam_step_in_place(p, m, v, g, t, lr):
    """optax ``adam`` then ``apply_updates`` written in place."""
    m.mul_(local.B1).add_(g, alpha=1.0 - local.B1)
    v.mul_(local.B2).addcmul_(g, g, value=1.0 - local.B2)
    bc1 = float(np.float32(1.0 - local.B1 ** t))
    bc2 = float(np.float32(1.0 - local.B2 ** t))
    p.add_((m / bc1) / (torch.sqrt(v / bc2) + local.EPS), alpha=-lr)


def test_adam_step_equals_the_in_place_step_bit_for_bit():
    gen = torch.Generator().manual_seed(0)
    p0 = torch.randn(4, 1000, generator=gen)
    p, m, v = p0.clone(), torch.zeros_like(p0), torch.zeros_like(p0)
    opt = {"p": p0.clone(), "m": torch.zeros_like(p0), "v": torch.zeros_like(p0)}
    for t in range(1, 7):
        g = torch.randn(4, 1000, generator=gen) * 10.0 ** -t
        g[0, :10] = 0.0
        old, kept = dict(opt), {k: x.clone() for k, x in opt.items()}
        _adam_step_in_place(p, m, v, g, t, 0.004)
        local.adam_step(opt, g, t, 0.004)
        # rebound, and the old tensors (which autograd may have saved) unwritten
        assert all(opt[k] is not old[k] and torch.equal(old[k], kept[k]) for k in "pmv"), t
        assert _same_bits(p, opt["p"]) and _same_bits(m, opt["m"]), t
        assert _same_bits(v, opt["v"]), t


def _local_update(tmp_path):
    sim = Simulator(audit_config(str(tmp_path)), device="cpu")
    cfg = sim.cfg
    update = local.build_local_update(sim.model, cfg.data_name, sim.train_data,
                                      epochs=2, batch_size=cfg.batch_size, lr=cfg.lr,
                                      clip_grad_norm=cfg.clip_grad_norm)
    draws = sim.draw_round(torch.Generator().manual_seed(4))
    perms = torch.cat([draws.perms, draws.perms])
    params = sim.init_state()["global_params"]
    sim.close()
    return update, params, (draws.idx, draws.mask, perms, draws.dropout_seed)


def test_local_update_under_a_gradient_keeps_the_bits(tmp_path):
    update, params, args = _local_update(tmp_path)
    assert not pt.under_gradient(params)
    plain = update(params, *args)
    tracked = pt.tree_map(lambda x: x.detach().requires_grad_(), params)
    assert pt.under_gradient(tracked)
    with torch.enable_grad():
        out = update(tracked, *args)
    assert out[0]["fc1"]["kernel"].requires_grad
    assert _trees_equal(plain[0], pt.tree_map(torch.Tensor.detach, out[0]))
    assert torch.equal(plain[1], out[1]) and _same_bits(plain[2], out[2].detach())
    with pytest.raises(ValueError, match="runs no segment"):
        with torch.enable_grad():
            update(tracked, *args, segment=2)


@pytest.fixture(scope="module")
def fedavg_sim(tmp_path_factory):
    sim = Simulator(audit_config(str(tmp_path_factory.mktemp("fedavg"))), device="cpu")
    yield sim
    sim.close()


def _attacking(sim) -> dict:
    return dict(sim.init_state(), have_genuine=True, broadcasts=1)


def _perturb(tree: dict, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return pt.tree_map(lambda x: torch.from_numpy(
        (PERTURB_STD * rng.standard_normal(tuple(x.shape))).astype(np.float32)), tree)


@pytest.mark.parametrize("attacking", [False, True], ids=["default", "attacking"])
def test_value_under_a_gradient_equals_no_grad(fedavg_sim, attacking):
    sim = fedavg_sim
    for entry in sim.damage_objective(_attacking(sim) if attacking else None):
        args = (_perturb(entry["args"][0]),) + tuple(entry["args"][1:])
        with torch.no_grad():
            plain = entry["objective"](*args)
        p = pt.tree_map(lambda x: x.requires_grad_(), args[0])
        with torch.enable_grad():
            value = entry["objective"](p, *args[1:])
        assert value.requires_grad and _same_bits(plain, value.detach()), entry["name"]


def test_fltrust_root_seed_stays_on_the_device_with_the_ints_bits(tmp_path):
    sim = Simulator(audit_config(str(tmp_path), mode="FLTrust"), device="cpu")
    root = {k: v[:tround.ROOT_SIZE] for k, v in sim.test_data.items()}
    kw = dict(num_clients=4, pool_size=64, lo=8, hi=12, epochs=2, num_genuine=3,
              leak_groups=[1], leak_k=1, root_size=root["label"].shape[0])
    d = draw_round(torch.Generator().manual_seed(3), **kw)
    assert isinstance(d.root_seed, torch.Tensor) and d.root_seed.dim() == 0
    assert d.root_seed.dtype == torch.int64
    update = local.build_root_update(sim.model, "ICU", root, epochs=2,
                                     batch_size=tround.ROOT_BATCH, lr=sim.cfg.lr,
                                     clip_grad_norm=sim.cfg.clip_grad_norm)
    params = sim.init_state()["global_params"]
    sim.close()
    on_device = update(params, d.root_perms, d.root_seed)
    as_int = update(params, d.root_perms, int(d.root_seed))
    assert _trees_equal(on_device, as_int)


# ---------------------------------------------------------------------------
# 2. the objectives' shape
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", grad_audit.GRAD_MODES)
def test_damage_objective_entries_as_jaxs(mode, tmp_path):
    jsim = jengine.Simulator(jax_audit_config(mode=mode))
    try:
        theirs = [(e["name"], e["executor"], e["donate"]) for e in jsim.damage_objective()]
    finally:
        jsim.close()
    sim = Simulator(audit_config(str(tmp_path), mode=mode), device="cpu")
    try:
        entries = sim.damage_objective()
    finally:
        sim.close()
    assert [(e["name"], e["executor"], e["donate"]) for e in entries] == theirs
    assert all(sorted(e) == ["args", "donate", "executor", "name", "objective"]
               for e in entries)


def test_hyper_raises_as_jax(tmp_path):
    jsim = jengine.Simulator(jax_audit_config(mode="hyper"))
    try:
        with pytest.raises(NotImplementedError) as theirs:
            jsim.damage_objective()
    finally:
        jsim.close()
    sim = Simulator(audit_config(str(tmp_path), mode="hyper"), device="cpu")
    try:
        with pytest.raises(NotImplementedError) as ours:
            sim.damage_objective()
    finally:
        sim.close()
    assert str(ours.value) == str(theirs.value)


# ---------------------------------------------------------------------------
# 3. gradients against jax.grad, float64, dropout off
# ---------------------------------------------------------------------------

def _f64_dataset(get_dataset):
    def load(*args, **kw):
        return {k: v.astype(np.float64) if v.dtype.kind == "f" else v
                for k, v in get_dataset(*args, **kw).items()}
    return load


def jax_round_draws(k_round, cfg, groups, genuine: int, pool: int) -> RoundDraws:
    """The port's draws of a JAX round key (JAX round.py:273-322, no
    stragglers, dropout off), under the x64 mode the round ran in (its
    integer draws depend on it)."""
    lo, hi = cfg.num_data_range
    k_data, k_train, k_attack = jax.random.split(k_round, 3)
    idx, mask, sizes = jax_sample_round_indices(k_data, cfg.total_clients, pool, lo, hi)
    leak_k = min(max(int(cfg.genuine_rate * genuine), 1), genuine)
    leaks = []
    for gi, grp in enumerate(groups):
        keys = jax.random.split(jax.random.fold_in(k_attack, gi), len(grp.indices))
        leaks.append(as_t(jax.vmap(lambda key: jax.random.choice(
            jax.random.split(key)[0], genuine, (leak_k,), replace=False))(keys)))
    return RoundDraws(idx=as_t(idx), mask=torch.from_numpy(np.array(mask)), sizes=as_t(sizes),
                      perms=jax_perms(jax.random.split(k_train, cfg.total_clients),
                                      cfg.epochs, hi),
                      dropout_seed=0, leaks=tuple(leaks))


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """Both packages' fedavg Simulators at audit_config (threefry keys),
    CNNModel with dropout off, float64 data and state, from JAX's initial
    params: ``(jax_sim, port_sim, jax_state, port_state)``."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jengine, "get_model", lambda name: JaxCNNModel(dropout_rate=0.0))
    mp.setattr(engine, "get_model", lambda name: CNNModel(dropout_rate=0.0))
    mp.setattr(engine, "get_dataset", _f64_dataset(engine.get_dataset))
    kw = dict(prng_impl="threefry2x32")
    try:
        with jax.enable_x64(True):
            jsim = jengine.Simulator(jax_audit_config(**kw))
            jstate = jsim.init_state()
            f64 = lambda t: jax.tree.map(lambda x: jnp.asarray(x, jnp.float64), t)  # noqa: E731
            jstate = dict(jstate, global_params=f64(jstate["global_params"]),
                          prev_genuine=f64(jstate["prev_genuine"]))
        sim = Simulator(audit_config(str(tmp_path_factory.mktemp("both")), **kw), device="cpu")
    finally:
        mp.undo()
    state = sim.init_state()
    to_port = lambda t: pt.tree_map(torch.Tensor.double, params_from_jax(  # noqa: E731
        jax.tree.map(np.asarray, t), "CNNModel"))
    state = dict(state, global_params=to_port(jstate["global_params"]),
                 prev_genuine=to_port(jstate["prev_genuine"]))
    yield jsim, sim, jstate, state
    jsim.close()
    sim.close()


def _jax_perturb(perturb: dict) -> dict:
    return pt.tree_map(lambda x: jnp.asarray(x.numpy()), perturb)


def _jax_draws_of(jsim, sim, k_round) -> RoundDraws:
    _, genuine = jround.build_attack_groups(jsim.cfg)
    return jax_round_draws(k_round, jsim.cfg, jsim.attack_groups, len(genuine), sim.pool_size)


def _grad(entry, args) -> dict:
    return grad_audit.first_order(entry["objective"])(*args)


def _max_abs(tree) -> float:
    return max(float(np.abs(np.asarray(x)).max()) for x in pt.tree_leaves(tree))


def test_sync_damage_gradient_matches_jax(both):
    jsim, sim, jstate, state = both
    with jax.enable_x64(True):
        (jentry, *_) = jsim.damage_objective(jstate)
        _, k_round, _ = jax.random.split(jstate["rng"], 3)
        (entry, *_) = sim.damage_objective(state)
        perturb = pt.tree_map(torch.Tensor.double, _perturb(entry["args"][0]))
        jargs = (_jax_perturb(perturb),) + tuple(jentry["args"][1:])
        want = jax.jit(jax.grad(jentry["objective"]))(*jargs)
        want_value = float(jax.jit(jentry["objective"])(*jargs))
        draws = _jax_draws_of(jsim, sim, k_round)
    args = (perturb,) + tuple(entry["args"][1:4]) + (draws, 1)
    got = _grad(entry, args)
    with torch.no_grad():
        value = float(entry["objective"](*args))
    ref = dict(pt.tree_items(pt.tree_map(np.asarray, want)))
    scale = _max_abs(ref)
    err = max(float(np.abs(x.numpy() - ref[p]).max()) for p, x in pt.tree_items(got))
    assert scale > 0 and err <= SYNC_TOL * scale, (err, scale)
    assert abs(value - want_value) <= VALUE_TOL * abs(want_value), (value, want_value)


def test_fused_damage_gradient_matches_jax(both):
    jsim, sim, jstate, state = both
    cases = {"default": (jstate, state),
             "attacking": (dict(jstate, have_genuine=True, broadcasts=1),
                           dict(state, have_genuine=True, broadcasts=1))}
    with jax.enable_x64(True):
        grad = None
        theirs = {}
        for label, (js, ps) in cases.items():
            jentry = jsim.damage_objective(js)[1]
            grad = grad or jax.jit(jax.grad(jentry["objective"]))
            pool = pt.tree_map(torch.Tensor.double, _perturb(ps["prev_genuine"], seed=1))
            theirs[label] = (pool, grad(_jax_perturb(pool), *jentry["args"][1:]),
                             jentry["args"][1]["rng"])
    for label, (_, ps) in cases.items():
        pool, want, key = theirs[label]
        # the port's body draws JAX's rounds: split(rng, 3) a broadcast
        keys = []
        for _ in range(2):
            key, k_round, _ = jax.random.split(key, 3)
            keys.append(k_round)
        with jax.enable_x64(True):
            schedule = iter([_jax_draws_of(jsim, sim, k) for k in keys])
        entry = sim.damage_objective(ps)[1]
        drawer = sim._drawer
        sim._drawer = lambda gen, leak_pool=None: next(schedule)
        try:
            got = _grad(entry, (pool,) + tuple(entry["args"][1:]))
        finally:
            sim._drawer = drawer
        ref = dict(pt.tree_items(pt.tree_map(np.asarray, want)))
        if label == "default":
            assert all(not np.any(ref[p]) and not torch.any(x) for p, x in pt.tree_items(got))
            continue
        bad = {p: ~np.isfinite(ref[p]) for p in ref}
        assert sum(int(b.sum()) for b in bad.values()) > 0
        for p, x in pt.tree_items(got):
            np.testing.assert_array_equal(~np.isfinite(x.numpy()), bad[p], err_msg=p)
        scale = max(float(np.abs(np.where(bad[p], 0, ref[p])).max()) for p in ref)
        err = max(float(np.abs(np.where(bad[p], 0, x.numpy() - ref[p])).max())
                  for p, x in pt.tree_items(got))
        assert scale > 0 and err <= FUSED_TOL * scale, (err, scale)


# ---------------------------------------------------------------------------
# 4. local_backend: pallas
# ---------------------------------------------------------------------------

def test_pallas_refuses_the_fused_gradient_as_jax(tmp_path):
    kw = dict(model="TransformerModel", local_backend="pallas")
    jsim = jengine.Simulator(jax_audit_config(**kw))
    try:
        jentries = jsim.damage_objective()
        zeros = lambda a: jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), a)  # noqa: E731
        with pytest.raises(NotImplementedError):
            jax.grad(jentries[1]["objective"])(zeros(jentries[1]["args"][0]),
                                               *jentries[1]["args"][1:])
    finally:
        jsim.close()
    sim = Simulator(audit_config(str(tmp_path), **kw), device="cpu")
    try:
        sync, fused = sim.damage_objective()
        assert torch.isfinite(pt.tree_leaves(_grad(sync, sync["args"]))[0]).all()
        with torch.no_grad():
            assert torch.isfinite(fused["objective"](*fused["args"]))
        with pytest.raises(NotImplementedError, match="'pallas' has no backward"):
            _grad(fused, fused["args"])
    finally:
        sim.close()


# ---------------------------------------------------------------------------
# 5. the grad programs and the command
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def grad_command():
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = port_cli.main(["audit", "--grad", "--json", "--device", "cpu"])
    return rc, json.loads(out.getvalue())


def test_audit_grad_command_has_jaxs_keys(grad_command):
    rc, report = grad_command
    golden = json.loads((DATA / "audit_report.json").read_text())
    assert rc == 0 and report["ok"] is True and report["findings"] == []
    assert list(report) == list(golden) and report["schema"] == 2
    grad_golden = json.loads((DATA / "grad_audit_report.json").read_text())
    for p in report["grad_programs"]:
        assert set(grad_golden["programs"][0]) <= set(p)
    assert len(report["dataflow"]) == 10
    for d in report["dataflow"]:
        assert set(d) == set(grad_golden["dataflow"][0])


def test_grad_programs_are_clean(grad_command):
    _, report = grad_command
    by_name = {p["name"]: p for p in report["grad_programs"]}
    first = [f"{m}:grad[{o}]" for m in grad_audit.GRAD_MODES
             for o in ("sync_damage", "fused_damage[2]")]
    second = [f"{m}:grad2[sync_damage]" for m in grad_audit.GRAD_MODES]
    skipped = [f"sharded-{m}:grad[aggregate]" for m in grad_audit.GRAD_MODES]
    assert sorted(by_name) == sorted(first + second + skipped)
    for name in first + second:
        p = by_name[name]
        assert p["ok"] and p["syncs"] == 0 and p["forbidden_primitives"] == [], name
        assert p["f64_outputs"] == 0 and p["inplace_inputs"] == {}, name
        assert p["skipped"] is None and p["eqns"] > 0, name
    for name in first:
        p = by_name[name]
        assert p["donated_args"] == [0] and p["donated_leaves"] == 20, name
        assert p["aliased_leaves"] == p["expected_aliases"] == 20, name
    for name in skipped:
        assert "item 14" in by_name[name]["skipped"] and by_name[name]["ok"]


def test_a_wrong_gradient_tree_is_a_problem():
    perturb = {"a": torch.zeros(2, 3), "b": {"c": torch.zeros(4)}}
    check = grad_audit.tree_check(perturb)
    assert check(pt.tree_map(torch.ones_like, perturb)) == [] and check.matched == 2
    (problem,) = check({"a": torch.zeros(2, 3), "b": {"c": torch.zeros(4, dtype=torch.float64)}})
    assert "not the perturbation's" in problem and check.matched == 1


def test_fused_double_backward_traces_through_training(fedavg_sim):
    fused = fedavg_sim.damage_objective(_attacking(fedavg_sim))[1]
    report = grad_audit.trace_program("fedavg:grad2[fused_damage[2]]", "fused",
                                      grad_audit.double_backward(fused["objective"]),
                                      fused["args"], "cpu")
    assert report.ok and report.ops > 10000 and not report.syncs and not report.f64
