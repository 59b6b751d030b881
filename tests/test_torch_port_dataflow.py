"""The port's differentiability dataflow pass (``analysis/dataflow.py``)
on the CPU, against the JAX package.

1. The per-defense table on JAX's inputs (``audit_config()``'s initial
   params from the JAX package, converted with ``weights.py`` and
   broadcast to 4 rows; sizes and the weights mask all ones): every
   verdict equals ``tests/data/grad_audit_report.json``'s, no defense is
   flat, and krum's one cliff is ``zero_grad`` at its ``argmin`` line in
   ``attackfl_tpu_torch/ops/aggregators.py``.  The report has JAX's keys.
2. Torch fixtures written into ``tmp_path`` mirror JAX's three committed
   ones (``tests/data/analysis_fixtures/``): ``.detach()``,
   ``.to(torch.int32)`` and ``argsort``/``argmin`` indices.  Each is flat
   and gives the rules JAX's ``analyze_fixture`` gives on its own fixture,
   at the expected lines.
3. The aggregate-level damage's gradient (the table's objective) against
   ``jax.grad`` for all ten modes, in float64 (JAX under ``enable_x64``),
   on distinct seeded rows (not broadcast ones, so that sort ties cannot
   route the gradient to another row); ScionFL's uniforms and FLTrust's
   root shuffles from JAX's key, FLTrust's root training with dropout off
   in both packages.  Within 1e-5 of the gradient's largest magnitude,
   FLTrust within 5e-4 (``GRAD_TOL``).
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_threads import one_torch_thread  # noqa: F401

from attackfl_tpu.analysis.dataflow import analyze_fixture as jax_analyze_fixture
from attackfl_tpu.config import audit_config as jax_audit_config
from attackfl_tpu.data.synthetic import get_dataset as jax_get_dataset
from attackfl_tpu.models.icu import CNNModel as JaxCNNModel
from attackfl_tpu.training.round import build_aggregator as jax_build_aggregator
from attackfl_tpu_torch.analysis import dataflow
from attackfl_tpu_torch.analysis.grad_audit import first_order
from attackfl_tpu_torch.config import audit_config
from attackfl_tpu_torch.data.partition import RoundDraws
from attackfl_tpu_torch.models.icu import CNNModel
from attackfl_tpu_torch.ops import pytree as pt
from attackfl_tpu_torch.training.round import ROOT_SIZE, build_aggregator
from attackfl_tpu_torch.weights import params_from_jax

REPO = Path(__file__).resolve().parent.parent
DATA = REPO / "tests" / "data"
# of the gradient's largest magnitude, float64 on both sides.  FLTrust
# trains its root set, where JAX's loss rounds the model's output to
# float32 (see tests/test_torch_port_models_cnn.py): the two root updates
# part by 1.0e-6 in one fc1 kernel entry, which the gradient's component
# along the root delta carries (measured 1.3e-4)
GRAD_TOL = {"FLTrust": 5e-4}
DEFAULT_TOL = 1e-5


def _jax_params():
    cfg = jax_audit_config()
    return JaxCNNModel().init(jax.random.key(0, impl=cfg.prng_impl), jnp.zeros((1, 7)),
                              jnp.zeros((1, 16)))["params"]


@pytest.fixture(scope="module")
def table(tmp_path_factory):
    params = params_from_jax(jax.tree.map(np.asarray, _jax_params()), "CNNModel")
    return dataflow.defense_dataflow_reports(params=params)


def test_verdicts_match_the_golden_table(table):
    golden = {d["name"]: d for d in json.loads(
        (DATA / "grad_audit_report.json").read_text())["dataflow"]}
    assert [r.name for r in table] == sorted(golden)
    assert {r.name: r.verdict for r in table} == {k: d["verdict"] for k, d in golden.items()}
    assert dataflow.defense_findings(table) == []
    for r in table:
        assert sorted(r.to_dict()) == sorted(golden[r.name])
        assert r.reachability > 0.5 and r.touched_eqns >= r.live_eqns > 0, r.name
        assert (r.cliffs == []) == (r.name != "defense:krum"), r.name


def test_krums_cliff_is_its_argmin(table):
    source = (REPO / "attackfl_tpu_torch" / "ops" / "aggregators.py").read_text().splitlines()
    start = next(i for i, line in enumerate(source) if line.startswith("def krum_select"))
    line = next(i + 1 for i, text in enumerate(source[start:], start)
                if "torch.argmin(torch.sum(closest" in text)
    (krum,) = [r for r in table if r.name == "defense:krum"]
    assert krum.cliffs == [{"kind": "zero_grad", "primitive": "argmin",
                            "file": "attackfl_tpu_torch/ops/aggregators.py", "line": line}]
    assert 0.9 < krum.reachability < 1.0 and "argmin" in krum.piecewise


FIXTURES = {
    "stop_gradient_path": ('''import torch


def objective(perturb, target):
    poisoned = perturb.detach() + target  # line 5: cliff
    return torch.sum((poisoned - target) ** 2)


def example_args():
    return (torch.ones(4), torch.zeros(4))
''', [5]),
    "integer_cast_path": ('''import torch


def objective(perturb, target):
    quantized = perturb.to(torch.int32)  # line 5: cliff (f32 -> i32)
    return torch.sum((quantized.to(torch.float32) - target) ** 2)


def example_args():
    return (torch.ones(4) * 2.5, torch.zeros(4))
''', [5]),
    "zero_grad_sort": ('''import torch


def objective(perturb, scores):
    order = torch.argsort(perturb)  # line 5: cliff (index output)
    best = torch.argmin(perturb)  # line 6: cliff (index output)
    picked = scores[order[:1]] + scores[best[None]]
    return torch.sum(picked.to(torch.float32))


def example_args():
    return (torch.arange(4, dtype=torch.float32), torch.ones(4))
''', [5, 6]),
}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_gives_jaxs_rules(name, tmp_path):
    source, lines = FIXTURES[name]
    path = tmp_path / f"{name}.py"
    path.write_text(source)
    report, findings = dataflow.analyze_fixture(path)
    jreport, jfindings = jax_analyze_fixture(DATA / "analysis_fixtures" / f"{name}.py")
    assert report.flat and jreport.flat
    assert sorted((f.rule, f.line) for f in findings) == sorted(
        zip([f.rule for f in jfindings], lines))
    for f in findings:
        assert f.file == str(path) and "flat in the attack params" in f.message


# ---------------------------------------------------------------------------
# 3. the aggregate-level gradient against jax.grad
# ---------------------------------------------------------------------------

def _jax_damage(agg):
    def damage(perturb, params, stacked, sizes, wmask, rng):
        poisoned = jax.tree.map(lambda s, p: s + p, stacked, perturb)
        new = agg(params, poisoned, sizes, wmask, rng)
        sq = jax.tree.map(lambda a, b: jnp.sum((a - b) ** 2), new, params)
        return jax.tree.reduce(lambda a, b: a + b, sq)
    return damage


def _jax_draws(rng, n: int, p: int, epochs: int, n_root: int) -> RoundDraws:
    """ScionFL's uniforms (``jax.random.bernoulli``'s, float64 under x64)
    and FLTrust's root shuffles (JAX local.py:139-142) of one key."""
    keys = jax.random.split(rng, n)
    uniform = torch.from_numpy(np.array(jax.vmap(
        lambda k: jax.random.uniform(k, (p,), jnp.float64))(keys)))
    eks = jax.random.split(rng, epochs)
    root_perms = torch.from_numpy(np.stack([
        np.asarray(jax.random.permutation(jax.random.split(eks[e])[0], n_root))[None]
        for e in range(epochs)]).astype(np.int64))
    empty = torch.zeros((n, 0), dtype=torch.int64)
    return RoundDraws(idx=empty, mask=empty.bool(), sizes=torch.ones(n, dtype=torch.int64),
                      perms=empty[None], dropout_seed=0, leaks=(), uniform=uniform,
                      root_perms=root_perms, root_seed=0)


@pytest.fixture(scope="module")
def gradient_inputs(tmp_path_factory):
    cfg = audit_config(str(tmp_path_factory.mktemp("grad")))
    n = cfg.total_clients
    test_np = jax_get_dataset(cfg.data_name, "test", cfg.test_size, cfg.random_seed)
    rng_np = np.random.default_rng(11)
    params = jax.tree.map(lambda x: np.asarray(x, np.float64), _jax_params())
    stacked = jax.tree.map(lambda x: x[None] + 0.01 * rng_np.standard_normal((n,) + x.shape),
                           params)
    perturb = jax.tree.map(lambda x: 0.01 * rng_np.standard_normal(x.shape), stacked)
    num_params = sum(x.size for x in jax.tree.leaves(params))
    key = jax.random.key(7, impl="threefry2x32")
    with jax.enable_x64(True):
        draws = _jax_draws(key, n, num_params, cfg.epochs, min(ROOT_SIZE, cfg.test_size))
    return cfg, test_np, (perturb, params, stacked), key, draws


@pytest.mark.parametrize("mode", dataflow.DEFENSE_MODES)
def test_aggregate_damage_gradient_matches_jax(mode, gradient_inputs):
    cfg, test_np, (perturb, params, stacked), key, draws = gradient_inputs
    n = cfg.total_clients
    with jax.enable_x64(True):
        jcfg = jax_audit_config(mode=mode)
        agg = jax_build_aggregator(JaxCNNModel(dropout_rate=0.0), jcfg, test_np)
        as_jax = lambda t: jax.tree.map(jnp.asarray, t)  # noqa: E731
        want = jax.jit(jax.grad(_jax_damage(agg)))(
            as_jax(perturb), as_jax(params), as_jax(stacked), jnp.ones((n,), jnp.int32),
            jnp.ones((n,), jnp.float32), key)
    test = {k: torch.from_numpy(v.astype(np.float64) if v.dtype.kind == "f" else v)
            for k, v in test_np.items()}
    aggregate = build_aggregator(CNNModel(dropout_rate=0.0), cfg.replace(mode=mode), test)
    to_port = lambda t: pt.tree_map(lambda x: torch.from_numpy(np.asarray(x)), t)  # noqa: E731
    got = first_order(dataflow.damage(aggregate))(
        to_port(perturb), to_port(params), to_port(stacked), torch.ones(n, dtype=torch.int64),
        torch.ones(n), draws)
    ref = dict(pt.tree_items(pt.tree_map(np.asarray, want)))
    scale = max(float(np.abs(x).max()) for x in ref.values())
    err = max(float(np.abs(x.numpy() - ref[p]).max()) for p, x in pt.tree_items(got))
    assert scale > 0 and err <= GRAD_TOL.get(mode, DEFAULT_TOL) * scale, (mode, err, scale)
