"""The port's defenses (``attackfl_tpu_torch/ops/aggregators.py``,
``ops/stats.py``, ``ops/defenses.py`` and ``training/local.build_root_update``)
against the JAX package's on identical inputs, on the CPU.

Stacked inputs are made with numpy from a seed: 8 clients on a small tree
of four leaves, six benign rows around a shared base and two attackers
pointing the other way, so that byzantine and ScionFL filter someone.
Each rule runs unmasked and under two drop patterns (one drops row 0, the
byzantine anchor), on finite rows and with a valid row holding a NaN and
an inf.

Tolerances: Krum's index, byzantine's and ScionFL's keep masks and
ScionFL's bits equal (the decision margins of these inputs are asserted
above 1e-4 first: Krum's runner-up scores lie 1.2-20% above the best,
the clients nearest ScionFL's threshold 1.8-16% of it away); every
aggregate within 1e-6 (float32, reductions in another order), NaN where
JAX gives NaN, except ShieldFL's: its weights 1 / (1 - cos + 1e-6)
magnify float32 rounding in cos by 1 / (1 - cos), about 50 here, and
both packages land ~7e-7 from a float64 evaluation of the same formula,
so the port is held within 1e-6 of that evaluation and within 2e-6 (the
two errors) of JAX; FLTrust's root update within 2e-4, the ``xla``
update's bound (two epochs of clipped Adam); the numpy copies within
1e-12 (Mahalanobis, MAD, PCA up to a column's sign) and 1e-10 (GMM means
and covariances) of the JAX package's on float64 matrices, the gmm and
fltracer decisions identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_threads import one_torch_thread  # noqa: F401

from attackfl_tpu.data.synthetic import get_dataset as jax_get_dataset
from attackfl_tpu.models.icu import TransformerModel as JaxTransformerModel
from attackfl_tpu.ops import aggregators as jagg
from attackfl_tpu.ops import defenses as jdef
from attackfl_tpu.ops import stats as jstats
from attackfl_tpu.training import local as jlocal
from attackfl_tpu_torch.ops import aggregators as agg
from attackfl_tpu_torch.ops import defenses, stats
from attackfl_tpu_torch.ops import pytree as pt
from attackfl_tpu_torch.training import local
from attackfl_tpu_torch.weights import params_from_jax
from tests.test_torch_port_local import JaxDropoutOff, PortDropoutOff

C = 8
SHAPES = {"dense": {"bias": (5,), "kernel": (3, 5)}, "head": {"kernel": (7,)},
          "norm": {"scale": (4, 2)}}
MASKS = {"unmasked": None,
         "drop_two": [1, 1, 0, 1, 1, 0, 1, 1],
         "drop_first": [0, 1, 1, 1, 0, 1, 1, 1]}
BAD_ROW = 2            # valid under every pattern
AGG_TOL = 1e-6
SHIELDFL_TOL = 2e-6    # two float32 errors of AGG_TOL each, see the docstring
MARGIN = 1e-4          # relative decision margin the inputs must clear


def _stacked(seed: int = 0, bad: bool = False) -> dict:
    """Six benign rows (a shared base plus 0.2 noise) and two attackers
    (-0.5 base plus noise), numpy float32."""
    rng = np.random.default_rng(seed)

    def leaf(shape):
        base = rng.standard_normal(shape)
        rows = base + 0.2 * rng.standard_normal((C,) + shape)
        rows[6:] = -0.5 * base + 0.2 * rng.standard_normal((2,) + shape)
        return rows.astype(np.float32)

    tree = _map_shapes(SHAPES, leaf)
    if bad:
        tree["dense"]["kernel"][BAD_ROW, 1, 2] = np.nan
        tree["head"]["kernel"][BAD_ROW, 3] = np.inf
    return tree


def _map_shapes(shapes: dict, fn) -> dict:
    return {k: _map_shapes(v, fn) if isinstance(v, dict) else fn(v) for k, v in shapes.items()}


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _port(tree):
    return pt.tree_map(torch.from_numpy, tree)


def _jmask(name):
    return None if MASKS[name] is None else jnp.asarray(MASKS[name], jnp.float32)


def _tmask(name):
    return None if MASKS[name] is None else torch.tensor(MASKS[name], dtype=torch.float32)


def _assert_trees_close(ours: dict, ref, tol: float = AGG_TOL) -> None:
    ref_leaves = dict(pt.tree_items(pt.tree_map(np.asarray, ref)))
    for path, x in pt.tree_items(ours):
        np.testing.assert_allclose(x.detach().numpy(), ref_leaves[path], rtol=0, atol=tol,
                                   equal_nan=True, err_msg=path)


AGGREGATES = {
    "mean": (jagg.mean_aggregation, agg.mean_aggregation),
    "median": (jagg.median_aggregation, agg.median_aggregation),
    "trimmed_mean": (lambda t, m: jagg.trimmed_mean(t, 0.25, m),
                     lambda t, m: agg.trimmed_mean(t, 0.25, m)),
    "krum_f0": (lambda t, m: jagg.krum(t, 0, m), lambda t, m: agg.krum(t, 0, m)),
    "krum_f1": (lambda t, m: jagg.krum(t, 1, m), lambda t, m: agg.krum(t, 1, m)),
    "shieldfl": (lambda t, m: jagg.shieldfl(t, mask=m), lambda t, m: agg.shieldfl(t, mask=m)),
    "byzantine": (lambda t, m: jagg.byzantine_tolerance(t, 0.9, m),
                  lambda t, m: agg.byzantine_tolerance(t, 0.9, m)),
}


@pytest.mark.parametrize("bad", [False, True], ids=["finite", "nonfinite_row"])
@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("rule", list(AGGREGATES))
def test_aggregate_matches_jax(rule, mask, bad):
    tree = _stacked(bad=bad)
    jfn, tfn = AGGREGATES[rule]
    _assert_trees_close(tfn(_port(tree), _tmask(mask)), jfn(_jax(tree), _jmask(mask)),
                        SHIELDFL_TOL if rule == "shieldfl" else AGG_TOL)


@pytest.mark.parametrize("mask", list(MASKS))
def test_shieldfl_within_float32_of_a_float64_evaluation(mask):
    tree = _stacked()
    flat = np.concatenate([x.reshape(C, -1) for x in pt.tree_leaves(tree)], 1).astype(np.float64)
    m = np.ones(C) if MASKS[mask] is None else np.asarray(MASKS[mask], np.float64)
    unit = flat / (np.linalg.norm(flat, axis=1, keepdims=True) + 1e-8)
    ref = (unit * m[:, None]).sum(0) / max(m.sum(), 1.0)
    cos = unit @ ref / (np.linalg.norm(unit, axis=1) * np.linalg.norm(ref) + 1e-12)
    w = m / (1.0 - cos + 1e-6)
    want = {path: np.tensordot(w / w.sum(), x.astype(np.float64), axes=1)
            for path, x in pt.tree_items(tree)}
    np.testing.assert_allclose(agg.shieldfl_weights(_port(tree), mask=_tmask(mask)).numpy(),
                               w, rtol=2e-5, atol=0)
    _assert_trees_close(agg.shieldfl(_port(tree), mask=_tmask(mask)), want)


def _krum_scores64(flat: np.ndarray, f: int, mask) -> np.ndarray:
    """Krum's scores in float64 from finite rows, for the margin."""
    valid = np.ones(C, bool) if mask is None else np.asarray(mask, bool)
    d = ((flat[:, None, :] - flat[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d, np.inf)
    d[:, ~valid] = np.inf
    m = max(int(valid.sum()) - f - 2, 1)
    scores = np.sort(d, axis=1)[:, :m].sum(1)
    return np.where(valid, scores, np.inf)


@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("f", [0, 1])
def test_krum_index_matches_jax_with_a_stated_margin(f, mask):
    tree = _stacked(seed=1)
    flat = np.concatenate([x.reshape(C, -1) for x in pt.tree_leaves(tree)], 1).astype(np.float64)
    scores = np.sort(_krum_scores64(flat, f, MASKS[mask]))
    assert (scores[1] - scores[0]) / scores[0] > MARGIN
    want = int(jagg.krum_select(_jax(tree), f, _jmask(mask)))
    got = agg.krum_select(_port(tree), f, _tmask(mask))
    assert got.ndim == 0 and int(got) == want


@pytest.mark.parametrize("mask", list(MASKS))
def test_byzantine_keep_matches_jax(mask):
    tree = _stacked(seed=2)
    want = np.asarray(jagg.byzantine_keep(_jax(tree), 0.9, _jmask(mask)))
    got = agg.byzantine_keep(_port(tree), 0.9, _tmask(mask)).numpy()
    np.testing.assert_array_equal(got, want)
    # the filter rejects the attackers and keeps benign rows
    assert want[6:].sum() == 0 and want[:6].sum() > 0


def test_byzantine_falls_back_to_valid_then_to_everyone():
    tree = _stacked(seed=3)
    for m in ([0, 0, 0, 0, 0, 0, 1, 1], [0] * C):
        jm, tm = jnp.asarray(m, jnp.float32), torch.tensor(m, dtype=torch.float32)
        np.testing.assert_array_equal(agg.byzantine_keep(_port(tree), 2.0, tm).numpy(),
                                      np.asarray(jagg.byzantine_keep(_jax(tree), 2.0, jm)))
    # threshold 2 keeps nobody: all valid rows come back
    assert agg.byzantine_keep(_port(tree), 2.0, torch.ones(C)).tolist() == [1.0] * C


def test_trimmed_mean_static_error_and_overtrim():
    tree = _stacked()
    with pytest.raises(ValueError, match="Too few clients"):
        jagg.trimmed_mean(_jax(tree), 0.5)
    with pytest.raises(ValueError, match="Too few clients"):
        agg.trimmed_mean(_port(tree), 0.5)
    # masked, 2 valid rows at ratio 0.5: the window is empty, 0/0 = NaN
    m = [1, 1, 0, 0, 0, 0, 0, 0]
    want = jagg.trimmed_mean(_jax(tree), 0.5, jnp.asarray(m, jnp.float32))
    got = agg.trimmed_mean(_port(tree), 0.5, torch.tensor(m, dtype=torch.float32))
    assert all(bool(torch.isnan(x).all()) for x in pt.tree_leaves(got))
    _assert_trees_close(got, want)


def _jax_uniforms(rng, n: int, p: int) -> torch.Tensor:
    """The uniforms behind ``jax.random.bernoulli`` in scionfl_weights."""
    keys = jax.random.split(rng, n)
    return torch.from_numpy(np.array(jax.vmap(lambda k: jax.random.uniform(k, (p,)))(keys)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scionfl_bits_and_weights_match_jax(seed):
    tree = _stacked(seed=seed)
    flat = np.concatenate([x.reshape(C, -1) for x in pt.tree_leaves(tree)], 1)
    rng = jax.random.key(seed, impl="threefry2x32")
    uniform = _jax_uniforms(rng, C, flat.shape[1])
    jsig, _, _ = jax.vmap(jagg.quantize_vector)(jax.random.split(rng, C), jnp.asarray(flat))
    tsig, _, _ = agg.quantize_vector(uniform, torch.from_numpy(flat))
    np.testing.assert_array_equal(tsig.numpy(), np.asarray(jsig))

    sizes = np.arange(20, 20 + C, dtype=np.float32)
    sizes[5] = 0.0           # a dropped client (sizes * weights_mask)
    want = np.asarray(jagg.scionfl_weights(_jax(tree), jnp.asarray(sizes), rng))
    got = agg.scionfl_weights(_port(tree), torch.from_numpy(sizes), uniform)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < (want > 0).sum() < C
    _assert_trees_close(agg.scionfl(_port(tree), torch.from_numpy(sizes), uniform),
                        jagg.scionfl(_jax(tree), jnp.asarray(sizes), rng))


def test_scionfl_threshold_margin():
    """The inputs of the test above keep every client clear of ScionFL's
    threshold by more than MARGIN (relative), in float64."""
    for seed in (0, 1, 2):
        tree = _stacked(seed=seed)
        flat = np.concatenate([x.reshape(C, -1) for x in pt.tree_leaves(tree)], 1)
        uniform = _jax_uniforms(jax.random.key(seed, impl="threefry2x32"), C,
                                flat.shape[1]).numpy()
        x = flat.astype(np.float64)
        smin, smax = x.min(1), x.max(1)
        sig = (uniform < ((x - smin[:, None]) / (smax - smin + 1e-6)[:, None])).astype(float)
        l2 = np.sqrt((x.shape[1] - sig.sum(1)) * smin ** 2 + sig.sum(1) * smax ** 2)
        fac = np.where(l2 > 3 * l2.mean(), 3 * l2.mean() / l2, 1.0)
        deq = (smin * fac)[:, None] + sig * ((smax - smin) * fac)[:, None]
        ref = deq.mean(0)
        dist = 1 - deq @ ref / (np.linalg.norm(deq, axis=1) * np.linalg.norm(ref))
        thresh = np.sort(dist)[::-1][C // 2]
        others = np.delete(dist, np.argmin(np.abs(dist - thresh)))
        assert np.min(np.abs(others - thresh)) / abs(thresh) > MARGIN


def test_fltrust_trust_and_combine_match_jax():
    rng = np.random.default_rng(4)
    glob = _map_shapes(SHAPES, lambda s: rng.standard_normal(s).astype(np.float32))
    deltas = _map_shapes(SHAPES, lambda s: (0.1 * rng.standard_normal((C,) + s)).astype(np.float32))
    root = _map_shapes(SHAPES, lambda s: (0.1 * rng.standard_normal(s)).astype(np.float32))
    for leaf in pt.tree_leaves(deltas):
        leaf[3] = 0.0        # a dropped client: delta exactly 0, trust exactly 0
    want = np.asarray(jagg.fltrust_trust(_jax(deltas), _jax(root)))
    got = agg.fltrust_trust(_port(deltas), _port(root)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=AGG_TOL)
    assert got[3] == 0.0 and want[3] == 0.0 and (got > 0).any()
    _assert_trees_close(agg.fltrust_combine(_port(glob), _port(deltas), _port(root)),
                        jagg.fltrust_combine(_jax(glob), _jax(deltas), _jax(root)))


# ---------------------------------------------------------------------------
# FLTrust's root training
# ---------------------------------------------------------------------------

def jax_root_perms(rng, epochs: int, n: int) -> torch.Tensor:
    """The root update's per-epoch shuffles in JAX's key schedule
    (local.py:139-142 over one client), as (epochs, 1, n)."""
    eks = jax.random.split(rng, epochs)
    return torch.from_numpy(np.stack([
        np.asarray(jax.random.permutation(jax.random.split(eks[e])[0], n))[None]
        for e in range(epochs)]).astype(np.int64))


def test_root_update_matches_jax_with_dropout_off():
    epochs, n = 2, 200
    test_np = {k: v[:n] for k, v in jax_get_dataset("ICU", "test", 256, 1).items()}
    params = JaxTransformerModel().init(jax.random.PRNGKey(3), jnp.zeros((1, 7)),
                                        jnp.zeros((1, 16)))["params"]
    rng = jax.random.key(9, impl="threefry2x32")
    kw = dict(epochs=epochs, batch_size=100, lr=0.004, clip_grad_norm=1.0)
    jroot = jlocal.build_root_update(JaxDropoutOff(), "ICU",
                                     {k: jnp.asarray(v) for k, v in test_np.items()}, **kw)
    troot = local.build_root_update(PortDropoutOff(), "ICU",
                                    {k: torch.from_numpy(v) for k, v in test_np.items()}, **kw)
    init = params_from_jax(jax.tree.map(np.asarray, params))
    got = troot(init, jax_root_perms(rng, epochs, n), 0)
    want = jroot(params, rng)
    _assert_trees_close(got, want, tol=2e-4)
    assert max(float((a - b).abs().max()) for a, b in
               zip(pt.tree_leaves(got), pt.tree_leaves(init))) > 1e-3
    # unshuffled it would not match: the JAX update permutes every epoch
    ident = torch.arange(n).expand(epochs, 1, n)
    moved = troot(init, ident, 0)
    ref = dict(pt.tree_items(pt.tree_map(np.asarray, want)))
    assert max(float(np.abs(x.numpy() - ref[p]).max()) for p, x in pt.tree_items(moved)) > 2e-4


# ---------------------------------------------------------------------------
# the numpy copies of ops/stats.py and ops/defenses.py
# ---------------------------------------------------------------------------

def _clients64(seed: int = 0, n: int = 20, d: int = 300, attackers: int = 4):
    """Benign clients around one centre, the last ``attackers`` shifted."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(d) + 0.1 * rng.standard_normal((n, d))
    x[n - attackers:] += 0.6 * rng.standard_normal(d)
    mask = np.zeros(n, bool)
    mask[n - attackers:] = True
    return x, mask


def test_pca_mad_mahalanobis_match_jax():
    x, _ = _clients64()
    for k in (1, 5, 19, 25):
        ours, ref = stats.pca_fit_transform(x, k), jstats.pca_fit_transform(x, k)
        assert ours.shape == ref.shape
        sign = np.where(np.sum(ours * ref, axis=0) < 0, -1.0, 1.0)
        np.testing.assert_allclose(ours * sign, ref, rtol=0, atol=1e-12)
    z = x[:, 0]
    assert abs(stats.median_abs_deviation(z) - jstats.median_abs_deviation(z)) <= 1e-12
    mean, cov = x[:, :6].mean(0), np.cov(x[:, :6].T)
    for row in x[:, :6]:
        assert abs(stats.mahalanobis(row, mean, cov) - jstats.mahalanobis(row, mean, cov)) <= 1e-12


def test_gaussian_mixture_matches_jax():
    x, _ = _clients64(seed=1)
    z = jstats.pca_fit_transform(x, 6)
    ours = stats.GaussianMixture(n_components=2, seed=3).fit(z)
    ref = jstats.GaussianMixture(n_components=2, seed=3).fit(z)
    np.testing.assert_allclose(ours.means_, ref.means_, rtol=0, atol=1e-10)
    np.testing.assert_allclose(ours.covariances_, ref.covariances_, rtol=0, atol=1e-10)
    np.testing.assert_allclose(ours.predict_proba(z), ref.predict_proba(z), rtol=0, atol=1e-10)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gmm_filter_and_fltracer_match_jax(seed):
    x, attackers = _clients64(seed=seed)
    keep = defenses.gmm_filter(x, attackers, seed=seed)
    np.testing.assert_array_equal(keep, jdef.gmm_filter(x, attackers, seed=seed))
    assert keep.dtype == bool and 0 < keep.sum() < len(keep)
    got = defenses.fltracer_anomalies(x)
    np.testing.assert_array_equal(got, jdef.fltracer_anomalies(x))


@pytest.mark.parametrize("column", [0, 3])
def test_filters_ignore_the_sign_of_a_pca_component(monkeypatch, column):
    """LAPACK may return any sign for a principal component: the same
    matrix with one projected column negated gives the same decisions."""
    x, attackers = _clients64(seed=5)
    keep, anomalies = defenses.gmm_filter(x, attackers, seed=0), defenses.fltracer_anomalies(x)
    plain = stats.pca_fit_transform

    def flipped(a, k):
        z = plain(a, k)
        z[:, min(column, k - 1)] *= -1.0
        return z

    monkeypatch.setattr(defenses, "pca_fit_transform", flipped)
    np.testing.assert_array_equal(defenses.gmm_filter(x, attackers, seed=0), keep)
    np.testing.assert_array_equal(defenses.fltracer_anomalies(x), anomalies)
