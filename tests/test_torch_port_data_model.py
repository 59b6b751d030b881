"""The port's data, config, weights and model against the JAX package.

Same seeds and same numpy-made inputs into both packages.  Tolerances:
data and packed layouts exactly equal; the eval-mode forward at 1e-5
(float32, different summation order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_threads import one_torch_thread  # noqa: F401

from attackfl_tpu.config import config_from_dict as jax_config_from_dict
from attackfl_tpu.config import load_config as jax_load_config
from attackfl_tpu.data.synthetic import get_dataset as jax_get_dataset
from attackfl_tpu.models.icu import TransformerModel as JaxTransformerModel
from attackfl_tpu.ops import pytree as jpt
from attackfl_tpu_torch.config import Config, config_from_dict, load_config
from attackfl_tpu_torch.data.synthetic import get_dataset
from attackfl_tpu_torch.models.icu import TransformerModel
from attackfl_tpu_torch.ops import pytree as tpt
from attackfl_tpu_torch.registry import get_model
from attackfl_tpu_torch.weights import params_from_jax, params_to_jax

REPO_CONFIG = __file__.rsplit("/tests/", 1)[0] + "/config.yaml"


@pytest.fixture(scope="module")
def jax_params():
    return JaxTransformerModel().init(jax.random.PRNGKey(0), jnp.zeros((1, 7)),
                                      jnp.zeros((1, 16)))["params"]


@pytest.mark.parametrize("split,size,seed", [("train", 512, 1), ("test", 300, 7)])
def test_icu_arrays_byte_equal(split, size, seed):
    ours = get_dataset("ICU", split, size, seed)
    ref = jax_get_dataset("ICU", split, size, seed)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        assert ours[k].dtype == ref[k].dtype and ours[k].shape == ref[k].shape, k
        assert ours[k].tobytes() == ref[k].tobytes(), k


def test_other_datasets_are_refused():
    """An unknown dataset is refused; HAR (refused until ROADMAP item 11)
    now loads, byte-equal to the JAX package's."""
    with pytest.raises(ValueError, match="not valid"):
        get_dataset("MNIST", "train", 8, 0)
    ours, ref = get_dataset("HAR", "train", 8, 0), jax_get_dataset("HAR", "train", 8, 0)
    assert all(ours[k].tobytes() == ref[k].tobytes() for k in ref)


def test_config_yaml_loads_identically():
    ours = dataclasses.asdict(load_config(REPO_CONFIG))
    ref = dataclasses.asdict(jax_load_config(REPO_CONFIG))
    assert ours == ref


def test_config_validation_matches():
    with pytest.raises(ValueError, match="pallas"):
        Config(model="CNNModel", local_backend="pallas")
    with pytest.raises(ValueError, match="num-data-range"):
        Config(num_data_range=(10, 5))
    # fault plans are taken as the JAX package takes them, and a cohort
    # client outside the federation is refused alike
    raw = {"server": {"clients": 4}, "faults": [{"kind": "nan_storm", "round": 2,
                                                 "clients": [1]}]}
    ours, ref = config_from_dict(raw).faults, jax_config_from_dict(raw).faults
    assert [dataclasses.asdict(s) for s in ours] == [dataclasses.asdict(s) for s in ref]
    bad = {"server": {"clients": 4}, "faults": [{"kind": "dropout", "round": 2,
                                                 "clients": [4]}]}
    for build in (config_from_dict, jax_config_from_dict):
        with pytest.raises(ValueError, match="out of range"):
            build(bad)


def test_params_from_jax_round_trips(jax_params):
    np_tree = jax.tree.map(np.asarray, jax_params)
    ours = params_from_jax(np_tree)
    back = params_to_jax(ours)
    flat_ref = jax.tree_util.tree_leaves_with_path(np_tree)
    flat_back = jax.tree_util.tree_leaves_with_path(back)
    assert [jax.tree_util.keystr(p) for p, _ in flat_ref] == \
        [jax.tree_util.keystr(p) for p, _ in flat_back]
    for (path, a), (_, b) in zip(flat_ref, flat_back):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))


def test_params_from_jax_rejects_layout_drift(jax_params):
    np_tree = jax.tree.map(np.asarray, jax_params)
    np_tree = dict(np_tree, fc1={"kernel": np_tree["fc1"]["kernel"].T,
                                 "bias": np_tree["fc1"]["bias"]})
    with pytest.raises(ValueError, match="fc1/kernel"):
        params_from_jax(np_tree)


def test_tree_matches_jax_names_shapes_and_ravel_order(jax_params):
    ours = get_model("TransformerModel").init(torch.Generator().manual_seed(0))
    ref_paths = [("/".join(str(k.key) for k in p), tuple(x.shape))
                 for p, x in jax.tree_util.tree_leaves_with_path(jax_params)]
    assert [(p, tuple(x.shape)) for p, x in tpt.tree_items(ours)] == ref_paths
    # a stacked tree flattens to the same (N, P) columns in both packages
    rng = np.random.default_rng(0)
    stacked = jax.tree.map(lambda x: rng.standard_normal((3,) + x.shape).astype(np.float32),
                           jax.tree.map(np.asarray, jax_params))
    np.testing.assert_array_equal(
        tpt.tree_ravel_stacked(params_from_jax(stacked)).numpy(),
        np.asarray(jpt.tree_ravel_stacked(stacked)))


def test_init_follows_flax_distributions(jax_params):
    """lecun-normal kernels (std 1/sqrt(fan_in)), zero biases, LayerNorm
    ones and zeros — the statistics of the JAX package's init."""
    ours = dict(tpt.tree_items(TransformerModel().init(torch.Generator().manual_seed(3))))
    ref = {"/".join(str(k.key) for k in p): np.asarray(x)
           for p, x in jax.tree_util.tree_leaves_with_path(jax_params)}
    for path, x in ours.items():
        leaf = path.rsplit("/", 1)[1]
        if leaf == "bias":
            assert torch.count_nonzero(x) == 0, path
        elif leaf == "scale":
            assert torch.equal(x, torch.ones_like(x)), path
        else:
            fan_in = 64 if "/out/" in path else x.shape[0]
            assert float(x.abs().max()) <= 2.0 / np.sqrt(fan_in) / 0.8796 + 1e-6, path
            if x.numel() >= 1024:
                assert abs(float(x.std()) * np.sqrt(fan_in) - 1.0) < 0.1, path
                assert abs(float(ref[path].std()) * np.sqrt(fan_in) - 1.0) < 0.1, path


def test_forward_matches_flax(jax_params):
    rng = np.random.default_rng(1)
    vitals = rng.standard_normal((64, 7)).astype(np.float32)
    labs = rng.standard_normal((64, 16)).astype(np.float32)
    # non-trivial biases and norms, so every parameter enters the check
    np_tree = jax.tree.map(lambda x: (np.asarray(x) + 0.05 * rng.standard_normal(x.shape)
                                      ).astype(np.float32), jax_params)
    ref = JaxTransformerModel().apply({"params": np_tree}, vitals, labs)
    ours = TransformerModel().apply(params_from_jax(np_tree), torch.from_numpy(vitals),
                                    torch.from_numpy(labs))
    assert ours.shape == (64, 1)
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), atol=1e-5, rtol=0)
