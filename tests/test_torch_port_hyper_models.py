"""The port's hypernetworks (``attackfl_tpu_torch/models/hyper.py``) against
the JAX package's (``attackfl_tpu/models/hyper.py``) on the CPU.

Head names and shapes are compared on the CNNModel, RNNModel and
TransformerModel templates (CNNHyper on CNNModel only).  From the same
parameters, converted from flax: ``spectral_normalize`` within 1e-6,
every client's generated params and embeddings (``generate_all``) within
1e-6 in float32; with spectral normalization, the generated params and
one VJP of the generator for a fixed cotangent against ``jax.vjp`` within
1e-10 in float64 (JAX under ``enable_x64``).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_threads import one_torch_thread  # noqa: F401

from attackfl_tpu.models import icu as jicu
from attackfl_tpu.models.hyper import make_cnn_hyper as jax_make_cnn_hyper
from attackfl_tpu.models.hyper import make_hypernetwork as jax_make_hypernetwork
from attackfl_tpu.models.hyper import spectral_normalize as jax_spectral_normalize
from attackfl_tpu_torch.models.hyper import CNNHyper, make_hypernetwork, spectral_normalize
from attackfl_tpu_torch.ops import pytree as pt
from attackfl_tpu_torch.registry import get_model
from attackfl_tpu_torch.weights import hnet_params_from_jax, hnet_params_to_jax

C = 3
JAX_MAKE = {"HyperNetwork": jax_make_hypernetwork, "CNNHyper": jax_make_cnn_hyper}


def _templates(model: str):
    """(port template, JAX template) of ``model``; the JAX one as shapes
    (a hypernetwork reads only its template's shapes)."""
    jt = jax.eval_shape(getattr(jicu, model)().init, jax.random.PRNGKey(0),
                        jnp.zeros((1, 7)), jnp.zeros((1, 16)))["params"]
    return get_model(model).init(torch.Generator().manual_seed(0)), jt


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _hparams(module, seed: int = 1, dtype=np.float32) -> dict:
    """Seeded hypernetwork parameters for the JAX ``module`` (numpy), from
    the init distributions (embeddings N(0, 1), kernels and biases
    U(+-1/sqrt(fan_in))) without tracing flax's init."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.asarray(0))["params"]
    out = {}
    for name, leaves in shapes.items():
        if name == "embeddings":
            out[name] = {"embedding": rng.standard_normal(leaves["embedding"].shape)}
            continue
        lim = 1.0 / math.sqrt(leaves["kernel"].shape[0])
        out[name] = {k: rng.uniform(-lim, lim, x.shape) for k, x in leaves.items()}
    return jax.tree.map(lambda x: x.astype(dtype), out)


@pytest.mark.parametrize("cls,model", [("HyperNetwork", "CNNModel"),
                                       ("HyperNetwork", "RNNModel"),
                                       ("HyperNetwork", "TransformerModel"),
                                       ("CNNHyper", "CNNModel")])
def test_head_names_and_shapes_equal_jax(cls, model):
    tmpl, jt = _templates(model)
    module, _ = JAX_MAKE[cls](jt, C)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(1), jnp.asarray(0))["params"]
    expected = {path: tuple(x.shape) for path, x in pt.tree_items(shapes)}
    hnet = make_hypernetwork(cls, tmpl, C)
    assert hnet.jax_shapes() == expected
    assert hnet.numel == sum(math.prod(s) for s in expected.values())


def test_init_draws_the_torch_linear_and_embedding_distributions():
    tmpl, _ = _templates("CNNModel")
    hnet = make_hypernetwork("HyperNetwork", tmpl, 50)
    flat = hnet.init(torch.Generator().manual_seed(0))
    tree = hnet.tree(flat)
    emb = tree["embeddings"]["embedding"]
    assert emb.shape == (50, 8) and abs(float(emb.mean())) < 0.2 and 0.8 < float(emb.std()) < 1.2
    for module, leaves in tree.items():
        if module == "embeddings":
            continue
        lim = 1.0 / math.sqrt(leaves["kernel"].shape[0])
        for leaf in leaves.values():
            assert float(leaf.abs().max()) <= lim
        assert float(leaves["kernel"].abs().max()) > 0.9 * lim
    # same seed, same draw; the heads' biases are not at zero
    assert torch.equal(flat, hnet.init(torch.Generator().manual_seed(0)))
    assert float(tree["head_fc1__bias"]["bias"].abs().max()) > 0.05


@pytest.mark.parametrize("shape", [(3, 64, 128), (100, 50), (8, 100), (3, 1, 32)])
def test_spectral_normalize_matches_jax(shape):
    k = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)
    ref = np.asarray(jax_spectral_normalize(jnp.asarray(k)))
    ours = spectral_normalize(torch.from_numpy(k)).numpy()
    assert np.abs(ours - ref).max() <= 1e-6


@pytest.mark.parametrize("cls", ["HyperNetwork"])
def test_generate_all_matches_jax(cls):
    """Without spectral normalization, float32.  CNNHyper computes the
    same function under other head names; its generation, with spectral
    normalization, is held in float64 below (and HyperNetwork's by
    ``test_torch_port_hyper_update.py``, whose updates generate through
    it)."""
    tmpl, jt = _templates("CNNModel")
    module, apply = JAX_MAKE[cls](jt, C)
    hp = _hparams(module)
    jparams, jemb = jax.jit(jax.vmap(lambda i: apply(hp, i)))(jnp.arange(C))
    hnet = make_hypernetwork(cls, tmpl, C)
    flat = hnet_params_from_jax(_np(hp), hnet)
    params, emb = hnet.generate_all(flat)
    ref = dict(pt.tree_items(_np(jparams)))
    errs = [float(np.abs(x.numpy() - ref[path]).max()) for path, x in pt.tree_items(params)]
    assert max(errs) <= 1e-6
    assert np.array_equal(emb.numpy(), np.asarray(jemb))
    # one client through client(): its generate_all row (a (1, 100) product
    # in place of (3, 100), so within float32 rounding)
    one, e1 = hnet.client(flat, 1)
    for (_, a), (_, b) in zip(pt.tree_items(one), pt.tree_items(pt.tree_take(params, 1))):
        assert float((a - b).abs().max()) <= 1e-6
    assert torch.equal(e1, emb[1])
    # the conversion round-trips bit for bit
    back = hnet_params_to_jax(flat, hnet)
    for path, x in pt.tree_items(_np(hp)):
        assert np.array_equal(dict(pt.tree_items(back))[path], x)


def test_spectral_norm_generation_and_its_vjp_match_jax_in_float64():
    """With spectral normalization on, float64 on both sides: every
    client's generated params within 1e-10 (of max(1, |x|)), and one
    client's ``torch.autograd.grad`` with ``grad_outputs=delta`` against
    ``jax.vjp`` (sigma is differentiated, u and v are not)."""
    tmpl, jt = _templates("CNNModel")
    with jax.enable_x64(True):
        module, apply = jax_make_cnn_hyper(jt, C, spec_norm=True)
        hp = _hparams(module, 2, np.float64)
        rng = np.random.default_rng(0)
        delta = jax.tree.map(lambda x: rng.standard_normal(x.shape), jt)

        def both(p, d):
            gen = jax.vmap(lambda i: apply(p, i)[0])(jnp.arange(C))
            return gen, jax.vjp(lambda q: apply(q, jnp.asarray(2))[0], p)[1](d)

        jgen, (jgrads,) = jax.jit(both)(jax.tree.map(jnp.asarray, hp),
                                        jax.tree.map(jnp.asarray, delta))
        jgen, jgrads = _np(jgen), _np(jgrads)
    hnet = make_hypernetwork("CNNHyper", tmpl, C, spec_norm=True)
    flat = hnet_params_from_jax(_np(hp), hnet, dtype=torch.float64)
    gen = dict(pt.tree_items(hnet.generate_all(flat)[0]))
    for path, x in pt.tree_items(jgen):
        assert np.abs(gen[path].numpy() - x).max() <= 1e-10 * max(1.0, float(np.abs(x).max()))
    q = flat.clone().requires_grad_()
    rows, _ = hnet.generate(q, slice(2, 3))
    d = torch.cat([torch.from_numpy(x).reshape(-1) for _, x in pt.tree_items(delta)])
    (g,) = torch.autograd.grad(rows, q, grad_outputs=d[None])
    ours = dict(pt.tree_items(hnet_params_to_jax(g, hnet)))
    for path, x in pt.tree_items(jgrads):
        scale = max(1.0, float(np.abs(x).max()))
        assert np.abs(ours[path] - x).max() <= 1e-10 * scale, path


def test_cnn_hyper_refuses_another_template():
    tmpl, jt = _templates("RNNModel")
    with pytest.raises(ValueError, match="CNNHyper targets the CNNModel parameter layout only"):
        jax_make_cnn_hyper(jt, C)
    with pytest.raises(ValueError, match="CNNHyper targets the CNNModel parameter layout only"):
        CNNHyper(tmpl, C)


def test_conversion_checks_the_head_names():
    """A HyperNetwork tree does not load as CNNHyper (the heads' names
    differ), nor does a tree of another width."""
    tmpl, jt = _templates("CNNModel")
    hp = _hparams(jax_make_hypernetwork(jt, C)[0])
    with pytest.raises(ValueError, match="hypernetwork parameters differ"):
        hnet_params_from_jax(hp, make_hypernetwork("CNNHyper", tmpl, C))
    with pytest.raises(ValueError, match="hypernetwork parameters differ"):
        hnet_params_from_jax(hp, make_hypernetwork("HyperNetwork", tmpl, C + 1))
