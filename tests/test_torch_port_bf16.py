"""Mixed-precision local training (``compute-dtype: bfloat16 | float16``,
the ``xla`` update) of the port against the JAX package, on the CPU.

One minibatch step of C = 3 clients (B = 8, dropout off) from the same
seeded per-client params through JAX's ``make_loss_fn`` under ``vmap``
and the port's ``build_step_grad``, for CNNModel, RNNModel,
TransformerModel and the two-layer HAR TransformerClassifier in bfloat16,
TransformerModel in float16: the loss within 1e-2 relative and the
gradients within 5e-2 of the largest |g| (measured: at most 3.7e-3 and
8.3e-3; RNNModel's 4.7e-4, since its GRU cells add the input gates'
biases in float32 as the JAX package's compiled cells do, where they were
8.1e-2 apart).  The dtype of every
product (``dot_general`` and ``conv_general_dilated`` in JAX's jaxpr,
``mm``/``bmm``/``addmm``/``convolution`` under a ``TorchDispatchMode``)
equals JAX's: the forward's as counts per dtype, the gradient's as the
set of dtypes.  Then a
3-broadcast run of each package in bfloat16 on the same draws: every
round ok and the validation AUC within 0.02.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from _torch_port_models import JaxDropoutOff, dropout_off
from _torch_port_threads import one_torch_thread  # noqa: F401
from attackfl_tpu.data.synthetic import get_dataset as jax_get_dataset
from attackfl_tpu.eval.validation import evaluate_icu as jax_evaluate_icu
from attackfl_tpu.models import har as jhar
from attackfl_tpu.models import icu as jicu
from attackfl_tpu.training import local as jlocal
from attackfl_tpu_torch.config import Config, MeshConfig
from attackfl_tpu_torch.eval.validation import evaluate_icu
from attackfl_tpu_torch.ops import pytree as pt
from attackfl_tpu_torch.registry import get_model
from attackfl_tpu_torch.training import local
from attackfl_tpu_torch.training.engine import Simulator
from attackfl_tpu_torch.weights import params_from_jax, params_to_jax
from test_torch_port_faults import both_runs

C, B = 3, 8
JAX_MODELS = {"CNNModel": jicu.CNNModel, "RNNModel": jicu.RNNModel,
              "TransformerModel": jicu.TransformerModel,
              "TransformerClassifier": jhar.TransformerClassifier}
DATA = {"CNNModel": "ICU", "RNNModel": "ICU", "TransformerModel": "ICU",
        "TransformerClassifier": "HAR"}
PRODUCTS = ("mm", "bmm", "addmm", "baddbmm", "convolution", "convolution_backward")


def _batch(data_name: str, shape: tuple[int, ...], seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    if data_name == "ICU":
        return {"vitals": rng.standard_normal(shape + (7,)).astype(np.float32),
                "labs": rng.standard_normal(shape + (16,)).astype(np.float32),
                "label": (rng.random(shape) > 0.5).astype(np.float32)}
    return {"x": rng.standard_normal(shape + (561,)).astype(np.float32),
            "label": rng.integers(0, 6, shape).astype(np.int32)}


def _port_batch(batch: dict, data_name: str):
    inputs = tuple(torch.from_numpy(batch[k]) for k in local.INPUTS[data_name])
    label = torch.from_numpy(batch["label"]).to(
        torch.float32 if data_name == "ICU" else torch.int64)
    return inputs, label


@pytest.mark.parametrize("name,dtype", [("CNNModel", "bfloat16"), ("RNNModel", "bfloat16"),
                                        ("TransformerModel", "bfloat16"),
                                        ("TransformerClassifier", "bfloat16"),
                                        ("TransformerModel", "float16")])
def test_step_matches_jax(name, dtype):
    data_name = DATA[name]
    model = dropout_off(get_model(name))
    params = model.init(torch.Generator().manual_seed(0))
    batch = _batch(data_name, (C, B))
    rng = np.random.default_rng(1)
    flat = pt.tree_ravel_stacked(pt.tree_broadcast(params, C))
    flat = flat + 0.01 * torch.from_numpy(rng.standard_normal(flat.shape).astype(np.float32))
    unravel = pt.unraveler(params)
    rows = [unravel(flat[c]) for c in range(C)]
    jrows = jax.tree.map(lambda *xs: jnp.stack(xs),
                         *[jax.tree.map(jnp.asarray, params_to_jax(r, name)) for r in rows])
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def jax_step(compute_dtype):
        jloss = jlocal.make_loss_fn(JaxDropoutOff(JAX_MODELS[name]()), data_name,
                                    compute_dtype)
        jl, jg = jax.jit(jax.vmap(jax.value_and_grad(
            lambda p, b: jloss(p, b, jnp.ones(B), jax.random.PRNGKey(0)))))(jrows, jbatch)
        return torch.from_numpy(np.array(jl)), torch.stack([
            pt.tree_ravel_stacked(pt.tree_map(lambda x: x[None], params_from_jax(
                jax.tree.map(lambda x: np.asarray(x)[c], jg), name)))[0] for c in range(C)])

    jl, jgrads = jax_step(getattr(jnp, dtype))
    step = local.build_step_grad(model, data_name, params, getattr(torch, dtype))
    grads, loss = step(flat, *_port_batch(batch, data_name), torch.ones(C, B))
    assert grads.dtype == loss.dtype == torch.float32
    assert float(((loss - jl).abs() / jl.abs()).max()) <= 1e-2
    # the packages' reduced-precision gradients are two roundings of one
    # float32 gradient: they agree within 5e-2 of the largest |g|
    gap = float((grads - jgrads).abs().max())
    scale = float(jgrads.abs().max())
    assert gap <= 5e-2 * scale, gap / scale


class _Products(TorchDispatchMode):
    """The output dtype of every product op dispatched."""

    def __init__(self):
        super().__init__()
        self.dtypes: list[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ in PRODUCTS:
            outs = out if isinstance(out, (tuple, list)) else (out,)
            self.dtypes += [str(o.dtype).removeprefix("torch.") for o in outs
                            if isinstance(o, torch.Tensor)]
        return out


def _jax_products(jaxpr) -> list[str]:
    """The output dtype of every ``dot_general`` and ``conv_general_dilated``
    of ``jaxpr``, its sub-jaxprs (scans, custom derivatives) included."""
    found = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name in ("dot_general", "conv_general_dilated"):
            found.append(str(eqn.outvars[0].aval.dtype))
        for value in eqn.params.values():
            for sub in value if isinstance(value, (tuple, list)) else (value,):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    found += _jax_products(inner)
    return found


@pytest.mark.parametrize("name", list(JAX_MODELS))
def test_product_dtypes_match_jax(name):
    """bf16 stays where JAX keeps it: CNNModel and TransformerModel compute
    every product in bfloat16; RNNModel's carry is float32 (flax's
    ``initialize_carry``), so its recurrent products and everything after
    promote to float32; the HAR classifier adds its float32 position
    table after the bfloat16 conv, so its encoder runs in float32."""
    data_name = DATA[name]
    model = dropout_off(get_model(name))
    params = model.init(torch.Generator().manual_seed(0))
    batch = _batch(data_name, (4,))
    jparams = jax.tree.map(jnp.asarray, params_to_jax(params, name))
    jloss = jlocal.make_loss_fn(JaxDropoutOff(JAX_MODELS[name]()), data_name, jnp.bfloat16)
    loss_of = lambda p: jloss(p, batch, jnp.ones(4), jax.random.PRNGKey(0))  # noqa: E731
    j_fwd = _jax_products(jax.make_jaxpr(loss_of)(jparams).jaxpr)
    j_all = _jax_products(jax.make_jaxpr(jax.grad(loss_of))(jparams).jaxpr)

    inputs, label = _port_batch(batch, data_name)
    fwd = _Products()
    with fwd:
        local.make_loss_fn(model, data_name, torch.bfloat16)(params, inputs, label,
                                                             torch.ones(4))
    step = local.build_step_grad(model, data_name, params, torch.bfloat16)
    flat = pt.tree_ravel_stacked(pt.tree_map(lambda x: x[None], params))
    every = _Products()
    with every:
        step(flat, tuple(x[None] for x in inputs), label[None], torch.ones(1, 4))
    assert collections.Counter(fwd.dtypes) == collections.Counter(j_fwd)
    assert set(every.dtypes) == set(j_all)
    assert "bfloat16" in j_fwd


def test_compute_dtype_none_keeps_the_float32_bits():
    """With no compute dtype the loss and its gradient are, bit for bit,
    those of the float32 formula the port had before the knob existed."""
    model = get_model("TransformerModel")
    params = model.init(torch.Generator().manual_seed(0))
    batch = _batch("ICU", (B,))
    inputs, label = _port_batch(batch, "ICU")
    mask = torch.ones(B)
    keys = torch.arange(1, dtype=torch.int64) + 7
    masks = [m[0] for m in local.step_masks(
        keys, model.mask_specs([(B, 7), (B, 16)], model.dropout_rates))]

    def before(p):
        probs = torch.clamp(model.apply(p, *inputs, masks=masks)[:, 0], local.P_LO, local.P_HI)
        per = -(label * torch.log(probs) + (1.0 - label) * torch.log(1.0 - probs))
        return torch.sum(per * mask) / torch.clamp(torch.sum(mask), min=1.0)

    now = local.make_loss_fn(model, "ICU", None)
    g0, l0 = torch.func.grad_and_value(before)(params)
    g1, l1 = torch.func.grad_and_value(lambda p: now(p, inputs, label, mask, masks))(params)
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(pt.tree_leaves(g0), pt.tree_leaves(g1)))
    cfg = Config(local_backend="xla", mesh=MeshConfig(compute_dtype="float32"))
    assert local.resolve_compute_dtype(cfg.mesh.compute_dtype) is None


def test_three_bf16_broadcasts_match_jax():
    """Three broadcasts of each package in bfloat16 (CNNModel, 6 clients,
    one LIE attacker from broadcast 2) on the same draws: every round ok
    in both, and the validation AUC of the final params within 0.02."""
    train_np = jax_get_dataset("ICU", "train", 256, 1)
    test_np = jax_get_dataset("ICU", "test", 256, 1)
    runs = both_runs(jicu.CNNModel(), get_model("CNNModel"), train_np, data_name="ICU",
                     backend="xla", clients=6, epochs=2, batch=16, num_data_range=(24, 32),
                     broadcasts=3, compute_dtype="bfloat16",
                     attack=dict(mode="LIE", num_clients=1, attack_round=2, args=(0.74,)))
    assert [bool(o[3]) for o in runs.port] == [bool(o[3]) for o in runs.jax] == [True] * 3
    ours = float(evaluate_icu(get_model("CNNModel"), runs.port_params[-1],
                              {k: torch.from_numpy(v) for k, v in test_np.items()})["roc_auc"])
    ref = float(jax_evaluate_icu(jicu.CNNModel(), runs.jax_params[-1],
                                 {k: jnp.asarray(v) for k, v in test_np.items()})["roc_auc"])
    assert abs(ours - ref) <= 0.02


def test_bf16_simulator_keeps_float32_master_state(tmp_path):
    """A bf16 run of the engine, plain and hyper: every round ok, the
    params and the hypernetwork float32."""
    for mode in ("fedavg", "hyper"):
        sim = Simulator(Config(num_round=2, total_clients=4, mode=mode, model="CNNModel",
                               data_name="ICU", num_data_range=(16, 24), epochs=1,
                               batch_size=8, train_size=128, test_size=64,
                               local_backend="xla", log_path=str(tmp_path),
                               checkpoint_dir=str(tmp_path),
                               mesh=MeshConfig(compute_dtype="bfloat16")), device="cpu")
        state, history = sim.run(save_checkpoints=False, verbose=False)
        assert all(h["ok"] for h in history) and state["completed_rounds"] == 2
        held = [state["hnet_params"]] if mode == "hyper" else pt.tree_leaves(
            state["global_params"])
        assert all(x.dtype == torch.float32 and bool(torch.isfinite(x).all()) for x in held)
