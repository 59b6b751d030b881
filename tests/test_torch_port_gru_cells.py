"""RNNModel's bfloat16 GRU cells, one at a time, against the JAX package's
on the CPU.

Each of the twelve cells of ``_BiGRUStack`` (JAX
``attackfl_tpu/models/icu.py:52-66``: three bidirectional layers per
branch, flax ``nn.GRUCell``; the port's ``models/layers.py`` ``GRUCell``)
gets the same seeded parameters, cast to bfloat16 as ``make_loss_fn``
casts them and carried into the port through ``weights.params_from_jax``,
a float32 carry (zero, as the model starts it, and seeded) and its
in-model input (bfloat16 into the first layer, the float32 output of the
layer below into the others).  JAX's cell runs under ``jax.jit``, as the
step does.  The output, and the gradients of a seeded projection of it
with respect to the parameters, the carry and the input, are held in
bfloat16 ulps of each value's largest entry: the output within
``OUT_ULPS`` (measured 0.0000: float32 rounding), each gradient within a
few ulps, ``GRAD_ULPS`` (measured: 0 for the carry's and the input's, at
most 0.5 for a kernel's; the first layer's input-gate biases 1-3, the
batch's sum of the bias cotangent rounded at another point in each
package).  The compiled JAX cell adds each
input gate's bias to its bfloat16 product in float32 (XLA folds the
rounding of the biased gate into the float32 sum with the recurrent
term); a port that rounded the biased gate to bfloat16 first was 0.33
ulps off at the first layer's output, which the model's gradient carried
8.1e-2 of its largest entry away from JAX's.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_threads import one_torch_thread  # noqa: F401
from torch.func import functional_call

from attackfl_tpu.models import icu as jicu
from attackfl_tpu_torch.ops import pytree as pt
from attackfl_tpu_torch.registry import get_model
from attackfl_tpu_torch.weights import params_from_jax

B, H = 16, 32
OUT_ULPS, GRAD_ULPS = 0.02, 4.0
CELLS = [(branch, k) for branch in ("vitals", "labs") for k in range(6)]


def _ulp(x: np.ndarray) -> np.ndarray:
    """One bfloat16 ulp at each |x| (8 significant bits), floored at the
    ulp of the smallest normal float32."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126))) - 7)


def _ulps(ours: np.ndarray, ref: np.ndarray) -> float:
    """The largest gap in bfloat16 ulps of the reference's largest value."""
    return float(np.abs(ours - ref).max() / _ulp(np.abs(ref).max()))


@pytest.fixture(scope="module")
def jax_params():
    """RNNModel's parameter tree, seeded: kernels N(0, 1/fan_in), biases
    N(0, 0.1)."""
    shapes = jax.eval_shape(jicu.RNNModel().init, jax.random.PRNGKey(0), jnp.zeros((1, 7)),
                            jnp.zeros((1, 16)))["params"]
    rng = np.random.default_rng(0)
    return jax.tree.map(lambda s: (rng.standard_normal(s.shape) / (
        np.sqrt(s.shape[0]) if len(s.shape) == 2 else 10.0)).astype(np.float32), shapes)


@pytest.mark.parametrize("carry", ["zero", "seeded"])
@pytest.mark.parametrize("branch,k", CELLS)
def test_bf16_gru_cell_matches_jax(jax_params, branch, k, carry):
    rng = np.random.default_rng(100 * k + (branch == "labs") * 10 + (carry == "seeded"))
    cell_params = jax.tree.map(lambda x: x.astype(jnp.bfloat16),
                               jax_params[f"{branch}_gru"][f"GRUCell_{k}"])
    width = (7 if branch == "vitals" else 16) if k < 2 else 2 * H
    x = rng.standard_normal((B, width)).astype(np.float32)
    x_dtype = jnp.bfloat16 if k < 2 else jnp.float32
    h = (np.zeros((B, H), np.float32) if carry == "zero"
         else 0.5 * rng.standard_normal((B, H)).astype(np.float32))
    w = rng.standard_normal((B, H)).astype(np.float32)

    def jax_cell(p, h_, x_):
        out, _ = nn.GRUCell(H).apply({"params": p}, h_, x_)
        return out

    jx = jnp.asarray(x).astype(x_dtype)
    jout = np.asarray(jax.jit(jax_cell)(cell_params, jnp.asarray(h), jx))
    jgrads = jax.jit(jax.grad(lambda p, h_, x_: jnp.sum(jax_cell(p, h_, x_) * w),
                              argnums=(0, 1, 2)))(cell_params, jnp.asarray(h), jx)

    model = get_model("RNNModel")
    ported = params_from_jax(jax.tree.map(lambda a: np.asarray(a, np.float32), jax_params),
                             "RNNModel")
    prefix = f"{branch}_gru/GRUCell_{k}/"
    params = {path[len(prefix):].replace("/", "."): torch.as_tensor(leaf).to(torch.bfloat16)
              .requires_grad_(True) for path, leaf in pt.tree_items(ported)
              if path.startswith(prefix)}
    th = torch.from_numpy(h).requires_grad_(True)
    tx = torch.from_numpy(x).to(torch.bfloat16 if k < 2 else torch.float32).requires_grad_(True)
    cell = getattr(getattr(model, f"{branch}_gru"), f"GRUCell_{k}")
    out = functional_call(cell, params, (th, tx))
    assert out.dtype == torch.float32 and jout.dtype == np.float32
    (out * torch.from_numpy(w)).sum().backward()

    assert _ulps(out.detach().numpy(), jout) <= OUT_ULPS
    jp, jh, jxg = jgrads
    for gate, leaves in jp.items():
        for leaf, ref in leaves.items():
            ours = params[f"{gate}.{leaf}"].grad
            assert ours.dtype == torch.bfloat16
            assert _ulps(ours.float().numpy(), np.asarray(ref, np.float32)) <= GRAD_ULPS, (
                gate, leaf)
    assert _ulps(th.grad.numpy(), np.asarray(jh)) <= GRAD_ULPS
    assert _ulps(tx.grad.float().numpy(), np.asarray(jxg, np.float32)) <= GRAD_ULPS
