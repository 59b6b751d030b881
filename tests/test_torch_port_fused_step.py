"""The port's fused local-training step (attackfl_tpu_torch/ops/fused_step)
against the JAX package's Pallas kernel, run in interpret mode on the CPU.

Both packages get identical packed parameters and minibatches, made with
numpy from a seed.  Tolerances are those of tests/test_pallas_step.py:
2e-4 max-abs on parameters (two epochs of clipped Adam in float32, summed
in another order) and 1e-4 on the loss sums.  The CUDA kernel itself runs
only on the card: tests/test_torch_port_kernel_cuda.py holds it against
this plain version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_threads import one_torch_thread  # noqa: F401

from attackfl_tpu.models.icu import TransformerModel as JaxTransformerModel
from attackfl_tpu.ops import fused_step as jfs
from attackfl_tpu_torch.ops import fused_step as tfs
from attackfl_tpu_torch.weights import params_from_jax

C, B, NB = 8, 16, 2
LR, CLIP = 0.004, 1.0


def _jax_params(seed=0):
    model = JaxTransformerModel()
    return model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 7)),
                      jnp.zeros((1, 16)))["params"]


def _stacked_numpy(seed=0):
    """JAX init broadcast to C clients, each nudged by its own noise."""
    rng = np.random.default_rng(seed)
    params = jax.tree.map(np.asarray, _jax_params(seed))
    return jax.tree.map(
        lambda x: (np.broadcast_to(x, (C,) + x.shape)
                   + 0.01 * rng.standard_normal((C,) + x.shape)).astype(np.float32),
        params)


def _batches(seed=1, masked_client=None):
    rng = np.random.default_rng(seed)
    b = np.zeros((C, NB, B, 32), np.float32)
    b[..., :23] = rng.standard_normal((C, NB, B, 23))
    b[..., 23] = rng.random((C, NB, B)) < 0.3
    b[..., 24] = rng.random((C, NB, B)) < 0.9
    if masked_client is not None:
        b[masked_client, ..., 24] = 0.0
    return b


def _port_groups(stacked_np):
    gp = tfs.pack_params(params_from_jax(stacked_np))
    return gp, tfs.zeros_like_groups(gp), tfs.zeros_like_groups(gp)


def test_pack_params_matches_jax():
    stacked = _stacked_numpy()
    jg = jfs.pack_params(jax.tree.map(jnp.asarray, stacked))
    tg = tfs.pack_params(params_from_jax(stacked))
    assert tuple(tg) == jfs.GROUP_ORDER
    for k in jfs.GROUP_ORDER:
        np.testing.assert_array_equal(tg[k].numpy(), np.asarray(jg[k]), err_msg=k)
    back = tfs.unpack_params(tg, params_from_jax(stacked))
    jback = jfs.unpack_params(jg, jax.tree.map(jnp.asarray, stacked))
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(jback),
                                 jax.tree_util.tree_leaves_with_path(
                                     jax.tree.map(lambda t: t.numpy(), back))):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(path))


def test_reference_epoch_matches_pallas_interpret():
    """Dropout off, two epochs: run_epoch_reference == the Pallas kernel."""
    stacked = _stacked_numpy()
    batches = _batches()
    jg = jfs.pack_params(jax.tree.map(jnp.asarray, stacked))
    jm, jv = jfs.zeros_like_groups(jg), jfs.zeros_like_groups(jg)
    gp, gm, gv = _port_groups(stacked)
    for e in range(2):
        jg, jm, jv, jloss = jfs.run_epoch(
            jg, jm, jv, jnp.asarray(batches), 7 + e, e * NB, lr=LR, clip=CLIP,
            drop_attn=0.0, drop_block=0.0, drop_head=0.0, g_clients=8,
            interpret=True)
        gp, gm, gv, tloss = tfs.run_epoch(
            gp, gm, gv, torch.from_numpy(batches), 7 + e, e * NB, lr=LR,
            clip=CLIP, drop_attn=0.0, drop_block=0.0, drop_head=0.0)
        np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), atol=1e-4, rtol=0)
    for k in jfs.GROUP_ORDER:
        for name, t, j in (("p", gp, jg), ("m", gm, jm), ("v", gv, jv)):
            np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]), atol=2e-4,
                                       rtol=0, err_msg=f"{name}[{k}]")


@pytest.mark.parametrize("dropout", [(0.0, 0.0, 0.0), (0.1, 0.1, 0.3)])
def test_fully_masked_client_is_exact_noop(dropout):
    """A client with no valid sample is bit-identical after the epoch
    (msum guard, zero gradients, zero Adam update), dropout on or off;
    the w_in rows outside each branch's span stay exactly zero."""
    stacked = _stacked_numpy()
    gp, gm, gv = _port_groups(stacked)
    before = {k: v.clone() for k, v in gp.items()}
    gp, gm, gv, loss = tfs.run_epoch(
        gp, gm, gv, torch.from_numpy(_batches(masked_client=0)), 3, 0, lr=LR,
        clip=CLIP, drop_attn=dropout[0], drop_block=dropout[1], drop_head=dropout[2])
    assert torch.isfinite(loss).all()
    for k in tfs.GROUP_ORDER:
        assert torch.equal(gp[k][0], before[k][0]), k
        assert torch.equal(gm[k][0], torch.zeros_like(gm[k][0])), k
    assert any(not torch.equal(gp[k][1], before[k][1]) for k in tfs.GROUP_ORDER)
    for b, (off, f) in enumerate(zip(tfs.IN_OFFS, tfs.IN_DIMS)):
        off_span = torch.ones(tfs.NIN, dtype=torch.bool)
        off_span[off:off + f] = False
        assert torch.equal(gp["w_in"][:, b, off_span],
                           torch.zeros_like(gp["w_in"][:, b, off_span]))


def test_nan_params_poison_the_loss_sum():
    """NaN propagates into the per-client loss sum: the ok tripwire."""
    gp, gm, gv = _port_groups(_stacked_numpy())
    gp["w_h1"][2, 0, 0] = float("nan")
    *_, loss = tfs.run_epoch(gp, gm, gv, torch.from_numpy(_batches()), 0, 0,
                             lr=LR, clip=CLIP)
    assert torch.isnan(loss[2]) and torch.isfinite(loss[[0, 1, 3]]).all()


def _fmix32_uint32(h: np.ndarray) -> np.ndarray:
    """murmur3 fmix32 in wrapping uint32 arithmetic (what the CUDA kernel
    computes), as an independent check of the int64 transliteration."""
    h = h.astype(np.uint32)
    h ^= h >> np.uint32(16)
    h *= np.uint32(0x85EBCA6B)
    h ^= h >> np.uint32(13)
    h *= np.uint32(0xC2B2AE35)
    h ^= h >> np.uint32(16)
    return h


def test_hash_is_exact_uint32_fmix32():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.integers(0, 2 ** 32, 4096, dtype=np.uint64),
                        np.array([0, 1, 2 ** 32 - 1, 2 ** 31, 0xFFFF, 0x10000],
                                 np.uint64)])
    got = tfs.fmix32(torch.from_numpy(x.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy().astype(np.uint64),
                                  _fmix32_uint32(x).astype(np.uint64))
    assert tfs.fmix32(int(x[0])) == int(got[0])


@pytest.mark.parametrize("rate", [0.1, 0.3, 0.5])
def test_dropout_mask_statistics(rate):
    """Masks take only {0, 1/(1-rate)}; the keep rate lies within 4 sigma
    of 1 - rate and the mean within 2% of 1 (the checks of
    scripts/tpu_validate_pallas.py:check_mask_statistics)."""
    keys = tfs.client_keys(1234, 5, torch.arange(16))
    mask = tfs.dropout_mask(keys, tfs.T_M4, 256, 64, rate)
    scale = np.float32(1.0 / (1.0 - rate))
    assert set(np.unique(mask.numpy())) <= {np.float32(0.0), scale}
    n = mask.numel()
    keep = float((mask > 0).float().mean())
    sigma = np.sqrt(rate * (1 - rate) / n)
    assert abs(keep - (1.0 - rate)) < 4 * sigma
    assert abs(float(mask.mean()) - 1.0) < 0.02
    # distinct tensors and clients draw distinct masks
    other = tfs.dropout_mask(keys, tfs.T_MW, 256, 64, rate)
    assert not torch.equal(mask, other)
    assert not torch.equal(mask[0], mask[1])


def test_dropout_changes_the_step_and_stays_deterministic():
    stacked = _stacked_numpy()
    batches = torch.from_numpy(_batches())
    outs = []
    for rates in ((0.0, 0.0, 0.0), (0.1, 0.1, 0.3), (0.1, 0.1, 0.3)):
        gp, gm, gv = _port_groups(stacked)
        gp, *_ = tfs.run_epoch(gp, gm, gv, batches, 11, 0, lr=LR, clip=CLIP,
                               drop_attn=rates[0], drop_block=rates[1],
                               drop_head=rates[2])
        outs.append(gp["w_h1"])
    assert not torch.equal(outs[0], outs[1])
    assert torch.equal(outs[1], outs[2])


def test_run_epoch_rejects_bad_inputs():
    gp, gm, gv = _port_groups(_stacked_numpy())
    batches = torch.from_numpy(_batches())
    with pytest.raises(ValueError, match="batches"):
        tfs.run_epoch(gp, gm, gv, batches[..., :24], 0, 0, lr=LR, clip=CLIP)
    with pytest.raises(ValueError, match="contiguous"):
        tfs.run_epoch(gp, gm, gv, batches.transpose(1, 2), 0, 0, lr=LR, clip=CLIP)
    bad = dict(gp, w_h2=gp["w_h2"][:4])
    with pytest.raises(ValueError, match="w_h2"):
        tfs.run_epoch(bad, gm, gv, batches, 0, 0, lr=LR, clip=CLIP)
    with pytest.raises(ValueError, match="float32"):
        tfs.run_epoch(dict(gp, vecs=gp["vecs"].double()), gm, gv, batches, 0, 0,
                      lr=LR, clip=CLIP)


def test_cpu_run_counts_no_kernel_launch():
    gp, gm, gv = _port_groups(_stacked_numpy())
    before = tfs.run_epoch.launches
    tfs.run_epoch(gp, gm, gv, torch.from_numpy(_batches()), 0, 0, lr=LR, clip=CLIP)
    assert tfs.run_epoch.launches == before
