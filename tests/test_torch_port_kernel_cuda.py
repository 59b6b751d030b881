"""The CUDA kernels of the port (csrc/fused_step.cu, csrc/dropout_mask.cu)
against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU and nvcc; skips elsewhere.  Imports no JAX, so it runs
where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_port_kernel_cuda.py

Small inputs (C=8, B=16, two minibatches) from a seed; tolerances 2e-4 on
p and 1e-4 per step on the loss, as the CPU parity tests, and m and v each
within 1e-3 of the plain version's largest |m| or |v|, as chip_smoke.py.  At this
size the cold Adam start is well conditioned (chip_smoke.py explains why it
is not at 100 clients).  The tiling cases run K1 at batch sizes that are
not multiples of its register tiles or that take several row chunks, at
more clients than the card has SMs, from a mid-training Adam state, where
every entry is gated.
K3 must be bit-equal to its plain version, one tensor or a whole step's
set per launch (the Transformer's nine tensors, and the HAR classifier's
nine, whose row counts differ within the launch); the torch-autograd local update with dropout on agrees
between the card and the CPU at 2e-4 (both draw the same masks from the
hash), gated as the kernel validator gates its check (a).
"""

import numpy as np
import pytest
import torch

from attackfl_tpu_torch import validate_kernels as vk
from attackfl_tpu_torch.models.har import TransformerClassifier
from attackfl_tpu_torch.models.icu import T_HEAD, TransformerModel
from attackfl_tpu_torch.ops import fused_step as tfs
from attackfl_tpu_torch.ops.pytree import tree_map

C, B, NB = 8, 16, 2


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernel has no CPU mode")
    return torch.device("cuda")


def _max_abs(groups):
    return max(float(x.abs().max()) for x in groups.values())


def _inputs(device, masked_client, C=C, B=B, nb=NB):
    rng = np.random.default_rng(1)
    params = TransformerModel().init(torch.Generator().manual_seed(0))
    stacked = tree_map(lambda x: (x.expand((C,) + tuple(x.shape)) + 0.01 * torch.from_numpy(
        rng.standard_normal((C,) + tuple(x.shape)).astype(np.float32))).contiguous(), params)
    b = np.zeros((C, nb, B, 32), np.float32)
    b[..., :23] = rng.standard_normal((C, nb, B, 23))
    b[..., 23] = rng.random((C, nb, B)) < 0.3
    b[..., 24] = rng.random((C, nb, B)) < 0.9
    b[masked_client, ..., 24] = 0.0
    groups = tfs.pack_params(tree_map(lambda x: x.to(device), stacked))
    return groups, torch.from_numpy(b).to(device)


def _warm_state(groups, masked_client):
    """A seeded mid-training Adam state (|m| ~ 1e-3, v in [1e-7, 1.1e-6]) on
    the live entries; padding and the fully masked client keep m = v = 0."""
    rng = np.random.default_rng(2)
    clients = groups["w_h1"].shape[0]
    live = tfs.pack_params(tree_map(lambda x: torch.ones((clients,) + tuple(x.shape)),
                                    TransformerModel().init(torch.Generator().manual_seed(0))))
    m, v = {}, {}
    for k, x in groups.items():
        on = (live[k] != 0).to(x.device, torch.float32)
        on[masked_client] = 0.0
        m[k] = (1e-3 * torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
                .to(x.device) * on).contiguous()
        v[k] = ((1e-7 + 1e-6 * torch.from_numpy(rng.random(x.shape).astype(np.float32)))
                .to(x.device) * on).contiguous()
    return m, v


@pytest.mark.cuda
@pytest.mark.parametrize("rates", [(0.0, 0.0, 0.0), (0.1, 0.1, 0.3)])
def test_kernel_matches_plain_version(card, rates):
    groups, batches = _inputs(card, masked_client=3)
    kw = dict(lr=0.004, clip=1.0, drop_attn=rates[0], drop_block=rates[1],
              drop_head=rates[2])
    kp, rp = ({k: v.clone() for k, v in groups.items()} for _ in range(2))
    km, kv, rm, rv = (tfs.zeros_like_groups(groups) for _ in range(4))
    launches = tfs.run_epoch.launches
    kp, km, kv, kloss = tfs.run_epoch(kp, km, kv, batches, 5, 0, **kw)
    rp, rm, rv, rloss = tfs.run_epoch_reference(rp, rm, rv, batches, 5, 0, **kw)
    torch.cuda.synchronize()
    assert tfs.run_epoch.launches == launches + 1
    assert float((kloss - rloss).abs().max()) <= 1e-4 * NB
    for a, b, tol in ((kp, rp, 2e-4), (km, rm, 1e-3 * _max_abs(rm)), (kv, rv, 1e-3 * _max_abs(rv))):
        for k in tfs.GROUP_ORDER:
            assert float((a[k] - b[k]).abs().max()) <= tol, k
    for k in tfs.GROUP_ORDER:
        assert torch.equal(kp[k][3], groups[k][3]), k


@pytest.mark.cuda
@pytest.mark.parametrize("rates", [(0.0, 0.0, 0.0), (0.1, 0.1, 0.3)])
@pytest.mark.parametrize("clients,batch", [(8, 1), (8, 7), (8, 33), (8, 128), (8, 300),
                                           (150, 16)])
def test_kernel_tiling_matches_plain_version(card, clients, batch, rates):
    masked = 1
    groups, batches = _inputs(card, masked, C=clients, B=batch)
    m0, v0 = _warm_state(groups, masked)
    kw = dict(lr=0.004, clip=1.0, drop_attn=rates[0], drop_block=rates[1],
              drop_head=rates[2])
    k = [{n: x.clone() for n, x in s.items()} for s in (groups, m0, v0)]
    r = [{n: x.clone() for n, x in s.items()} for s in (groups, m0, v0)]
    launches = tfs.run_epoch.launches
    *k, kloss = tfs.run_epoch(*k, batches, 5, 100, **kw)
    *r, rloss = tfs.run_epoch_reference(*r, batches, 5, 100, **kw)
    torch.cuda.synchronize()
    assert tfs.run_epoch.launches == launches + 1
    assert float((kloss - rloss).abs().max()) <= 1e-4 * NB
    (kp, km, kv), (rp, rm, rv) = k, r
    for a, b, tol in ((kp, rp, 2e-4), (km, rm, 1e-3 * _max_abs(rm)), (kv, rv, 1e-3 * _max_abs(rv))):
        for n in tfs.GROUP_ORDER:
            assert float((a[n] - b[n]).abs().max()) <= tol, n
    for n in tfs.GROUP_ORDER:
        assert torch.equal(kp[n][masked], groups[n][masked]), n
    for branch, (off, f) in enumerate(zip(tfs.IN_OFFS, tfs.IN_DIMS)):
        rows = torch.ones(tfs.NIN, dtype=torch.bool, device=card)
        rows[off:off + f] = False
        assert bool((kp["w_in"][:, branch, rows] == 0).all())


@pytest.mark.cuda
def test_kernel_with_a_device_seed_equals_the_int_seed(card):
    """K1 reading its seed (plus the epoch offset) from device memory, as
    the round's draw leaves it there, is bit-equal to K1 given the int."""
    groups, batches = _inputs(card, masked_client=2)
    kw = dict(lr=0.004, clip=1.0, drop_attn=0.1, drop_block=0.1, drop_head=0.3)
    runs = []
    for seed, offset in ((12, 0), (torch.tensor(11, dtype=torch.int64, device=card), 1)):
        p = {k: v.clone() for k, v in groups.items()}
        runs.append(tfs.run_epoch(p, tfs.zeros_like_groups(p), tfs.zeros_like_groups(p),
                                  batches, seed, 0, seed_offset=offset, **kw))
    torch.cuda.synchronize()
    for a, b in zip(runs[0][:3], runs[1][:3]):
        for k in tfs.GROUP_ORDER:
            assert torch.equal(a[k], b[k]), k
    assert torch.equal(runs[0][3], runs[1][3])


@pytest.mark.cuda
def test_kernel_rejects_cpu_cuda_mix(card):
    groups, batches = _inputs(card, masked_client=0)
    m = tfs.zeros_like_groups(groups)
    with pytest.raises(ValueError, match="is on"):
        tfs.run_epoch(groups, m, tfs.zeros_like_groups(groups), batches.cpu(), 0, 0,
                      lr=0.004, clip=1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 256, 128), (100, 128, 64), (100, 128, 6),
                                   (100, 128, 4), (3, 7, 5), (5, 1, 1)])
def test_k3_is_bit_equal_to_plain_version(card, shape):
    C_, rows, width = shape
    keys = tfs.client_keys(1234, 7, torch.arange(C_, device=card))
    for rate in (0.1, 0.3, 0.5):
        launches = tfs.fill_masks.launches
        got = tfs.fill_mask(keys, T_HEAD, rows, width, rate)
        torch.cuda.synchronize()
        assert tfs.fill_masks.launches == launches + 1
        assert torch.equal(got, tfs.dropout_mask(keys, T_HEAD, rows, width, rate))


# (clients, specs): the config-4 step's nine tensors, at C=100 and at more
# clients; the HAR step's nine (attention weights (561, 561), tokens
# (128 * 561, w), head (128, 64)); then the odd shapes of
# tests/test_torch_port_masks.py
STEP_SPECS = TransformerModel().mask_specs([(128, 7), (128, 16)], (0.1, 0.1, 0.3))
HAR_SPECS = TransformerClassifier().mask_specs([(128, 561)], (0.1, 0.1, 0.3))
MASK_SETS = {
    "config-4 step C=100 B=128": (100, STEP_SPECS),
    "config-4 step C=150 B=128": (150, STEP_SPECS),
    "HAR step C=3 B=128 L=561": (3, HAR_SPECS),
    "C=3 rows 7 widths 5, 1, 6": (3, [(16, 7, 5, 0.1), (17, 7, 1, 0.3), (18, 7, 6, 0.5)]),
    "one row and one column": (1, [(24, 1, 1, 0.1)]),
    "C=5 one row": (5, [(16, 1, 1, 0.1), (17, 1, 5, 0.3), (24, 1, 3, 0.7)]),
    "C=3 mixed rows": (3, [(16, 9, 9, 0.1), (17, 45, 5, 0.1), (24, 5, 4, 0.3)]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", MASK_SETS)
def test_k3_step_launch_is_bit_equal_to_plain_version(card, case):
    C_, specs = MASK_SETS[case]
    keys = tfs.client_keys(1234, 7, torch.arange(C_, device=card))
    launches = tfs.fill_masks.launches
    got = tfs.fill_masks(keys, specs)
    torch.cuda.synchronize()
    assert tfs.fill_masks.launches == launches + 1
    want = tfs.dropout_masks(keys, specs)
    assert len(got) == len(want) == len(specs)
    for g, w in zip(got, want):
        assert g.storage_offset() == w.storage_offset()
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_xla_update_with_dropout_matches_cpu(card):
    rates = (0.1, 0.1, 0.3)
    cp, cok, closs = vk.train("cpu", rates, fused=False)
    launches = tfs.fill_masks.launches
    gp, gok, gloss = vk.train(card, rates, fused=False)
    torch.cuda.synchronize()
    nb = -(-vk.HI // vk.B)
    assert tfs.fill_masks.launches == launches + vk.EPOCHS * nb
    assert bool(cok.all()) and bool(gok.all())
    assert float((gloss.cpu() - closs).abs().max()) <= vk.LOSS_TOL
    sure = tree_map(lambda g: g >= vk.GRAD_FLOOR, vk.first_step_grads("cpu", rates))
    assert vk.max_abs(tree_map(lambda x: x.cpu(), gp), cp, sure) <= vk.PARAM_TOL
