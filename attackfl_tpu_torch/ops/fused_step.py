"""Fused local training: one epoch of Adam steps for every client in one
CUDA kernel launch (``csrc/fused_step.cu``).

Replaces the JAX package's Pallas TPU kernel
``attackfl_tpu/ops/fused_step.py:_train_step_kernel`` (pallas_call at
:524, launched by ``run_epoch`` :470-536).  Per minibatch it computes the
TransformerModel forward of both branches and the head, the masked,
clipped BCE, the hand-derived backward, the global-norm clip over all
parameters, and bias-corrected Adam at step ``t_offset + j + 1``.

The layout is the JAX package's, so both packages take identical arrays:
38 active parameter leaves packed into 7 dense groups per client
(``pack_params``), minibatches as ``[C, nb, B, 32]`` (cols 0-6 vitals,
7-22 labs, 23 label, 24 mask).

``run_epoch`` launches the kernel for CUDA tensors and runs
``run_epoch_reference``, the plain PyTorch transliteration of the kernel
body, for CPU tensors; on any other input it raises.  Both update p, m and
v in place (the JAX kernel aliases them in -> out) and return the
per-client sum of the nb per-step losses.

Dropout: the TPU kernel drew masks from the TPU's hardware PRNG.  Here a
counter-based hash (murmur3 ``fmix32`` chained over seed, step, client,
tensor id and element index) gives each mask element its 32 random bits;
``_mask``'s rule is kept (keep if bits >= min(int(rate * 2^32), 2^32 - 1),
scale 1/(1 - rate)).  The hash uses only operations that int64 tensor
arithmetic repeats exactly, so the kernel and the plain version draw the
same masks.  Masks stay elementwise, as the TPU kernel's are.

``fill_masks`` fills every mask tensor of one minibatch step with one
launch of CUDA kernel K3 (``csrc/dropout_mask.cu``, the port of the mask
kernel of ``scripts/tpu_validate_pallas.py``), as views into one arena; the
torch-autograd local update (``training/local.py``) draws its dropout masks
with it.  The hash itself lives in ``csrc/dropout_hash.cuh``, shared by
both kernels.

Each wrapper counts its launches in a process-wide attribute
(``run_epoch.launches``, ``fill_masks.launches``), read and reset by
whoever measures a path.  The run service's jobs launch from several
threads of one process, so a count is bumped under a lock
(:func:`_count_launch`): an attribute's ``+=`` is a read and a write,
and two threads between them lose one.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

from attackfl_tpu_torch.costmodel.capture import is_fake, kernel_work
from attackfl_tpu_torch.ops.pytree import tree_broadcast, tree_map, under_gradient

_LAUNCH_LOCK = threading.Lock()


def _count_launch(wrapper) -> None:
    """One launch more on ``wrapper.launches``, safe across threads."""
    with _LAUNCH_LOCK:
        wrapper.launches += 1

D = 64          # model width
FF = 8          # ffn dim 6, padded to 8 (pad rows/cols stay zero)
NV = 26         # [64]-vector slots in `vecs`
NIN = 32        # padded input-projection rows (the batch has 32 columns)
B1, B2, EPS = 0.9, 0.999, 1e-8
LN_EPS = 1e-6
_GELU_C = math.sqrt(2.0 / math.pi)

# vecs slot indices (per branch b: base = 11 * b)
S_BD, S_BV, S_BO, S_B1F, S_B2F, S_G1, S_BE1, S_G2, S_BE2, S_G3, S_BE3 = range(11)
S_BF1, S_BF2, S_WOUT, S_BOUT = 22, 23, 24, 25

BRANCHES = ("vitals", "labs")
IN_DIMS = (7, 16)
IN_OFFS = (0, 7)
COL_LABEL, COL_MASK = 23, 24
GROUP_ORDER = ("w_in", "w_sq", "w_ff1", "w_ff2", "w_h1", "w_h2", "vecs")
GROUP_SHAPES = {"w_in": (2, NIN, D), "w_sq": (4, D, D), "w_ff1": (2, D, FF),
                "w_ff2": (2, FF, D), "w_h1": (2 * D, D), "w_h2": (D, 32),
                "vecs": (NV, D)}
N_G = len(GROUP_ORDER)

# dropout-mask tensor ids in the hash (per branch b: + 4 * b)
T_MW, T_M1, T_MF, T_M2 = 0, 1, 2, 3
T_M4 = 8
_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


# ---------------------------------------------------------------------------
# packed parameter layout
# ---------------------------------------------------------------------------

def pack_params(stacked: dict) -> dict[str, torch.Tensor]:
    """Stacked TransformerModel params [C, ...] -> the 7 packed groups.

    ``w_in`` slot b is a [NIN, D] matrix whose rows IN_OFFS[b] ..
    IN_OFFS[b] + IN_DIMS[b] hold the branch's input kernel; every other
    row is zero, so the kernel projects the whole 32-column batch row."""
    p = stacked
    C = p["fc1"]["kernel"].shape[0]
    kw = {"dtype": torch.float32, "device": p["fc1"]["kernel"].device}
    w_in = torch.zeros((C, 2, NIN, D), **kw)
    w_sq = torch.zeros((C, 4, D, D), **kw)
    w_ff1 = torch.zeros((C, 2, D, FF), **kw)
    w_ff2 = torch.zeros((C, 2, FF, D), **kw)
    vecs = torch.zeros((C, NV, D), **kw)

    for b, (name, f, off) in enumerate(zip(BRANCHES, IN_DIMS, IN_OFFS)):
        blk = p[f"{name}_transformer"]
        base = 11 * b
        w_in[:, b, off:off + f, :] = p[f"{name}_dense"]["kernel"]
        w_sq[:, 2 * b] = blk["attention"]["value"]["kernel"].reshape(C, D, D)
        w_sq[:, 2 * b + 1] = blk["attention"]["out"]["kernel"].reshape(C, D, D)
        w_ff1[:, b, :, :6] = blk["ffn_dense1"]["kernel"]
        w_ff2[:, b, :6, :] = blk["ffn_dense2"]["kernel"]
        vecs[:, base + S_BD] = p[f"{name}_dense"]["bias"]
        vecs[:, base + S_BV] = blk["attention"]["value"]["bias"].reshape(C, D)
        vecs[:, base + S_BO] = blk["attention"]["out"]["bias"]
        vecs[:, base + S_B1F, :6] = blk["ffn_dense1"]["bias"]
        vecs[:, base + S_B2F] = blk["ffn_dense2"]["bias"]
        vecs[:, base + S_G1] = blk["attention_norm"]["scale"]
        vecs[:, base + S_BE1] = blk["attention_norm"]["bias"]
        vecs[:, base + S_G2] = blk["ffn_norm"]["scale"]
        vecs[:, base + S_BE2] = blk["ffn_norm"]["bias"]
        vecs[:, base + S_G3] = p[f"{name}_bn"]["scale"]
        vecs[:, base + S_BE3] = p[f"{name}_bn"]["bias"]

    vecs[:, S_BF1] = p["fc1"]["bias"]
    vecs[:, S_BF2, :32] = p["fc2"]["bias"]
    vecs[:, S_WOUT, :32] = p["output"]["kernel"][:, :, 0]
    vecs[:, S_BOUT, :1] = p["output"]["bias"]
    return {"w_in": w_in, "w_sq": w_sq, "w_ff1": w_ff1, "w_ff2": w_ff2,
            "w_h1": p["fc1"]["kernel"].to(torch.float32).contiguous(),
            "w_h2": p["fc2"]["kernel"].to(torch.float32).contiguous(),
            "vecs": vecs}


def unpack_params(groups: dict[str, torch.Tensor], template: dict) -> dict:
    """Packed groups -> stacked tree shaped like ``template``.  The inert
    attention query/key leaves are copied from ``template``, which is what
    their zero gradients would leave under Adam."""
    C = groups["w_h1"].shape[0]
    vecs = groups["vecs"]
    out = tree_map(lambda x: x.clone(), template)

    def put(node: dict, key: str, value: torch.Tensor) -> None:
        node[key] = value.contiguous()

    for b, (name, f, off) in enumerate(zip(BRANCHES, IN_DIMS, IN_OFFS)):
        base = 11 * b
        blk = out[f"{name}_transformer"]
        put(out[f"{name}_dense"], "kernel", groups["w_in"][:, b, off:off + f, :])
        put(out[f"{name}_dense"], "bias", vecs[:, base + S_BD])
        put(blk["attention"]["value"], "kernel", groups["w_sq"][:, 2 * b].reshape(C, D, 4, 16))
        put(blk["attention"]["value"], "bias", vecs[:, base + S_BV].reshape(C, 4, 16))
        put(blk["attention"]["out"], "kernel", groups["w_sq"][:, 2 * b + 1].reshape(C, 4, 16, D))
        put(blk["attention"]["out"], "bias", vecs[:, base + S_BO])
        put(blk["ffn_dense1"], "kernel", groups["w_ff1"][:, b, :, :6])
        put(blk["ffn_dense1"], "bias", vecs[:, base + S_B1F, :6])
        put(blk["ffn_dense2"], "kernel", groups["w_ff2"][:, b, :6, :])
        put(blk["ffn_dense2"], "bias", vecs[:, base + S_B2F])
        put(blk["attention_norm"], "scale", vecs[:, base + S_G1])
        put(blk["attention_norm"], "bias", vecs[:, base + S_BE1])
        put(blk["ffn_norm"], "scale", vecs[:, base + S_G2])
        put(blk["ffn_norm"], "bias", vecs[:, base + S_BE2])
        put(out[f"{name}_bn"], "scale", vecs[:, base + S_G3])
        put(out[f"{name}_bn"], "bias", vecs[:, base + S_BE3])

    put(out["fc1"], "kernel", groups["w_h1"])
    put(out["fc1"], "bias", vecs[:, S_BF1])
    put(out["fc2"], "kernel", groups["w_h2"])
    put(out["fc2"], "bias", vecs[:, S_BF2, :32])
    put(out["output"], "kernel", vecs[:, S_WOUT, :32].unsqueeze(-1))
    put(out["output"], "bias", vecs[:, S_BOUT, :1])
    return out


def zeros_like_groups(groups: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    return {k: torch.zeros_like(v) for k, v in groups.items()}


# ---------------------------------------------------------------------------
# dropout: counter-based hash (the kernel's fmix32, in exact int64 steps)
# ---------------------------------------------------------------------------

def _mul32(h, c: int):
    """(h * c) mod 2^32 for 0 <= h < 2^32 without leaving int64."""
    return ((h & 0xFFFF) * c + (((h >> 16) * (c & 0xFFFF)) << 16)) & _M32


def fmix32(h):
    """murmur3's 32-bit finalizer on ints or int64 tensors in [0, 2^32)."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def drop_params(rate: float) -> tuple[int, float]:
    """(threshold, scale) of ``_mask`` at ``rate``: keep if bits >= thr,
    scale kept elements by float32(1 / (1 - rate)).  Rate 0 gives (0, 1)."""
    thr = min(int(rate * 2.0 ** 32), 2 ** 32 - 1)
    return thr, float(np.float32(1.0 / (1.0 - rate)))


def client_keys(seed, step, clients: torch.Tensor) -> torch.Tensor:
    """Per-client hash keys of one minibatch step, int64 [C].  ``seed``
    is an int or a 0-dim int64 tensor on the clients' device (the round's
    draw, which stays there); both give the same bits."""
    k = fmix32((seed & _M32) ^ _GOLDEN)
    k = fmix32(k ^ (step & _M32))
    return fmix32(clients.to(torch.int64) ^ k)


def dropout_mask(keys: torch.Tensor, tensor_id: int, rows: int, width: int,
                 rate: float) -> torch.Tensor:
    """Elementwise inverted-dropout mask [C, rows, width] for one tensor of
    one step; element (r, c) hashes index r * width + c."""
    thr, scale = drop_params(rate)
    kt = fmix32(keys ^ tensor_id)
    elem = torch.arange(rows * width, dtype=torch.int64,
                        device=keys.device).reshape(1, rows, width)
    bits = fmix32(kt.reshape(-1, 1, 1) ^ elem)
    return torch.where(bits >= thr, scale, 0.0).to(torch.float32)


MAX_MASKS = 16   # mask tensors of one K3 launch (MAX_TENSORS in csrc/dropout_mask.cu)
# integer operations of one K3 mask element: fmix32 of (key ^ tensor id)
# is amortised over the client's elements, the element's own fmix32 is 2
# multiplies, 3 shifts and 4 xors, then a compare and a select
K3_OPS_PER_ELEMENT = 11


def mask_layout(C: int, shapes) -> tuple[list[int], int]:
    """Where each ``[C, rows, width]`` mask tensor of ``shapes`` (its
    ``(rows, width)``) lies in one float32 arena: its offset in floats,
    each rounded up to a multiple of 4 so that every tensor starts 16-byte
    aligned and no quad of K3 straddles two tensors; and the arena's length
    in floats."""
    offsets, end = [], 0
    for rows, width in shapes:
        offsets.append(-(-end // 4) * 4)
        end = offsets[-1] + C * rows * width
    return offsets, end


def _mask_arena(keys: torch.Tensor, specs):
    """An empty arena for ``specs`` on the keys' device, laid out by
    :func:`mask_layout`: ``(arena, offsets, views)``, one contiguous
    ``[C, rows, width]`` view per tensor."""
    C, shapes = keys.numel(), [(r, w) for _, r, w, _ in specs]
    offsets, total = mask_layout(C, shapes)
    arena = torch.empty(total, dtype=torch.float32, device=keys.device)
    views = [arena[o:o + C * r * w].view(C, r, w) for o, (r, w) in zip(offsets, shapes)]
    return arena, offsets, views


def dropout_masks(keys: torch.Tensor, specs) -> list[torch.Tensor]:
    """:func:`dropout_mask` of every ``(tensor_id, rows, width, rate)`` in
    ``specs``, as contiguous ``[C, rows, width]`` views into one arena laid
    out by :func:`mask_layout`: the plain version of K3."""
    _, _, views = _mask_arena(keys, specs)
    for view, (tensor_id, rows, width, rate) in zip(views, specs):
        view.copy_(dropout_mask(keys, tensor_id, rows, width, rate))
    return views


def _check_mask_inputs(keys, specs) -> None:
    if not isinstance(keys, torch.Tensor) or keys.ndim != 1 or keys.dtype != torch.int64:
        raise ValueError("keys must be a 1-D int64 tensor")
    if not 1 <= len(specs) <= MAX_MASKS:
        raise ValueError(f"one launch draws 1 to {MAX_MASKS} masks, not {len(specs)}")
    C = keys.numel()
    for tensor_id, rows, width, rate in specs:
        if C < 1 or rows < 1 or width < 1:
            raise ValueError(f"empty mask: {C} keys, rows {rows}, width {width}")
        if C * rows * width >= 2 ** 31:
            raise ValueError(f"mask [{C}, {rows}, {width}] has 2^31 elements or more")
        if not 0.0 < rate < 1.0:
            raise ValueError(f"dropout rate must be in (0, 1), got {rate} (tensor {tensor_id})")


def fill_masks(keys: torch.Tensor, specs) -> list[torch.Tensor]:
    """:func:`dropout_masks` from one launch of CUDA kernel K3
    (``csrc/dropout_mask.cu``), the port of the mask kernel of
    ``scripts/tpu_validate_pallas.py:125`` (``_mask``).  ``keys``: int64
    [C] from :func:`client_keys`; ``specs``: at most ``MAX_MASKS``
    ``(tensor_id, rows, width, rate)``, each tensor with its own shape,
    rate in (0, 1).

    CUDA keys go to the kernel, one launch for every tensor (counted in
    ``fill_masks.launches``); CPU keys to :func:`dropout_masks`; anything
    else raises.  A counted program (``costmodel.capture``) counts the
    launch by :func:`mask_work` whichever runs."""
    specs = [(int(t), int(r), int(w), float(p)) for t, r, w, p in specs]
    _check_mask_inputs(keys, specs)
    with kernel_work(**mask_work(keys.numel(), specs)):
        if is_fake(keys):
            return _mask_arena(keys, specs)[2]
        if keys.device.type == "cpu":
            return dropout_masks(keys, specs)
        return _fill_masks_on_card(keys, specs)


def _fill_masks_on_card(keys: torch.Tensor, specs) -> list[torch.Tensor]:
    if keys.device.type != "cuda":
        raise ValueError(f"fill_masks runs on cuda or cpu, not {keys.device}")
    from attackfl_tpu_torch.ops.build import MaskSpec, load_library

    lib = load_library("dropout_mask")
    keys = keys.contiguous()
    arena, offsets, views = _mask_arena(keys, specs)
    descs = (MaskSpec * len(specs))(*[
        MaskSpec(o // 4, r * w, t & _M32, *drop_params(p))
        for o, (t, r, w, p) in zip(offsets, specs)])
    with torch.cuda.device(keys.device):
        rc = lib.dropout_masks_fill(keys.data_ptr(), arena.data_ptr(), keys.numel(), descs,
                                    len(specs), torch.cuda.current_stream(keys.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dropout_mask kernel launch failed: CUDA error {rc}")
    _count_launch(fill_masks)
    return views


fill_masks.launches = 0


def fill_mask(keys: torch.Tensor, tensor_id: int, rows: int, width: int,
              rate: float) -> torch.Tensor:
    """One mask tensor from :func:`fill_masks`: :func:`dropout_mask` on the
    CPU, one K3 launch on the card."""
    return fill_masks(keys, [(tensor_id, rows, width, rate)])[0]


# ---------------------------------------------------------------------------
# plain PyTorch version: a line-for-line transliteration of the kernel body
# ---------------------------------------------------------------------------

def _gelu(x):
    t = torch.tanh(_GELU_C * (x + 0.044715 * x * x * x))
    return 0.5 * x * (1.0 + t)


def _gelu_grad(x):
    t = torch.tanh(_GELU_C * (x + 0.044715 * x * x * x))
    return 0.5 * (1.0 + t) + 0.5 * x * (1.0 - t * t) * _GELU_C * (1.0 + 0.134145 * x * x)


def _ln_fwd(r, g, b):
    mu = torch.mean(r, dim=-1, keepdim=True)
    var = torch.mean(torch.square(r - mu), dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + LN_EPS)
    xhat = (r - mu) * rstd
    return xhat * g + b, xhat, rstd


def _ln_bwd(dy, xhat, rstd, g):
    dyg = dy * g
    dg = torch.sum(dy * xhat, dim=1)
    db = torch.sum(dy, dim=1)
    dx = (dyg - torch.mean(dyg, dim=-1, keepdim=True)
          - xhat * torch.mean(dyg * xhat, dim=-1, keepdim=True)) * rstd
    return dx, dg, db


def _dw(x, dz):
    """[C,B,K], [C,B,N] -> [C,K,N] (contract the batch)."""
    return torch.bmm(x.transpose(1, 2), dz)


def _dx(dz, w):
    """[C,B,N], [C,K,N] -> [C,B,K] (contract features)."""
    return torch.bmm(dz, w.transpose(1, 2))


def _pad(x, width=D):
    return F.pad(x, (0, width - x.shape[-1]))


@torch.no_grad()
def run_epoch_reference(p, m, v, batches, seed, t_offset, *, lr, clip,
                        drop_attn=0.1, drop_block=0.1, drop_head=0.3, seed_offset=0,
                        client_base=0):
    """One epoch of fused Adam steps in plain PyTorch ops, on any device.

    Arguments and result as :func:`run_epoch`; p, m and v are updated in
    place."""
    C, nb, B, _ = batches.shape
    seed = seed + seed_offset
    dev = batches.device
    clients = torch.arange(client_base, client_base + C, dtype=torch.int64, device=dev)
    loss_sums = torch.zeros(C, dtype=torch.float32, device=dev)
    rates = (drop_attn, drop_block, drop_head)
    lo, hi = 1e-7, 1.0 - 1e-7
    span = torch.zeros(2, NIN, 1, dtype=torch.float32, device=dev)
    for b, (off, f) in enumerate(zip(IN_OFFS, IN_DIMS)):
        span[b, off:off + f] = 1.0

    for j in range(nb):
        step = t_offset + j
        keys = client_keys(seed, step, clients)

        def mask(tensor_id, width, which):
            if rates[which] > 0.0:
                return dropout_mask(keys, tensor_id, B, width, rates[which])
            return torch.ones((C, B, width), dtype=torch.float32, device=dev)

        w_in, w_sq, w_ff1, w_ff2 = p["w_in"], p["w_sq"], p["w_ff1"], p["w_ff2"]
        w_h1, w_h2, vecs = p["w_h1"], p["w_h2"], p["vecs"]
        data = batches[:, j]                                     # [C,B,32]
        y = data[:, :, COL_LABEL:COL_LABEL + 1]
        msk = data[:, :, COL_MASK:COL_MASK + 1]

        def row(i, w=D):
            return vecs[:, i:i + 1, :w]

        # ---------------- forward ----------------
        stash, xb = [], []
        for b in range(2):
            base = 11 * b
            z1 = torch.bmm(data, w_in[:, b]) + row(base + S_BD)
            x1 = _gelu(z1)
            v_ = torch.bmm(x1, w_sq[:, 2 * b]) + row(base + S_BV)
            mw = mask(T_MW + 4 * b, D, 0)
            vd = v_ * mw
            a = torch.bmm(vd, w_sq[:, 2 * b + 1]) + row(base + S_BO)
            m1 = mask(T_M1 + 4 * b, D, 1)
            r1 = x1 + a * m1
            g1 = row(base + S_G1)
            x2, xhat1, rstd1 = _ln_fwd(r1, g1, row(base + S_BE1))
            z2 = torch.bmm(x2, w_ff1[:, b]) + row(base + S_B1F, FF)
            mf = mask(T_MF + 4 * b, FF, 1)
            hd = _gelu(z2) * mf
            yf = torch.bmm(hd, w_ff2[:, b]) + row(base + S_B2F)
            m2 = mask(T_M2 + 4 * b, D, 1)
            r2 = x2 + yf * m2
            g2 = row(base + S_G2)
            x3, xhat2, rstd2 = _ln_fwd(r2, g2, row(base + S_BE2))
            g3 = row(base + S_G3)
            xb_b, xhat3, rstd3 = _ln_fwd(x3, g3, row(base + S_BE3))
            xb.append(xb_b)
            stash.append((z1, x1, mw, vd, m1, xhat1, rstd1, g1, x2, z2, mf,
                          hd, m2, xhat2, rstd2, g2, xhat3, rstd3, g3))

        cc = torch.cat(xb, dim=-1)                               # [C,B,128]
        z4 = torch.bmm(cc, w_h1) + row(S_BF1)
        m4 = mask(T_M4, D, 2)
        x4d = _gelu(z4) * m4
        z5 = torch.bmm(x4d, w_h2) + row(S_BF2, 32)
        x5 = _gelu(z5)
        wo = row(S_WOUT, 32)
        z6 = torch.sum(x5 * wo, dim=-1, keepdim=True) + row(S_BOUT, 1)
        prob = torch.sigmoid(z6)                                 # [C,B,1]
        pc = torch.clamp(prob, lo, hi)

        msum = torch.clamp(torch.sum(msk, dim=1, keepdim=True), min=1.0)
        per = -(y * torch.log(pc) + (1.0 - y) * torch.log(1.0 - pc))
        loss_sums += (torch.sum(per * msk, dim=1, keepdim=True) / msum)[:, 0, 0]

        # ---------------- backward ----------------
        within = ((prob > lo) & (prob < hi)).to(torch.float32)
        dpc = msk * (pc - y) / (pc * (1.0 - pc)) / msum
        dz6 = dpc * within * prob * (1.0 - prob)                 # [C,B,1]
        g_wout = torch.sum(x5 * dz6, dim=1)                      # [C,32]
        g_bout = torch.sum(dz6, dim=1)                           # [C,1]
        dz5 = dz6 * wo * _gelu_grad(z5)
        g_wh2 = _dw(x4d, dz5)
        g_bf2 = torch.sum(dz5, dim=1)
        dz4 = _dx(dz5, w_h2) * m4 * _gelu_grad(z4)
        g_wh1 = _dw(cc, dz4)
        g_bf1 = torch.sum(dz4, dim=1)
        dcc = _dx(dz4, w_h1)

        g_vecs = torch.zeros_like(vecs)
        g_win = torch.zeros_like(w_in)
        g_wsq = torch.zeros_like(w_sq)
        g_wff1 = torch.zeros_like(w_ff1)
        g_wff2 = torch.zeros_like(w_ff2)
        for b in range(2):
            base = 11 * b
            (z1, x1, mw, vd, m1, xhat1, rstd1, g1, x2, z2, mf,
             hd, m2, xhat2, rstd2, g2, xhat3, rstd3, g3) = stash[b]
            dxb = dcc[:, :, b * D:(b + 1) * D]
            dx3, g_vecs[:, base + S_G3], g_vecs[:, base + S_BE3] = _ln_bwd(dxb, xhat3, rstd3, g3)
            dr2, g_vecs[:, base + S_G2], g_vecs[:, base + S_BE2] = _ln_bwd(dx3, xhat2, rstd2, g2)
            dyf = dr2 * m2
            g_wff2[:, b] = _dw(hd, dyf)
            g_vecs[:, base + S_B2F] = torch.sum(dyf, dim=1)
            dz2 = _dx(dyf, w_ff2[:, b]) * mf * _gelu_grad(z2)
            g_wff1[:, b] = _dw(x2, dz2)
            g_vecs[:, base + S_B1F] = _pad(torch.sum(dz2, dim=1))
            dx2 = dr2 + _dx(dz2, w_ff1[:, b])
            dr1, g_vecs[:, base + S_G1], g_vecs[:, base + S_BE1] = _ln_bwd(dx2, xhat1, rstd1, g1)
            da = dr1 * m1
            g_wsq[:, 2 * b + 1] = _dw(vd, da)
            g_vecs[:, base + S_BO] = torch.sum(da, dim=1)
            dv = _dx(da, w_sq[:, 2 * b + 1]) * mw
            g_wsq[:, 2 * b] = _dw(x1, dv)
            g_vecs[:, base + S_BV] = torch.sum(dv, dim=1)
            dz1 = (dr1 + _dx(dv, w_sq[:, 2 * b])) * _gelu_grad(z1)
            # rows outside the branch's span (and label/mask) never train
            g_win[:, b] = torch.where(span[b] > 0, _dw(data, dz1), 0.0)
            g_vecs[:, base + S_BD] = torch.sum(dz1, dim=1)
        g_vecs[:, S_BF1] = g_bf1
        g_vecs[:, S_BF2] = _pad(g_bf2)
        g_vecs[:, S_WOUT] = _pad(g_wout)
        g_vecs[:, S_BOUT] = _pad(g_bout)
        grads = {"w_in": g_win, "w_sq": g_wsq, "w_ff1": g_wff1,
                 "w_ff2": g_wff2, "w_h1": g_wh1, "w_h2": g_wh2, "vecs": g_vecs}

        # ---------------- clip + Adam ----------------
        if clip > 0.0:
            gn2 = sum(torch.sum(torch.square(g).reshape(C, -1), dim=1)
                      for g in grads.values())
            scale = torch.clamp(
                clip / torch.clamp(torch.sqrt(gn2), min=1e-12), max=1.0)
        else:
            scale = torch.ones(C, dtype=torch.float32, device=dev)
        t = step + 1
        bc1 = float(np.float32(1.0 - B1 ** t))
        bc2 = float(np.float32(1.0 - B2 ** t))
        for k in GROUP_ORDER:
            g = grads[k] * scale.reshape((C,) + (1,) * (grads[k].ndim - 1))
            m_new = B1 * m[k] + (1.0 - B1) * g
            v_new = B2 * v[k] + (1.0 - B2) * (g * g)
            m[k].copy_(m_new)
            v[k].copy_(v_new)
            p[k].copy_(p[k] - lr * (m_new / bc1) / (torch.sqrt(v_new / bc2) + EPS))
    return p, m, v, loss_sums


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

def _check_inputs(p, m, v, batches) -> None:
    if not isinstance(batches, torch.Tensor) or batches.ndim != 4 or batches.shape[-1] != 32:
        raise ValueError("batches must be a [C, nb, B, 32] tensor")
    if batches.dtype != torch.float32 or not batches.is_contiguous():
        raise ValueError("batches must be contiguous float32")
    C, nb, B, _ = batches.shape
    if C < 1 or nb < 1 or B < 1:
        raise ValueError(f"empty batches {tuple(batches.shape)}")
    for label, groups in (("p", p), ("m", m), ("v", v)):
        if set(groups) != set(GROUP_ORDER):
            raise ValueError(f"{label}: groups must be {GROUP_ORDER}")
        for k in GROUP_ORDER:
            t = groups[k]
            if t.device != batches.device:
                raise ValueError(f"{label}[{k}] is on {t.device}, batches on {batches.device}")
            if t.dtype != torch.float32 or not t.is_contiguous():
                raise ValueError(f"{label}[{k}] must be contiguous float32")
            if tuple(t.shape) != (C,) + GROUP_SHAPES[k]:
                raise ValueError(
                    f"{label}[{k}] has shape {tuple(t.shape)}, expected "
                    f"{(C,) + GROUP_SHAPES[k]}")


def _launch(p, m, v, batches, seed: torch.Tensor, seed_offset: int, t_offset, client_base,
            lr, clip, rates) -> torch.Tensor:
    from attackfl_tpu_torch.ops.build import load_library

    lib = load_library("fused_step")
    C, nb, B, _ = batches.shape
    scratch = torch.empty(C * lib.fused_step_scratch_floats(B),
                          dtype=torch.float32, device=batches.device)
    loss = torch.empty(C, dtype=torch.float32, device=batches.device)
    ptrs = (ctypes.c_void_p * (3 * N_G))(
        *[groups[k].data_ptr() for groups in (p, m, v) for k in GROUP_ORDER])
    (thr_a, sc_a), (thr_b, sc_b), (thr_h, sc_h) = (drop_params(r) for r in rates)
    stream = torch.cuda.current_stream(batches.device).cuda_stream
    with torch.cuda.device(batches.device):
        rc = lib.fused_step_run_epoch(
            ptrs, batches.data_ptr(), loss.data_ptr(), scratch.data_ptr(),
            C, nb, B, seed.data_ptr(), seed_offset, t_offset, client_base, lr, clip,
            thr_a, sc_a, thr_b, sc_b, thr_h, sc_h, stream)
    if rc != 0:
        raise RuntimeError(f"fused_step kernel launch failed: CUDA error {rc}")
    # freeing ``scratch`` here is safe: the caching allocator hands its
    # memory only to later work on this same stream
    return loss


def _seed_tensor(seed, device: torch.device) -> torch.Tensor:
    """``seed`` as the 0-dim int64 tensor on ``device`` that K1 reads: a
    tensor as given, an int by a fill on the device (no copy from the
    host)."""
    if not isinstance(seed, torch.Tensor):
        return torch.full((), int(seed), dtype=torch.int64, device=device)
    if seed.dtype != torch.int64 or seed.numel() != 1 or seed.device != device:
        raise ValueError(f"the seed must be one int64 on {device}, got {seed.dtype} "
                         f"{tuple(seed.shape)} on {seed.device}")
    return seed.reshape(()).contiguous()


def run_epoch(p, m, v, batches, seed, t_offset, *, lr, clip,
              drop_attn=0.1, drop_block=0.1, drop_head=0.3, seed_offset=0, client_base=0):
    """One epoch of fused Adam steps for every client.

    p, m, v: dicts of packed ``[C, ...]`` float32 groups (``pack_params``),
    updated in place.  batches: ``[C, nb, B, 32]`` float32.  The epoch's
    dropout seed is ``seed + seed_offset``: ``seed`` an int or a 0-dim
    int64 tensor on the batches' device, which the kernel reads from
    device memory, so a seed drawn on the card is never copied to the
    host; ``seed_offset`` (the epoch) a host int.  t_offset: Adam steps
    taken before this epoch.  ``client_base``: the global index of the
    first client, which keys its dropout masks: a mesh shard's block of
    clients ``base .. base + C`` draws the masks those clients draw in one
    unsharded launch (0: an unsharded launch).  Returns ``(p, m, v, loss_sums [C])``, the
    per-client sum of the nb per-step masked-mean losses.

    CUDA tensors go to the kernel (counted in ``run_epoch.launches``); CPU
    tensors to :func:`run_epoch_reference`.  A counted program
    (``costmodel.capture``) counts the call by :func:`epoch_work`
    whichever runs."""
    _check_inputs(p, m, v, batches)
    C, nb, B, _ = batches.shape
    with kernel_work(**epoch_work(C, nb, B)):
        if is_fake(batches):
            return p, m, v, torch.empty(C, dtype=torch.float32, device=batches.device)
        return _run_epoch(p, m, v, batches, seed, t_offset, lr=lr, clip=clip,
                          drop_attn=drop_attn, drop_block=drop_block, drop_head=drop_head,
                          seed_offset=seed_offset, client_base=client_base)


def _run_epoch(p, m, v, batches, seed, t_offset, *, lr, clip, drop_attn, drop_block,
               drop_head, seed_offset, client_base):
    kw = dict(lr=float(lr), clip=float(clip))
    rates = (float(drop_attn), float(drop_block), float(drop_head))
    if batches.device.type == "cpu":
        if isinstance(seed, torch.Tensor):
            seed = _seed_tensor(seed, batches.device)
        return run_epoch_reference(p, m, v, batches, seed, int(t_offset),
                                   drop_attn=rates[0], drop_block=rates[1],
                                   drop_head=rates[2], seed_offset=int(seed_offset),
                                   client_base=int(client_base), **kw)
    if batches.device.type != "cuda":
        raise ValueError(f"run_epoch runs on cuda or cpu, not {batches.device}")
    loss = _launch(p, m, v, batches, _seed_tensor(seed, batches.device), int(seed_offset),
                   int(t_offset), int(client_base), kw["lr"], kw["clip"], rates)
    _count_launch(run_epoch)
    return p, m, v, loss


run_epoch.launches = 0


NO_BACKWARD = (
    "local_backend 'pallas' has no backward: the fused kernel K1 (csrc/fused_step.cu), "
    "like the JAX package's pallas_call, defines no gradient; differentiate through "
    "local training under local_backend 'xla'")


def build_fused_local_update(dataset: dict[str, torch.Tensor], *, epochs: int,
                             batch_size: int, lr: float, clip_grad_norm: float,
                             dropout=(0.1, 0.1, 0.3)) -> Callable:
    """Batched local training of every client, the port's
    ``build_fused_local_update`` (``fused_step.py:543-645``).

    Returns ``batched(params, idx [C, hi], mask [C, hi], perms [E, C, hi],
    seed, client_base=0) -> (stacked_params [C, ...], ok [C] bool, loss
    [C])``, ``client_base`` the global index of the first client (a mesh
    shard's, :func:`run_epoch`): per epoch
    the PADDED index array is permuted by ``perms[e]``, cut into nb fixed
    minibatches (the tail padded with masked rows), and trained with
    dropout seed ``seed + e`` (``seed`` an int or the round's 0-dim int64
    device tensor); ``loss`` is the last epoch's mean.  K1 has no backward,
    as the JAX package's ``pallas_call`` has none: under a gradient
    (``pytree.under_gradient``) the update refuses
    (:data:`NO_BACKWARD`)."""
    feats = torch.cat([dataset["vitals"], dataset["labs"],
                       dataset["label"][:, None]], dim=1).to(torch.float32)
    B = batch_size
    clip = float(clip_grad_norm) if clip_grad_norm else 0.0

    def batched(params, idx, mask, perms, seed, client_base=0):
        if under_gradient(params):
            raise NotImplementedError(NO_BACKWARD)
        C, hi = idx.shape
        nb = -(-hi // B)
        pad = nb * B - hi
        stacked = params
        if params["fc1"]["kernel"].ndim == 2:
            stacked = tree_broadcast(params, C)
        gp = pack_params(stacked)
        gm = zeros_like_groups(gp)
        gv = zeros_like_groups(gp)
        ok = torch.ones(C, dtype=torch.bool, device=idx.device)
        sums = None
        for e in range(epochs):
            p_idx = torch.gather(idx, 1, perms[e])
            p_msk = torch.gather(mask.to(torch.float32), 1, perms[e])
            bidx = F.pad(p_idx, (0, pad)).reshape(C, nb, B)
            bmsk = F.pad(p_msk, (0, pad)).reshape(C, nb, B)
            batch = torch.cat(
                [feats[bidx], bmsk[..., None],
                 torch.zeros((C, nb, B, 7), dtype=torch.float32, device=idx.device)],
                dim=-1).contiguous()
            gp, gm, gv, sums = run_epoch(
                gp, gm, gv, batch, seed, e * nb, lr=lr, clip=clip, seed_offset=e,
                drop_attn=dropout[0], drop_block=dropout[1], drop_head=dropout[2],
                client_base=client_base)
            ok = ok & torch.isfinite(sums)
        return unpack_params(gp, stacked), ok, sums / nb

    return batched


def epoch_work(C: int, nb: int, B: int) -> dict[str, Any]:
    """Operations and bytes one ``run_epoch`` call needs at these shapes,
    for its roofline bound.  MACs count the live products only, not the
    kernel's padding: each branch's input projection over its own 7 or 16
    columns, the FFN at width 6.  Forward 29,664 per sample; backward a
    weight product for every layer and an input product for every layer
    but the input projections (57,856), so 87,520 MACs per sample."""
    ff = 6
    proj = sum(f * D for f in IN_DIMS)
    fwd = proj + 2 * (D * D + D * D + D * ff + ff * D) + 2 * D * D + D * 32 + 32
    bwd = fwd + (fwd - proj)
    flops = 2 * (fwd + bwd) * B * nb * C
    params = sum(math.prod(s) for s in GROUP_SHAPES.values())
    state_bytes = 2 * 3 * params * 4 * C          # p, m, v read and written
    nbytes = state_bytes + C * nb * B * 32 * 4 + C * 4
    return {"flops": flops, "bytes": nbytes}


def mask_work(C: int, specs) -> dict[str, Any]:
    """Operations and bytes one ``fill_masks`` launch needs for ``specs``
    (its ``(tensor_id, rows, width, rate)``) at C clients, for its
    roofline bound: each mask element written once as float32 and C int64
    keys read; ``K3_OPS_PER_ELEMENT`` int32 operations per element, under
    ``flops`` as XLA's cost analysis counts an elementwise op of any
    type."""
    elements = sum(C * int(rows) * int(width) for _, rows, width, _ in specs)
    return {"flops": K3_OPS_PER_ELEMENT * elements, "bytes": 4 * elements + 8 * C}
