"""Per-client local training with torch autograd, batched over clients: the
port's ``local_backend: xla`` (``attackfl_tpu/training/local.py:39-169``).

Each minibatch step runs ``torch.func.vmap(torch.func.grad_and_value(loss))``
over the client axis on the model's ``functional_call``, then the optax
chain of the JAX package, batched over clients: ``clip_by_global_norm``
per client (no +1e-6) and Adam (b1 .9, b2 .999, eps 1e-8 outside the
sqrt, bias correction at step t), with a fresh state every call (the
reference builds its Adam per round, client.py:78).

Every client's parameters travel as one row of a flat ``[C, P]`` matrix in
``jax.tree.leaves`` order (``ops/pytree.tree_ravel_stacked``), so the
gradient, the clip and the Adam update are a handful of launches per step
whatever the tree.  The inert attention query/key leaves get exactly zero
gradient, so Adam leaves them unchanged.

Dropout takes pre-drawn masks at the places and rates of the JAX package's
``xla`` path (see ``models/icu.py``): 9 mask tensors per step and client,
drawn on the card by one launch of kernel K3 (``ops/fused_step.fill_masks``)
per step from the counter-based hash keyed on (seed + epoch, step,
client), with tensor ids apart from the fused kernel's.  The hash gives
the same bits on the CPU and the card, so this path with dropout on is
reproducible across devices.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import grad_and_value, vmap

from attackfl_tpu_torch.models.icu import TransformerModel
from attackfl_tpu_torch.ops import fused_step
from attackfl_tpu_torch.ops.pytree import (
    tree_broadcast, tree_map, tree_ravel_stacked, unraveler,
)

B1, B2, EPS = 0.9, 0.999, 1e-8
P_LO, P_HI = 1e-7, 1.0 - 1e-7

# mask tensor ids: per branch b, T_BRANCH + 4 * b + (attention, attention
# output, FFN hidden, FFN output); then the head.  The fused kernel uses 0-8.
T_BRANCH, T_HEAD = 16, 24
BRANCHES = ("vitals", "labs")
MASKS_PER_STEP = 4 * len(BRANCHES) + 1


def make_loss_fn(model, data_name: str) -> Callable:
    """Per-batch masked mean loss ``loss(params, vitals, labs, label, mask,
    masks)``: BCE on sigmoid outputs clipped to [1e-7, 1 - 1e-7] (ICU,
    client.py:77), ``sum(per * mask) / max(sum(mask), 1)``."""
    if data_name in ("HAR", "CIFAR10"):
        raise NotImplementedError(
            f"the {data_name} loss is not ported yet (ROADMAP.md queue 1, item 11)")
    if data_name != "ICU":
        raise ValueError(f"Data name '{data_name}' is not valid.")

    def loss_fn(params, vitals, labs, label, mask, masks):
        probs = torch.clamp(model.apply(params, vitals, labs, masks)[:, 0], P_LO, P_HI)
        per = -(label * torch.log(probs) + (1.0 - label) * torch.log(1.0 - probs))
        return torch.sum(per * mask) / torch.clamp(torch.sum(mask), min=1.0)

    return loss_fn


def clip_by_global_norm(grads: torch.Tensor, max_norm: float) -> torch.Tensor:
    """optax ``clip_by_global_norm`` on each row of ``grads`` [C, P]."""
    norm = torch.sqrt(torch.sum(grads * grads, dim=1, keepdim=True))
    return torch.where(norm < max_norm, grads, grads / norm * max_norm)


def adam_step_(p: torch.Tensor, m: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
               t: int, lr: float) -> None:
    """optax ``adam`` then ``apply_updates`` at step ``t``, in place."""
    m.mul_(B1).add_(g, alpha=1.0 - B1)
    v.mul_(B2).addcmul_(g, g, value=1.0 - B2)
    bc1 = float(np.float32(1.0 - B1 ** t))
    bc2 = float(np.float32(1.0 - B2 ** t))
    p.add_((m / bc1) / (torch.sqrt(v / bc2) + EPS), alpha=-lr)


def mask_specs(rates, *, heads: int, ff: int, width: int) -> list[tuple[int, int, float]]:
    """The ``(tensor_id, width, rate)`` of each of a step's
    ``MASKS_PER_STEP`` mask tensors, in the order :func:`step_masks`
    returns them: per branch (attention, attention output, FFN hidden, FFN
    output), then the head.  ``rates``: (attention, block, head)."""
    attn, block, head = rates
    specs = []
    for b in range(len(BRANCHES)):
        tid = T_BRANCH + 4 * b
        specs += [(tid, heads, attn), (tid + 1, width, block), (tid + 2, ff, block),
                  (tid + 3, width, block)]
    return specs + [(T_HEAD, width, head)]


def step_masks(keys: torch.Tensor, rows: int, rates, *, heads: int, ff: int,
               width: int) -> dict | None:
    """The dropout masks of one step for every client (keys [C]), as
    ``TransformerModel.apply`` takes them; None when every rate is 0.  The
    tensors with a rate above 0 come from one K3 launch
    (``fused_step.fill_masks``); a rate of 0 gives masks of ones, left out
    of the launch.  ``heads``: attention heads; ``ff``: FFN hidden width;
    ``width``: the model width, which the attention output, the FFN output
    and fc1's output all have."""
    if all(r == 0.0 for r in rates):
        return None
    specs = mask_specs(rates, heads=heads, ff=ff, width=width)
    drawn = iter(fused_step.fill_masks(keys, [s for s in specs if s[2] > 0.0], rows))
    masks = [next(drawn) if rate > 0.0 else
             torch.ones((keys.numel(), rows, cols), dtype=torch.float32, device=keys.device)
             for _, cols, rate in specs]
    out = {name: tuple(masks[4 * b:4 * b + 4]) for b, name in enumerate(BRANCHES)}
    out["head"] = masks[-1]
    return out


def mask_widths(model: TransformerModel) -> dict[str, int]:
    """The ``heads``, ``ff`` and ``width`` of :func:`step_masks` for ``model``."""
    return dict(heads=model.vitals_transformer.attention.value.kernel.shape[1],
                ff=model.vitals_transformer.ffn_dense1.kernel.shape[1],
                width=model.fc1.kernel.shape[1])


def build_local_update(model, data_name: str, dataset: dict[str, torch.Tensor], *,
                       epochs: int, batch_size: int, lr: float, clip_grad_norm: float,
                       dropout=(0.1, 0.1, 0.3)) -> Callable:
    """Batched local training of every client with torch autograd.

    Returns ``batched(params, idx [C, hi], mask [C, hi], perms [E, C, hi],
    seed) -> (stacked_params [C, ...], ok [C] bool, loss [C])``, the
    signature of ``ops/fused_step.build_fused_local_update``: per epoch the
    PADDED index array is permuted by ``perms[e]`` and cut into nb fixed
    minibatches (the tail padded with masked rows); dropout masks are keyed
    on seed ``seed + e``; ``ok`` is False where any step's loss was not
    finite; ``loss`` is the last epoch's mean over its nb steps.
    ``dropout``: rates (attention, block, head)."""
    if not isinstance(model, TransformerModel):
        raise NotImplementedError(
            f"local training of {type(model).__name__} is not ported yet "
            "(ROADMAP.md queue 1, item 11)")
    loss_fn = make_loss_fn(model, data_name)
    rates = tuple(float(r) for r in dropout)
    B = batch_size
    clip = float(clip_grad_norm) if clip_grad_norm else 0.0
    widths = mask_widths(model)
    vitals, labs = dataset["vitals"], dataset["labs"]
    labels = dataset["label"].to(torch.float32)

    def batched(params, idx, mask, perms, seed):
        C, hi = idx.shape
        nb = -(-hi // B)
        pad = nb * B - hi
        stacked = params
        if params["fc1"]["kernel"].ndim == 2:
            stacked = tree_broadcast(params, C)
        unravel = unraveler(tree_map(lambda x: x[0], stacked))

        def loss_of_row(flat, vit, lab, y, msk, masks=None):
            return loss_fn(unravel(flat), vit, lab, y, msk, masks)

        step = vmap(grad_and_value(loss_of_row))

        p = tree_ravel_stacked(stacked).to(torch.float32)
        m, v = torch.zeros_like(p), torch.zeros_like(p)
        ok = torch.ones(C, dtype=torch.bool, device=idx.device)
        clients = torch.arange(C, dtype=torch.int64, device=idx.device)
        loss_sum = None
        for e in range(epochs):
            bidx = F.pad(torch.gather(idx, 1, perms[e]), (0, pad)).reshape(C, nb, B)
            bmsk = F.pad(torch.gather(mask.to(torch.float32), 1, perms[e]),
                         (0, pad)).reshape(C, nb, B)
            bvit, blab, by = vitals[bidx], labs[bidx], labels[bidx]
            t0 = e * nb
            steps = torch.arange(t0, t0 + nb, dtype=torch.int64, device=idx.device)
            keys = fused_step.client_keys(seed + e, steps[:, None], clients)   # [nb, C]
            loss_sum = torch.zeros(C, dtype=torch.float32, device=idx.device)
            for j in range(nb):
                masks = step_masks(keys[j], B, rates, **widths)
                batch = (bvit[:, j], blab[:, j], by[:, j], bmsk[:, j])
                grads, loss = step(p, *batch, *(() if masks is None else (masks,)))
                ok &= torch.isfinite(loss)
                loss_sum += loss
                if clip > 0.0:
                    grads = clip_by_global_norm(grads, clip)
                adam_step_(p, m, v, grads, t0 + j + 1, lr)
        return tree_map(lambda x: x.contiguous(), unravel(p)), ok, loss_sum / nb

    return batched


def build_root_update(model, data_name: str, root_data: dict[str, torch.Tensor], *,
                      epochs: int, batch_size: int, lr: float, clip_grad_norm: float,
                      dropout=(0.1, 0.1, 0.3)) -> Callable:
    """FLTrust's server-side root training (reference server.py:290-293,711;
    JAX ``training/local.py:172-198``): :func:`build_local_update` over one
    "client" holding the whole root set, every slot valid.

    Returns ``root_update(params, perms [E, 1, n], seed) -> params``.  As
    in the JAX package, whose ``build_local_update`` draws a permutation
    every epoch whatever its docstring says, the root set is shuffled each
    epoch by ``perms``; dropout is on, with masks from K3 keyed on
    ``seed + e``, whatever ``local_backend`` the clients train under."""
    n = next(iter(root_data.values())).shape[0]
    device = next(iter(root_data.values())).device
    idx = torch.arange(n, dtype=torch.int64, device=device)[None]
    mask = torch.ones((1, n), dtype=torch.bool, device=device)
    inner = build_local_update(model, data_name, root_data, epochs=epochs,
                               batch_size=batch_size, lr=lr,
                               clip_grad_norm=clip_grad_norm, dropout=dropout)

    def root_update(params, perms, seed):
        stacked, _ok, _loss = inner(params, idx, mask, perms, seed)
        return tree_map(lambda x: x[0], stacked)

    return root_update
