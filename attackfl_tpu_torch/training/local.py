"""Per-client local training with torch autograd, batched over clients: the
port's ``local_backend: xla`` (``attackfl_tpu/training/local.py:39-169``),
for every model of the zoo.

Each minibatch step runs ``torch.func.vmap(torch.func.grad_and_value(loss))``
over the client axis on the model's ``functional_call`` (per-client conv
weights become a grouped conv), then the optax chain of the JAX package,
batched over clients: ``clip_by_global_norm`` per client (no +1e-6) and
Adam (b1 .9, b2 .999, eps 1e-8 outside the sqrt, bias correction at step
t), with a fresh state every call (the reference builds its Adam per
round, client.py:78).

Every client's parameters travel as one row of a flat ``[C, P]`` matrix in
``jax.tree.leaves`` order (``ops/pytree.tree_ravel_stacked``), so the
gradient, the clip and the Adam update are a handful of launches per step
whatever the tree.  The inert attention query/key leaves of
TransformerModel get exactly zero gradient, so Adam leaves them unchanged.

Dropout takes pre-drawn masks at the places and rates the model states
(``Model.mask_specs``: nine tensors a step for TransformerModel and the HAR
TransformerClassifier, two for CNNModel and RNNModel, none for ResNet18),
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

from attackfl_tpu_torch.ops import fused_step
from attackfl_tpu_torch.ops.pytree import (
    tree_broadcast, tree_items, tree_map, tree_ravel_stacked, unraveler,
)

B1, B2, EPS = 0.9, 0.999, 1e-8
P_LO, P_HI = 1e-7, 1.0 - 1e-7
# the dataset columns a model's forward takes, by dataset
INPUTS = {"ICU": ("vitals", "labs"), "HAR": ("x",), "CIFAR10": ("x",)}


def make_loss_fn(model, data_name: str) -> Callable:
    """Per-batch masked mean loss ``loss(params, inputs, label, mask,
    masks)``, ``sum(per * mask) / max(sum(mask), 1)`` (JAX package
    local.py:54-91): ICU, BCE on sigmoid outputs clipped to [1e-7, 1 -
    1e-7] (client.py:77); HAR, softmax cross-entropy on the logits with
    integer labels (client.py:117); CIFAR10, NLL of the log-probabilities
    (src/Validation.py:76).  ``inputs``: the tuple of ``INPUTS[data_name]``
    columns; ``masks`` as the model's forward takes them."""
    if data_name == "ICU":
        def per_row(params, inputs, label, masks):
            probs = torch.clamp(model.apply(params, *inputs, masks=masks)[:, 0], P_LO, P_HI)
            return -(label * torch.log(probs) + (1.0 - label) * torch.log(1.0 - probs))
    elif data_name == "HAR":
        def per_row(params, inputs, label, masks):
            logits = model.apply(params, *inputs, masks=masks)
            picked = torch.gather(logits, 1, label[:, None])[:, 0]
            return torch.logsumexp(logits, dim=-1) - picked
    elif data_name == "CIFAR10":
        def per_row(params, inputs, label, masks):
            logp = model.apply(params, *inputs, masks=masks)
            return -torch.gather(logp, 1, label[:, None])[:, 0]
    else:
        raise ValueError(f"Data name '{data_name}' is not valid.")

    def loss_fn(params, inputs, label, mask, masks=None):
        per = per_row(params, inputs, label, masks)
        return torch.sum(per * mask) / torch.clamp(torch.sum(mask), min=1.0)

    return loss_fn


def labels_of(dataset: dict[str, torch.Tensor], data_name: str) -> torch.Tensor:
    """The label column as the loss takes it: float32 for ICU's BCE, int64
    class indices otherwise."""
    return dataset["label"].to(torch.float32 if data_name == "ICU" else torch.int64)


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


def step_masks(keys: torch.Tensor, specs) -> list[torch.Tensor] | None:
    """The dropout masks of one step for every client (keys [C]), one
    ``[C, rows, width]`` tensor per ``(tensor_id, rows, width, rate)`` of
    ``specs``; None when every rate is 0 (or there is no spec).  The
    tensors with a rate above 0 come from one K3 launch
    (``fused_step.fill_masks``); a rate of 0 gives masks of ones, left out
    of the launch."""
    if all(rate == 0.0 for *_, rate in specs):
        return None
    drawn = iter(fused_step.fill_masks(keys, [s for s in specs if s[3] > 0.0]))
    return [next(drawn) if rate > 0.0 else
            torch.ones((keys.numel(), rows, width), dtype=torch.float32, device=keys.device)
            for _, rows, width, rate in specs]


def build_step_grad(model, data_name: str, template: dict) -> Callable:
    """One minibatch's per-client gradient and loss: ``step(flat [C, P],
    inputs, label [C, B], mask [C, B], masks=None) -> (grads [C, P], loss
    [C])``, ``vmap(grad_and_value)`` over the rows of ``flat``, a tree
    shaped like ``template`` raveled; ``inputs`` a tuple of [C, B, ...]
    tensors and ``masks`` a list of [C, rows, width]."""
    loss_fn = make_loss_fn(model, data_name)
    unravel = unraveler(template)

    def loss_of_row(flat, inputs, label, mask, masks=None):
        return loss_fn(unravel(flat), inputs, label, mask, masks)

    return vmap(grad_and_value(loss_of_row))


def build_local_update(model, data_name: str, dataset: dict[str, torch.Tensor], *,
                       epochs: int, batch_size: int, lr: float, clip_grad_norm: float,
                       dropout=None) -> Callable:
    """Batched local training of every client with torch autograd.

    Returns ``batched(params, idx [C, hi], mask [C, hi], perms [E, C, hi],
    seed) -> (stacked_params [C, ...], ok [C] bool, loss [C])``, the
    signature of ``ops/fused_step.build_fused_local_update``: per epoch the
    PADDED index array is permuted by ``perms[e]`` and cut into nb fixed
    minibatches (the tail padded with masked rows); dropout masks are keyed
    on seed ``seed + e``; ``ok`` is False where any step's loss was not
    finite; ``loss`` is the last epoch's mean over its nb steps.
    ``params``: one tree, or a stacked tree with one row per client.
    ``dropout``: the rates in the order of ``model.dropout_rates`` (None:
    those)."""
    rates = tuple(float(r) for r in (model.dropout_rates if dropout is None else dropout))
    B = batch_size
    clip = float(clip_grad_norm) if clip_grad_norm else 0.0
    names = INPUTS[data_name]
    columns = [dataset[k] for k in names]
    labels = labels_of(dataset, data_name)
    specs = model.mask_specs([(B,) + tuple(x.shape[1:]) for x in columns], rates)
    ndim = {n.replace(".", "/"): p.ndim for n, p in model.named_parameters()}

    def batched(params, idx, mask, perms, seed):
        C, hi = idx.shape
        nb = -(-hi // B)
        pad = nb * B - hi
        path, leaf = next(tree_items(params))
        stacked = tree_broadcast(params, C) if leaf.ndim == ndim[path] else params
        template = tree_map(lambda x: x[0], stacked)
        unravel = unraveler(template)
        step = build_step_grad(model, data_name, template)

        p = tree_ravel_stacked(stacked)
        m, v = torch.zeros_like(p), torch.zeros_like(p)
        ok = torch.ones(C, dtype=torch.bool, device=idx.device)
        clients = torch.arange(C, dtype=torch.int64, device=idx.device)
        loss_sum = None
        for e in range(epochs):
            bidx = F.pad(torch.gather(idx, 1, perms[e]), (0, pad)).reshape(C, nb, B)
            bmsk = F.pad(torch.gather(mask.to(torch.float32), 1, perms[e]),
                         (0, pad)).reshape(C, nb, B)
            binputs, by = [x[bidx] for x in columns], labels[bidx]
            t0 = e * nb
            steps = torch.arange(t0, t0 + nb, dtype=torch.int64, device=idx.device)
            keys = fused_step.client_keys(seed + e, steps[:, None], clients)   # [nb, C]
            loss_sum = torch.zeros(C, dtype=p.dtype, device=idx.device)
            for j in range(nb):
                masks = step_masks(keys[j], specs)
                batch = (tuple(x[:, j] for x in binputs), by[:, j], bmsk[:, j])
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
                      dropout=None) -> Callable:
    """FLTrust's server-side root training (reference server.py:290-293,711;
    JAX ``training/local.py:172-198``): :func:`build_local_update` over one
    "client" holding the whole root set, every slot valid.

    Returns ``root_update(params, perms [E, 1, n], seed) -> params``.  As
    in the JAX package, whose ``build_local_update`` draws a permutation
    every epoch whatever its docstring says, the root set is shuffled each
    epoch by ``perms``; dropout is on at the model's rates (or
    ``dropout``), with masks from K3 keyed on ``seed + e``, whatever
    ``local_backend`` the clients train under."""
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
