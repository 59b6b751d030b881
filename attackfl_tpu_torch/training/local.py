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

``compute_dtype`` (``cfg.mesh.compute_dtype`` bfloat16 or float16) runs
the model's forward and backward in that dtype, as JAX's ``make_loss_fn``
(local.py:39-91) does: the unravelled parameters and the floating input
columns are cast on the way into the model, its output is cast back to
float32 and the loss is reduced in float32.  The gradient comes back
float32 through the cast's backward, so the master parameters, the clip
and Adam stay float32.  There is no loss scaling, as in the JAX package.
``None`` casts nothing.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import grad_and_value, vmap

from attackfl_tpu_torch.costmodel.capture import counting
from attackfl_tpu_torch.device import CAPTURE_LOCK
from attackfl_tpu_torch.ops import fused_step
from attackfl_tpu_torch.ops.pytree import (
    tree_broadcast, tree_items, tree_map, tree_ravel_stacked, under_gradient, unraveler,
)

B1, B2, EPS = 0.9, 0.999, 1e-8
P_LO, P_HI = 1e-7, 1.0 - 1e-7
# the dataset columns a model's forward takes, by dataset
INPUTS = {"ICU": ("vitals", "labs"), "HAR": ("x",), "CIFAR10": ("x",)}
COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}


def resolve_compute_dtype(name: str) -> torch.dtype | None:
    """``cfg.mesh.compute_dtype`` as :func:`make_loss_fn` takes it: None
    for float32 (no cast at all), else the torch dtype."""
    return None if name == "float32" else COMPUTE_DTYPES[name]


def make_loss_fn(model, data_name: str, compute_dtype: torch.dtype | None = None
                 ) -> Callable:
    """Per-batch masked mean loss ``loss(params, inputs, label, mask,
    masks)``, ``sum(per * mask) / max(sum(mask), 1)`` (JAX package
    local.py:54-91): ICU, BCE on sigmoid outputs clipped to [1e-7, 1 -
    1e-7] (client.py:77); HAR, softmax cross-entropy on the logits with
    integer labels (client.py:117); CIFAR10, NLL of the log-probabilities
    (src/Validation.py:76).  ``inputs``: the tuple of ``INPUTS[data_name]``
    columns; ``masks`` as the model's forward takes them.  With
    ``compute_dtype`` the model runs in that dtype and its output is
    float32 again before the loss."""
    def forward(params, inputs, masks):
        if compute_dtype is None:
            return model.apply(params, *inputs, masks=masks)
        cast = lambda x: x.to(compute_dtype) if x.is_floating_point() else x  # noqa: E731
        out = model.apply(tree_map(cast, params), *(cast(x) for x in inputs), masks=masks)
        return out.to(torch.float32)

    if data_name == "ICU":
        def per_row(params, inputs, label, masks):
            probs = torch.clamp(forward(params, inputs, masks)[:, 0], P_LO, P_HI)
            return -(label * torch.log(probs) + (1.0 - label) * torch.log(1.0 - probs))
    elif data_name == "HAR":
        def per_row(params, inputs, label, masks):
            logits = forward(params, inputs, masks)
            picked = torch.gather(logits, 1, label[:, None])[:, 0]
            return torch.logsumexp(logits, dim=-1) - picked
    elif data_name == "CIFAR10":
        def per_row(params, inputs, label, masks):
            logp = forward(params, inputs, masks)
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


def adam_step(state: dict[str, torch.Tensor], g: torch.Tensor, t: int, lr: float) -> None:
    """optax ``adam`` then ``apply_updates`` at step ``t`` on ``state``'s
    ``p``, ``m`` and ``v``.  Each entry is rebound to a new tensor and no
    tensor that autograd saved is written, so the damage objectives
    (``Simulator.damage_objective``) differentiate through local training;
    the in-place ops run on the step's own temporaries, so the bits are
    those of optax's step written in place.  ``state`` holds the only
    reference to each old tensor, which is freed as its successor is
    made: the peak is an in-place step's."""
    state["m"] = (state["m"] * B1).add_(g, alpha=1.0 - B1)
    state["v"] = (state["v"] * B2).addcmul_(g, g, value=1.0 - B2)
    bc1 = float(np.float32(1.0 - B1 ** t))
    bc2 = float(np.float32(1.0 - B2 ** t))
    upd = (state["m"] / bc1) / (torch.sqrt(state["v"] / bc2) + EPS)
    state["p"] = torch.add(state["p"], upd, alpha=-lr)


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


def build_step_grad(model, data_name: str, template: dict,
                    compute_dtype: torch.dtype | None = None) -> Callable:
    """One minibatch's per-client gradient and loss: ``step(flat [C, P],
    inputs, label [C, B], mask [C, B], masks=None) -> (grads [C, P], loss
    [C])``, ``vmap(grad_and_value)`` over the rows of ``flat``, a tree
    shaped like ``template`` raveled; ``inputs`` a tuple of [C, B, ...]
    tensors and ``masks`` a list of [C, rows, width].  ``compute_dtype``:
    see :func:`make_loss_fn`."""
    loss_fn = make_loss_fn(model, data_name, compute_dtype)
    unravel = unraveler(template)

    def loss_of_row(flat, inputs, label, mask, masks=None):
        return loss_fn(unravel(flat), inputs, label, mask, masks)

    return vmap(grad_and_value(loss_of_row))


class StepGraph:
    """One minibatch step of ``segment`` clients (``build_step_grad``'s
    ``step`` and the clip) captured in a CUDA graph, replayed for every segment of the
    matrix's fold (``matrix/program.py``): the host issues one replay in
    place of the step's ~200 launches.  The graph's inputs have the shapes
    and strides of the eager call's (step ``j`` of ``[segment, nb, B,
    ...]`` batches, the masks' ``[segment, rows, width]`` rows), so it
    runs the kernels the eager call runs, and gives its bits: a replay
    equals the eager step bit for bit on the H100 (``PERF.md``).
    It is captured once, after two eager calls on a side stream (cuBLAS's
    handle and workspace), with no host sync, holding
    ``device.CAPTURE_LOCK``: another thread's device-wide sync during the
    capture would invalidate it."""

    def __init__(self, step: Callable, p: torch.Tensor, binputs, by: torch.Tensor,
                 bmsk: torch.Tensor, masks, segment: int):
        def like(x):
            return torch.zeros((segment,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)

        self.p = torch.zeros_like(p)
        self.binputs = [like(x) for x in binputs]
        self.by, self.bmsk = like(by), like(bmsk)
        self.masks = None if masks is None else [like(m) for m in masks]
        args = (self.p, tuple(x[:, 0] for x in self.binputs), self.by[:, 0], self.bmsk[:, 0],
                *(() if self.masks is None else (self.masks,)))
        current = torch.cuda.current_stream(p.device)
        side = torch.cuda.Stream(p.device)
        side.wait_stream(current)
        with CAPTURE_LOCK, torch.cuda.stream(side):
            for _ in range(2):
                step(*args)
            self.graph = torch.cuda.CUDAGraph()
            self.graph.capture_begin(capture_error_mode="thread_local")
            try:
                self.out = step(*args)
            finally:
                self.graph.capture_end()
        current.wait_stream(side)

    def __call__(self, p, binputs, by, bmsk, j: int, masks, rows: slice):
        """The step of ``rows`` at step ``j``: its inputs copied into the
        graph's, one replay; the outputs are the graph's own tensors."""
        self.p.copy_(p)
        for mine, x in zip(self.binputs, binputs):
            mine[:, 0].copy_(x[rows, j])
        self.by[:, 0].copy_(by[rows, j])
        self.bmsk[:, 0].copy_(bmsk[rows, j])
        if masks is not None:
            for mine, m in zip(self.masks, masks):
                mine.copy_(m[rows])
        self.graph.replay()
        return self.out


def build_local_update(model, data_name: str, dataset: dict[str, torch.Tensor], *,
                       epochs: int, batch_size: int, lr: float, clip_grad_norm: float,
                       dropout=None, compute_dtype: torch.dtype | None = None) -> Callable:
    """Batched local training of every client with torch autograd.

    Returns ``batched(params, idx [C, hi], mask [C, hi], perms [E, C, hi],
    seed, clients=None, segment=None, client_base=0) -> (stacked_params
    [C, ...], ok [C] bool, loss [C])``, the signature of
    ``ops/fused_step.build_fused_local_update``:
    per epoch the PADDED index array is permuted by ``perms[e]`` and cut
    into nb fixed minibatches (the tail padded with masked rows); dropout
    masks are keyed on seed ``seed + e``; ``ok`` is False where any step's
    loss was not finite; ``loss`` is the last epoch's mean over its nb
    steps.  ``params``: one tree, or a stacked tree with one row per
    client.  ``dropout``: the rates in the order of ``model.dropout_rates``
    (None: those); ``compute_dtype``: see :func:`make_loss_fn`.

    The same call trains many runs' clients together (the scenario
    matrix's fold, ``matrix/program.py``): ``seed`` a [C] tensor, each
    row's run's draw, and ``clients`` [C] each row's client id within its
    run.  The keys ``client_keys(seed + e, step, client)`` are elementwise,
    so every row draws the masks of its own run, all rows' in one K3
    launch a step.  A client mesh's shard (``parallel/shard.py``) trains
    its block as global clients ``client_base ..`` (``clients`` None), so
    its rows draw the masks of one unsharded call.

    Every step runs out of place (:func:`adam_step`), so the engine's
    damage objective differentiates through a round's training; under a
    gradient (``pytree.under_gradient``) ``segment`` is refused."""
    rates = tuple(float(r) for r in (model.dropout_rates if dropout is None else dropout))
    B = batch_size
    clip = float(clip_grad_norm) if clip_grad_norm else 0.0
    names = INPUTS[data_name]
    columns = [dataset[k] for k in names]
    labels = labels_of(dataset, data_name)
    specs = model.mask_specs([(B,) + tuple(x.shape[1:]) for x in columns], rates)
    ndim = {n.replace(".", "/"): p.ndim for n, p in model.named_parameters()}
    # the captured gradient step of a segment, by its row count (the card)
    graphs: dict[int, StepGraph] = {}

    def batched(params, idx, mask, perms, seed, clients=None, segment=None, client_base=0):
        C, hi = idx.shape
        nb = -(-hi // B)
        pad = nb * B - hi
        path, leaf = next(tree_items(params))
        stacked = tree_broadcast(params, C) if leaf.ndim == ndim[path] else params
        template = tree_map(lambda x: x[0], stacked)
        unravel = unraveler(template)
        grad = build_step_grad(model, data_name, template, compute_dtype)

        def step(*args):
            # the clip's row norms are reductions over P whose split on the
            # card depends on the row count below 16, so a segment clips
            # its own rows, as its standalone call does
            grads, loss = grad(*args)
            return (clip_by_global_norm(grads, clip) if clip > 0.0 else grads), loss

        def grad_rows(p, binputs, by, bmsk, j, masks):
            """Step ``j``'s clipped gradients and losses: one call of
            ``step`` for each ``segment`` rows (all rows at once when
            None); on the card each segment's call replays one captured
            graph."""
            def args(r):
                return (p[r], tuple(x[r, j] for x in binputs), by[r, j], bmsk[r, j],
                        *(() if masks is None else ([m[r] for m in masks],)))
            if segment is None or segment >= C:
                return step(*args(slice(None)))
            rows = [slice(i, i + segment) for i in range(0, C, segment)]
            if p.is_cuda and not counting():
                graph = graphs.get(segment)
                if graph is None:
                    graph = graphs[segment] = StepGraph(step, p[rows[0]], binputs, by, bmsk,
                                                        masks, segment)
                grads = torch.empty_like(p)
                loss = torch.empty(C, dtype=p.dtype, device=p.device)
                for r in rows:
                    g, v = graph(p[r], binputs, by, bmsk, j, masks, r)
                    grads[r].copy_(g)
                    loss[r].copy_(v)
                return grads, loss
            parts = [step(*args(r)) for r in rows]
            return torch.cat([g for g, _ in parts]), torch.cat([v for _, v in parts])

        if segment is not None and under_gradient(params):
            raise ValueError("a local update under a gradient runs no segment: a captured "
                             "step graph writes its outputs in place")
        # Adam's state; adam_step rebinds its entries, the only references
        opt = {"p": tree_ravel_stacked(stacked)}
        opt["m"], opt["v"] = torch.zeros_like(opt["p"]), torch.zeros_like(opt["p"])
        ok = torch.ones(C, dtype=torch.bool, device=idx.device)
        if clients is None:
            clients = torch.arange(client_base, client_base + C, dtype=torch.int64,
                                   device=idx.device)
        loss_sum = None
        for e in range(epochs):
            bidx = F.pad(torch.gather(idx, 1, perms[e]), (0, pad)).reshape(C, nb, B)
            bmsk = F.pad(torch.gather(mask.to(torch.float32), 1, perms[e]),
                         (0, pad)).reshape(C, nb, B)
            binputs, by = [x[bidx] for x in columns], labels[bidx]
            t0 = e * nb
            steps = torch.arange(t0, t0 + nb, dtype=torch.int64, device=idx.device)
            keys = fused_step.client_keys(seed + e, steps[:, None], clients)   # [nb, C]
            loss_sum = torch.zeros(C, dtype=opt["p"].dtype, device=idx.device)
            for j in range(nb):
                masks = step_masks(keys[j], specs)
                grads, loss = grad_rows(opt["p"], binputs, by, bmsk, j, masks)
                ok = ok & torch.isfinite(loss)
                loss_sum = loss_sum + loss
                adam_step(opt, grads, t0 + j + 1, lr)
        return tree_map(lambda x: x.contiguous(), unravel(opt["p"])), ok, loss_sum / nb

    batched.graphs = graphs   # read by the recompile guard (analysis/retrace.py)
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
