"""The hypernetworks of hyper mode (the port's ``attackfl_tpu/models/hyper.py``):
a per-client embedding table feeding an MLP trunk whose features one
linear head per target-parameter leaf maps to that client's full model.

Both classes compute the same function, as in the JAX package:

    emd = embeddings[i]                        N(0, 1) init
    f = mlp_in(emd); f = mlp_hidden_k(relu(f)) for k < n_hidden
    leaf = (f @ head.kernel + head.bias).reshape(leaf shape)

with every dense in flax's ``(in, out)`` layout and torch ``Linear``'s
init, ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))`` for kernel and bias.  They
differ in the heads' names only: :class:`HyperNetwork` derives them from
the target tree (``head_`` + the leaf path with ``/`` -> ``__``),
:class:`CNNHyper` hand-writes one per CNNModel layer and refuses any
other target.  With ``spec_norm`` every kernel is divided by its largest
singular value (:func:`spectral_normalize`).

The parameters travel as ONE flat vector, as a client's parameters travel
as one row of the local update's ``[C, P]`` matrix, so the clip and Adam
of the hypernetwork update are a handful of launches whatever the number
of heads.  Its layout: the embedding table, the trunk's kernels and
biases, then every head's kernel side by side as one ``(hidden, P)``
matrix and every bias as one ``(P,)`` vector, both in the target's leaf
order (``ops/pytree.tree_items``).  Generating every client is then one
``(C, hidden) @ (hidden, P)`` product plus the bias, and its rows are
already the local update's flat rows.  :meth:`HyperNetwork.tree` gives
the flax-named tree of views (the JAX layout, the checkpoint's), and
:meth:`HyperNetwork.from_tree` its inverse.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from attackfl_tpu_torch.ops.pytree import tree_items, unraveler

SPEC_NORM_ITERS = 15


class Segments:
    """Kernels of ``widths`` columns laid side by side: each column's
    kernel id (``ids``) and the per-kernel sums of a row's columns
    (:meth:`sum`), as differences of float64 prefix sums.  No atomics, so
    the sums take the same order on the CPU and the card, and a few wide
    kernels do not serialize on their few output slots."""

    def __init__(self, widths: list[int], device: torch.device | str):
        width = torch.tensor(widths, device=device)
        self.ids = torch.repeat_interleave(torch.arange(len(widths), device=device), width)
        self.last = torch.cumsum(width, 0) - 1
        self.before = self.last - width           # -1 for the first kernel
        # the power iteration's start, 1/sqrt(fan_out) in each kernel's columns
        self.u0 = torch.tensor([1.0 / math.sqrt(k) for k in widths], dtype=torch.float64,
                               device=device).index_select(0, self.ids)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """(..., F) -> (..., S): the sum of each kernel's columns."""
        prefix = torch.cumsum(x, -1, dtype=torch.float64)
        head = prefix.index_select(-1, self.before.clamp(min=0)) * (self.before >= 0)
        return (prefix.index_select(-1, self.last) - head).to(x.dtype)


def segment_sigmas(w: torch.Tensor, segs: Segments,
                   n_iter: int = SPEC_NORM_ITERS) -> torch.Tensor:
    """The largest singular value of each of the kernels that ``w``
    (fan_in, F) holds side by side (``segs``): ``n_iter`` power iterations
    from the fixed start ``u0 = 1/sqrt(fan_out)``, with ``u`` and ``v``
    detached, then ``sigma = v . (w u)`` (JAX ``spectral_normalize``,
    hyper.py:30-57).  Returns (S,)."""
    with torch.no_grad():
        u = segs.u0.to(w.dtype)
        for _ in range(n_iter):
            v = segs.sum(w * u)                                          # w_s @ u_s
            v = v / (torch.linalg.vector_norm(v, dim=0) + 1e-12)
            u = torch.sum(w * v.index_select(1, segs.ids), dim=0)        # w_s^T v_s
            u = u / (torch.sqrt(segs.sum(u * u)) + 1e-12).index_select(0, segs.ids)
    return segs.sum(torch.sum(v.index_select(1, segs.ids) * w, dim=0) * u)


def spectral_normalize(kernel: torch.Tensor, segs: Segments | None = None,
                       n_iter: int = SPEC_NORM_ITERS) -> torch.Tensor:
    """``kernel`` divided by an estimate of its largest singular value, on
    the kernel reshaped ``(fan_in, fan_out)``; stateless, as the JAX
    package's (no ``torch.nn.utils.spectral_norm`` buffer).  ``segs``:
    ``Segments([fan_out])`` on the kernel's device, built here if not given."""
    w = kernel.reshape(-1, kernel.shape[-1])
    segs = Segments([w.shape[1]], w.device) if segs is None else segs
    return kernel / (segment_sigmas(w, segs, n_iter)[0] + 1e-12)


class HyperNetwork:
    """Embedding(n_nodes, embedding_dim) -> MLP(hidden_dim, n_hidden) ->
    one head per leaf of ``template`` (JAX ``HyperNetwork``, hyper.py:128-193;
    reference src/Model.py:251-304, ``HyperNetwork(net, total_clients, 8,
    100, False, 2)`` at server.py:800).

    It holds no weights: every method takes the flat parameter vector
    ``flat``, as ``Model.apply`` takes its tree."""

    def __init__(self, template: dict, n_nodes: int, embedding_dim: int = 8,
                 hidden_dim: int = 100, spec_norm: bool = False, n_hidden: int = 2):
        self.n_nodes, self.hidden_dim, self.spec_norm = n_nodes, hidden_dim, spec_norm
        self.widths = [leaf.numel() for _, leaf in tree_items(template)]
        self.num_target = sum(self.widths)
        self.unravel_target = unraveler(template)
        heads = self.head_names(template)
        # (flax path, shape, offset into flat) of the trunk's leaves
        dims = [embedding_dim] + [hidden_dim] * (n_hidden + 1)
        denses = ["mlp_in"] + [f"mlp_hidden{i}" for i in range(n_hidden)]
        trunk = [("embeddings/embedding", (n_nodes, embedding_dim))]
        for name, fan_in, fan_out in zip(denses, dims, dims[1:]):
            trunk += [(f"{name}/kernel", (fan_in, fan_out)), (f"{name}/bias", (fan_out,))]
        self.trunk, offset = [], 0
        for path, shape in trunk:
            self.trunk.append((path, shape, offset))
            offset += math.prod(shape)
        self.numel = offset + (hidden_dim + 1) * self.num_target
        # (flax head name, column offset, width) per target leaf
        cols = [0]
        for w in self.widths:
            cols.append(cols[-1] + w)
        self.heads = list(zip(heads, cols, self.widths))
        # spectral norm's Segments per device: (the trunk's, the heads')
        self._segments: dict[torch.device, tuple[Segments, Segments]] = {}

    def head_names(self, template: dict) -> list[str]:
        """The flax head name of each target leaf, in leaf order."""
        return ["head_" + path.replace("/", "__") for path, _ in tree_items(template)]

    # ------------------------------------------------------------------
    # the flat vector
    # ------------------------------------------------------------------

    def parts(self, flat: torch.Tensor):
        """Views of ``flat``: ``(embeddings (n_nodes, E), [(kernel, bias)]
        of the trunk's denses, heads' kernel (hidden, P), heads' bias (P,))``."""
        shapes = [s for _, s, _ in self.trunk] + [(self.hidden_dim, self.num_target),
                                                   (self.num_target,)]
        # one split, so under autograd the flat gradient is one concatenation
        views = [part.view(s) for part, s in
                 zip(torch.split(flat, [math.prod(s) for s in shapes]), shapes)]
        return views[0], list(zip(views[1:-2:2], views[2:-2:2])), views[-2], views[-1]

    @torch.no_grad()
    def init(self, generator: torch.Generator | None = None, device: torch.device | str = "cpu",
             dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """A fresh flat parameter vector: embeddings N(0, 1), every kernel
        and bias U(-1/sqrt(fan_in), 1/sqrt(fan_in)), drawn on the CPU from
        ``generator`` (so CPU and card runs start alike), then moved."""
        flat = torch.empty(self.numel, dtype=dtype)
        emb, denses, kernel, bias = self.parts(flat)
        emb.normal_(0.0, 1.0, generator=generator)
        for k, b in denses:
            lim = 1.0 / math.sqrt(k.shape[0])
            k.uniform_(-lim, lim, generator=generator)
            b.uniform_(-lim, lim, generator=generator)
        lim = 1.0 / math.sqrt(self.hidden_dim)
        kernel.uniform_(-lim, lim, generator=generator)
        bias.uniform_(-lim, lim, generator=generator)
        return flat.to(device)

    def jax_shapes(self) -> dict[str, tuple[int, ...]]:
        """The flax parameter tree's leaf paths and shapes."""
        shapes = {path: shape for path, shape, _ in self.trunk}
        for name, _, width in self.heads:
            shapes[f"{name}/kernel"] = (self.hidden_dim, width)
            shapes[f"{name}/bias"] = (width,)
        return shapes

    def _leaves(self, flat: torch.Tensor) -> dict[str, torch.Tensor]:
        """Flax path -> view of ``flat`` (head kernels are column blocks)."""
        out = {path: flat[o:o + math.prod(s)].view(s) for path, s, o in self.trunk}
        _, _, kernel, bias = self.parts(flat)
        for name, col, width in self.heads:
            out[f"{name}/kernel"] = kernel[:, col:col + width]
            out[f"{name}/bias"] = bias[col:col + width]
        return out

    def tree(self, flat: torch.Tensor) -> dict[str, Any]:
        """The flax-named parameter tree, as views of ``flat``."""
        tree: dict[str, Any] = {}
        for path, leaf in self._leaves(flat).items():
            module, name = path.split("/")
            tree.setdefault(module, {})[name] = leaf
        return tree

    @torch.no_grad()
    def from_tree(self, tree: dict[str, Any], device: torch.device | str | None = None,
                  ) -> torch.Tensor:
        """The flat vector of a flax-named tree (the inverse of :meth:`tree`);
        ValueError unless its paths and shapes are this network's."""
        leaves = dict(tree_items(tree))
        expected = self.jax_shapes()
        got = {path: tuple(x.shape) for path, x in leaves.items()}
        if got != expected:
            diff = {p: (got.get(p), expected.get(p)) for p in sorted(set(got) | set(expected))
                    if got.get(p) != expected.get(p)}
            raise ValueError(f"hypernetwork parameters differ (got, expected): {diff}")
        first = next(iter(leaves.values()))
        flat = torch.empty(self.numel, dtype=first.dtype,
                           device=first.device if device is None else device)
        for path, view in self._leaves(flat).items():
            view.copy_(leaves[path])
        return flat

    # ------------------------------------------------------------------
    # generation
    # ------------------------------------------------------------------

    def _kernels(self, denses, kernel):
        """The trunk's kernels and the heads' kernel, spectrally normalized
        where ``spec_norm`` asks (per dense, per head)."""
        if not self.spec_norm:
            return [k for k, _ in denses], kernel
        if kernel.device not in self._segments:
            self._segments[kernel.device] = (Segments([self.hidden_dim], kernel.device),
                                             Segments(self.widths, kernel.device))
        one, segs = self._segments[kernel.device]
        trunk = [spectral_normalize(k, one) for k, _ in denses]
        # index_select, not sigma[ids]: its backward is index_add_, which is
        # deterministic on the CPU where advanced indexing's is not
        sigma = segment_sigmas(kernel, segs) + 1e-12
        return trunk, kernel / sigma.index_select(0, segs.ids)

    def generate(self, flat: torch.Tensor, clients: slice = slice(None)
                 ) -> tuple[torch.Tensor, torch.Tensor]:
        """Flat target rows ``(c, P)`` (the local update's layout) and
        embeddings ``(c, E)`` of the clients ``clients`` (a slice)."""
        emb, denses, kernel, bias = self.parts(flat)
        kernels, heads = self._kernels(denses, kernel)
        emd = emb[clients]
        f = torch.addmm(denses[0][1], emd, kernels[0])
        for k, (_, b) in zip(kernels[1:], denses[1:]):
            f = torch.addmm(b, F.relu(f), k)
        return torch.addmm(bias, f, heads), emd

    def generate_all(self, flat: torch.Tensor) -> tuple[dict, torch.Tensor]:
        """Every client's parameters as a stacked tree (C, ...) and the
        embeddings (C, E) (the broadcast phase, reference server.py:588-590)."""
        rows, emd = self.generate(flat)
        return self.unravel_target(rows), emd

    def client(self, flat: torch.Tensor, idx: int) -> tuple[dict, torch.Tensor]:
        """Client ``idx``'s parameter tree and embedding."""
        rows, emd = self.generate(flat, slice(idx, idx + 1))
        return self.unravel_target(rows[0]), emd[0]


# (head name, CNNModel leaf path, flax-layout shape), hand-written per
# layer as the reference does (src/Model.py:328-356,389-414)
CNN_HYPER_HEADS: tuple[tuple[str, str, tuple[int, ...]], ...] = tuple(
    head
    for branch in ("vitals", "labs")
    for head in (
        (f"{branch}_conv1_weights", f"{branch}_conv1/kernel", (3, 1, 32)),
        (f"{branch}_conv1_bias", f"{branch}_conv1/bias", (32,)),
        (f"{branch}_conv2_weights", f"{branch}_conv2/kernel", (3, 32, 64)),
        (f"{branch}_conv2_bias", f"{branch}_conv2/bias", (64,)),
        (f"{branch}_conv3_weights", f"{branch}_conv3/kernel", (3, 64, 128)),
        (f"{branch}_conv3_bias", f"{branch}_conv3/bias", (128,)),
    )
) + (
    ("fc1_weights", "fc1/kernel", (128 * 2 * 4, 128)),
    ("fc1_bias", "fc1/bias", (128,)),
    ("fc2_weights", "fc2/kernel", (128, 64)),
    ("fc2_bias", "fc2/bias", (64,)),
    ("fc3_weights", "fc3/kernel", (64, 32)),
    ("fc3_bias", "fc3/bias", (32,)),
    ("output_weights", "output/kernel", (32, 1)),
    ("output_bias", "output/bias", (1,)),
)


class CNNHyper(HyperNetwork):
    """The hypernetwork hand-specialized to CNNModel (JAX ``CNNHyper``,
    hyper.py:196-300; reference src/Model.py:309-416): one named head per
    CNNModel layer.  Raises ValueError for any other target layout."""

    def __init__(self, template: dict, n_nodes: int, **kw):
        expected = {path: shape for _, path, shape in CNN_HYPER_HEADS}
        actual = {path: tuple(leaf.shape) for path, leaf in tree_items(template)}
        if actual != expected:
            diff = {path: (actual.get(path), expected.get(path))
                    for path in sorted(set(actual) | set(expected))
                    if actual.get(path) != expected.get(path)}
            raise ValueError(
                "CNNHyper targets the CNNModel parameter layout only; "
                f"mismatched leaves (got, expected): {diff}")
        super().__init__(template, n_nodes, **kw)

    def head_names(self, template: dict) -> list[str]:
        by_path = {path: name for name, path, _ in CNN_HYPER_HEADS}
        return [by_path[path] for path, _ in tree_items(template)]


HYPER_CLASSES = {"HyperNetwork": HyperNetwork, "CNNHyper": CNNHyper}


def make_hypernetwork(hyper_class: str, template: dict, n_nodes: int, **kw) -> HyperNetwork:
    """The configured class (``hyper_class``) for ``template``'s model."""
    return HYPER_CLASSES[hyper_class](template, n_nodes, **kw)
