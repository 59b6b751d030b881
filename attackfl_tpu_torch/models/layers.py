"""Building blocks of the model zoo (the port's
``attackfl_tpu/models/layers.py``, with flax's Conv, GroupNorm, GRUCell and
MultiHeadDotProductAttention).

Parameters carry the flax names and the flax layout: a dense ``kernel`` is
(in, out), a conv ``kernel`` (k..., in, out), attention's ``value.kernel``
is (D, H, dh) and ``out.kernel`` (H, dh, D), LayerNorm and GroupNorm have
``scale`` and ``bias``.  The numerics are flax's, not torch's defaults:
LayerNorm and GroupNorm eps 1e-6, tanh-approximate GELU, "SAME" padding as
flax computes it.  Initialization draws the flax distributions
(lecun-normal kernels with fan-in ``prod(kernel) * in``, orthogonal GRU
recurrent kernels, zero biases, norm ones and zeros) from an explicit
generator.

Activations inside a model are channel-first, as torch's convolutions
take them; a conv permutes its flax-layout kernel in ``forward``.

Mixed dtypes promote as flax's ``promote_dtype`` does: Dense and
LayerNorm compute in the promoted type of their input and parameters
(bfloat16 with float32 is float32), so a model fed bfloat16 parameters and
a float32 constant or carry leaves bfloat16 where the JAX model does (the
convolutions and GroupNorm only ever see one dtype).  Normalization
statistics are float32 inside ``F.layer_norm`` and ``F.group_norm``, as in
flax, and a dropout mask multiplies in its activation's dtype
(:func:`dropped`).  With every operand of one dtype nothing is cast.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from attackfl_tpu_torch.ops.pytree import tree_items

LN_EPS = 1e-6
# flax's truncated-normal variance correction for truncation at +-2 std
_TRUNC_STD = 0.87962566103423978


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def promoted_dtype(*xs: torch.Tensor) -> torch.dtype:
    """The promoted dtype of ``xs`` (flax ``promote_dtype``'s)."""
    dtype = xs[0].dtype
    for x in xs[1:]:
        dtype = torch.promote_types(dtype, x.dtype)
    return dtype


def promoted(*xs: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """``xs`` cast to their promoted dtype; the tensors themselves when
    they share one."""
    dtype = promoted_dtype(*xs)
    return tuple(x.to(dtype) for x in xs)


def dropped(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Inverted dropout by a pre-drawn mask (values 0 or 1/(1 - rate)),
    in ``x``'s dtype as flax's ``Dropout`` computes it."""
    return x * mask.to(x.dtype)


def lecun_normal_(kernel: torch.Tensor, fan_in: int,
                  generator: torch.Generator | None) -> None:
    """flax ``lecun_normal``: truncated normal at +-2 std, variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(kernel, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


class Dense(nn.Module):
    """``kernel`` of shape ``in_shape + out_shape``; the product contracts
    ``len(in_shape)`` leading kernel axes (flax Dense / DenseGeneral).
    ``orthogonal`` draws the kernel as flax's ``orthogonal()`` does (the
    GRU's recurrent kernels); ``use_bias=False`` leaves out the bias."""

    def __init__(self, in_shape: tuple[int, ...], out_shape: tuple[int, ...],
                 use_bias: bool = True, orthogonal: bool = False):
        super().__init__()
        self.n_in = len(in_shape)
        self.fan_in = math.prod(in_shape)
        self.orthogonal = orthogonal
        self.kernel = nn.Parameter(torch.empty(in_shape + out_shape))
        self.bias = nn.Parameter(torch.zeros(out_shape)) if use_bias else None

    def reset_parameters(self, generator: torch.Generator | None) -> None:
        if self.orthogonal:
            nn.init.orthogonal_(self.kernel, generator=generator)
        else:
            lecun_normal_(self.kernel, self.fan_in, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.widened(x, None)

    def widened(self, x: torch.Tensor, dtype: torch.dtype | None) -> torch.Tensor:
        """The product in the promoted dtype of ``x`` and the kernel,
        widened to ``dtype`` (None: kept) before the bias is added.  A
        flax Dense whose output only feeds a float32 sum compiles so under
        XLA: the bfloat16 product is rounded once and its bias added in
        float32, the biased value never rounded to bfloat16 (the GRU's
        input gates, :class:`GRUCell`)."""
        x, kernel = promoted(x, self.kernel)
        y = torch.tensordot(x, kernel, dims=self.n_in)
        if dtype is not None:
            y = y.to(dtype)
        return y if self.bias is None else y + self.bias.to(y.dtype)


class LayerNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def reset_parameters(self, generator: torch.Generator | None) -> None:
        nn.init.ones_(self.scale)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, scale, bias = promoted(x, self.scale, self.bias)
        return F.layer_norm(x, scale.shape, scale, bias, LN_EPS)


class GroupNorm(LayerNorm):
    """flax ``nn.GroupNorm`` with ``num_groups = min(32, features)``, eps
    1e-6, over channel-first activations."""

    def __init__(self, features: int):
        super().__init__(features)
        self.groups = min(32, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x, self.groups, self.scale, self.bias, LN_EPS)


def same_pads(sizes, kernel, stride: int) -> list[tuple[int, int]]:
    """flax's "SAME" padding per spatial axis: the output has ceil(n /
    stride) positions and the low side gets the smaller half of the total
    pad, so a 3-wide kernel at stride 2 on an even length pads (0, 1)."""
    pads = []
    for n, k in zip(sizes, kernel):
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


class Conv(nn.Module):
    """flax ``nn.Conv`` with "SAME" padding on channel-first activations
    ``(B, in, *spatial)``.  The parameter is the flax kernel ``(k..., in,
    out)``, permuted to torch's ``(out, in, k...)`` in ``forward``; uneven
    pads are applied with ``F.pad`` before a conv without padding."""

    def __init__(self, in_features: int, features: int, kernel_size: tuple[int, ...],
                 stride: int = 1, use_bias: bool = True):
        super().__init__()
        self.kernel_size, self.stride = tuple(kernel_size), stride
        self.kernel = nn.Parameter(torch.empty(self.kernel_size + (in_features, features)))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def reset_parameters(self, generator: torch.Generator | None) -> None:
        lecun_normal_(self.kernel, math.prod(self.kernel.shape[:-1]), generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        nd = len(self.kernel_size)
        weight = self.kernel.permute(nd + 1, nd, *range(nd))
        pads = same_pads(x.shape[2:], self.kernel_size, self.stride)
        conv = F.conv1d if nd == 1 else F.conv2d
        if all(lo == hi for lo, hi in pads):
            return conv(x, weight, self.bias, stride=self.stride,
                        padding=tuple(lo for lo, _ in pads))
        # F.pad lists the last axis first
        x = F.pad(x, [p for pair in reversed(pads) for p in pair])
        return conv(x, weight, self.bias, stride=self.stride)


PARAM_LAYERS = (Dense, LayerNorm, Conv)


def adaptive_avg_pool1d(x: torch.Tensor, output_size: int) -> torch.Tensor:
    """PyTorch-style adaptive average pool over the last axis of (B, C, L):
    bin i averages positions floor(i L / out) to ceil((i + 1) L / out), so
    bins overlap when out does not divide L (JAX package layers.py:16-29)."""
    length = x.shape[-1]
    bins = []
    for i in range(output_size):
        start = (i * length) // output_size
        end = -(-((i + 1) * length) // output_size)
        bins.append(torch.mean(x[..., start:end], dim=-1))
    return torch.stack(bins, dim=-1)


def sinusoidal_position_encoding(max_len: int, d_model: int) -> np.ndarray:
    """Classic sin/cos table (JAX package layers.py:197-204)."""
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    pos = np.arange(max_len, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float32) * (-np.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe


class Model(nn.Module):
    """A model of the zoo.  Parameters travel as plain trees (nested dicts
    keyed by the flax names, see ``ops/pytree.py``): ``init`` draws one,
    ``apply`` runs the forward with one.

    Dropout takes pre-drawn inverted-dropout masks (values 0 or
    1/(1 - rate)), one tensor per place: ``mask_specs`` states them for
    one client's minibatch as ``(tensor_id, rows, width, rate)``, and
    ``forward(..., masks)`` takes the list in that order, each tensor of
    shape (rows, width); without masks the forward is the evaluation path
    (flax ``train=False``).  ``dropout_rates`` are the model's own rates,
    in the order ``mask_specs`` reads them."""

    dropout_rates: tuple[float, ...] = ()
    # rows of one evaluation chunk (bounds the activations' memory)
    eval_chunk = 4096

    def mask_specs(self, shapes, rates) -> list[tuple[int, int, int, float]]:
        """The mask tensors of one client's minibatch whose inputs have
        ``shapes`` (each led by the batch size), at ``rates``."""
        return []

    @torch.no_grad()
    def init(self, generator: torch.Generator | None = None,
             device: torch.device | str = "cpu") -> dict:
        """A fresh parameter tree with the flax init distributions."""
        for module in self.modules():
            if isinstance(module, PARAM_LAYERS):
                module.reset_parameters(generator)
        tree: dict = {}
        for name, param in self.named_parameters():
            *path, leaf = name.split(".")
            node = tree
            for key in path:
                node = node.setdefault(key, {})
            node[leaf] = param.detach().clone().to(device)
        return tree

    def apply(self, params: dict, *inputs: torch.Tensor, masks=None) -> torch.Tensor:
        """Forward with the parameters of ``params`` (flax ``apply``)."""
        flat = {path.replace("/", "."): leaf for path, leaf in tree_items(params)}
        return functional_call(self, flat, inputs, {"masks": masks})


class Seq1Attention(nn.Module):
    """Multi-head self-attention over a sequence of length 1, exactly.

    With one key the softmax is the constant 1, so the output is
    ``out(value(x))`` and the query/key projections get exactly zero
    gradient.  They are kept in the tree, inert, so flattening matches the
    JAX package's tree leaf for leaf.  Inputs are (B, D): the length-1
    sequence axis is implicit."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        head_dim = dim // num_heads
        self.query = Dense((dim,), (num_heads, head_dim))
        self.key = Dense((dim,), (num_heads, head_dim))
        self.value = Dense((dim,), (num_heads, head_dim))
        self.out = Dense((num_heads, head_dim), (dim,))

    def forward(self, x: torch.Tensor, head_mask: torch.Tensor | None = None) -> torch.Tensor:
        """``head_mask`` (B, H): attention-weight dropout, which over the
        (B, H, 1, 1) weights of a length-1 sequence is one scaled Bernoulli
        scalar per (batch, head) on the value (JAX package layers.py:97-104)."""
        value = self.value(x)                              # (B, H, dh)
        if head_mask is not None:
            value = dropped(value, head_mask.unsqueeze(-1))
        return self.out(value)


class TransformerBlock(nn.Module):
    """x = LN(x + Drop(MHA(x))); x = LN(x + Drop(FFN(x))), FFN = Dense(ff)
    -> GELU -> Drop -> Dense(dim) (reference src/Model.py:166-191).

    ``masks`` = (attention (B, H), attention output (B, D), FFN hidden
    (B, ff), FFN output (B, D)), the places of the JAX package's
    layers.py:134-160; ``None`` is the deterministic forward."""

    def __init__(self, dim: int, num_heads: int, ff_dim: int):
        super().__init__()
        self.attention = Seq1Attention(dim, num_heads)
        self.attention_norm = LayerNorm(dim)
        self.ffn_dense1 = Dense((dim,), (ff_dim,))
        self.ffn_dense2 = Dense((ff_dim,), (dim,))
        self.ffn_norm = LayerNorm(dim)

    def forward(self, x: torch.Tensor, masks=None) -> torch.Tensor:
        if masks is None:
            x = self.attention_norm(x + self.attention(x))
            y = self.ffn_dense2(gelu(self.ffn_dense1(x)))
            return self.ffn_norm(x + y)
        m_head, m_attn, m_ffn, m_out = masks
        x = self.attention_norm(x + dropped(self.attention(x, m_head), m_attn))
        y = self.ffn_dense2(dropped(gelu(self.ffn_dense1(x)), m_ffn))
        return self.ffn_norm(x + dropped(y, m_out))


class MultiHeadAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` (self-attention) on (B, L, D):
    q/k/v kernels (D, H, dh), out (H, dh, D); the query is divided by
    sqrt(dh), the softmax is float32, and attention-weight dropout is one
    (L, L) mask shared by batch and heads (flax's broadcast dropout,
    ``dropout_shape`` (1, 1, q, k)), applied after the softmax."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.head_dim = dim // num_heads
        self.query = Dense((dim,), (num_heads, self.head_dim))
        self.key = Dense((dim,), (num_heads, self.head_dim))
        self.value = Dense((dim,), (num_heads, self.head_dim))
        self.out = Dense((num_heads, self.head_dim), (dim,))

    def forward(self, x: torch.Tensor, weight_mask: torch.Tensor | None = None) -> torch.Tensor:
        q = self.query(x) / math.sqrt(self.head_dim)                  # (B, L, H, dh)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, self.key(x))
        weights = torch.softmax(logits, dim=-1)
        if weight_mask is not None:
            weights = dropped(weights, weight_mask)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", weights, self.value(x)))


class TorchEncoderLayer(nn.Module):
    """Post-norm encoder layer with a ReLU FFN (JAX package
    layers.py:164-194, torch ``TransformerEncoderLayer``'s defaults).
    ``masks`` = (attention weights (L, L), attention output (B*L, D), FFN
    hidden (B*L, ff), FFN output (B*L, D)), or None."""

    def __init__(self, dim: int, num_heads: int, ff_dim: int):
        super().__init__()
        self.self_attn = MultiHeadAttention(dim, num_heads)
        self.norm1 = LayerNorm(dim)
        self.linear1 = Dense((dim,), (ff_dim,))
        self.linear2 = Dense((ff_dim,), (dim,))
        self.norm2 = LayerNorm(dim)

    def forward(self, x: torch.Tensor, masks=None) -> torch.Tensor:
        if masks is None:
            x = self.norm1(x + self.self_attn(x))
            return self.norm2(x + self.linear2(F.relu(self.linear1(x))))
        m_weights, m_attn, m_ffn, m_out = masks
        tokens = x.shape[:2] + (-1,)
        x = self.norm1(x + dropped(self.self_attn(x, m_weights), m_attn.reshape(tokens)))
        y = self.linear2(dropped(F.relu(self.linear1(x)), m_ffn.reshape(tokens)))
        return self.norm2(x + dropped(y, m_out.reshape(tokens)))


class GRUCell(nn.Module):
    """flax ``nn.GRUCell``: r = sigmoid(ir(x) + hr(h)), z = sigmoid(iz(x) +
    hz(h)), n = tanh(in(x) + r * hn(h)), h' = (1 - z) n + z h.  ``ir``,
    ``iz``, ``in`` and ``hn`` have biases, ``hr`` and ``hz`` none; the
    recurrent kernels are drawn orthogonal.  With bfloat16 inputs and a
    float32 carry the input gates' biases are added in float32, as the
    JAX package's compiled cell adds them (:meth:`Dense.widened`)."""

    def __init__(self, in_features: int, hidden: int):
        super().__init__()
        for gate in ("ir", "iz", "in"):
            self.add_module(gate, Dense((in_features,), (hidden,)))
        for gate in ("hr", "hz"):
            self.add_module(gate, Dense((hidden,), (hidden,), use_bias=False, orthogonal=True))
        self.hn = Dense((hidden,), (hidden,), orthogonal=True)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        dtype = promoted_dtype(x, self.ir.kernel, h)
        r = torch.sigmoid(self.ir.widened(x, dtype) + self.hr(h))
        z = torch.sigmoid(self.iz.widened(x, dtype) + self.hz(h))
        n = torch.tanh(getattr(self, "in").widened(x, dtype) + r * self.hn(h))
        return (1.0 - z) * n + z * h


class BiGRUStack(nn.Module):
    """Stacked bidirectional GRUs (JAX package icu.py:52-66): layer k's
    forward cell is ``GRUCell_{2k}`` and its backward cell
    ``GRUCell_{2k+1}`` (flax names cells in the order they are built); the
    carry starts at zero, the backward outputs keep the input's time order
    and each layer outputs [forward, backward] on the feature axis."""

    def __init__(self, in_features: int, hidden: int, layers: int = 3):
        super().__init__()
        self.hidden, self.layers = hidden, layers
        for k in range(2 * layers):
            self.add_module(f"GRUCell_{k}",
                            GRUCell(in_features if k < 2 else 2 * hidden, hidden))

    def _carry(self, x: torch.Tensor) -> torch.Tensor:
        """The zero carry, at least float32: flax's starts in the
        parameter dtype (GRUCell ``initialize_carry``), so with bfloat16
        inputs the recurrent path promotes to float32."""
        dtype = torch.promote_types(x.dtype, torch.float32)
        return x.new_zeros(x.shape[:1] + (self.hidden,), dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, F) -> (B, T, 2 * hidden)."""
        steps = x.shape[1]
        for k in range(self.layers):
            fwd, bwd = getattr(self, f"GRUCell_{2 * k}"), getattr(self, f"GRUCell_{2 * k + 1}")
            h = self._carry(x)
            outs_f = []
            for t in range(steps):
                h = fwd(h, x[:, t])
                outs_f.append(h)
            h = self._carry(x)
            outs_b = [None] * steps
            for t in reversed(range(steps)):
                h = bwd(h, x[:, t])
                outs_b[t] = h
            x = torch.cat([torch.stack(outs_f, 1), torch.stack(outs_b, 1)], dim=-1)
        return x
