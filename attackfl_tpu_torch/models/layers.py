"""Building blocks of the ICU TransformerModel (the port's
``attackfl_tpu/models/layers.py:52-161``).

Parameters carry the flax names and the flax layout: a dense ``kernel`` is
(in, out), attention's ``value.kernel`` is (D, H, dh) and ``out.kernel``
(H, dh, D), LayerNorm has ``scale`` and ``bias``.  The numerics are
flax's, not torch's defaults: LayerNorm eps 1e-6 and tanh-approximate
GELU.  Initialization draws the flax distributions (lecun-normal kernels,
zero biases, LayerNorm ones and zeros) from an explicit generator.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-6
# flax's truncated-normal variance correction for truncation at +-2 std
_TRUNC_STD = 0.87962566103423978


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def lecun_normal_(kernel: torch.Tensor, fan_in: int,
                  generator: torch.Generator | None) -> None:
    """flax ``lecun_normal``: truncated normal at +-2 std, variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(kernel, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


class Dense(nn.Module):
    """``kernel`` of shape ``in_shape + out_shape``; the product contracts
    ``len(in_shape)`` leading kernel axes (flax Dense / DenseGeneral)."""

    def __init__(self, in_shape: tuple[int, ...], out_shape: tuple[int, ...]):
        super().__init__()
        self.n_in = len(in_shape)
        self.fan_in = math.prod(in_shape)
        self.kernel = nn.Parameter(torch.empty(in_shape + out_shape))
        self.bias = nn.Parameter(torch.zeros(out_shape))

    def reset_parameters(self, generator: torch.Generator | None) -> None:
        lecun_normal_(self.kernel, self.fan_in, generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tensordot(x, self.kernel, dims=self.n_in) + self.bias


class LayerNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def reset_parameters(self, generator: torch.Generator | None) -> None:
        nn.init.ones_(self.scale)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.scale.shape, self.scale, self.bias, LN_EPS)


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
            value = value * head_mask.unsqueeze(-1)
        return self.out(value)


class TransformerBlock(nn.Module):
    """x = LN(x + Drop(MHA(x))); x = LN(x + Drop(FFN(x))), FFN = Dense(ff)
    -> GELU -> Drop -> Dense(dim) (reference src/Model.py:166-191).

    Dropout takes pre-drawn inverted-dropout masks (values 0 or
    1/(1 - rate)): ``masks`` = (attention (B, H), attention output (B, D),
    FFN hidden (B, ff), FFN output (B, D)), the places of the JAX package's
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
        x = self.attention_norm(x + self.attention(x, m_head) * m_attn)
        y = self.ffn_dense2(gelu(self.ffn_dense1(x)) * m_ffn)
        return self.ffn_norm(x + y * m_out)
