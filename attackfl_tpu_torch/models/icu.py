"""ICU mortality models: the dual-branch (vitals 7-dim, labs 16-dim)
CNNModel, RNNModel and TransformerModel (the port's
``attackfl_tpu/models/icu.py``; reference src/Model.py:27-246).  Each
takes ``(vitals (B, 7), labs (B, 16))`` and returns sigmoid probabilities
(B, 1).

Without masks the forward is the evaluation path (flax ``train=False``);
with the list of masks that ``mask_specs`` states it is the training
forward of the torch-autograd local update (``training/local.py``).  The
fused kernel (``ops/fused_step.py``) carries TransformerModel's forward
and dropout itself.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from attackfl_tpu_torch.models.layers import (
    BiGRUStack, Conv, Dense, LayerNorm, Model, TransformerBlock, adaptive_avg_pool1d, dropped,
    gelu,
)
from attackfl_tpu_torch.registry import register_model

D = 64
BRANCHES = ("vitals", "labs")
# mask tensor ids of TransformerModel: per branch b, T_BRANCH + 4 * b +
# (attention, attention output, FFN hidden, FFN output); then the head.
# The fused kernel uses 0-8.
T_BRANCH, T_HEAD = 16, 24


def branch_head_specs(shapes, rate: float, width: int) -> list[tuple[int, int, int, float]]:
    """One ``(B, width)`` mask per branch at ``rate``, ids T_BRANCH and
    T_BRANCH + 1 (CNNModel's and RNNModel's dropout)."""
    rows = shapes[0][0]
    return [(T_BRANCH + b, rows, width, rate) for b in range(len(BRANCHES))]


@register_model("CNNModel")
class CNNModel(Model):
    """Dual-branch 1-D CNN (JAX package icu.py:18-49).  Per branch: the
    features as a 1-channel signal, 3x Conv1d(k=3, SAME) 32 -> 64 -> 128
    with ReLU, adaptive average pool to 4 positions, a position-major
    flatten to 512 (flax's NLC (B, 4, 128)), dropout.  Head: 1024 -> 128 ->
    64 -> 32 -> 1, ReLU, sigmoid."""

    def __init__(self, dropout_rate: float = 0.3):
        super().__init__()
        self.dropout_rates = (float(dropout_rate),)
        for name in BRANCHES:
            for i, (cin, cout) in enumerate(((1, 32), (32, 64), (64, 128)), 1):
                self.add_module(f"{name}_conv{i}", Conv(cin, cout, (3,)))
        self.fc1 = Dense((1024,), (128,))
        self.fc2 = Dense((128,), (64,))
        self.fc3 = Dense((64,), (32,))
        self.output = Dense((32,), (1,))

    def mask_specs(self, shapes, rates):
        return branch_head_specs(shapes, rates[0], 512)

    def _branch(self, x: torch.Tensor, prefix: str) -> torch.Tensor:
        x = x[:, None, :]                                    # (B, 1, L): NCL
        for i in (1, 2, 3):
            x = F.relu(getattr(self, f"{prefix}_conv{i}")(x))
        x = adaptive_avg_pool1d(x, 4)                        # (B, 128, 4)
        return x.transpose(1, 2).reshape(x.shape[0], -1)     # position-major (B, 512)

    def forward(self, vitals: torch.Tensor, labs: torch.Tensor, masks=None) -> torch.Tensor:
        parts = [self._branch(x, name) for x, name in zip((vitals, labs), BRANCHES)]
        if masks is not None:
            parts = [dropped(p, m) for p, m in zip(parts, masks)]
        x = F.relu(self.fc1(torch.cat(parts, dim=1)))
        x = F.relu(self.fc2(x))
        x = F.relu(self.fc3(x))
        return torch.sigmoid(self.output(x))


@register_model("RNNModel")
class RNNModel(Model):
    """Dual-branch 3-layer bidirectional GRU (JAX package icu.py:52-104).
    Per branch: inputs equal to the mask value -2.0 are zeroed, 2-D inputs
    become sequences of length 1, the last timestep is LayerNorm'd and
    dropped out.  Head: 4h -> h -> h/2 -> 1, ReLU, sigmoid."""

    def __init__(self, vitals_input_dim: int = 7, labs_input_dim: int = 16,
                 hidden_dim: int = 32, dropout_rate: float = 0.3, mask_value: float = -2.0):
        super().__init__()
        self.dropout_rates = (float(dropout_rate),)
        self.hidden_dim, self.mask_value = hidden_dim, mask_value
        for name, dim in zip(BRANCHES, (vitals_input_dim, labs_input_dim)):
            self.add_module(f"{name}_gru", BiGRUStack(dim, hidden_dim))
            self.add_module(f"{name}_ln", LayerNorm(2 * hidden_dim))
        self.fc1 = Dense((4 * hidden_dim,), (hidden_dim,))
        self.fc2 = Dense((hidden_dim,), (hidden_dim // 2,))
        self.output = Dense((hidden_dim // 2,), (1,))

    def mask_specs(self, shapes, rates):
        return branch_head_specs(shapes, rates[0], 2 * self.hidden_dim)

    def _branch(self, x: torch.Tensor, prefix: str) -> torch.Tensor:
        x = torch.where(x == self.mask_value, torch.zeros_like(x), x)
        if x.ndim == 2:
            x = x[:, None, :]                                # (B, 1, F)
        x = getattr(self, f"{prefix}_gru")(x)[:, -1]         # last timestep (B, 2h)
        return getattr(self, f"{prefix}_ln")(x)

    def forward(self, vitals: torch.Tensor, labs: torch.Tensor, masks=None) -> torch.Tensor:
        parts = [self._branch(x, name) for x, name in zip((vitals, labs), BRANCHES)]
        if masks is not None:
            parts = [dropped(p, m) for p, m in zip(parts, masks)]
        x = F.relu(self.fc1(torch.cat(parts, dim=1)))
        x = F.relu(self.fc2(x))
        return torch.sigmoid(self.output(x))


@register_model("TransformerModel")
class TransformerModel(Model):
    """Dual-branch single-block Transformer (JAX package icu.py:107-146;
    the config.yaml default model).  Per branch: Dense(F -> 64) + GELU,
    one TransformerBlock (4 heads, ff 6) over a length-1 sequence,
    LayerNorm.  Head: 128 -> 64 (GELU, dropout) -> 32 (GELU) -> 1,
    sigmoid.  Dropout rates (attention, block, head): 0.1, 0.1 and
    ``dropout_rate``."""

    def __init__(self, vitals_input_dim: int = 7, labs_input_dim: int = 16,
                 num_heads: int = 4, ff_dim: int = 6, dropout_rate: float = 0.3):
        super().__init__()
        self.dropout_rates = (0.1, 0.1, float(dropout_rate))
        for name, dim in zip(BRANCHES, (vitals_input_dim, labs_input_dim)):
            self.add_module(f"{name}_dense", Dense((dim,), (D,)))
            self.add_module(f"{name}_transformer", TransformerBlock(D, num_heads, ff_dim))
            self.add_module(f"{name}_bn", LayerNorm(D))
        self.fc1 = Dense((2 * D,), (D,))
        self.fc2 = Dense((D,), (32,))
        self.output = Dense((32,), (1,))

    def mask_specs(self, shapes, rates):
        """Per branch (attention (B, heads), attention output (B, 64), FFN
        hidden (B, ff), FFN output (B, 64)), then the head (B, 64), at
        rates (attention, block, head)."""
        attn, block, head = rates
        rows = shapes[0][0]
        heads = self.vitals_transformer.attention.value.kernel.shape[1]
        ff = self.vitals_transformer.ffn_dense1.kernel.shape[1]
        width = self.fc1.kernel.shape[1]
        specs = []
        for b in range(len(BRANCHES)):
            tid = T_BRANCH + 4 * b
            specs += [(tid, rows, heads, attn), (tid + 1, rows, width, block),
                      (tid + 2, rows, ff, block), (tid + 3, rows, width, block)]
        return specs + [(T_HEAD, rows, width, head)]

    def _branch(self, x: torch.Tensor, prefix: str, masks) -> torch.Tensor:
        x = gelu(getattr(self, f"{prefix}_dense")(x))
        x = getattr(self, f"{prefix}_transformer")(x, masks)
        return getattr(self, f"{prefix}_bn")(x)

    def forward(self, vitals: torch.Tensor, labs: torch.Tensor, masks=None) -> torch.Tensor:
        """Block masks as :class:`TransformerBlock` takes them, four per
        branch; the head mask is the ``dropout_rate`` dropout after fc1's
        GELU (JAX package icu.py:143-144)."""
        block = [None, None] if masks is None else [masks[0:4], masks[4:8]]
        x = torch.cat([self._branch(vitals, "vitals", block[0]),
                       self._branch(labs, "labs", block[1])], dim=1)
        x = gelu(self.fc1(x))
        if masks is not None:
            x = dropped(x, masks[8])
        x = gelu(self.fc2(x))
        return torch.sigmoid(self.output(x))
