"""HAR (human activity recognition) classifier (the port's
``attackfl_tpu/models/har.py``; reference src/Model.py:420-458): a conv
stem with a sinusoidal position encoding, a 2-layer post-norm Transformer
encoder and a mean pool, 6 classes.

Input (B, 561) (or (B, 1, 561), the torch layout); output (B, 6) logits.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from attackfl_tpu_torch.models.icu import T_BRANCH, T_HEAD
from attackfl_tpu_torch.models.layers import (
    Conv, Dense, Model, TorchEncoderLayer, sinusoidal_position_encoding,
)
from attackfl_tpu_torch.registry import register_model

# the head's dropout, fixed whatever dropout_rate says (JAX package har.py:47)
HEAD_RATE = 0.3


@register_model("TransformerClassifier")
class TransformerClassifier(Model):
    """Dropout rates (attention weights, block, head): ``dropout_rate``,
    ``dropout_rate`` and 0.3."""

    # a 561-long sequence's attention is (rows, heads, 561, 561): 128 rows
    # keep one such tensor of an evaluation chunk at 645 MB
    eval_chunk = 128

    def __init__(self, d_model: int = 64, num_heads: int = 4, num_layers: int = 2,
                 num_classes: int = 6, ff_dim: int = 256, dropout_rate: float = 0.1,
                 max_len: int = 600):
        super().__init__()
        self.dropout_rates = (float(dropout_rate), float(dropout_rate), HEAD_RATE)
        self.d_model, self.ff_dim, self.num_layers = d_model, ff_dim, num_layers
        self.conv = Conv(1, d_model, (3,))
        # a constant, not a parameter: the tree has no leaf for it
        self.register_buffer("pe", torch.from_numpy(
            sinusoidal_position_encoding(max_len, d_model)), persistent=False)
        for i in range(num_layers):
            self.add_module(f"encoder{i}", TorchEncoderLayer(d_model, num_heads, ff_dim))
        self.cls_dense1 = Dense((d_model,), (64,))
        self.cls_dense2 = Dense((64,), (num_classes,))

    def mask_specs(self, shapes, rates):
        """Per encoder layer i, ids T_BRANCH + 4 i + (attention weights
        (L, L), attention output (B*L, d), FFN hidden (B*L, ff), FFN output
        (B*L, d)); then the head (B, 64), id T_HEAD."""
        attn, block, head = rates
        batch, length = shapes[0][0], shapes[0][-1]
        tokens = batch * length
        specs = []
        for i in range(self.num_layers):
            tid = T_BRANCH + 4 * i
            specs += [(tid, length, length, attn), (tid + 1, tokens, self.d_model, block),
                      (tid + 2, tokens, self.ff_dim, block), (tid + 3, tokens, self.d_model, block)]
        return specs + [(T_HEAD, batch, 64, head)]

    def forward(self, x: torch.Tensor, masks=None) -> torch.Tensor:
        if x.ndim == 3:                                      # (B, 1, L) torch layout
            x = x[:, 0, :]
        h = self.conv(x[:, None, :]).transpose(1, 2)         # (B, L, d)
        h = h + self.pe[:h.shape[1]].to(h.device)
        for i in range(self.num_layers):
            h = getattr(self, f"encoder{i}")(h, None if masks is None else masks[4 * i:4 * i + 4])
        h = F.relu(self.cls_dense1(torch.mean(h, dim=1)))
        if masks is not None:
            h = h * masks[-1]
        return self.cls_dense2(h)
