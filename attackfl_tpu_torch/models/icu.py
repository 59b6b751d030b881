"""ICU mortality model: the dual-branch TransformerModel (the port's
``attackfl_tpu/models/icu.py:107-146``; reference src/Model.py:194-246).

Per branch: Dense(F -> 64) + GELU, one TransformerBlock (4 heads, ff 6)
over a length-1 sequence, LayerNorm.  Head: 128 -> 64 (GELU, dropout) ->
32 (GELU) -> 1, sigmoid.  Without masks the forward is the evaluation
path (flax ``train=False``); with a dict of pre-drawn dropout masks it is
the training forward of the torch-autograd local update
(``training/local.py``).  The fused kernel (``ops/fused_step.py``) carries
its own forward and dropout.

Parameters travel as plain trees (nested dicts keyed by the flax names,
see ``ops/pytree.py``): ``init`` draws one, ``apply`` runs the forward
with one.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.func import functional_call

from attackfl_tpu_torch.models.layers import Dense, LayerNorm, TransformerBlock, gelu
from attackfl_tpu_torch.ops.pytree import tree_items
from attackfl_tpu_torch.registry import register_model

D = 64


@register_model("TransformerModel")
class TransformerModel(nn.Module):
    def __init__(self, vitals_input_dim: int = 7, labs_input_dim: int = 16,
                 num_heads: int = 4, ff_dim: int = 6, dropout_rate: float = 0.3):
        super().__init__()
        self.dropout_rate = dropout_rate
        for name, dim in (("vitals", vitals_input_dim), ("labs", labs_input_dim)):
            self.add_module(f"{name}_dense", Dense((dim,), (D,)))
            self.add_module(f"{name}_transformer", TransformerBlock(D, num_heads, ff_dim))
            self.add_module(f"{name}_bn", LayerNorm(D))
        self.fc1 = Dense((2 * D,), (D,))
        self.fc2 = Dense((D,), (32,))
        self.output = Dense((32,), (1,))

    def _branch(self, x: torch.Tensor, prefix: str, masks) -> torch.Tensor:
        x = gelu(getattr(self, f"{prefix}_dense")(x))
        x = getattr(self, f"{prefix}_transformer")(
            x, None if masks is None else masks[prefix])
        return getattr(self, f"{prefix}_bn")(x)

    def forward(self, vitals: torch.Tensor, labs: torch.Tensor,
                masks: dict | None = None) -> torch.Tensor:
        """Sigmoid probabilities (B, 1).  ``masks``: None (deterministic),
        or {"vitals": block masks, "labs": block masks, "head": (B, 64)},
        block masks as :class:`TransformerBlock` takes them; the head mask
        is the ``dropout_rate`` dropout after fc1's GELU (JAX package
        icu.py:143-144)."""
        x = torch.cat([self._branch(vitals, "vitals", masks),
                       self._branch(labs, "labs", masks)], dim=1)
        x = gelu(self.fc1(x))
        if masks is not None:
            x = x * masks["head"]
        x = gelu(self.fc2(x))
        return torch.sigmoid(self.output(x))

    @torch.no_grad()
    def init(self, generator: torch.Generator | None = None,
             device: torch.device | str = "cpu") -> dict:
        """A fresh parameter tree with the flax init distributions."""
        for module in self.modules():
            if isinstance(module, (Dense, LayerNorm)):
                module.reset_parameters(generator)
        tree: dict = {}
        for name, param in self.named_parameters():
            *path, leaf = name.split(".")
            node = tree
            for key in path:
                node = node.setdefault(key, {})
            node[leaf] = param.detach().clone().to(device)
        return tree

    def apply(self, params: dict, vitals: torch.Tensor, labs: torch.Tensor,
              masks: dict | None = None) -> torch.Tensor:
        """Forward with the parameters of ``params`` (flax ``apply``);
        ``masks`` as :meth:`forward` takes them."""
        flat = {path.replace("/", "."): leaf for path, leaf in tree_items(params)}
        return functional_call(self, flat, (vitals, labs, masks))
