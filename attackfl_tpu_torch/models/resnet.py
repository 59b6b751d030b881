"""ResNet-18 for CIFAR-10, BASELINE config 5 (the port's
``attackfl_tpu/models/resnet.py``): a CIFAR-style ResNet-18 (3x3 stem, no
max-pool) with bias-free convs and GroupNorm in place of BatchNorm, a
global mean, a linear classifier and log-softmax over 10 classes (the
NLL-based validation contract).  It has no dropout.

Input NHWC (B, 32, 32, 3), as the CIFAR data is stored; an NCHW batch
(channel axis 1 of size 3, last axis not 3) is taken as it is.
Activations are NCHW inside.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from attackfl_tpu_torch.models.layers import Conv, Dense, GroupNorm, Model
from attackfl_tpu_torch.registry import register_model

STEM = 64


class ResidualBlock(nn.Module):
    """conv3x3(stride) -> GN -> ReLU -> conv3x3 -> GN, plus the input, or
    its 1x1 ``proj`` + ``gn_proj`` when the shape changes; ReLU."""

    def __init__(self, in_features: int, features: int, strides: int):
        super().__init__()
        self.conv1 = Conv(in_features, features, (3, 3), strides, use_bias=False)
        self.gn1 = GroupNorm(features)
        self.conv2 = Conv(features, features, (3, 3), use_bias=False)
        self.gn2 = GroupNorm(features)
        if strides != 1 or in_features != features:
            self.proj = Conv(in_features, features, (1, 1), strides, use_bias=False)
            self.gn_proj = GroupNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.gn1(self.conv1(x)))
        y = self.gn2(self.conv2(y))
        residual = self.gn_proj(self.proj(x)) if hasattr(self, "proj") else x
        return F.relu(y + residual)


@register_model("ResNet18")
class ResNet18(Model):
    def __init__(self, num_classes: int = 10, stage_sizes: tuple[int, ...] = (2, 2, 2, 2),
                 stage_features: tuple[int, ...] = (64, 128, 256, 512)):
        super().__init__()
        self.stem = Conv(3, STEM, (3, 3), use_bias=False)
        self.gn_stem = GroupNorm(STEM)
        self.blocks = []
        features_in = STEM
        for stage, (num_blocks, features) in enumerate(zip(stage_sizes, stage_features)):
            for block in range(num_blocks):
                strides = 2 if stage > 0 and block == 0 else 1
                name = f"stage{stage}_block{block}"
                self.add_module(name, ResidualBlock(features_in, features, strides))
                self.blocks.append(name)
                features_in = features
        self.classifier = Dense((features_in,), (num_classes,))

    def forward(self, x: torch.Tensor, masks=None) -> torch.Tensor:
        if not (x.ndim == 4 and x.shape[1] == 3 and x.shape[-1] != 3):
            x = x.permute(0, 3, 1, 2)                        # NHWC -> NCHW
        # a contiguous copy: the CPU backward of this network on a
        # channels-last-strided input crashes (torch 2.13)
        x = x.contiguous()
        x = F.relu(self.gn_stem(self.stem(x)))
        for name in self.blocks:
            x = getattr(self, name)(x)
        x = self.classifier(torch.mean(x, dim=(2, 3)))       # global average pool
        return F.log_softmax(x, dim=-1)
