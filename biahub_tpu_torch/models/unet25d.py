"""The 2.5D UNet of ``architecture: 2.5D`` (or ``unet25d``).

Counterpart of ``biahub_tpu/models/unet25d.py`` (its module docstring is the
spec) with the state-dict names of the reference's torch twin
(``enc{i}_block{0,1}``, ``bottleneck_block{0,1}``, ``dec{i}_block{0,1}``,
each ``.conv`` and ``.norm``; ``squeeze``, ``head``): blocks of Conv3d 3x3x3
-> channelwise LayerNorm (eps 1e-6) -> ReLU, (1, 2, 2) max-pools,
nearest-neighbour (1, 2, 2) upsampling, a VALID depth squeeze and a 1x1x1
head.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["UNet25D"]


class _ChannelLayerNorm3d(nn.Module):
    """LayerNorm over the channel axis of an NCDHW tensor, eps 1e-6."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.layer_norm(x.permute(0, 2, 3, 4, 1), (x.shape[1],), self.weight, self.bias, 1e-6)
        return x.permute(0, 4, 1, 2, 3)


class _ConvBlock25D(nn.Module):
    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.conv = nn.Conv3d(in_dim, dim, 3, padding=1)
        self.norm = _ChannelLayerNorm3d(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.norm(self.conv(x)))


class UNet25D(nn.Module):
    """(N, C_in, in_stack_depth, H, W) -> (N, C_out, out_stack_depth, H, W);
    H and W divisible by 2 ** (len(num_filters) - 1)."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1, in_stack_depth: int = 5,
                 out_stack_depth: int = 1, num_filters=(24, 48, 96, 192)):
        super().__init__()
        self.in_channels = int(in_channels)
        self.out_channels = int(out_channels)
        self.in_stack_depth = int(in_stack_depth)
        self.out_stack_depth = int(out_stack_depth)
        self.num_filters = tuple(int(f) for f in num_filters)
        prev = self.in_channels
        for i, nf in enumerate(self.num_filters[:-1]):
            self.add_module(f"enc{i}_block0", _ConvBlock25D(prev, nf))
            self.add_module(f"enc{i}_block1", _ConvBlock25D(nf, nf))
            prev = nf
        last = self.num_filters[-1]
        self.bottleneck_block0 = _ConvBlock25D(prev, last)
        self.bottleneck_block1 = _ConvBlock25D(last, last)
        prev = last
        for i in reversed(range(len(self.num_filters) - 1)):
            nf = self.num_filters[i]
            self.add_module(f"dec{i}_block0", _ConvBlock25D(prev + nf, nf))
            self.add_module(f"dec{i}_block1", _ConvBlock25D(nf, nf))
            prev = nf
        kd = self.in_stack_depth - self.out_stack_depth + 1
        self.squeeze = nn.Conv3d(self.num_filters[0], self.num_filters[0], (kd, 1, 1))
        self.head = nn.Conv3d(self.num_filters[0], self.out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, _, d, h, w = x.shape
        if d != self.in_stack_depth:
            raise ValueError(f"depth {d} != in_stack_depth {self.in_stack_depth}")
        down = 2 ** (len(self.num_filters) - 1)
        if h % down or w % down:
            raise ValueError(f"H/W of {tuple(x.shape)} not divisible by {down}")
        levels = len(self.num_filters) - 1
        skips = []
        for i in range(levels):
            x = getattr(self, f"enc{i}_block1")(getattr(self, f"enc{i}_block0")(x))
            skips.append(x)
            x = F.max_pool3d(x, (1, 2, 2))
        x = self.bottleneck_block1(self.bottleneck_block0(x))
        for i in reversed(range(levels)):
            x = F.interpolate(x, scale_factor=(1, 2, 2), mode="nearest")
            x = torch.cat([x, skips[i]], dim=1)
            x = getattr(self, f"dec{i}_block1")(getattr(self, f"dec{i}_block0")(x))
        return self.head(F.relu(self.squeeze(x)))
