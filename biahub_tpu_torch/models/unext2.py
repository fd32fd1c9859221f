"""UNeXt2, the virtual-staining network of ``architecture: fcmae``.

Counterpart of ``biahub_tpu/models/unext2.py`` (its module docstring is the
architecture's spec) with the state-dict names of the reference's torch twin
(``biahub_tpu/models/torch_twin.py``: ``stem``, ``stage{i}_block{b}.
{dwconv,norm,pwconv1,grn,pwconv2}``, ``down{i}_{norm,conv}``, ``up{j}_conv``,
``dec{j}_block{b}.{conv,norm}``, ``head``). GELU is exact, both
LayerNorms are channelwise with eps 1e-6, the pixel shuffle is
``torch.nn.functional.pixel_shuffle`` and the stem folds the remaining depth
into channels channel-major.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["UNeXt2"]


class _ChannelLayerNorm(nn.Module):
    """LayerNorm over the channel axis of an NCHW tensor, eps 1e-6."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.layer_norm(x.permute(0, 2, 3, 1), (x.shape[1],), self.weight, self.bias, 1e-6)
        return x.permute(0, 3, 1, 2)


class _GRN(nn.Module):
    """ConvNeXtV2 global response normalization of an NHWC tensor."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(dim))
        self.beta = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gx = torch.sqrt(torch.sum(torch.square(x), dim=(1, 2), keepdim=True))
        nx = gx / (torch.mean(gx, dim=-1, keepdim=True) + 1e-6)
        return self.gamma * (x * nx) + self.beta + x


class _ConvNeXtV2Block(nn.Module):
    """x + pw2(GRN(GELU(pw1(LN(dwconv7x7(x))))))."""

    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.grn = _GRN(4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.dwconv(x).permute(0, 2, 3, 1)
        y = self.pwconv2(self.grn(F.gelu(self.pwconv1(self.norm(y)))))
        return x + y.permute(0, 3, 1, 2)


class _DecoderBlock(nn.Module):
    """3x3 conv -> channelwise LayerNorm -> GELU."""

    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.conv = nn.Conv2d(in_dim, dim, 3, padding=1)
        self.norm = _ChannelLayerNorm(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(self.norm(self.conv(x)))


class UNeXt2(nn.Module):
    """(N, C_in, D, H, W) float32 -> (N, C_out, z_out, H, W); D must be
    ``in_stack_depth`` and D, H, W divisible by ``stem_kernel_size``, and H,
    W by the stem's times 8 (the encoder's three halvings)."""

    def __init__(self, in_channels: int = 1, out_channels: int = 2, in_stack_depth: int = 15,
                 out_stack_depth: int | None = None, encoder_blocks=(3, 3, 9, 3),
                 dims=(96, 192, 384, 768), decoder_conv_blocks: int = 2,
                 stem_kernel_size=(5, 4, 4)):
        super().__init__()
        kd, kh, kw = (int(k) for k in stem_kernel_size)
        self.in_channels = int(in_channels)
        self.out_channels = int(out_channels)
        self.in_stack_depth = int(in_stack_depth)
        self.z_out = int(out_stack_depth or in_stack_depth)
        self.encoder_blocks = tuple(int(b) for b in encoder_blocks)
        self.dims = tuple(int(d) for d in dims)
        self.decoder_conv_blocks = int(decoder_conv_blocks)
        self.stem_kernel_size = (kd, kh, kw)
        self.stem = nn.Conv3d(in_channels, self.dims[0] // (self.in_stack_depth // kd),
                              (kd, kh, kw), stride=(kd, kh, kw))
        for i, (depth, dim) in enumerate(zip(self.encoder_blocks, self.dims)):
            if i > 0:
                self.add_module(f"down{i}_norm", _ChannelLayerNorm(self.dims[i - 1]))
                self.add_module(f"down{i}_conv", nn.Conv2d(self.dims[i - 1], dim, 2, 2))
            for b in range(depth):
                self.add_module(f"stage{i}_block{b}", _ConvNeXtV2Block(dim))
        for j in range(3):
            dim = self.dims[2 - j]
            self.add_module(f"up{j}_conv", nn.Conv2d(self.dims[3 - j], 4 * dim, 3, padding=1))
            for b in range(self.decoder_conv_blocks):
                self.add_module(f"dec{j}_block{b}", _DecoderBlock(2 * dim if b == 0 else dim,
                                                                  dim))
        self.head = nn.Conv2d(self.dims[0], self.out_channels * self.z_out * kh * kw, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kd, kh, kw = self.stem_kernel_size
        n, _, d, h, w = x.shape
        if d % kd or h % kh or w % kw:
            raise ValueError(
                f"input {tuple(x.shape)} not divisible by stem kernel {self.stem_kernel_size}")
        x = self.stem(x)
        n, c, d, h, w = x.shape
        x = x.reshape(n, c * d, h, w)
        skips = []
        for i, depth in enumerate(self.encoder_blocks):
            if i > 0:
                x = getattr(self, f"down{i}_conv")(getattr(self, f"down{i}_norm")(x))
            for b in range(depth):
                x = getattr(self, f"stage{i}_block{b}")(x)
            skips.append(x)
        for j in range(3):
            x = F.pixel_shuffle(getattr(self, f"up{j}_conv")(x), 2)
            x = torch.cat([x, skips[2 - j]], dim=1)
            for b in range(self.decoder_conv_blocks):
                x = getattr(self, f"dec{j}_block{b}")(x)
        x = F.pixel_shuffle(self.head(x), kh)
        n, _, hh, ww = x.shape
        return x.reshape(n, self.out_channels, self.z_out, hh, ww)
