"""CPnet, cellpose v2's segmentation network.

Counterpart of ``biahub_tpu/models/cpnet.py`` (its module docstring is the
spec) with cellpose's own state-dict names, as the reference's torch twin
has them (``downsample.down.res_down_N.conv.conv_T.{0,2}``,
``upsample.up.res_up_N...``, ``output.{0,2}``), so a cellpose checkpoint
loads as it is. BatchNorm runs on its running statistics (the module is
built in eval mode). ``forward`` takes NCHW and returns the network's
output (dY, dX, cellprob for ``nout`` 3) and the L2-normalised style vector.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["CPnet", "CPNET_NBASE_DEFAULT"]

CPNET_NBASE_DEFAULT = (2, 32, 64, 128, 256)


def _batchconv(cin: int, cout: int, sz: int) -> nn.Sequential:
    """BatchNorm -> ReLU -> Conv (indices 0/1/2)."""
    return nn.Sequential(nn.BatchNorm2d(cin, eps=1e-5), nn.ReLU(inplace=True),
                         nn.Conv2d(cin, cout, sz, padding=sz // 2))


def _batchconv0(cin: int, cout: int, sz: int) -> nn.Sequential:
    """BatchNorm -> Conv (indices 0/1)."""
    return nn.Sequential(nn.BatchNorm2d(cin, eps=1e-5), nn.Conv2d(cin, cout, sz, padding=sz // 2))


class _ResDown(nn.Module):
    def __init__(self, cin: int, cout: int, sz: int):
        super().__init__()
        self.conv = nn.Sequential()
        self.proj = _batchconv0(cin, cout, 1)
        for t in range(4):
            self.conv.add_module(f"conv_{t}", _batchconv(cin if t == 0 else cout, cout, sz))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.proj(x) + self.conv[1](self.conv[0](x))
        return x + self.conv[3](self.conv[2](x))


class _BatchConvStyle(nn.Module):
    """conv(x [+ skip] + Linear(style))."""

    def __init__(self, cin: int, cout: int, style_channels: int, sz: int):
        super().__init__()
        self.conv = _batchconv(cin, cout, sz)
        self.full = nn.Linear(style_channels, cout)

    def forward(self, style: torch.Tensor, x: torch.Tensor,
                y: torch.Tensor | None = None) -> torch.Tensor:
        if y is not None:
            x = x + y
        return self.conv(x + self.full(style)[:, :, None, None])


class _ResUp(nn.Module):
    def __init__(self, cin: int, cout: int, style_channels: int, sz: int):
        super().__init__()
        self.conv = nn.Sequential()
        self.conv.add_module("conv_0", _batchconv(cin, cout, sz))
        for t in range(1, 4):
            self.conv.add_module(f"conv_{t}", _BatchConvStyle(cout, cout, style_channels, sz))
        self.proj = _batchconv0(cin, cout, 1)

    def forward(self, x: torch.Tensor, y: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
        x = self.proj(x) + self.conv[1](style, self.conv[0](x), y=y)
        return x + self.conv[3](style, self.conv[2](style, x))


class _Downsample(nn.Module):
    def __init__(self, nbase, sz: int):
        super().__init__()
        self.down = nn.Sequential()
        for n in range(len(nbase) - 1):
            self.down.add_module(f"res_down_{n}", _ResDown(nbase[n], nbase[n + 1], sz))

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        feats = []
        for n in range(len(self.down)):
            feats.append(self.down[n](F.max_pool2d(feats[-1], 2, 2) if n > 0 else x))
        return feats


class _Upsample(nn.Module):
    def __init__(self, nbaseup, sz: int):
        super().__init__()
        self.up = nn.Sequential()
        for n in range(1, len(nbaseup)):
            self.up.add_module(f"res_up_{n - 1}",
                               _ResUp(nbaseup[n], nbaseup[n - 1], nbaseup[-1], sz))

    def forward(self, style: torch.Tensor, xd: list[torch.Tensor]) -> torch.Tensor:
        x = self.up[-1](xd[-1], xd[-1], style)
        for n in range(len(self.up) - 2, -1, -1):
            x = self.up[n](F.interpolate(x, scale_factor=2, mode="nearest"), xd[n], style)
        return x


class CPnet(nn.Module):
    """Cellpose v2 CPnet: NCHW -> (NCHW output, style); eval mode."""

    def __init__(self, nbase=CPNET_NBASE_DEFAULT, nout: int = 3, sz: int = 3,
                 style_on: bool = True):
        super().__init__()
        nbase = [int(n) for n in nbase]
        nbaseup = nbase[1:] + [nbase[-1]]
        self.nbase, self.nout, self.sz, self.style_on = tuple(nbase), int(nout), int(sz), style_on
        self.downsample = _Downsample(nbase, sz)
        self.upsample = _Upsample(nbaseup, sz)
        self.output = _batchconv(nbaseup[0], nout, 1)
        self.eval()

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        feats = self.downsample(x)
        style = feats[-1].mean(dim=(2, 3))
        style = style / torch.sum(style ** 2, dim=1, keepdim=True) ** 0.5
        y = self.upsample(style if self.style_on else style * 0.0, feats)
        return self.output(y), style
