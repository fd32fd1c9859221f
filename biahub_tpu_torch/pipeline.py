"""The headline deconvolve -> deskew step as a module that holds its state.

What ``biahub_tpu/fuse.py:540-600`` and bench.py's headline set up around
``kernels/chain.py::deconvolve_then_deskew_batched``: the prepared Tikhonov
filter, hoisted once per acquisition, and the deskew geometry.
"""

from __future__ import annotations

import torch
from torch import nn

from biahub_tpu_torch.device import resolve_device
from biahub_tpu_torch.kernels.chain import run_chain
from biahub_tpu_torch.kernels.deconvolve import volume_tensor
from biahub_tpu_torch.kernels.deskew import deskew_geometry
from biahub_tpu_torch.kernels.fft import prepare_fourier_filter

__all__ = ["DeconvolveDeskew"]


class DeconvolveDeskew(nn.Module):
    """``forward(volumes)``: (B, Z, Y, X) uint16 or float32 -> (B, groups,
    Y_out, X_out) float32, deconvolved then deskewed.

    The prepared filter ``tf / (tf^2 + reg)`` is the buffer ``filter`` (so
    ``.to(device)`` moves it); the deskew geometry is the attribute
    ``geometry``. Volumes must have the ``zyx_shape`` the module was built
    for.
    """

    def __init__(
        self,
        transfer_function_half,
        zyx_shape: tuple[int, int, int],
        regularization_strength: float,
        ls_angle_deg: float,
        px_to_scan_ratio: float,
        keep_overhang: bool = False,
        average_window: int = 1,
        overhang_fill: str | float = 0,
        skip_flip: bool = False,
        device: str | torch.device = "cuda",
    ):
        super().__init__()
        dev = resolve_device(device)
        self.geometry = deskew_geometry(
            zyx_shape, ls_angle_deg, px_to_scan_ratio, keep_overhang,
            average_window, overhang_fill, skip_flip,
        )
        self.register_buffer("filter", prepare_fourier_filter(
            zyx_shape, transfer_function_half, regularization_strength, dev
        ))

    def forward(self, volumes) -> torch.Tensor:
        data = volume_tensor(volumes, self.filter.device)
        if tuple(data.shape[1:]) != self.geometry.zyx_shape or data.ndim != 4:
            raise ValueError(f"DeconvolveDeskew: built for (B,) + "
                             f"{self.geometry.zyx_shape}, got {tuple(data.shape)}")
        return run_chain(data, self.filter, self.geometry)
