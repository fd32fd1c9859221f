"""In-focus slice detection from transverse mid-band spectral power.

Counterpart of ``biahub_tpu/kernels/focus.py``: the in-focus z-slice
maximizes the log power of the transverse spatial-frequency band between
``midband_fractions`` of the detection cutoff (fc = 2 NA / lambda). The
reference computes it with an XLA 2D rfft; here it is ``torch.fft`` on the
input's device, batched over (T, Z).
"""

from __future__ import annotations

import numpy as np
import torch

from biahub_tpu_torch.device import as_tensor, resolve_device

__all__ = ["midband_power_zyx", "focus_from_transverse_band",
           "focus_from_transverse_band_tzyx"]


def _midband_mask(
    shape_yx: tuple[int, int],
    NA_det: float,
    lambda_ill: float,
    pixel_size: float,
    midband_fractions: tuple[float, float],
) -> np.ndarray:
    fy = np.fft.fftfreq(shape_yx[0], d=pixel_size)
    fx = np.fft.rfftfreq(shape_yx[1], d=pixel_size)
    frr = np.sqrt(fy[:, None] ** 2 + fx[None, :] ** 2)
    cutoff = 2 * NA_det / lambda_ill
    return (frr > cutoff * midband_fractions[0]) & (frr < cutoff * midband_fractions[1])


def midband_power_zyx(
    zyx: torch.Tensor,
    NA_det: float = 1.35,
    lambda_ill: float = 0.5,
    pixel_size: float = 0.1,
    midband_fractions: tuple[float, float] = (0.125, 0.25),
) -> torch.Tensor:
    """Per-slice mid-band log spectral power (the focus metric) of a
    (..., Y, X) tensor, shape (...,), float32."""
    zyx = zyx.to(torch.float32)
    mask = torch.from_numpy(
        _midband_mask(tuple(zyx.shape[-2:]), NA_det, lambda_ill, pixel_size,
                      midband_fractions)).to(zyx.device)
    spectrum = torch.fft.rfftn(zyx, dim=(-2, -1)).abs()
    return (torch.log(spectrum + 1e-12) * mask).sum(dim=(-2, -1))


def focus_from_transverse_band(
    zyx,
    NA_det: float = 1.35,
    lambda_ill: float = 0.5,
    pixel_size: float = 0.1,
    midband_fractions: tuple[float, float] = (0.125, 0.25),
    mode: str = "max",
    device: str | torch.device = "cuda",
) -> int:
    """Index of the in-focus slice of a ZYX stack; 0 for one slice or a
    constant stack (the reference's empty-FOV rule)."""
    if zyx.ndim != 3:
        raise ValueError("Input must be a ZYX stack")
    return int(focus_from_transverse_band_tzyx(
        zyx[None], NA_det, lambda_ill, pixel_size, midband_fractions, mode, device)[0])


def focus_from_transverse_band_tzyx(
    tzyx,
    NA_det: float = 1.35,
    lambda_ill: float = 0.5,
    pixel_size: float = 0.1,
    midband_fractions: tuple[float, float] = (0.125, 0.25),
    mode: str = "max",
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """In-focus z-index (int numpy (T,)) of every timepoint of a (T, Z, Y,
    X) stack, in one batched sweep; constant frames give 0."""
    if tzyx.ndim != 4:
        raise ValueError("Input must be a TZYX stack")
    T, Z = tzyx.shape[:2]
    if Z == 1:
        return np.zeros(T, dtype=int)
    data = as_tensor(tzyx, resolve_device(device))
    power = midband_power_zyx(data, NA_det, lambda_ill, float(pixel_size),
                              tuple(midband_fractions))  # (T, Z)
    idx = power.argmin(dim=1) if mode == "min" else power.argmax(dim=1)
    flat = data.reshape(T, -1)
    idx[(flat == flat[:, :1]).all(dim=1)] = 0
    return idx.cpu().numpy().astype(int)
