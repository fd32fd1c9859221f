"""The deskew's two-tap lerp evaluated from the z-spectrum, in float64.

Counterpart of ``biahub_tpu/kernels/fourier_resample.py``. The deskew
resamples the scan axis at ``p = px*x' - px*ct*z' + offset`` with a two-tap
lerp, a linear functional of the samples, so one complex matrix per output
row evaluates it straight from the DFT of the samples:

    lerp(ifft(V), p) == M(p) @ V,
    M[n, kz] = ((1-f) e^{i theta z0} + f e^{i theta (z0+1)}) / Z

with ``theta = 2 pi kz / Z``, ``z0 = floor(p)``, ``f = p - z0``. These
matrices are the table of the spectral deskew (:mod:`biahub_tpu_torch.
kernels.spectral`, kernel M).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from biahub_tpu_torch.device import resolve_device
from biahub_tpu_torch.kernels.deskew import get_deskewed_data_shape

__all__ = ["lerp_dft_matrix", "masked_lerp_dft_matrix", "deskew_sample_positions"]


def _positions(positions, device) -> torch.Tensor:
    p = positions if isinstance(positions, torch.Tensor) else torch.from_numpy(
        np.asarray(positions, dtype=np.float64))
    return p.to(device=resolve_device(device), dtype=torch.float64).reshape(-1)


def lerp_dft_matrix(n: int, positions, device: str | torch.device = "cuda") -> torch.Tensor:
    """Complex128 (len(positions), n) matrix ``M`` with ``M @ fft(v) ==
    lerp(v, p)`` (numpy's DFT convention); taps wrap periodically."""
    p = _positions(positions, device)
    z0 = torch.floor(p)[:, None]
    f = p[:, None] - z0
    theta = 2.0 * math.pi * torch.arange(n, dtype=torch.float64, device=p.device)[None, :] / n
    return ((1.0 - f) * torch.exp(1j * theta * z0)
            + f * torch.exp(1j * theta * (z0 + 1.0))) / n


def masked_lerp_dft_matrix(n: int, positions,
                           device: str | torch.device = "cuda") -> torch.Tensor:
    """:func:`lerp_dft_matrix` with each tap outside ``[0, n-1]`` dropped
    instead of wrapped, which is the zero-padded real-space lerp exactly
    (rows with both taps out are zero). Built, as the reference's, from
    the n roots of unity ``E[m] = e^{2i pi m/n}`` indexed by ``(kz*z0) mod
    n`` in integers, so no phase is a large float angle."""
    p = _positions(positions, device)
    i0f = torch.floor(p)
    f = p - i0f
    i0 = i0f.to(torch.int64)
    kz = torch.arange(n, dtype=torch.int64, device=p.device)
    e_table = torch.exp(2j * math.pi * torch.arange(n, dtype=torch.float64,
                                                     device=p.device) / n)
    w0 = torch.where((i0 >= 0) & (i0 <= n - 1), 1.0 - f, 0.0)
    w1 = torch.where((i0 + 1 >= 0) & (i0 + 1 <= n - 1), f, 0.0)
    m0 = torch.remainder(i0[:, None] * kz[None, :], n)
    m1 = torch.remainder((i0 + 1)[:, None] * kz[None, :], n)
    return (w0[:, None] * e_table[m0] + w1[:, None] * e_table[m1]) / n


def deskew_sample_positions(
    raw_shape: tuple[int, int, int],
    ls_angle_deg: float,
    px_to_scan_ratio: float,
    keep_overhang: bool,
    device: str | torch.device = "cuda",
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(in_z, exact)``, each (Z_out, X_out): the float64 scan position
    feeding deskewed voxel (z', :, x'), in the reference's arithmetic
    (kernels/deskew.py:233-244), and where the unmasked (periodic) matrix
    equals the zero-padded lerp: both taps in range, or tap 0 in range with
    a zero fraction."""
    device = resolve_device(device)
    z_in, y_in, x_in = (int(s) for s in raw_shape)
    output_shape, _ = get_deskewed_data_shape(
        (z_in, y_in, x_in), ls_angle_deg, px_to_scan_ratio, keep_overhang)
    z_out, x_out = y_in, output_shape[2]
    ct = float(np.cos(ls_angle_deg * np.pi / 180))
    px = float(px_to_scan_ratio)
    offset = px * ct * (z_out - 1) / 2 - px * (x_out - 1) / 2 + (z_in - 1) / 2
    z_idx = torch.arange(z_out, dtype=torch.float64, device=device)[:, None]
    x_idx = torch.arange(x_out, dtype=torch.float64, device=device)[None, :]
    in_z = px * x_idx - px * ct * z_idx + offset
    i0 = torch.floor(in_z)
    f = in_z - i0
    both_in = (i0 >= 0) & (i0 + 1 <= z_in - 1)
    lower_only = (i0 >= 0) & (i0 <= z_in - 1) & (f == 0)
    return in_z, both_in | lower_only
