"""Fluorescence deconvolution: PSF transfer function + Tikhonov inverse filter.

Counterpart of ``biahub_tpu/kernels/deconvolve.py``. The transfer function
is the normalised magnitude of the padded PSF's 3D FFT; deconvolution is

    out = irfftn(rfftn(data) * tf / (tf^2 + reg))

on the rfft half-spectrum. It runs as passes A, B and C of
:mod:`biahub_tpu_torch.kernels.fft`: the CUDA kernels for a volume on the
card, their plain PyTorch versions (``torch.fft``) on the CPU. A shape the
kernels do not take (``fft.deconvolve_limit``) runs the reference's XLA
route, ``torch.fft`` on the whole volume, and says so on stderr.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from biahub_tpu_torch.device import as_tensor, resolve_device
from biahub_tpu_torch.kernels.fft import (
    PASS_A_DTYPES,
    deconvolve_limit,
    fwd_yx,
    inv_yx,
    prepare_fourier_filter,
    z_filter_,
)

__all__ = ["compute_transfer_function", "deconvolve_zyx", "deconvolve_czyx"]


def compute_transfer_function(
    psf_zyx_data: np.ndarray,
    output_zyx_shape: tuple[int, int, int],
) -> np.ndarray:
    """Normalized |FFT| of the PSF zero-padded (centered) to the output shape.

    A copy of ``biahub_tpu.kernels.deconvolve.compute_transfer_function``,
    bit-for-bit, including the odd-padding split.
    """
    padding = np.array(output_zyx_shape) - np.array(psf_zyx_data.shape)
    pad_width = [
        (x // 2, x // 2) if x % 2 == 0 else (x // 2, x // 2 + 1) for x in padding
    ]
    padded = np.pad(psf_zyx_data, pad_width=pad_width, mode="constant", constant_values=0)
    tf = np.abs(np.fft.fftn(padded))
    tf /= tf.max()
    return tf.astype(np.float32)


def volume_tensor(data, device: torch.device) -> torch.Tensor:
    """``data`` on ``device`` in a dtype pass A reads: uint16 and float32
    stay as they are (uint16 converts exactly inside the kernel), anything
    else becomes float32."""
    return as_tensor(data, device, dtypes=PASS_A_DTYPES)


def deconvolve_zyx(
    zyx_data,
    transfer_function_half=None,
    regularization_strength: float = 1e-3,
    prepared: torch.Tensor | None = None,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """Tikhonov inverse filter of one ZYX volume; float32 (Z, Y, X) out.

    ``transfer_function_half`` is the full TF sliced to ``[..., : X // 2 +
    1]``. ``prepared``: a :func:`~biahub_tpu_torch.kernels.fft.
    prepare_fourier_filter` result for this shape, which callers hoist out
    of a loop over volumes (then the TF may be omitted). Where kernels A, B
    and C do not take the shape, ``irfftn(rfftn(volume) * filter)`` in
    ``torch.fft``, the reference's route beyond its kernels
    (deconvolve.py:66-71), decided from the shape before any launch.
    """
    dev = resolve_device(device)
    volume = volume_tensor(zyx_data, dev)
    filt = prepared if prepared is not None else prepare_fourier_filter(
        volume.shape, transfer_function_half, regularization_strength, dev
    )
    limit = deconvolve_limit(volume.shape)
    if limit is not None:
        print(f"deconvolve_zyx: {tuple(volume.shape)} takes torch.fft: {limit}",
              file=sys.stderr)
        return torch.fft.irfftn(torch.fft.rfftn(volume.to(torch.float32)) * filt.to(dev),
                                s=tuple(volume.shape))
    spectrum = fwd_yx(volume)
    z_filter_(spectrum, filt.to(dev))
    return inv_yx(spectrum, out=torch.empty(volume.shape, dtype=torch.float32, device=dev))


def deconvolve_czyx(
    czyx_data,
    transfer_function_half,
    regularization_strength: float = 1e-3,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """The inverse filter of each channel of a CZYX stack."""
    dev = resolve_device(device)
    data = volume_tensor(czyx_data, dev)
    filt = prepare_fourier_filter(
        data.shape[1:], transfer_function_half, regularization_strength, dev
    )
    return torch.stack([
        deconvolve_zyx(c, prepared=filt, device=dev) for c in data
    ])
