"""Deconvolve, then deskew: the headline step as one chain of kernels.

Counterpart of ``biahub_tpu/kernels/chain.py``'s ``deconvolve_then_deskew``
and ``deconvolve_then_deskew_batched``. On the card each volume runs
kernels A -> B -> C into one deconvolved batch buffer, and kernel D deskews
the batch; on the CPU the same wrappers run their plain versions. The
result equals ``deskew_zyx(deconvolve_zyx(v))`` in the standard frame, or
with Y reversed under ``skip_flip``. uint16 volumes go into pass A as they
are.
"""

from __future__ import annotations

import torch

from biahub_tpu_torch.device import resolve_device
from biahub_tpu_torch.kernels.deconvolve import volume_tensor
from biahub_tpu_torch.kernels.deskew import DeskewGeometry, deskew_geometry
from biahub_tpu_torch.kernels.deskew_cuda import deskew
from biahub_tpu_torch.kernels.fft import (
    fwd_yx,
    half_spectrum_shape,
    inv_yx,
    prepare_fourier_filter,
    z_filter_,
)

__all__ = ["deconvolve_then_deskew", "deconvolve_then_deskew_batched",
           "run_chain"]


def run_chain(volumes: torch.Tensor, filt: torch.Tensor,
              geo: DeskewGeometry) -> torch.Tensor:
    """A -> B -> C per volume, then D over the batch: (B, Z, Y, X) float32
    or uint16 on one device -> (B, groups, Y_out, X_out) float32. One
    spectrum buffer serves every volume."""
    batch = volumes.shape[0]
    decon = torch.empty((batch,) + tuple(volumes.shape[1:]), dtype=torch.float32,
                        device=volumes.device)
    spectrum = torch.empty(half_spectrum_shape(volumes.shape[1:]),
                           dtype=torch.complex64, device=volumes.device)
    for b in range(batch):
        fwd_yx(volumes[b], out=spectrum)
        z_filter_(spectrum, filt)
        inv_yx(spectrum, out=decon[b])
    return deskew(decon, geo)


def deconvolve_then_deskew_batched(
    volumes,
    transfer_function_half,
    regularization_strength: float,
    ls_angle_deg: float,
    px_to_scan_ratio: float,
    keep_overhang: bool = False,
    average_window: int = 1,
    prepared: torch.Tensor | None = None,
    skip_flip: bool = False,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """Deconvolve then deskew a (B, Z, Y, X) batch -> (B, groups, Y_out,
    X_out) float32. ``prepared``: a hoisted
    :func:`~biahub_tpu_torch.kernels.fft.prepare_fourier_filter` result
    (then the transfer function may be None)."""
    dev = resolve_device(device)
    data = volume_tensor(volumes, dev)
    zyx = tuple(data.shape[1:])
    filt = prepared if prepared is not None else prepare_fourier_filter(
        zyx, transfer_function_half, regularization_strength, dev
    )
    geo = deskew_geometry(zyx, ls_angle_deg, px_to_scan_ratio, keep_overhang,
                          average_window, skip_flip=skip_flip)
    return run_chain(data, filt.to(dev), geo)


def deconvolve_then_deskew(
    volume,
    transfer_function_half,
    regularization_strength: float,
    ls_angle_deg: float,
    px_to_scan_ratio: float,
    keep_overhang: bool = False,
    average_window: int = 1,
    prepared: torch.Tensor | None = None,
    skip_flip: bool = False,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """One ZYX volume -> (groups, Y_out, X_out) float32 (see
    :func:`deconvolve_then_deskew_batched`)."""
    dev = resolve_device(device)
    return deconvolve_then_deskew_batched(
        volume_tensor(volume, dev)[None], transfer_function_half,
        regularization_strength, ls_angle_deg, px_to_scan_ratio,
        keep_overhang, average_window, prepared, skip_flip, dev,
    )[0]
