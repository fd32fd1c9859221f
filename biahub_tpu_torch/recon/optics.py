"""Optical transfer function models: pupils, widefield OTF, phase WOTF, and
their Tikhonov inverse.

Counterpart of ``biahub_tpu/recon/optics.py``. :func:`pupil`, :func:`_kz`
and :func:`_z_coords` are copies of the reference's numpy helpers. The
transfer functions are the reference's expressions in float32 and
complex64, in its order: the reference computes them with XLA FFTs, so
``torch.fft`` computes them here, on the device asked for, and no formula
is made more precise than the reference's. :func:`tikhonov_inverse_3d`
runs kernels A, Bc and C
(:func:`~biahub_tpu_torch.kernels.fft.fourier_filter_zyx`), the reference's
``assume_hermitian`` route through ``fourier_filter_zyx_pallas``, or, for a
shape the kernels do not take, the same half-spectrum filter in
``torch.fft`` (the reference's XLA route past
``deconvolve_pallas_supported``, optics.py:186-205).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from biahub_tpu_torch.device import as_tensor, resolve_device
from biahub_tpu_torch.kernels import fft as kfft

__all__ = [
    "pupil",
    "fluorescence_otf_3d",
    "phase_wotf_3d",
    "tikhonov_inverse_3d",
]


def _frequency_grids(yx_shape, yx_pixel_size):
    fy = np.fft.fftfreq(yx_shape[0], d=yx_pixel_size)
    fx = np.fft.fftfreq(yx_shape[1], d=yx_pixel_size)
    return np.meshgrid(fy, fx, indexing="ij")


def pupil(
    yx_shape,
    yx_pixel_size: float,
    numerical_aperture: float,
    wavelength: float,
) -> np.ndarray:
    """Binary circular pupil on the fftfreq grid (cutoff NA/lambda)."""
    fyy, fxx = _frequency_grids(yx_shape, yx_pixel_size)
    frr = np.sqrt(fyy**2 + fxx**2)
    return (frr <= numerical_aperture / wavelength).astype(np.float32)


def _kz(yx_shape, yx_pixel_size, wavelength, n_media) -> np.ndarray:
    """Axial wavevector kz(u) = sqrt((n/lambda)^2 - |u|^2), zero outside."""
    fyy, fxx = _frequency_grids(yx_shape, yx_pixel_size)
    f2 = fyy**2 + fxx**2
    kz2 = (n_media / wavelength) ** 2 - f2
    return np.sqrt(np.maximum(kz2, 0.0)).astype(np.float32)


def _z_coords(n_z: int, z_pixel_size: float) -> np.ndarray:
    # fftfreq-style z coordinates so the OTF is centered at z=0 without shifts
    return (np.fft.fftfreq(n_z) * n_z * z_pixel_size).astype(np.float32)


def _defocus(z: torch.Tensor, kz: torch.Tensor) -> torch.Tensor:
    """``exp(2j*pi*z*kz)`` for every z, (Z, Y, X) complex64, as the reference
    forms it: the phase (float32(2 pi) * z) * kz rounded in float32, then
    its cosine and sine."""
    theta = (z * (2 * math.pi))[:, None, None] * kz[None]
    return torch.polar(torch.ones_like(theta), theta)


def _grids(shape, yx_pixel_size, z_pixel_size, wavelength, n_media, dev):
    kz = torch.from_numpy(_kz(shape[1:], yx_pixel_size, wavelength, n_media)).to(dev)
    z = torch.from_numpy(_z_coords(shape[0], z_pixel_size)).to(dev)
    return kz, z


def fluorescence_otf_3d(
    zyx_shape: tuple[int, int, int],
    yx_pixel_size: float,
    z_pixel_size: float,
    wavelength_emission: float,
    numerical_aperture_detection: float,
    index_of_refraction_media: float,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """Widefield incoherent 3D OTF, complex64 (Z, Y, X), 1 at DC."""
    dev = resolve_device(device)
    shape = tuple(int(s) for s in zyx_shape)
    p = torch.from_numpy(pupil(shape[1:], yx_pixel_size, numerical_aperture_detection,
                               wavelength_emission)).to(dev)
    kz, z = _grids(shape, yx_pixel_size, z_pixel_size, wavelength_emission,
                   index_of_refraction_media, dev)
    asf = torch.fft.ifft2(p[None] * _defocus(z, kz), dim=(1, 2))
    otf = torch.fft.fftn(asf.abs() ** 2)
    return otf / otf[0, 0, 0]


def phase_wotf_3d(
    zyx_shape: tuple[int, int, int],
    yx_pixel_size: float,
    z_pixel_size: float,
    wavelength_illumination: float,
    numerical_aperture_illumination: float,
    numerical_aperture_detection: float,
    index_of_refraction_media: float,
    invert_phase_contrast: bool = False,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """3D weak-object PHASE transfer function, complex64 (Z, Y, X): the
    z-FFT of 2 Im{C(f, z)}, C the source-pupil correlation at defocus z
    (one FFT cross-correlation per z), so FFT3(I_norm) ~ H * FFT3(phi)."""
    dev = resolve_device(device)
    shape = tuple(int(s) for s in zyx_shape)
    p = torch.from_numpy(pupil(shape[1:], yx_pixel_size, numerical_aperture_detection,
                               wavelength_illumination)).to(dev)
    s = torch.from_numpy(pupil(shape[1:], yx_pixel_size, numerical_aperture_illumination,
                               wavelength_illumination)).to(dev)
    kz, z = _grids(shape, yx_pixel_size, z_pixel_size, wavelength_illumination,
                   index_of_refraction_media, dev)
    norm = torch.sum(s * p * p) + 1e-12
    defocus = _defocus(z, kz)
    # C(f, z) = sum_u conj(A'(u)) B(u + f), A' = S P e^{i2pi z kz}, B = P e^{i2pi z kz}.
    a_conj = (s * p)[None] * defocus
    b = p[None] * defocus
    corr = torch.fft.ifft2(torch.fft.fft2(a_conj).conj() * torch.fft.fft2(b))
    c = corr * (p.numel() / norm) / p.numel()  # normalize by source energy
    h = torch.fft.fft(2.0 * c.imag, dim=0) * (1.0 if invert_phase_contrast else -1.0)
    # One z-FFT bin corresponds to dz spacing; fold the z sampling in.
    return h / shape[0]


def tikhonov_inverse_3d(
    zyx_data,
    transfer_function,
    regularization_strength: float = 1e-3,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """``f = Re{IFFT3(FFT3(data) conj(H) / (|H|^2 + reg))}``, float32, for a
    Hermitian ``H`` (true of the transfer functions built here): the
    reference's ``assume_hermitian`` route, kernels A, Bc and C on the rfft
    half spectrum, or ``torch.fft`` on it where the kernels do not take the
    shape (``fft.deconvolve_limit``; one stderr line says so). apply-inv-tf
    runs the same two steps, with the filter prepared once per call."""
    dev = resolve_device(device)
    data = as_tensor(zyx_data, dev)
    filt = kfft.prepare_hermitian_filter(data.shape, transfer_function,
                                         regularization_strength, dev)
    if kfft.takes_torch_fft("tikhonov_inverse_3d", data.shape):
        return kfft.filter_torch_fft(data, filt)
    return kfft.fourier_filter_zyx(data, filt)
