"""Deconvolve, deskew and warp: the repo's main path as chains of kernels.

Counterpart of ``biahub_tpu/kernels/chain.py``:

- the headline step ``deconvolve_then_deskew{,_batched}``: on the card each
  volume runs kernels A -> B -> C into one deconvolved batch buffer, and
  kernel D deskews the batch (:func:`run_chain`). The result equals
  ``deskew_zyx(deconvolve_zyx(v))`` in the standard frame, or with Y
  reversed under ``skip_flip``;
- the full chain ``deconvolve_deskew_warp{,_batched}`` and
  ``deskew_then_warp``: the deskew keeps Y reversed (``skip_flip``) and its
  flip rides the in-plane warp's matrix, ``flip_y_matrix(Y) @ M``
  (chain.py:299-304, :521); kernels E and F then warp the whole batch once
  each (:func:`run_chain_warp`). A general 3D matrix takes the reference's
  other route (chain.py:439-472): the deskew in the zyx store, then the
  multipass warp, kernel H (:func:`run_chain_warp_general`);
- with ``spectral=True``, both take the spectral engine where it holds
  (chain.py:159-178, :386-415): kernels A, K, L and M
  (:mod:`biahub_tpu_torch.kernels.spectral`) emit the deskewed volume from
  the spectrum, in the xzy store before the warp
  (:func:`chain_warp_spectral_route`). The keyword stands in for the
  reference's ``BIAHUB_TPU_SPECTRAL_DESKEW=1``.

On the CPU the same wrappers run their plain versions. uint16 volumes go
into pass A as they are. A volume shape that kernels A, B and C do not take
(``fft.deconvolve_limit``) is deconvolved with ``torch.fft``, the
reference's route past ``deconvolve_pallas_supported`` (chain.py:106-118:
``deconvolve_zyx``'s XLA FFT, then the deskew), and then deskewed (and
warped) by the same kernels; one stderr line says so.
"""

from __future__ import annotations

import numpy as np
import torch

from biahub_tpu_torch.device import as_tensor, resolve_device
from biahub_tpu_torch.kernels.affine import (
    affine_warp_auto,
    affine_warp_zyx,
    inplane_coefficients,
    is_inplane_matrix,
    matrix_4x4,
)
from biahub_tpu_torch.kernels.deconvolve import volume_tensor
from biahub_tpu_torch.kernels.deskew import (
    DeskewGeometry,
    deskew_geometry,
    deskew_zyx,
    fill_overhang_,
)
from biahub_tpu_torch.kernels.deskew_cuda import deskew
from biahub_tpu_torch.kernels.fft import (
    filter_torch_fft,
    fwd_yx,
    half_spectrum_shape,
    inv_yx,
    prepare_fourier_filter,
    takes_torch_fft,
    z_filter_,
)
from biahub_tpu_torch.kernels.spectral import (
    prepare_spectral_deskew,
    run_spectral,
    run_spectral_warp,
    spectral_deskew_supported,
)

__all__ = [
    "flip_y_matrix",
    "deconvolve_then_deskew",
    "deconvolve_then_deskew_batched",
    "deskew_then_warp",
    "deconvolve_deskew_warp",
    "deconvolve_deskew_warp_batched",
    "chain_warp_matrix",
    "chain_warp_coefficients",
    "chain_warp_spectral_route",
    "run_chain",
    "run_chain_warp",
    "run_chain_warp_general",
]


def run_chain(volumes: torch.Tensor, filt: torch.Tensor,
              geo: DeskewGeometry, out_layout: str = "zyx", fill=None) -> torch.Tensor:
    """A -> B -> C per volume, then D over the batch: (B, Z, Y, X) float32
    or uint16 on one device -> (B, groups, Y_out, X_out) float32, or (B,
    X_out, groups, Y_out) with ``out_layout="xzy"``. One spectrum buffer
    serves every volume. A shape past ``fft.deconvolve_limit`` is
    deconvolved with ``torch.fft`` instead of A, B and C. ``fill``: the
    overhang fill (``deskew.overhang_fill_value``; zyx store only), applied
    to each deskewed volume."""
    if fill is not None and out_layout != "zyx":
        raise ValueError("run_chain: the overhang fill needs the zyx store")
    batch = volumes.shape[0]
    decon = torch.empty((batch,) + tuple(volumes.shape[1:]), dtype=torch.float32,
                        device=volumes.device)
    if takes_torch_fft("deconvolve_then_deskew", volumes.shape[1:]):
        for b in range(batch):
            filter_torch_fft(volumes[b], filt, out=decon[b])
    else:
        spectrum = torch.empty(half_spectrum_shape(volumes.shape[1:]),
                               dtype=torch.complex64, device=volumes.device)
        for b in range(batch):
            fwd_yx(volumes[b], out=spectrum)
            z_filter_(spectrum, filt)
            inv_yx(spectrum, out=decon[b])
    return fill_overhang_(deskew(decon, geo, out_layout), fill)


def run_chain_warp(volumes: torch.Tensor, filt: torch.Tensor, geo: DeskewGeometry,
                   coeffs: torch.Tensor, output_shape, fill: float = 0.0,
                   out_layout: str = "zyx", overhang_fill=None) -> torch.Tensor:
    """:func:`run_chain` (``geo.skip_flip`` set), then kernels E and F once
    each over the batch -> (B, Zo, Yo, Xo) float32. ``coeffs``: the
    :func:`chain_warp_coefficients` of the warp, on the volumes' device.
    ``out_layout="xzy"`` hands the deskew to the warp in (B, X', Z', Y')
    (the reference's xzy handoff); the output is the same to the bit.
    ``overhang_fill``: the deskew's overhang fill, between D (zyx store)
    and E, as the reference composes its stages when a fill is asked for
    (fuse.py:508-511)."""
    from biahub_tpu_torch.kernels.warp_cuda import warp_x, warp_zy

    z_out, y_out, x_out = (int(s) for s in output_shape)
    if overhang_fill is not None:
        out_layout = "zyx"
    deskewed = run_chain(volumes, filt, geo, out_layout, overhang_fill)
    inter = warp_zy(deskewed, coeffs, (z_out, y_out), input_xzy=out_layout == "xzy")
    return warp_x(inter, coeffs, x_out, geo.out_shape, fill)


def run_chain_warp_general(volumes: torch.Tensor, filt: torch.Tensor,
                           geo: DeskewGeometry, matrix: np.ndarray, output_shape,
                           fill: float = 0.0, overhang_fill=None) -> torch.Tensor:
    """:func:`run_chain` (``geo.skip_flip`` set), then a general 3D warp of
    the batch by ``matrix`` (:func:`chain_warp_matrix`) -> (B, Zo, Yo, Xo)
    float32: the multipass warp with the one matrix for every volume (H
    once per canonical slot), or the exact gather when a pivot vanishes,
    as the reference's ``affine_warp_auto`` warps each volume.
    ``overhang_fill``: the deskew's overhang fill, before the warp."""
    from biahub_tpu_torch.kernels.multipass_warp import multipass_affine_warp_zyx_batched

    out_shape = tuple(int(s) for s in output_shape)
    deskewed = run_chain(volumes, filt, geo, fill=overhang_fill)
    try:
        return multipass_affine_warp_zyx_batched(
            deskewed, np.stack([matrix] * len(deskewed)), out_shape, fill,
            device=deskewed.device)
    except ValueError:  # a vanishing pivot
        return torch.stack([affine_warp_zyx(v, matrix, out_shape, fill, device=v.device)
                            for v in deskewed])


def flip_y_matrix(y_size: int) -> np.ndarray:
    """OUTPUT->INPUT affine flipping the Y axis of a ``y_size`` volume."""
    f = np.eye(4)
    f[1, 1] = -1.0
    f[1, 3] = float(y_size - 1)
    return f


def chain_warp_matrix(matrix, geo: DeskewGeometry) -> np.ndarray:
    """``flip_y_matrix(Y_out) @ matrix``: the warp ``matrix`` of the
    standard deskewed frame, applied to the deskew that keeps Y reversed
    (``skip_flip``)."""
    return flip_y_matrix(geo.zyx_shape[2]) @ matrix_4x4(matrix)


def chain_warp_coefficients(matrix, geo: DeskewGeometry) -> torch.Tensor:
    """The in-plane coefficients of :func:`chain_warp_matrix`; raises
    ValueError for a matrix that is not in-plane."""
    return inplane_coefficients(chain_warp_matrix(matrix, geo))


def chain_warp_spectral_route(
    zyx_shape,
    ls_angle_deg: float,
    px_to_scan_ratio: float,
    keep_overhang: bool,
    average_window: int,
    matrix,
) -> bool:
    """Whether :func:`deconvolve_deskew_warp` with ``spectral=True`` takes
    the spectral engine (chain.py:41-80): the kernels take the geometry
    and ``flip_y_matrix(Y_out) @ matrix`` is in-plane."""
    if not spectral_deskew_supported(zyx_shape, ls_angle_deg, px_to_scan_ratio,
                                     keep_overhang, average_window):
        return False
    geo = deskew_geometry(zyx_shape, ls_angle_deg, px_to_scan_ratio, keep_overhang,
                          average_window, skip_flip=True)
    return is_inplane_matrix(chain_warp_matrix(matrix, geo))


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
    spectral: bool = False,
) -> torch.Tensor:
    """Deconvolve then deskew a (B, Z, Y, X) batch -> (B, groups, Y_out,
    X_out) float32. ``prepared``: a hoisted
    :func:`~biahub_tpu_torch.kernels.fft.prepare_fourier_filter` result
    (then the transfer function may be None). ``spectral``: take the
    spectral engine where :func:`~biahub_tpu_torch.kernels.spectral.
    spectral_deskew_supported` holds (its table built and cached)."""
    dev = resolve_device(device)
    data = volume_tensor(volumes, dev)
    zyx = tuple(data.shape[1:])
    filt = prepared if prepared is not None else prepare_fourier_filter(
        zyx, transfer_function_half, regularization_strength, dev
    )
    geo = deskew_geometry(zyx, ls_angle_deg, px_to_scan_ratio, keep_overhang,
                          average_window, skip_flip=skip_flip)
    if spectral and spectral_deskew_supported(zyx, ls_angle_deg, px_to_scan_ratio,
                                              keep_overhang, average_window):
        table = prepare_spectral_deskew(zyx, ls_angle_deg, px_to_scan_ratio, keep_overhang,
                                        average_window, dev)
        out = run_spectral(data, filt.to(dev), table, geo)
        return out if skip_flip else out.flip(2)
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
    spectral: bool = False,
) -> torch.Tensor:
    """One ZYX volume -> (groups, Y_out, X_out) float32 (see
    :func:`deconvolve_then_deskew_batched`)."""
    dev = resolve_device(device)
    return deconvolve_then_deskew_batched(
        volume_tensor(volume, dev)[None], transfer_function_half,
        regularization_strength, ls_angle_deg, px_to_scan_ratio,
        keep_overhang, average_window, prepared, skip_flip, dev, spectral,
    )[0]


def deskew_then_warp(
    volume,
    ls_angle_deg: float,
    px_to_scan_ratio: float,
    matrix,
    output_shape: tuple[int, int, int] | None = None,
    keep_overhang: bool = False,
    average_window: int = 1,
    fill: float = 0.0,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """Deskew one ZYX volume, then warp it by ``matrix`` (an output->input
    affine of the standard deskewed frame) -> (Zo, Yo, Xo) float32; the
    deskew's Y flip rides the warp (chain.py:307). ``output_shape``
    defaults to the deskewed shape."""
    dev = resolve_device(device)
    deskewed = deskew_zyx(as_tensor(volume, dev), ls_angle_deg, px_to_scan_ratio,
                          keep_overhang, average_window, skip_flip=True, device=dev)
    out_shape = tuple(int(s) for s in (
        output_shape if output_shape is not None else deskewed.shape))
    m = flip_y_matrix(int(deskewed.shape[1])) @ matrix_4x4(matrix)
    return affine_warp_auto(deskewed, m, out_shape, fill=fill, device=dev)


def deconvolve_deskew_warp_batched(
    volumes,
    transfer_function_half,
    regularization_strength: float,
    ls_angle_deg: float,
    px_to_scan_ratio: float,
    matrix,
    output_shape: tuple[int, int, int] | None = None,
    keep_overhang: bool = False,
    average_window: int = 1,
    fill: float = 0.0,
    prepared: torch.Tensor | None = None,
    device: str | torch.device = "cuda",
    spectral: bool = False,
) -> torch.Tensor:
    """Deconvolve, deskew and warp a (B, Z, Y, X) batch -> (B, Zo, Yo, Xo)
    float32 (chain.py:475). ``matrix``: an output->input affine of the
    standard deskewed frame (register and stabilize composed), in-plane
    (kernels E and F) or general (:func:`run_chain_warp_general`);
    ``output_shape`` defaults to the deskewed (groups, Y_out, X_out);
    ``prepared``: a hoisted
    :func:`~biahub_tpu_torch.kernels.fft.prepare_fourier_filter` result.
    ``spectral``: take the spectral engine's xzy store into E and F where
    :func:`chain_warp_spectral_route` holds."""
    dev = resolve_device(device)
    data = volume_tensor(volumes, dev)
    zyx = tuple(data.shape[1:])
    geo = deskew_geometry(zyx, ls_angle_deg, px_to_scan_ratio, keep_overhang,
                          average_window, skip_flip=True)
    m = chain_warp_matrix(matrix, geo)
    filt = prepared if prepared is not None else prepare_fourier_filter(
        zyx, transfer_function_half, regularization_strength, dev
    )
    out_shape = output_shape if output_shape is not None else geo.out_shape
    if not is_inplane_matrix(m):
        return run_chain_warp_general(data, filt.to(dev), geo, m, out_shape, fill)
    coeffs = inplane_coefficients(m).to(dev)
    if spectral and chain_warp_spectral_route(zyx, ls_angle_deg, px_to_scan_ratio,
                                              keep_overhang, average_window, matrix):
        table = prepare_spectral_deskew(zyx, ls_angle_deg, px_to_scan_ratio, keep_overhang,
                                        average_window, dev)
        return run_spectral_warp(data, filt.to(dev), table, geo, coeffs, out_shape, fill)
    return run_chain_warp(data, filt.to(dev), geo, coeffs, out_shape, fill)


def deconvolve_deskew_warp(
    volume,
    transfer_function_half,
    regularization_strength: float,
    ls_angle_deg: float,
    px_to_scan_ratio: float,
    matrix,
    output_shape: tuple[int, int, int] | None = None,
    keep_overhang: bool = False,
    average_window: int = 1,
    fill: float = 0.0,
    prepared: torch.Tensor | None = None,
    device: str | torch.device = "cuda",
    spectral: bool = False,
) -> torch.Tensor:
    """One ZYX volume -> (Zo, Yo, Xo) float32 (see
    :func:`deconvolve_deskew_warp_batched`)."""
    dev = resolve_device(device)
    return deconvolve_deskew_warp_batched(
        volume_tensor(volume, dev)[None], transfer_function_half,
        regularization_strength, ls_angle_deg, px_to_scan_ratio, matrix,
        output_shape, keep_overhang, average_window, fill, prepared, dev, spectral,
    )[0]
