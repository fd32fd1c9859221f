"""Spectral deconvolve + deskew: the deskew's lerp evaluated from the spectrum.

Counterpart of the host side of ``biahub_tpu/kernels/pallas_spectral.py``.
The deskew's scan-axis lerp is linear in the z samples, so it evaluates
straight from the z-spectrum as one complex matrix per output tilt row
(:mod:`biahub_tpu_torch.kernels.fourier_resample`), and the deconvolved
volume never reaches memory. Per volume:

- kernel A (:func:`~biahub_tpu_torch.kernels.fft.fwd_yx`): rfft along X
  and DFT along Y;
- kernel K (:func:`~biahub_tpu_torch.kernels.fft.z_fwd_filter_`): DFT
  along Z times the filter, no inverse;
- kernel L (:func:`~biahub_tpu_torch.kernels.fft.y_inv_`): inverse DFT
  along Y;
- kernel M (:func:`~biahub_tpu_torch.kernels.spectral_cuda.lerp_irfft`):
  per output group, the table contracted with the group's tilt rows (on the
  tensor cores, in split TF32), then the irfft along X, in the zyx store or
  the xzy store the warp reads.

The normalisation is split as the reference's: the table carries
1/(Z*avg), L 1/Y and M's irfft 1/X. The result equals
``deskew_zyx(deconvolve_zyx(v), skip_flip=True)`` to float32 rounding
(the frame that keeps Y reversed). The route is opt-in (``spectral=True``
on the chain functions and modules, where the reference reads
``BIAHUB_TPU_SPECTRAL_DESKEW``); this module reads no environment.
"""

from __future__ import annotations

import functools

import torch

from biahub_tpu_torch.device import resolve_device
from biahub_tpu_torch.kernels.deconvolve import volume_tensor
from biahub_tpu_torch.kernels.deskew import DeskewGeometry, deskew_geometry
from biahub_tpu_torch.kernels.fft import (
    fwd_yx,
    half_spectrum_shape,
    max_axis,
    prepare_fourier_filter,
    y_inv_,
    z_fwd_filter_,
)
from biahub_tpu_torch.kernels.fourier_resample import (
    deskew_sample_positions,
    masked_lerp_dft_matrix,
)
from biahub_tpu_torch.kernels.spectral_cuda import OUT_LAYOUTS, lerp_irfft

__all__ = [
    "prepare_spectral_deskew",
    "spectral_table",
    "spectral_deskew_supported",
    "deconvolve_deskew_zyx_spectral",
    "run_spectral",
    "run_spectral_warp",
]

_TABLE_ROWS = 16  # table rows built at a time (bounds the float64 temporaries)


def _table_shape(geo: DeskewGeometry) -> tuple[int, int, int]:
    return geo.groups * geo.average_window, geo.x_out, geo.zyx_shape[0]


def spectral_table(raw_shape, ls_angle_deg: float, px_to_scan_ratio: float,
                   keep_overhang: bool, average_window: int,
                   device: torch.device) -> torch.Tensor:
    """The table of :func:`prepare_spectral_deskew`, built anew: row z' is
    the masked lerp-DFT matrix of output tilt row min(z', Z_out-1) (the
    tail group's edge padding), times 1/avg, built in float64 and cast to
    complex64 as ``_spectral_table_np`` (pallas_spectral.py:133-165)."""
    shape = tuple(int(s) for s in raw_shape)
    geo = deskew_geometry(shape, ls_angle_deg, px_to_scan_ratio, keep_overhang,
                          average_window)
    rows, x_out, z_in = _table_shape(geo)
    in_z, _ = deskew_sample_positions(shape, ls_angle_deg, px_to_scan_ratio,
                                      keep_overhang, device)
    in_z = in_z[torch.arange(rows, device=device).clamp_max(shape[1] - 1)]
    table = torch.empty((rows, x_out, z_in), dtype=torch.complex64, device=device)
    scale = 1.0 / int(average_window)
    for r0 in range(0, rows, _TABLE_ROWS):
        r1 = min(r0 + _TABLE_ROWS, rows)
        m = masked_lerp_dft_matrix(z_in, in_z[r0:r1].reshape(-1), device)
        table[r0:r1] = (m * scale).reshape(r1 - r0, x_out, z_in).to(torch.complex64)
    return table


@functools.lru_cache(maxsize=2)
def _cached_table(raw_shape, ls_angle_deg, px_to_scan_ratio, keep_overhang, average_window,
                  device):
    return spectral_table(raw_shape, ls_angle_deg, px_to_scan_ratio, keep_overhang,
                          average_window, device)


def prepare_spectral_deskew(
    raw_shape: tuple[int, int, int],
    ls_angle_deg: float,
    px_to_scan_ratio: float,
    keep_overhang: bool,
    average_window: int = 1,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """The per-acquisition lerp-DFT table, (groups*avg, X_out, Z) complex64
    on ``device``, with 1/(Z*avg) folded in; one table serves both stores
    (no group is padded). Cached for the last two geometries: callers that
    hold several hoist it (it is ~256 MB at the headline). Do not write
    into the result."""
    dev = resolve_device(device)
    return _cached_table(tuple(int(s) for s in raw_shape), float(ls_angle_deg),
                         float(px_to_scan_ratio), bool(keep_overhang),
                         int(average_window), dev)


def spectral_deskew_supported(
    shape: tuple[int, int, int],
    ls_angle_deg: float,
    px_to_scan_ratio: float,
    keep_overhang: bool,
    average_window: int = 1,
) -> bool:
    """Whether the port's kernels take this geometry: every axis within
    A's limits (2 to 8192 for a power of two, 2 to 4096 otherwise; K's Z,
    L's Y and M's X too), Y within K's grid and the groups within M's grid.
    An overhang-only geometry is not taken. Reads no environment: the
    opt-in is the callers' ``spectral`` keyword."""
    z, y, x = (int(s) for s in shape)
    if int(average_window) < 1:
        return False
    try:
        geo = deskew_geometry((z, y, x), ls_angle_deg, px_to_scan_ratio, keep_overhang,
                              average_window)
    except ValueError:  # overhang only
        return False
    return (all(2 <= n <= max_axis(n) for n in (z, y, x)) and y <= 65535
            and geo.groups <= 65535)


def _check_table(table: torch.Tensor, geo: DeskewGeometry) -> None:
    want = _table_shape(geo)
    if tuple(table.shape) != want or table.dtype != torch.complex64:
        raise ValueError(
            f"deskew table {tuple(table.shape)} {table.dtype} does not match this "
            f"geometry (expected complex64 {want}); rebuild it with "
            "prepare_spectral_deskew")


def run_spectral(volumes: torch.Tensor, filt: torch.Tensor, table: torch.Tensor,
                 geo: DeskewGeometry, out_layout: str = "zyx") -> torch.Tensor:
    """A -> K -> L -> M per volume into one batch output: (B, Z, Y, X)
    float32 or uint16 -> (B, groups, X, X_out) float32, or (B, X_out,
    groups, X) with ``out_layout="xzy"``, Y reversed. One spectrum buffer
    serves every volume."""
    batch = volumes.shape[0]
    x = geo.zyx_shape[2]
    vol_shape = ((geo.groups, x, geo.x_out) if out_layout == "zyx"
                 else (geo.x_out, geo.groups, x))
    out = torch.empty((batch,) + vol_shape, dtype=torch.float32, device=volumes.device)
    spectrum = torch.empty(half_spectrum_shape(geo.zyx_shape), dtype=torch.complex64,
                           device=volumes.device)
    for b in range(batch):
        fwd_yx(volumes[b], out=spectrum)
        z_fwd_filter_(spectrum, filt)
        y_inv_(spectrum)
        lerp_irfft(spectrum, table, x, geo.average_window, out_layout, out=out[b])
    return out


def run_spectral_warp(volumes: torch.Tensor, filt: torch.Tensor, table: torch.Tensor,
                      geo: DeskewGeometry, coeffs: torch.Tensor, output_shape,
                      fill: float = 0.0) -> torch.Tensor:
    """:func:`run_spectral` in the xzy store, then kernels E and F once
    each over the batch (``input_xzy``) -> (B, Zo, Yo, Xo) float32.
    ``coeffs``: the in-plane coefficients of the chain's matrix, the
    deskew's Y flip folded in."""
    from biahub_tpu_torch.kernels.warp_cuda import warp_x, warp_zy

    z_out, y_out, x_out = (int(s) for s in output_shape)
    xzy = run_spectral(volumes, filt, table, geo, "xzy")
    inter = warp_zy(xzy, coeffs, (z_out, y_out), input_xzy=True)
    return warp_x(inter, coeffs, x_out, geo.out_shape, fill)


def _filter(shape, transfer_function_half, regularization_strength, prepared, filt,
            dev: torch.device) -> torch.Tensor:
    """The filter kernel K multiplies by: the complex ``filt`` when
    ``regularization_strength`` is None (the reference's ``filter_halves``
    mode), else ``prepared`` or the Tikhonov filter of the transfer
    function."""
    if regularization_strength is None:
        if filt is None:
            raise ValueError("regularization_strength=None needs a complex filter")
        f = torch.as_tensor(filt).to(device=dev, dtype=torch.complex64)
    elif prepared is not None:
        f = prepared.to(dev)
    else:
        f = prepare_fourier_filter(shape, transfer_function_half, regularization_strength,
                                   dev)
    if tuple(f.shape) != half_spectrum_shape(shape):
        raise ValueError(f"filter {tuple(f.shape)} does not match volume shape "
                         f"{tuple(shape)} (want {half_spectrum_shape(shape)})")
    return f.contiguous()


def deconvolve_deskew_zyx_spectral(
    volume,
    transfer_function_half=None,
    regularization_strength: float | None = 1e-3,
    *,
    ls_angle_deg: float,
    px_to_scan_ratio: float,
    keep_overhang: bool,
    average_window: int = 1,
    prepared: torch.Tensor | None = None,
    deskew_table: torch.Tensor | None = None,
    filter=None,  # noqa: A002
    out_layout: str = "zyx",
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """Deconvolve then deskew one ZYX volume through the spectral engine
    (pallas_spectral.py:653): (groups, X, X_out) float32 in the frame that
    keeps Y reversed (``deskew_zyx(..., skip_flip=True)``'s), or (X_out,
    groups, X) with ``out_layout="xzy"``, the warp's input layout.

    ``prepared``: a :func:`~biahub_tpu_torch.kernels.fft.
    prepare_fourier_filter` result. ``filter``: a complex64 (Z, Y, X//2+1)
    filter (e.g. :func:`~biahub_tpu_torch.kernels.fft.
    prepare_hermitian_filter`'s), taken when ``regularization_strength``
    is None, as the reference's ``filter_halves``. ``deskew_table``: a
    :func:`prepare_spectral_deskew` result (built, and cached, when
    omitted). Raises when the table does not match the geometry and
    outside :func:`spectral_deskew_supported`."""
    if out_layout not in OUT_LAYOUTS:
        raise ValueError(f"out_layout must be one of {OUT_LAYOUTS}, got {out_layout!r}")
    dev = resolve_device(device)
    data = volume_tensor(volume, dev)
    shape = tuple(int(s) for s in data.shape)
    if not spectral_deskew_supported(shape, ls_angle_deg, px_to_scan_ratio, keep_overhang,
                                     average_window):
        raise ValueError(f"the spectral deskew does not take volume shape {shape} with "
                         f"average_window {average_window} and keep_overhang "
                         f"{keep_overhang} (see spectral_deskew_supported)")
    geo = deskew_geometry(shape, ls_angle_deg, px_to_scan_ratio, keep_overhang,
                          average_window, skip_flip=True)
    f = _filter(shape, transfer_function_half, regularization_strength, prepared, filter,
                dev)
    table = (deskew_table if deskew_table is not None else prepare_spectral_deskew(
        shape, ls_angle_deg, px_to_scan_ratio, keep_overhang, average_window, dev))
    _check_table(table, geo)
    return run_spectral(data[None], f, table.to(dev), geo, out_layout)[0]

