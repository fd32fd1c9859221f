"""Wrappers of the in-plane warp kernels E (``warp_zy``) and F
(``warp_x_masked``) of ``csrc/warp.cu``.

:func:`warp_zy` (kernel E) is the counterpart of
``biahub_tpu/kernels/pallas_resample.py``'s ``shear_resample2_pallas_t``
and ``shear_resample2_pallas_t_batched`` (warp pass 1), :func:`warp_x`
(kernel F) of ``shear_resample_pallas_t`` and
``shear_resample_pallas_t_batched`` with their mask (warp pass 2). With a
(B, 21) coefficient table, one row per volume, they are also the
counterparts of the traced-coefficient forms ``shear_resample2_pallas_t_dyn``
and ``shear_resample_pallas_t_dyn`` (and their mask_oob use) that
stabilize's per-timepoint batches run. A CPU tensor takes the plain version
in :mod:`biahub_tpu_torch.kernels.affine`; a CUDA tensor launches the kernel
or raises.
"""

from __future__ import annotations

import ctypes

import torch

from biahub_tpu_torch.kernels import _build
from biahub_tpu_torch.kernels.affine import N_COEFFS, warp_x_plain, warp_zy_plain

__all__ = ["warp_zy", "warp_x"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "warp_zy": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "warp_x_masked": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _F, _F, _P],
}
# One block per output row on gridDim.x.
_MAX_ROWS = 2**31 - 1


def _check(t: torch.Tensor, coeffs: torch.Tensor, what: str) -> int:
    """Checks a batch and its coefficients; returns the kernel's coefficient
    stride (0: one set for the batch, N_COEFFS: one row per volume)."""
    if t.ndim != 4 or t.dtype != torch.float32:
        raise ValueError(f"{what}: want a 4-d float32 tensor, got "
                         f"{tuple(t.shape)} {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: tensor must be contiguous")
    if (coeffs.shape not in ((N_COEFFS,), (t.shape[0], N_COEFFS))
            or coeffs.dtype != torch.float32 or coeffs.device != t.device
            or not coeffs.is_contiguous()):
        raise ValueError(f"{what}: coefficients must be a contiguous ({N_COEFFS},) "
                         f"or ({t.shape[0]}, {N_COEFFS}) float32 tensor on "
                         f"{t.device} (inplane_coefficients), got "
                         f"{tuple(coeffs.shape)} {coeffs.dtype} on {coeffs.device}")
    return 0 if coeffs.ndim == 1 else N_COEFFS


def _check_grid(batch: int, z_out: int, y_out: int, what: str) -> None:
    if batch * z_out * y_out > _MAX_ROWS:
        raise ValueError(f"{what}: {batch * z_out * y_out} output rows exceed "
                         "the kernel's grid")


def warp_zy(volumes: torch.Tensor, coeffs: torch.Tensor, out_zy,
            input_xzy: bool = False) -> torch.Tensor:
    """Kernel E: (B, Zi, Yi, Xi) float32, or (B, Xi, Zi, Yi) with
    ``input_xzy`` -> (B, Zo, Yo, Xi) float32, warp pass 1 with the
    coefficients of :func:`~biahub_tpu_torch.kernels.affine.
    inplane_coefficients`, one set for the batch or a (B, 21) table, one row
    per volume. Launches count as ``warp_zy``."""
    cstride = _check(volumes, coeffs, "warp_zy")
    z_out, y_out = (int(s) for s in out_zy)
    if not _build.on_card(volumes, "warp_zy"):
        return warp_zy_plain(volumes, coeffs, (z_out, y_out), input_xzy)
    batch = volumes.shape[0]
    if input_xzy:
        xi, zi, yi = volumes.shape[1:]
    else:
        zi, yi, xi = volumes.shape[1:]
    _check_grid(batch, z_out, y_out, "warp_zy")
    out = torch.empty((batch, z_out, y_out, xi), dtype=torch.float32,
                      device=volumes.device)
    if out.numel() == 0:
        return out
    lib = _build.library("warp", _SIGNATURES)
    with torch.cuda.device(volumes.device):
        rc = lib.warp_zy(_build.ptr(volumes), _build.ptr(out), _build.ptr(coeffs),
                         cstride, batch, zi, yi, xi, z_out, y_out, int(input_xzy),
                         _build.stream_of(volumes))
    _build.check(rc, lib, "warp_zy")
    _build.count_launch("warp_zy")
    return out


def warp_x(inter: torch.Tensor, coeffs: torch.Tensor, x_out: int, in_shape,
           fill: float = 0.0) -> torch.Tensor:
    """Kernel F: (B, Zo, Yo, Xi) float32 (kernel E's output) -> (B, Zo, Yo,
    Xo) float32, warp pass 2 and the exact constant-fill mask of the warp's
    logical ZYX input ``in_shape``, each volume's from its own coefficients
    with a (B, 21) table. Launches count as ``warp_x``."""
    cstride = _check(inter, coeffs, "warp_x")
    x_out = int(x_out)
    in_shape = tuple(int(s) for s in in_shape)
    if not _build.on_card(inter, "warp_x"):
        return warp_x_plain(inter, coeffs, x_out, in_shape, fill)
    batch, z_out, y_out, xi = inter.shape
    _check_grid(batch, z_out, y_out, "warp_x")
    out = torch.empty((batch, z_out, y_out, x_out), dtype=torch.float32,
                      device=inter.device)
    if out.numel() == 0:
        return out
    lib = _build.library("warp", _SIGNATURES)
    with torch.cuda.device(inter.device):
        rc = lib.warp_x_masked(_build.ptr(inter), _build.ptr(out), _build.ptr(coeffs),
                               cstride, batch, z_out, y_out, xi, x_out,
                               *(float(s - 1) for s in in_shape), float(fill),
                               _build.stream_of(inter))
    _build.check(rc, lib, "warp_x")
    _build.count_launch("warp_x")
    return out
