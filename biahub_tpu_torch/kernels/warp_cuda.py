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

Kernel E stages each output tile's input window in shared memory
(``csrc/warp.cu``); :func:`zy_window` is that window, computed as the
kernel computes it, and :func:`zy_staged` whether a tile takes it or its
direct gathers.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from biahub_tpu_torch.kernels import _build
from biahub_tpu_torch.kernels.affine import N_COEFFS, warp_x_plain, warp_zy_plain

__all__ = ["warp_zy", "warp_x", "E_TILES", "E_STAGE", "zy_window", "zy_staged"]

# Kernel E's output tile (T yo, W x) by input layout, and the floats one of
# its two window stages holds (csrc/warp.cu ETile, kStage).
E_TILES = {"zyx": (32, 64), "xzy": (64, 32)}
E_STAGE = 6144


def _coord(cr, r, co, o, tau):
    """warp.cu's coord(): (cr*r + co*o) + tau, each op rounded to float32."""
    f = np.float32
    return (f(cr) * f(r) + f(co) * f(o)) + f(tau)


def _tap_rows(coords, n: int) -> tuple[int, int]:
    """The rows the clamped taps of ``coords`` reach: their floors clamped
    to [-1, n] (taps()), the least and the greatest plus one, clamped to
    [0, n-1]."""
    floors = [int(min(max(np.floor(c), -1), n)) for c in coords]
    return min(max(min(floors), 0), n - 1), min(max(max(floors) + 1, 0), n - 1)


def zy_window(coeffs, zo: int, yo_range, x_range, in_zy) -> tuple[tuple[int, int],
                                                                  tuple[int, int], bool]:
    """Kernel E's window for the tile of outputs (zo, yo, x), yo and x in the
    inclusive ranges ``yo_range`` and ``x_range``, of a (Zi, Yi) input
    plane ``in_zy``, from one coefficient row: ((zlo, zhi), (ylo, yhi),
    finite), the z rows from the two x ends at zo and the y rows from the
    four (yo, x) corners, in the kernel's float32 operand order. Every tap
    of the tile lies inside when ``finite`` (the corners' coordinates are)."""
    mzz, zco, tz, b0, b1, b2 = (np.float32(c) for c in np.asarray(coeffs)[:6])
    zi, yi = in_zy
    zc = [_coord(mzz, zo, zco, x, tz) for x in x_range]
    yc = [_coord(b0, yo, b1, x, b2) for yo in yo_range for x in x_range]
    finite = bool(np.all(np.isfinite(zc + yc)))
    return _tap_rows(zc, zi), _tap_rows(yc, yi), finite


def zy_staged(window, layout: str, vec4: bool = True) -> bool:
    """Whether kernel E stages a tile's ``window`` (:func:`zy_window`) for
    the zyx or xzy read, or computes it with direct gathers. ``vec4``: the
    staged runs are copied 16 bytes at a time (the contiguous axis a
    multiple of 4), so the xzy read's y runs start at a multiple of 4 and
    take whole 4-float pieces."""
    (zlo, zhi), (ylo, yhi), finite = window
    nz, ny = zhi - zlo + 1, yhi - ylo + 1
    _, w = E_TILES[layout]
    if layout == "xzy":
        ry = ((yhi - (ylo & ~3)) // 4 + 1) * 4 if vec4 else ny
        need = nz * w * ry
    else:
        need = nz * ny * w
    return finite and need <= E_STAGE

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
