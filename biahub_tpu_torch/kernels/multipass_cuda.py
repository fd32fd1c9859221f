"""Wrappers of the multipass warp's elementary pass, kernel H
(``resample_pass``), and of its VJP, kernels I (``resample_pass_deriv``)
and J (``resample_pass_adjoint``), all in ``csrc/multipass.cu``.

Counterpart of ``biahub_tpu/kernels/pallas_resample.py``'s
``shear_resample_pallas`` (:201, one concrete coefficient set),
``shear_resample_pallas_dyn`` (:312, coefficients per matrix),
``shear_resample_deriv_dyn`` (:1340) and ``shear_resample_adjoint_dyn``
(:1348): with a coefficient table of one row set for the batch or one per
volume, each kernel serves both. A CPU tensor takes the plain version in
:mod:`~biahub_tpu_torch.kernels.multipass_warp`; a CUDA tensor launches the
kernel or raises.

Kernel J gathers each output over the q whose taps reach it, from a tile's
q range staged in shared memory (``csrc/multipass.cu``):
:func:`adjoint_q_range` is that range, computed as the kernel computes it.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from biahub_tpu_torch.kernels import _build
from biahub_tpu_torch.kernels.multipass_warp import (
    resample_pass_adjoint_plain,
    resample_pass_deriv_plain,
    resample_pass_plain,
)

__all__ = ["resample_pass", "resample_pass_deriv", "resample_pass_adjoint", "ADJOINT_TILES",
           "adjoint_max_q", "adjoint_q_range"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "resample_pass": [_P, _P, _P] + [_I] * 9 + [_F, _P],
    "resample_pass_deriv": [_P, _P, _P] + [_I] * 9 + [_P, _P],
    "resample_pass_adjoint": [_P, _P, _P] + [_I] * 9 + [_P],
}
# One block per frame row on gridDim.x.
_MAX_ROWS = 2**31 - 1
# Kernel J's tiles (csrc/multipass.cu): p along r and lanes along the
# frame's last axis, for r = 0 or 1 and for r = 2.
ADJOINT_TILES = {0: (32, 32), 1: (32, 32), 2: (1024, 1)}


def adjoint_max_q(r: int, o: int) -> int:
    """The longest q range kernel J stages for a tile of pass (r, o); a
    longer one takes the per-voxel code."""
    if r == 2:
        return 1536
    return 48 if o == 2 else 96


def _band(order: int) -> tuple[int, int]:
    return (0, 1) if order == 1 else (-1, 2)


def adjoint_q_range(cr, co, tau, shear: bool, o_range, p_range, order: int,
                    size_r: int) -> tuple[int, int] | None:
    """Kernel J's q range [q0, q1] of a tile: the q whose coordinate lies in
    [p_lo - kmax - 1, p_hi - kmin + 1] for the pass's other index in the
    inclusive ``o_range``, solved in double with 1/cr at the ends, widened
    by one q and clipped to the axis (empty when q1 < q0); None when it
    cannot be solved (cr = 0, not finite), where the tile takes the
    per-voxel code."""
    kmin, kmax = _band(order)
    cr, co, tau = (float(np.float32(v)) for v in (cr, co, tau))
    rcp = 1.0 / cr if cr else math.inf
    qs = []
    for i_o in o_range:
        base = tau + co * float(i_o) if shear else tau
        qs += [(float(p_range[0] - kmax - 1) - base) * rcp,
               (float(p_range[1] - kmin + 1) - base) * rcp]
    lo, hi = min(qs), max(qs)
    if not (math.isfinite(lo) and math.isfinite(hi)):
        return None
    return int(max(math.floor(lo) - 1.0, 0.0)), int(min(math.ceil(hi) + 1.0, size_r - 1.0))


def _check(frame: torch.Tensor, coeffs: torch.Tensor, slot: int, r: int, o: int, order: int,
           what: str) -> None:
    if frame.ndim != 4 or frame.dtype != torch.float32 or not frame.is_contiguous():
        raise ValueError(f"{what}: want a contiguous (B, F0, F1, F2) float32 frame, "
                         f"got {tuple(frame.shape)} {frame.dtype}")
    if r not in (0, 1, 2) or o not in (0, 1, 2) or order not in (1, 3):
        raise ValueError(f"{what}: r, o in 0-2 and order 1 or 3, got {r}, {o}, {order}")
    batch = frame.shape[0]
    if (coeffs.dtype != torch.float32 or coeffs.device != frame.device
            or not coeffs.is_contiguous() or coeffs.shape[-1] != 3
            or coeffs.ndim not in (2, 3) or (coeffs.ndim == 3 and coeffs.shape[0] != batch)
            or not 0 <= slot < coeffs.shape[-2]):
        raise ValueError(f"{what}: coefficients must be a contiguous float32 (S, 3) "
                         f"or ({batch}, S, 3) tensor on {frame.device} with row {slot}, got "
                         f"{tuple(coeffs.shape)} {coeffs.dtype} on {coeffs.device}")


def _on_card(frame: torch.Tensor, what: str) -> bool:
    if not _build.on_card(frame, what):
        return False
    if frame.shape[0] * frame.shape[1] * frame.shape[2] > _MAX_ROWS:
        raise ValueError(f"{what}: the frame's rows exceed the kernel's grid")
    return True


def _launch(entry: str, *args) -> None:
    lib = _build.library("multipass", _SIGNATURES)
    rc = getattr(lib, entry)(*args)
    _build.check(rc, lib, entry)
    _build.count_launch(entry)


def _out_buffer(out: torch.Tensor | None, frame: torch.Tensor, what: str) -> torch.Tensor:
    if out is None:
        return torch.empty_like(frame)
    if (out.shape != frame.shape or out.dtype != frame.dtype or out.device != frame.device
            or not out.is_contiguous() or out.data_ptr() == frame.data_ptr()):
        raise ValueError(f"{what}: out must be another contiguous buffer of the "
                         "frame's shape, type and device")
    return out


def _cstride(coeffs: torch.Tensor) -> int:
    return 0 if coeffs.ndim == 2 else coeffs.shape[1] * 3


def resample_pass(frame: torch.Tensor, coeffs: torch.Tensor, slot: int, r: int, o: int,
                  order: int = 3, fill: float = 0.0,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel H: one pass over a (B, F0, F1, F2) float32 frame, resampling
    axis ``r`` at ``(cr*i_r + tau) + co*i_o`` (no ``co`` term when ``o ==
    r``) with (cr, co, tau) from row ``slot`` of ``coeffs``: float32 (S, 3)
    for the batch or (B, S, 3) per volume. ``order`` 3 (Catmull-Rom) or 1.
    ``out``: a frame-shaped buffer to write (not ``frame``); the plain
    version allocates its own. Launches count as ``resample_pass``."""
    _check(frame, coeffs, slot, r, o, order, "resample_pass")
    if not _on_card(frame, "resample_pass"):
        return resample_pass_plain(frame, coeffs, slot, r, o, order, fill)
    out = _out_buffer(out, frame, "resample_pass")
    if frame.numel() == 0:
        return out
    with torch.cuda.device(frame.device):
        _launch("resample_pass", _build.ptr(frame), _build.ptr(out), _build.ptr(coeffs),
                _cstride(coeffs), int(slot), frame.shape[0], *frame.shape[1:], int(r), int(o),
                int(order), float(fill), _build.stream_of(frame))
    return out


def resample_pass_deriv(frame: torch.Tensor, ybar: torch.Tensor, coeffs: torch.Tensor,
                        slot: int, r: int, o: int, order: int = 3) -> torch.Tensor:
    """Kernel I: the cotangents of pass ``slot``'s (cr, co, tau) from the
    pass input ``frame`` and the output cotangent ``ybar`` (both (B, F0, F1,
    F2) float32) -> (B, 3) float64, one row per volume. The kernel writes a
    float64 partial per frame row; one sum over them gives the result.
    Launches count as ``resample_pass_deriv``."""
    _check(frame, coeffs, slot, r, o, order, "resample_pass_deriv")
    if (ybar.shape != frame.shape or ybar.dtype != frame.dtype or ybar.device != frame.device
            or not ybar.is_contiguous()):
        raise ValueError("resample_pass_deriv: ybar must be a contiguous tensor of the "
                         "frame's shape, type and device")
    if not _on_card(frame, "resample_pass_deriv"):
        return resample_pass_deriv_plain(frame, ybar, coeffs, slot, r, o, order)
    batch, f0, f1, f2 = frame.shape
    partials = torch.empty((batch, f0 * f1, 3), dtype=torch.float64, device=frame.device)
    if frame.numel() == 0:
        return partials.sum(1)
    with torch.cuda.device(frame.device):
        _launch("resample_pass_deriv", _build.ptr(frame), _build.ptr(ybar), _build.ptr(coeffs),
                _cstride(coeffs), int(slot), batch, f0, f1, f2, int(r), int(o), int(order),
                _build.ptr(partials), _build.stream_of(frame))
    return partials.sum(1)


def resample_pass_adjoint(ybar: torch.Tensor, coeffs: torch.Tensor, slot: int, r: int, o: int,
                          order: int = 3, out: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel J: the cotangent of pass ``slot``'s input from its output
    cotangent ``ybar`` ((B, F0, F1, F2) float32, the same shape), the exact
    transpose of H in the data. ``out``: a frame-shaped buffer to write (not
    ``ybar``). Launches count as ``resample_pass_adjoint``."""
    _check(ybar, coeffs, slot, r, o, order, "resample_pass_adjoint")
    if not _on_card(ybar, "resample_pass_adjoint"):
        return resample_pass_adjoint_plain(ybar, coeffs, slot, r, o, order)
    out = _out_buffer(out, ybar, "resample_pass_adjoint")
    if ybar.numel() == 0:
        return out
    with torch.cuda.device(ybar.device):
        _launch("resample_pass_adjoint", _build.ptr(ybar), _build.ptr(out), _build.ptr(coeffs),
                _cstride(coeffs), int(slot), ybar.shape[0], *ybar.shape[1:], int(r), int(o),
                int(order), _build.stream_of(ybar))
    return out
