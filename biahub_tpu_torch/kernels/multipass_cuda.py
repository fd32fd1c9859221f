"""Wrapper of the multipass warp's elementary pass, kernel H
(``resample_pass``, ``csrc/multipass.cu``).

Counterpart of ``biahub_tpu/kernels/pallas_resample.py``'s
``shear_resample_pallas`` (:201, one concrete coefficient set) and
``shear_resample_pallas_dyn`` (:312, coefficients per matrix): with a
coefficient table of one row set for the batch or one per volume, H serves
both. A CPU tensor takes :func:`~biahub_tpu_torch.kernels.multipass_warp.
resample_pass_plain`; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from biahub_tpu_torch.kernels import _build
from biahub_tpu_torch.kernels.multipass_warp import resample_pass_plain

__all__ = ["resample_pass"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"resample_pass": [_P, _P, _P] + [_I] * 9 + [_F, _P]}
# One block per frame row on gridDim.x.
_MAX_ROWS = 2**31 - 1


def resample_pass(frame: torch.Tensor, coeffs: torch.Tensor, slot: int, r: int, o: int,
                  order: int = 3, fill: float = 0.0,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel H: one pass over a (B, F0, F1, F2) float32 frame, resampling
    axis ``r`` at ``(cr*i_r + tau) + co*i_o`` (no ``co`` term when ``o ==
    r``) with (cr, co, tau) from row ``slot`` of ``coeffs``: float32 (S, 3)
    for the batch or (B, S, 3) per volume. ``order`` 3 (Catmull-Rom) or 1.
    ``out``: a frame-shaped buffer to write (not ``frame``); the plain
    version allocates its own. Launches count as ``resample_pass``."""
    if frame.ndim != 4 or frame.dtype != torch.float32 or not frame.is_contiguous():
        raise ValueError(f"resample_pass: want a contiguous (B, F0, F1, F2) float32 frame, "
                         f"got {tuple(frame.shape)} {frame.dtype}")
    if r not in (0, 1, 2) or o not in (0, 1, 2) or order not in (1, 3):
        raise ValueError(f"resample_pass: r, o in 0-2 and order 1 or 3, got {r}, {o}, {order}")
    batch = frame.shape[0]
    if (coeffs.dtype != torch.float32 or coeffs.device != frame.device
            or not coeffs.is_contiguous() or coeffs.shape[-1] != 3
            or coeffs.ndim not in (2, 3) or (coeffs.ndim == 3 and coeffs.shape[0] != batch)
            or not 0 <= slot < coeffs.shape[-2]):
        raise ValueError(f"resample_pass: coefficients must be a contiguous float32 (S, 3) "
                         f"or ({batch}, S, 3) tensor on {frame.device} with row {slot}, got "
                         f"{tuple(coeffs.shape)} {coeffs.dtype} on {coeffs.device}")
    if not _build.on_card(frame, "resample_pass"):
        return resample_pass_plain(frame, coeffs, slot, r, o, order, fill)
    if batch * frame.shape[1] * frame.shape[2] > _MAX_ROWS:
        raise ValueError("resample_pass: the frame's rows exceed the kernel's grid")
    if out is None:
        out = torch.empty_like(frame)
    elif (out.shape != frame.shape or out.dtype != frame.dtype or out.device != frame.device
          or not out.is_contiguous() or out.data_ptr() == frame.data_ptr()):
        raise ValueError("resample_pass: out must be another contiguous buffer of the "
                         "frame's shape, type and device")
    if frame.numel() == 0:
        return out
    cstride = 0 if coeffs.ndim == 2 else coeffs.shape[1] * 3
    lib = _build.library("multipass", _SIGNATURES)
    with torch.cuda.device(frame.device):
        rc = lib.resample_pass(_build.ptr(frame), _build.ptr(out), _build.ptr(coeffs), cstride,
                               int(slot), batch, *frame.shape[1:], int(r), int(o), int(order),
                               float(fill), _build.stream_of(frame))
    _build.check(rc, lib, "resample_pass")
    _build.count_launch("resample_pass")
    return out
