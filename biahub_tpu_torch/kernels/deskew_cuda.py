"""Wrapper of the deskew kernel (kernel D, ``csrc/deskew.cu``).

Counterpart of ``biahub_tpu/kernels/pallas_deskew.py``'s
``deskew_zyx_pallas_batched`` (:323, zyx layout) and ``deskew_zyx_pallas``
(:513): the scan-axis lerp and the slice averaging of a batch in one pass,
the unaveraged volume never stored. A CPU tensor takes
:func:`~biahub_tpu_torch.kernels.deskew.deskew_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from biahub_tpu_torch.kernels import _build
from biahub_tpu_torch.kernels.deskew import DeskewGeometry, deskew_plain

__all__ = ["deskew"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "deskew": [_P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _F, _F, _I, _P],
}
_MAX_GRID_Z = 65535


def deskew(volumes: torch.Tensor, geo: DeskewGeometry) -> torch.Tensor:
    """Kernel D: (B, Z, Y, X) float32 -> (B, groups, X, X_out) float32, the
    deskew of each volume with ``geo`` (see :func:`deskew_geometry`)."""
    if volumes.ndim != 4 or volumes.dtype != torch.float32:
        raise ValueError(f"deskew: want a (B, Z, Y, X) float32 tensor, got "
                         f"{tuple(volumes.shape)} {volumes.dtype}")
    if tuple(volumes.shape[1:]) != geo.zyx_shape:
        raise ValueError(f"deskew: volumes {tuple(volumes.shape)} do not match "
                         f"the geometry's {geo.zyx_shape}")
    if not volumes.is_contiguous():
        raise ValueError("deskew: tensor must be contiguous")
    if not _build.on_card(volumes, "deskew"):
        return deskew_plain(volumes, geo)
    batch = volumes.shape[0]
    if batch * geo.groups > _MAX_GRID_Z:
        raise ValueError(f"deskew: batch {batch} x {geo.groups} groups exceeds "
                         f"the kernel's grid ({_MAX_GRID_Z})")
    out = torch.empty((batch,) + geo.out_shape, dtype=torch.float32,
                      device=volumes.device)
    lib = _build.library("deskew", _SIGNATURES)
    z_in, y_in, x_in = geo.zyx_shape
    with torch.cuda.device(volumes.device):
        rc = lib.deskew(
            _build.ptr(volumes), _build.ptr(out), batch, z_in, y_in, x_in,
            geo.x_out, geo.average_window, geo.px, geo.pxct, geo.offset,
            1.0 / geo.average_window, int(geo.skip_flip),
            _build.stream_of(volumes),
        )
    _build.check(rc, lib, "deskew")
    _build.count_launch("deskew")
    return out
