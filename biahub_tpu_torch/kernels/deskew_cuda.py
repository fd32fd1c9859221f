"""Wrapper of the deskew kernel (kernel D, ``csrc/deskew.cu``).

Counterpart of ``biahub_tpu/kernels/pallas_deskew.py``'s
``deskew_zyx_pallas_batched`` (:323) and ``deskew_zyx_pallas`` (:513), in
both of their ``out_layout``s: the scan-axis lerp and the slice averaging of
a batch in one pass, the unaveraged volume never stored. A CPU tensor takes
:func:`~biahub_tpu_torch.kernels.deskew.deskew_plain` (permuted for
``"xzy"``).
"""

from __future__ import annotations

import ctypes

import torch

from biahub_tpu_torch.kernels import _build
from biahub_tpu_torch.kernels.deskew import DeskewGeometry, deskew_plain

__all__ = ["deskew"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "deskew": [_P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _F, _F, _I, _I, _P],
}
_MAX_GRID_Z = 65535


def deskew(volumes: torch.Tensor, geo: DeskewGeometry,
           out_layout: str = "zyx") -> torch.Tensor:
    """Kernel D: (B, Z, Y, X) float32 -> the deskew of each volume with
    ``geo`` (see :func:`deskew_geometry`), float32, stored as (B, groups,
    Y_out, X_out) for ``out_layout="zyx"`` or (B, X_out, groups, Y_out) for
    ``"xzy"``, the warp's ``input_xzy`` layout (which, as in the reference,
    requires ``geo.skip_flip``). Launches count as ``deskew`` and
    ``deskew_xzy``."""
    if out_layout not in ("zyx", "xzy"):
        raise ValueError(f"deskew: out_layout must be 'zyx' or 'xzy', not {out_layout!r}")
    if out_layout == "xzy" and not geo.skip_flip:
        raise ValueError("deskew: out_layout='xzy' requires skip_flip=True")
    if volumes.ndim != 4 or volumes.dtype != torch.float32:
        raise ValueError(f"deskew: want a (B, Z, Y, X) float32 tensor, got "
                         f"{tuple(volumes.shape)} {volumes.dtype}")
    if tuple(volumes.shape[1:]) != geo.zyx_shape:
        raise ValueError(f"deskew: volumes {tuple(volumes.shape)} do not match "
                         f"the geometry's {geo.zyx_shape}")
    if not volumes.is_contiguous():
        raise ValueError("deskew: tensor must be contiguous")
    xzy = out_layout == "xzy"
    if not _build.on_card(volumes, "deskew"):
        out = deskew_plain(volumes, geo)
        return out.permute(0, 3, 1, 2).contiguous() if xzy else out
    batch = volumes.shape[0]
    if batch * geo.groups > _MAX_GRID_Z:
        raise ValueError(f"deskew: batch {batch} x {geo.groups} groups exceeds "
                         f"the kernel's grid ({_MAX_GRID_Z})")
    groups, y_out, x_out = geo.out_shape
    shape = (batch, x_out, groups, y_out) if xzy else (batch, groups, y_out, x_out)
    out = torch.empty(shape, dtype=torch.float32, device=volumes.device)
    lib = _build.library("deskew", _SIGNATURES)
    z_in, y_in, x_in = geo.zyx_shape
    with torch.cuda.device(volumes.device):
        rc = lib.deskew(
            _build.ptr(volumes), _build.ptr(out), batch, z_in, y_in, x_in,
            geo.x_out, geo.average_window, geo.px, geo.pxct, geo.offset,
            1.0 / geo.average_window, int(geo.skip_flip), int(xzy),
            _build.stream_of(volumes),
        )
    _build.check(rc, lib, "deskew")
    _build.count_launch("deskew_xzy" if xzy else "deskew")
    return out
