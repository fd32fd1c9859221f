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
import functools
from typing import NamedTuple

import numpy as np
import torch

from biahub_tpu_torch.kernels import _build
from biahub_tpu_torch.kernels.deskew import DeskewGeometry, deskew_plain

__all__ = ["deskew", "DeskewPlan", "deskew_plan", "scan_windows", "batch_chunks"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "deskew": [_P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _F, _F, _I, _I, _I, _I, _I, _P],
}
_MAX_GRID_Y = 65535
# csrc/deskew.cu: a staged row's floats (a block's strip of 128 yo, padded)
# and the widest chunk of xo.
PITCH, MAX_CHUNK = 132, 32
# A plan's shared memory: two blocks an SM where the windows allow, else one.
_SMEM_TWO, _SMEM_ONE = 113 * 1024, 227 * 1024


def scan_windows(geo: DeskewGeometry, cx: int) -> tuple[np.ndarray, np.ndarray]:
    """First scan row and row count of kernel D's window for each tilt
    output zo (every group's clamped zo is one of them) and chunk of ``cx``
    xo, (Y_in, chunks) each: the floor of the scan coordinate at the chunk's
    first and last xo, one more row for the second tap, clipped to [0,
    Z_in); computed in float32 in the kernel's order (csrc/deskew.cu
    scan_window)."""
    z_in, y_in, _ = geo.zyx_shape
    px, pxct, off = (np.float32(v) for v in (geo.px, geo.pxct, geo.offset))
    xa = np.arange(0, geo.x_out, cx)
    xb = np.minimum(xa + cx, geo.x_out) - 1
    zo = np.arange(y_in, dtype=np.float32)[:, None]

    def floor_at(xo):
        return np.floor((px * xo.astype(np.float32) - pxct * zo) + off).astype(np.int64)

    fa, fb = floor_at(xa), floor_at(xb)
    lo = np.maximum(np.minimum(fa, fb), 0)
    hi = np.minimum(np.maximum(fa, fb) + 1, z_in - 1)
    return lo, np.maximum(hi - lo + 1, 0)


class DeskewPlan(NamedTuple):
    """Kernel D's launch plan: xo a chunk, window rows per tilt row, bytes
    of shared memory."""

    cx: int
    rows: int
    smem: int


def _smem(avg: int, rows: int, cx: int) -> int:
    """csrc/deskew.cu's layout: two stages of avg windows of ``rows`` padded
    rows of the strip, a zero row, the windows' first rows, and a chunk's
    avg x cx taps (4 words each)."""
    return 4 * (2 * avg * rows * PITCH + PITCH + ((2 * avg + 3) & ~3) + 4 * avg * cx)


@functools.lru_cache(maxsize=16)
def deskew_plan(geo: DeskewGeometry) -> DeskewPlan:
    """The widest chunk of xo (a power of two up to 32) whose two stages of
    windows let two blocks share an SM (else one), and the window's rows at
    that chunk (the most any chunk and tilt row need, at least the 2 of one
    output's taps). The same plan serves both stores."""
    avg = geo.average_window
    for budget in (_SMEM_TWO, _SMEM_ONE):
        for cx in (MAX_CHUNK >> i for i in range(MAX_CHUNK.bit_length())):
            rows = max(2, int(scan_windows(geo, cx)[1].max()))
            smem = _smem(avg, rows, cx)
            if smem <= budget:
                return DeskewPlan(cx, rows, smem)
    raise ValueError(f"deskew: average_window {avg} leaves no room for the scan windows "
                     "in a block's shared memory")


def batch_chunks(batch: int, groups: int) -> list[tuple[int, int]]:
    """The volumes [start, stop) of each launch of kernel D for a batch of
    ``batch``: in order, at most 65535 // groups a launch (its grid's y is
    (volume, group)). Volumes share nothing, so the chunks give the bits of
    one launch."""
    per = _MAX_GRID_Y // groups
    if per < 1:
        raise ValueError(f"deskew: {groups} groups exceed the kernel's grid ({_MAX_GRID_Y})")
    return [(s, min(s + per, batch)) for s in range(0, batch, per)]


def deskew(volumes: torch.Tensor, geo: DeskewGeometry,
           out_layout: str = "zyx") -> torch.Tensor:
    """Kernel D: (B, Z, Y, X) float32 -> the deskew of each volume with
    ``geo`` (see :func:`deskew_geometry`), float32, stored as (B, groups,
    Y_out, X_out) for ``out_layout="zyx"`` or (B, X_out, groups, Y_out) for
    ``"xzy"``, the warp's ``input_xzy`` layout (which, as in the reference,
    requires ``geo.skip_flip``). A batch past the kernel's grid runs in
    chunks (:func:`batch_chunks`). Launches count as ``deskew`` and
    ``deskew_xzy``, one a chunk."""
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
    chunks = batch_chunks(batch, geo.groups)
    plan = deskew_plan(geo)
    groups, y_out, x_out = geo.out_shape
    shape = (batch, x_out, groups, y_out) if xzy else (batch, groups, y_out, x_out)
    out = torch.empty(shape, dtype=torch.float32, device=volumes.device)
    lib = _build.library("deskew", _SIGNATURES)
    z_in, y_in, x_in = geo.zyx_shape
    for start, stop in chunks:
        with torch.cuda.device(volumes.device):
            rc = lib.deskew(
                _build.ptr(volumes[start:stop]), _build.ptr(out[start:stop]), stop - start,
                z_in, y_in, x_in, geo.x_out, geo.average_window, geo.px, geo.pxct, geo.offset,
                1.0 / geo.average_window, int(geo.skip_flip), int(xzy), *plan,
                _build.stream_of(volumes),
            )
        _build.check(rc, lib, f"deskew ({plan}, volumes {start}:{stop})")
        _build.count_launch("deskew_xzy" if xzy else "deskew")
    return out
