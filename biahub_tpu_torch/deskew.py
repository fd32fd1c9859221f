"""deskew on arrays in memory.

Counterpart of the compute of ``biahub_tpu/deskew.py::deskew`` (:143-296)
without its plate I/O: every (t, c) volume of a (T, C, Z, Y, X) array is
deskewed by kernel D in batches, its overhang filled where the settings ask
(``kernels/deskew.py::fill_overhang``), in the standard frame (the
reference deskews with ``skip_flip`` and flips Y on the host, ``post_fetch``
at :292; here kernel D reads the coverslip axis reversed, which gives the
same values).

When one volume and its output exceed the batch budget (compared as the
reference does, :222-223), each volume is deskewed in input-X slabs (=
output-Y slabs: the scan resample involves only the scan and tilt axes, so
the split is exact) without the fill, and the fill then runs in output-Y
slabs with a 4-voxel halo and the mean from a first sweep
(:func:`fill_overhang_chunked`, the reference's ``_fill_overhang_chunked``,
:103-140). That result is in host memory, as the reference's is on its
plate.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from biahub_tpu_torch.convert import deskew_settings_from_reference
from biahub_tpu_torch.device import as_tensor, resolve_device
from biahub_tpu_torch.estimate_stabilization import DEFAULT_MAX_BATCH_BYTES
from biahub_tpu_torch.kernels.deskew import (
    deskew_geometry,
    deskew_zyx,
    fill_overhang_,
    get_deskewed_data_shape,
    overhang_fill_value,
    overhang_mask,
)
from biahub_tpu_torch.kernels.deskew_cuda import deskew

__all__ = ["deskew_arrays", "deskew_slabbed", "fill_overhang_chunked"]

# The dilation reaches 3 voxels: a 4-voxel halo gives each slab the mask of
# the whole volume.
HALO = 4


def deskew_slabbed(vol, dk: dict, x_chunk: int, device: torch.device) -> torch.Tensor:
    """Deskew one (Z, Y, X) volume in input-X slabs of ``x_chunk`` ->
    (groups, Y_out, X_out) float32 in host memory, the standard frame and no
    fill: each slab goes to the device alone, and its output (Y reversed
    within the slab) lands at Y_out ``[X - x1, X - x0)``. ``dk``: the
    deskew's keyword arguments (``convert.deskew_settings_from_reference``)."""
    Z, Y, X = vol.shape
    out_zyx, _ = get_deskewed_data_shape((Z, Y, X), dk["ls_angle_deg"], dk["px_to_scan_ratio"],
                                         dk["keep_overhang"], dk["average_window"])
    out = torch.empty(out_zyx, dtype=torch.float32)
    for x0 in range(0, X, x_chunk):
        x1 = min(x0 + x_chunk, X)
        slab = deskew_zyx(as_tensor(vol[:, :, x0:x1], device), dk["ls_angle_deg"],
                          dk["px_to_scan_ratio"], dk["keep_overhang"], dk["average_window"],
                          device=device)
        out[:, X - x1:X - x0, :] = slab.cpu()
    return out


def _center(vol: torch.Tensor, y0: int, y1: int, device: torch.device):
    """The slab ``[y0, y1)`` of ``vol`` on the device, and its mask from the
    slab widened by the halo (clipped to the volume)."""
    lo, hi = max(0, y0 - HALO), min(vol.shape[1], y1 + HALO)
    mask = overhang_mask(as_tensor(vol[:, lo:hi], device))
    return as_tensor(vol[:, y0:y1], device), mask[:, y0 - lo:y1 - lo]


def fill_overhang_chunked(vol: torch.Tensor, fill, y_chunk: int,
                          device: torch.device) -> torch.Tensor:
    """``fill_overhang`` of one deskewed (Z, Y, X) volume in host memory, in
    place, in Y slabs of ``y_chunk`` with a 4-voxel halo: a first sweep sums
    the voxels outside each slab's mask for the mean (``fill == "mean"``),
    a second fills each slab, reading it after the previous slab's write as
    the reference does. ``fill``: ``"mean"`` or a float."""
    Y = vol.shape[1]
    if fill == "mean":
        total, count = 0.0, 0
        for y0 in range(0, Y, y_chunk):
            slab, mask = _center(vol, y0, min(y0 + y_chunk, Y), device)
            valid = ~mask
            total += float(torch.where(valid, slab, 0.0).sum(dtype=torch.float64))
            count += int(valid.sum())
        value = float(np.float32(total / max(count, 1)))
    else:
        value = float(fill)
    for y0 in range(0, Y, y_chunk):
        y1 = min(y0 + y_chunk, Y)
        slab, mask = _center(vol, y0, y1, device)
        vol[:, y0:y1] = torch.where(mask, torch.tensor(value, device=device), slab).cpu()
    return vol


def deskew_arrays(
    tczyx,
    settings: dict,
    max_batch_bytes: int = DEFAULT_MAX_BATCH_BYTES,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """Deskew each (t, c) volume of a (T, C, Z, Y, X) array -> (T, C,
    groups, Y_out, X_out) float32. ``settings``: the deskew verb's settings
    as a dict (``settings/example_deskew_settings.yml`` as loaded). In
    budget, batches of as many volumes as ``max_batch_bytes`` holds (input
    and output counted) run through kernel D and the fill, on the device;
    over it, each volume in X slabs and a chunked fill, in host memory."""
    dev = resolve_device(device)
    dk = deskew_settings_from_reference(settings)
    T, C, Z, Y, X = tczyx.shape
    out_zyx, _ = get_deskewed_data_shape((Z, Y, X), dk["ls_angle_deg"], dk["px_to_scan_ratio"],
                                         dk["keep_overhang"], dk["average_window"])
    fill = overhang_fill_value(dk["keep_overhang"], dk["overhang_fill"])
    volume_bytes = 4 * (Z * Y * X + int(np.prod(out_zyx)))
    units = [(t, c) for t in range(T) for c in range(C)]
    if volume_bytes > max_batch_bytes:
        n_splits = -(-volume_bytes // max_batch_bytes)
        x_chunk = max(1, -(-X // int(n_splits)))
        print(f"Volume exceeds the device batch budget; deskewing in {n_splits} X-slabs of "
              f"{x_chunk}", file=sys.stderr)
        out = torch.empty((T, C) + tuple(out_zyx), dtype=torch.float32)
        for t, c in units:
            out[t, c] = deskew_slabbed(tczyx[t, c], dk, x_chunk, dev)
            if fill is not None:
                fill_overhang_chunked(out[t, c], fill, x_chunk, dev)
        return out
    geo = deskew_geometry((Z, Y, X), dk["ls_angle_deg"], dk["px_to_scan_ratio"],
                          dk["keep_overhang"], dk["average_window"])
    out = torch.empty((T, C) + tuple(out_zyx), dtype=torch.float32, device=dev)
    flat = out.view((T * C,) + tuple(out_zyx))
    step = max(1, min(len(units), max_batch_bytes // volume_bytes))
    for i in range(0, len(units), step):
        batch = units[i:i + step]
        vols = torch.stack([as_tensor(tczyx[t, c], dev) for t, c in batch])
        flat[i:i + len(batch)] = fill_overhang_(deskew(vols, geo), fill)
    return out
