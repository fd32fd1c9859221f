"""Light-sheet deskew: shear scan-frame ZYX stacks into the coverslip frame.

Counterpart of ``biahub_tpu/kernels/deskew.py``. Two of the three input axes
map to output axes by a transpose and flips; only the scan axis needs a
fractional resample, a two-tap lerp, and the output is then mean-pooled in
groups of ``average_window`` slices along Z with the tail group
edge-padded. :func:`deskew_plain` is the plain PyTorch version of that (the
lerp gather of the reference's XLA route); the CUDA kernel that computes the
same in one pass is wrapped in :mod:`biahub_tpu_torch.kernels.deskew_cuda`.

With ``keep_overhang=True`` and a non-zero ``overhang_fill``, the deskewed
volume's zero-padded overhang is then filled (:func:`fill_overhang`, the
reference's :125-160): the zero mask dilated by three 3x3x3 max-pools,
filled with a constant or with the mean of the voxels outside it. That is
plain PyTorch after kernel D, as the reference runs it after its Pallas
kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from biahub_tpu_torch.device import as_tensor, resolve_device

__all__ = [
    "get_deskewed_data_shape",
    "deskew_transform_matrix",
    "uncentered_deskew_matrix",
    "average_n_slices",
    "DeskewGeometry",
    "deskew_geometry",
    "deskew_plain",
    "overhang_mask",
    "fill_overhang",
    "overhang_fill_value",
    "fill_overhang_",
    "deskew_zyx",
    "deskew_zyx_batched",
    "deskew_czyx",
]


def _averaged_shape(shape: tuple[int, ...], window: int) -> tuple[int, ...]:
    return (int(np.ceil(shape[0] / window)),) + tuple(shape[1:])


def get_deskewed_data_shape(
    raw_data_shape: tuple[int, int, int],
    ls_angle_deg: float,
    px_to_scan_ratio: float,
    keep_overhang: bool,
    average_n_slices: int = 1,
    pixel_size_um: float = 1,
) -> tuple[tuple[int, int, int], tuple[float, float, float]]:
    """Output (Z, Y, X) shape and voxel size of the deskewed volume (a copy
    of the reference's shape math).

    With keep_overhang the output X spans the whole tilted parallelepiped;
    without it only the fully-sampled cuboid interior is kept.
    """
    theta = ls_angle_deg * np.pi / 180
    st, ct = np.sin(theta), np.cos(theta)
    Z, Y, X = raw_data_shape

    if keep_overhang:
        Xp = int(np.ceil((Z / px_to_scan_ratio) + (Y * ct)))
    else:
        Xp = int(np.ceil((Z / px_to_scan_ratio) - (Y * ct)))
        if Xp <= 0:
            raise ValueError(
                f"Dataset contains only overhang when keep_overhang=False. "
                f"Computed Xp={Xp} <= 0. Either set keep_overhang=True or use a "
                f"dataset with non-overhang content."
            )

    output_shape = (Y, X, Xp)
    voxel_size = (average_n_slices * st * pixel_size_um, pixel_size_um, pixel_size_um)
    return _averaged_shape(output_shape, average_n_slices), voxel_size


def deskew_transform_matrix(ls_angle_deg: float, px_to_scan_ratio: float) -> np.ndarray:
    """Centered output->input deskew affine: row 0 mixes z_out and x_out into
    the scan axis; rows 1-2 are pure flips of the remaining axes."""
    ct = np.cos(ls_angle_deg * np.pi / 180)
    return np.array(
        [
            [-px_to_scan_ratio * ct, 0, px_to_scan_ratio, 0],
            [-1, 0, 0, 0],
            [0, -1, 0, 0],
            [0, 0, 0, 1],
        ]
    )


def uncentered_deskew_matrix(raw_shape: tuple[int, int, int], output_shape: tuple[int, int, int],
                             ls_angle_deg: float, px_to_scan_ratio: float) -> np.ndarray:
    """:func:`deskew_transform_matrix` in index coordinates (the convention
    of ``affine_warp_zyx`` and scipy): the centres of both frames folded
    into the translation column (the reference's
    ``uncentered_deskew_matrix``, kernels/deskew.py:90)."""
    m = deskew_transform_matrix(ls_angle_deg, px_to_scan_ratio)
    c_in = (np.asarray(raw_shape, dtype=np.float64) - 1) / 2
    c_out = (np.asarray(output_shape, dtype=np.float64) - 1) / 2
    out = np.eye(4)
    out[:3, :3] = m[:3, :3]
    out[:3, 3] = c_in - m[:3, :3] @ c_out
    return out


def average_n_slices(data: torch.Tensor, window: int = 1) -> torch.Tensor:
    """Mean-pool the first axis in groups of ``window``, edge-padding the tail."""
    if window == 1:
        return data
    remainder = data.shape[0] % window
    if remainder > 0:
        pad = data[-1:].expand((window - remainder,) + tuple(data.shape[1:]))
        data = torch.cat([data, pad], dim=0)
    grouped = data.reshape((data.shape[0] // window, window) + tuple(data.shape[1:]))
    return grouped.mean(dim=1)


class DeskewGeometry(NamedTuple):
    """Per-acquisition deskew constants. ``px``, ``pxct`` and ``offset`` are
    the Python floats of the reference (deskew.py:240-242); both versions
    cast them to float32 before use."""

    zyx_shape: tuple[int, int, int]
    x_out: int
    average_window: int
    skip_flip: bool
    px: float
    pxct: float
    offset: float

    @property
    def groups(self) -> int:
        return -(-self.zyx_shape[1] // self.average_window)

    @property
    def out_shape(self) -> tuple[int, int, int]:
        """(groups, Y_out, X_out) of one deskewed volume."""
        return self.groups, self.zyx_shape[2], self.x_out


def deskew_geometry(
    zyx_shape,
    ls_angle_deg: float,
    px_to_scan_ratio: float,
    keep_overhang: bool,
    average_window: int = 1,
    skip_flip: bool = False,
) -> DeskewGeometry:
    Z_in, Y_in, X_in = (int(s) for s in zyx_shape)
    output_shape, _ = get_deskewed_data_shape(
        (Z_in, Y_in, X_in), ls_angle_deg, px_to_scan_ratio, keep_overhang
    )
    Z_out, X_out = Y_in, output_shape[2]
    ct = float(np.cos(ls_angle_deg * np.pi / 180))
    px = float(px_to_scan_ratio)
    offset = px * ct * (Z_out - 1) / 2 - px * (X_out - 1) / 2 + (Z_in - 1) / 2
    return DeskewGeometry((Z_in, Y_in, X_in), X_out, int(average_window),
                          bool(skip_flip), px, px * ct, offset)


def _deskew_one(raw: torch.Tensor, geo: DeskewGeometry) -> torch.Tensor:
    Z_in, Y_in, X_in = geo.zyx_shape
    Z_out, X_out = Y_in, geo.x_out
    dev = raw.device
    # (Z_scan, Y_tilt, X_cover) -> (Z_out, scan, Y_out): tilt rows reversed,
    # and the coverslip axis too unless skip_flip.
    data = torch.flip(raw.to(torch.float32).permute(1, 0, 2),
                      dims=(0,) if geo.skip_flip else (0, 2))

    def f32(v: float) -> torch.Tensor:
        return torch.tensor(v, dtype=torch.float32, device=dev)

    z_idx = torch.arange(Z_out, dtype=torch.float32, device=dev)[:, None]
    x_idx = torch.arange(X_out, dtype=torch.float32, device=dev)[None, :]
    in_z = f32(geo.px) * x_idx - f32(geo.pxct) * z_idx + f32(geo.offset)

    i0f = torch.floor(in_z)
    frac = (in_z - i0f)[:, :, None]
    i0 = i0f.to(torch.int64)
    i1 = i0 + 1
    rows = torch.arange(Z_out, device=dev)[:, None]
    v0 = data[rows, i0.clamp(0, Z_in - 1)]  # (Z_out, X_out, Y_out)
    v1 = data[rows, i1.clamp(0, Z_in - 1)]
    v0 = torch.where(((i0 >= 0) & (i0 < Z_in))[:, :, None], v0, 0.0)
    v1 = torch.where(((i1 >= 0) & (i1 < Z_in))[:, :, None], v1, 0.0)
    deskewed = (v0 * (1.0 - frac) + v1 * frac).permute(0, 2, 1)
    return average_n_slices(deskewed, geo.average_window)


def deskew_plain(volumes: torch.Tensor, geo: DeskewGeometry) -> torch.Tensor:
    """Plain PyTorch deskew of a (B, Z, Y, X) batch -> (B, groups, Y_out,
    X_out) float32, one volume at a time (the gather's index tensors are
    (Z_out, X_out, Y_out) per volume)."""
    return torch.stack([_deskew_one(v, geo) for v in volumes])


def overhang_mask(data: torch.Tensor, dilation_iterations: int = 3) -> torch.Tensor:
    """Bool mask of ``data == 0`` dilated by ``dilation_iterations`` 3x3x3
    max-pools with SAME padding and a -inf border (the reference's :125-138)
    over the last three axes. Those pools compose into one box of half-width
    ``dilation_iterations`` clipped to the volume, computed exactly on the
    boolean mask as one dilation per axis, each an OR of shifted copies
    whose reach doubles (1, then 2 voxels for 3): cheaper on the card than
    one 7^3 max-pool, the reference's three 3^3 pools or three 1-D max-pools
    (PERF.md, PR 16)."""
    mask = data == 0
    for axis in range(mask.ndim - 3, mask.ndim):
        n, reach = mask.shape[axis], 0
        while reach < dilation_iterations and reach < n - 1:
            step = min(reach + 1, dilation_iterations - reach, n - 1)
            grown = mask.clone()
            grown.narrow(axis, step, n - step).logical_or_(mask.narrow(axis, 0, n - step))
            grown.narrow(axis, 0, n - step).logical_or_(mask.narrow(axis, step, n - step))
            mask, reach = grown, reach + step
    return mask


def fill_overhang(data: torch.Tensor, fill_value: float | None = None,
                  dilation_iterations: int = 3) -> torch.Tensor:
    """``data`` (Z, Y, X) float32 with :func:`overhang_mask`'s voxels
    replaced by ``fill_value``, or by the mean of the voxels outside the mask
    when it is None (the reference's :141-160). The mean's sum runs in
    float64 (the reference's in float32) and is rounded to float32 once."""
    dilated = overhang_mask(data, dilation_iterations)
    if fill_value is None:
        valid = ~dilated
        total = torch.where(valid, data, 0.0).sum(dtype=torch.float64)
        count = max(int(valid.sum()), 1)
        fill = (total / count).to(torch.float32)
    else:
        fill = torch.tensor(float(fill_value), dtype=torch.float32, device=data.device)
    return torch.where(dilated, fill, data)


def overhang_fill_value(keep_overhang: bool, overhang_fill: str | float):
    """The fill a deskew with these settings applies: None when none acts
    (the overhang is cut, or the fill is 0), else ``"mean"`` or the float
    (the reference's condition, kernels/deskew.py:222)."""
    if not keep_overhang or overhang_fill == 0:
        return None
    return "mean" if overhang_fill == "mean" else float(overhang_fill)


def fill_overhang_(volumes: torch.Tensor, fill) -> torch.Tensor:
    """:func:`fill_overhang` of each volume of a (B, Z, Y, X) batch in place;
    ``fill`` as :func:`overhang_fill_value` gives it (None: no change)."""
    if fill is not None:
        for v in volumes:
            v.copy_(fill_overhang(v, None if fill == "mean" else fill))
    return volumes


def deskew_zyx_batched(
    volumes,
    ls_angle_deg: float,
    px_to_scan_ratio: float,
    keep_overhang: bool,
    average_window: int = 1,
    overhang_fill: str | float = 0,
    skip_flip: bool = False,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """Deskew a (B, Z, Y, X) batch -> (B, groups, Y_out, X_out) float32.

    Input axes: 0 = scan, 1 = tilted, 2 = coverslip plane. Output axes: Z
    (coverslip normal, averaged in groups), Y (the input's coverslip axis),
    X (the scan axis). ``skip_flip`` returns Y reversed, for callers that
    flip on the host or fold the flip into a later warp. With
    ``keep_overhang`` a non-zero ``overhang_fill`` (``"mean"`` or a float)
    fills each volume's overhang after kernel D (:func:`fill_overhang`).
    """
    from biahub_tpu_torch.kernels.deskew_cuda import deskew

    dev = resolve_device(device)
    data = as_tensor(volumes, dev)
    geo = deskew_geometry(data.shape[1:], ls_angle_deg, px_to_scan_ratio,
                          keep_overhang, average_window, skip_flip)
    return fill_overhang_(deskew(data, geo),
                          overhang_fill_value(keep_overhang, overhang_fill))


def deskew_zyx(
    raw_data,
    ls_angle_deg: float,
    px_to_scan_ratio: float,
    keep_overhang: bool,
    average_window: int = 1,
    overhang_fill: str | float = 0,
    skip_flip: bool = False,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """Deskew one ZYX volume -> (groups, Y_out, X_out) float32 (see
    :func:`deskew_zyx_batched`)."""
    dev = resolve_device(device)
    return deskew_zyx_batched(
        as_tensor(raw_data, dev)[None], ls_angle_deg, px_to_scan_ratio,
        keep_overhang, average_window, overhang_fill, skip_flip, dev,
    )[0]


def deskew_czyx(
    czyx,
    ls_angle_deg: float,
    px_to_scan_ratio: float,
    keep_overhang: bool,
    average_window: int = 1,
    overhang_fill: str | float = 0,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """Deskew each channel of a (C, Z, Y, X) volume -> (C, groups, Y_out,
    X_out) float32: :func:`deskew_zyx_batched` with the channels as the
    batch (the reference's ``deskew_czyx``, kernels/deskew.py:336, a vmap
    of ``deskew_zyx``)."""
    return deskew_zyx_batched(czyx, ls_angle_deg, px_to_scan_ratio, keep_overhang,
                              average_window, overhang_fill, device=device)
