"""Pairwise tile registration and the global mosaic position solve.

Counterpart of ``biahub_tpu/stitching/tile.py`` (:30-211): FOV names encode
grid coordinates as ``RRRCCC``; adjacent tiles are registered by phase
cross-correlation of their overlap strips (gaussian + log1p, Hanning
window, on the host with scipy as the reference), scored by peak
isolation, and the positions are solved per axis as a confidence-weighted
soft-L1 least squares (scipy). The strips' correlation is
:func:`~biahub_tpu_torch.kernels.pcc._pcc_core` (``torch.fft``, the
reference's ``jnp.fft`` route) on the verb's device; the peak, the 11 x 11
wrapped exclusion and the confidence are numpy on the host, line for line
as the reference.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from biahub_tpu_torch.device import resolve_device
from biahub_tpu_torch.kernels.pcc import _pcc_core

__all__ = [
    "parse_grid_coords",
    "register_translation_nd",
    "pairwise_shifts",
    "optimal_positions",
]


def parse_grid_coords(fov_name: str) -> tuple[int, int]:
    """(row, col) grid coordinates from an ``RRRCCC`` FOV name."""
    name = fov_name.split("/")[-1]
    if len(name) >= 6 and name[-6:].isdigit():
        digits = name[-6:]
        return int(digits[:3]), int(digits[3:])
    raise ValueError(f"Cannot parse grid coordinates from FOV name: {fov_name}")


def _preprocess(img: np.ndarray) -> np.ndarray:
    """Gaussian denoise, log compression and a 2D Hanning window (float64,
    as the reference's product with ``np.hanning``)."""
    from scipy.ndimage import gaussian_filter

    img = np.asarray(img, dtype=np.float32)
    img = gaussian_filter(img, 1.0)
    img = np.log1p(img - img.min())
    window = np.hanning(img.shape[0])[:, None] * np.hanning(img.shape[1])[None, :]
    return img * window


def register_translation_nd(ref_img: np.ndarray, mov_img: np.ndarray,
                            device: str | torch.device = "cuda") -> tuple[np.ndarray, float]:
    """PCC shift between two equal-shape 2D strips and its peak-isolation
    confidence in [0, 1]: the peak over the highest value outside the 11 x
    11 (wrapped) neighbourhood of the peak, minus one, clipped to [0, 10]
    and divided by 10. The shift maps the moving strip onto the reference
    (the moving strip's content moves by -shift)."""
    dev = resolve_device(device)
    ref_p = torch.from_numpy(_preprocess(ref_img)).to(dev)
    mov_p = torch.from_numpy(_preprocess(mov_img)).to(dev)
    corr = np.abs(_pcc_core(ref_p, mov_p, "magnitude").cpu().numpy())
    peak_flat = np.argmax(corr)
    peak = np.unravel_index(peak_flat, corr.shape)
    peak_value = corr[peak]

    masked = corr.copy()
    radius = 5
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            masked[(peak[0] + dy) % corr.shape[0], (peak[1] + dx) % corr.shape[1]] = 0
    second = masked.max()
    confidence = float(peak_value / (second + 1e-8) - 1.0)
    confidence = float(np.clip(confidence, 0, 10) / 10)

    shift = np.array(peak, dtype=np.float64)
    midpoint = np.array([np.fix(s / 2) for s in corr.shape])
    wrap = shift > midpoint
    shift[wrap] -= np.array(corr.shape)[wrap]
    return shift, confidence


def pairwise_shifts(
    well_positions: dict,
    plate_path: Path,
    well_name: str,
    flipud: bool = False,
    fliplr: bool = False,
    rot90: bool = False,
    overlap: int = 300,
    channel_index: int = 0,
    z_index: int = 0,
    initial_positions: dict | None = None,
    device: str | torch.device = "cuda",
) -> tuple[list, dict]:
    """Register every pair of adjacent tiles of one well on their overlap
    strips (the plane ``[0, channel_index, z_index]`` of each tile).

    ``initial_positions`` maps a FOV name to its stage (y, x) pixel
    position; the expected displacement between neighbours places the
    strips (at most ``overlap`` pixels wide, at least 4). Returns
    ``(edge_list, confidence_dict)``, each edge ``(name_a, name_b, offset,
    confidence)`` with ``offset`` tile b's (y, x) position relative to
    tile a's."""
    from biahub_tpu_torch.io.ngff import open_ome_zarr

    plate = open_ome_zarr(Path(plate_path), mode="r")
    names = list(well_positions.keys())
    coords = {name: parse_grid_coords(name) for name in names}
    by_coord = {v: k for k, v in coords.items()}

    def load_tile(name):
        img = plate[name].data[0, channel_index, z_index]
        if flipud:
            img = img[::-1]
        if fliplr:
            img = img[:, ::-1]
        if rot90:
            img = np.rot90(img)
        return np.asarray(img, dtype=np.float32)

    edge_list = []
    confidence_dict = {}
    for name in names:
        r, c = coords[name]
        tile_a = None
        for axis, neighbor_coord in ((0, (r + 1, c)), (1, (r, c + 1))):
            neighbor = by_coord.get(neighbor_coord)
            if neighbor is None:
                continue
            if tile_a is None:
                tile_a = load_tile(name)
            tile_b = load_tile(neighbor)
            size = tile_a.shape[axis]
            if initial_positions and name in initial_positions:
                disp0 = float(initial_positions[neighbor][axis] - initial_positions[name][axis])
            else:
                disp0 = float(size - min(overlap, size))
            ov = int(np.clip(round(size - disp0), 4, min(overlap, size)))
            disp0 = size - ov
            if axis == 0:
                strip_a, strip_b = tile_a[-ov:, :], tile_b[:ov, :]
            else:
                strip_a, strip_b = tile_a[:, -ov:], tile_b[:, :ov]
            shift, confidence = register_translation_nd(strip_a, strip_b, device=device)
            # strip_b's content is strip_a's at (x + d - disp0): the PCC shift
            # corrects the expected displacement additively.
            offset = np.zeros(2)
            offset[axis] = disp0
            offset += shift
            edge_list.append((name, neighbor, offset, confidence))
            confidence_dict[(name, neighbor)] = (f"{name}->{neighbor}", confidence)
    return edge_list, confidence_dict


def optimal_positions(
    edge_list: list,
    tile_lut: dict,
    well_name: str,
    tile_size: tuple[int, int],
    initial_guess: dict | None = None,
) -> dict:
    """Consistent (y, x) tile positions from the pairwise edge offsets:
    per axis a confidence-weighted soft-L1 least squares of p_b - p_a =
    offset, tied to the initial guess with weight 0.01."""
    from scipy.optimize import least_squares

    names = list(tile_lut.keys())
    index = {name.split("/")[-1]: i for i, name in enumerate(names)}
    n = len(names)

    init = np.zeros((n, 2))
    if initial_guess and well_name in initial_guess:
        init[:, 0] = initial_guess[well_name]["i"]
        init[:, 1] = initial_guess[well_name]["j"]

    positions = init.copy()
    for axis in range(2):
        rows_a, rows_b, offsets, weights = [], [], [], []
        for name_a, name_b, offset, confidence in edge_list:
            rows_a.append(index[name_a.split("/")[-1]])
            rows_b.append(index[name_b.split("/")[-1]])
            offsets.append(offset[axis])
            weights.append(max(confidence, 1e-3))
        if not offsets:
            continue
        rows_a = np.asarray(rows_a)
        rows_b = np.asarray(rows_b)
        offsets = np.asarray(offsets)
        weights = np.sqrt(np.asarray(weights))

        def residuals(p):
            res = weights * (p[rows_b] - p[rows_a] - offsets)
            anchor = 0.01 * (p - init[:, axis])
            return np.concatenate([res, anchor])

        sol = least_squares(residuals, init[:, axis], loss="soft_l1")
        positions[:, axis] = sol.x

    return {name.split("/")[-1]: (positions[i, 0], positions[i, 1])
            for i, name in enumerate(names)}
