"""Bead patches for the PSF: extraction and the background noise level.

Counterpart of ``biahub_tpu/psf/analysis.py``'s ``extract_beads`` (:30)
and ``compute_noise_level`` (:203), on numpy. The Gaussian fits and the
report of ``characterize-psf`` need pandas and matplotlib and are not
ported (ROADMAP queue 1).
"""

from __future__ import annotations

import numpy as np

__all__ = ["bead_patch_slices", "extract_beads", "compute_noise_level"]


def bead_patch_slices(shape, points, scale, patch_size=None) -> list[tuple[slice, ...]]:
    """The (z, y, x) slices of the bead patches (sizes in um) around
    ``points`` that lie wholly inside a volume of ``shape``."""
    if patch_size is None:
        patch_size = (scale[0] * 15, scale[1] * 18, scale[2] * 18)
    half_px = [int(round((p / s) // 2)) for p, s in zip(patch_size, scale)]
    out = []
    for point in np.asarray(points, dtype=int):
        slices = []
        for coord, half, size in zip(point, half_px, shape):
            start, stop = coord - half, coord + half + 1
            if start < 0 or stop > size:
                break
            slices.append(slice(int(start), int(stop)))
        else:
            out.append(tuple(slices))
    return out


def extract_beads(zyx_data, points, scale, patch_size=None):
    """Crop bead patches (sizes in um) around detected peak coordinates.

    Returns (patches, offsets); beads whose full patch would cross the volume
    border are dropped, and so are empty patches."""
    zyx_data = np.asarray(zyx_data)
    patches, offsets = [], []
    for slices in bead_patch_slices(zyx_data.shape, points, scale, patch_size):
        patch = zyx_data[slices]
        if patch.size == 0:
            continue
        patches.append(patch)
        offsets.append(tuple(int(s.start) for s in slices))
    return patches, offsets


def compute_noise_level(zyx_data, peak_coordinates, patch_size_pix):
    """Std of the volume with bead patches masked out."""
    zyx_data = np.asarray(zyx_data)
    mask = np.ones_like(zyx_data, dtype=bool)
    half = [size // 2 for size in patch_size_pix]
    for z, y, x in peak_coordinates:
        patch_mask = tuple(
            slice(max(0, c - half[i]), min(zyx_data.shape[i], c + half[i] + 1))
            for i, c in enumerate((z, y, x))
        )
        mask[patch_mask] = False
    return float(np.std(zyx_data[mask]))
