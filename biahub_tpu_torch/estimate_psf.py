"""estimate-psf: average bead patches into a PSF.

Counterpart of ``biahub_tpu/estimate_psf.py``: :func:`estimate_psf_arrays`
is its numeric body (:42-103): detect beads in each position with the
verb's fixed settings (blocks of (64, 64, 32), kernel G), crop the patches
of the first patch's shape, normalize each by its peak, average, and
min-max normalize. The verb, :func:`estimate_psf`, reads the first (t, c)
volume of every input position and writes the PSF as an HCS plate ``0/0/0``
with one channel ``PSF``, one chunk, at the inputs' ZYX scale.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from biahub_tpu_torch.cli.parsing import CommandError
from biahub_tpu_torch.cli.utils import yaml_to_model
from biahub_tpu_torch.convert import psf_from_beads_settings_from_reference
from biahub_tpu_torch.device import as_tensor, resolve_device
from biahub_tpu_torch.io.ngff import TransformationMeta, open_ome_zarr
from biahub_tpu_torch.kernels.peaks import detect_peaks
from biahub_tpu_torch.psf.analysis import bead_patch_slices

__all__ = ["BEAD_DETECTION_SETTINGS", "estimate_psf_arrays", "estimate_psf"]

# The verb's fixed bead detection (estimate_psf.py:61-69).
BEAD_DETECTION_SETTINGS = {
    "block_size": (64, 64, 32),
    "blur_kernel_size": 3,
    "nms_distance": 32,
    "min_distance": 50,
    "threshold_abs": 200.0,
    "max_num_peaks": 2000,
    "exclude_border": (5, 10, 5),
}


def estimate_psf_arrays(
    pzyx,
    zyx_scale=(1.0, 1.0, 1.0),
    patch_size_px=(101, 101, 101),
    verbose: bool = False,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """The average PSF of the beads in a (P, Z, Y, X) stack of positions
    (numpy or a tensor), ``patch_size_px`` the settings' ``axis{0,1,2}_
    patch_size`` -> the patch-shaped float32 PSF on ``device``, min-max
    normalized. Raises ValueError when no position has a bead."""
    dev = resolve_device(device)
    patch_um = tuple(a * b for a, b in zip(patch_size_px, zyx_scale))
    stacks = []
    for zyx in pzyx:
        vol = as_tensor(zyx, dev)
        peaks = detect_peaks(vol, **BEAD_DETECTION_SETTINGS, verbose=verbose, device=dev)
        patches = [vol[sl] for sl in bead_patch_slices(tuple(vol.shape), peaks, zyx_scale,
                                                       patch_size=patch_um)]
        patches = [p for p in patches if p.numel()]
        if not patches:
            continue
        stacks.append(torch.stack([p for p in patches if p.shape == patches[0].shape]))
    if not stacks:
        raise ValueError("No beads detected in any input position.")
    beads = torch.cat(stacks)
    if verbose:
        print(f"Total beads: {beads.shape[0]}")
    normalized = beads / beads.amax(dim=(-3, -2, -1))[:, None, None, None]
    average_psf = normalized.mean(dim=0)
    average_psf = average_psf - average_psf.min()
    return average_psf / average_psf.max()


def estimate_psf(
    input_position_dirpaths: list[Path],
    config_filepath: Path,
    output_dirpath: Path,
    device: str | torch.device = "cuda",
) -> None:
    """The estimate-psf verb on plates (module docstring); no bead in any
    position is a :class:`~biahub_tpu_torch.cli.parsing.CommandError`."""
    dev = resolve_device(device)
    print("Loading data...")
    pzyx, zyx_scale = [], (1.0, 1.0, 1.0)
    for path in input_position_dirpaths:
        position = open_ome_zarr(str(path), mode="r")
        pzyx.append(position["0"][0, 0])
        zyx_scale = tuple(position.scale[-3:])
    try:
        pzyx = np.array(pzyx)
    except ValueError:
        raise ValueError("Concatenating position arrays failed.") from None
    settings = yaml_to_model(config_filepath, psf_from_beads_settings_from_reference)
    patch_size_px = tuple(settings[f"axis{i}_patch_size"] for i in range(3))
    print(f"Detecting beads in {len(pzyx)} positions...")
    try:
        psf = estimate_psf_arrays(pzyx, zyx_scale, patch_size_px, verbose=True, device=dev)
    except ValueError as exc:
        raise CommandError(str(exc)) from None
    psf = psf.cpu().numpy()
    plate = open_ome_zarr(output_dirpath, layout="hcs", mode="w", channel_names=["PSF"])
    plate.create_position("0", "0", "0").create_image(
        "0", psf[None, None].astype(np.float32), chunks=(1, 1) + psf.shape,
        transform=[TransformationMeta(type="scale", scale=(1, 1) + zyx_scale)])
