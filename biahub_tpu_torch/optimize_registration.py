"""optimize-registration on arrays in memory: refine a registration.

Counterpart of ``biahub_tpu/optimize_registration.py:29-62``
(``_optimize_registration``): the initial source->target warp is refined by
intensity registration (:mod:`biahub_tpu_torch.registration.intensity`) on
the LIR-cropped overlap when ``crop``, as the verb does. Reading the plates
and writing the refined YAML wait for the I/O layer (ROADMAP queue 1).
"""

from __future__ import annotations

import numpy as np
import torch

from biahub_tpu_torch.device import as_tensor, resolve_device
from biahub_tpu_torch.registration.intensity import estimate_czyx

__all__ = ["optimize_registration_arrays"]


def optimize_registration_arrays(
    source_czyx,
    target_czyx,
    initial_tform,
    source_channel_index: int | list = 0,
    target_channel_index: int = 0,
    crop: bool = False,
    target_mask_radius: float | None = None,
    clip: bool = False,
    sobel_filter: bool = False,
    verbose: bool = False,
    output_folder_path=None,
    device: str | torch.device = "cuda",
) -> np.ndarray | None:
    """Refine ``initial_tform`` (4x4, output->input) on one (C, Z, Y, X)
    pair, numpy or tensors -> the composed float64 4x4, or None when either
    input is all zeros. (The reference spells ``sobel_filter``
    ``sobel_fitler``.)"""
    dev = resolve_device(device)
    source_czyx = as_tensor(source_czyx, dev)
    target_czyx = as_tensor(target_czyx, dev)
    if bool((source_czyx == 0).all()) or bool((target_czyx == 0).all()):
        return None
    return estimate_czyx(
        source_czyx, target_czyx, np.asarray(initial_tform), source_channel_index,
        target_channel_index, crop=crop, ref_mask_radius=target_mask_radius, clip=clip,
        sobel_filter=sobel_filter, verbose=verbose,
        output_folder_path=output_folder_path, device=dev)
