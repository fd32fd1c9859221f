"""optimize-registration: refine a registration.

Counterpart of ``biahub_tpu/optimize_registration.py``: on arrays,
:func:`optimize_registration_arrays` (``_optimize_registration``, :29-62)
refines the initial source->target warp by intensity registration
(:mod:`biahub_tpu_torch.registration.intensity`), on the LIR-cropped
overlap when ``crop``; the verb, :func:`optimize_registration` (:64-138),
reads one timepoint of the first source and target positions, refines the
settings file's ``affine_transform_zyx`` with ``crop=True`` and writes the
settings with the refined matrix.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from biahub_tpu_torch.cli.parsing import CommandError
from biahub_tpu_torch.cli.utils import model_to_yaml, yaml_to_model
from biahub_tpu_torch.convert import (
    registration_settings_dump,
    registration_settings_from_reference,
)
from biahub_tpu_torch.device import as_tensor, resolve_device
from biahub_tpu_torch.io.ngff import open_ome_zarr
from biahub_tpu_torch.registration.intensity import estimate_czyx

__all__ = ["optimize_registration_arrays", "optimize_registration"]


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


def optimize_registration(
    source_position_dirpaths: list[Path],
    target_position_dirpaths: list[Path],
    config_filepath: Path,
    output_filepath: Path,
    display_viewer: bool = False,
    device: str | torch.device = "cuda",
) -> None:
    """The optimize-registration verb on plates (module docstring). A
    ``time_indices`` other than an int takes timepoint 0; all-zero inputs
    are a :class:`~biahub_tpu_torch.cli.parsing.CommandError`."""
    dev = resolve_device(device)
    settings = yaml_to_model(config_filepath, registration_settings_from_reference)
    t_idx = settings["time_indices"]
    if not isinstance(t_idx, int):
        print("Time index 'all' is not supported for optimize-registration, using first "
              "time index")
        t_idx = 0
    source = open_ome_zarr(source_position_dirpaths[0], mode="r")
    source_index = source.channel_names.index(settings["source_channel_names"][0])
    source_czyx = as_tensor(source.data[t_idx], dev)
    print("Source data shape:", tuple(source_czyx.shape))
    target = open_ome_zarr(target_position_dirpaths[0], mode="r")
    target_index = target.channel_names.index(settings["target_channel_name"])
    target_czyx = as_tensor(target.data[t_idx], dev)
    print("Target data shape:", tuple(target_czyx.shape))
    print(f"\nOptimizing registration using source channel "
          f"{source.channel_names[source_index]} and target channel "
          f"{target.channel_names[target_index]}")
    composed = optimize_registration_arrays(
        source_czyx, target_czyx, np.asarray(settings["affine_transform_zyx"], np.float32),
        source_index, target_index, crop=True, verbose=settings["verbose"], device=dev)
    if composed is None:
        raise CommandError("Input data contains only NaN or zeros.")
    print(f"Writing registration parameters to {output_filepath}")
    model_to_yaml(registration_settings_dump(**dict(
        settings, affine_transform_zyx=composed.tolist())), output_filepath)
    if display_viewer:
        print("napari viewing is unavailable in a headless run; inspect the registered "
              "output with `register` instead.")
