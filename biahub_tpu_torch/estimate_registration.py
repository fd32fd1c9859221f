"""estimate-registration on arrays in memory: a source->target warp.

Counterpart of ``biahub_tpu/estimate_registration.py:213-374`` for the
``beads`` method (:mod:`biahub_tpu_torch.registration.beads`) and the
``ants`` method (intensity registration,
:mod:`biahub_tpu_torch.registration.intensity`): one transform gives the
``RegistrationSettings`` fields, several (one per timepoint) the
``StabilizationSettings`` fields, after ``evaluate_transforms`` when the
settings ask for it; both as plain dicts, which the verb writes as YAML.
Not ported: the ``manual`` method (napari or point files) and the plate
I/O and YAML writing (ROADMAP queue 1).
"""

from __future__ import annotations

import torch

from biahub_tpu_torch.convert import registration_estimate_settings_from_reference
from biahub_tpu_torch.device import resolve_device
from biahub_tpu_torch.registration.utils import evaluate_transforms

__all__ = ["estimate_registration_arrays"]


def estimate_registration_arrays(
    source_tczyx,
    target_tczyx,
    source_channel_names: list[str],
    target_channel_names: list[str],
    settings: dict,
    voxel_size,
    source_voxel_size=None,
    device: str | torch.device = "cuda",
) -> dict:
    """Estimate the warp of the source (moving) stack onto the target stack,
    both (T, C, Z, Y, X) numpy or tensors, with an
    ``EstimateRegistrationSettings`` dict -> the output settings as a dict.
    ``voxel_size``: the target's scale (its last three entries are its
    voxel size, and all five the output voxel size); ``source_voxel_size``:
    the source's ZYX voxel size (default the target's)."""
    dev = resolve_device(device)
    settings = registration_estimate_settings_from_reference(settings)
    method = settings["estimation_method"]
    target_name, source_name = settings["target_channel_name"], settings["source_channel_name"]
    source_index = list(source_channel_names).index(source_name)
    target_index = list(target_channel_names).index(target_name)
    target_voxel = tuple(voxel_size)[-3:]
    source_voxel = target_voxel if source_voxel_size is None else tuple(source_voxel_size)[-3:]
    verbose = settings["verbose"]

    if method == "beads":
        from biahub_tpu_torch.registration.beads import estimate_tczyx

        transforms = estimate_tczyx(
            source_tczyx, target_tczyx, source_index, target_index,
            beads_match_settings=settings["beads_match_settings"],
            affine_transform_settings=settings["affine_transform_settings"], verbose=verbose,
            ref_voxel_size=target_voxel, mov_voxel_size=source_voxel, device=dev)
    elif method == "ants":
        from biahub_tpu_torch.registration.intensity import estimate_tczyx

        transforms = estimate_tczyx(
            source_tczyx, target_tczyx, source_index, target_index,
            ants_registration_settings=settings["ants_registration_settings"],
            affine_transform_settings=settings["affine_transform_settings"], verbose=verbose,
            device=dev)
    else:
        raise NotImplementedError(
            "biahub_tpu_torch: the manual estimation method (napari or point files) is not "
            "ported (ROADMAP queue 1 item 5)")

    if len(transforms) == 1:
        return {
            "source_channel_names": [source_name],
            "target_channel_name": target_name,
            "affine_transform_zyx": transforms[0],
            "keep_overhang": False,
            "interpolation": "linear",
            "time_indices": "all",
            "verbose": False,
            "output_ome_zarr_version": None,
        }
    evaluation = settings["eval_transform_settings"]
    if evaluation:
        transforms = evaluate_transforms(
            transforms, tuple(source_tczyx.shape[-3:]),
            validation_window_size=evaluation["validation_window_size"],
            validation_tolerance=evaluation["validation_tolerance"],
            interpolation_window_size=evaluation["interpolation_window_size"],
            interpolation_type=evaluation["interpolation_type"], verbose=verbose)
    return {
        "stabilization_estimation_channel": target_name,
        "stabilization_type": "affine",
        "stabilization_method": method,
        "stabilization_channels": [source_name, target_name],
        "affine_transform_zyx_list": transforms,
        "time_indices": "all",
        "output_voxel_size": list(voxel_size),
        "output_ome_zarr_version": None,
    }
