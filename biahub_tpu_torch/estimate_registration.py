"""estimate-registration: a source->target warp.

Counterpart of ``biahub_tpu/estimate_registration.py:213-374`` for the
``beads`` method (:mod:`biahub_tpu_torch.registration.beads`) and the
``ants`` method (intensity registration,
:mod:`biahub_tpu_torch.registration.intensity`): one transform gives the
``RegistrationSettings`` fields, several (one per timepoint) the
``StabilizationSettings`` fields, after ``evaluate_transforms`` when the
settings ask for it. :func:`estimate_registration_arrays` returns them as
a dict; the verb, :func:`estimate_registration`, reads the two channels
from the plates (each once, moved to the device once) and writes them as
the YAML file that ``register`` and ``stabilize`` read, with each
timepoint's transform as ``xyz_transforms/<t>.npy`` beside it and, when
verbose and several, ``translation_plots/<method>_registration.png``. Not
ported: the ``manual`` method (napari or point files).
"""

from __future__ import annotations

from pathlib import Path

import torch

from biahub_tpu_torch.cli.parsing import CommandError
from biahub_tpu_torch.cli.utils import model_to_yaml, yaml_to_model
from biahub_tpu_torch.convert import (
    registration_estimate_settings_from_reference,
    registration_settings_dump,
    stabilization_settings_dump,
)
from biahub_tpu_torch.device import as_tensor, resolve_device
from biahub_tpu_torch.io.ngff import open_ome_zarr
from biahub_tpu_torch.registration.utils import evaluate_transforms, plot_translations

__all__ = ["estimate_registration_arrays", "estimate_registration", "MANUAL_REFUSAL"]

MANUAL_REFUSAL = ("biahub_tpu_torch: the manual estimation method (napari or point files) "
                  "is not ported (ROADMAP queue 1 item 5)")


def estimate_registration_arrays(
    source_tczyx,
    target_tczyx,
    source_channel_names: list[str],
    target_channel_names: list[str],
    settings: dict,
    voxel_size,
    source_voxel_size=None,
    registration_target_channel: str | None = None,
    registration_source_channels: list[str] | None = None,
    output_folder_path=None,
    device: str | torch.device = "cuda",
) -> dict:
    """Estimate the warp of the source (moving) stack onto the target stack,
    both (T, C, Z, Y, X) numpy or tensors, with an
    ``EstimateRegistrationSettings`` dict -> the output settings as a dict.
    ``voxel_size``: the target's scale (its last three entries are its
    voxel size, and all five the output voxel size); ``source_voxel_size``:
    the source's ZYX voxel size (default the target's). The channels the
    settings file names for ``register`` default to the settings' target
    and source channels (the verb's ``-rt`` and ``-rs``);
    ``output_folder_path`` keeps each timepoint's transform as
    ``xyz_transforms/<t>.npy`` there."""
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
            output_folder_path=output_folder_path, ref_voxel_size=target_voxel,
            mov_voxel_size=source_voxel, device=dev)
    elif method == "ants":
        from biahub_tpu_torch.registration.intensity import estimate_tczyx

        transforms = estimate_tczyx(
            source_tczyx, target_tczyx, source_index, target_index,
            ants_registration_settings=settings["ants_registration_settings"],
            affine_transform_settings=settings["affine_transform_settings"], verbose=verbose,
            output_folder_path=output_folder_path, device=dev)
    else:
        raise NotImplementedError(MANUAL_REFUSAL)

    evaluation = settings["eval_transform_settings"]
    if len(transforms) == 1:
        if evaluation:
            print("One transform was estimated, no need to evaluate")
        return registration_settings_dump(
            list(registration_source_channels or [source_name]),
            registration_target_channel or target_name, transforms[0])
    if evaluation:
        transforms = evaluate_transforms(
            transforms, tuple(source_tczyx.shape[-3:]),
            validation_window_size=evaluation["validation_window_size"],
            validation_tolerance=evaluation["validation_tolerance"],
            interpolation_window_size=evaluation["interpolation_window_size"],
            interpolation_type=evaluation["interpolation_type"], verbose=verbose)
    return stabilization_settings_dump(target_name, "affine", method, [source_name, target_name],
                                       transforms, voxel_size)


def _channel(path, name: str, dev):
    """The position at ``path``, and its channel ``name`` read once as
    (T, 1, Z, Y, X) on the device."""
    position = open_ome_zarr(path, mode="r")
    index = position.channel_names.index(name)
    return position, as_tensor(position.data[:, index], dev)[:, None]


def estimate_registration(
    source_position_dirpaths: list[Path],
    target_position_dirpaths: list[Path],
    output_filepath: Path,
    config_filepath: Path,
    registration_target_channel: str | None = None,
    registration_source_channel: list[str] = (),
    sbatch_filepath: str | None = None,
    local: bool = False,
    source_points=None,
    target_points=None,
    source_points_frame: str = "pre_aligned",
    device: str | torch.device = "cuda",
) -> None:
    """The estimate-registration verb on plates (module docstring): the
    first source and target positions, the YAML at ``output_filepath``.
    The ``manual`` method (and with it the point files) is refused as a
    :class:`~biahub_tpu_torch.cli.parsing.CommandError`."""
    dev = resolve_device(device)
    output_dir = Path(output_filepath).parent
    output_dir.mkdir(parents=True, exist_ok=True)
    settings = yaml_to_model(config_filepath, registration_estimate_settings_from_reference)
    print(f"Settings: {settings}")
    if settings["estimation_method"] == "manual":
        raise CommandError(MANUAL_REFUSAL)
    target_name, source_name = settings["target_channel_name"], settings["source_channel_name"]
    print(f"Target channel: {target_name}")
    print(f"Source channel: {source_name}")
    source, source_data = _channel(source_position_dirpaths[0], source_name, dev)
    target, target_data = _channel(target_position_dirpaths[0], target_name, dev)
    model = estimate_registration_arrays(
        source_data, target_data, [source_name], [target_name], settings, target.scale,
        source_voxel_size=source.scale[-3:],
        registration_target_channel=registration_target_channel,
        registration_source_channels=list(registration_source_channel),
        output_folder_path=output_dir, device=dev)
    if "affine_transform_zyx_list" in model and settings["verbose"]:
        plot_translations(model["affine_transform_zyx_list"], output_dir / "translation_plots"
                          / f"{settings['estimation_method']}_registration.png")
    model_to_yaml(model, output_filepath)
    print(f"Registration settings saved to {output_dir.resolve()}")
