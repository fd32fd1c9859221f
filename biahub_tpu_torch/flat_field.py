"""The flat-field verb.

Counterpart of the compute of ``biahub_tpu/flat_field.py::flat_field``
(:74-147): on arrays in memory (:func:`flat_field_arrays`) and on plates
(:func:`flat_field`). The target channels of every timepoint are corrected
by ``kernels/flat_field.py::flat_field_zyx``, and the other channels copied
as float32 (the reference's output plate is float32).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from biahub_tpu_torch.cli.utils import PROVENANCE_METADATA_KEYS, get_output_paths, yaml_to_model
from biahub_tpu_torch.convert import flat_field_settings_from_reference
from biahub_tpu_torch.device import as_tensor, resolve_device
from biahub_tpu_torch.io.ngff import create_empty_plate, get_ome_zarr_version, open_ome_zarr
from biahub_tpu_torch.kernels.flat_field import flat_field_zyx
from biahub_tpu_torch.runtime.executor import BatchRunner, resolve_cluster
from biahub_tpu_torch.runtime.resources import (
    echo_resources,
    estimate_resources,
    settings_fingerprint,
)

__all__ = ["resolve_target_indices", "flat_field_arrays", "flat_field"]


def resolve_target_indices(
    settings: dict,
    all_channel_names: list[str],
    others_note: str = "Other channels will be copied as-is",
) -> list[int]:
    """The indices of the channels to correct (the reference's
    ``_resolve_target_indices``, :45-72, with its lines on stdout):
    ``channel_names`` None means every channel; a name that is not a
    channel, or an empty list, raises ValueError with the reference's
    message."""
    names = settings.get("channel_names")
    if names is None:
        print(f"Flat fielding ALL channels: {all_channel_names}")
        target = all_channel_names
    elif names:
        for name in names:
            if name not in all_channel_names:
                raise ValueError(
                    f"Channel '{name}' not found in input dataset. "
                    f"Available channels: {all_channel_names}"
                )
        target = names
        print(f"Input channels: {all_channel_names}")
        print(f"Flat field channels: {target}")
        print(others_note)
    else:
        raise ValueError(
            "Must specify either 'channel_names' or set channel_names to null in config."
        )
    return [list(all_channel_names).index(name) for name in target]


def flat_field_arrays(
    tczyx,
    channel_names: list[str],
    settings: dict,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """Flat-field a (T, C, Z, Y, X) array -> (T, C, Z, Y, X) float32 on the
    device: the channels the settings name (``FlatFieldCorrectionSettings``
    as a dict, ``settings/example_flat_field_settings.yml`` as loaded)
    corrected volume by volume, the others copied."""
    dev = resolve_device(device)
    targets = set(resolve_target_indices(flat_field_settings_from_reference(settings),
                                         list(channel_names)))
    T, C = tczyx.shape[:2]
    out = torch.empty(tuple(tczyx.shape), dtype=torch.float32, device=dev)
    for t in range(T):
        for c in range(C):
            vol = as_tensor(tczyx[t, c], dev)
            out[t, c] = flat_field_zyx(vol, device=dev) if c in targets else vol
    return out


def flat_field(
    input_position_dirpaths: list[Path],
    config_filepath: Path,
    output_dirpath: Path,
    sbatch_filepath: str | None = None,
    cluster: str = "slurm",
    monitor: bool = True,
    init_only: bool = False,
    resume: bool = False,
    device: str | torch.device = "cuda",
) -> None:
    """The flat-field verb on plates (the reference's ``flat_field``,
    :74-147): a float32 output plate of the input's shape, the target
    channels corrected by :func:`~biahub_tpu_torch.kernels.flat_field.
    flat_field_zyx` in device batches, the others copied."""
    dev = resolve_device(device)
    output_dirpath = Path(output_dirpath)
    settings = yaml_to_model(config_filepath, flat_field_settings_from_reference)
    input_dataset = open_ome_zarr(str(input_position_dirpaths[0]), mode="r")
    all_channel_names = input_dataset.channel_names
    input_shape = input_dataset.data.shape
    input_plate = Path(input_position_dirpaths[0]).parents[2]
    version = settings["output_ome_zarr_version"] or get_ome_zarr_version(input_plate)
    create_empty_plate(
        store_path=output_dirpath,
        position_keys=[Path(p).parts[-3:] for p in input_position_dirpaths],
        channel_names=all_channel_names,
        shape=input_shape,
        scale=input_dataset.scale,
        dtype=np.float32,
        version=version,
        metadata_sources=input_plate,
        metadata_keys=PROVENANCE_METADATA_KEYS,
    )
    time_minutes, num_cpus, gb_ram_per_cpu = estimate_resources(
        shape=input_shape, ram_multiplier=8, time_multiplier=0.7, max_num_cpus=16)
    echo_resources(num_cpus, num_cpus * gb_ram_per_cpu, time_minutes)
    if init_only:
        print(f"Initialized {output_dirpath} ({len(input_position_dirpaths)} positions)")
        return

    output_position_paths = get_output_paths(input_position_dirpaths, output_dirpath)
    target_indices = resolve_target_indices(settings, all_channel_names)
    other_indices = [c for c in range(len(all_channel_names)) if c not in target_indices]
    resolved = resolve_cluster(cluster=cluster)
    print(f"Running on-device batches (mode='{resolved}')")
    input_positions = [open_ome_zarr(p, mode="r") for p in input_position_dirpaths]
    output_positions = [open_ome_zarr(p, mode="r+") for p in output_position_paths]
    for out_pos in output_positions:
        out_pos.update_zattrs({"biahub-flat_field": settings})

    def kernel(vols: torch.Tensor) -> torch.Tensor:
        return torch.stack([flat_field_zyx(v, device=dev) for v in vols])

    runner = BatchRunner(cluster=resolved, device=dev)
    n = runner.run_zyx(kernel, input_positions, output_positions,
                       channel_pairs=[(c, c) for c in target_indices], resume=resume,
                       resume_token=settings_fingerprint(settings),
                       monitor=monitor and resolved != "debug")
    if other_indices:
        runner.copy_channels(input_positions, output_positions,
                             [(c, c) for c in other_indices])
    print(f"Flat-fielded {n} (t, c) volumes")
    for path in input_position_dirpaths:
        print(f"Flat-field complete: {path}")
    runner.echo_stats()
