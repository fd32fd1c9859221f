"""CLI-layer utilities: settings files, output paths, provenance keys.

Counterpart of ``biahub_tpu/cli/utils.py``: ``yaml_to_model`` reads a
settings file with the port's YAML reader and validates it through one of
the readers of
:mod:`biahub_tpu_torch.convert`, which refuse unknown fields as the
reference's models do; ``model_to_yaml`` writes a settings dict as the
reference's ``model_to_yaml`` writes its model (:mod:`biahub_tpu_torch.cli.
yaml_writer`); ``update_model`` merges into a settings dict as the
reference's merges into its model.
"""

from __future__ import annotations

from collections.abc import Callable
from pathlib import Path

import numpy as np
import torch

from biahub_tpu_torch.cli.yaml_reader import load_file
from biahub_tpu_torch.cli.yaml_writer import dump_file
from biahub_tpu_torch.io.ngff import get_ome_zarr_version, open_ome_zarr

__all__ = [
    "PROVENANCE_METADATA_KEYS",
    "yaml_to_model",
    "model_to_yaml",
    "update_model",
    "get_output_paths",
    "resolve_ome_zarr_version",
    "append_channels",
    "copy_n_paste",
    "copy_n_paste_czyx",
    "get_empty_frame_indices",
]

#: fnmatch allowlist of per-position attribute keys carried into output
#: stores: the provenance records each step stamps.
PROVENANCE_METADATA_KEYS = ("biahub-*", "waveorder", "cytoland")


def yaml_to_model(yaml_path: Path, reader: Callable[[dict], dict]) -> dict:
    """The settings file at ``yaml_path``, validated by ``reader`` (e.g.
    ``convert.deskew_settings_dump``)."""
    yaml_path = Path(yaml_path)
    if not yaml_path.exists():
        raise FileNotFoundError(f"The YAML file '{yaml_path}' does not exist.")
    raw = load_file(yaml_path)
    if not isinstance(raw, dict):
        raise ValueError(f"{yaml_path}: want a mapping of settings, got {raw!r}")
    return reader(raw)


def model_to_yaml(model: dict, yaml_path: Path) -> None:
    """Write a settings dict (a reference model's ``model_dump()``, e.g.
    from ``convert.registration_settings_dump``) to ``yaml_path``, its
    top-level None values dropped, as the reference's ``model_to_yaml``."""
    if not isinstance(model, dict):
        raise TypeError(f"model_to_yaml: want a settings dict, got {type(model).__name__}")
    dump_file({k: v for k, v in model.items() if v is not None}, yaml_path)


def update_model(model: dict, update_dict: dict) -> dict:
    """A copy of the settings dict ``model`` with ``update_dict``'s entries:
    a dict merged one level into a nested settings dict, anything else
    replacing the entry (the reference's ``update_model`` on its model)."""
    updated = dict(model)
    for key, value in update_dict.items():
        if isinstance(value, dict) and isinstance(model.get(key), dict):
            updated[key] = {**model[key], **value}
        else:
            updated[key] = value
    return updated


def get_output_paths(input_paths: list[Path], output_zarr_path: Path,
                     ensure_unique_positions: bool | None = None) -> list[Path]:
    """Mirror input row/col/fov position keys under the output plate path;
    with ``ensure_unique_positions`` a repeated key gets a ``d<n>`` suffix
    on its column."""
    out_paths = []
    seen: dict[str, int] = {}
    for path in input_paths:
        parts = Path(path).parts[-3:]
        key = "/".join(parts)
        if ensure_unique_positions and key in seen:
            seen[key] += 1
            parts = (parts[0], f"{parts[1]}d{seen[key]}", parts[2])
        elif ensure_unique_positions:
            seen[key] = 0
        out_paths.append(Path(output_zarr_path, *parts))
    return out_paths


def resolve_ome_zarr_version(path) -> str:
    """The OME-Zarr version of an existing store."""
    return get_ome_zarr_version(path)


def append_channels(input_data_path: Path, target_data_path: Path) -> None:
    """Append every channel of one store to the positions of another."""
    appending = open_ome_zarr(input_data_path, mode="r")
    appending_names = appending.channel_names
    target = open_ome_zarr(target_data_path, mode="r+")
    for name, position in target.positions():
        num_existing = len(position.channel_names)
        src_pos = appending[name]
        old = position.data[...]
        T, C, Z, Y, X = old.shape
        new = np.zeros((T, C + len(appending_names), Z, Y, X), old.dtype)
        new[:, :C] = old
        for i, channel in enumerate(appending_names):
            position.append_channel(channel)
            new[:, num_existing + i] = src_pos.data[:, i]
        position.create_image("0", new)


def copy_n_paste(zyx_data, zyx_slicing_params: list):
    """Crop a ZYX array (numpy or a tensor) by [z_slice, y_slice, x_slice],
    NaNs zeroed first."""
    if isinstance(zyx_data, torch.Tensor):
        zyx_data = torch.nan_to_num(zyx_data, nan=0.0)
    else:
        zyx_data = np.nan_to_num(zyx_data, nan=0)
    return zyx_data[zyx_slicing_params[0], zyx_slicing_params[1], zyx_slicing_params[2]]


def copy_n_paste_czyx(czyx_data, czyx_slicing_params: list):
    """Crop a CZYX array by [z_slice, y_slice, x_slice] on its last axes."""
    return czyx_data[:, czyx_slicing_params[0], czyx_slicing_params[1],
                     czyx_slicing_params[2]]


def get_empty_frame_indices(input_array) -> list[int]:
    """Indices of the all-zero or all-NaN Z slices of a 3D array (numpy or a
    tensor)."""
    if input_array.ndim != 3:
        raise ValueError("Input array must be 3D.")
    # x != x holds exactly at NaN, for numpy and torch alike.
    return [z for z, frame in enumerate(input_array)
            if bool((frame != frame).all() or (frame == 0).all())]
