"""estimate-crop: the common crop where both arms of a pair hold data.

Counterpart of ``biahub_tpu/estimate_crop.py``: for each pair of positions
(the label-free arm first, the light-sheet arm second, from the
``ConcatenateSettings``' two ``concat_data_paths``),
:func:`estimate_crop_one_position` (:33) masks the voxels of each arm's
first channel that are non-zero and not NaN, keeps the (t, c) volumes whose
voxel count lies within 20% of the median, intersects them, optionally
applies a circular mask to the label-free arm, and finds the largest
interior rectangle (:func:`~biahub_tpu_torch.register.find_lir`); with an
``output_dir`` it writes the position's CSV (``fov``, ``Z``, ``Y``, ``X``,
the ranges as ``[start, stop]``, as pandas writes them). The verb
(:func:`estimate_crop`, :118) takes the smallest crop common to every
position and writes the settings with those slices.
"""

from __future__ import annotations

import csv
from pathlib import Path

import numpy as np

from biahub_tpu_torch.cli.utils import model_to_yaml, yaml_to_model
from biahub_tpu_torch.convert import concatenate_settings_from_reference
from biahub_tpu_torch.io.ngff import open_ome_zarr
from biahub_tpu_torch.register import find_lir
from biahub_tpu_torch.runtime import estimate_resources, resolve_cluster

__all__ = ["estimate_crop_one_position", "estimate_crop"]


def estimate_crop_one_position(lf_dir: Path, ls_dir: Path, lf_mask_radius: float | None = None,
                               output_dir: Path | None = None):
    """The ([z0, z1], [y0, y1], [x0, x1]) crop of one pair of positions
    where both arms are non-zero (module docstring)."""
    fov = "/".join(Path(lf_dir).parts[-3:])
    print(f"Processing FOV: {fov}")

    lf_data = open_ome_zarr(lf_dir).data[:, :1]
    lf_mask = (lf_data != 0) & (~np.isnan(lf_data))
    ls_data = open_ome_zarr(ls_dir).data[:, :1]
    ls_mask = (ls_data != 0) & (~np.isnan(ls_data))
    del lf_data, ls_data

    lf_shape, ls_shape = lf_mask.shape[-3:], ls_mask.shape[-3:]
    _max_zyx_dims = np.asarray([lf_shape, ls_shape]).min(axis=0)
    if lf_shape != ls_shape:
        print("WARNING: Phase and fluorescence datasets should have the same shape, got"
              f" phase shape: {lf_shape}, fluorescence shape: {ls_shape}")
        lf_mask = lf_mask[..., : _max_zyx_dims[0], : _max_zyx_dims[1], : _max_zyx_dims[2]]
        ls_mask = ls_mask[..., : _max_zyx_dims[0], : _max_zyx_dims[1], : _max_zyx_dims[2]]

    data = np.concatenate([lf_mask, ls_mask], axis=1)
    # Frames whose non-zero volume is near the median (blank or partial
    # frames are dropped).
    volume = np.sum(data, axis=(2, 3, 4))
    median_volume = np.median(volume)
    valid_t, valid_c = np.where((volume > 0.8 * median_volume) & (volume < 1.2 * median_volume))
    if len(valid_t) == 0:
        print("No valid data found for current position, will not crop.")
        return tuple(zip((0, 0, 0), _max_zyx_dims))
    combined_mask = np.all(data[valid_t, valid_c], axis=0)

    if lf_mask_radius is not None:
        print(f"Applying circular mask of radius {lf_mask_radius} to phase channel.")
        if not (0 < lf_mask_radius <= 1):
            raise ValueError(
                "lf_mask_radius must be a fraction of image width (0 < lf_mask_radius <= 1).")
        circle = np.zeros(lf_mask.shape[-2:], dtype=bool)
        y, x = np.ogrid[: circle.shape[-2], : circle.shape[-1]]
        center = (circle.shape[-2] // 2, circle.shape[-1] // 2)
        radius = int(lf_mask_radius * min(center))
        circle[(x - center[0]) ** 2 + (y - center[1]) ** 2 <= radius**2] = True
        combined_mask = combined_mask * circle[: _max_zyx_dims[1], : _max_zyx_dims[2]]

    z_slice, y_slice, x_slice = find_lir(combined_mask)
    print(f"Estimated crop for FOV {fov}:\n"
          f"Z: {z_slice.start} - {z_slice.stop}\n"
          f"Y: {y_slice.start} - {y_slice.stop}\n"
          f"X: {x_slice.start} - {x_slice.stop}")
    ranges = ([z_slice.start, z_slice.stop], [y_slice.start, y_slice.stop],
              [x_slice.start, x_slice.stop])
    if output_dir:
        Path(output_dir).mkdir(parents=True, exist_ok=True)
        with open(Path(output_dir) / f"{fov.replace('/', '_')}.csv", "w", newline="") as f:
            writer = csv.writer(f, lineterminator="\n")
            writer.writerow(["fov", "Z", "Y", "X"])
            writer.writerow([fov, *(str(r) for r in ranges)])
    return ranges


def _positions(config_filepath: Path, pattern: str) -> list[Path]:
    return [p for p in sorted(config_filepath.parent.glob(pattern)) if p.is_dir()]


def estimate_crop(config_filepath: Path, output_filepath: Path,
                  lf_mask_radius: float | None = 0.95, sbatch_filepath: str | None = None,
                  local: bool = False) -> None:
    """The estimate-crop verb (module docstring); the paths' globs are
    relative to the settings file's folder."""
    config_filepath = Path(config_filepath)
    if config_filepath.suffix not in (".yml", ".yaml"):
        raise ValueError("Config file must be a yaml file")
    settings = yaml_to_model(config_filepath, concatenate_settings_from_reference)
    Path(output_filepath).parent.mkdir(parents=True, exist_ok=True)

    lf_position_dirpaths = _positions(config_filepath, settings["concat_data_paths"][0])
    print(f"Found {len(lf_position_dirpaths)} phase channels.")
    ls_position_dirpaths = _positions(config_filepath, settings["concat_data_paths"][1])
    print(f"Found {len(ls_position_dirpaths)} fluorescence channels.")
    if len(lf_position_dirpaths) != len(ls_position_dirpaths):
        raise ValueError("Number of phase and fluorescence channels must be the same.")

    dataset = open_ome_zarr(lf_position_dirpaths[0])
    estimate_resources(shape=dataset.data.shape, ram_multiplier=16, max_num_cpus=16)
    resolve_cluster(None, local)

    all_ranges = []
    for ls_dir, lf_dir in zip(ls_position_dirpaths, lf_position_dirpaths):
        ranges = estimate_crop_one_position(lf_dir=lf_dir, ls_dir=ls_dir,
                                            lf_mask_radius=lf_mask_radius)
        all_ranges.append([list(r) for r in ranges])

    all_ranges = np.array(all_ranges)
    standardized = np.concatenate([all_ranges[..., 0].max(axis=0, keepdims=True),
                                   all_ranges[..., 1].min(axis=0, keepdims=True)])
    print(f"Standardized ranges:\nZ: {standardized[:, 0].tolist()}\n"
          f"Y: {standardized[:, 1].tolist()}\nX: {standardized[:, 2].tolist()}")
    out = dict(settings)
    out["Z_slice"] = standardized[:, 0].tolist()
    out["Y_slice"] = standardized[:, 1].tolist()
    out["X_slice"] = standardized[:, 2].tolist()
    model_to_yaml(out, output_filepath)
    print("Done.")
