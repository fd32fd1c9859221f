"""The estimate-stitch verb: per-FOV pixel shifts from stage metadata.

Counterpart of ``biahub_tpu/estimate_stitch.py`` (:31-243): each FOV's
micromanager stage position (the plate's ``Summary.StagePositions``, the
entry labelled with the position's ``omero.name``, else its row/col/fov
name) becomes well-local pixel shifts (re-origined at the well's smallest
coordinate, divided by the voxel size); ``--pcc-channel-name`` refines Y
and X by phase cross-correlation of the overlap strips and the global
position solve (:mod:`biahub_tpu_torch.stitching`, the correlations on the
verb's device); then the flips, re-anchoring at zero where a flip made a
shift negative, rounding to 2 decimals, and the ``StitchSettings`` YAML
that the stitch verb reads.
"""

from __future__ import annotations

from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from biahub_tpu_torch.cli.utils import model_to_yaml
from biahub_tpu_torch.convert import stitch_settings_from_reference
from biahub_tpu_torch.io.ngff import open_ome_zarr
from biahub_tpu_torch.stitching.tile import optimal_positions, pairwise_shifts

__all__ = ["estimate_stitch", "extract_stage_position"]


def _stage_entry(plate_dataset, position_name: str) -> dict | None:
    """The last StagePositions entry labelled ``position_name`` (micromanager
    appends on re-acquisition: the newest entry wins)."""
    entry = None
    for candidate in plate_dataset.zattrs["Summary"]["StagePositions"]:
        if candidate.get("Label") == position_name:
            entry = candidate
    return entry


def extract_stage_position(plate_dataset, position_name: str) -> tuple:
    """(z, y, x) stage coordinates in um of a named micromanager position.

    Two metadata dialects: ``DevicePositions`` (a device list; the
    ``DefaultXYStage`` device carries (x, y), and every other device's
    first coordinate adds to z), or direct keys (``DefaultXYStage`` and
    ``DefaultZStage`` name top-level entries holding [x, y] and z). An
    axis without its device or key is 0."""
    entry = _stage_entry(plate_dataset, position_name)
    if entry is None:
        return 0.0, 0.0, 0.0
    xy_stage = entry.get("DefaultXYStage", "")
    if "DevicePositions" in entry:
        x = y = z = 0.0
        for device in entry["DevicePositions"]:
            coords = device["Position_um"]
            if xy_stage and device["Device"] == xy_stage:
                x, y = coords
            else:
                z += coords[0]
        return z, y, x
    x, y = entry.get(xy_stage, (0.0, 0.0)) if xy_stage else (0.0, 0.0)
    z = entry.get(entry.get("DefaultZStage", ""), 0.0)
    return z, y, x


def _read_stage_positions(input_position_dirpaths: list[Path]) -> dict[str, tuple]:
    """fov_name ("row/col/fov") -> (z, y, x) stage coordinates in um."""
    plate_path = Path(*Path(input_position_dirpaths[0]).parts[:-3])
    coords: dict[str, tuple] = {}
    plate = open_ome_zarr(plate_path)
    for dirpath in input_position_dirpaths:
        fov_name = "/".join(Path(dirpath).parts[-3:])
        label = open_ome_zarr(dirpath).zattrs.get("omero", {}).get("name", fov_name)
        coords[fov_name] = extract_stage_position(plate, label)
        print(f"Found metadata: {fov_name}: {coords[fov_name]}")
    return coords


def _refine_well_with_pcc(shifts_px: np.ndarray, fov_names: list[str], plate_path: Path,
                          well_name: str, channel_index: int, z_index: int, fliplr: bool,
                          flipud: bool, device) -> np.ndarray:
    """``shifts_px`` with its Y and X columns replaced by the PCC-refined
    solve, seeded by the stage estimate."""
    seed_yx = {name: (shifts_px[i, 1], shifts_px[i, 2]) for i, name in enumerate(fov_names)}
    edges, confidence = pairwise_shifts(
        {name: None for name in fov_names}, plate_path, well_name, flipud=flipud,
        fliplr=fliplr, rot90=False, overlap=300, channel_index=channel_index,
        z_index=z_index, initial_positions=seed_yx, device=device)
    print("Confidence scores:")
    for pair, *_, score in confidence.values():
        print(f"{pair}: {score:.2f}")
    tile_yx = open_ome_zarr(plate_path / fov_names[0]).data.shape[-2:]
    solved = optimal_positions(
        edges, {name.split("/")[-1]: i for i, name in enumerate(fov_names)}, well_name,
        tile_size=tile_yx,
        initial_guess={well_name: {"i": shifts_px[:, 1], "j": shifts_px[:, 2]}})
    refined = shifts_px.copy()
    refined[:, 1] = [yx[0] for yx in solved.values()]
    refined[:, 2] = [yx[1] for yx in solved.values()]
    return refined


def estimate_stitch(
    input_position_dirpaths: list[Path],
    output_filepath: Path,
    fliplr: bool = False,
    flipud: bool = False,
    flipxy: bool = False,
    pcc_channel_name: str | None = None,
    pcc_z_index: int = 0,
    add_offset: bool = False,
    local: bool = False,
    monitor: bool = False,
    device: str | torch.device = "cuda",
) -> dict:
    """The estimate-stitch verb (the reference's ``estimate_stitch_cli``):
    writes the ``StitchSettings`` YAML of every position's (z, y, x) pixel
    shift to ``output_filepath`` and returns its settings dict.
    ``add_offset``, ``local`` and ``monitor`` are accepted and unused, as in
    the reference."""
    plate_path = Path(*Path(input_position_dirpaths[0]).parts[:-3])
    print("Reading stage positions...")
    stage_um = _read_stage_positions(input_position_dirpaths)

    by_well: dict[str, list[str]] = defaultdict(list)
    for fov_name in stage_um:
        by_well["/".join(fov_name.split("/")[:2])].append(fov_name)

    first = open_ome_zarr(input_position_dirpaths[0])
    scale_zyx = np.asarray(first.scale[2:], dtype=np.float64)
    channel_names = first.channel_names

    total_translation: dict[str, list[float]] = {}
    for well_name, fov_names in by_well.items():
        shifts = np.array([stage_um[f] for f in fov_names], dtype=np.float64)
        shifts -= shifts.min(axis=0)
        shifts /= scale_zyx
        if pcc_channel_name is not None:
            shifts = _refine_well_with_pcc(
                shifts, fov_names, plate_path, well_name,
                channel_index=channel_names.index(pcc_channel_name), z_index=pcc_z_index,
                fliplr=fliplr, flipud=flipud, device=device)
        if fliplr:
            shifts[:, 2] *= -1
        if flipud:
            shifts[:, 1] *= -1
        if flipxy:
            shifts = shifts[:, [0, 2, 1]]
        shifts -= np.minimum(shifts.min(axis=0), 0)
        for fov_name, zyx in zip(fov_names, shifts):
            total_translation[fov_name] = [float(v) for v in np.round(zyx, 2)]

    settings = stitch_settings_from_reference({"channels": None,
                                               "total_translation": total_translation})
    model_to_yaml(settings, Path(output_filepath))
    return settings
