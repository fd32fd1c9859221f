"""The deskew verb, on arrays in memory and on plates.

Counterpart of ``biahub_tpu/deskew.py::deskew`` (:143-296):
:func:`deskew_arrays` is its compute on a (T, C, Z, Y, X) array,
:func:`deskew` the verb on plates through the batch runner. Every (t, c)
volume is
deskewed by kernel D in batches, its overhang filled where the settings ask
(``kernels/deskew.py::fill_overhang``), in the standard frame (the
reference deskews with ``skip_flip`` and flips Y on the host, ``post_fetch``
at :292; here kernel D reads the coverslip axis reversed, which gives the
same values).

When one volume and its output exceed the batch budget (compared as the
reference does, :222-223), each volume is deskewed in input-X slabs (=
output-Y slabs: the scan resample involves only the scan and tilt axes, so
the split is exact) without the fill, and the fill then runs in output-Y
slabs with a 4-voxel halo and the mean from a first sweep
(:func:`fill_overhang_chunked`, the reference's ``_fill_overhang_chunked``,
:103-140). That result is in host memory, as the reference's is on its
plate. The plate verb computes the same functions on the same volumes,
so its plate equals :func:`deskew_arrays` bit for bit (the coverslip flip
stays inside kernel D rather than in the runner's ``post_fetch``).
"""

from __future__ import annotations

import sys
import warnings
from pathlib import Path

import numpy as np
import torch

from biahub_tpu_torch.cli.utils import PROVENANCE_METADATA_KEYS, get_output_paths, yaml_to_model
from biahub_tpu_torch.convert import deskew_settings_dump, deskew_settings_from_reference
from biahub_tpu_torch.device import as_tensor, resolve_device
from biahub_tpu_torch.estimate_stabilization import DEFAULT_MAX_BATCH_BYTES
from biahub_tpu_torch.io.ngff import create_empty_plate, get_ome_zarr_version, open_ome_zarr
from biahub_tpu_torch.io.progress import ProgressStore
from biahub_tpu_torch.kernels.deskew import (
    deskew_geometry,
    deskew_zyx,
    fill_overhang_,
    get_deskewed_data_shape,
    overhang_fill_value,
    overhang_mask,
)
from biahub_tpu_torch.kernels.deskew_cuda import deskew as deskew_batch
from biahub_tpu_torch.parallel.mesh import Mesh
from biahub_tpu_torch.runtime.executor import (
    BatchRunner,
    resolve_cluster,
    sbatch_to_overrides,
    stripe_units,
)
from biahub_tpu_torch.runtime.resources import (
    echo_resources,
    estimate_resources,
    settings_fingerprint,
)

__all__ = ["deskew_arrays", "deskew_slabbed", "fill_overhang_chunked", "deskew"]

# The dilation reaches 3 voxels: a 4-voxel halo gives each slab the mask of
# the whole volume.
HALO = 4


def deskew_slabbed(vol, dk: dict, x_chunk: int, device: torch.device) -> torch.Tensor:
    """Deskew one (Z, Y, X) volume in input-X slabs of ``x_chunk`` ->
    (groups, Y_out, X_out) float32 in host memory, the standard frame and no
    fill: each slab goes to the device alone, and its output (Y reversed
    within the slab) lands at Y_out ``[X - x1, X - x0)``. ``dk``: the
    deskew's keyword arguments (``convert.deskew_settings_from_reference``)."""
    Z, Y, X = vol.shape
    out_zyx, _ = get_deskewed_data_shape((Z, Y, X), dk["ls_angle_deg"], dk["px_to_scan_ratio"],
                                         dk["keep_overhang"], dk["average_window"])
    out = torch.empty(out_zyx, dtype=torch.float32)
    for x0 in range(0, X, x_chunk):
        x1 = min(x0 + x_chunk, X)
        slab = deskew_zyx(as_tensor(vol[:, :, x0:x1], device), dk["ls_angle_deg"],
                          dk["px_to_scan_ratio"], dk["keep_overhang"], dk["average_window"],
                          device=device)
        out[:, X - x1:X - x0, :] = slab.cpu()
    return out


def _center(vol: torch.Tensor, y0: int, y1: int, device: torch.device):
    """The slab ``[y0, y1)`` of ``vol`` on the device, and its mask from the
    slab widened by the halo (clipped to the volume)."""
    lo, hi = max(0, y0 - HALO), min(vol.shape[1], y1 + HALO)
    mask = overhang_mask(as_tensor(vol[:, lo:hi], device))
    return as_tensor(vol[:, y0:y1], device), mask[:, y0 - lo:y1 - lo]


def fill_overhang_chunked(vol: torch.Tensor, fill, y_chunk: int,
                          device: torch.device) -> torch.Tensor:
    """``fill_overhang`` of one deskewed (Z, Y, X) volume in host memory, in
    place, in Y slabs of ``y_chunk`` with a 4-voxel halo: a first sweep sums
    the voxels outside each slab's mask for the mean (``fill == "mean"``),
    a second fills each slab, reading it after the previous slab's write as
    the reference does. ``fill``: ``"mean"`` or a float."""
    Y = vol.shape[1]
    if fill == "mean":
        total, count = 0.0, 0
        for y0 in range(0, Y, y_chunk):
            slab, mask = _center(vol, y0, min(y0 + y_chunk, Y), device)
            valid = ~mask
            total += float(torch.where(valid, slab, 0.0).sum(dtype=torch.float64))
            count += int(valid.sum())
        value = float(np.float32(total / max(count, 1)))
    else:
        value = float(fill)
    for y0 in range(0, Y, y_chunk):
        y1 = min(y0 + y_chunk, Y)
        slab, mask = _center(vol, y0, y1, device)
        vol[:, y0:y1] = torch.where(mask, torch.tensor(value, device=device), slab).cpu()
    return vol


def deskew_arrays(
    tczyx,
    settings: dict,
    max_batch_bytes: int = DEFAULT_MAX_BATCH_BYTES,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """Deskew each (t, c) volume of a (T, C, Z, Y, X) array -> (T, C,
    groups, Y_out, X_out) float32. ``settings``: the deskew verb's settings
    as a dict (``settings/example_deskew_settings.yml`` as loaded). In
    budget, batches of as many volumes as ``max_batch_bytes`` holds (input
    and output counted) run through kernel D and the fill, on the device;
    over it, each volume in X slabs and a chunked fill, in host memory."""
    dev = resolve_device(device)
    dk = deskew_settings_from_reference(settings)
    T, C, Z, Y, X = tczyx.shape
    out_zyx, _ = get_deskewed_data_shape((Z, Y, X), dk["ls_angle_deg"], dk["px_to_scan_ratio"],
                                         dk["keep_overhang"], dk["average_window"])
    fill = overhang_fill_value(dk["keep_overhang"], dk["overhang_fill"])
    volume_bytes = 4 * (Z * Y * X + int(np.prod(out_zyx)))
    units = [(t, c) for t in range(T) for c in range(C)]
    if volume_bytes > max_batch_bytes:
        n_splits = -(-volume_bytes // max_batch_bytes)
        x_chunk = max(1, -(-X // int(n_splits)))
        print(f"Volume exceeds the device batch budget; deskewing in {n_splits} X-slabs of "
              f"{x_chunk}", file=sys.stderr)
        out = torch.empty((T, C) + tuple(out_zyx), dtype=torch.float32)
        for t, c in units:
            out[t, c] = deskew_slabbed(tczyx[t, c], dk, x_chunk, dev)
            if fill is not None:
                fill_overhang_chunked(out[t, c], fill, x_chunk, dev)
        return out
    geo = deskew_geometry((Z, Y, X), dk["ls_angle_deg"], dk["px_to_scan_ratio"],
                          dk["keep_overhang"], dk["average_window"])
    out = torch.empty((T, C) + tuple(out_zyx), dtype=torch.float32, device=dev)
    flat = out.view((T * C,) + tuple(out_zyx))
    step = max(1, min(len(units), max_batch_bytes // volume_bytes))
    for i in range(0, len(units), step):
        batch = units[i:i + step]
        vols = torch.stack([as_tensor(tczyx[t, c], dev) for t, c in batch])
        flat[i:i + len(batch)] = fill_overhang_(deskew_batch(vols, geo), fill)
    return out


def deskew(
    input_position_dirpaths: list[Path],
    config_filepath: Path,
    output_dirpath: Path,
    sbatch_filepath: str | None = None,
    cluster: str = "slurm",
    monitor: bool = True,
    init_only: bool = False,
    resume: bool = False,
    device: str | torch.device = "cuda",
    mesh: Mesh | None = None,
) -> None:
    """The deskew verb on plates (the reference's ``deskew``, :143-296):
    the output plate at the deskewed shape and voxel size, then every (t, c)
    volume through kernel D and the fill in device batches split over
    ``mesh`` (default: every card); over the batch
    budget, each volume in X slabs and a chunked fill
    (:func:`deskew_slabbed`, :func:`fill_overhang_chunked`)."""
    dev = resolve_device(device)
    output_dirpath = Path(output_dirpath)
    settings = yaml_to_model(config_filepath, deskew_settings_dump)
    dk = deskew_settings_from_reference(settings)
    zarr_pixel_size = float(open_ome_zarr(str(input_position_dirpaths[0]), mode="r").scale[-1])
    if zarr_pixel_size > 0 and not np.isclose(settings["pixel_size_um"], zarr_pixel_size,
                                              rtol=0.05):
        warnings.warn(f"Config pixel_size_um={settings['pixel_size_um']} differs from the input "
                      f"zarr metadata XY scale ({zarr_pixel_size:.4f}).", stacklevel=2)
    input_dataset = open_ome_zarr(str(input_position_dirpaths[0]), mode="r")
    T, C, Z, Y, X = input_dataset.data.shape
    args = ((Z, Y, X), dk["ls_angle_deg"], dk["px_to_scan_ratio"], dk["keep_overhang"],
            dk["average_window"])
    out_zyx, voxel_size = get_deskewed_data_shape(*args, settings["pixel_size_um"])
    input_plate = Path(input_position_dirpaths[0]).parents[2]
    create_empty_plate(
        store_path=output_dirpath,
        position_keys=[Path(p).parts[-3:] for p in input_position_dirpaths],
        channel_names=input_dataset.channel_names,
        shape=(T, C) + tuple(out_zyx),
        scale=(1, 1) + tuple(voxel_size),
        version=settings["output_ome_zarr_version"] or get_ome_zarr_version(input_plate),
        metadata_sources=input_plate,
        metadata_keys=PROVENANCE_METADATA_KEYS,
    )
    time_minutes, num_cpus, gb_ram_per_cpu = estimate_resources(
        shape=(T, C, Z, Y, X), ram_multiplier=8, time_multiplier=0.5, max_num_cpus=16)
    echo_resources(num_cpus, num_cpus * gb_ram_per_cpu, time_minutes)
    if init_only:
        print(f"Initialized {output_dirpath} ({len(input_position_dirpaths)} positions)")
        return
    if sbatch_filepath:
        print(f"Resource overrides (compatibility): {sbatch_to_overrides(sbatch_filepath)}")
    resolved = resolve_cluster(cluster=cluster)
    print(f"Running on-device batches (mode='{resolved}')")

    input_positions = [open_ome_zarr(p, mode="r") for p in input_position_dirpaths]
    output_positions = [open_ome_zarr(p, mode="r+")
                        for p in get_output_paths(input_position_dirpaths, output_dirpath)]
    for out_pos in output_positions:
        out_pos.update_zattrs({"biahub-deskew": settings})
    fill = overhang_fill_value(dk["keep_overhang"], dk["overhang_fill"])
    token = settings_fingerprint(settings)
    runner = BatchRunner(cluster=resolved, device=dev, mesh=mesh)
    volume_bytes = 4 * (Z * Y * X + int(np.prod(out_zyx)))
    if volume_bytes > runner.max_batch_bytes:
        n_splits = -(-volume_bytes // runner.max_batch_bytes)
        x_chunk = max(1, -(-X // int(n_splits)))
        print(f"Volume exceeds the device batch budget; deskewing in {n_splits} X-slabs of "
              f"{x_chunk}")
        progress: dict[int, ProgressStore] = {}
        n = 0
        for p_idx, t, c in stripe_units([(p, t, c) for p in range(len(input_positions))
                                         for t in range(T) for c in range(C)]):
            out_pos = output_positions[p_idx]
            if resume and p_idx not in progress:
                progress[p_idx] = ProgressStore(out_pos.path, token)
            if p_idx in progress and progress[p_idx].is_done(t, c):
                n += 1
                continue
            vol = deskew_slabbed(input_positions[p_idx].data[t, c], dk, x_chunk, dev)
            if fill is not None:
                fill_overhang_chunked(vol, fill, x_chunk, dev)
            out_pos["0"][t, c] = vol.numpy()
            if p_idx in progress:
                progress[p_idx].mark_done(t, c)
            n += 1
    else:
        geo = deskew_geometry(*args)

        def kernel(vols: torch.Tensor) -> torch.Tensor:
            return fill_overhang_(deskew_batch(vols, geo), fill)

        n = runner.run_zyx(kernel, input_positions, output_positions, resume=resume,
                           resume_token=token, monitor=monitor and resolved != "debug")
    print(f"Deskewed {n} (t, c) volumes across {len(input_positions)} positions")
    for path in input_position_dirpaths:
        print(f"Deskew complete: {path}")
    runner.echo_stats()
