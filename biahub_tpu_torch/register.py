"""The register verb, on arrays in memory and on plates, and its helpers.

Counterpart of ``biahub_tpu/register.py``: the matrix helpers
(``get_3D_rescaling_matrix``, ``get_3D_rotation_matrix``,
``get_3D_fliplr_matrix``, :47-95), ``apply_affine_transform`` (:98-135),
``find_lir`` (:138-163), ``find_overlapping_volume`` (:166-182),
``rescale_voxel_size`` (:185-186) and, in :func:`register_arrays`, the
compute of ``register_cli`` (:217-397) without its plates: the source
channels the settings name are warped into the target frame by
``affine_warp_auto`` (the crop start folded into the matrix when the output
is cropped to the overlap), and the target's other channels are copied
cropped. A volume over the batch budget is warped in output chunks
(``kernels/multipass_warp.py::chunked_affine_warp_zyx``). :func:`register`
is the verb on plates (``register_cli``, :197-398) through the batch runner,
the same functions on the same volumes as :func:`register_arrays`.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

from biahub_tpu_torch.apply_inverse_transfer_function import time_indices
from biahub_tpu_torch.cli.utils import yaml_to_model
from biahub_tpu_torch.convert import registration_settings_from_reference
from biahub_tpu_torch.device import as_tensor, resolve_device
from biahub_tpu_torch.estimate_stabilization import DEFAULT_MAX_BATCH_BYTES
from biahub_tpu_torch.io.ngff import create_empty_plate, get_ome_zarr_version, open_ome_zarr
from biahub_tpu_torch.kernels.affine import affine_warp_auto, affine_warp_auto_batched
from biahub_tpu_torch.kernels.multipass_warp import chunked_affine_warp_zyx, common_frame_bytes
from biahub_tpu_torch.parallel.mesh import Mesh
from biahub_tpu_torch.runtime.executor import BatchRunner, resolve_cluster, stripe_units
from biahub_tpu_torch.runtime.resources import estimate_resources
from biahub_tpu_torch.transforms.lir import largest_interior_rectangle

__all__ = [
    "get_3D_rescaling_matrix",
    "get_3D_rotation_matrix",
    "get_3D_fliplr_matrix",
    "apply_affine_transform",
    "find_lir",
    "find_overlapping_volume",
    "rescale_voxel_size",
    "register_arrays",
    "register",
    "convert_transform_to_ants",
    "convert_transform_to_numpy",
]

# Interpolation names that take the nearest neighbour (order 0).
_NEAREST = ("nearest", "nearestNeighbor", "genericLabel")


def get_3D_rescaling_matrix(start_shape_zyx, scaling_factor_zyx=(1, 1, 1),
                            end_shape_zyx=None) -> np.ndarray:
    """YX-centred anisotropic rescale."""
    center_y_start, center_x_start = np.array(start_shape_zyx)[-2:] / 2
    if end_shape_zyx is None:
        center_y_end, center_x_end = center_y_start, center_x_start
    else:
        center_y_end, center_x_end = np.array(end_shape_zyx)[-2:] / 2
    sz, sy, sx = scaling_factor_zyx[-3], scaling_factor_zyx[-2], scaling_factor_zyx[-1]
    return np.array(
        [
            [sz, 0, 0, 0],
            [0, sy, 0, -center_y_start * sy + center_y_end],
            [0, 0, sx, -center_x_start * sx + center_x_end],
            [0, 0, 0, 1],
        ]
    )


def get_3D_rotation_matrix(start_shape_zyx, angle: float = 0.0,
                           end_shape_zyx=None) -> np.ndarray:
    """In-plane (YX) rotation by ``angle`` degrees about the volume centre."""
    center_y_start, center_x_start = np.array(start_shape_zyx)[-2:] / 2
    if end_shape_zyx is None:
        center_y_end, center_x_end = center_y_start, center_x_start
    else:
        center_y_end, center_x_end = np.array(end_shape_zyx)[-2:] / 2
    theta = np.radians(angle)
    c, s = np.cos(theta), np.sin(theta)
    return np.array(
        [
            [1, 0, 0, 0],
            [0, c, -s, -center_y_start * c + s * center_x_start + center_y_end],
            [0, s, c, -center_y_start * s - center_x_start * c + center_x_end],
            [0, 0, 0, 1],
        ]
    )


def get_3D_fliplr_matrix(start_shape_zyx, end_shape_zyx=None) -> np.ndarray:
    """Left-right (X) flip about the volume centre."""
    center_x_start = start_shape_zyx[-1] / 2
    center_x_end = center_x_start if end_shape_zyx is None else end_shape_zyx[-1] / 2
    return np.array(
        [
            [1, 0, 0, 0],
            [0, 1, 0, 0],
            [0, 0, -1, 2 * center_x_end],
            [0, 0, 0, 1],
        ]
    )


def _shift_to(matrix: np.ndarray, start) -> np.ndarray:
    """``matrix`` moved to an output that starts at ``start``: the crop
    start folded into the translation, so cropped voxels are never
    computed."""
    shifted = np.asarray(matrix, dtype=np.float64).copy()
    shifted[:3, 3] += shifted[:3, :3] @ np.asarray(start, dtype=np.float64)
    return shifted


def _slice_shape(slices) -> tuple[int, int, int]:
    return tuple(int(s.stop - s.start) for s in slices)


def apply_affine_transform(
    zyx_data,
    matrix,
    output_shape_zyx: tuple,
    interpolation: str = "linear",
    crop_output_slicing=None,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """Warp one ZYX volume, or each of a CZYX stack, by an output->input
    ``matrix`` through ``affine_warp_auto`` (NaN read as 0); with
    ``crop_output_slicing`` (z, y, x slices) only that region of the
    output, its start folded into the matrix. Nearest-neighbour names
    (``nearest``, ``nearestNeighbor``, ``genericLabel``) take order 0."""
    dev = resolve_device(device)
    data = torch.nan_to_num(as_tensor(zyx_data, dev), nan=0.0)
    m = np.asarray(matrix, dtype=np.float64)
    out_shape = tuple(int(s) for s in output_shape_zyx)
    if crop_output_slicing is not None:
        m = _shift_to(m, [s.start for s in crop_output_slicing])
        out_shape = _slice_shape(crop_output_slicing)
    order = 0 if interpolation in _NEAREST else 1
    if data.ndim == 4:
        return torch.stack([affine_warp_auto(c, m, out_shape, order=order, device=dev)
                            for c in data])
    return affine_warp_auto(data, m, out_shape, order=order, device=dev)


def find_lir(registered_zyx: np.ndarray) -> tuple[slice, slice, slice]:
    """ZYX slices of the largest interior rectangle of a boolean volume: the
    LIR of the central YX plane, then the Z window common to the LIRs of
    probe ZY and ZX planes at its first, middle and last column and row
    (the reference's search, biahub/register.py:287-345)."""
    registered_zyx = np.asarray(registered_zyx, dtype=bool)

    registered_yx = registered_zyx[registered_zyx.shape[0] // 2]
    x, y, width, height = largest_interior_rectangle(registered_yx)
    x_start, x_stop = x, x + width
    y_start, y_stop = y, y + height
    x_slice = slice(x_start, x_stop)
    y_slice = slice(y_start, y_stop)

    coords = []
    for _x in (x_start, x_start + (x_stop - x_start) // 2, x_stop - 1):
        _, z, _, depth = largest_interior_rectangle(registered_zyx[:, y_slice, _x])
        coords.append((z, z + depth))
    for _y in (y_start, y_start + (y_stop - y_start) // 2, y_stop - 1):
        _, z, _, depth = largest_interior_rectangle(registered_zyx[:, _y, x_slice])
        coords.append((z, z + depth))

    coords = np.asarray(coords)
    z_slice = slice(int(coords.max(axis=0)[0]), int(coords.min(axis=0)[1]))
    return (z_slice, y_slice, x_slice)


def find_overlapping_volume(
    input_zyx_shape: tuple,
    target_zyx_shape: tuple,
    transformation_matrix,
    method: str = "LIR",
    device: str | torch.device = "cuda",
) -> tuple[slice, slice, slice]:
    """ZYX slices of the overlap: a volume of ones of ``input_zyx_shape``
    warped into the target frame by ``transformation_matrix``, thresholded
    above 0, and its :func:`find_lir`."""
    if method != "LIR":
        raise ValueError(f"Unknown method {method}")
    moving = np.ones(tuple(int(s) for s in input_zyx_shape), dtype=np.float32)
    registered = apply_affine_transform(moving, transformation_matrix,
                                        tuple(target_zyx_shape), device=device)
    print("Starting Largest interior rectangle (LIR) search")
    return find_lir((registered > 0).cpu().numpy())


def rescale_voxel_size(affine_matrix, input_scale) -> np.ndarray:
    return np.linalg.norm(affine_matrix, axis=1) * input_scale


def register_arrays(
    source_tczyx,
    source_channel_names: list[str],
    settings: dict,
    source_voxel_size=(1.0, 1.0, 1.0),
    target_tczyx=None,
    target_channel_names: list[str] | None = None,
    max_batch_bytes: int = DEFAULT_MAX_BATCH_BYTES,
    device: str | torch.device = "cuda",
) -> tuple[torch.Tensor, list[str], np.ndarray]:
    """Register a (T, C, Z, Y, X) source into the target's frame ->
    ``(array, channel_names, voxel_size)``: the (len(time_indices), C_out,
    Z', Y', X') float32 output, its channels (the target's, then the
    source's unless the source is the target) and its voxel size
    (:func:`rescale_voxel_size` of the matrix's linear part). ``settings``:
    ``RegistrationSettings`` as a dict. ``target_tczyx`` None: the source
    is the target (one store).

    Without ``keep_overhang`` the output is the target frame cropped to the
    overlap's LIR (:func:`find_overlapping_volume`), the crop start folded
    into the matrix. The named source channels are warped by
    ``affine_warp_auto`` (``interpolation`` ``nearest`` or
    ``nearestNeighbor``: order 0), in batches on the device; the target's
    channels that are not registered are copied cropped; any other output
    channel stays 0. When one volume, its output and the multipass frames
    exceed ``max_batch_bytes`` (the reference's :320-374), each volume is
    warped in output chunks of ``max(32, s // n)`` and the result is in host
    memory."""
    dev = resolve_device(device)
    rs = registration_settings_from_reference(settings)
    matrix = np.array(rs["affine_transform_zyx"], dtype=np.float64)
    same = target_tczyx is None
    target = source_tczyx if same else target_tczyx
    target_names = list(source_channel_names if same else target_channel_names)
    T = source_tczyx.shape[0]
    source_shape = tuple(int(s) for s in source_tczyx.shape[-3:])
    target_shape = tuple(int(s) for s in target.shape[-3:])
    voxel_size = rescale_voxel_size(matrix[:3, :3], np.asarray(source_voxel_size)[-3:])
    times = time_indices(rs, T)
    out_names = list(target_names) + ([] if same else list(source_channel_names))
    if rs["keep_overhang"]:
        crop = tuple(slice(0, s) for s in target_shape)
    else:
        crop = find_overlapping_volume(source_shape, target_shape, matrix, device=dev)
    out_shape = _slice_shape(crop)
    warp_matrix = matrix if rs["keep_overhang"] else _shift_to(matrix, [s.start for s in crop])
    order = 0 if rs["interpolation"] in ("nearest", "nearestNeighbor") else 1
    pairs = [(source_channel_names.index(name), out_names.index(name))
             for name in source_channel_names if name in rs["source_channel_names"]]
    workspace = common_frame_bytes(warp_matrix, source_shape, out_shape)
    volume_bytes = 4 * (int(np.prod(source_shape)) + int(np.prod(out_shape))) + workspace
    units = [(t_out, t, c_in, c_out) for t_out, t in enumerate(times) for c_in, c_out in pairs]
    over = volume_bytes > max_batch_bytes
    out = torch.zeros((len(times), len(out_names)) + out_shape, dtype=torch.float32,
                      device="cpu" if over else dev)
    if over:
        chunk = tuple(max(32, s // max(1, int(np.ceil(volume_bytes / max_batch_bytes))))
                      for s in out_shape)
        print(f"Volume exceeds the device batch budget; warping in output chunks of {chunk}",
              file=sys.stderr)
        for t_out, t, c_in, c_out in units:
            def read_fn(zs, ys, xs, _t=t, _c=c_in):
                return source_tczyx[_t, _c, zs, ys, xs]

            def write_fn(zs, ys, xs, data, _t=t_out, _c=c_out):
                out[_t, _c, zs, ys, xs] = data.cpu()

            chunked_affine_warp_zyx(read_fn, warp_matrix, source_shape, out_shape, chunk,
                                    write_fn=write_fn, order=order, device=dev)
    else:
        step = max(1, min(len(units), max_batch_bytes // volume_bytes)) if units else 1
        for i in range(0, len(units), step):
            batch = units[i:i + step]
            vols = torch.stack([as_tensor(source_tczyx[t, c], dev) for _, t, c, _ in batch])
            warped = affine_warp_auto_batched(vols, warp_matrix, out_shape, order=order,
                                              device=dev)
            for (t_out, _, _, c_out), w in zip(batch, warped):
                out[t_out, c_out] = w
    copies = [(target_names.index(name), out_names.index(name))
              for name in target_names if name not in rs["source_channel_names"]]
    for t_out, t in enumerate(times):
        for c_in, c_out in copies:
            out[t_out, c_out] = as_tensor(target[t, c_in][crop], out.device)
    return out, out_names, voxel_size


def register(
    source_position_dirpaths: list[Path],
    target_position_dirpaths: list[Path],
    config_filepath: Path,
    output_dirpath: Path,
    local: bool = False,
    sbatch_filepath: str | None = None,
    monitor: bool = True,
    device: str | torch.device = "cuda",
    mesh: Mesh | None = None,
) -> None:
    """The register verb on plates (the reference's ``register_cli``,
    :197-398): the output plate in the target's frame (cropped to the
    overlap's LIR without ``keep_overhang``, the crop start folded into the
    matrix) at :func:`rescale_voxel_size`, the named source channels warped
    by ``affine_warp_auto`` in device batches split over ``mesh`` (default:
    every card; over the budget in output
    chunks, read from and written to the plates), the target's other
    channels copied cropped."""
    dev = resolve_device(device)
    output_dirpath = Path(output_dirpath)
    settings = yaml_to_model(config_filepath, registration_settings_from_reference)
    matrix = np.array(settings["affine_transform_zyx"], dtype=np.float64)
    keep_overhang = settings["keep_overhang"]
    source_dataset = open_ome_zarr(source_position_dirpaths[0])
    T, C, Z, Y, X = source_dataset.data.shape
    source_channel_names = source_dataset.channel_names
    source_shape = tuple(source_dataset.data.shape[-3:])
    output_voxel_size = rescale_voxel_size(matrix[:3, :3], source_dataset.scale[-3:])
    target_dataset = open_ome_zarr(target_position_dirpaths[0])
    target_channel_names = target_dataset.channel_names
    target_shape = tuple(target_dataset.data.shape[-3:])
    print("\nREGISTRATION PARAMETERS:")
    print(f"Transformation matrix:\n{matrix}")
    print(f"Voxel size: {output_voxel_size}")
    times = time_indices(settings, T)
    output_channel_names = list(target_channel_names)
    if target_position_dirpaths != source_position_dirpaths:
        output_channel_names += list(source_channel_names)
    if not keep_overhang:
        print("\nFinding largest overlapping volume between source and target datasets")
        crop = find_overlapping_volume(source_shape, target_shape, matrix, device=dev)
        out_shape = _slice_shape(crop)
        print(f"Shape of cropped output dataset: {out_shape}\n")
    else:
        crop = tuple(slice(0, s) for s in target_shape)
        out_shape = target_shape
    create_empty_plate(
        store_path=output_dirpath,
        position_keys=[Path(p).parts[-3:] for p in source_position_dirpaths],
        channel_names=output_channel_names,
        shape=(len(times), len(output_channel_names)) + tuple(out_shape),
        scale=(1, 1) + tuple(output_voxel_size),
        dtype=np.float32,
        version=settings["output_ome_zarr_version"] or get_ome_zarr_version(
            Path(source_position_dirpaths[0]).parents[2]),
    )
    estimate_resources(shape=(T, C, Z, Y, X), ram_multiplier=5)
    resolved = resolve_cluster(None, local)
    print(f"Running on-device batches (mode='{resolved}')")
    warp_matrix = matrix if keep_overhang else _shift_to(matrix, [s.start for s in crop])
    order = 0 if settings["interpolation"] in ("nearest", "nearestNeighbor") else 1
    source_positions = [open_ome_zarr(p, mode="r") for p in source_position_dirpaths]
    target_positions = [open_ome_zarr(p, mode="r") for p in target_position_dirpaths]
    output_positions = [open_ome_zarr(output_dirpath / Path(*Path(p).parts[-3:]), mode="r+")
                        for p in source_position_dirpaths]
    for out_pos in output_positions:
        out_pos.update_zattrs({"biahub-register": {
            "affine_transformation": {"transform_matrix": matrix.tolist()},
            "settings": settings}})
    runner = BatchRunner(cluster=resolved, device=dev, mesh=mesh)
    pairs = [(source_channel_names.index(name), output_channel_names.index(name))
             for name in source_channel_names if name in settings["source_channel_names"]]
    workspace = common_frame_bytes(warp_matrix, source_shape, out_shape)
    volume_bytes = 4 * (int(np.prod(source_shape)) + int(np.prod(out_shape))) + workspace
    if volume_bytes > runner.max_batch_bytes:
        chunk = tuple(max(32, s // max(1, int(np.ceil(volume_bytes / runner.max_batch_bytes))))
                      for s in out_shape)
        print(f"Volume exceeds the device batch budget; warping in output chunks of {chunk}")
        units = [(src, out, int(t), t_out, c_in, c_out)
                 for src, out in zip(source_positions, output_positions)
                 for t_out, t in enumerate(times) for c_in, c_out in pairs]
        n = 0
        for src, out, t, t_out, c_in, c_out in stripe_units(units):
            def read_fn(zs, ys, xs, _t=t, _c=c_in, _p=src):
                return _p.data[_t, _c, zs, ys, xs]

            def write_fn(zs, ys, xs, data, _t=t_out, _c=c_out, _p=out):
                _p["0"][_t, _c, zs, ys, xs] = data.cpu().numpy()

            chunked_affine_warp_zyx(read_fn, warp_matrix, source_shape, out_shape, chunk,
                                    write_fn=write_fn, order=order, device=dev)
            n += 1
    else:
        def kernel(vols: torch.Tensor) -> torch.Tensor:
            return affine_warp_auto_batched(vols, warp_matrix, out_shape, order=order,
                                            device=vols.device)

        n = runner.run_zyx(kernel, source_positions, output_positions, channel_pairs=pairs,
                           time_indices=times, monitor=monitor and resolved != "debug",
                           unit_workspace_bytes=workspace)
    copies = [(target_channel_names.index(name), output_channel_names.index(name))
              for name in target_channel_names if name not in settings["source_channel_names"]]
    futures = []
    for in_pos, out_pos in zip(target_positions, output_positions):
        for t_out, t in enumerate(times):
            for c_in, c_out in copies:
                data = in_pos.data[(int(t), int(c_in)) + tuple(crop)]
                futures.append(out_pos["0"].write_async((t_out, c_out),
                                                        data.astype(np.float32)))
    for f in futures:
        f.result()
    print(f"Registered {n} (t, c) volumes")
    runner.echo_stats()


def convert_transform_to_ants(T_numpy):
    """The reference's shim (register.py:430): ANTs transform objects are
    not part of the port either; every warp and registration function takes
    the 4x4 matrix itself. Raises ``ImportError``."""
    raise ImportError(
        "ANTs transform objects are not part of biahub_tpu_torch; pass the 4x4 "
        "numpy matrix directly (every warp and registration function takes it)."
    )


def convert_transform_to_numpy(T_ants):
    """The reference's shim (register.py:441); see
    :func:`convert_transform_to_ants`. Raises ``ImportError``."""
    raise ImportError(
        "ANTs transform objects are not part of biahub_tpu_torch; transforms are "
        "already plain 4x4 numpy matrices here."
    )
