"""The stabilize verb: per-timepoint 4x4 transforms, on arrays in memory
(:func:`stabilize_tczyx`) and on plates (:func:`stabilize`).

Counterpart of ``biahub_tpu/stabilize.py``: the
first transform's rotation decides whether the output YX axes swap
(:func:`_output_yx`), every channel of a timepoint is warped by that
timepoint's matrix, and the kernel is chosen from the whole matrix list
(:160-215): all translations take :func:`~biahub_tpu_torch.kernels.affine.
translation_warp_zyx_batched`, all in-plane matrices the in-plane warp with
one matrix per volume; both run kernels E and F once per batch, with a
(B, 21) coefficient table. Any other set takes the batched multipass warp
(:func:`~biahub_tpu_torch.kernels.multipass_warp.
multipass_affine_warp_zyx_batched`: kernel H once per canonical slot and
batch, with a (B, 7, 3) table, in one frame for the whole run), or the
exact gather when a matrix has a vanishing pivot
(:func:`~biahub_tpu_torch.kernels.affine.make_batched_warp`). When one
volume, its output and its frames exceed the batch budget, each volume is
warped in output chunks (the reference's :216-262). The plate verb reads
one settings file per position (matched by ``<row>_<col>_<fov>`` in its
name when there are several) and chooses the kernel and the output frame
from every position's matrices.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

from biahub_tpu_torch.apply_inverse_transfer_function import time_indices as select_times
from biahub_tpu_torch.cli.disk import check_disk_space_with_du
from biahub_tpu_torch.cli.utils import yaml_to_model
from biahub_tpu_torch.convert import stabilize_settings_from_reference
from biahub_tpu_torch.device import as_tensor, resolve_device
from biahub_tpu_torch.estimate_stabilization import DEFAULT_MAX_BATCH_BYTES
from biahub_tpu_torch.kernels.affine import affine_warp_auto, make_batched_warp
from biahub_tpu_torch.io.ngff import create_empty_plate, get_ome_zarr_version, open_ome_zarr
from biahub_tpu_torch.kernels.multipass_warp import chunked_affine_warp_zyx
from biahub_tpu_torch.runtime.executor import (
    BatchRunner,
    WorkUnit,
    resolve_cluster,
    stripe_units,
)
from biahub_tpu_torch.runtime.resources import estimate_resources

__all__ = ["apply_stabilization_transform", "stabilize_tczyx", "stabilize_batch_size",
           "stabilize"]


def apply_stabilization_transform(
    zyx_data,
    list_of_shifts: list,
    input_time_index: int,
    output_shape: tuple[int, int, int] | None = None,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """Warp one (Z, Y, X) volume, or each of a (C, Z, Y, X) stack, by the
    transform of its time index (NaN read as 0)."""
    dev = resolve_device(device)
    data = torch.nan_to_num(as_tensor(zyx_data, dev), nan=0.0)
    if output_shape is None:
        output_shape = tuple(data.shape[-3:])
    matrix = np.asarray(list_of_shifts[input_time_index], dtype=np.float64)
    if data.ndim == 4:
        return torch.stack([affine_warp_auto(c, matrix, tuple(output_shape), device=dev)
                            for c in data])
    return affine_warp_auto(data, matrix, tuple(output_shape), device=dev)


def _output_yx(matrices, Y: int, X: int) -> tuple[int, int]:
    """(Yo, Xo): swapped when the first transform is a ~90 deg rotation
    about the first axis (the reference's :71)."""
    # scipy is imported at call time: its import starts a process (numpy's
    # CPU probe), and importing the port starts none.
    from scipy.linalg import svd
    from scipy.spatial.transform import Rotation

    r_matrix = np.asarray(matrices[0], dtype=np.float64)[:3, :3]
    u, _, vt = svd(r_matrix)
    euler = Rotation.from_matrix(u @ vt).as_euler("xyz", degrees=True)
    if np.isclose(euler[0], 90, atol=10):
        return X, Y
    return Y, X


def stabilize_batch_size(in_zyx, out_zyx, n_volumes: int,
                         max_batch_bytes: int = DEFAULT_MAX_BATCH_BYTES,
                         workspace_bytes: int = 0) -> int:
    """Volumes per batch: as many as fit ``max_batch_bytes`` counting each
    volume's float32 input and output and the warp's ``workspace_bytes``
    (the multipass warp's common frames, :func:`~biahub_tpu_torch.kernels.
    multipass_warp.common_frame_bytes`), the reference runner's rule for one
    chunk in flight (runtime/executor.py:264-300, stabilize.py:216-229)."""
    unit = 4 * (int(np.prod(in_zyx)) + int(np.prod(out_zyx))) + int(workspace_bytes)
    return int(max(1, min(n_volumes, max_batch_bytes // unit)))


def stabilize_tczyx(
    tczyx,
    matrices,
    time_indices="all",
    max_batch_bytes: int = DEFAULT_MAX_BATCH_BYTES,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """Stabilize a (T, C, Z, Y, X) timelapse by one 4x4 output->input
    matrix per raw timepoint -> (len(time_indices), C, Z, Yo, Xo) float32,
    fill 0. ``time_indices``: ``"all"``, a list, or one index. The (t, c)
    volumes run in batches of :func:`stabilize_batch_size`: one launch of
    kernels E and F per batch, or of H per canonical slot for general
    matrices. Past ``max_batch_bytes`` for one volume (input, output and
    the multipass frames), each volume runs in output chunks and the result
    is in host memory (:func:`_stabilize_chunked`)."""
    dev = resolve_device(device)
    T, C, Z, Y, X = tczyx.shape
    mats = np.asarray(matrices, dtype=np.float64)
    if mats.ndim != 3 or mats.shape[1:] != (4, 4) or len(mats) < T:
        raise ValueError(f"want one 4x4 matrix per timepoint ({T}), got "
                         f"{mats.shape}")
    if time_indices == "all":
        times = list(range(T))
    elif isinstance(time_indices, list):
        times = [int(t) for t in time_indices]
    else:
        times = [int(time_indices)]
    out_y, out_x = _output_yx(mats, Y, X)
    out_zyx = (Z, out_y, out_x)
    units = [(t, c) for t in times for c in range(C)]
    # The kernel is chosen from every matrix given, as the reference's
    # (:172-213), not only from the timepoints warped.
    warp, workspace = make_batched_warp(mats, (Z, Y, X), out_zyx, dev)
    volume_bytes = 4 * (Z * Y * X + int(np.prod(out_zyx))) + workspace
    if volume_bytes > max_batch_bytes:
        return _stabilize_chunked(tczyx, mats, times, out_zyx, volume_bytes,
                                  max_batch_bytes, dev)
    out = torch.empty((len(times), C) + out_zyx, dtype=torch.float32, device=dev)
    flat = out.view(len(units), *out_zyx)
    step = stabilize_batch_size((Z, Y, X), out_zyx, len(units), max_batch_bytes, workspace)
    for i in range(0, len(units), step):
        batch = units[i:i + step]
        vols = torch.stack([as_tensor(tczyx[t, c], dev) for t, c in batch])
        flat[i:i + len(batch)] = warp(vols, mats[[t for t, _ in batch]])
    return out


def _stabilize_chunked(tczyx, mats, times, out_zyx, volume_bytes: int,
                       max_batch_bytes: int, dev: torch.device) -> torch.Tensor:
    """The reference's over-budget route (stabilize.py:216-262): one
    volume and its frames exceed ``max_batch_bytes``, so each (t, c) is
    warped by its timepoint's matrix in output chunks of ``max(32, s //
    n_splits)`` through :func:`~biahub_tpu_torch.kernels.multipass_warp.
    chunked_affine_warp_zyx`, its input read box by box. The result is in
    host memory."""
    T, C, Z, Y, X = tczyx.shape
    n_splits = max(1, int(np.ceil(volume_bytes / max_batch_bytes)))
    chunk = tuple(max(32, s // n_splits) for s in out_zyx)
    print(f"Volume exceeds the device batch budget; stabilizing in output chunks of {chunk}",
          file=sys.stderr)
    out = torch.zeros((len(times), C) + out_zyx, dtype=torch.float32)
    for t_out, t in enumerate(times):
        for c in range(C):
            def read_fn(zs, ys, xs, _t=t, _c=c):
                return tczyx[_t, _c, zs, ys, xs]

            def write_fn(zs, ys, xs, data, _t=t_out, _c=c):
                out[_t, _c, zs, ys, xs] = data.cpu()

            chunked_affine_warp_zyx(read_fn, mats[t], (Z, Y, X), out_zyx, chunk,
                                    write_fn=write_fn, device=dev)
    return out


def stabilize(
    input_position_dirpaths: list[Path],
    output_dirpath: Path,
    config_filepaths: list[Path],
    sbatch_filepath: str | None = None,
    local: bool = False,
    monitor: bool = True,
    device: str | torch.device = "cuda",
) -> None:
    """The stabilize verb on plates (the reference's ``stabilize``,
    :85-279): the output plate (YX swapped when the first settings file's
    first transform turns by ~90 deg, ``output_voxel_size`` as the scale),
    then every (t, c) unit warped by its position's float32 matrix of
    timepoint t, the kernel chosen from every position's matrices
    (:func:`~biahub_tpu_torch.kernels.affine.make_batched_warp`); over the
    batch budget in output chunks read from and written to the plates."""
    dev = resolve_device(device)
    settings = yaml_to_model(config_filepaths[0], stabilize_settings_from_reference)
    output_dirpath = Path(output_dirpath)
    dataset = open_ome_zarr(input_position_dirpaths[0])
    T, C, Z, Y, X = dataset.data.shape
    out_zyx = (Z,) + _output_yx(settings["affine_transform_zyx_list"], Y, X)
    times = select_times(settings, T)
    create_empty_plate(
        store_path=output_dirpath,
        position_keys=[Path(p).parts[-3:] for p in input_position_dirpaths],
        channel_names=dataset.channel_names,
        shape=(len(times), C) + out_zyx,
        scale=settings["output_voxel_size"],
        dtype=np.float32,
        version=settings["output_ome_zarr_version"] or get_ome_zarr_version(
            Path(input_position_dirpaths[0]).parents[2]),
    )
    if not check_disk_space_with_du(input_position_dirpaths[0], output_dirpath, margin=1.1,
                                    verbose=True):
        raise RuntimeError(f"Not enough disk space to store the output at {output_dirpath}")
    estimate_resources(shape=(T, C, Z, Y, X), ram_multiplier=16, max_num_cpus=16)
    resolved = resolve_cluster(None, local)
    print(f"Running on-device batches (mode='{resolved}')")

    def config_for(path: Path) -> dict:
        if len(config_filepaths) > 1:
            fov = "_".join(Path(path).parts[-3:])
            matches = [p for p in config_filepaths if fov in Path(p).name]
            if not matches:
                raise ValueError(f"No config file matches position {fov}")
            return yaml_to_model(matches[0], stabilize_settings_from_reference)
        return settings

    input_positions = [open_ome_zarr(p, mode="r") for p in input_position_dirpaths]
    output_positions = [open_ome_zarr(output_dirpath / Path(*Path(p).parts[-3:]), mode="r+")
                        for p in input_position_dirpaths]
    per_position = []
    for path, out_pos in zip(input_position_dirpaths, output_positions):
        fov_settings = config_for(path)
        per_position.append(np.asarray(fov_settings["affine_transform_zyx_list"],
                                       dtype=np.float32))
        out_pos.update_zattrs({"biahub-stabilize": fov_settings})
    units = [WorkUnit(p, int(t), c, c, int(t_out)) for p in range(len(input_positions))
             for t_out, t in enumerate(times) for c in range(C)]
    warp, workspace = make_batched_warp(np.concatenate(per_position), (Z, Y, X), out_zyx, dev)
    runner = BatchRunner(cluster=resolved, device=dev)
    volume_bytes = 4 * (Z * Y * X + int(np.prod(out_zyx))) + workspace
    if volume_bytes > runner.max_batch_bytes:
        n_splits = max(1, int(np.ceil(volume_bytes / runner.max_batch_bytes)))
        chunk = tuple(max(32, s // n_splits) for s in out_zyx)
        print(f"Volume exceeds the device batch budget; stabilizing in output chunks of "
              f"{chunk}")
        n = 0
        for u in stripe_units(units):
            def read_fn(zs, ys, xs, _u=u):
                return input_positions[_u.pos_idx].data[_u.t, _u.c_in, zs, ys, xs]

            def write_fn(zs, ys, xs, data, _u=u):
                output_positions[_u.pos_idx]["0"][_u.out_t, _u.c_out, zs, ys, xs] = \
                    data.cpu().numpy()

            chunked_affine_warp_zyx(read_fn, per_position[u.pos_idx][u.t].astype(np.float64),
                                    (Z, Y, X), out_zyx, chunk, write_fn=write_fn, device=dev)
            n += 1
        print(f"Stabilized {n} (t, c) volumes")
        return

    def kernel(vols: torch.Tensor, matrix: np.ndarray) -> torch.Tensor:
        return warp(vols, matrix.astype(np.float64))

    n = runner.run_units(kernel, units, input_positions, output_positions,
                         per_unit_params=lambda u: {"matrix": per_position[u.pos_idx][u.t]},
                         monitor=monitor and resolved != "debug",
                         unit_workspace_bytes=workspace)
    print(f"Stabilized {n} (t, c) volumes")
    runner.echo_stats()
