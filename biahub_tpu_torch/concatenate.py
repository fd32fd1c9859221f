"""The concatenate verb: positions of several stores merged into one plate.

Counterpart of ``biahub_tpu/concatenate.py`` (:50-464): per path the
channels to take (deduplicated by name: a repeated channel writes into the
first one's index), per path Z/Y/X crop windows, the time indices, the
output dtype (the inputs' when they agree, else float32), one output
position per input position (``ensure_unique_positions`` suffixes a
repeated key), resolve mode (``--concat-data-paths`` writes the config with
those paths and exits), ``--init`` (the plate and the ``RESOURCES:`` line
only) and ``--resume`` (each position's finished (t, c) units are skipped,
keyed by the settings' fingerprint). The output plate is created
idempotently, carrying the provenance attributes of the last source plate.

The verb does no arithmetic but ``nan_to_num`` and the cast to the output
dtype, so, as the reference, it runs on the host and no data goes to the
card: (t, c) units are read, cleaned and written in windows of 8, the
units of a window on 8 threads.
"""

from __future__ import annotations

import glob
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from biahub_tpu_torch.cli.parsing import natsorted
from biahub_tpu_torch.cli.utils import (
    PROVENANCE_METADATA_KEYS,
    get_output_paths,
    model_to_yaml,
    yaml_to_model,
)
from biahub_tpu_torch.cli.yaml_reader import load_file
from biahub_tpu_torch.convert import concatenate_settings_from_reference
from biahub_tpu_torch.io.ngff import create_empty_plate, get_ome_zarr_version, open_ome_zarr
from biahub_tpu_torch.io.progress import ProgressStore
from biahub_tpu_torch.runtime.executor import resolve_cluster
from biahub_tpu_torch.runtime.resources import (
    echo_resources,
    estimate_resources,
    settings_fingerprint,
)

__all__ = ["concatenate", "concatenate_verb", "resolve_concatenate_config", "get_slice",
           "get_path_slice_param", "get_channel_combiner_metadata"]

#: (t, c) units read and written at once.
WINDOW = 8


def get_path_slice_param(slice_param, path_index, total_paths):
    """One path's slice spec: "all", the shared [start, end], or its own."""
    if slice_param == "all":
        return "all"
    if isinstance(slice_param, list):
        if len(slice_param) == 2 and all(isinstance(i, int) for i in slice_param):
            return slice_param
        return slice_param[path_index] if path_index < len(slice_param) else slice_param[-1]
    return slice_param


def get_slice(slice_param, max_value: int) -> slice:
    if slice_param == "all":
        return slice(0, max_value)
    if (isinstance(slice_param, list) and len(slice_param) == 2
            and all(isinstance(i, int) for i in slice_param)):
        return slice(*slice_param)
    raise ValueError(f"Invalid slice parameter: {slice_param}")


def create_path_slicing_params(path_z_slice, path_y_slice, path_x_slice, dataset_shape):
    return [get_slice(path_z_slice, dataset_shape[2]), get_slice(path_y_slice, dataset_shape[3]),
            get_slice(path_x_slice, dataset_shape[4])]


def calculate_cropped_size(slice_params_zyx) -> tuple[int, int, int]:
    sizes = tuple(abs(s.stop - s.start) for s in slice_params_zyx)
    print(f"Output ZYX shape after cropping: {sizes}")
    return sizes


def validate_slicing_params_zyx(slicing_params_list) -> None:
    first = calculate_cropped_size(slicing_params_list[0])
    for i, params in enumerate(slicing_params_list[1:], 1):
        size = calculate_cropped_size(params)
        if size != first:
            raise ValueError(
                f"Inconsistent slice sizes detected. Path 0 has size {first}, but path {i} "
                f"has size {size}. All paths must have the same slice size.")


def get_channel_combiner_metadata(data_paths_list: list[str], processing_channel_names: list,
                                  slicing_params: list):
    """The paths' globs expanded; the merged channel list, and per position
    its input and output channel indices and its ZYX slices."""
    z_slice_param, y_slice_param, x_slice_param = slicing_params
    expanded_paths = [[Path(p) for p in natsorted(glob.glob(str(paths))) if Path(p).is_dir()]
                      for paths in data_paths_list]
    all_data_paths = [p for group in expanded_paths for p in group]

    all_channel_names: list[str] = []
    input_channel_idx: list[list[int]] = []
    output_channel_idx: list[list[int]] = []
    all_slicing_params: list[list[slice]] = []
    counter = 0
    for i, (paths, per_datapath_channels) in enumerate(
            zip(expanded_paths, processing_channel_names)):
        dataset = open_ome_zarr(paths[0])
        channel_names = dataset.channel_names
        path_z = get_path_slice_param(z_slice_param, i, len(data_paths_list))
        path_y = get_path_slice_param(y_slice_param, i, len(data_paths_list))
        path_x = get_path_slice_param(x_slice_param, i, len(data_paths_list))
        for _ in paths:
            all_slicing_params.append(
                create_path_slicing_params(path_z, path_y, path_x, dataset.data.shape))
        if per_datapath_channels == "all":
            per_datapath_channels = channel_names
        out_indices: list[int] = []
        in_indices: list[int] = []
        for channel in per_datapath_channels:
            if channel in channel_names:
                if channel not in all_channel_names:
                    all_channel_names.append(channel)
                    out_indices.append(counter)
                    counter += 1
                else:
                    print(f"Warning: Channel {channel} already exists. Skipping and using "
                          "index from the first entry.")
                    counter = all_channel_names.index(channel)
                    out_indices.append(counter)
                in_indices.append(channel_names.index(channel))
        input_channel_idx.extend([in_indices for _ in paths])
        output_channel_idx.extend([out_indices for _ in paths])

    if len(all_slicing_params) > 1:
        validate_slicing_params_zyx(all_slicing_params)
    print(f"Channel names: {all_channel_names}")
    print(f"Input channel indices: {input_channel_idx}")
    print(f"Output channel indices: {output_channel_idx}")
    return (all_data_paths, all_channel_names, input_channel_idx, output_channel_idx,
            all_slicing_params)


def _unique_source_plates(data_paths: list[Path]) -> list[Path]:
    seen: set = set()
    plates = []
    for p in data_paths:
        plate = Path(p).parents[2]
        if plate not in seen:
            seen.add(plate)
            plates.append(plate)
    return plates


def _resolve_time_indices(settings: dict, all_shapes) -> list[int]:
    T = all_shapes[0][0]
    time_indices = settings["time_indices"]
    if time_indices == "all":
        if not all(s[0] == T for s in all_shapes):
            print("Warning: Datasets have different number of time points. Taking the "
                  "smallest number of time points.")
        return list(range(min(s[0] for s in all_shapes)))
    if isinstance(time_indices, list):
        return time_indices
    if isinstance(time_indices, int):
        return [time_indices]
    return list(range(T))


def _prepare_concatenate(settings: dict, output_dirpath: Path) -> dict:
    """The positions, channels and crops, and the output plate created
    idempotently."""
    (all_data_paths, all_channel_names, input_channel_idx_list, output_channel_idx_list,
     all_slicing_params) = get_channel_combiner_metadata(
        settings["concat_data_paths"], settings["channel_names"],
        [settings["Z_slice"], settings["Y_slice"], settings["X_slice"]])
    output_position_paths = get_output_paths(
        all_data_paths, output_dirpath,
        ensure_unique_positions=settings["ensure_unique_positions"])

    all_shapes, all_dtypes, all_voxel_sizes = [], [], []
    for path in all_data_paths:
        dataset = open_ome_zarr(path)
        if len(dataset.array_names()) > 1:
            raise ValueError("Concatenation of datasets with multiple arrays (pyramid levels) "
                             "is not supported.")
        all_shapes.append(dataset.data.shape)
        all_dtypes.append(dataset.data.dtype)
        all_voxel_sizes.append(dataset.scale[-3:])

    all_crop = all(settings[k] == "all" for k in ("Z_slice", "Y_slice", "X_slice"))
    same_zyx = all(s[-3:] == all_shapes[0][-3:] for s in all_shapes)
    if all_crop and not same_zyx:
        raise ValueError("Datasets have different shapes. All ZYX shapes must match to "
                         "concatenate when using 'all' for slicing.")
    if not all(v == all_voxel_sizes[0] for v in all_voxel_sizes):
        print("Warning: Datasets have different voxel sizes. Taking the first voxel size.")

    T, C, Z, Y, X = all_shapes[0]
    if all(d == all_dtypes[0] for d in all_dtypes):
        dtype = all_dtypes[0]
    else:
        print("Warning: not all dtypes match. Casting data at float32.")
        dtype = np.float32
    input_time_indices = _resolve_time_indices(settings, all_shapes)
    if not same_zyx:
        print("Warning: Datasets have different shapes, but slicing parameters are specified. "
              "Will validate output shapes after cropping.")
    cropped_shape_zyx = calculate_cropped_size(all_slicing_params[0])
    if cropped_shape_zyx[0] > Z or cropped_shape_zyx[1] > Y or cropped_shape_zyx[2] > X:
        raise ValueError("The cropped shape is larger than the original shape.")

    chunks = settings["chunks_czyx"]
    create_empty_plate(
        store_path=output_dirpath,
        position_keys=[Path(p).parts[-3:] for p in output_position_paths],
        channel_names=all_channel_names,
        shape=(len(input_time_indices), len(all_channel_names)) + tuple(cropped_shape_zyx),
        chunks=[1] + list(chunks) if chunks else None,
        shards_ratio=settings["shards_ratio"],
        scale=(1,) * 2 + tuple(all_voxel_sizes[0]),
        dtype=dtype,
        version=settings["output_ome_zarr_version"] or get_ome_zarr_version(
            Path(all_data_paths[0]).parents[2]),
        metadata_sources=_unique_source_plates(all_data_paths)[-1],
        metadata_keys=PROVENANCE_METADATA_KEYS,
    )
    print(f"Created {output_dirpath} ({len(output_position_paths)} positions)")
    return {
        "all_data_paths": all_data_paths,
        "output_position_paths": output_position_paths,
        "input_channel_idx_list": input_channel_idx_list,
        "output_channel_idx_list": output_channel_idx_list,
        "all_slicing_params": all_slicing_params,
        "input_time_indices": input_time_indices,
        "shape": (T, C, Z, Y, X),
    }


def resolve_concatenate_config(config_path, output_config, concat_data_paths) -> None:
    """Resolve mode: the config at ``config_path`` with its
    ``concat_data_paths`` replaced, validated and written to
    ``output_config``."""
    raw = load_file(Path(config_path))
    raw["concat_data_paths"] = list(concat_data_paths)
    model_to_yaml(concatenate_settings_from_reference(raw), output_config)
    print(f"Resolved config written to {output_config}")


def _copy_unit(in_arr, out_arr, unit, zyx_slicing) -> tuple[int, int]:
    """One (t_out, t_in, c_in, c_out) unit: its crop read, ``nan_to_num``-ed
    in place, cast to the output dtype and written."""
    t_out, t_in, c_in, c_out = unit
    data = in_arr[(int(t_in), int(c_in), *zyx_slicing)]
    np.nan_to_num(data, copy=False, nan=0)
    out_arr[(t_out, c_out)] = data.astype(out_arr.dtype, copy=False)
    return t_out, c_out


def _copy_position(in_pos, out_pos, units, zyx_slicing, progress) -> None:
    """Every unit of one position, WINDOW at a time on as many threads (the
    reads, ``nan_to_num`` and writes of a window overlap; file I/O and
    NumPy release the GIL); a unit is marked done once its window is
    written."""
    in_arr, out_arr = in_pos["0"], out_pos["0"]
    with ThreadPoolExecutor(WINDOW) as pool:
        for w0 in range(0, len(units), WINDOW):
            done = list(pool.map(lambda u: _copy_unit(in_arr, out_arr, u, zyx_slicing),
                                 units[w0:w0 + WINDOW]))
            if progress is not None:
                progress.mark_many_done(done)


def concatenate(
    settings: dict,
    output_dirpath: Path,
    sbatch_filepath: str | None = None,
    cluster: str = "slurm",
    block: bool = False,
    monitor: bool = True,
    init_only: bool = False,
    resume: bool = False,
) -> None:
    """Concatenate the positions of a validated ``ConcatenateSettings`` dict
    (:func:`~biahub_tpu_torch.convert.concatenate_settings_from_reference`)
    into the plate ``output_dirpath``."""
    prep = _prepare_concatenate(settings, output_dirpath)
    T, C, Z, Y, X = prep["shape"]
    batch_size = settings["shards_ratio"][0] if settings["shards_ratio"] else 1
    _, num_cpus, gb_ram_per_cpu = estimate_resources(
        shape=(max(T // batch_size, 1), C, Z, Y, X), ram_multiplier=8 * batch_size,
        max_num_cpus=16)
    echo_resources(num_cpus, num_cpus * gb_ram_per_cpu, 360)
    if init_only:
        return
    resolve_cluster(cluster=cluster)
    token = settings_fingerprint(settings)
    for in_path, out_path, in_channels, out_channels, zyx_slicing in zip(
            prep["all_data_paths"], prep["output_position_paths"],
            prep["input_channel_idx_list"], prep["output_channel_idx_list"],
            prep["all_slicing_params"]):
        in_pos = open_ome_zarr(in_path, mode="r")
        out_pos = open_ome_zarr(out_path, mode="r+")
        out_pos.update_zattrs({"biahub-concatenate": settings})
        progress = ProgressStore(out_pos.path, token) if resume else None
        units = [(t_out, t_in, c_in, c_out)
                 for t_out, t_in in enumerate(prep["input_time_indices"])
                 for c_in, c_out in zip(in_channels, out_channels)
                 if progress is None or not progress.is_done(t_out, c_out)]
        _copy_position(in_pos, out_pos, units, zyx_slicing, progress)
        print(f"Concatenated {in_path} -> {out_path}")


def concatenate_verb(config_filepath: Path, output_dirpath: Path,
                     sbatch_filepath: str | None = None, cluster: str = "slurm",
                     monitor: bool = False, init_only: bool = False, resume: bool = False,
                     concat_data_paths: tuple[str, ...] = (), num_processes: int = 1) -> None:
    """The concatenate verb (the reference's ``concatenate_cli``): resolve
    mode when ``concat_data_paths`` is given (``output_dirpath`` is then the
    YAML file to write), else the concatenation."""
    if concat_data_paths:
        resolve_concatenate_config(config_filepath, output_dirpath, concat_data_paths)
        return
    settings = yaml_to_model(config_filepath, concatenate_settings_from_reference)
    concatenate(settings, output_dirpath, sbatch_filepath=sbatch_filepath, cluster=cluster,
                block=cluster in ("debug", "local"), monitor=monitor, init_only=init_only,
                resume=resume)
