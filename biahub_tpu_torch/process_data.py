"""process-with-config: numpy functions named in a settings file, applied
to each timepoint of a position.

Counterpart of ``biahub_tpu/process_data.py``: :func:`binning_czyx` (:36),
:func:`process_czyx` (:86) and :func:`process_with_config` (:103). The
functions are arbitrary host callables named in the settings
(:mod:`~biahub_tpu_torch.cli.resolve_function`: ``np.<name>``, the
binning, ``ultrack.imgproc`` where it imports), so the verb runs on the
host, as the reference does: the port's
:class:`~biahub_tpu_torch.runtime.executor.BatchRunner` on the CPU reads
each (T, C)-unit CZYX volume in its stored dtype, runs the chain, and
writes the float32 result. A binning sets the output's shape and scale;
other functions are taken to keep the shape.
"""

from __future__ import annotations

import copy
from collections.abc import Sequence
from pathlib import Path
from typing import Literal

import numpy as np
import torch

from biahub_tpu_torch.cli.resolve_function import resolve_function
from biahub_tpu_torch.cli.utils import get_output_paths, yaml_to_model
from biahub_tpu_torch.convert import processing_settings_from_reference
from biahub_tpu_torch.io.ngff import create_empty_plate, get_ome_zarr_version, open_ome_zarr
from biahub_tpu_torch.runtime import estimate_resources, resolve_cluster
from biahub_tpu_torch.runtime.executor import BatchRunner, WorkUnit

__all__ = ["binning_czyx", "process_czyx", "process_with_config"]


def binning_czyx(czyx_data: np.ndarray, binning_factor_zyx: Sequence[int] = (1, 2, 2),
                 mode: Literal["sum", "mean"] = "sum") -> np.ndarray:
    """Bin ZYX by summing or averaging windows. Sum mode rescales each
    channel to span the dtype's range (uint16's for floats); mean mode
    averages, and rescales integer outputs to the dtype's range."""
    C = czyx_data.shape[0]
    bz, by, bx = binning_factor_zyx
    new_z = czyx_data.shape[1] // bz
    new_y = czyx_data.shape[2] // by
    new_x = czyx_data.shape[3] // bx

    output = np.zeros((C, new_z, new_y, new_x), dtype=np.float32)
    for c in range(C):
        reshaped = (czyx_data[c, : new_z * bz, : new_y * by, : new_x * bx]
                    .astype(np.float32).reshape(new_z, bz, new_y, by, new_x, bx))
        if mode == "sum":
            output[c] = reshaped.sum(axis=(1, 3, 5))
            if output[c].max() > 0:
                if np.issubdtype(czyx_data.dtype, np.integer):
                    max_val = np.iinfo(czyx_data.dtype).max
                else:
                    max_val = np.iinfo(np.uint16).max
                rng = output[c].max() - output[c].min()
                if rng > 0:
                    output[c] = (output[c] - output[c].min()) * max_val / rng
        elif mode == "mean":
            output[c] = reshaped.mean(axis=(1, 3, 5))
        else:
            raise ValueError(f"Invalid mode: {mode}. Must be 'sum' or 'mean'.")

    if mode == "mean" and np.issubdtype(czyx_data.dtype, np.integer):
        if output.max() > 0:
            output = output * np.iinfo(czyx_data.dtype).max / output.max()
    return output.astype(czyx_data.dtype)


CUSTOM_FUNCTIONS = {
    "biahub.process_data.binning_czyx": binning_czyx,
    "biahub_tpu.process_data.binning_czyx": binning_czyx,
}
_BINNING = tuple(CUSTOM_FUNCTIONS)


def process_czyx(czyx_data: np.ndarray, processing_functions: list[dict]) -> np.ndarray:
    """Apply the settings' chain (``ProcessingFunctions`` dicts, their
    ``input_channels`` resolved to indices) to one CZYX volume."""
    for proc in processing_functions:
        func = resolve_function(proc["function"], custom_functions=CUSTOM_FUNCTIONS)
        kwargs = proc["kwargs"]
        if len(proc["input_channels"]) == 1:
            c_idx = proc["input_channels"][0]
        else:
            raise ValueError("Only one input channel is supported for now")
        print(f"Processing with {func.__name__} with kwargs {kwargs} to channel {c_idx}")
        czyx_data = func(czyx_data, **kwargs)
    return czyx_data


def process_with_config(input_position_dirpaths: Sequence[Path], config_filepath: Path,
                        output_dirpath: Path, sbatch_filepath: Path | None = None,
                        local: bool = False, monitor: bool = True) -> None:
    """The process-with-config verb (module docstring)."""
    output_dirpath = Path(output_dirpath)
    output_position_paths = get_output_paths(input_position_dirpaths, output_dirpath)
    dataset = open_ome_zarr(input_position_dirpaths[0])
    T, C, Z, Y, X = dataset.data.shape
    channel_names = dataset.channel_names
    scale_dataset = dataset.scale

    settings = copy.deepcopy(yaml_to_model(config_filepath, processing_settings_from_reference))
    functions = settings["processing_functions"]
    if not functions:
        raise ValueError("Processing functions must be specified")
    for proc in functions:
        if proc["input_channels"] is not None and len(proc["input_channels"]) == 1:
            proc["input_channels"][0] = channel_names.index(proc["input_channels"][0])
        else:
            raise ValueError("Channel must be specified for preprocessing functions")
        if not callable(resolve_function(proc["function"], custom_functions=CUSTOM_FUNCTIONS)):
            raise ValueError(f"Function {proc['function']} is not callable")

    output_shape = (T, C, Z, Y, X)
    new_scale = scale_dataset
    for proc in functions:
        if proc["function"] in _BINNING:
            factor = proc["kwargs"].get("binning_factor_zyx", (1, 4, 4))
            print(f"Binning factor: {factor}")
            output_shape = (T, C, Z // factor[0], Y // factor[1], X // factor[2])
            new_scale = [scale_dataset[0], scale_dataset[1], scale_dataset[2] * factor[0],
                         scale_dataset[3] * factor[1], scale_dataset[4] * factor[2]]
            break

    version = settings["output_ome_zarr_version"] or get_ome_zarr_version(
        Path(input_position_dirpaths[0]).parents[2])
    create_empty_plate(store_path=output_dirpath,
                       position_keys=[Path(p).parts[-3:] for p in input_position_dirpaths],
                       channel_names=channel_names, shape=output_shape, scale=new_scale,
                       dtype=np.float32, version=version)
    estimate_resources(shape=output_shape, dtype=np.float32, ram_multiplier=4, max_num_cpus=16)
    resolve_cluster(None, local)

    def kernel(volumes: torch.Tensor) -> torch.Tensor:
        return torch.stack([torch.from_numpy(np.ascontiguousarray(
            process_czyx(v.numpy(), functions), dtype=np.float32)) for v in volumes])

    kernel.native_ingest_dtypes = (dataset.data.dtype,)
    runner = BatchRunner(cluster="debug", device="cpu")
    channels = tuple(range(C))
    for input_position_path, output_position_path in zip(input_position_dirpaths,
                                                         output_position_paths):
        in_pos = open_ome_zarr(input_position_path, mode="r")
        out_pos = open_ome_zarr(output_position_path, mode="r+")
        out_pos.update_zattrs({"biahub-process_with_config": settings})
        runner.run_units(kernel, [WorkUnit(0, t, channels, channels) for t in range(T)],
                         [in_pos], [out_pos], out_dtype=np.float32)
        print(f"Processed {input_position_path}")
