"""The segment verb: one label channel per configured model, over a plate.

Counterpart of ``biahub_tpu/segment.py``. ``path_to_model`` is
``threshold_otsu`` (Otsu foreground and distance-peak instance splitting,
on the host in NumPy and SciPy as the reference, so its labels are
bit-equal), or the path of a cellpose-schema CPnet checkpoint, which runs on
the device (:func:`~biahub_tpu_torch.segmentation.engine.
cpnet_segment_czyx`) with cellpose's ``eval_args`` mapped as the reference
maps them. Any other name (cellpose's built-in, download-backed models)
raises the reference's message: the card's machine has no cellpose.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from biahub_tpu_torch.cli.parsing import CommandError
from biahub_tpu_torch.cli.resolve_function import resolve_function
from biahub_tpu_torch.cli.utils import get_output_paths, yaml_to_model
from biahub_tpu_torch.convert import segmentation_settings_from_reference
from biahub_tpu_torch.device import resolve_device
from biahub_tpu_torch.io.ngff import create_empty_plate, get_ome_zarr_version, open_ome_zarr
from biahub_tpu_torch.runtime.executor import resolve_cluster
from biahub_tpu_torch.runtime.resources import estimate_resources

__all__ = ["segment_data", "segment", "otsu_threshold", "threshold_instance_labels"]


def otsu_threshold(data: np.ndarray) -> float:
    """Otsu's threshold over a 256-bin histogram."""
    data = np.asarray(data).ravel()
    hist, bin_edges = np.histogram(data, bins=256)
    centers = (bin_edges[:-1] + bin_edges[1:]) / 2
    weight1 = np.cumsum(hist)
    weight2 = np.cumsum(hist[::-1])[::-1]
    with np.errstate(invalid="ignore", divide="ignore"):
        mean1 = np.cumsum(hist * centers) / weight1
        mean2 = (np.cumsum((hist * centers)[::-1]) / weight2[::-1])[::-1]
    variance = weight1[:-1] * weight2[1:] * (mean1[:-1] - mean2[1:]) ** 2
    if not np.isfinite(variance).any():
        return float(np.mean(data))
    return float(centers[:-1][np.nanargmax(variance)])


def threshold_instance_labels(zyx: np.ndarray, min_size: int = 20,
                              split: bool = True) -> np.ndarray:
    """Instance labels: Otsu foreground split by a Voronoi partition seeded
    at the distance map's local maxima; labels under ``min_size`` dropped."""
    from scipy import ndimage

    zyx = np.asarray(zyx, dtype=np.float32)
    foreground = zyx > otsu_threshold(zyx)
    if not foreground.any():
        return np.zeros(zyx.shape, np.uint32)
    if split:
        distance = ndimage.distance_transform_edt(foreground)
        footprint = np.ones((3,) * zyx.ndim)
        local_max = (distance == ndimage.maximum_filter(distance, footprint=footprint)) & (
            distance > 1)
        markers, n = ndimage.label(local_max)
        if n > 0:
            _, nearest = ndimage.distance_transform_edt(markers == 0, return_indices=True)
            labels = markers[tuple(nearest)]
            labels[~foreground] = 0
        else:
            labels, _ = ndimage.label(foreground)
    else:
        labels, _ = ndimage.label(foreground)
    counts = np.bincount(labels.ravel())
    small = np.where(counts < min_size)[0]
    if len(small):
        labels[np.isin(labels, small)] = 0
    return labels.astype(np.uint32)


#: cellpose eval args the CPnet engine understands; the ignored ones are
#: plumbing; anything else raises (:func:`_cpnet_eval`).
_CPNET_EVAL_KEYS = ("channels", "diameter", "diam_mean", "cellprob_threshold", "flow_threshold",
                    "min_size", "niter", "normalize", "stitch_threshold")
_CPNET_IGNORED_KEYS = ("batch_size", "channel_axis", "z_axis", "gpu", "progress")


def _cpnet_eval(czyx: np.ndarray, checkpoint: str, eval_args: dict,
                device="cuda") -> np.ndarray:
    """cellpose-style ``eval_args`` mapped onto the CPnet engine."""
    from biahub_tpu_torch.segmentation.engine import cpnet_segment_czyx

    kwargs = {}
    for key, value in dict(eval_args).items():
        if key in _CPNET_EVAL_KEYS:
            kwargs[key] = tuple(value) if key == "channels" else value
        elif key in _CPNET_IGNORED_KEYS:
            continue
        elif key == "do_3D" and value:
            raise CommandError(
                "do_3D=True (orthogonal-view 3D flows) is not supported by the "
                "native CPnet engine; use stitch_threshold for 3D objects, or "
                "install cellpose."
            )
        elif key != "do_3D":
            raise CommandError(
                f"eval arg '{key}' is not understood by the native CPnet "
                f"engine (supported: {', '.join(_CPNET_EVAL_KEYS)})."
            )
    return cpnet_segment_czyx(czyx, checkpoint, device=device, **kwargs)


def segment_data(czyx_data: np.ndarray, segmentation_models: dict,
                 device="cuda") -> np.ndarray:
    """Segment one CZYX volume with each configured model (the settings'
    ``models``, as :func:`~biahub_tpu_torch.convert.
    segmentation_settings_from_reference` gives them) -> (n_models, Z', Y,
    X). As in the reference, each model's preprocessing writes into the
    volume the later models see."""
    czyx_data = np.asarray(czyx_data, dtype=np.float32)
    out = []
    for model_name, model_args in segmentation_models.items():
        print(f"Segmenting with model {model_name}")
        z_slice_2d = model_args["z_slice_2D"]
        czyx_to_segment = (czyx_data[:, z_slice_2d:z_slice_2d + 1]
                           if z_slice_2d is not None else czyx_data)
        for preproc in model_args["preprocessing"]:
            func = resolve_function(preproc["function"])
            kwargs = dict(preproc["kwargs"])
            if "out_range" in kwargs and isinstance(kwargs["out_range"], list):
                kwargs["out_range"] = tuple(kwargs["out_range"])
            c_idx = preproc["channel"]
            print(f"Processing with {func.__name__} with kwargs {kwargs} to channel {c_idx}")
            czyx_data[int(c_idx)] = func(czyx_data[int(c_idx)], **kwargs)

        path_to_model = model_args["path_to_model"]
        if path_to_model == "threshold_otsu":
            min_size = int(model_args["eval_args"].get("min_size", 20))
            segmentation = np.stack([threshold_instance_labels(z, min_size=min_size)
                                     for z in czyx_to_segment]).max(axis=0)
        elif Path(path_to_model).is_file():
            segmentation = _cpnet_eval(czyx_to_segment, path_to_model, model_args["eval_args"],
                                       device)
        else:
            raise CommandError(
                f"Model '{path_to_model}' requires the cellpose "
                "package, which is not installed (built-in model names like "
                "'cyto' are download-backed). Native alternatives: "
                "'threshold_otsu' (no checkpoint needed), or a path to a "
                "cellpose-schema CPnet .pt checkpoint, which runs on the "
                "TPU-native flax engine."
            )
        segmentation = np.asarray(segmentation)
        if z_slice_2d is not None and segmentation.ndim == 2:
            segmentation = segmentation[np.newaxis, ...]
        out.append(segmentation)
    return np.stack(out, axis=0)


def segment(input_position_dirpaths, config_filepath, output_dirpath, sbatch_filepath=None,
            local: bool = False, monitor: bool = True, device="cuda") -> None:
    """The verb on plates: one uint32 channel ``<model>_labels`` per model,
    Z collapsed to 1 when every model is 2D, each position stamped with the
    settings (``biahub-segment``), timepoint by timepoint."""
    device = resolve_device(device)
    output_dirpath = Path(output_dirpath)
    output_position_paths = get_output_paths(input_position_dirpaths, output_dirpath)
    settings = yaml_to_model(config_filepath, segmentation_settings_from_reference)
    input_dataset = open_ome_zarr(input_position_dirpaths[0], mode="r")
    T, C, Z, Y, X = input_dataset.data.shape
    models = settings["models"]
    z_out = 1 if all(m["z_slice_2D"] is not None for m in models.values()) else Z
    version = settings["output_ome_zarr_version"] or get_ome_zarr_version(
        Path(input_position_dirpaths[0]).parents[2])
    create_empty_plate(
        store_path=output_dirpath,
        position_keys=[Path(p).parts[-3:] for p in input_position_dirpaths],
        channel_names=[f"{name}_labels" for name in models],
        shape=(T, len(models), z_out, Y, X),
        scale=input_dataset.scale,
        dtype=np.uint32,
        version=version,
    )
    estimate_resources(shape=(T, C, Z, Y, X), ram_multiplier=8, max_num_cpus=16)
    resolve_cluster(None, local)
    for in_path, out_path in zip(input_position_dirpaths, output_position_paths):
        in_pos = open_ome_zarr(in_path, mode="r")
        out_pos = open_ome_zarr(out_path, mode="r+")
        out_pos.update_zattrs({"biahub-segment": settings})
        out_arr = out_pos["0"]
        for t in range(T):
            out_arr[t] = segment_data(in_pos.data[t], models, device).astype(np.uint32)
        print(f"Segmentation complete: {in_path}")
