"""The track verb: 2D/3D object tracking over time-lapse plates.

Counterpart of ``biahub_tpu/track.py``: z-plane selection (all, central,
range, or the in-focus window, found with the port's
:mod:`~biahub_tpu_torch.kernels.focus` on the device), the settings'
preprocessing chains (allow-listed functions,
:mod:`biahub_tpu_torch.cli.resolve_function`, with the native stand-ins
for ``ultrack.imgproc``), blank frames filled from a CSV, then segmentation
and linking by the tracking engine (:mod:`biahub_tpu_torch.tracking.
engine`). The preprocessing and the engine run on the host in NumPy and
SciPy, as the reference runs them, so the labels are bit-equal to the
reference's; the CSVs are read and written without pandas
(``tracks_{fov}.csv`` is the text of the reference frame's
``to_csv(index=False)``). The ``cellpose`` segmentation method raises, as
the reference does without the cellpose package.
"""

from __future__ import annotations

import ast
import csv
import os
from pathlib import Path

import numpy as np

from biahub_tpu_torch.cli.parsing import CommandError
from biahub_tpu_torch.cli.resolve_function import resolve_function
from biahub_tpu_torch.cli.utils import PROVENANCE_METADATA_KEYS, yaml_to_model
from biahub_tpu_torch.convert import tracking_settings_from_reference, zslicing_from_reference
from biahub_tpu_torch.device import resolve_device
from biahub_tpu_torch.io.ngff import create_empty_plate, get_ome_zarr_version, open_ome_zarr
from biahub_tpu_torch.kernels.focus import focus_from_transverse_band_tzyx
from biahub_tpu_torch.runtime.executor import resolve_cluster
from biahub_tpu_torch.runtime.resources import echo_resources, estimate_resources
from biahub_tpu_torch.tracking.engine import track_from_foreground_contour, tracks_csv

__all__ = ["track", "track_one_position", "resolve_z_slice", "fill_empty_frames",
           "CUSTOM_FUNCTIONS"]

NA_DET = 1.35
LAMBDA_ILL = 0.500


def mem_nuc_contour(nuclei_prediction, membrane_prediction):
    """Contour map at the nuclei/membrane interface."""
    return (np.asarray(membrane_prediction) + (1 - np.asarray(nuclei_prediction))) / 2


def normalize(image, lower_q: float = 0.01, upper_q: float = 0.999):
    """Quantile-normalize to [0, 1] (stand-in for ultrack.imgproc.normalize)."""
    image = np.asarray(image, dtype=np.float32)
    lo, hi = np.quantile(image, [lower_q, upper_q])
    return np.clip((image - lo) / max(hi - lo, 1e-8), 0, 1)


def detect_foreground(image, sigma: float = 15.0, threshold: float = 0.5):
    """Foreground mask: background subtraction and an Otsu-scaled threshold
    (stand-in for ultrack.imgproc.detect_foreground)."""
    from scipy.ndimage import gaussian_filter

    from biahub_tpu_torch.segment import otsu_threshold

    image = np.asarray(image, dtype=np.float32)
    corrected = image - gaussian_filter(image, sigma)
    return (corrected > threshold * otsu_threshold(corrected)).astype(np.float32)


def robust_invert(image, sigma: float = 1.0):
    """Smoothed, inverted, quantile-normalized intensity: a contour map
    (stand-in for ultrack.imgproc.robust_invert)."""
    from scipy.ndimage import gaussian_filter

    smooth = gaussian_filter(np.asarray(image, dtype=np.float32), sigma)
    return normalize(smooth.max() - smooth)


# The names settings files use for them (the reference's keys).
CUSTOM_FUNCTIONS = {
    "biahub.track.mem_nuc_contour": mem_nuc_contour,
    "biahub_tpu.track.mem_nuc_contour": mem_nuc_contour,
    "ultrack.imgproc.normalize": normalize,
    "ultrack.imgproc.detect_foreground": detect_foreground,
    "ultrack.imgproc.robust_invert": robust_invert,
    "biahub_tpu.track.normalize": normalize,
    "biahub_tpu.track.detect_foreground": detect_foreground,
    "biahub_tpu.track.robust_invert": robust_invert,
}


def fill_empty_frames(arr, empty_frames_idx: list[int] | None):
    """Replace listed empty frames with the nearest valid frame (in place):
    the previous one, or the next for frame 0 or when none precedes."""
    if not empty_frames_idx or not isinstance(empty_frames_idx, list):
        return arr
    num_frames = arr.shape[0]
    for idx in empty_frames_idx:
        prev_valid = next(
            (i for i in range(idx - 1, -1, -1) if i not in empty_frames_idx), None)
        next_valid = next(
            (i for i in range(idx + 1, num_frames) if i not in empty_frames_idx), None)
        source = prev_valid if prev_valid is not None else next_valid
        if idx == 0 and next_valid is not None:
            source = next_valid
        if source is not None:
            arr[idx] = arr[source]
    return arr


def read_blank_frames_csv(path) -> list[dict[str, str]]:
    """The blank-frames CSV's rows (columns ``FOV`` and ``t``) as text."""
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def get_empty_frames_idx_from_csv(rows: list[dict[str, str]], fov: str) -> list[int] | None:
    """Empty timepoints of one FOV: its first row's ``t`` when that is a
    list (``"[1, 4]"``); anything else is no empty frame. As the
    reference's pandas read: a cell is text, so only a list parses."""
    for row in rows:
        if row.get("FOV") == fov:
            t_value = row.get("t")
            if isinstance(t_value, str) and t_value.startswith("["):
                t_value = ast.literal_eval(t_value)
            if isinstance(t_value, list):
                return [int(i) for i in t_value]
            return None
    return None


def central_z_slice(z_shape: int) -> slice:
    """Centered odd-sized Z window of at least 3 planes."""
    n_slices = max(3, z_shape // 2)
    if n_slices % 2 == 0:
        n_slices += 1
    half = n_slices // 2
    return slice(z_shape // 2 - half, z_shape // 2 + half + 1)


def _median_focus_plane(stack, pixel_size: float, device="cuda") -> int:
    """Median in-focus z-plane over the timepoints of a (T, Z, Y, X) stack;
    an all-zero frame counts as the middle plane."""
    stack = np.asarray(stack)
    z_shape = stack.shape[1]
    planes = focus_from_transverse_band_tzyx(stack, NA_det=NA_DET, lambda_ill=LAMBDA_ILL,
                                             pixel_size=pixel_size, device=device)
    z_focus = [z_shape // 2 if stack[t].sum() == 0 else int(np.clip(planes[t], 0, z_shape - 1))
               for t in range(stack.shape[0])]
    return int(np.median(z_focus))


def _focus_window(center: int, window_size: int, z_shape: int, frac_below: float):
    """Fixed-size window around the focus, shifted (not clipped) into range."""
    size = min(window_size, z_shape)
    start = center - int(round(frac_below * window_size))
    stop = start + size
    if start < 0:
        start, stop = 0, size
    elif stop > z_shape:
        start, stop = z_shape - size, z_shape
    return slice(start, stop), size


def resolve_z_slice(z: dict, z_shape: int) -> tuple[slice, int]:
    """Read-time z-slice and plane count of a ``ZSlicing`` dict."""
    method = z["method"]
    if method == "all":
        return slice(None), z_shape
    if method == "central":
        z_slices = central_z_slice(z_shape)
        return z_slices, z_slices.stop - z_slices.start
    if method == "range":
        if z["range"] is None:
            return slice(None), z_shape
        start, stop = z["range"]
        if stop <= start:
            raise ValueError(
                f"Invalid z_slicing.range {tuple(z['range'])}: must contain at least one "
                "slice (stop > start)."
            )
        return slice(start, stop), stop - start
    if method == "focus":
        return slice(None), min(z["window_size"], z_shape)
    raise ValueError(f"Unknown z_slicing.method: {method!r}")


def apply_focus_slicing(data_dict, z_slicing: dict, pixel_size: float, device="cuda"):
    """Slice every channel to the FOV's focus window (method ``focus``)."""
    focus_channel = z_slicing["focus_channel"] or next(iter(data_dict))
    if focus_channel not in data_dict:
        raise ValueError(
            f"focus_channel '{focus_channel}' not in loaded channels {list(data_dict)}.")
    stack = data_dict[focus_channel]
    center = _median_focus_plane(stack, pixel_size, device)
    z_slices, _ = _focus_window(center, z_slicing["window_size"], stack.shape[1],
                                z_slicing["frac_below"])
    print(f"Focus-resolved z-slice: {z_slices}")
    return {name: arr[:, z_slices] for name, arr in data_dict.items()}


def run_preprocessing_pipeline(data_dict, input_images: list[dict]):
    """Each channel's function chain (per timepoint where asked)."""
    for image in input_images:
        for channel_name, pipeline in image["channels"].items():
            for step in pipeline:
                print(f"Processing {channel_name} with {step['function']}")
                run_function = resolve_function(step["function"],
                                                custom_functions=CUSTOM_FUNCTIONS)
                f_data = [np.asarray(data_dict[name])
                          for name in step["input_channels"] or [channel_name]]
                if step["per_timepoint"]:
                    result = np.stack([run_function(*[d[t] for d in f_data], **step["kwargs"])
                                       for t in range(f_data[0].shape[0])])
                else:
                    result = run_function(*f_data, **step["kwargs"])
                data_dict[channel_name] = np.asarray(result)
    return data_dict


def load_data(position_key, input_images: list[dict], z_slices: slice):
    """The configured channels of one position as (T, Z, Y, X) arrays."""
    data_dict = {}
    for image in input_images:
        if image["path"] is not None:
            dataset = open_ome_zarr(Path(image["path"]) / Path(*position_key), mode="r")
            names = dataset.channel_names
            for channel_name in image["channels"]:
                print(f"Loading data for channel {channel_name} from {image['path']}")
                data_dict[channel_name] = dataset.data[:, names.index(channel_name), z_slices]
    return data_dict


def fill_empty_frames_from_csv(fov, data_dict, blank_frame_csv_path):
    if blank_frame_csv_path:
        empty_frames_idx = get_empty_frames_idx_from_csv(
            read_blank_frames_csv(blank_frame_csv_path), fov)
        for channel_name, channel_data in data_dict.items():
            data_dict[channel_name] = fill_empty_frames(np.asarray(channel_data),
                                                        empty_frames_idx)
    return data_dict


def detect_foreground_segmentation(data_dict):
    """The foreground mask and contour map among the preprocessed channels."""
    if "foreground" in data_dict and "contour" in data_dict:
        return data_dict["foreground"], data_dict["contour"]
    if "foreground_contour" in data_dict:
        return data_dict["foreground_contour"]
    raise ValueError("Foreground and contour channels are required for tracking.")


def track_one_position(position_key, input_images, output_dirpath, tracking_config: dict,
                       blank_frames_path=None, z_slices=None, scale=(1, 1, 1, 1, 1),
                       cellpose_config: dict | None = None, z_slicing: dict | None = None,
                       output_mode: str = "2D", device="cuda"):
    """Segmentation and tracking of one FOV; writes its labels and
    ``tracks_{fov}.csv``. Returns (labels, tracks table)."""
    if z_slicing is None:
        z_slicing = zslicing_from_reference()
    fov = "_".join(position_key)
    print(f"Processing FOV: {fov.replace('_', '/')}")
    data_dict = load_data(position_key, input_images, z_slices)
    if z_slicing["method"] == "focus":
        data_dict = apply_focus_slicing(data_dict, z_slicing, scale[-1], device)
    data_dict = run_preprocessing_pipeline(data_dict, input_images)
    data_dict = fill_empty_frames_from_csv("/".join(position_key), data_dict,
                                           blank_frames_path)

    linking_config = tracking_config.get("linking_config", {})
    max_distance = float(linking_config.get("max_distance", 50.0))
    max_gap = int(linking_config.get("max_gap", 0))
    segmentation_config = tracking_config.get("segmentation_config", {})
    min_size = int(segmentation_config.get("min_area", 4))
    hierarchy = bool(segmentation_config.get("hierarchy_selection", False))

    if cellpose_config is not None:
        # The reference's message without the cellpose package, which the
        # card's machine does not have.
        raise CommandError(
            "cellpose is not installed; use segmentation_method "
            "'foreground_contour' (native) or install cellpose."
        )
    foreground, contour = detect_foreground_segmentation(data_dict)
    foreground, contour = np.asarray(foreground), np.asarray(contour)
    if output_mode == "2D" and foreground.ndim == 4:
        foreground, contour = foreground.mean(axis=1), contour.mean(axis=1)
    tracking_labels, table = track_from_foreground_contour(
        foreground, contour, scale=scale, max_distance=max_distance, min_size=min_size,
        max_gap=max_gap, hierarchy=hierarchy)

    position_dir = Path(output_dirpath) / Path(*position_key)
    csv_path = position_dir / f"tracks_{fov}.csv"
    os.makedirs(csv_path.parent, exist_ok=True)
    csv_path.write_text(tracks_csv(table))
    print(f"Saved tracks to: {position_dir}")

    labels = np.asarray(tracking_labels, dtype=np.uint32)
    output = open_ome_zarr(position_dir, mode="r+")["0"]
    if output_mode == "2D":
        if labels.ndim != 3:
            raise ValueError(
                f"output_mode='2D' expects (T, Y, X) labels but tracking produced "
                f"shape {labels.shape}. Ensure input_images projects Z (e.g. np.mean).")
        output[:, 0, 0] = labels
    else:
        if labels.ndim != 4:
            raise ValueError(
                f"output_mode='3D' expects (T, Z, Y, X) labels but tracking produced "
                f"shape {labels.shape}.")
        output[:, 0] = labels
    return tracking_labels, table


def _init_output_plate(input_position_dirpaths, output_dirpath, settings: dict):
    dataset = open_ome_zarr(str(input_position_dirpaths[0]), mode="r")
    T, C, Z, Y, X = dataset.data.shape
    _, z_win = resolve_z_slice(settings["z_slicing"], Z)
    output_shape = (T, 1, 1, Y, X) if settings["output_mode"] == "2D" else (T, 1, z_win, Y, X)
    position_keys = [Path(p).parts[-3:] for p in input_position_dirpaths]
    input_plate = Path(input_position_dirpaths[0]).parents[2]
    create_empty_plate(
        store_path=output_dirpath,
        position_keys=position_keys,
        channel_names=[f"{settings['target_channel']}_labels"],
        shape=output_shape,
        scale=dataset.scale,
        version=settings["output_ome_zarr_version"] or get_ome_zarr_version(input_plate),
        dtype=np.uint32,
        metadata_sources=input_plate,
        metadata_keys=PROVENANCE_METADATA_KEYS,
    )
    for _, position in open_ome_zarr(output_dirpath, mode="r+").positions():
        position.update_zattrs({"biahub-track": settings})
    print(f"Created {output_dirpath} ({len(position_keys)} positions)")
    return (T, C, output_shape[2], Y, X)


def track(input_position_dirpaths, config_filepath, output_dirpath, sbatch_filepath=None,
          cluster: str = "slurm", monitor: bool = True, init_only: bool = False,
          input_images_path: str | None = None, device="cuda") -> None:
    """The verb on plates: the first ``input_images`` entry without a path
    reads ``input_images_path`` (else the input plate); one label channel
    ``<target_channel>_labels`` (Z 1 in 2D mode), each position stamped
    with the settings (``biahub-track``); ``--init`` creates the plate and
    prints the ``RESOURCES:`` line."""
    device = resolve_device(device)
    output_dirpath = Path(output_dirpath)
    settings = yaml_to_model(config_filepath, tracking_settings_from_reference)
    input_plate = Path(input_position_dirpaths[0]).parents[2]
    primary_path = Path(input_images_path) if input_images_path is not None else input_plate
    for image in settings["input_images"]:
        if image["path"] is None:
            image["path"] = str(primary_path)
            break

    T, C, Z_out, Y, X = _init_output_plate(input_position_dirpaths, output_dirpath, settings)
    _, num_cpus, gb_ram_per_cpu = estimate_resources(
        shape=(T, C, Z_out, Y, X), ram_multiplier=16, max_num_cpus=16)
    echo_resources(num_cpus, num_cpus * gb_ram_per_cpu, 60)
    if init_only:
        print(f"Initialized {output_dirpath} ({len(input_position_dirpaths)} positions)")
        return

    dataset = open_ome_zarr(str(input_position_dirpaths[0]), mode="r")
    scale = dataset.scale
    z_slices, _ = resolve_z_slice(settings["z_slicing"], dataset.data.shape[2])
    track_scale = scale[-2:] if settings["output_mode"] == "2D" else scale[-3:]
    cellpose_cfg = (settings["cellpose_config"]
                    if settings["segmentation_method"] == "cellpose" else None)
    resolve_cluster(cluster=cluster)
    for position_key in [Path(p).parts[-3:] for p in input_position_dirpaths]:
        track_one_position(
            position_key=position_key,
            output_dirpath=output_dirpath,
            tracking_config=settings["tracking_config"],
            input_images=settings["input_images"],
            blank_frames_path=settings["blank_frames_path"],
            z_slices=z_slices,
            scale=track_scale,
            cellpose_config=cellpose_cfg,
            z_slicing=settings["z_slicing"],
            output_mode=settings["output_mode"],
            device=device,
        )
        print(f"Tracking complete: {'/'.join(position_key)}")
