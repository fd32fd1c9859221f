"""estimate-stabilization on arrays in memory: per-position drift transforms.

Counterpart of ``biahub_tpu/estimate_stabilization.py`` for its four
methods:

- focus-finding, z: the in-focus z-index per timepoint from transverse
  mid-band power (:mod:`biahub_tpu_torch.kernels.focus`);
- focus-finding, xy: subpixel 2D phase cross-correlation of the focus
  slices;
- phase-cross-corr, xyz: volumetric PCC of every timepoint against the
  first or the previous one, through kernels A, Bx and C
  (:mod:`biahub_tpu_torch.kernels.pcc`);
- beads, xyz: bead detection, matching and fitting on the first position
  (:mod:`biahub_tpu_torch.registration.beads`; kernels G and H).

Each per-position function takes a *position-like* object: anything with
``.data`` (an indexable (T, C, Z, Y, X) array: numpy or a tensor),
``.scale`` and ``.channel_names``, the only attributes the reference's
per-position functions read. :class:`ArrayPosition` is one in memory, a
position of the port's OME-Zarr store another.

:func:`estimate_stabilization_arrays` runs the dispatch on positions in
memory; the verb, :func:`estimate_stabilization` (reference :498-668), on
plates, writes the reference's outputs: ``positions_focus.csv`` (merged
with the file an earlier run left, which is state: the xy route and the
well average read it back), ``<kind>_stabilization_settings/<fov>.yml`` (or
``xyz_stabilization_settings.yml`` and ``xyz_transforms/<t>.npy`` for
beads), and when ``verbose`` ``z_focus_shift.npy``,
``shifts_per_position/<fov>.csv`` and the plots (only where matplotlib is
installed). The PCC and beads routes read the estimation channel of a
position once and move it to the device once.
"""

from __future__ import annotations

import copy
import csv
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Any

import numpy as np
import torch

from biahub_tpu_torch.cli.utils import yaml_to_model
from biahub_tpu_torch.convert import (
    stabilization_settings_dump,
    stabilization_settings_from_reference,
)
from biahub_tpu_torch.device import as_tensor, resolve_device
from biahub_tpu_torch.io.ngff import open_ome_zarr
from biahub_tpu_torch.kernels.focus import focus_from_transverse_band_tzyx
from biahub_tpu_torch.kernels.pcc import (
    _pcc_peak_indices_pairwise,
    _pcc_peak_indices_vs_first,
    match_shape,
    pcc_shifts_pairwise,
    pcc_shifts_vs_first,
    subpixel_shift_2d,
)
from biahub_tpu_torch.registration.beads import estimate_tczyx
from biahub_tpu_torch.plots import pyplot
from biahub_tpu_torch.registration.utils import evaluate_transforms, save_transforms
from biahub_tpu_torch.runtime.executor import DEFAULT_MAX_BATCH_BYTES

__all__ = [
    "ArrayPosition",
    "DEFAULT_MAX_BATCH_BYTES",
    "estimate_z_focus_per_position",
    "get_mean_z_positions",
    "estimate_xy_stabilization_per_position",
    "estimate_xyz_stabilization_pcc_per_position",
    "get_tform_from_pcc",
    "estimate_stabilization_arrays",
    "estimate_stabilization",
]

NA_DET = 1.35
LAMBDA_ILL = 0.500


@dataclass
class ArrayPosition:
    """One position in memory: ``data`` (T, C, Z, Y, X), numpy or a tensor;
    ``scale`` (T, C, Z, Y, X) voxel sizes; ``channel_names``."""

    data: Any
    scale: list
    channel_names: list


def _center_crop_slices(Y: int, X: int, center_crop_xy) -> tuple[slice, slice]:
    if not center_crop_xy:
        return slice(0, Y), slice(0, X)
    cx, cy = center_crop_xy[0], center_crop_xy[1]
    cx, cy = min(cx, X), min(cy, Y)
    return (
        slice(Y // 2 - cy // 2, Y // 2 + cy // 2),
        slice(X // 2 - cx // 2, X // 2 + cx // 2),
    )


# ---------------------------------------------------------------------------
# Z: focus finding
# ---------------------------------------------------------------------------


def estimate_z_focus_per_position(
    position,
    fov: str,
    channel_index: int,
    center_crop_xy,
    verbose: bool = False,
    max_batch_bytes: int = DEFAULT_MAX_BATCH_BYTES,
    device: str | torch.device = "cuda",
) -> list[dict]:
    """In-focus z-index per timepoint for one position: the rows
    (``position``, ``time_idx``, ``channel``, ``focus_idx``) of the
    reference's focus table. Timepoints run as batched sweeps of at most
    ``max_batch_bytes`` (counting each crop twice, as the reference)."""
    dev = resolve_device(device)
    T, C, Z, Y, X = position.data.shape
    pixel_size = position.scale[-1]
    y_idx, x_idx = _center_crop_slices(Y, X, center_crop_xy)
    crop_bytes = 4 * Z * (y_idx.stop - y_idx.start) * (x_idx.stop - x_idx.start)
    t_chunk = max(1, max_batch_bytes // max(crop_bytes * 2, 1))
    focus_indices = np.zeros(T, dtype=int)
    for t0 in range(0, T, t_chunk):
        t1 = min(t0 + t_chunk, T)
        stack = as_tensor(position.data[t0:t1, channel_index, :, y_idx, x_idx], dev)
        focus_indices[t0:t1] = focus_from_transverse_band_tzyx(
            stack, NA_det=NA_DET, lambda_ill=LAMBDA_ILL, pixel_size=pixel_size, device=dev
        )
    rows = []
    for t in range(T):
        z_idx = int(focus_indices[t])
        if verbose:
            print(f"Estimating focus for timepoint {t}: {z_idx}")
        rows.append({
            "position": fov.replace("_", "/"),
            "time_idx": t,
            "channel": position.channel_names[channel_index],
            "focus_idx": z_idx,
        })
    return rows


def _z_transforms_from_focus(focus_idx) -> np.ndarray:
    """Per-timepoint z-translation transforms from a focus-index series: the
    first valid (non-zero) index is the reference, and each transform
    samples at z + (focus_t - focus_ref)."""
    z_val = next((v for v in focus_idx if v != 0 and not np.isnan(v)), None)
    if z_val is None:
        raise ValueError("Z index of focus reference is None, focus_idx contains only zeros")
    transforms = [np.eye(4)]
    for z_next in focus_idx[1:]:
        shift = np.eye(4)
        shift[0, 3] = z_next - z_val
        transforms.append(shift)
    return np.asarray(transforms)


def _mean_focus(rows, method: str = "mean") -> np.ndarray:
    """Focus index per timepoint over positions, failed findings (0) left
    out: the reference's ``groupby("time_idx")["focus_idx"].mean()`` (or
    ``median()``) over the rows of its focus table, by ascending
    ``time_idx``."""
    by_t: dict[int, list] = {}
    for row in sorted(rows, key=lambda r: r["time_idx"]):
        by_t.setdefault(row["time_idx"], []).append(
            np.nan if row["focus_idx"] == 0 else float(row["focus_idx"]))
    reduce = np.nanmean if method == "mean" else np.nanmedian
    return np.array([np.nan if np.isnan(v).all() else reduce(v)
                     for v in map(np.asarray, by_t.values())])


def get_mean_z_positions(fov_focus: dict[str, list], method: str = "mean") -> np.ndarray:
    """Across-position mean (or median) focus index per timepoint, failed
    findings (0) left out, from ``{fov: focus indices}``: the averaging of
    the reference's ``get_mean_z_positions`` without its CSV."""
    return _mean_focus([{"time_idx": t, "focus_idx": f} for vals in fov_focus.values()
                        for t, f in enumerate(vals)], method)


def _focus_per_position(positions: dict, channel_index: int, focus_settings: dict,
                        verbose: bool, dev) -> dict[str, list]:
    """``{fov: focus indices}`` of every position."""
    return {
        _fov_name(key): [
            row["focus_idx"] for row in estimate_z_focus_per_position(
                pos, _fov_name(key), channel_index, focus_settings["center_crop_xy"],
                verbose, device=dev)
        ]
        for key, pos in positions.items()
    }


def _z_dict(fov_focus: dict[str, list], focus_settings: dict) -> dict[str, list]:
    if focus_settings["average_across_wells"]:
        z_offsets = get_mean_z_positions(
            fov_focus, method=focus_settings["average_across_wells_method"])
        return {"average": _z_transforms_from_focus(list(z_offsets)).tolist()}
    return {fov: _z_transforms_from_focus(vals).tolist() for fov, vals in fov_focus.items()}


# ---------------------------------------------------------------------------
# XY: translation registration of focus slices
# ---------------------------------------------------------------------------


def _fill_focus(focus_idx) -> list[int]:
    """pandas' ``Series(f).replace(0, nan).ffill().fillna(Series(f).mean())
    .astype(int)`` in numpy."""
    raw = np.asarray(focus_idx, dtype=np.float64)
    z = np.where(raw == 0, np.nan, raw)
    for i in range(1, len(z)):
        if np.isnan(z[i]):
            z[i] = z[i - 1]
    z[np.isnan(z)] = np.nanmean(raw)
    return z.astype(int).tolist()


def estimate_xy_stabilization_per_position(
    position,
    focus_idx: list[int],
    channel_index: int,
    center_crop_xy,
    t_reference: str = "previous",
    verbose: bool = False,
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """Per-timepoint (T, 4, 4) xy transforms from subpixel PCC of the focus
    slices, against the first slice or chained from the previous one."""
    dev = resolve_device(device)
    T, C, Z, Y, X = position.data.shape
    y_idx, x_idx = _center_crop_slices(Y, X, center_crop_xy)
    z_idx = _fill_focus(focus_idx)
    tyx = torch.stack([
        as_tensor(position.data[t, channel_index, z, y_idx, x_idx], dev)
        for t, z in zip(range(T), z_idx)
    ]).clamp_min(0).to(torch.float32)

    shifts = np.zeros((T, 2))
    if t_reference == "first":
        for t in range(1, T):
            shifts[t] = subpixel_shift_2d(tyx[0], tyx[t], device=dev)
    else:  # previous: accumulate pairwise shifts into the first frame's coords
        for t in range(1, T):
            shifts[t] = shifts[t - 1] + subpixel_shift_2d(tyx[t - 1], tyx[t], device=dev)

    transforms = np.zeros((T, 4, 4))
    transforms[:] = np.eye(4)
    # The PCC peak d of (ref, mov) satisfies mov(x) ~ ref(x + d); the
    # aligning warp out[o] = mov[o + delta] needs delta = -d.
    transforms[:, 1, 3] = -shifts[:, 0]
    transforms[:, 2, 3] = -shifts[:, 1]
    return transforms


# ---------------------------------------------------------------------------
# XYZ: volumetric phase cross-correlation
# ---------------------------------------------------------------------------


def _pcc_crop_slices(shape_zyx, settings: dict):
    Z, Y, X = shape_zyx
    y_idx, x_idx = _center_crop_slices(Y, X, settings["center_crop_xy"])
    z_idx = slice(0, Z)
    if settings["X_slice"] != "all":
        x_idx = slice(settings["X_slice"][0], settings["X_slice"][1])
    if settings["Y_slice"] != "all":
        y_idx = slice(settings["Y_slice"][0], settings["Y_slice"][1])
    if settings["Z_slice"] != "all":
        z_idx = slice(settings["Z_slice"][0], settings["Z_slice"][1])
    return z_idx, y_idx, x_idx


def estimate_xyz_stabilization_pcc_per_position(
    position,
    fov: str,
    channel_index: int,
    phase_cross_corr_settings: dict,
    verbose: bool = False,
    max_batch_bytes: int = DEFAULT_MAX_BATCH_BYTES,
    device: str | torch.device = "cuda",
) -> list:
    """Per-timepoint 4x4 transforms (lists) from volumetric PCC (see
    :func:`_pcc_transforms_and_shifts`)."""
    return _pcc_transforms_and_shifts(position, channel_index, phase_cross_corr_settings,
                                      verbose, max_batch_bytes, device)[0]


def _pcc_transforms_and_shifts(position, channel_index: int, phase_cross_corr_settings: dict,
                               verbose: bool, max_batch_bytes: int, device) -> tuple[list, list]:
    """Per-timepoint 4x4 transforms (lists) from volumetric PCC of the crop
    against the first or the previous timepoint. The pairs run in chunks of
    ``max_batch_bytes // (8 * crop bytes)`` timepoints, as the reference's;
    with ``t_reference="first"`` each chunk transforms the reference crop
    once (kernel A) and keeps its spectrum for the chunk's pairs.
    ``function_type="custom_padding"`` pads each axis to ``next_fast_len``
    (lengths with no prime factor above 11, which the kernels take as
    Bluestein lines). Also the rows ``(t, dz, dy, dx)`` of each pair's
    shift, the reference's ``shifts_per_position`` table."""
    from scipy.fft import next_fast_len  # at call time, as in kernels/pcc.py

    dev = resolve_device(device)
    settings = phase_cross_corr_settings
    T = position.data.shape[0]
    z_idx, y_idx, x_idx = _pcc_crop_slices(position.data.shape[2:], settings)
    padding = settings["function_type"] == "custom_padding"

    def load(t0, t1):
        return as_tensor(position.data[t0:t1, channel_index, z_idx, y_idx, x_idx], dev)

    ref_stack = load(0, 1)
    crop_shape = tuple(ref_stack.shape[1:])
    fft_shape = tuple(int(next_fast_len(int(s * settings["maximum_shift"])))
                      for s in crop_shape) if padding else crop_shape
    vol_bytes = 4 * int(np.prod(fft_shape))
    t_chunk = max(1, max_batch_bytes // max(vol_bytes * 8, 1))

    def prep(stack):
        return torch.stack([match_shape(v, fft_shape) for v in stack]) if padding else stack

    ref = prep(ref_stack)[0]
    norm = settings["normalization"]
    chunks = []
    for t0 in range(1, T, t_chunk):
        t1 = min(t0 + t_chunk, T)
        movs = prep(load(t0, t1))
        if settings["t_reference"] == "first":
            if padding:
                chunks.append(_pcc_peak_indices_vs_first(ref, movs, norm, dev))
            else:
                chunks.append(pcc_shifts_vs_first(ref, movs, norm, dev))
        else:  # previous: pair each frame with its predecessor
            prevs = prep(load(t0 - 1, t1 - 1))
            if padding:
                chunks.append(_pcc_peak_indices_pairwise(prevs, movs, norm, dev))
            else:
                chunks.append(pcc_shifts_pairwise(prevs, movs, norm, dev))
    all_shifts = np.zeros((T, 3))
    if chunks:
        found = torch.cat(chunks).cpu().numpy()
        if padding:
            found = np.stack([[s // 2 - ((q + s // 2) % s) for s, q in zip(fft_shape, row)]
                              for row in found.astype(np.int64)])
        all_shifts[1:] = found.astype(np.float64)

    transforms = [np.eye(4).tolist()]
    shifts = [(0, 0.0, 0.0, 0.0)]
    cumulative = np.zeros(3)
    for t in range(1, T):
        shift = all_shifts[t]
        if settings["t_reference"] == "previous":
            cumulative = cumulative + shift
            total = cumulative.copy()
        else:
            total = shift
        transforms.append(get_tform_from_pcc(total))
        shifts.append((t, *(float(v) for v in shift)))
        if verbose:
            print(f"Time {t}: shift (dz,dy,dx) = {tuple(np.round(shift, 2))}")
    return transforms, shifts


def get_tform_from_pcc(shift) -> list:
    """4x4 aligning transform from a PCC shift: out[o] = mov[o - shift]."""
    transform = np.eye(4)
    transform[:3, 3] = -np.asarray(shift, dtype=np.float64)
    return transform.tolist()


# ---------------------------------------------------------------------------
# Orchestration
# ---------------------------------------------------------------------------


def _compose_xyz(xy_dict: dict, z_dict: dict) -> tuple[dict, dict]:
    """``({fov: xy_t @ z_t}, {fov: z transforms})`` for the FOVs of
    ``xy_dict``, each FOV's z transforms its own or the well average's."""
    z_of = {fov: np.asarray(z_dict[fov if fov in z_dict else "average"]).tolist()
            for fov in xy_dict}
    xyz = {}
    for fov, xy_transforms in xy_dict.items():
        xy_t, z_t = np.asarray(xy_transforms), np.asarray(z_of[fov])
        if xy_t.shape[0] != z_t.shape[0]:
            raise ValueError("The number of translation matrices and z drift matrices "
                             "must be the same")
        xyz[fov] = np.asarray([a @ b for a, b in zip(xy_t, z_t)]).tolist()
    return xyz, z_of


def _fov_name(key: str) -> str:
    """``"A/1/0"`` -> ``"A_1_0"``, the reference's per-FOV file stem."""
    return "_".join(str(key).strip("/").split("/")[-3:])


def _skip_beads(positions: dict, skip_beads_fov: str) -> dict:
    """Drop the beads FOV (the reference matches the string in the path)."""
    if skip_beads_fov == "0":
        return positions
    return {k: p for k, p in positions.items() if skip_beads_fov not in str(k)}


def estimate_stabilization_arrays(
    positions: dict,
    settings: dict,
    device: str | torch.device = "cuda",
) -> dict[str, dict[str, list]]:
    """estimate-stabilization on positions in memory: ``positions`` maps a
    position's path (``"A/1/0"``) to a position-like object, ``settings``
    is an ``EstimateStabilizationSettings`` dict (see
    :func:`~biahub_tpu_torch.convert.stabilization_settings_from_reference`).
    Returns ``{kind: {fov: transforms}}`` with ``kind`` the reference's
    output folder (``"xyz"``, ``"z"``, ``"xy"``), ``fov`` its file stem
    (``"A_1_0"``, or ``"average"`` for well-averaged z), and each list of
    4x4 transforms passed through ``evaluate_transforms`` when the settings
    have ``eval_transform_settings`` (the dispatch of the reference's
    ``estimate_stabilization``, :498-675)."""
    dev = resolve_device(device)
    s = stabilization_settings_from_reference(settings)
    verbose = s["verbose"]
    kind, method = s["stabilization_type"], s["stabilization_method"]
    first = next(iter(positions.values()))
    channel_index = first.channel_names.index(s["stabilization_estimation_channel"])
    shape_zyx = tuple(int(n) for n in first.data.shape[2:])
    eval_settings = s["eval_transform_settings"]

    def evaluate(fov_transforms: dict) -> dict:
        out = {}
        for fov, transforms in fov_transforms.items():
            transforms = copy.deepcopy(np.asarray(transforms).tolist())
            if eval_settings:
                transforms = evaluate_transforms(
                    transforms=transforms,
                    shape_zyx=shape_zyx,
                    validation_window_size=eval_settings["validation_window_size"],
                    validation_tolerance=eval_settings["validation_tolerance"],
                    interpolation_window_size=eval_settings["interpolation_window_size"],
                    interpolation_type=eval_settings["interpolation_type"],
                    verbose=verbose,
                )
            out[fov] = transforms
        return out

    def xy_dict(stack_reg: dict, fov_focus: dict | None) -> dict:
        chosen = _skip_beads(positions, stack_reg["skip_beads_fov"])
        if fov_focus is None:
            focus_settings = stack_reg["focus_finding_settings"]
            if focus_settings is None:
                raise ValueError("stack_reg_settings.focus_finding_settings is None: "
                                 "xy focus-finding needs it to find the focus slices")
            fov_focus = _focus_per_position(chosen, channel_index, focus_settings,
                                            verbose, dev)
        return {
            _fov_name(key): estimate_xy_stabilization_per_position(
                pos, fov_focus[_fov_name(key)], channel_index, stack_reg["center_crop_xy"],
                t_reference=stack_reg["t_reference"], verbose=verbose, device=dev,
            ).tolist()
            for key, pos in chosen.items()
        }

    def z_focus() -> tuple[dict, dict]:
        focus_settings = s["focus_finding_settings"]
        chosen = _skip_beads(positions, focus_settings["skip_beads_fov"])
        fov_focus = _focus_per_position(chosen, channel_index, focus_settings, verbose, dev)
        return fov_focus, _z_dict(fov_focus, focus_settings)

    if kind == "xyz" and method == "beads":
        # The first position is the beads FOV; its transforms are the run's.
        key, pos = next(iter(positions.items()))
        transforms = estimate_tczyx(
            mov_tczyx=pos.data, ref_tczyx=pos.data, mov_channel_index=channel_index,
            ref_channel_index=channel_index,
            beads_match_settings=s["beads_match_settings"],
            affine_transform_settings=s["affine_transform_settings"],
            verbose=verbose, mode="stabilization", device=dev)
        return {"xyz": evaluate({_fov_name(key): transforms})}
    if kind == "xyz" and method == "focus-finding":
        fov_focus, z_dict = z_focus()
        xy = xy_dict(s["stack_reg_settings"], fov_focus)
        xyz, z_of = _compose_xyz(xy, z_dict)
        return {"xyz": evaluate(xyz), "z": evaluate(z_of), "xy": evaluate(xy)}
    if kind == "xyz" and method == "phase-cross-corr":
        pcc = s["phase_cross_corr_settings"]
        chosen = _skip_beads(positions, pcc["skip_beads_fov"])
        return {"xyz": evaluate({
            _fov_name(key): estimate_xyz_stabilization_pcc_per_position(
                pos, _fov_name(key), channel_index, pcc, verbose, device=dev)
            for key, pos in chosen.items()
        })}
    if kind == "z" and method == "focus-finding":
        return {"z": evaluate(z_focus()[1])}
    if kind == "xy" and method == "focus-finding":
        return {"xy": evaluate(xy_dict(s["stack_reg_settings"], None))}
    return {}


# ---------------------------------------------------------------------------
# The verb on plates
# ---------------------------------------------------------------------------

_FOCUS_COLUMNS = ("position", "time_idx", "channel", "focus_idx")


def _read_focus_csv(path: Path) -> list[dict]:
    with open(path, newline="") as f:
        return [{"position": r["position"], "time_idx": int(r["time_idx"]),
                 "channel": r["channel"], "focus_idx": int(r["focus_idx"])}
                for r in csv.DictReader(f)]


def _write_csv(path: Path, columns, rows) -> None:
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(columns)
        writer.writerows(rows)


def _remove_beads_fov(paths: list, skip_beads_fov: str) -> list:
    """Drop the beads FOV from the estimation inputs (the reference matches
    the string in the path)."""
    if skip_beads_fov != "0":
        print(f"Removing beads FOV {skip_beads_fov} from input data paths")
        paths = [p for p in paths if skip_beads_fov not in str(p)]
    return paths


def _on_device(path, channel_index: int, dev) -> ArrayPosition:
    """One channel of a stored position, read once as (T, Z, Y, X) and moved
    to the device once, as a one-channel position."""
    position = open_ome_zarr(path, mode="r")
    data = as_tensor(position.data[:, channel_index], dev)[:, None]
    return ArrayPosition(data, position.scale, [position.channel_names[channel_index]])


def _mean_focus_from_csv(focus_csv: Path, method: str, verbose: bool) -> np.ndarray:
    """The well-averaged focus index per timepoint of the whole focus table
    (earlier runs' positions included); when ``verbose`` its plot,
    ``z_drift.png``."""
    avg = _mean_focus(_read_focus_csv(focus_csv), method)
    if verbose:
        plt = pyplot(focus_csv.parent / "z_drift.png")
        if plt is not None:
            plt.plot(avg, linestyle="--", label="mean of all positions")
            plt.xlabel("Time index")
            plt.ylabel("Focus index")
            plt.legend()
            plt.savefig(focus_csv.parent / "z_drift.png")
            plt.close()
    return avg


def estimate_z_stabilization(input_position_dirpaths: list, output_folder_path: Path,
                             focus_finding_settings: dict, channel_index: int,
                             verbose: bool = False, estimate_z_index: bool = False,
                             max_batch_bytes: int = DEFAULT_MAX_BATCH_BYTES,
                             device: str | torch.device = "cuda"):
    """Focus-based z transforms per FOV through ``positions_focus.csv``
    (reference :131-185): the new rows first, an existing file's rows after
    them, one row per (position, time_idx), sorted. ``{fov: transforms}``,
    ``{"average": transforms}`` with ``average_across_wells`` (over the
    whole file), or None with ``estimate_z_index``."""
    paths = _remove_beads_fov(input_position_dirpaths, focus_finding_settings["skip_beads_fov"])
    output_folder_path = Path(output_folder_path)
    output_folder_path.mkdir(parents=True, exist_ok=True)
    rows, fov_focus = [], {}
    for path in paths:
        fov = _fov_name(path)
        found = estimate_z_focus_per_position(
            open_ome_zarr(path, mode="r"), fov, channel_index,
            focus_finding_settings["center_crop_xy"], verbose, max_batch_bytes, device)
        rows += found
        fov_focus[fov] = [r["focus_idx"] for r in found]
    focus_csv = output_folder_path / "positions_focus.csv"
    if focus_csv.exists():
        print("Using existing focus CSV file.")
        rows += _read_focus_csv(focus_csv)
    unique = {}
    for row in rows:
        unique.setdefault((row["position"], row["time_idx"]), row)
    _write_csv(focus_csv, _FOCUS_COLUMNS, [[r[k] for k in _FOCUS_COLUMNS]
                                           for _, r in sorted(unique.items())])
    if estimate_z_index:
        return None
    if focus_finding_settings["average_across_wells"]:
        z_offsets = _mean_focus_from_csv(
            focus_csv, focus_finding_settings["average_across_wells_method"], verbose)
        transforms = _z_transforms_from_focus(list(z_offsets)).tolist()
        if verbose:
            print(f"Saving z focus shift matrices to {output_folder_path}")
            np.save(output_folder_path / "z_focus_shift.npy", transforms)
        return {"average": transforms}
    return {fov: _z_transforms_from_focus(vals).tolist() for fov, vals in fov_focus.items()}


def estimate_xy_stabilization(input_position_dirpaths: list, output_folder_path: Path,
                              stack_reg_settings: dict, channel_index: int,
                              verbose: bool = False,
                              max_batch_bytes: int = DEFAULT_MAX_BATCH_BYTES,
                              device: str | torch.device = "cuda") -> dict[str, list]:
    """XY transforms per FOV from the focus slices that
    ``positions_focus.csv`` names, the file written first when absent
    (reference :261-312)."""
    paths = _remove_beads_fov(input_position_dirpaths, stack_reg_settings["skip_beads_fov"])
    output_folder_path = Path(output_folder_path)
    output_folder_path.mkdir(parents=True, exist_ok=True)
    focus_csv = output_folder_path / "positions_focus.csv"
    if focus_csv.exists():
        print("Using existing Z focus index file.")
    else:
        print("Estimating Z focus positions...")
        estimate_z_stabilization(paths, output_folder_path,
                                 stack_reg_settings["focus_finding_settings"], channel_index,
                                 verbose, True, max_batch_bytes, device)
    rows = _read_focus_csv(focus_csv)
    out = {}
    for path in paths:
        key = str(Path(*Path(path).parts[-3:]))
        out[_fov_name(path)] = estimate_xy_stabilization_per_position(
            open_ome_zarr(path, mode="r"), [r["focus_idx"] for r in rows if r["position"] == key],
            channel_index, stack_reg_settings["center_crop_xy"],
            t_reference=stack_reg_settings["t_reference"], verbose=verbose,
            device=device).tolist()
    return out


def estimate_xyz_stabilization_pcc(input_position_dirpaths: list, output_folder_path: Path,
                                   phase_cross_corr_settings: dict, channel_index: int,
                                   verbose: bool = False,
                                   max_batch_bytes: int = DEFAULT_MAX_BATCH_BYTES,
                                   device: str | torch.device = "cuda") -> dict[str, list]:
    """Volumetric PCC transforms per FOV (reference :439-462); when
    ``verbose`` each FOV's shifts as ``shifts_per_position/<fov>.csv``."""
    paths = _remove_beads_fov(input_position_dirpaths,
                              phase_cross_corr_settings["skip_beads_fov"])
    Path(output_folder_path).mkdir(parents=True, exist_ok=True)
    out = {}
    for path in paths:
        fov = _fov_name(path)
        out[fov], shifts = _pcc_transforms_and_shifts(
            _on_device(path, channel_index, resolve_device(device)), 0,
            phase_cross_corr_settings, verbose, max_batch_bytes, device)
        if verbose:
            folder = Path(output_folder_path) / "shifts_per_position"
            folder.mkdir(parents=True, exist_ok=True)
            _write_csv(folder / f"{fov}.csv", ("TimepointID", "ShiftZ", "ShiftY", "ShiftX"),
                       shifts)
    return out


def estimate_stabilization(
    input_position_dirpaths: list[Path],
    output_dirpath: Path,
    config_filepath: Path,
    sbatch_filepath: str | None = None,
    local: bool = False,
    device: str | torch.device = "cuda",
) -> None:
    """The estimate-stabilization verb on plates (module docstring); the
    batch budget is ``BIAHUB_TPU_MAX_BATCH_BYTES``, as the reference's."""
    dev = resolve_device(device)
    settings = yaml_to_model(Path(config_filepath), stabilization_settings_from_reference)
    print(f"Settings: {settings}")
    verbose = settings["verbose"]
    kind, method = settings["stabilization_type"], settings["stabilization_method"]
    output_dirpath = Path(output_dirpath)
    output_dirpath.mkdir(parents=True, exist_ok=True)
    dataset = open_ome_zarr(input_position_dirpaths[0], mode="r")
    channel_index = dataset.channel_names.index(settings["stabilization_estimation_channel"])
    shape_zyx = tuple(dataset.data.shape[2:])
    budget = int(os.environ.get("BIAHUB_TPU_MAX_BATCH_BYTES", DEFAULT_MAX_BATCH_BYTES))
    eval_settings = settings["eval_transform_settings"]
    model = stabilization_settings_dump(
        settings["stabilization_estimation_channel"], kind, method,
        settings["stabilization_channels"], [], dataset.scale)

    def evaluate(transforms):
        if not eval_settings:
            return transforms
        return evaluate_transforms(
            transforms=copy.deepcopy(transforms), shape_zyx=shape_zyx,
            validation_window_size=eval_settings["validation_window_size"],
            validation_tolerance=eval_settings["validation_tolerance"],
            interpolation_window_size=eval_settings["interpolation_window_size"],
            interpolation_type=eval_settings["interpolation_type"], verbose=verbose)

    def save(fov_transforms: dict, what: str) -> None:
        for fov, transforms in fov_transforms.items():
            save_transforms(model, evaluate(transforms),
                            output_dirpath / f"{what}_stabilization_settings" / f"{fov}.yml",
                            output_dirpath / "translation_plots" / f"{fov}.png", verbose)

    paths = list(input_position_dirpaths)
    focus_kw = {"verbose": verbose, "max_batch_bytes": budget, "device": dev}
    if kind == "xyz" and method == "focus-finding":
        print("Estimating xyz stabilization parameters with focus finding and stack "
              "registration")
        z_dict = estimate_z_stabilization(paths, output_dirpath,
                                          settings["focus_finding_settings"], channel_index,
                                          **focus_kw)
        xy_dict = estimate_xy_stabilization(paths, output_dirpath,
                                            settings["stack_reg_settings"], channel_index,
                                            **focus_kw)
        xyz_dict, z_of = _compose_xyz(xy_dict, z_dict)
        save(xyz_dict, "xyz")
        save(z_of, "z")
        save(xy_dict, "xy")
    elif kind == "xyz" and method == "beads":
        print("Estimating xyz stabilization parameters with beads")
        beads = _on_device(paths[0], channel_index, dev)
        transforms = estimate_tczyx(
            mov_tczyx=beads.data, ref_tczyx=beads.data, mov_channel_index=0,
            ref_channel_index=0, beads_match_settings=settings["beads_match_settings"],
            affine_transform_settings=settings["affine_transform_settings"],
            verbose=verbose, output_folder_path=output_dirpath, mode="stabilization",
            device=dev)
        save_transforms(model, evaluate(transforms),
                        output_dirpath / "xyz_stabilization_settings.yml",
                        output_dirpath / "translation_plots" / "beads.png", verbose)
    elif kind == "xyz" and method == "phase-cross-corr":
        print("Estimating xyz stabilization parameters with phase cross correlation")
        save(estimate_xyz_stabilization_pcc(paths, output_dirpath,
                                            settings["phase_cross_corr_settings"],
                                            channel_index, **focus_kw), "xyz")
    elif kind == "z" and method == "focus-finding":
        print("Estimating z stabilization parameters with focus finding")
        save(estimate_z_stabilization(paths, output_dirpath, settings["focus_finding_settings"],
                                      channel_index, **focus_kw), "z")
    elif kind == "xy" and method == "focus-finding":
        print("Estimating xy stabilization parameters with focus finding and stack "
              "registration")
        save(estimate_xy_stabilization(paths, output_dirpath, settings["stack_reg_settings"],
                                       channel_index, **focus_kw), "xy")
