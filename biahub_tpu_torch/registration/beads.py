"""Beads-based registration: detect -> match -> fit -> iterate.

Counterpart of ``biahub_tpu/registration/beads.py:50-453``: detect bead
peaks in both volumes (kernel G, :func:`~biahub_tpu_torch.kernels.peaks.
detect_peaks`), match them by graph matching, fit a euclidean, similarity
or affine transform, compose it with the current warp, and keep whichever
scores better on KD-tree peak overlap, ``qc_settings.iterations`` times.
Warps run on the device through :func:`~biahub_tpu_torch.kernels.affine.
affine_warp_auto` (general matrices: the multipass warp, kernel H); the
volumes stay on the device, and only peak coordinates and matrices cross
to the host.

Every transform here is a WARP matrix mapping output (reference) index
coordinates to input (moving) ones. If F maps moving points to reference
points (the fit's direction), the warp correction is F^-1 composed on the
right: W' = W @ F^-1.

Settings are the reference models' dicts
(:func:`~biahub_tpu_torch.convert.beads_match_settings_from_reference`,
:func:`~biahub_tpu_torch.convert.affine_transform_settings_from_reference`).
``output_filepath`` saves the best transform as ``.npy`` and
``output_folder_path`` each timepoint's (``<t>.npy``, under
``xyz_transforms/`` for a stack), as the reference's.
:func:`optimize_matches` grid-searches the matching settings (reference
:456-562), each trial warped and scored on the device.
"""

from __future__ import annotations

import copy
from itertools import product
from pathlib import Path
from typing import Literal

import numpy as np
import torch

from biahub_tpu_torch.convert import (
    affine_transform_settings_from_reference,
    beads_match_settings_from_reference,
)
from biahub_tpu_torch.device import as_tensor, resolve_device
from biahub_tpu_torch.kernels.affine import affine_warp_auto
from biahub_tpu_torch.kernels.peaks import detect_peaks
from biahub_tpu_torch.transforms.fitting import fit_transform
from biahub_tpu_torch.transforms.graph_matching import Graph, GraphMatcher

__all__ = [
    "peaks_from_beads",
    "matches_from_beads",
    "transform_from_matches",
    "overlap_score",
    "optimize_transform",
    "optimize_matches",
    "estimate",
    "estimate_tzyx",
    "estimate_tczyx",
    "estimate_with_propagation",
    "estimate_independently",
]


def _warp(mov: torch.Tensor, warp_matrix, out_shape, device) -> torch.Tensor:
    return affine_warp_auto(torch.nan_to_num(mov, nan=0.0),
                            np.asarray(warp_matrix, dtype=np.float64),
                            tuple(int(s) for s in out_shape), device=device)


def _all_zeros_or_nan(t: torch.Tensor) -> bool:
    return bool(torch.isnan(t).all() or (t == 0).all())


def peaks_from_beads(mov, ref, mov_peaks_settings: dict, ref_peaks_settings: dict,
                     verbose: bool = False, mask_path=None,
                     device: str | torch.device = "cuda"):
    """Bead peaks of the moving and reference volumes, or (None, None) when
    either has fewer than two. With ``mask_path`` (a position whose first
    (t, c) volume is the mask) only the reference peaks whose (y, x) column
    the mask leaves clean at every z are kept."""
    peaks = []
    for name, vol, ps in (("moving", mov, mov_peaks_settings),
                          ("reference", ref, ref_peaks_settings)):
        if verbose:
            print(f"Detecting beads in {name} dataset")
        peaks.append(detect_peaks(
            vol, block_size=tuple(ps["block_size"]), threshold_abs=ps["threshold_abs"],
            nms_distance=ps["nms_distance"], min_distance=ps["min_distance"],
            verbose=verbose, device=device))
    mov_peaks, ref_peaks = peaks
    if verbose:
        print(f"Total of peaks in moving dataset: {len(mov_peaks)}")
        print(f"Total of peaks in reference dataset: {len(ref_peaks)}")
    if len(mov_peaks) < 2 or len(ref_peaks) < 2:
        print("Not enough beads detected")
        return None, None
    if mask_path is not None:
        from biahub_tpu_torch.io.ngff import open_ome_zarr

        print("Filtering peaks with mask")
        mask = np.asarray(open_ome_zarr(mask_path).data[0, 0])
        ref_peaks = np.array([
            p for p in np.asarray(ref_peaks)
            if 0 <= int(p[1]) < mask.shape[1] and 0 <= int(p[2]) < mask.shape[2]
            and not mask[:, int(p[1]), int(p[2])].any()
        ])
    return mov_peaks, ref_peaks


def matches_from_beads(mov_peaks, ref_peaks, beads_match_settings: dict,
                       verbose: bool = False) -> np.ndarray:
    """Match bead peaks (Hungarian graph matching or descriptor matching),
    then filter them geometrically; (K, 2) int32 (moving, reference)."""
    s = beads_match_settings
    if s["algorithm"] == "match_descriptor":
        mov_graph = Graph.from_nodes(mov_peaks)
        ref_graph = Graph.from_nodes(ref_peaks)
        md = s["match_descriptor_settings"]
        matcher = GraphMatcher(algorithm="descriptor", cross_check=md["cross_check"],
                               max_ratio=md["max_ratio"], metric=md["distance_metric"],
                               verbose=verbose)
    else:
        hm = s["hungarian_match_settings"]
        k = hm["edge_graph_settings"]["k"]
        mov_graph = Graph.from_nodes(mov_peaks, mode="knn", k=k)
        ref_graph = Graph.from_nodes(ref_peaks, mode="knn", k=k)
        matcher = GraphMatcher(algorithm="hungarian",
                               weights=hm["cost_matrix_settings"]["weights"],
                               cost_threshold=hm["cost_threshold"],
                               cross_check=hm["cross_check"], max_ratio=hm["max_ratio"],
                               verbose=verbose)
    matches = matcher.match(mov_graph, ref_graph)
    fm = s["filter_matches_settings"]
    matches = matcher.filter_matches(
        matches, mov_graph, ref_graph,
        angle_threshold=fm["angle_threshold"],
        min_distance_quantile=fm["min_distance_quantile"],
        max_distance_quantile=fm["max_distance_quantile"],
        direction_threshold=fm["direction_threshold"],
    )
    if verbose:
        print(f"Total of matches: {len(matches)}")
    return matches


def transform_from_matches(matches, mov_peaks, ref_peaks, affine_transform_settings: dict,
                           ndim: int = 3, verbose: bool = False):
    """(forward, inverse) homogeneous matrices of the fitted points map
    mov -> ref; the inverse is the warp correction."""
    if ndim not in (2, 3):
        raise ValueError(f"Peaks must be 2D or 3D, got {ndim}D")
    fwd = fit_transform(mov_peaks[matches[:, 0]], ref_peaks[matches[:, 1]],
                        affine_transform_settings["transform_type"])
    return fwd, np.linalg.inv(fwd)


def overlap_score(mov_peaks, ref_peaks, radius: int = 6, verbose: bool = False) -> float:
    """Fraction of reference peaks with a moving peak within ``radius``."""
    from scipy.spatial import cKDTree

    if mov_peaks is None or ref_peaks is None or len(mov_peaks) == 0 or len(ref_peaks) == 0:
        print("No peaks found, returning nan metrics")
        return np.nan
    mov_tree = cKDTree(mov_peaks)
    hits = sum(1 for p in ref_peaks if mov_tree.query_ball_point(p, r=radius))
    fraction = hits / max(min(len(mov_peaks), len(ref_peaks)), 1)
    if verbose:
        print(f"Mov peaks: {len(mov_peaks)}")
        print(f"Ref peaks: {len(ref_peaks)}")
        print(f"Peaks overlap fraction: {fraction}")
    return fraction


def optimize_transform(transform, mov, ref, beads_match_settings: dict,
                       affine_transform_settings: dict, verbose: bool = False,
                       debug: bool = False, device: str | torch.device = "cuda"):
    """One refinement round; returns the better of (input, corrected) warp
    and its score, or (None, -1)."""
    dev = resolve_device(device)
    ref = as_tensor(ref, dev)
    mov = as_tensor(mov, dev)
    peak_settings = (beads_match_settings["source_peaks_settings"],
                     beads_match_settings["target_peaks_settings"])

    mov_reg = _warp(mov, transform, ref.shape, dev)
    mov_peaks, ref_peaks = peaks_from_beads(mov_reg, ref, *peak_settings, verbose=debug,
                                            device=dev)
    if mov_peaks is None or ref_peaks is None:
        return None, -1

    radius = beads_match_settings["qc_settings"]["score_centroid_mask_radius"]
    score_before = overlap_score(mov_peaks, ref_peaks, radius=radius, verbose=debug)

    matches = matches_from_beads(mov_peaks, ref_peaks, beads_match_settings, verbose=debug)
    if len(matches) < 3:
        print("Not enough matches found, returning the current transform")
        return None, -1

    _, inv = transform_from_matches(matches, mov_peaks, ref_peaks, affine_transform_settings,
                                    ndim=mov.ndim, verbose=debug)
    composed = np.asarray(transform) @ inv

    mov_reg_opt = _warp(mov, composed, ref.shape, dev)
    mov_peaks_opt, ref_peaks_opt = peaks_from_beads(mov_reg_opt, ref, *peak_settings,
                                                    verbose=debug, device=dev)
    score_after = overlap_score(mov_peaks_opt, ref_peaks_opt, radius=radius, verbose=debug)

    if verbose:
        print(f"Quality score before beads matching: {score_before}")
        print(f"Quality score after beads matching: {score_after}")

    if not np.isnan(score_after) and score_after >= score_before:
        return composed, score_after
    return np.asarray(transform), score_before


# optimize_matches' grid keys, each the path of the entry it sets in the
# beads match settings dict (the reference's setters, beads.py:500-520).
_GRID_PATHS = {
    "min_distance_quantile": ("filter_matches_settings", "min_distance_quantile"),
    "max_distance_quantile": ("filter_matches_settings", "max_distance_quantile"),
    "direction_threshold": ("filter_matches_settings", "direction_threshold"),
    "cost_threshold": ("hungarian_match_settings", "cost_threshold"),
    "max_ratio": ("hungarian_match_settings", "max_ratio"),
    "k": ("hungarian_match_settings", "edge_graph_settings", "k"),
    **{f"weights_{w}": ("hungarian_match_settings", "cost_matrix_settings", "weights", w)
       for w in ("dist", "edge_angle", "edge_length", "pca_dir", "pca_aniso",
                 "edge_descriptor")},
}
DEFAULT_PARAM_GRID = {
    "min_distance_quantile": [0, 0.01],
    "max_distance_quantile": [0, 0.99],
    "direction_threshold": [0, 50],
    "k": [5, 10],
}


def optimize_matches(mov, ref, approx_transform, beads_match_settings: dict,
                     affine_transform_settings: dict, param_grid: dict | None = None,
                     verbose: bool = False, device: str | torch.device = "cuda") -> dict:
    """The beads match settings of the grid's best trial: for each
    combination of ``param_grid`` (default :data:`DEFAULT_PARAM_GRID`, 16
    trials) match the peaks of the approximately registered pair, fit and
    compose the correction, warp again and score the peaks' overlap; the
    settings unchanged when too few peaks are found or no trial scores.
    A trial that meets too few or degenerate matches on the host
    (``ValueError``, ``LinAlgError``) is skipped; a device error is raised."""
    dev = resolve_device(device)
    bms = beads_match_settings_from_reference(beads_match_settings)
    ats = affine_transform_settings_from_reference(affine_transform_settings)
    param_grid = DEFAULT_PARAM_GRID if param_grid is None else param_grid
    score_radius = bms["qc_settings"]["score_centroid_mask_radius"]
    peak_settings = (bms["source_peaks_settings"], bms["target_peaks_settings"])
    approx = np.asarray(approx_transform, dtype=np.float64)
    ref = as_tensor(ref, dev)
    mov = as_tensor(mov, dev)

    print("Detecting peaks in approximately registered space for grid search...")
    mov_peaks, ref_peaks = peaks_from_beads(_warp(mov, approx, ref.shape, dev), ref,
                                            *peak_settings, device=dev)
    if mov_peaks is None or ref_peaks is None:
        print("Not enough peaks detected for optimization, returning original settings.")
        return bms

    grid_keys = list(param_grid)
    grid_values = [param_grid[k] for k in grid_keys]
    print(f"Starting grid search: {len(mov_peaks)} mov peaks, {len(ref_peaks)} ref peaks, "
          f"{np.prod([len(v) for v in grid_values])} parameter combinations.")

    best_score, best_settings = -1.0, bms
    for combo in product(*grid_values):
        params = dict(zip(grid_keys, combo))
        trial = copy.deepcopy(bms)
        for key, value in params.items():
            if key in _GRID_PATHS:
                *parents, leaf = _GRID_PATHS[key]
                node = trial
                for name in parents:
                    node = node[name]
                node[leaf] = value
        try:
            matches = matches_from_beads(mov_peaks, ref_peaks, trial)
            if len(matches) < 3:
                continue
            _, inv = transform_from_matches(matches, mov_peaks, ref_peaks, ats,
                                            ndim=mov_peaks.shape[1])
        except (ValueError, np.linalg.LinAlgError) as e:
            if verbose:
                print(f"  {params} -> failed: {e}")
            continue
        composed = approx @ inv
        peaks_opt = peaks_from_beads(_warp(mov, composed, ref.shape, dev), ref, *peak_settings,
                                     device=dev)
        if peaks_opt[0] is None:
            continue
        score = overlap_score(peaks_opt[0], peaks_opt[1], radius=score_radius)
        if np.isnan(score):
            continue
        if verbose:
            print(f"  {params} -> matches={len(matches)}, score={score:.4f}")
        if score > best_score:
            best_score, best_settings = score, trial

    if verbose:
        print(f"Best score: {best_score:.4f}")
    return best_settings


def estimate(mov, ref, beads_match_settings: dict | None = None,
             affine_transform_settings: dict | None = None, verbose: bool = False,
             output_filepath=None, user_transform=None, debug: bool = False,
             device: str | torch.device = "cuda"):
    """Iteratively estimate the best warp between a moving and a reference
    (Z, Y, X) volume; None when either is all zeros or NaN. With
    ``output_filepath`` the best transform is saved there (``np.save``)."""
    dev = resolve_device(device)
    bms = beads_match_settings_from_reference(beads_match_settings)
    ats = affine_transform_settings_from_reference(affine_transform_settings)
    mov, ref = as_tensor(mov, dev), as_tensor(ref, dev)
    if _all_zeros_or_nan(mov) or _all_zeros_or_nan(ref):
        print("Skipping: moving or reference data contains only NaN/zeros.")
        return None

    initial = np.asarray(ats["approx_transform"], dtype=np.float64)
    transform = initial
    qc_iterations = bms["qc_settings"]["iterations"]
    history: list[tuple[np.ndarray | None, float]] = []

    for iteration in range(qc_iterations):
        if verbose:
            print(f"Iteration {iteration + 1}/{qc_iterations}: optimizing transform via "
                  "bead matching...")
        optimized, score = optimize_transform(transform, mov, ref, bms, ats, verbose=verbose,
                                              debug=debug, device=dev)
        history.append((optimized, score))
        if score == 1:
            break
        transform = optimized

        if user_transform is not None and iteration == 0:
            if verbose:
                print("Optimizing user transform:")
            optimized_user, score_user = optimize_transform(
                np.asarray(user_transform, dtype=np.float64), mov, ref, bms, ats,
                verbose=verbose, debug=debug, device=dev)
            if score_user > score:
                history[-1] = (optimized_user, score_user)
                if score_user == 1:
                    break
                transform = optimized_user

        if transform is None:
            break

    best_transform, best_score = max(history, key=lambda x: x[1]) if history else (None, -1)
    if best_transform is None:
        best_transform = initial
    if verbose:
        print(f"Best transform:\n{best_transform}")
        print(f"Best quality score: {best_score}")
    if output_filepath:
        print(f"Saving transform to {output_filepath}")
        np.save(output_filepath, np.asarray(best_transform))
    return best_transform


def estimate_tzyx(t_idx: int, mov_tzyx, ref_tzyx, beads_match_settings: dict | None = None,
                  affine_transform_settings: dict | None = None, verbose: bool = False,
                  output_folder_path=None,
                  mode: Literal["registration", "stabilization"] = "registration",
                  user_transform=None, device: str | torch.device = "cuda"):
    """The warp of one timepoint; in stabilization mode the reference volume
    is the first timepoint or the previous one (``t_reference``). With
    ``output_folder_path`` the result is saved there as ``<t_idx>.npy``."""
    dev = resolve_device(device)
    ats = affine_transform_settings_from_reference(affine_transform_settings)
    if verbose:
        print(f"Processing timepoint: {t_idx}")
    mov_zyx = as_tensor(mov_tzyx[t_idx], dev)
    if mode == "stabilization":
        t_ref = 0 if ats["t_reference"] == "first" else max(t_idx - 1, 0)
        ref_zyx = as_tensor(mov_tzyx[t_ref], dev)
    else:
        ref_zyx = as_tensor(ref_tzyx[t_idx], dev)
    output_filepath = None
    if output_folder_path:
        Path(output_folder_path).mkdir(parents=True, exist_ok=True)
        output_filepath = Path(output_folder_path) / f"{t_idx}.npy"
    return estimate(mov_zyx, ref_zyx, beads_match_settings, ats, verbose=verbose,
                    output_filepath=output_filepath, user_transform=user_transform,
                    device=dev)


class _ChannelView:
    """(T, Z, Y, X) view of one channel of a (T, C, Z, Y, X) array."""

    def __init__(self, data, c):
        self._data, self._c = data, c
        self.shape = (data.shape[0],) + tuple(data.shape[2:])
        self.ndim = 4

    def __getitem__(self, t):
        return self._data[t, self._c]


def estimate_tczyx(
    mov_tczyx,
    ref_tczyx,
    mov_channel_index: int,
    ref_channel_index: int | None = None,
    beads_match_settings: dict | None = None,
    affine_transform_settings: dict | None = None,
    verbose: bool = False,
    output_folder_path=None,
    ref_voxel_size=(0.174, 0.1494, 0.1494),
    mov_voxel_size=(0.174, 0.1494, 0.1494),
    mode: Literal["registration", "stabilization"] = "registration",
    device: str | torch.device = "cuda",
) -> list:
    """Per-timepoint beads warps (4x4 nested lists) of a whole (T, C, Z, Y,
    X) stack, numpy or a tensor; failed timepoints become the identity. With
    ``use_prev_t_transform`` each result seeds the next timepoint. With
    ``output_folder_path`` each timepoint's result is saved as
    ``xyz_transforms/<t>.npy`` there."""
    dev = resolve_device(device)
    bms = beads_match_settings_from_reference(beads_match_settings)
    ats = affine_transform_settings_from_reference(affine_transform_settings)

    mov_tzyx = _ChannelView(mov_tczyx, mov_channel_index)
    ref_tzyx = mov_tzyx if mode == "stabilization" else _ChannelView(ref_tczyx,
                                                                       ref_channel_index)
    if ats["compute_approx_transform"]:
        from biahub_tpu_torch.registration.utils import approx_transform_from_scale

        approx = approx_transform_from_scale(
            mov_voxel_size, ref_voxel_size, rotation_90_count=-1,
            source_shape_zyx=mov_tzyx.shape[-3:], target_shape_zyx=ref_tzyx.shape[-3:])
        if verbose:
            print(f"Computed approx transform: {approx}")
        ats["approx_transform"] = approx.tolist()

    transforms_dir = None
    if output_folder_path is not None:
        transforms_dir = Path(output_folder_path) / "xyz_transforms"
        transforms_dir.mkdir(parents=True, exist_ok=True)
    initial = ats["approx_transform"]
    transforms: list = []
    for t in range(mov_tzyx.shape[0]):
        if mode == "stabilization" and t == 0:
            transforms.append(np.eye(4).tolist())
            continue
        mov_t, ref_t = as_tensor(mov_tzyx[t], dev), as_tensor(ref_tzyx[t], dev)
        if _all_zeros_or_nan(mov_t) or _all_zeros_or_nan(ref_t):
            print(f"Timepoint {t} has no data, skipping")
            transforms.append(None)
            continue
        user = initial if ats["use_prev_t_transform"] else None
        result = estimate_tzyx(t, mov_tzyx, ref_tzyx, bms, ats, verbose=verbose,
                               output_folder_path=transforms_dir, mode=mode,
                               user_transform=user, device=dev)
        if result is not None:
            transforms.append(np.asarray(result).tolist())
            if ats["use_prev_t_transform"]:
                # Propagate: this timepoint's result seeds the next.
                ats["approx_transform"] = np.asarray(result).tolist()
        else:
            transforms.append(None)
    return [t if t is not None else np.eye(4).tolist() for t in transforms]


def _with_propagation(kwargs: dict, flag: bool) -> dict:
    settings = dict(kwargs.get("affine_transform_settings") or {})
    settings["use_prev_t_transform"] = flag
    return dict(kwargs, affine_transform_settings=settings)


def estimate_with_propagation(*args, **kwargs) -> list:
    """:func:`estimate_tczyx` with each timepoint's result seeding the next
    (``use_prev_t_transform`` set; the reference's
    ``estimate_with_propagation``, registration/beads.py:572)."""
    return estimate_tczyx(*args, **_with_propagation(kwargs, True))


def estimate_independently(*args, **kwargs) -> list:
    """:func:`estimate_tczyx` with every timepoint estimated from scratch
    (``use_prev_t_transform`` unset; the reference's
    ``estimate_independently``, registration/beads.py:578)."""
    return estimate_tczyx(*args, **_with_propagation(kwargs, False))
