"""Transform QC: outlier validation and interpolation of per-timepoint
transforms.

Counterpart of ``biahub_tpu/registration/utils.py:38-180``, on numpy and
``scipy.interpolate``: a moving-window mean of accepted transforms is the
reference; a candidate whose mean grid-point displacement against it
exceeds the tolerance is dropped and filled by local (or global)
interpolation over the 4x4 entries. ``save_transforms`` writes the
transforms into a settings YAML (the port's writer) and, when verbose,
their translations as a plot (:func:`plot_translations`; only where
matplotlib is installed, :func:`biahub_tpu_torch.plots.pyplot`). Also
the approximate source->target transform from voxel sizes
(:func:`approx_transform_from_scale`, utils.py:236) with its matrix helpers
(the reference's ``register.py:47-95``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Literal

import numpy as np

from biahub_tpu_torch.cli.utils import model_to_yaml
from biahub_tpu_torch.plots import pyplot

__all__ = [
    "check_transforms_difference",
    "validate_transforms",
    "interpolate_transforms",
    "evaluate_transforms",
    "save_transforms",
    "plot_translations",
    "load_transforms",
    "approx_transform_from_scale",
    "get_3D_rescaling_matrix",
    "get_3D_rotation_matrix",
    "get_3D_fliplr_matrix",
]


def check_transforms_difference(
    tform1,
    tform2,
    shape_zyx: tuple[int, int, int],
    threshold: float = 5.0,
    verbose: bool = False,
) -> bool:
    """True when the mean displacement of a 10^3 grid under the two transforms
    is within the threshold."""
    tform1 = np.array(tform1)
    tform2 = np.array(tform2)
    Z, Y, X = shape_zyx
    zz, yy, xx = np.meshgrid(
        np.linspace(0, Z - 1, 10), np.linspace(0, Y - 1, 10), np.linspace(0, X - 1, 10)
    )
    grid = np.vstack([zz.ravel(), yy.ravel(), xx.ravel(), np.ones(zz.size)]).T
    p1 = (tform1 @ grid.T).T
    p2 = (tform2 @ grid.T).T
    mse = np.mean(np.linalg.norm(p1[:, :3] - p2[:, :3], axis=1))
    if verbose:
        print(f"MSE of transformed points: {mse:.2f}; threshold: {threshold:.2f}")
    return mse <= threshold


def validate_transforms(
    transforms: list,
    shape_zyx: tuple[int, int, int],
    window_size: int = 10,
    tolerance: float = 100.0,
    verbose: bool = False,
) -> list:
    """Mark outlier transforms as None (in place) by windowed-mean deviation."""
    valid: list = []
    reference = None
    for i, transform in enumerate(transforms):
        if transform is None:
            if verbose:
                print(f"Transform at timepoint {i} is None and will be interpolated")
            continue
        if len(valid) < window_size:
            valid.append(transform)
            reference = np.mean(valid, axis=0)
            if verbose:
                print(f"[Bootstrap] Accepting transform at timepoint {i} (no validation)")
        elif check_transforms_difference(transform, reference, shape_zyx, tolerance, verbose):
            valid.append(transform)
            if len(valid) > window_size:
                valid.pop(0)
            reference = np.mean(valid, axis=0)
            if verbose:
                print(f"Transform at timepoint {i} is valid")
        else:
            transforms[i] = None
            if verbose:
                print(f"Transform at timepoint {i} is invalid and will be interpolated")
    return transforms


def interpolate_transforms(
    transforms: list,
    window_size: int = 3,
    interpolation_type: Literal["linear", "cubic"] = "linear",
    verbose: bool = False,
) -> list:
    """Fill None entries by interpolating the 4x4 entries over time."""
    # scipy is imported at call time: its import starts a process (numpy's
    # CPU probe), and importing the port starts none.
    from scipy.interpolate import interp1d

    n = len(transforms)
    valid_indices = [i for i, t in enumerate(transforms) if t is not None]
    valid = [np.array(transforms[i]) for i in valid_indices]
    if len(valid_indices) < 2:
        raise ValueError("At least two valid transforms are required for interpolation.")

    missing = [i for i in range(n) if transforms[i] is None]
    if not missing:
        return transforms
    if verbose:
        print(f"Interpolating missing transforms at timepoints: {missing}")

    if window_size > 0:
        for idx in missing:
            start = max(0, idx - window_size)
            end = min(n, idx + window_size + 1)
            local_x = [j for j in range(start, end) if j in valid_indices]
            local_y = [np.array(transforms[j]) for j in local_x]
            if len(local_x) < 2:
                closest = valid_indices[
                    int(np.argmin(np.abs(np.asarray(valid_indices) - idx)))
                ]
                transforms[idx] = transforms[closest]
                if verbose:
                    print(
                        f"Not enough interpolation neighbors were found for timepoint "
                        f"{idx} using closest valid transform at timepoint {closest}"
                    )
                continue
            kind = interpolation_type if len(local_x) > 3 else "linear"
            f = interp1d(local_x, local_y, axis=0, kind=kind, fill_value="extrapolate")
            transforms[idx] = f(idx).tolist()
            if verbose:
                print(f"Interpolated timepoint {idx} using neighbors: {local_x}")
    else:
        f = interp1d(valid_indices, valid, axis=0, kind="linear", fill_value="extrapolate")
        transforms = [
            f(i).tolist() if transforms[i] is None else transforms[i] for i in range(n)
        ]
    return transforms


def evaluate_transforms(
    transforms,
    shape_zyx: tuple[int, int, int],
    validation_window_size: int = 10,
    validation_tolerance: float = 100.0,
    interpolation_window_size: int = 3,
    interpolation_type: Literal["linear", "cubic"] = "linear",
    verbose: bool = False,
):
    """Validate then interpolate a per-timepoint transform list."""
    if not isinstance(transforms, list):
        transforms = transforms.tolist()
    if len(transforms) < validation_window_size:
        raise Warning(
            f"Not enough transforms for validation and interpolation. "
            f"Required: {validation_window_size}, Provided: {len(transforms)}"
        )
    transforms = validate_transforms(
        transforms=transforms,
        window_size=validation_window_size,
        tolerance=validation_tolerance,
        shape_zyx=shape_zyx,
        verbose=verbose,
    )
    if len(transforms) < interpolation_window_size:
        raise Warning(
            f"Not enough transforms for interpolation. "
            f"Required: {interpolation_window_size}, Provided: {len(transforms)}"
        )
    return interpolate_transforms(
        transforms=transforms,
        window_size=interpolation_window_size,
        interpolation_type=interpolation_type,
        verbose=verbose,
    )


def get_3D_rescaling_matrix(start_shape_zyx, scaling_factor_zyx=(1, 1, 1), end_shape_zyx=None):
    """YX-centered anisotropic rescale (the reference's register.py:47)."""
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


def get_3D_rotation_matrix(start_shape_zyx, angle: float = 0.0, end_shape_zyx=None):
    """In-plane (YX) rotation about the volume center (register.py:65)."""
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


def get_3D_fliplr_matrix(start_shape_zyx, end_shape_zyx=None):
    """Left-right (X) flip about the volume center (register.py:84)."""
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


def save_transforms(
    model: dict,
    transforms,
    output_filepath_settings,
    output_filepath_plot=None,
    verbose: bool = False,
) -> None:
    """Write the per-timepoint transforms into a settings YAML: ``model``
    (a ``StabilizationSettings`` dict, e.g. ``convert.
    stabilization_settings_dump``) with ``affine_transform_zyx_list``
    replaced; when ``verbose``, also the translations' plot (reference
    ``registration/utils.py:182-206``). A path without ``.yml``/``.yaml``
    (``.png`` for the plot) takes that suffix."""
    if transforms is None or len(transforms) == 0:
        raise ValueError("Transforms are empty")
    if not isinstance(transforms, list):
        transforms = transforms.tolist()
    output_filepath_settings = Path(output_filepath_settings)
    if output_filepath_settings.suffix not in (".yml", ".yaml"):
        output_filepath_settings = output_filepath_settings.with_suffix(".yml")
    output_filepath_settings.parent.mkdir(parents=True, exist_ok=True)
    model_to_yaml(dict(model, affine_transform_zyx_list=transforms), output_filepath_settings)
    if verbose and output_filepath_plot is not None:
        output_filepath_plot = Path(output_filepath_plot)
        if output_filepath_plot.suffix != ".png":
            output_filepath_plot = output_filepath_plot.with_suffix(".png")
        plot_translations(np.asarray(transforms), output_filepath_plot)


def plot_translations(transforms_zyx, output_filepath) -> None:
    """The Z, X and Y translations of (T, 4, 4) transforms over time, one
    panel each (reference ``registration/utils.py:209-225``)."""
    plt = pyplot(output_filepath)
    if plt is None:
        return
    transforms_zyx = np.asarray(transforms_zyx)
    _, axs = plt.subplots(3, 1, figsize=(10, 10))
    axs[0].plot(transforms_zyx[:, 0, 3])
    axs[0].set_title("Z-Translation")
    axs[1].plot(transforms_zyx[:, 2, 3])
    axs[1].set_title("X-Translation")
    axs[2].plot(transforms_zyx[:, 1, 3])
    axs[2].set_title("Y-Translation")
    plt.savefig(output_filepath, dpi=300, bbox_inches="tight")
    plt.close()


def load_transforms(folder: Path, pattern: str = "*.npy") -> dict[str, np.ndarray]:
    """Per-FOV transform stacks saved as ``.npy`` files in ``folder``, by
    file stem, in sorted order."""
    return {path.stem: np.load(path) for path in sorted(Path(folder).glob(pattern))}


def approx_transform_from_scale(
    source_scale_zyx,
    target_scale_zyx,
    rotation_90_count: int = 0,
    flip: tuple[bool, bool, bool] = (False, False, False),
    source_shape_zyx=None,
    target_shape_zyx=None,
) -> np.ndarray:
    """Approximate source->target transform from voxel-size scaling, a
    90-degree in-plane rotation count and axis flips (the reference's
    utils.py:236)."""
    scale = np.asarray(source_scale_zyx, dtype=float) / np.asarray(
        target_scale_zyx, dtype=float
    )
    out = get_3D_rescaling_matrix(
        source_shape_zyx or (1, 1, 1), scale, target_shape_zyx or source_shape_zyx
    )
    if rotation_90_count:
        out = (
            get_3D_rotation_matrix(
                target_shape_zyx or source_shape_zyx or (1, 1, 1),
                90.0 * rotation_90_count,
            )
            @ out
        )
    if any(flip):
        if flip[-1]:
            out = get_3D_fliplr_matrix(target_shape_zyx or source_shape_zyx or (1, 1, 1)) @ out
    return out
