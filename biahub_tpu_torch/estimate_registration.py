"""estimate-registration: a source->target warp.

Counterpart of ``biahub_tpu/estimate_registration.py`` for its three
methods: ``beads`` (:mod:`biahub_tpu_torch.registration.beads`), ``ants``
(intensity registration, :mod:`biahub_tpu_torch.registration.intensity`)
and ``manual``, point pairs picked by a user: headless from point files
(``--source-points``/``--target-points``, :func:`registration_from_point_pairs`)
or, where napari is installed, clicked in a viewer
(:func:`user_assisted_registration`). The manual fit
(:func:`manual_transform_from_picked_points`) is a 3D similarity, or the
reference's Euclidean variant: a 2D YX rigid fit plus the z translation of
the first point pair.

One transform gives the ``RegistrationSettings`` fields, several (one per
timepoint) the ``StabilizationSettings`` fields, after
``evaluate_transforms`` when the settings ask for it.
:func:`estimate_registration_arrays` returns them as a dict; the verb,
:func:`estimate_registration`, reads the two channels from the plates (each
once, moved to the device once; the manual method reads only what its
route needs) and writes them as the YAML file that ``register`` and
``stabilize`` read, with each timepoint's transform as
``xyz_transforms/<t>.npy`` beside it and, when verbose and several,
``translation_plots/<method>_registration.png``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from biahub_tpu_torch.cli.parsing import CommandError
from biahub_tpu_torch.cli.utils import model_to_yaml, yaml_to_model
from biahub_tpu_torch.convert import (
    registration_estimate_settings_from_reference,
    registration_settings_dump,
    stabilization_settings_dump,
)
from biahub_tpu_torch.device import as_tensor, resolve_device
from biahub_tpu_torch.io.ngff import open_ome_zarr
from biahub_tpu_torch.register import (
    get_3D_fliplr_matrix,
    get_3D_rescaling_matrix,
    get_3D_rotation_matrix,
)
from biahub_tpu_torch.registration.utils import evaluate_transforms, plot_translations
from biahub_tpu_torch.transforms.fitting import fit_transform

__all__ = [
    "estimate_registration_arrays",
    "estimate_registration",
    "registration_from_point_pairs",
    "manual_compound_affine",
    "manual_transform_from_picked_points",
    "user_assisted_registration",
    "HEADLESS_MESSAGE",
]

# Focus-finding constants of the manual flow (the reference's :61-67).
NA_DETECTION_SOURCE = 1.35
NA_DETECTION_TARGET = 1.35
WAVELENGTH_EMISSION_SOURCE_CHANNEL = 0.45  # um
WAVELENGTH_EMISSION_TARGET_CHANNEL = 0.6  # um
FOCUS_SLICE_ROI_WIDTH = 150

COLOR_CYCLE = ["white", "cyan", "lime", "orchid", "blue", "orange", "yellow", "magenta"]

HEADLESS_MESSAGE = (
    "user_assisted_registration requires an interactive napari "
    "session; headless, export point pairs and pass --source-points/"
    "--target-points (or call registration_from_point_pairs), or use "
    "the 'beads'/'ants' estimation methods."
)


def manual_compound_affine(source_shape_zyx, target_shape_zyx, source_voxel_size,
                           target_voxel_size, pre_affine_90degree_rotation: int = 0,
                           pre_affine_fliplr: bool = False) -> np.ndarray:
    """Pre-alignment compound affine of the manual flow: voxel-size rescale
    ∘ optional 90° in-plane rotation ∘ optional left-right flip (flip
    first)."""
    sz = float(source_voxel_size[-3]) / float(target_voxel_size[-3])
    syx = float(source_voxel_size[-1]) / float(target_voxel_size[-1])
    scaling_affine = get_3D_rescaling_matrix(target_shape_zyx, (sz, syx, syx),
                                             target_shape_zyx)
    rotate90_affine = get_3D_rotation_matrix(source_shape_zyx,
                                             90.0 * pre_affine_90degree_rotation,
                                             target_shape_zyx)
    fliplr_affine = (get_3D_fliplr_matrix(source_shape_zyx, target_shape_zyx)
                     if pre_affine_fliplr else np.eye(4))
    return scaling_affine @ rotate90_affine @ fliplr_affine


def manual_transform_from_picked_points(source_points, target_points, compound_affine,
                                        similarity: bool = False) -> np.ndarray:
    """Output->input registration matrix from clicked point pairs.

    ``source_points`` are in the PRE-ALIGNED display frame (picked on the
    compound-affine overlay, as the napari flow records them). Similarity
    fits all three axes; Euclidean is a 2D YX rigid fit plus a z
    translation from the FIRST point pair.
    """
    src = np.asarray(source_points, dtype=np.float64)
    dst = np.asarray(target_points, dtype=np.float64)
    if src.shape != dst.shape or src.ndim != 2 or src.shape[1] != 3:
        raise ValueError(
            f"point arrays must both be (N, 3) ZYX; got {src.shape} vs {dst.shape}")
    if len(src) < 3:
        raise ValueError("need at least three point pairs")
    if similarity:
        fit = fit_transform(src, dst, "similarity")
    else:
        yx = fit_transform(src[:, 1:], dst[:, 1:], "euclidean")  # (3, 3)
        z_translation = dst[0, 0] - src[0, 0]
        fit = np.vstack([np.array([[1.0, 0.0, 0.0, z_translation]]),
                         np.insert(yx, 0, 0.0, axis=1)])
    # fit @ compound maps source to target points; the warp matrix
    # (output -> input) is its inverse.
    return np.linalg.inv(fit @ np.asarray(compound_affine, dtype=np.float64))


def registration_from_point_pairs(source_points, target_points, source_shape_zyx,
                                  target_shape_zyx, source_voxel_size, target_voxel_size,
                                  similarity: bool = False,
                                  pre_affine_90degree_rotation: int = 0,
                                  pre_affine_fliplr: bool = False,
                                  source_points_frame: str = "original") -> np.ndarray:
    """Manual registration from point pairs, headless.

    ``source_points_frame``: ``"original"`` means the source points were
    picked on the raw source volume (e.g. in Fiji) and are composed with
    the compound pre-alignment here; ``"pre_aligned"`` means they were
    picked on the compound-affine overlay, the frame the napari flow
    records (the verb passes this, its option's default).
    """
    compound = manual_compound_affine(source_shape_zyx, target_shape_zyx, source_voxel_size,
                                      target_voxel_size, pre_affine_90degree_rotation,
                                      pre_affine_fliplr)
    src = np.asarray(source_points, dtype=np.float64)
    if source_points_frame == "original":
        hom = np.hstack([src, np.ones((len(src), 1))])
        src = (compound @ hom.T).T[:, :3]
    elif source_points_frame != "pre_aligned":
        raise ValueError(f"unknown source_points_frame {source_points_frame!r}")
    return manual_transform_from_picked_points(src, target_points, compound, similarity)


def _load_points(path) -> np.ndarray:
    """An (N, 3) ZYX points array from a ``.npy`` or CSV/TSV file: headerless
    numbers, or napari's "Save Points layer" export (a header row
    ``index,axis-0,axis-1,axis-2``, skipped, and a leading index column
    0, 1, 2, ..., dropped)."""
    path = Path(path)
    if path.suffix == ".npy":
        pts = np.load(path)
    else:
        delimiter = "," if path.suffix == ".csv" else None
        try:
            pts = np.loadtxt(path, delimiter=delimiter, ndmin=2)
        except ValueError:
            pts = np.loadtxt(path, delimiter=delimiter, skiprows=1, ndmin=2)
    if pts.ndim == 2 and pts.shape[1] == 4 and np.array_equal(pts[:, 0], np.arange(len(pts))):
        pts = pts[:, 1:]  # napari's row-index column
    return pts


def _find_focus_slice(volume, na_det: float, wavelength: float, pixel_size: float,
                      device: torch.device) -> int:
    """In-focus z index over the central ROI, the mid-slice when the metric
    lands on an edge."""
    from biahub_tpu_torch.kernels.focus import focus_from_transverse_band

    z, y, x = volume.shape[-3:]
    roi = volume[:, max(y // 2 - FOCUS_SLICE_ROI_WIDTH, 0): y // 2 + FOCUS_SLICE_ROI_WIDTH,
                 max(x // 2 - FOCUS_SLICE_ROI_WIDTH, 0): x // 2 + FOCUS_SLICE_ROI_WIDTH]
    idx = focus_from_transverse_band(roi, NA_det=na_det, lambda_ill=wavelength,
                                     pixel_size=pixel_size, device=device)
    if idx in (0, z - 1):
        idx = z // 2
        print(f"Could not determine best focus slice, using {idx}")
    else:
        print(f"Best focus slice: {idx}")
    return idx


def user_assisted_registration(source_channel_volume, source_channel_name: str,
                               source_channel_voxel_size, target_channel_volume,
                               target_channel_name: str, target_channel_voxel_size,
                               similarity: bool = False, pre_affine_90degree_rotation: int = 0,
                               pre_affine_fliplr: bool = False,
                               device: str | torch.device = "cuda") -> list:
    """Interactive manual registration in napari: the target volume and the
    pre-aligned source (warped on ``device``), each point layer starting at
    its in-focus slice, alternating click pairs; the fitted transform is
    previewed and returned as ``[matrix.tolist()]``. Without napari this
    raises ``RuntimeError`` (:data:`HEADLESS_MESSAGE`)."""
    try:
        import napari  # type: ignore
    except ImportError:
        raise RuntimeError(HEADLESS_MESSAGE) from None

    from biahub_tpu_torch.register import apply_affine_transform

    dev = resolve_device(device)
    source = as_tensor(source_channel_volume, dev)
    target = as_tensor(target_channel_volume, dev)
    print("Finding source channel focus slice...")
    source_focus_idx = _find_focus_slice(source, NA_DETECTION_SOURCE,
                                         WAVELENGTH_EMISSION_SOURCE_CHANNEL,
                                         source_channel_voxel_size[-1], dev)
    print("Finding target channel focus slice...")
    target_focus_idx = _find_focus_slice(target, NA_DETECTION_TARGET,
                                         WAVELENGTH_EMISSION_TARGET_CHANNEL,
                                         target_channel_voxel_size[-1], dev)
    scaling_factor_z = source_channel_voxel_size[-3] / target_channel_voxel_size[-3]

    compound = manual_compound_affine(tuple(source.shape), tuple(target.shape),
                                      source_channel_voxel_size, target_channel_voxel_size,
                                      pre_affine_90degree_rotation, pre_affine_fliplr)
    # Display overlay: the source warped into the target frame (output ->
    # input matrix = the compound's inverse).
    source_pre_reg = apply_affine_transform(source, np.linalg.inv(compound), target.shape,
                                            device=dev).cpu().numpy()
    target_np = target.cpu().numpy()

    viewer = napari.Viewer()
    viewer.add_image(target_np, name=f"target_{target_channel_name}")
    points_target = viewer.add_points(ndim=3, name=f"pts_target_{target_channel_name}",
                                      size=20, face_color=COLOR_CYCLE[0])
    source_layer = viewer.add_image(source_pre_reg, name=f"source_{source_channel_name}",
                                    blending="additive", colormap="green")
    points_source = viewer.add_points(ndim=3, name=f"pts_source_{source_channel_name}",
                                      size=20, face_color=COLOR_CYCLE[0])
    viewer.layers.selection.active = points_source
    points_source.mode = "add"
    points_target.mode = "add"

    def next_on_click(layer, event):
        """Alternate between the two point layers after each click, jumping
        the z slider to the partner layer's last point (or its focus slice)
        and cycling the pair color."""
        if layer.mode != "add":
            return
        other = points_target if layer is points_source else points_source
        if len(other.data) < 1:
            focus = (target_focus_idx if other is points_target
                     else source_focus_idx * scaling_factor_z)
            next_step = (focus, 0, 0)
        else:
            next_step = (other.data[-1][0], 0, 0)
        layer.add(layer.world_to_data(viewer.cursor.position))
        shift = 0 if layer is points_source else 1
        current = COLOR_CYCLE.index(layer.current_face_color)
        other.current_face_color = COLOR_CYCLE[(current + shift) % len(COLOR_CYCLE)]
        other.mode = "add"
        layer.selected_data = {}
        viewer.layers.selection.active = other
        viewer.dims.current_step = next_step

    viewer.dims.current_step = (source_focus_idx * scaling_factor_z, 0, 0)
    points_source.mouse_drag_callbacks.append(next_on_click)
    points_target.mouse_drag_callbacks.append(next_on_click)

    input("Add at least three points in the two channels by sequentially "
          "clicking on a feature in the source channel and its corresponding "
          "feature in target channel. Select grid mode if you prefer "
          "side-by-side view. Press <enter> when done...")

    tform = manual_transform_from_picked_points(np.asarray(points_source.data),
                                                np.asarray(points_target.data), compound,
                                                similarity=similarity)

    print("\nShowing registered source image in magenta")
    registered = apply_affine_transform(source, tform, target.shape, device=dev).cpu().numpy()
    viewer.add_image(registered, name=f"registered_{source_channel_name}",
                     colormap="magenta", blending="additive")
    viewer.layers.remove(points_source)
    viewer.layers.remove(points_target)
    source_layer.visible = False
    print(f"Estimated affine transformation matrix:\n{tform}\n")
    input("Press <Enter> to close the viewer and exit...")
    viewer.close()
    return [tform.tolist()]


def _manual_transforms(settings: dict, source_tczyx, target_tczyx, source_index: int,
                       target_index: int, source_voxel, target_voxel, source_points,
                       target_points, source_points_frame: str, dev) -> list:
    """The manual method's one transform: from the point pairs when given,
    else clicked in napari on the settings' timepoint."""
    manual = settings["manual_registration_settings"]
    similarity = settings["affine_transform_settings"]["transform_type"] == "similarity"
    rot90, fliplr = manual["affine_90degree_rotation"], manual["affine_fliplr"]
    if source_points is not None or target_points is not None:
        if source_points is None or target_points is None:
            raise CommandError("--source-points and --target-points must be given together")
        return [registration_from_point_pairs(
            source_points, target_points, tuple(source_tczyx.shape[-3:]),
            tuple(target_tczyx.shape[-3:]), source_voxel, target_voxel, similarity,
            rot90, fliplr, source_points_frame).tolist()]
    t_idx = manual["time_index"]
    return user_assisted_registration(
        source_tczyx[t_idx, source_index], settings["source_channel_name"], source_voxel,
        target_tczyx[t_idx, target_index], settings["target_channel_name"], target_voxel,
        similarity, rot90, fliplr, device=dev)


def estimate_registration_arrays(
    source_tczyx,
    target_tczyx,
    source_channel_names: list[str],
    target_channel_names: list[str],
    settings: dict,
    voxel_size,
    source_voxel_size=None,
    registration_target_channel: str | None = None,
    registration_source_channels: list[str] | None = None,
    output_folder_path=None,
    source_points=None,
    target_points=None,
    source_points_frame: str = "pre_aligned",
    device: str | torch.device = "cuda",
) -> dict:
    """Estimate the warp of the source (moving) stack onto the target stack,
    both (T, C, Z, Y, X) numpy or tensors (or a plate's arrays), with an
    ``EstimateRegistrationSettings`` dict -> the output settings as a dict.
    ``voxel_size``: the target's scale (its last three entries are its
    voxel size, and all five the output voxel size); ``source_voxel_size``:
    the source's ZYX voxel size (default the target's). The channels the
    settings file names for ``register`` default to the settings' target
    and source channels (the verb's ``-rt`` and ``-rs``);
    ``output_folder_path`` keeps each timepoint's transform as
    ``xyz_transforms/<t>.npy`` there. The manual method takes (N, 3) ZYX
    ``source_points`` and ``target_points`` (source points picked in
    ``source_points_frame``), or raises ``RuntimeError`` without them where
    napari is missing."""
    dev = resolve_device(device)
    settings = registration_estimate_settings_from_reference(settings)
    method = settings["estimation_method"]
    target_name, source_name = settings["target_channel_name"], settings["source_channel_name"]
    source_index = list(source_channel_names).index(source_name)
    target_index = list(target_channel_names).index(target_name)
    target_voxel = tuple(voxel_size)[-3:]
    source_voxel = target_voxel if source_voxel_size is None else tuple(source_voxel_size)[-3:]
    verbose = settings["verbose"]

    if method == "beads":
        from biahub_tpu_torch.registration.beads import estimate_tczyx

        transforms = estimate_tczyx(
            source_tczyx, target_tczyx, source_index, target_index,
            beads_match_settings=settings["beads_match_settings"],
            affine_transform_settings=settings["affine_transform_settings"], verbose=verbose,
            output_folder_path=output_folder_path, ref_voxel_size=target_voxel,
            mov_voxel_size=source_voxel, device=dev)
    elif method == "ants":
        from biahub_tpu_torch.registration.intensity import estimate_tczyx

        transforms = estimate_tczyx(
            source_tczyx, target_tczyx, source_index, target_index,
            ants_registration_settings=settings["ants_registration_settings"],
            affine_transform_settings=settings["affine_transform_settings"], verbose=verbose,
            output_folder_path=output_folder_path, device=dev)
    else:
        transforms = _manual_transforms(settings, source_tczyx, target_tczyx, source_index,
                                        target_index, source_voxel, target_voxel,
                                        source_points, target_points, source_points_frame, dev)

    evaluation = settings["eval_transform_settings"]
    if len(transforms) == 1:
        if evaluation:
            print("One transform was estimated, no need to evaluate")
        return registration_settings_dump(
            list(registration_source_channels or [source_name]),
            registration_target_channel or target_name, transforms[0])
    if evaluation:
        transforms = evaluate_transforms(
            transforms, tuple(source_tczyx.shape[-3:]),
            validation_window_size=evaluation["validation_window_size"],
            validation_tolerance=evaluation["validation_tolerance"],
            interpolation_window_size=evaluation["interpolation_window_size"],
            interpolation_type=evaluation["interpolation_type"], verbose=verbose)
    return stabilization_settings_dump(target_name, "affine", method, [source_name, target_name],
                                       transforms, voxel_size)


def _channel(path, name: str, dev):
    """The position at ``path``, and its channel ``name`` read once as
    (T, 1, Z, Y, X) on the device."""
    position = open_ome_zarr(path, mode="r")
    index = position.channel_names.index(name)
    return position, as_tensor(position.data[:, index], dev)[:, None]


def estimate_registration(
    source_position_dirpaths: list[Path],
    target_position_dirpaths: list[Path],
    output_filepath: Path,
    config_filepath: Path,
    registration_target_channel: str | None = None,
    registration_source_channel: list[str] = (),
    sbatch_filepath: str | None = None,
    local: bool = False,
    source_points=None,
    target_points=None,
    source_points_frame: str = "pre_aligned",
    device: str | torch.device = "cuda",
) -> None:
    """The estimate-registration verb on plates (module docstring): the
    first source and target positions, the YAML at ``output_filepath``.
    The manual method reads the point files (:func:`_load_points`) and,
    without them, the settings' timepoint for napari; headless, it fails
    with :data:`HEADLESS_MESSAGE` as a
    :class:`~biahub_tpu_torch.cli.parsing.CommandError`."""
    dev = resolve_device(device)
    output_dir = Path(output_filepath).parent
    output_dir.mkdir(parents=True, exist_ok=True)
    settings = yaml_to_model(config_filepath, registration_estimate_settings_from_reference)
    print(f"Settings: {settings}")
    target_name, source_name = settings["target_channel_name"], settings["source_channel_name"]
    print(f"Target channel: {target_name}")
    print(f"Source channel: {source_name}")
    if settings["estimation_method"] == "manual":
        source = open_ome_zarr(source_position_dirpaths[0], mode="r")
        target = open_ome_zarr(target_position_dirpaths[0], mode="r")
        source_data, source_names = source.data, source.channel_names
        target_data, target_names = target.data, target.channel_names
    else:
        source, source_data = _channel(source_position_dirpaths[0], source_name, dev)
        target, target_data = _channel(target_position_dirpaths[0], target_name, dev)
        source_names, target_names = [source_name], [target_name]
    try:
        model = estimate_registration_arrays(
            source_data, target_data, source_names, target_names, settings, target.scale,
            source_voxel_size=source.scale[-3:],
            registration_target_channel=registration_target_channel,
            registration_source_channels=list(registration_source_channel),
            output_folder_path=output_dir,
            source_points=None if source_points is None else _load_points(source_points),
            target_points=None if target_points is None else _load_points(target_points),
            source_points_frame=source_points_frame, device=dev)
    except RuntimeError as exc:
        if str(exc) != HEADLESS_MESSAGE:
            raise
        raise CommandError(str(exc)) from None
    if "affine_transform_zyx_list" in model and settings["verbose"]:
        plot_translations(model["affine_transform_zyx_list"], output_dir / "translation_plots"
                          / f"{settings['estimation_method']}_registration.png")
    model_to_yaml(model, output_filepath)
    print(f"Registration settings saved to {output_dir.resolve()}")
