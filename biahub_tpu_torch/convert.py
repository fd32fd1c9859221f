"""Carry the JAX package's per-acquisition state into the port.

``module_from_reference`` builds :class:`~biahub_tpu_torch.pipeline.
DeconvolveDeskew` from the reference's numpy transfer function and from
settings dicts with the field names of ``biahub_tpu/settings.py``'s
``DeskewSettings`` and ``DeconvolveSettings`` (settings.py:373-451), with
their defaults and their rounding, without pydantic. ``chain_from_reference``
builds :class:`~biahub_tpu_torch.pipeline.DeconvolveDeskewWarp` from a fused
pipeline's settings (``FusePipelineSettings``, settings.py:557-620) as a
plain dict. ``deskew_settings_from_reference`` reads ``DeskewSettings``
into the deskew's arguments, ``flat_field_settings_from_reference``
validates ``FlatFieldCorrectionSettings`` (settings.py:361-364),
``registration_settings_from_reference`` the register verb's
``RegistrationSettings`` (:422-433) and ``fuse_settings_from_reference``
the fused pipeline's ``FusePipelineSettings`` (:593-625) with its stage
checks. ``deconvolve_settings_from_reference`` validates the deconvolve
verb's settings (``DeconvolveSettings``),
``stabilization_settings_from_reference`` estimate-stabilization's
(``EstimateStabilizationSettings``, settings.py:324) and
``registration_estimate_settings_from_reference`` estimate-registration's
(``EstimateRegistrationSettings``, settings.py:299) into plain dicts with
their defaults. ``reconstruction_settings_from_reference``
validates the reconstruction verbs' settings (``ReconstructionSettings``,
recon/settings.py) and ``transfer_functions_from_reference`` carries the
reference's transfer functions into tensors. ``spectral_table_from_reference``
carries the spectral deskew's lerp-DFT table. ``deskew_settings_dump``,
``fuse_settings_dump``, ``stabilize_settings_from_reference`` and
``reconstruction_settings_dump`` give the plate verbs' settings as the
reference's models dump them (the provenance the verbs stamp on their
plates); ``registration_settings_dump`` and ``stabilization_settings_dump``
build the YAML files the estimate verbs write, and
``psf_from_beads_settings_from_reference`` validates estimate-psf's
``PsfFromBeadsSettings``, ``characterize_settings_from_reference``
characterize-psf's ``CharacterizeSettings`` and
``processing_settings_from_reference`` process-with-config's
``ProcessingImportFuncSettings``. ``stitch_settings_from_reference`` and
``concatenate_settings_from_reference`` give ``StitchSettings`` and
``ConcatenateSettings`` as their models dump them: the files the stitch
and concatenate verbs read, and those estimate-stitch and concatenate's
resolve mode write. Settings files are read by
:mod:`biahub_tpu_torch.cli.yaml_reader`.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from biahub_tpu_torch.pipeline import DeconvolveDeskew, DeconvolveDeskewWarp

__all__ = ["module_from_reference", "chain_from_reference",
           "deskew_settings_from_reference", "flat_field_settings_from_reference",
           "registration_settings_from_reference", "fuse_settings_from_reference",
           "stabilization_settings_from_reference", "beads_match_settings_from_reference",
           "affine_transform_settings_from_reference", "deconvolve_settings_from_reference",
           "registration_estimate_settings_from_reference",
           "reconstruction_settings_from_reference", "transfer_functions_from_reference",
           "spectral_table_from_reference", "deskew_settings_dump", "fuse_settings_dump",
           "stabilize_settings_from_reference", "reconstruction_settings_dump",
           "registration_settings_dump", "stabilization_settings_dump",
           "psf_from_beads_settings_from_reference", "stitch_settings_from_reference",
           "concatenate_settings_from_reference", "segmentation_settings_from_reference",
           "tracking_settings_from_reference", "zslicing_from_reference",
           "cellpose_config_from_reference", "characterize_settings_from_reference",
           "processing_settings_from_reference"]

_DESKEW_FIELDS = {
    "pixel_size_um", "ls_angle_deg", "px_to_scan_ratio", "scan_step_um",
    "keep_overhang", "overhang_fill", "average_n_slices", "device",
    "output_ome_zarr_version",
}
_DECONVOLVE_FIELDS = {"regularization_strength", "output_ome_zarr_version"}
# FusePipelineSettings' fields.
_FUSE_FIELDS = {
    "flat_field", "deconvolve", "deskew", "registration", "stabilization",
    "time_indices", "output_shape_zyx", "output_ome_zarr_version",
}


def _unknown(d: dict, fields: set, what: str) -> None:
    extra = set(d) - fields
    if extra:
        raise ValueError(f"{what}: unknown fields {sorted(extra)}")


def deskew_settings_from_reference(deskew: dict) -> dict:
    """The deskew fields the deskew and the chain use, as their keyword
    arguments (``ls_angle_deg``, ``px_to_scan_ratio``, ``keep_overhang``,
    ``average_window``, ``overhang_fill``), validated and defaulted as
    ``DeskewSettings`` does: the angle in [0, 45] rounded to 0.01, the
    ratio rounded to 0.001, and derived as round(pixel_size_um /
    scan_step_um, 3) when absent (settings.py:410-413), the fill ``"mean"``
    or a float. ``pixel_size_um``, ``device`` and ``output_ome_zarr_version``
    are accepted and not used."""
    _unknown(deskew, _DESKEW_FIELDS, "deskew settings")
    angle = float(deskew["ls_angle_deg"])
    if not 0 < angle <= 45:
        raise ValueError("Light sheet angle must be be between 0 and 45 degrees")
    ratio = deskew.get("px_to_scan_ratio")
    if ratio is None:
        if deskew.get("scan_step_um") is None:
            raise ValueError(
                "If px_to_scan_ratio is not provided, both pixel_size_um and "
                "scan_step_um must be provided"
            )
        ratio = deskew["pixel_size_um"] / deskew["scan_step_um"]
    if float(ratio) <= 0:
        raise ValueError("px_to_scan_ratio must be positive")
    fill = deskew.get("overhang_fill", 0.0)
    if isinstance(fill, str) and fill != "mean":
        raise ValueError(f"overhang_fill: want 'mean' or a number, got {fill!r}")
    return {
        "ls_angle_deg": round(angle, 2),
        "px_to_scan_ratio": round(float(ratio), 3),
        "keep_overhang": bool(deskew.get("keep_overhang", False)),
        "average_window": int(deskew.get("average_n_slices", 3)),
        "overhang_fill": fill if isinstance(fill, str) else float(fill),
    }


def _deconvolve_settings(deconvolve: dict) -> float:
    """The regularization strength, default 0.001 as ``DeconvolveSettings``."""
    _unknown(deconvolve, _DECONVOLVE_FIELDS, "deconvolve settings")
    reg = float(deconvolve.get("regularization_strength", 0.001))
    if reg <= 0:
        raise ValueError("regularization_strength must be positive")
    return reg


def deconvolve_settings_from_reference(settings: dict) -> dict:
    """``DeconvolveSettings`` (settings.py:450-452) as a plain dict with its
    defaults: ``regularization_strength`` (positive, 0.001) and
    ``output_ome_zarr_version`` ("0.4", "0.5" or None)."""
    version = settings.get("output_ome_zarr_version")
    if version not in (None, "0.4", "0.5"):
        raise ValueError(f"output_ome_zarr_version: must be '0.4', '0.5' or None, "
                         f"got {version!r}")
    return {"regularization_strength": _deconvolve_settings(settings),
            "output_ome_zarr_version": version}


def module_from_reference(
    tf_half: np.ndarray,
    deskew: dict,
    deconvolve: dict,
    zyx_shape: tuple[int, int, int],
    device: str | torch.device = "cuda",
    skip_flip: bool = False,
) -> DeconvolveDeskew:
    """The port's deconvolve -> deskew module for volumes of ``zyx_shape``,
    from the reference's half transfer function and settings dicts."""
    return DeconvolveDeskew(
        tf_half, tuple(int(s) for s in zyx_shape), _deconvolve_settings(deconvolve),
        skip_flip=skip_flip, device=device, **deskew_settings_from_reference(deskew),
    )


def _matrix(value, name: str) -> np.ndarray:
    m = np.asarray(value, dtype=np.float64)
    if m.shape != (4, 4):
        raise ValueError(f"{name} must be a 4x4 matrix (list of 4 lists of 4 numbers)")
    return m


def _fuse_warp_matrix(fuse: dict, time_index: int) -> np.ndarray:
    """The warp of raw timepoint ``time_index``: ``M_reg @ M_stab[t]``,
    either factor optional, as ``fuse.py:84-114`` composes them (output->
    input maps, so the stabilize map runs first on an output coordinate)."""
    reg, stab = fuse.get("registration"), fuse.get("stabilization")
    if reg is None and stab is None:
        raise ValueError("fuse settings: the warp chain needs a registration "
                         "or a stabilization block")
    m = np.eye(4)
    if reg is not None:
        _unknown(reg, {"affine_transform_zyx"}, "registration settings")
        m = _matrix(reg["affine_transform_zyx"], "affine_transform_zyx")
    if stab is not None:
        _unknown(stab, {"affine_transform_zyx_list"}, "stabilization settings")
        mats = stab["affine_transform_zyx_list"]
        if not isinstance(mats, list) or not mats:
            raise ValueError("affine_transform_zyx_list must be a non-empty list")
        if len(mats) <= time_index:
            raise ValueError(
                f"stabilization.affine_transform_zyx_list has {len(mats)} matrices "
                f"but timepoint {time_index} is processed (one matrix per raw "
                "timepoint, like StabilizationSettings)"
            )
        m = m @ _matrix(mats[time_index], "each element of affine_transform_zyx_list")
    return m


def chain_from_reference(
    tf_half: np.ndarray,
    fuse_settings: dict,
    zyx_shape: tuple[int, int, int],
    time_index: int = 0,
    device: str | torch.device = "cuda",
) -> DeconvolveDeskewWarp:
    """The port's deconvolve -> deskew -> warp module for raw timepoint
    ``time_index`` of volumes of ``zyx_shape``, from the reference's half
    transfer function and a fused pipeline's settings as a dict (its
    ``deconvolve``, ``deskew``, ``registration`` and optional
    ``stabilization`` blocks; ``output_shape_zyx`` when given). A
    ``flat_field`` block is validated and left to the caller: it is a
    per-channel prefix on the raw volume (``fuse.fuse_arrays`` applies it),
    and the module runs the rest of the chain."""
    _unknown(fuse_settings, _FUSE_FIELDS, "fuse settings")
    if fuse_settings.get("flat_field") is not None:
        flat_field_settings_from_reference(fuse_settings["flat_field"])
    for block in ("deconvolve", "deskew"):
        if fuse_settings.get(block) is None:
            raise ValueError(f"fuse settings: the chain needs a {block} block")
    out = fuse_settings.get("output_shape_zyx")
    return DeconvolveDeskewWarp(
        tf_half, tuple(int(s) for s in zyx_shape),
        _deconvolve_settings(fuse_settings["deconvolve"]),
        matrix=_fuse_warp_matrix(fuse_settings, int(time_index)),
        output_shape=None if out is None else tuple(int(s) for s in out),
        device=device, **deskew_settings_from_reference(fuse_settings["deskew"]),
    )


# -- estimate-stabilization settings (settings.py:237-340), without pydantic --

_REQUIRED = object()


def _literal(*choices):
    def check(v, name):
        if v not in choices:
            raise ValueError(f"{name}: must be one of {list(choices)}, got {v!r}")
        return v
    return check


def _typed(kind):
    def check(v, name):
        if not isinstance(v, kind):
            raise ValueError(f"{name}: want {kind.__name__}, got {v!r}")
        return v
    return check


_BOOL_WORDS = {"0": False, "off": False, "f": False, "false": False, "n": False,
               "no": False, "1": True, "on": True, "t": True, "true": True, "y": True,
               "yes": True}


def _lax_bool(v, name):
    """pydantic's lax bool: a bool, 0 or 1, or one of its words."""
    if isinstance(v, bool):
        return v
    if isinstance(v, int) and v in (0, 1):
        return bool(v)
    if isinstance(v, str) and v.lower() in _BOOL_WORDS:
        return _BOOL_WORDS[v.lower()]
    raise ValueError(f"{name}: want bool, got {v!r}")


def _lax_number(kind):
    """pydantic's lax int or float: a number (an int only when integral) or
    a string of one; never a bool."""
    def check(v, name):
        try:
            if isinstance(v, bool):
                raise ValueError
            x = float(v) if isinstance(v, str) else v
            if not isinstance(x, (int, float)) or (kind is int and x != int(x)):
                raise ValueError
            return kind(x)
        except (TypeError, ValueError, OverflowError):
            raise ValueError(f"{name}: want {kind.__name__}, got {v!r}") from None
    return check


def _int_list(v, name):
    if not isinstance(v, list) or not all(
            isinstance(i, int) and not isinstance(i, bool) for i in v):
        raise ValueError(f"{name}: want a list of integers, got {v!r}")
    return list(v)


def _slice_spec(v, name):
    if v != "all" and not isinstance(v, list):
        raise ValueError(f"{name}: must be 'all' or a list, got {v!r}")
    return v


def _matrix_4x4(v, name):
    if not isinstance(v, list):
        raise ValueError(f"{name}: must be a list")
    _matrix(v, name)
    return v


def _optional(check):
    return lambda v, name: None if v is None else check(v, name)


def _model(schema, forbid: bool = True):
    """A checker of a settings block: unknown fields raise (are dropped
    with ``forbid=False``, as a plain pydantic ``BaseModel`` drops them),
    absent ones take their defaults (a callable default is a factory)."""
    def check(d, name):
        if not isinstance(d, dict):
            raise ValueError(f"{name}: want a mapping, got {d!r}")
        if forbid:
            _unknown(d, set(schema), name)
        out = {}
        for field, (default, check_field) in schema.items():
            if field in d:
                out[field] = check_field(d[field], f"{name}.{field}")
            elif default is _REQUIRED:
                raise ValueError(f"{name}: field {field!r} is required")
            else:
                out[field] = default() if callable(default) else default
        return out
    return check


_T_REFERENCE = ("first", _literal("first", "previous"))
_SKIP_BEADS = ("0", _typed(str))
_SLICE = ("all", _slice_spec)
_PHASE_CROSS_CORR = _model({
    "normalization": (None, _literal("magnitude", "classic", None)),
    "maximum_shift": (1.2, _lax_number(float)),
    "function_type": ("custom", _literal("custom_padding", "custom")),
    "t_reference": _T_REFERENCE,
    "skip_beads_fov": _SKIP_BEADS,
    "center_crop_xy": (None, _optional(_int_list)),
    "X_slice": _SLICE,
    "Y_slice": _SLICE,
    "Z_slice": _SLICE,
})
_FOCUS_FINDING = _model({
    "average_across_wells": (False, _lax_bool),
    "average_across_wells_method": ("mean", _literal("mean", "median")),
    "skip_beads_fov": _SKIP_BEADS,
    "center_crop_xy": (lambda: [800, 800], _int_list),
})
_STACK_REG = _model({
    "center_crop_xy": (lambda: [800, 800], _int_list),
    "skip_beads_fov": _SKIP_BEADS,
    "focus_finding_settings": (lambda: _FOCUS_FINDING({}, "focus_finding_settings"),
                               _optional(_FOCUS_FINDING)),
    "t_reference": _T_REFERENCE,
})
_EVAL_TRANSFORM = _model({
    "validation_window_size": (10, _lax_number(int)),
    "validation_tolerance": (1000.0, _lax_number(float)),
    "interpolation_window_size": (3, _lax_number(int)),
    "interpolation_type": ("linear", _literal("linear", "cubic")),
})
_AFFINE_TRANSFORM = _model({
    "t_reference": _T_REFERENCE,
    "transform_type": ("euclidean", _literal("euclidean", "similarity", "affine")),
    "approx_transform": (lambda: np.eye(4).tolist(), _optional(_matrix_4x4)),
    "use_prev_t_transform": (True, _lax_bool),
    "compute_approx_transform": (False, _lax_bool),
})
_DETECT_PEAKS = _model({
    "threshold_abs": (110, _lax_number(float)),
    "nms_distance": (16, _lax_number(int)),
    "min_distance": (0, _lax_number(int)),
    "block_size": (lambda: [8, 8, 8], _int_list),
})
_EDGE_GRAPH_METHODS = _literal("knn", "radius", "full")


def _edge_graph(d, name):
    """``EdgeGraphSettings``: a plain pydantic model (unknown fields are
    dropped, not refused), with the method's defaults applied and the other
    methods' fields cleared."""
    if not isinstance(d, dict):
        raise ValueError(f"{name}: want a mapping, got {d!r}")
    method = _EDGE_GRAPH_METHODS(d.get("method", "knn"), f"{name}.method")
    k = _optional(_lax_number(int))(d.get("k"), f"{name}.k")
    radius = _optional(_lax_number(float))(d.get("radius"), f"{name}.radius")
    if method == "knn":
        return {"method": method, "k": 5 if k is None else k, "radius": None}
    if method == "radius":
        return {"method": method, "k": None, "radius": 30.0 if radius is None else radius}
    return {"method": method, "k": None, "radius": None}


def _weights(v, name):
    if not isinstance(v, dict) or not all(isinstance(k, str) for k in v):
        raise ValueError(f"{name}: want a mapping of names to numbers, got {v!r}")
    return {k: _lax_number(float)(w, f"{name}.{k}") for k, w in v.items()}


_METRIC = ("euclidean", _literal("euclidean", "cosine", "cityblock"))
_COST_MATRIX = _model({
    "weights": (lambda: {"dist": 0.5, "edge_angle": 1.0, "edge_length": 1.0,
                         "pca_dir": 0.0, "pca_aniso": 0.0, "edge_descriptor": 0.0},
                _weights),
    "normalize": (False, _lax_bool),
})
_HUNGARIAN_MATCH = _model({
    "distance_metric": _METRIC,
    "cost_threshold": (0.10, _lax_number(float)),
    "max_ratio": (0.8, _lax_number(float)),
    "cross_check": (False, _lax_bool),
    "edge_graph_settings": (lambda: _edge_graph({}, "edge_graph_settings"), _edge_graph),
    "cost_matrix_settings": (lambda: _COST_MATRIX({}, "cost_matrix_settings"),
                             _COST_MATRIX),
})
_MATCH_DESCRIPTOR = _model({
    "distance_metric": _METRIC,
    "max_ratio": (0.8, _lax_number(float)),
    "cross_check": (False, _lax_bool),
})
_FILTER_MATCHES = _model({
    "angle_threshold": (0, _lax_number(float)),
    "direction_threshold": (0, _lax_number(float)),
    "min_distance_quantile": (0.01, _lax_number(float)),
    "max_distance_quantile": (0.95, _lax_number(float)),
})
_QC_BEADS = _model({
    "iterations": (2, _lax_number(int)),
    "score_threshold": (0.40, _lax_number(float)),
    "score_centroid_mask_radius": (6, _lax_number(int)),
})
_BEADS_MATCH = _model({
    "algorithm": ("hungarian", _literal("hungarian", "match_descriptor")),
    "source_peaks_settings": (lambda: _DETECT_PEAKS({}, "source_peaks_settings"),
                              _optional(_DETECT_PEAKS)),
    "target_peaks_settings": (lambda: _DETECT_PEAKS({}, "target_peaks_settings"),
                              _optional(_DETECT_PEAKS)),
    "match_descriptor_settings": (lambda: _MATCH_DESCRIPTOR({}, "match_descriptor_settings"),
                                  _MATCH_DESCRIPTOR),
    "hungarian_match_settings": (lambda: _HUNGARIAN_MATCH({}, "hungarian_match_settings"),
                                 _HUNGARIAN_MATCH),
    "filter_matches_settings": (lambda: _FILTER_MATCHES({}, "filter_matches_settings"),
                                _FILTER_MATCHES),
    "qc_settings": (lambda: _QC_BEADS({}, "qc_settings"), _QC_BEADS),
})


def beads_match_settings_from_reference(settings: dict | None = None) -> dict:
    """``BeadsMatchSettings`` (settings.py:150-234) as a plain dict,
    validated and defaulted as the model and its nested models do; reads
    back unchanged."""
    return _BEADS_MATCH(settings or {}, "beads_match_settings")


def affine_transform_settings_from_reference(settings: dict | None = None) -> dict:
    """``AffineTransformSettings`` (settings.py:274-286) as a plain dict."""
    return _AFFINE_TRANSFORM(settings or {}, "affine_transform_settings")


_ESTIMATE_STABILIZATION = _model({
    "stabilization_estimation_channel": (_REQUIRED, _typed(str)),
    "stabilization_channels": (_REQUIRED, _typed(list)),
    "stabilization_type": (_REQUIRED, _literal("z", "xy", "xyz")),
    "stabilization_method": ("focus-finding",
                             _literal("beads", "phase-cross-corr", "focus-finding")),
    "beads_match_settings": (None, _optional(_BEADS_MATCH)),
    "phase_cross_corr_settings": (None, _optional(_PHASE_CROSS_CORR)),
    "stack_reg_settings": (None, _optional(_STACK_REG)),
    "focus_finding_settings": (None, _optional(_FOCUS_FINDING)),
    "affine_transform_settings": (lambda: _AFFINE_TRANSFORM({}, "affine_transform_settings"),
                                  _AFFINE_TRANSFORM),
    "eval_transform_settings": (None, _optional(_EVAL_TRANSFORM)),
    "verbose": (False, _lax_bool),
})


def stabilization_settings_from_reference(settings: dict) -> dict:
    """estimate-stabilization's settings as a plain dict, validated and
    defaulted as ``EstimateStabilizationSettings`` and its nested
    ``PhaseCrossCorrSettings``, ``FocusFindingSettings``,
    ``StackRegSettings``, ``EvalTransformSettings``,
    ``AffineTransformSettings`` and ``BeadsMatchSettings`` with its nested
    models do (settings.py:150-340): literals checked, unknown fields
    refused, and the method's settings block created with its defaults when
    absent. The result has the layout of the reference model's
    ``model_dump()`` and reads back unchanged."""
    out = _ESTIMATE_STABILIZATION(settings, "estimate-stabilization settings")
    method, kind = out["stabilization_method"], out["stabilization_type"]
    if method == "beads" and out["beads_match_settings"] is None:
        out["beads_match_settings"] = beads_match_settings_from_reference()
    elif method == "phase-cross-corr" and out["phase_cross_corr_settings"] is None:
        out["phase_cross_corr_settings"] = _PHASE_CROSS_CORR({}, "phase_cross_corr_settings")
    elif method == "focus-finding":
        if kind in ("z", "xyz") and out["focus_finding_settings"] is None:
            out["focus_finding_settings"] = _FOCUS_FINDING({}, "focus_finding_settings")
        if kind in ("xy", "xyz") and out["stack_reg_settings"] is None:
            out["stack_reg_settings"] = _STACK_REG({}, "stack_reg_settings")
    return out


_ANTS_REGISTRATION = _model({"sobel_filter": (False, _lax_bool)})
_MANUAL_REGISTRATION = _model({
    "time_index": (0, _lax_number(int)),
    "affine_90degree_rotation": (0, _lax_number(int)),
    "affine_fliplr": (False, _lax_bool),
})
_ESTIMATE_REGISTRATION = _model({
    "target_channel_name": (_REQUIRED, _typed(str)),
    "source_channel_name": (_REQUIRED, _typed(str)),
    "estimation_method": ("manual", _literal("manual", "beads", "ants")),
    "beads_match_settings": (None, _optional(_BEADS_MATCH)),
    "focus_finding_settings": (None, _optional(_FOCUS_FINDING)),
    "affine_transform_settings": (lambda: _AFFINE_TRANSFORM({}, "affine_transform_settings"),
                                  _AFFINE_TRANSFORM),
    "eval_transform_settings": (None, _optional(_EVAL_TRANSFORM)),
    "ants_registration_settings": (None, _optional(_ANTS_REGISTRATION)),
    "manual_registration_settings": (None, _optional(_MANUAL_REGISTRATION)),
    "verbose": (False, _lax_bool),
})


def registration_estimate_settings_from_reference(settings: dict) -> dict:
    """estimate-registration's settings as a plain dict, validated and
    defaulted as ``EstimateRegistrationSettings`` and its nested models do
    (settings.py:150-321): unknown fields refused, ``approx_transform`` a
    4x4, and the method's settings block (``manual_registration_settings``,
    ``beads_match_settings`` or ``ants_registration_settings``) created with
    its defaults when absent. The result has the layout of the reference
    model's ``model_dump()`` and reads back unchanged."""
    out = _ESTIMATE_REGISTRATION(settings, "estimate-registration settings")
    block = {"manual": ("manual_registration_settings", _MANUAL_REGISTRATION),
             "beads": ("beads_match_settings", _BEADS_MATCH),
             "ants": ("ants_registration_settings", _ANTS_REGISTRATION)}
    name, model = block[out["estimation_method"]]
    if out[name] is None:
        out[name] = model({}, name)
    return out


# -- reconstruction settings (recon/settings.py), without pydantic ----------

def _bounded(kind, ok, what):
    """pydantic's lax ``kind`` with a constraint (PositiveFloat,
    NonNegativeInt)."""
    number = _lax_number(kind)

    def check(v, name):
        x = number(v, name)
        if not ok(x):
            raise ValueError(f"{name}: must be {what}, got {v!r}")
        return x
    return check


_POSITIVE = _bounded(float, lambda x: x > 0, "greater than 0")
_NON_NEGATIVE_INT = _bounded(int, lambda x: x >= 0, "greater than or equal to 0")


def _str_list(v, name):
    if not isinstance(v, (list, tuple)) or not all(isinstance(s, str) for s in v):
        raise ValueError(f"{name}: want a list of strings, got {v!r}")
    return list(v)


def _time_indices(v, name):
    """``int | list[int] | Literal["all"]``, as pydantic's smart union
    reads it."""
    if isinstance(v, str) and v == "all":
        return v
    if isinstance(v, (list, tuple)):
        return [_lax_number(int)(i, f"{name}[{k}]") for k, i in enumerate(v)]
    return _lax_number(int)(v, name)


def _dimension(v, name):
    """``Literal[2, 3]``: an int or an integral float, never a bool or a
    string."""
    if isinstance(v, bool) or not isinstance(v, (int, float)) or v not in (2, 3):
        raise ValueError(f"{name}: must be 2 or 3, got {v!r}")
    return int(v)


def _block(transfer_function, apply_inverse):
    """A modality: its transfer_function and apply_inverse blocks, each
    created with its defaults when absent."""
    return _model({
        "transfer_function": (lambda: transfer_function({}, "transfer_function"),
                              transfer_function),
        "apply_inverse": (lambda: apply_inverse({}, "apply_inverse"), apply_inverse),
    })


_INVERSE = _model({
    "reconstruction_algorithm": ("Tikhonov", _literal("Tikhonov", "TV")),
    "regularization_strength": (0.001, _POSITIVE),
    "TV_rho_strength": (0.001, _POSITIVE),
    "TV_iterations": (1, _NON_NEGATIVE_INT),
})
_OPTICS = {
    "yx_pixel_size": (0.325, _POSITIVE),
    "z_pixel_size": (2.0, _POSITIVE),
    "z_padding": (0, _NON_NEGATIVE_INT),
    "index_of_refraction_media": (1.3, _POSITIVE),
    "numerical_aperture_detection": (1.2, _POSITIVE),
}
_BIREFRINGENCE = _block(
    _model({"swing": (0.1, _lax_number(float))}),
    _model({
        "wavelength_illumination": (0.532, _POSITIVE),
        "background_path": ("", _typed(str)),
        "remove_estimated_background": (False, _lax_bool),
        "flip_orientation": (False, _lax_bool),
        "rotate_orientation": (False, _lax_bool),
    }))
_PHASE = _block(
    _model({
        "wavelength_illumination": (0.532, _POSITIVE), **_OPTICS,
        "numerical_aperture_illumination": (0.52, _POSITIVE),
        "invert_phase_contrast": (False, _lax_bool),
    }),
    _INVERSE)
_FLUORESCENCE = _block(
    _model({"wavelength_emission": (0.507, _POSITIVE), **_OPTICS}), _INVERSE)
_RECONSTRUCTION = _model({
    "input_channel_names": (lambda: ["BF"], _str_list),
    "time_indices": ("all", _time_indices),
    "reconstruction_dimension": (3, _dimension),
    "birefringence": (None, _optional(_BIREFRINGENCE)),
    "phase": (None, _optional(_PHASE)),
    "fluorescence": (None, _optional(_FLUORESCENCE)),
})


def reconstruction_settings_from_reference(settings: dict) -> dict:
    """compute-tf's, apply-inv-tf's and reconstruct's settings as a plain
    dict, validated and defaulted as ``ReconstructionSettings`` and its
    nested models do (recon/settings.py:19-114): unknown fields refused,
    literals, positive floats and non-negative ints checked, and each given
    modality's ``transfer_function`` and ``apply_inverse`` blocks created
    with their defaults when absent. The result has the layout of the
    reference model's ``model_dump()`` and reads back unchanged. The
    ``z_padding``, ``TV_*``, ``background_path`` and
    ``remove_estimated_background`` fields and ``reconstruction_algorithm:
    TV`` are accepted and, as in the reference, not used."""
    return _RECONSTRUCTION(settings, "reconstruction settings")


def transfer_functions_from_reference(tfs: dict) -> dict[str, torch.Tensor]:
    """The reference's transfer functions (``{"phase": H, "fluorescence":
    otf}``, numpy complex (Z, Y, X) arrays, as apply-inv-tf's
    ``_load_transfer_functions`` returns them) as complex64 CPU tensors,
    the form :func:`~biahub_tpu_torch.compute_transfer_function.
    compute_transfer_function_arrays` returns."""
    _unknown(tfs, {"phase", "fluorescence"}, "transfer functions")
    out = {}
    for name, tf in tfs.items():
        arr = np.asarray(tf)
        if arr.ndim != 3:
            raise ValueError(f"transfer function {name!r}: want a (Z, Y, X) array, "
                             f"got shape {arr.shape}")
        out[name] = torch.from_numpy(arr.astype(np.complex64))
    return out


def spectral_table_from_reference(mr, mi, groups: int, average_window: int) -> torch.Tensor:
    """The reference's ``PreparedSpectralDeskew`` (``mr``, ``mi``: (rows,
    X_out, Z) float32 real and imaginary parts, rows = groups * avg, or the
    xzy layout's group count padded to 8 times avg, whose extra rows are
    zero) as the port's (groups * avg, X_out, Z) complex64 CPU table, the
    form :func:`~biahub_tpu_torch.kernels.spectral.prepare_spectral_deskew`
    returns: the xzy pad rows dropped."""
    mr, mi = np.asarray(mr), np.asarray(mi)
    rows = int(groups) * int(average_window)
    if mr.shape != mi.shape or mr.ndim != 3 or mr.shape[0] < rows:
        raise ValueError(f"spectral table: want two (>= {rows}, X_out, Z) arrays, got "
                         f"{mr.shape} and {mi.shape}")
    return torch.complex(torch.from_numpy(np.ascontiguousarray(mr[:rows], np.float32)),
                         torch.from_numpy(np.ascontiguousarray(mi[:rows], np.float32)))


# -- flat-field, register and fused pipeline settings (settings.py:361-625) --

def _version(v, name):
    if v not in (None, "0.4", "0.5"):
        raise ValueError(f"{name}: must be '0.4', '0.5' or None, got {v!r}")
    return v


def _non_negative_time_indices(v, name):
    """``NonNegativeInt | list[NonNegativeInt] | Literal["all"]``."""
    out = _time_indices(v, name)
    if out != "all" and min(out if isinstance(out, list) else [out], default=0) < 0:
        raise ValueError(f"{name}: time indices must be non-negative, got {v!r}")
    return out


def _matrix_rows(v, name):
    """``RegistrationSettings``' check: a list of 4 rows, each a list of 4."""
    if not isinstance(v, list) or len(v) != 4:
        raise ValueError(f"{name} must be a 4x4 matrix as a list of rows")
    for row in v:
        if not isinstance(row, list) or len(row) != 4:
            raise ValueError(f"Each row of {name} must have 4 entries")
    return _matrix_4x4(v, name)


def _matrix_list(v, name):
    """``FuseStabilizeSettings``' check: a non-empty list of 4x4 matrices."""
    if not isinstance(v, list) or not v:
        raise ValueError(f"{name} must be a non-empty list")
    for m in v:
        _matrix(m, "each element of affine_transform_zyx_list")
    return v


_FLAT_FIELD = _model({
    "channel_names": (None, _optional(_str_list)),
    "output_ome_zarr_version": (None, _version),
})
_REGISTRATION = _model({
    "source_channel_names": (_REQUIRED, _str_list),
    "target_channel_name": (_REQUIRED, _typed(str)),
    "affine_transform_zyx": (_REQUIRED, _matrix_rows),
    "keep_overhang": (False, _lax_bool),
    "interpolation": ("linear", _typed(str)),
    "time_indices": ("all", _non_negative_time_indices),
    "verbose": (False, _lax_bool),
    "output_ome_zarr_version": (None, _version),
})


def flat_field_settings_from_reference(settings: dict | None = None) -> dict:
    """``FlatFieldCorrectionSettings`` (settings.py:361-364) as a plain dict:
    ``channel_names`` (a list of names, or None for every channel) and
    ``output_ome_zarr_version``."""
    return _FLAT_FIELD(settings or {}, "flat-field settings")


def registration_settings_from_reference(settings: dict) -> dict:
    """``RegistrationSettings`` (settings.py:422-433) as a plain dict:
    ``source_channel_names``, ``target_channel_name``,
    ``affine_transform_zyx`` (a 4x4 list of rows), ``keep_overhang``
    (False), ``interpolation`` ("linear"), ``time_indices`` ("all"),
    ``verbose`` and ``output_ome_zarr_version``."""
    return _REGISTRATION(settings, "registration settings")


def fuse_settings_from_reference(settings: dict) -> dict:
    """``FusePipelineSettings`` (settings.py:593-625) as a plain dict, its
    stage blocks validated: ``flat_field`` (:func:`flat_field_settings_from_
    reference`), ``deconvolve`` (:func:`deconvolve_settings_from_reference`),
    ``deskew`` (:func:`deskew_settings_from_reference`: the deskew's keyword
    arguments), ``registration`` (``{"affine_transform_zyx": 4x4}``) and
    ``stabilization`` (``{"affine_transform_zyx_list": [4x4, ...]}``), each
    None when absent; ``time_indices`` ("all"), ``output_shape_zyx`` (None,
    or 3 non-negative ints) and ``output_ome_zarr_version``. As the model's
    check: at least one stage, and ``output_shape_zyx`` only with a warp
    stage."""
    if not isinstance(settings, dict):
        raise ValueError(f"fuse settings: want a mapping, got {settings!r}")
    _unknown(settings, _FUSE_FIELDS, "fuse settings")
    out = {name: None for name in ("flat_field", "deconvolve", "deskew", "registration",
                                   "stabilization")}
    if settings.get("flat_field") is not None:
        out["flat_field"] = flat_field_settings_from_reference(settings["flat_field"])
    if settings.get("deconvolve") is not None:
        out["deconvolve"] = deconvolve_settings_from_reference(settings["deconvolve"])
    if settings.get("deskew") is not None:
        out["deskew"] = deskew_settings_from_reference(settings["deskew"])
    reg, stab = settings.get("registration"), settings.get("stabilization")
    if reg is not None:
        out["registration"] = _model({"affine_transform_zyx": (_REQUIRED, _matrix_4x4)})(
            reg, "registration settings")
    if stab is not None:
        out["stabilization"] = _model({
            "affine_transform_zyx_list": (_REQUIRED, _matrix_list)})(
            stab, "stabilization settings")
    out["time_indices"] = _non_negative_time_indices(settings.get("time_indices", "all"),
                                                     "time_indices")
    shape = settings.get("output_shape_zyx")
    if shape is not None:
        shape = [_bounded(int, lambda x: x >= 0, "greater than or equal to 0")(
            s, "output_shape_zyx") for s in _typed(list)(shape, "output_shape_zyx")]
    out["output_shape_zyx"] = shape
    out["output_ome_zarr_version"] = _version(settings.get("output_ome_zarr_version"),
                                              "output_ome_zarr_version")
    if not any(out[name] is not None for name in ("flat_field", "deconvolve", "deskew",
                                                  "registration", "stabilization")):
        raise ValueError(
            "FusePipelineSettings needs at least one stage (flat_field / "
            "deconvolve / deskew / registration / stabilization)"
        )
    if shape is not None and len(shape) != 3:
        raise ValueError("output_shape_zyx must have 3 entries (Z, Y, X)")
    if shape is not None and reg is None and stab is None:
        raise ValueError(
            "output_shape_zyx only applies to the warp stage — add a "
            "registration or stabilization block, or drop it"
        )
    return out


# -- the settings as the reference's models dump them (the provenance
# attributes the verbs write to their output plates) ------------------------

def deskew_settings_dump(deskew: dict) -> dict:
    """``DeskewSettings(**deskew).model_dump()`` (settings.py:373-413):
    every field, validated as :func:`deskew_settings_from_reference` does,
    the angle and ratio rounded, the ratio derived where absent."""
    kw = deskew_settings_from_reference(deskew)
    if deskew.get("pixel_size_um") is None:
        raise ValueError("deskew settings: field 'pixel_size_um' is required")
    scan = deskew.get("scan_step_um")
    return {
        "pixel_size_um": _POSITIVE(deskew["pixel_size_um"], "pixel_size_um"),
        "ls_angle_deg": kw["ls_angle_deg"],
        "px_to_scan_ratio": kw["px_to_scan_ratio"],
        "scan_step_um": None if scan is None else _POSITIVE(scan, "scan_step_um"),
        "keep_overhang": kw["keep_overhang"],
        "overhang_fill": kw["overhang_fill"],
        "average_n_slices": kw["average_window"],
        "device": _typed(str)(deskew.get("device", "cpu"), "device"),
        "output_ome_zarr_version": _version(deskew.get("output_ome_zarr_version"),
                                            "output_ome_zarr_version"),
    }


def fuse_settings_dump(settings: dict) -> dict:
    """``FusePipelineSettings(**settings).model_dump()``: the stage blocks
    of :func:`fuse_settings_from_reference`, the deskew block as
    :func:`deskew_settings_dump`."""
    out = fuse_settings_from_reference(settings)
    if out["deskew"] is not None:
        out["deskew"] = deskew_settings_dump(settings["deskew"])
    return out


_STABILIZATION = _model({
    "stabilization_estimation_channel": (_REQUIRED, _typed(str)),
    "stabilization_type": (_REQUIRED, _literal("z", "xy", "xyz", "affine")),
    "stabilization_method": ("focus-finding", _literal("beads", "phase-cross-corr",
                                                       "focus-finding", "manual", "ants")),
    "stabilization_channels": (_REQUIRED, _typed(list)),
    "affine_transform_zyx_list": (_REQUIRED, lambda v, name: (
        _typed(list)(v, name), [_matrix(m, "each element of affine_transform_zyx_list")
                                for m in v])[0]),
    "time_indices": ("all", _non_negative_time_indices),
    "output_voxel_size": (lambda: [1.0] * 5, lambda v, name: [
        _POSITIVE(s, name) for s in _typed(list)(v, name)]),
    "output_ome_zarr_version": (None, _version),
})


def stabilize_settings_from_reference(settings: dict) -> dict:
    """The stabilize verb's ``StabilizationSettings`` (settings.py:515-535)
    as its ``model_dump()``: the transforms one 4x4 per timepoint,
    ``time_indices`` ("all"), ``output_voxel_size`` (five ones)."""
    return _STABILIZATION(settings, "stabilization settings")


def reconstruction_settings_dump(settings: dict) -> dict:
    """``ReconstructionSettings(**settings).model_dump()``: the
    ``biahub-compute-tf`` and ``biahub-reconstruct`` attributes (the reader
    :func:`reconstruction_settings_from_reference` gives that layout)."""
    return reconstruction_settings_from_reference(settings)


def registration_settings_dump(source_channel_names: list, target_channel_name: str,
                               affine_transform_zyx: list, **fields) -> dict:
    """``RegistrationSettings(...).model_dump()`` (settings.py:422-433): the
    file estimate-registration writes for one transform and
    optimize-registration for its refined one; ``fields`` the model's other
    fields (``keep_overhang``, ``time_indices``, ...)."""
    return registration_settings_from_reference(dict(
        source_channel_names=source_channel_names, target_channel_name=target_channel_name,
        affine_transform_zyx=affine_transform_zyx, **fields))


def stabilization_settings_dump(stabilization_estimation_channel: str, stabilization_type: str,
                                stabilization_method: str, stabilization_channels: list,
                                affine_transform_zyx_list: list, output_voxel_size) -> dict:
    """``StabilizationSettings(...).model_dump()`` (settings.py:515-535) with
    ``time_indices="all"``, as estimate-stabilization's ``_model()`` and
    estimate-registration (several transforms) build it: the files
    ``stabilize`` reads."""
    return stabilize_settings_from_reference(dict(
        stabilization_estimation_channel=stabilization_estimation_channel,
        stabilization_type=stabilization_type, stabilization_method=stabilization_method,
        stabilization_channels=list(stabilization_channels),
        affine_transform_zyx_list=affine_transform_zyx_list, time_indices="all",
        output_voxel_size=list(output_voxel_size)))


_PSF_FROM_BEADS = _model({
    f"axis{i}_patch_size": (101, _bounded(int, lambda x: x > 0, "greater than 0"))
    for i in range(3)
})


def psf_from_beads_settings_from_reference(settings: dict | None = None) -> dict:
    """``PsfFromBeadsSettings`` (settings.py:444-447) as its ``model_dump()``:
    ``axis{0,1,2}_patch_size``, positive ints, 101 by default; unknown
    fields raise."""
    return _PSF_FROM_BEADS(settings or {}, "estimate-psf settings")


# -- stitch and concatenate settings (settings.py:480-530, 636-651) ---------

def _translation_table(v, name):
    """``dict[str, list[float]]`` as pydantic's lax mode reads it; a (y, x)
    entry gets a leading z = 0, as ``StitchSettings.__init__`` adds it."""
    if not isinstance(v, dict):
        raise ValueError(f"{name}: want a mapping of position to translation, got {v!r}")
    out = {}
    for key, value in v.items():
        if not isinstance(key, str) or not isinstance(value, list):
            raise ValueError(f"{name}: want position: [z, y, x], got {key!r}: {value!r}")
        if len(value) == 2:
            value = [0] + value
        out[key] = [_lax_number(float)(x, f"{name}.{key}") for x in value]
    return out


def _affine_table(v, name):
    if not isinstance(v, dict) or not all(
            isinstance(k, str) and isinstance(m, list) for k, m in v.items()):
        raise ValueError(f"{name}: want a mapping of position to a list, got {v!r}")
    return dict(v)


def stitch_settings_from_reference(settings: dict) -> dict:
    """``StitchSettings`` (settings.py:636-651) as its ``model_dump()``:
    ``channels`` (None: every channel), ``total_translation`` ({position:
    [z, y, x]} floats; a (y, x) entry gets a leading z = 0),
    ``affine_transform`` and ``output_ome_zarr_version``. As the model (a
    plain ``BaseModel``), unknown fields are dropped; without a translation
    table or an affine one it raises "Either affine_transform or
    total_translation must be provided"."""
    if not isinstance(settings, dict):
        raise ValueError(f"stitch settings: want a mapping, got {settings!r}")
    if not any((settings.get("total_translation"), settings.get("affine_transform"))):
        raise ValueError("Either affine_transform or total_translation must be provided")
    channels = settings.get("channels")
    translation, affine = settings.get("total_translation"), settings.get("affine_transform")
    return {
        "channels": None if channels is None else _str_list(channels, "channels"),
        "total_translation": None if translation is None else _translation_table(
            translation, "total_translation"),
        "affine_transform": None if affine is None else _affine_table(affine,
                                                                      "affine_transform"),
        "output_ome_zarr_version": _version(settings.get("output_ome_zarr_version"),
                                            "output_ome_zarr_version"),
    }


def _slice_pair(pair) -> None:
    if not (isinstance(pair, list) and len(pair) == 2 and all(_is_int(i) for i in pair)):
        raise ValueError("Each slice item must be 'all' or a list of two non-negative "
                         "integers [start, end].")
    if not all(i >= 0 for i in pair):
        raise ValueError("Slice indices must be non-negative integers.")


def _is_int(v) -> bool:
    return isinstance(v, int) and not isinstance(v, bool)


def _is_pair(v) -> bool:
    return isinstance(v, list) and len(v) == 2 and all(_is_int(i) for i in v)


def _concat_slice(v, name):
    """``SliceSpec`` and ``_validate_slice_spec`` (settings.py:87-134):
    "all", [start, end], or one such item (or a list of them) per path."""
    if v == "all":
        return v
    if not isinstance(v, list):
        raise ValueError("Slice must be 'all' or a list.")
    if _is_pair(v):
        _slice_pair(v)
        return v
    for item in v:
        if item == "all":
            continue
        if _is_pair(item):
            _slice_pair(item)
        elif isinstance(item, list):
            for sub in item:
                if sub != "all":
                    _slice_pair(sub)
        else:
            raise ValueError("Each item in a per-path slice list must be 'all' or a valid "
                             "slice specification.")
    return v


def _concat_paths(v, name):
    if not isinstance(v, list) or not all(isinstance(p, str) for p in v):
        raise ValueError("concat_data_paths must be a list of positions.")
    return list(v)


def _concat_channels(v, name):
    if not isinstance(v, list) or not all(
            isinstance(n, str) or (isinstance(n, list) and all(isinstance(s, str) for s in n))
            for n in v):
        raise ValueError("channel_names must be a list of strings or lists of strings.")
    return list(v)


def _chunks_czyx(v, name):
    if v is not None and (not isinstance(v, list) or len(v) != 4
                          or not all(_is_int(i) for i in v)):
        raise ValueError("chunks_czyx must be a list of 4 integers (C, Z, Y, X)")
    return v


_CONCATENATE = _model({
    "concat_data_paths": (_REQUIRED, _concat_paths),
    "time_indices": ("all", _time_indices),
    "channel_names": (_REQUIRED, _concat_channels),
    "X_slice": ("all", _concat_slice),
    "Y_slice": ("all", _concat_slice),
    "Z_slice": ("all", _concat_slice),
    "chunks_czyx": (None, _chunks_czyx),
    "shards_ratio": (None, _optional(_int_list)),
    "ensure_unique_positions": (False, _optional(_lax_bool)),
    "output_ome_zarr_version": ("0.5", _version),
})


def concatenate_settings_from_reference(settings: dict) -> dict:
    """``ConcatenateSettings`` (settings.py:480-530) as its ``model_dump()``,
    in its field order, with its checks and their messages as
    ``ValueError``: ``concat_data_paths`` (a list of position paths or
    globs), ``time_indices`` ("all"), ``channel_names`` (per path "all" or a
    list of names), ``X_slice`` / ``Y_slice`` / ``Z_slice`` ("all", [start,
    end] or one per path), ``chunks_czyx`` (None or 4 ints),
    ``shards_ratio`` (None, or one ratio an axis: sharded OME-Zarr 0.5 arrays),
    ``ensure_unique_positions`` (False) and ``output_ome_zarr_version``
    ("0.5": concatenate writes OME-Zarr 0.5 unless asked otherwise)."""
    out = _CONCATENATE(settings, "concatenate settings")
    n = len(out["concat_data_paths"])
    for name in ("X_slice", "Y_slice", "Z_slice"):
        spec = out[name]
        if n and isinstance(spec, list) and not _is_pair(spec) and len(spec) != n:
            raise ValueError(
                f"{name} must be 'all', a single slice specification, or a list with the "
                f"same length as concat_data_paths ({n})")
    return out


# -- segment and track settings (settings.py:659-799) -------------------------

def _list_of(check):
    def check_list(v, name):
        if not isinstance(v, list):
            raise ValueError(f"{name}: want a list, got {v!r}")
        return [check(item, f"{name}[{i}]") for i, item in enumerate(v)]
    return check_list


def _dict_of(check):
    def check_dict(v, name):
        if not isinstance(v, dict):
            raise ValueError(f"{name}: want a mapping, got {v!r}")
        return {_typed(str)(k, f"{name} key"): check(item, f"{name}.{k}")
                for k, item in v.items()}
    return check_dict


def _zarr_path(v, name):
    """``ProcessingInputChannel.path``: None or a path ending in ``.zarr``."""
    if v is None:
        return None
    if not isinstance(v, str):
        raise ValueError(f"{name}: want a path, got {v!r}")
    if Path(v).suffix != ".zarr":
        raise ValueError("Path must be a valid OME-Zarr dataset.")
    return str(Path(v))


def _int_pair(v, name):
    if not isinstance(v, (list, tuple)) or len(v) != 2:
        raise ValueError(f"{name}: want [start, stop], got {v!r}")
    return [_lax_number(int)(i, name) for i in v]


_PREPROCESSING_FUNCTION = _model({
    "function": (_REQUIRED, _typed(str)),
    "channel": (_REQUIRED, _typed(str)),
    "kwargs": (dict, _typed(dict)),
}, forbid=False)
_SEGMENTATION_MODEL = _model({
    "path_to_model": (_REQUIRED, _typed(str)),
    "eval_args": (_REQUIRED, _typed(dict)),
    "z_slice_2D": (None, _optional(_lax_number(int))),
    "preprocessing": (list, _list_of(_PREPROCESSING_FUNCTION)),
}, forbid=False)
_PROCESSING_FUNCTION = _model({
    "function": (_REQUIRED, _typed(str)),
    "input_channels": (None, _optional(_str_list)),
    "kwargs": (dict, _typed(dict)),
    "per_timepoint": (True, _optional(_lax_bool)),
})
_PROCESSING_INPUT_CHANNEL = _model({
    "path": (None, _zarr_path),
    "channels": (_REQUIRED, _dict_of(_list_of(_PROCESSING_FUNCTION))),
})
_CELLPOSE_CONFIG = _model({
    "model_type": ("nuclei", _typed(str)),
    "diameter": (80, _lax_number(float)),
    "cellprob_threshold": (0.0, _lax_number(float)),
    "flow_threshold": (0.4, _lax_number(float)),
    "gpu": (True, _lax_bool),
    "min_size": (500, _lax_number(int)),
    "input_channel": ("nuclei_prediction", _typed(str)),
    "labels_sigma": (5.0, _lax_number(float)),
})
_ZSLICING = _model({
    "method": ("all", _literal("all", "central", "range", "focus")),
    "range": (None, _optional(_int_pair)),
    "window_size": (48, _lax_number(int)),
    "frac_below": (1 / 3, _lax_number(float)),
    "frac_above": (2 / 3, _lax_number(float)),
    "focus_channel": (None, _optional(_typed(str))),
})
_TRACKING = _model({
    "target_channel": ("nuclei_prediction", _typed(str)),
    "fov": ("*/*/*", _typed(str)),
    "blank_frames_path": (None, _optional(lambda v, name: str(Path(_typed(str)(v, name))))),
    "output_mode": ("2D", _literal("2D", "3D")),
    "z_slicing": (lambda: _ZSLICING({}, "z_slicing"), _ZSLICING),
    "input_images": (_REQUIRED, _list_of(_PROCESSING_INPUT_CHANNEL)),
    "tracking_config": (dict, _typed(dict)),
    "segmentation_method": ("foreground_contour", _literal("foreground_contour", "cellpose")),
    "cellpose_config": (None, _optional(_CELLPOSE_CONFIG)),
    "output_ome_zarr_version": (None, _version),
})


def segmentation_settings_from_reference(settings: dict) -> dict:
    """``SegmentationSettings`` (settings.py:726-770) as its ``model_dump(
    mode="json")``: ``models`` ({name: {path_to_model, eval_args,
    z_slice_2D, preprocessing: [{function, channel, kwargs}]}}; a model's and
    a step's unknown fields dropped, the settings' own refused) and
    ``output_ome_zarr_version``. As the model's validator, a ``z_slice_2D``
    that is set becomes 0, and refuses ``do_3D`` in ``eval_args``."""
    out = _model({"models": (_REQUIRED, _dict_of(_SEGMENTATION_MODEL)),
                  "output_ome_zarr_version": (None, _version)})(settings, "segmentation settings")
    for model in out["models"].values():
        if model["z_slice_2D"] is not None:
            if model["eval_args"].get("do_3D", None):
                raise ValueError("If 'z_slice_2D' is provided, 'do_3D' in 'eval_args' must be "
                                 "set to False.")
            model["z_slice_2D"] = 0
    return out


def zslicing_from_reference(settings: dict | None = None) -> dict:
    """``ZSlicing`` (settings.py:694-711) as a plain dict with its
    defaults: ``method`` ("all"), ``range`` (None or [start, stop]),
    ``window_size`` (48), ``frac_below`` (1/3), ``frac_above`` (2/3) and
    ``focus_channel``."""
    return _ZSLICING(settings or {}, "z_slicing")


def cellpose_config_from_reference(settings: dict | None = None) -> dict:
    """``CellposeConfig`` (settings.py:682-692) as a plain dict with its
    defaults."""
    return _CELLPOSE_CONFIG(settings or {}, "cellpose_config")


def tracking_settings_from_reference(settings: dict) -> dict:
    """``TrackingSettings`` (settings.py:714-724) as a plain dict, nested
    blocks included (``ProcessingInputChannel``, ``ProcessingFunctions``,
    ``CellposeConfig``, ``ZSlicing``; unknown fields refused, as every
    ``MyBaseModel``); paths are strings, so the dict is also its
    ``model_dump(mode="json")``."""
    return _TRACKING(settings, "tracking settings")


# -- characterize-psf and process-with-config settings (settings.py:455-477,
# 659-668) -------------------------------------------------------------------

def _non_negative_ints(v, name):
    if not isinstance(v, (list, tuple)):
        raise ValueError(f"{name}: want a list, got {v!r}")
    return [_NON_NEGATIVE_INT(i, f"{name}[{k}]") for k, i in enumerate(v)]


def _patch_size(v, name):
    if not isinstance(v, (list, tuple)) or len(v) != 3:
        raise ValueError(f"{name}: want 3 positive numbers, got {v!r}")
    return tuple(_POSITIVE(x, f"{name}[{k}]") for k, x in enumerate(v))


_CHARACTERIZE = _model({
    "block_size": ((64, 64, 32), _non_negative_ints),
    "blur_kernel_size": (3, _NON_NEGATIVE_INT),
    "nms_distance": (32, _NON_NEGATIVE_INT),
    "min_distance": (50, _NON_NEGATIVE_INT),
    "threshold_abs": (200.0, _POSITIVE),
    "max_num_peaks": (2000, _NON_NEGATIVE_INT),
    "exclude_border": ((5, 10, 5), _non_negative_ints),
    "device": ("cuda", _typed(str)),
    "patch_size": (None, _optional(_patch_size)),
    "axis_labels": (lambda: ["AXIS0", "AXIS1", "AXIS2"], _str_list),
    "offset": (0.0, _lax_number(float)),
    "gain": (1.0, _lax_number(float)),
    "use_robust_1d_fwhm": (False, _lax_bool),
    "fwhm_plot_type": ("3D", _literal("1D", "3D")),
})
_PROCESSING_SETTINGS = _model({
    "processing_functions": (list, _list_of(_PROCESSING_FUNCTION)),
    "output_ome_zarr_version": (None, _version),
})


def characterize_settings_from_reference(settings: dict | None = None) -> dict:
    """``CharacterizeSettings`` (settings.py:455-477) as its
    ``model_dump()``: the peak detector's settings, ``patch_size`` (None or
    three um), ``axis_labels``, ``offset``, ``gain``,
    ``use_robust_1d_fwhm`` and ``fwhm_plot_type`` ("1D" or "3D"); unknown
    fields raise. ``device`` is accepted and not used: the verb runs where
    its caller says."""
    return _CHARACTERIZE(settings or {}, "characterize settings")


def processing_settings_from_reference(settings: dict) -> dict:
    """``ProcessingImportFuncSettings`` (settings.py:666-668) as its
    ``model_dump()``: ``processing_functions``, each a
    ``ProcessingFunctions`` (``function``, ``input_channels``, ``kwargs``,
    ``per_timepoint``), and ``output_ome_zarr_version``."""
    return _PROCESSING_SETTINGS(settings, "processing settings")
