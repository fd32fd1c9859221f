"""Carry the JAX package's per-acquisition state into the port.

``module_from_reference`` builds :class:`~biahub_tpu_torch.pipeline.
DeconvolveDeskew` from the reference's numpy transfer function and from
settings dicts with the field names of ``biahub_tpu/settings.py``'s
``DeskewSettings`` and ``DeconvolveSettings`` (settings.py:373-451), with
their defaults and their rounding, without pydantic. ``chain_from_reference``
builds :class:`~biahub_tpu_torch.pipeline.DeconvolveDeskewWarp` from a fused
pipeline's settings (``FusePipelineSettings``, settings.py:557-620) as a
plain dict. The port reads no YAML itself.
"""

from __future__ import annotations

import numpy as np
import torch

from biahub_tpu_torch.pipeline import DeconvolveDeskew, DeconvolveDeskewWarp

__all__ = ["module_from_reference", "chain_from_reference"]

_DESKEW_FIELDS = {
    "pixel_size_um", "ls_angle_deg", "px_to_scan_ratio", "scan_step_um",
    "keep_overhang", "overhang_fill", "average_n_slices", "device",
    "output_ome_zarr_version",
}
_DECONVOLVE_FIELDS = {"regularization_strength", "output_ome_zarr_version"}
# FusePipelineSettings' fields; flat_field is not ported yet.
_FUSE_FIELDS = {
    "flat_field", "deconvolve", "deskew", "registration", "stabilization",
    "time_indices", "output_shape_zyx", "output_ome_zarr_version",
}


def _unknown(d: dict, fields: set, what: str) -> None:
    extra = set(d) - fields
    if extra:
        raise ValueError(f"{what}: unknown fields {sorted(extra)}")


def _deskew_settings(deskew: dict) -> dict:
    """The deskew fields the chain uses, validated and defaulted as
    ``DeskewSettings`` does: the angle in [0, 45] rounded to 0.01, the
    ratio rounded to 0.001, and derived as round(pixel_size_um /
    scan_step_um, 3) when absent (settings.py:410-413). ``device`` and
    ``output_ome_zarr_version`` are accepted and not used."""
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
        skip_flip=skip_flip, device=device, **_deskew_settings(deskew),
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
    ``stabilization`` blocks; ``output_shape_zyx`` when given)."""
    _unknown(fuse_settings, _FUSE_FIELDS, "fuse settings")
    if fuse_settings.get("flat_field") is not None:
        raise NotImplementedError("biahub_tpu_torch: the flat_field stage is not ported yet")
    for block in ("deconvolve", "deskew"):
        if fuse_settings.get(block) is None:
            raise ValueError(f"fuse settings: the chain needs a {block} block")
    out = fuse_settings.get("output_shape_zyx")
    return DeconvolveDeskewWarp(
        tf_half, tuple(int(s) for s in zyx_shape),
        _deconvolve_settings(fuse_settings["deconvolve"]),
        matrix=_fuse_warp_matrix(fuse_settings, int(time_index)),
        output_shape=None if out is None else tuple(int(s) for s in out),
        device=device, **_deskew_settings(fuse_settings["deskew"]),
    )
