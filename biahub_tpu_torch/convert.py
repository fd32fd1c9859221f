"""Carry the JAX package's per-acquisition state into the port.

``module_from_reference`` builds :class:`~biahub_tpu_torch.pipeline.
DeconvolveDeskew` from the reference's numpy transfer function and from
settings dicts with the field names of ``biahub_tpu/settings.py``'s
``DeskewSettings`` and ``DeconvolveSettings`` (settings.py:373-451), with
their defaults and their rounding, without pydantic.
"""

from __future__ import annotations

import numpy as np
import torch

from biahub_tpu_torch.pipeline import DeconvolveDeskew

__all__ = ["module_from_reference"]

_DESKEW_FIELDS = {
    "pixel_size_um", "ls_angle_deg", "px_to_scan_ratio", "scan_step_um",
    "keep_overhang", "overhang_fill", "average_n_slices", "device",
    "output_ome_zarr_version",
}
_DECONVOLVE_FIELDS = {"regularization_strength", "output_ome_zarr_version"}


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
