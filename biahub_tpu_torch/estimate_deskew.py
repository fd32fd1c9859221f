"""estimate-deskew: the deskew parameters from calibration measurements.

Counterpart of ``biahub_tpu/estimate_deskew.py``: ``px_to_scan_ratio``
from a rectangle around an object that is square after deskewing
(:func:`px_to_scan_ratio_from_rectangle`, :34) and the light-sheet angle
from a line along a coverslip-normal object (:func:`ls_angle_from_line`,
:45), from point files exported from any viewer (``--rect-points``,
``--line-points``: ``.npy`` or headerless CSV/TSV, :func:`_load_points`,
:58) or from measured values; the verb (:154) writes ``DeskewSettings``
as the reference's ``model_to_yaml`` does. ``--interactive`` needs napari,
which the port does not drive: it refuses as the reference does without
napari.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from biahub_tpu_torch.cli.parsing import CommandError
from biahub_tpu_torch.cli.utils import model_to_yaml
from biahub_tpu_torch.convert import deskew_settings_dump

__all__ = ["px_to_scan_ratio_from_rectangle", "ls_angle_from_line", "estimate_deskew"]


def px_to_scan_ratio_from_rectangle(rect: np.ndarray) -> float:
    """The scan extent over the coverslip extent of a (4, 3) rectangle in
    (scan, tilt, coverslip) order."""
    rect = np.asarray(rect, dtype=np.float64)
    return float((rect[2, 0] - rect[0, 0]) / (rect[2, 2] - rect[0, 2]))


def ls_angle_from_line(line: np.ndarray, px_to_scan_ratio: float) -> float:
    """The light-sheet angle (degrees) of a (2, 2) point pair on the X
    projection."""
    line = np.asarray(line, dtype=np.float64)
    r = line[1] - line[0]
    r_hat = r / np.linalg.norm(r)
    theta = np.arccos(r_hat[0] / r_hat[1] / px_to_scan_ratio)
    return float((theta % np.pi) * 180 / np.pi)


def _load_points(path) -> np.ndarray:
    path = Path(path)
    if path.suffix == ".npy":
        return np.load(path)
    return np.loadtxt(path, delimiter="," if path.suffix == ".csv" else None)


def estimate_deskew(output_filepath, pixel_size_um=None, scan_step_um=None,
                    px_to_scan_ratio=None, ls_angle_deg=None, rect_points=None,
                    line_points=None, interactive: bool = False) -> None:
    """The estimate-deskew verb (module docstring)."""
    if not str(output_filepath).endswith((".yaml", ".yml")):
        raise ValueError("Output file must be a YAML file.")
    if pixel_size_um is None or scan_step_um is None:
        raise CommandError("estimate-deskew needs --pixel-size-um and --scan-step-um.")
    if interactive:
        raise CommandError("--interactive requires napari; headless, pass --rect-points/"
                           "--line-points files or the measured values directly.")
    if px_to_scan_ratio is None and rect_points is not None:
        px_to_scan_ratio = round(px_to_scan_ratio_from_rectangle(_load_points(rect_points)), 3)
        print(f"Measured px_to_scan_ratio : {px_to_scan_ratio:.3f}")
    if px_to_scan_ratio is None:
        px_to_scan_ratio = round(pixel_size_um / scan_step_um, 3)
        print(f"Using px_to_scan_ratio = pixel_size/scan_step = {px_to_scan_ratio}")
    if ls_angle_deg is None and line_points is not None:
        ls_angle_deg = ls_angle_from_line(_load_points(line_points), px_to_scan_ratio)
        print(f"Measured light-sheet angle : {ls_angle_deg:.2f}")
    if ls_angle_deg is None:
        raise CommandError("Provide --ls-angle-deg, a --line-points file, or --interactive "
                           "(see ls_angle_from_line for the math).")
    settings = deskew_settings_dump({"pixel_size_um": pixel_size_um, "ls_angle_deg": ls_angle_deg,
                                     "px_to_scan_ratio": px_to_scan_ratio,
                                     "scan_step_um": scan_step_um})
    print(f"Writing deskewing parameters to {output_filepath}")
    model_to_yaml(settings, output_filepath)
