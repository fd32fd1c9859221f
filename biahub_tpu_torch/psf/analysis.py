"""Bead patches for the PSF: extraction, the background noise level and
the Gaussian fits of ``characterize-psf``.

Counterpart of ``biahub_tpu/psf/analysis.py``, on numpy and scipy:
``extract_beads`` (:30), ``fit_gaussian_3d`` (:61), ``_fit_z_profile``
(:131), ``analyze_psf`` (:152), ``compute_noise_level`` (:203) and the 1D
peak widths (:217, :230). ``analyze_psf`` returns the reference's two
tables as lists of records (dicts in the reference's column order, its
``dropna`` and zero-width filtering applied) and their column lists, where
the reference returns DataFrames: the card's machine has no pandas.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = [
    "bead_patch_slices",
    "extract_beads",
    "fit_gaussian_3d",
    "analyze_psf",
    "compute_noise_level",
    "calculate_peak_widths",
    "calculate_robust_peak_widths",
]

_FWHM = 2 * np.sqrt(2 * np.log(2))


def bead_patch_slices(shape, points, scale, patch_size=None) -> list[tuple[slice, ...]]:
    """The (z, y, x) slices of the bead patches (sizes in um) around
    ``points`` that lie wholly inside a volume of ``shape``."""
    if patch_size is None:
        patch_size = (scale[0] * 15, scale[1] * 18, scale[2] * 18)
    half_px = [int(round((p / s) // 2)) for p, s in zip(patch_size, scale)]
    out = []
    for point in np.asarray(points, dtype=int):
        slices = []
        for coord, half, size in zip(point, half_px, shape):
            start, stop = coord - half, coord + half + 1
            if start < 0 or stop > size:
                break
            slices.append(slice(int(start), int(stop)))
        else:
            out.append(tuple(slices))
    return out


def extract_beads(zyx_data, points, scale, patch_size=None):
    """Crop bead patches (sizes in um) around detected peak coordinates.

    Returns (patches, offsets); beads whose full patch would cross the volume
    border are dropped, and so are empty patches."""
    zyx_data = np.asarray(zyx_data)
    patches, offsets = [], []
    for slices in bead_patch_slices(zyx_data.shape, points, scale, patch_size):
        patch = zyx_data[slices]
        if patch.size == 0:
            continue
        patches.append(patch)
        offsets.append(tuple(int(s.start) for s in slices))
    return patches, offsets


def compute_noise_level(zyx_data, peak_coordinates, patch_size_pix):
    """Std of the volume with bead patches masked out."""
    zyx_data = np.asarray(zyx_data)
    mask = np.ones_like(zyx_data, dtype=bool)
    half = [size // 2 for size in patch_size_pix]
    for z, y, x in peak_coordinates:
        patch_mask = tuple(
            slice(max(0, c - half[i]), min(zyx_data.shape[i], c + half[i] + 1))
            for i, c in enumerate((z, y, x))
        )
        mask[patch_mask] = False
    return float(np.std(zyx_data[mask]))


def fit_gaussian_3d(patch: np.ndarray, scale) -> dict | None:
    """Full-covariance 3D Gaussian fit of one bead patch (physical units):
    mu in um from the patch origin, axis and principal-axis FWHMs in um,
    amplitude and background; None on failure (the reference's fit)."""
    from scipy.optimize import curve_fit

    patch = np.asarray(patch, dtype=np.float64)
    scale = np.asarray(scale, dtype=np.float64)
    zz, yy, xx = np.meshgrid(
        *[np.arange(s) * sc for s, sc in zip(patch.shape, scale)], indexing="ij")
    coords = np.stack([zz.ravel(), yy.ravel(), xx.ravel()])
    data = patch.ravel()

    bg0 = float(np.percentile(data, 10))
    amp0 = float(data.max() - bg0)
    peak = np.unravel_index(np.argmax(patch), patch.shape)
    mu0 = np.asarray(peak) * scale
    sigma0 = np.maximum(np.asarray(patch.shape) * scale / 8.0, scale)
    # The inverse covariance through its Cholesky factor L (lower
    # triangular, Sigma^-1 = L L^T), positive definite by construction.
    l0 = np.array([1 / sigma0[0], 1 / sigma0[1], 1 / sigma0[2], 0.0, 0.0, 0.0])
    p0 = np.concatenate([[bg0, amp0], mu0, l0])

    def model(c, bg, amp, mz, my, mx, l00, l11, l22, l10, l20, l21):
        L = np.array([[l00, 0, 0], [l10, l11, 0], [l20, l21, l22]])
        d = np.stack([c[0] - mz, c[1] - my, c[2] - mx])
        q = np.einsum("ij,jn->in", L.T, d)
        return bg + amp * np.exp(-0.5 * np.sum(q * q, axis=0))

    try:
        popt, _ = curve_fit(model, coords, data, p0=p0, maxfev=4000)
    except Exception:
        return None

    bg, amp = popt[0], popt[1]
    mu = popt[2:5]
    L = np.array([[popt[5], 0, 0], [popt[8], popt[6], 0], [popt[9], popt[10], popt[7]]])
    try:
        cov = np.linalg.inv(L @ L.T)
    except np.linalg.LinAlgError:
        return None
    if not np.all(np.isfinite(cov)) or np.any(np.diag(cov) <= 0):
        return None

    sigmas = np.sqrt(np.diag(cov))
    eigvals = np.clip(np.linalg.eigvalsh(cov), 0, None)
    pc_fwhm = _FWHM * np.sqrt(eigvals)  # ascending
    return {
        "z_mu": mu[0],
        "y_mu": mu[1],
        "x_mu": mu[2],
        "zyx_amp": amp,
        "zyx_bg": bg,
        "zyx_z_fwhm": _FWHM * sigmas[0],
        "zyx_y_fwhm": _FWHM * sigmas[1],
        "zyx_x_fwhm": _FWHM * sigmas[2],
        "zyx_pc1_fwhm": pc_fwhm[2],
        "zyx_pc2_fwhm": pc_fwhm[1],
        "zyx_pc3_fwhm": pc_fwhm[0],
    }


def _fit_z_profile(patch: np.ndarray, scale_z: float) -> dict:
    """1D Gaussian fit of the axial profile through the brightest voxel."""
    from scipy.optimize import curve_fit

    peak = np.unravel_index(np.argmax(patch), patch.shape)
    profile = patch[:, peak[1], peak[2]].astype(np.float64)
    z = np.arange(profile.size) * scale_z
    bg0 = profile.min()
    amp0 = profile.max() - bg0

    def model(z, bg, amp, mu, sigma):
        return bg + amp * np.exp(-0.5 * ((z - mu) / sigma) ** 2)

    try:
        popt, _ = curve_fit(model, z, profile,
                            p0=[bg0, amp0, z[np.argmax(profile)], scale_z * 2], maxfev=2000)
        return {"z_amp": popt[1], "z_fwhm": _FWHM * abs(popt[3])}
    except Exception:
        return {"z_amp": np.nan, "z_fwhm": np.nan}


WIDTH_COLUMNS = [f"1d_{i}_fwhm" for i in ("z", "y", "x")]


def _complete(row: dict, columns) -> bool:
    return all(c in row and not (isinstance(row[c], float) and math.isnan(row[c]))
               for c in columns)


def analyze_psf(zyx_patches: list, peak_coordinates: list, scale, offset: float = 0.0,
                gain: float = 1.0, noise: float = 1.0, use_robust_1d_fwhm: bool = False):
    """Gaussian-fit every bead patch: ``(gaussian_rows, gaussian_columns,
    width_rows, width_columns)``, the reference's ``df_gaussian_fit`` and
    ``df_1d_peak_width`` as records (rows with a missing value dropped, 1D
    rows with a zero width dropped), positions in um in the volume, the
    amplitudes divided by ``gain`` and ``zyx_snr`` the amplitude over
    ``noise``."""
    f_1d = calculate_robust_peak_widths if use_robust_1d_fwhm else calculate_peak_widths
    fits = []
    for patch in zyx_patches:
        patch = np.clip((np.asarray(patch) + offset) * gain, 0, None)
        summary = fit_gaussian_3d(patch, scale) or {}
        if summary:
            summary.update(_fit_z_profile(patch, scale[0]))
        fits.append(summary)
    # The columns pandas' from_records gives: each key in order of first
    # appearance; a failed fit is a row of NaN.
    columns = []
    for row in fits:
        columns += [k for k in row if k not in columns]
    rows = [{c: float(row.get(c, np.nan)) for c in columns} for row in fits]
    has_mu = "z_mu" in columns
    if has_mu:
        for row, origin in zip(rows, np.asarray(peak_coordinates)):
            for axis, name in enumerate(("z_mu", "y_mu", "x_mu")):
                row[name] += float(origin[axis] * scale[axis])
            row["z_amp"] /= gain
            row["zyx_amp"] /= gain
    width_columns = (["z_mu", "y_mu", "x_mu"] if has_mu else []) + WIDTH_COLUMNS
    widths = []
    for i, patch in enumerate(zyx_patches):
        w = [float(v) for v in f_1d(np.asarray(patch), scale)]
        mu = [rows[i][c] for c in ("z_mu", "y_mu", "x_mu")] if has_mu else []
        widths.append(dict(zip(width_columns, mu + w)))
    rows = [row for row in rows if _complete(row, columns)]
    widths = [row for row in widths if _complete(row, width_columns)
              and not any(row[c] == 0 for c in WIDTH_COLUMNS)]
    if "zyx_amp" in columns:
        columns = columns + ["zyx_snr"]
        for row in rows:
            row["zyx_snr"] = row["zyx_amp"] / noise
    return rows, columns, widths, width_columns


def calculate_peak_widths(zyx_data, zyx_scale):
    """Half-max widths of the central axial and lateral line profiles
    (scipy's ``peak_widths``); zeros on failure."""
    from scipy.signal import peak_widths

    scale_z, scale_y, scale_x = zyx_scale
    shape_z, shape_y, shape_x = zyx_data.shape
    try:
        z_fwhm = peak_widths(zyx_data[:, shape_y // 2, shape_x // 2], [shape_z // 2])[0][0]
        y_fwhm = peak_widths(zyx_data[shape_z // 2, :, shape_x // 2], [shape_y // 2])[0][0]
        x_fwhm = peak_widths(zyx_data[shape_z // 2, shape_y // 2, :], [shape_x // 2])[0][0]
    except Exception:
        z_fwhm, y_fwhm, x_fwhm = (0.0, 0.0, 0.0)
    return z_fwhm * scale_z, y_fwhm * scale_y, x_fwhm * scale_x


def calculate_robust_peak_widths(zyx_data, zyx_scale):
    """Parabola-refined, interpolated half-max widths of the central
    profiles; 0 on an axis that fails."""
    from scipy.interpolate import interp1d

    shape_z, shape_y, shape_x = zyx_data.shape
    slices = ((slice(None), shape_y // 2, shape_x // 2),
              (shape_z // 2, slice(None), shape_x // 2),
              (shape_z // 2, shape_y // 2, slice(None)))
    fwhm = []
    for _slice, _scale in zip(slices, zyx_scale):
        try:
            y = zyx_data[_slice]
            x = np.arange(y.size)
            peak_index = np.argmax(y)
            fit_range = slice(max(0, peak_index - 2), min(peak_index + 2, y.size))
            p = np.polyfit(x[fit_range], y[fit_range], 2)
            peak_index = -p[1] / (2 * p[0])
            half_max = np.polyval(p, peak_index) / 2

            x_scaled = x * _scale
            indices = np.where(y >= half_max / 2)[0]
            il = indices[indices < peak_index]
            ir = indices[indices > peak_index]
            fl = interp1d(y[il], x_scaled[il], kind="linear", fill_value="extrapolate")
            fr = interp1d(y[ir], x_scaled[ir], kind="linear", fill_value="extrapolate")
            fwhm.append(float(fr(half_max) - fl(half_max)))
        except Exception:
            fwhm.append(0.0)
    return fwhm
