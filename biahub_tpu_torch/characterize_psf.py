"""characterize-psf: bead detection, Gaussian fits and the PSF report.

Counterpart of ``biahub_tpu/characterize_psf.py``: ``_characterize_psf``
(:162) detects the beads of one volume with the peak detector on the card
(kernel G, :func:`~biahub_tpu_torch.kernels.peaks.detect_peaks`), crops
their patches, fits each on the host with scipy
(:func:`~biahub_tpu_torch.psf.analysis.analyze_psf`) and writes
:func:`generate_report`'s files: ``peaks.pkl``, ``psf_gaussian_fit.csv``,
``psf_1d_peak_width.csv`` (the reference's columns, through ``csv``) and
``psf_analysis_report.html``. The plots (``plots/psf_slices.png`` and
``plots/fwhm_vs_<label>.png``) are made only where matplotlib exists, and
the report's ``<img>`` tags name only the plots that were written.
"""

from __future__ import annotations

import csv
import math
import pickle
import time
from pathlib import Path

import numpy as np
import torch

from biahub_tpu_torch.cli.parsing import CommandError
from biahub_tpu_torch.cli.utils import yaml_to_model
from biahub_tpu_torch.convert import characterize_settings_from_reference
from biahub_tpu_torch.device import resolve_device
from biahub_tpu_torch.io.ngff import open_ome_zarr
from biahub_tpu_torch.kernels.peaks import detect_peaks
from biahub_tpu_torch.plots import pyplot
from biahub_tpu_torch.psf.analysis import analyze_psf, compute_noise_level, extract_beads

__all__ = ["characterize_psf", "characterize_psf_volume", "generate_report", "write_csv"]


def write_csv(path, columns: list, rows: list[dict]) -> None:
    """The rows as pandas' ``to_csv(index=False)`` writes a frame of them:
    a header, then one line a row, floats as their ``repr``."""
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(columns)
        for row in rows:
            writer.writerow([repr(float(row[c])) if isinstance(row[c], (float, np.floating))
                             else row[c] for c in columns])


def _mean(values) -> float:
    return float(np.mean(values)) if len(values) else math.nan


def _std(values) -> float:
    """pandas' ``Series.std``: ddof 1, NaN below two values."""
    return float(np.std(values, ddof=1)) if len(values) > 1 else math.nan


def _plot_psf_slices(plt, plots_dir: Path, beads, indices) -> Path:
    n = len(beads)
    fig, axes = plt.subplots(3, max(n, 1), figsize=(3 * max(n, 1), 9))
    axes = np.asarray(axes).reshape(3, max(n, 1))
    for i, bead in enumerate(beads):
        mid = [s // 2 for s in bead.shape]
        for row, (plane, title) in enumerate(
                ((bead[mid[0]], "XY"), (bead[:, mid[1]], "XZ"), (bead[:, :, mid[2]], "YZ"))):
            ax = axes[row, i]
            ax.imshow(plane, cmap="gray")
            ax.set_title(f"bead {indices[i]} {title}", fontsize=8)
            ax.axis("off")
    fig.tight_layout()
    path = plots_dir / "psf_slices.png"
    fig.savefig(path, dpi=150)
    plt.close(fig)
    return path


def _plot_fwhm_scatter(plt, plots_dir: Path, xs, ys, axis_labels) -> list[Path]:
    paths = []
    for i, label in enumerate(axis_labels):
        fig, ax = plt.subplots(figsize=(4, 3))
        for y_vals, name in zip(ys, ("z", "y", "x")):
            ax.plot(xs[i], y_vals, "o", markersize=2, label=f"{name} FWHM")
        ax.set_xlabel(f"{label} (um)")
        ax.set_ylabel("FWHM (um)")
        ax.legend(frameon=False)
        fig.tight_layout()
        path = plots_dir / f"fwhm_vs_{label}.png"
        fig.savefig(path, dpi=150)
        plt.close(fig)
        paths.append(path)
    return paths


def generate_report(output_path, data_dir, dataset: str, beads: list, peaks: np.ndarray,
                    fits: tuple, scale: tuple, axis_labels, fwhm_plot_type: str) -> None:
    """Write the report, its tables and (where matplotlib exists) its plots
    (the reference's ``generate_report``, :84); ``fits`` is
    :func:`~biahub_tpu_torch.psf.analysis.analyze_psf`'s result."""
    gauss, gauss_columns, widths, width_columns = fits
    output_path = Path(output_path)
    output_path.mkdir(exist_ok=True, parents=True)
    plots_dir = output_path / "plots"
    plots_dir.mkdir(exist_ok=True)
    num_beads, num_successful = len(beads), len(gauss)

    def column(rows, name):
        return [r[name] for r in rows]

    images = []
    plt = pyplot(plots_dir / "psf_slices.png")
    if plt is not None:
        rng = np.random.default_rng(0)
        sample = sorted(rng.choice(num_beads, min(5, num_beads), replace=False))
        images.append((_plot_psf_slices(plt, plots_dir, [beads[i] for i in sample], sample),
                       800))
        if fwhm_plot_type == "1D" and len(widths):
            xs = [column(widths, c) for c in ("x_mu", "y_mu", "z_mu")]
            ys = [column(widths, c) for c in ("1d_z_fwhm", "1d_y_fwhm", "1d_x_fwhm")]
        else:
            xs = [column(gauss, c) for c in ("x_mu", "y_mu", "z_mu")]
            ys = [column(gauss, c) for c in ("zyx_z_fwhm", "zyx_y_fwhm", "zyx_x_fwhm")]
        images += [(p, 400) for p in _plot_fwhm_scatter(plt, plots_dir, xs, ys, axis_labels)]

    axes3 = ("zyx_z_fwhm", "zyx_y_fwhm", "zyx_x_fwhm")
    fwhm_3d_mean = [_mean(column(gauss, c)) for c in axes3]
    fwhm_3d_std = [_std(column(gauss, c)) for c in axes3]
    fwhm_pc_mean = [_mean(column(gauss, c))
                    for c in ("zyx_pc3_fwhm", "zyx_pc2_fwhm", "zyx_pc1_fwhm")]
    fwhm_1d_mean = [_mean(column(widths, c)) for c in ("1d_z_fwhm", "1d_y_fwhm", "1d_x_fwhm")]
    snr_mean = _mean(column(gauss, "zyx_snr")) if "zyx_snr" in gauss_columns else 0

    with open(output_path / "peaks.pkl", "wb") as f:
        pickle.dump(peaks, f)
    write_csv(output_path / "psf_gaussian_fit.csv", gauss_columns, gauss)
    write_csv(output_path / "psf_1d_peak_width.csv", width_columns, widths)

    def _fmt(vals):
        return ", ".join(f"{v:.3f}" for v in vals)

    tags = "".join(f'<img src="plots/{p.name}" width="{w}">' + ("<br>\n" if w == 800 else "")
                   for p, w in images)
    html = f"""<!DOCTYPE html><html><head><title>PSF Analysis</title></head><body>
<h1>PSF Analysis Report</h1>
<p>Dataset: {dataset}<br>Path: {data_dir}<br>Scale (z, y, x): {tuple(scale)} um</p>
<h2>Detection</h2>
<p>Beads: {num_beads}, successful fits: {num_successful}, failed: {num_beads - num_successful}<br>
Mean SNR: {snr_mean:.1f}</p>
<h2>FWHM (um)</h2>
<p>3D Gaussian fit (z, y, x): {_fmt(fwhm_3d_mean)} &plusmn; {_fmt(fwhm_3d_std)}<br>
Principal components: {_fmt(fwhm_pc_mean)}<br>
1D profiles (z, y, x): {_fmt(fwhm_1d_mean)}</p>
<h2>Plots</h2>
{tags}
</body></html>"""
    with open(output_path / "psf_analysis_report.html", "w") as f:
        f.write(html)


def characterize_psf_volume(zyx_data: np.ndarray, zyx_scale: tuple, settings: dict,
                            output_report_path, input_dataset_path: str,
                            input_dataset_name: str, device: str | torch.device = "cuda"):
    """The reference's ``_characterize_psf`` (:162) on one (Z, Y, X)
    volume with a validated settings dict: the peaks on ``device``, the
    fits and the report on the host. Returns the (N, 3) peaks."""
    dev = resolve_device(device)
    settings = dict(settings)
    patch_size = settings.pop("patch_size", None)
    axis_labels = settings.pop("axis_labels")
    offset = settings.pop("offset")
    gain = settings.pop("gain")
    use_robust_1d_fwhm = settings.pop("use_robust_1d_fwhm")
    fwhm_plot_type = settings.pop("fwhm_plot_type")
    settings.pop("device", None)

    print("Detecting peaks...")
    t1 = time.time()
    peaks = detect_peaks(
        zyx_data,
        block_size=tuple(settings["block_size"]),
        nms_distance=settings["nms_distance"],
        min_distance=settings["min_distance"],
        threshold_abs=settings["threshold_abs"],
        max_num_peaks=settings["max_num_peaks"],
        exclude_border=tuple(settings["exclude_border"]),
        blur_kernel_size=settings["blur_kernel_size"],
        verbose=True,
        device=dev,
    )
    print(f"Time to detect peaks: {time.time() - t1:.2f}s")
    if len(peaks) == 0:
        raise CommandError("No peaks detected.")

    beads, offsets = extract_beads(zyx_data=zyx_data, points=peaks, scale=zyx_scale,
                                   patch_size=patch_size)
    if not beads:
        raise CommandError("No beads could be extracted.")
    noise = compute_noise_level(zyx_data, peaks, beads[0].shape)

    print("Analyzing PSFs...")
    fits = analyze_psf(zyx_patches=beads, peak_coordinates=offsets, scale=zyx_scale,
                       offset=offset, gain=gain, noise=noise,
                       use_robust_1d_fwhm=use_robust_1d_fwhm)
    generate_report(output_report_path, input_dataset_path, input_dataset_name, beads, peaks,
                    fits, zyx_scale, axis_labels, fwhm_plot_type)
    return peaks


def characterize_psf(input_position_dirpaths: list[Path], config_filepath: Path,
                     output_dirpath: Path, device: str | torch.device = "cuda") -> None:
    """The characterize-psf verb: the first position's first (t, c)
    volume, at its ZYX scale."""
    settings = yaml_to_model(config_filepath, characterize_settings_from_reference)
    dataset = open_ome_zarr(str(input_position_dirpaths[0]), mode="r")
    zyx_data = dataset["0"][0, 0]
    zyx_scale = tuple(dataset.scale[-3:])
    characterize_psf_volume(np.asarray(zyx_data), zyx_scale, settings, Path(output_dirpath),
                            str(input_position_dirpaths[0]),
                            "/".join(Path(input_position_dirpaths[0]).parts[-3:]),
                            device=device)
    print(f"Report saved to {output_dirpath}")
