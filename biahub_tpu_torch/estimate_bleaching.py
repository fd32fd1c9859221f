"""estimate-bleaching: each channel's mean intensity over time and the
lifetime of its exponential decay.

Counterpart of ``biahub_tpu/estimate_bleaching.py``: the mean and standard
deviation of each (t, c) volume (:func:`bleaching_statistics`, on the card,
summed in float64), then per channel ``a * exp(-t / b) + c`` fitted on the
host with scipy's ``curve_fit`` (the reference's p0, the standard
deviations as sigma, ``maxfev`` 5000; :func:`fit_bleaching`). Each fit
prints "Curve fit successful!" and its label, the channel and the lifetime
in minutes (or the error and "Curve fit failed!"), so the number reaches
the user without matplotlib; ``<output>/<row>/<col>/<fov>/bleaching.svg``
is drawn only where matplotlib exists. Times come from the plate's
``Summary.Interval_ms``, one minute a frame where it is missing.
"""

from __future__ import annotations

import os
import warnings
from concurrent.futures import Future
from pathlib import Path

import numpy as np
import torch

from biahub_tpu_torch.device import resolve_device
from biahub_tpu_torch.io.ngff import open_ome_zarr
from biahub_tpu_torch.plots import pyplot

__all__ = ["bleaching_statistics", "fit_bleaching", "plot_bleaching_curves",
           "estimate_bleaching"]

MSECS_PER_MINUTE = 60000

# Display colors of common channel names (the reference's registry).
_CHANNEL_COLORS = {"GFP": "#00FF00", "RFP": "#FF0000", "mCherry": "#FF0000",
                   "DAPI": "#0000FF", "BF": "#FFFFFF"}


def bleaching_statistics(tczyx, device: str | torch.device = "cuda"):
    """The (T, C) float64 means and standard deviations of a (T, C, Z, Y,
    X) array (a plate's ``ImageArray`` or numpy), each volume reduced on
    ``device`` in float64; the next volume is read while one is reduced."""
    dev = resolve_device(device)
    T, C = tczyx.shape[:2]
    means = np.zeros((T, C))
    stds = np.zeros_like(means)
    keys = [(t, c) for t in range(T) for c in range(C)]

    def read(key) -> Future:
        if hasattr(tczyx, "read_async"):
            return tczyx.read_async(key)
        done = Future()
        done.set_result(np.asarray(tczyx[key]))
        return done

    pending = read(keys[0]) if keys else None
    for i, (t, c) in enumerate(keys):
        zyx = pending.result()
        if i + 1 < len(keys):
            pending = read(keys[i + 1])
        vol = torch.from_numpy(np.ascontiguousarray(zyx)).to(dev).to(torch.float64)
        std, mean = torch.std_mean(vol, correction=0)
        means[t, c], stds[t, c] = float(mean), float(std)
    return means, stds


def _decay(x, a, b, cc):
    return a * np.exp(-x / b) + cc


def fit_bleaching(times, means, stds, channel_names) -> list:
    """Per channel the fitted (a, b, c) or None, with the reference's
    printed lines; b is the lifetime in the times' unit."""
    from scipy.optimize import curve_fit

    fits = []
    for c in range(means.shape[1]):
        ydata, yerr = means[:, c], stds[:, c]
        try:
            popt, _ = curve_fit(_decay, times[:], ydata, sigma=yerr,
                                p0=(np.max(ydata) - np.min(ydata), 100, np.min(ydata)),
                                maxfev=5000)
            print("Curve fit successful!")
            print(channel_names[c] + f" - {popt[1]:0.0f} minutes")
            fits.append(popt)
        except Exception as e:  # noqa: BLE001 - a failed fit only drops the label
            print(e)
            print("Curve fit failed!")
            fits.append(None)
    return fits


def _plot(times, means, fits, channel_names, output_file, title) -> None:
    plt = pyplot(output_file)
    if plt is None:
        return
    f, ax = plt.subplots(1, 1, figsize=(4, 4))
    for c, popt in enumerate(fits):
        color = _CHANNEL_COLORS.get(channel_names[c], f"C{c}")
        label = channel_names[c]
        if popt is not None:
            xx = np.linspace(0, np.max(times), 100)
            ax.plot(xx, _decay(xx, *popt), color=color, alpha=0.5)
            label += f" - {popt[1]:0.0f} minutes"
        ax.plot(times, means[:, c], label=label, marker="o", markeredgewidth=0, linewidth=0,
                color=color)
    ax.set_title(title, {"fontsize": 8})
    ax.set_xlabel("Time (minutes)")
    ax.set_ylabel("Mean Intensity (AU)")
    ax.legend(frameon=False, markerfirst=False)
    ax.spines["right"].set_visible(False)
    ax.spines["top"].set_visible(False)
    plt.savefig(output_file, bbox_inches="tight")
    plt.close()


def plot_bleaching_curves(times, tczyx_data, channel_names, output_file, title="",
                          device: str | torch.device = "cuda"):
    """Per-channel mean intensity over time with exponential decay fits,
    plotted to ``output_file`` (the reference's ``plot_bleaching_curves``:
    the means on ``device``, the fits on the host, the plot only where
    matplotlib is installed); returns the means, standard deviations and
    fits."""
    means, stds = bleaching_statistics(tczyx_data, device)
    fits = fit_bleaching(times, means, stds, channel_names)
    _plot(times, means, fits, channel_names, output_file, title)
    return means, stds, fits


def estimate_bleaching(input_position_dirpaths, output_dirpath,
                       device: str | torch.device = "cuda") -> dict:
    """The estimate-bleaching verb (module docstring); returns
    ``{position: (times, means, stds, fits)}``."""
    plate_zattrs = {}
    try:
        plate_zattrs = open_ome_zarr(Path(*Path(input_position_dirpaths[0]).parts[:-3])).zattrs
    except Exception as e:  # noqa: BLE001 - missing plate metadata only drops the times
        print(e)
        warnings.warn("WARNING: this position has no plate metadata, so the time metadata "
                      "will be missing.", stacklevel=2)
    results = {}
    for input_position_dirpath in input_position_dirpaths:
        reader = open_ome_zarr(input_position_dirpath)
        well_name = "/".join(Path(input_position_dirpath).parts[-3:])
        tczyx_data = reader["0"]
        print(f"Generating bleaching curves for position {well_name}")
        T = tczyx_data.shape[0]
        try:
            dt = np.float32(plate_zattrs["Summary"]["Interval_ms"] / MSECS_PER_MINUTE)
        except Exception as e:  # noqa: BLE001
            print(e)
            warnings.warn(f"WARNING: missing time metadata for p={well_name}", stacklevel=2)
            dt = 1
        times = np.arange(0, T * dt, step=dt)
        output_file = os.path.join(output_dirpath, well_name)
        os.makedirs(output_file, exist_ok=True)
        title = str(input_position_dirpath) + f" - position = {well_name}"
        means, stds, fits = plot_bleaching_curves(
            times, tczyx_data, reader.channel_names,
            os.path.join(output_file, "bleaching.svg"), title, device)
        results[well_name] = (times, means, stds, fits)
    return results
