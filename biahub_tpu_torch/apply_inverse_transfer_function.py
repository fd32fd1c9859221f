"""apply-inv-tf on arrays: reconstruct each timepoint of a TCZYX stack.

Counterpart of ``biahub_tpu/apply_inverse_transfer_function.py`` without
its plates and batch runner: ``_make_recon_kernel`` (:59-110), the
``time_indices`` selection (:128-133) and the refusals of a missing
transfer function (:169-178). Per timepoint, on the input channels in the
settings' order: birefringence by Stokes inversion (torch), phase as the
Tikhonov inverse of ``czyx[0] / mean - 1`` through the WOTF, fluorescence
as the Tikhonov inverse of every input channel through the OTF. Each
inverse is one run of kernels A, Bc and C; the filters are prepared once
per call. Outputs are ordered birefringence (4), phase (1), fluorescence
(C), as :func:`~biahub_tpu_torch.recon.settings.output_channel_names`
names them.
"""

from __future__ import annotations

import torch

from biahub_tpu_torch.convert import reconstruction_settings_from_reference
from biahub_tpu_torch.device import as_tensor, resolve_device
from biahub_tpu_torch.kernels import fft as kfft
from biahub_tpu_torch.recon.birefringence import (
    birefringence_from_stokes,
    stokes_from_intensities,
)
from biahub_tpu_torch.recon.settings import output_channel_names

__all__ = ["apply_inverse_transfer_function_arrays", "time_indices"]


def time_indices(settings: dict, n_time: int) -> list[int]:
    """The timepoints a validated settings dict selects from ``n_time``."""
    sel = settings["time_indices"]
    if sel == "all":
        return list(range(n_time))
    return list(sel) if isinstance(sel, list) else [sel]


def _check_transfer_functions(settings: dict, tfs: dict) -> None:
    if settings["phase"] is not None and "phase" not in tfs:
        raise ValueError(
            "Config requests phase reconstruction but the transfer function store "
            "has no phase transfer function; re-run compute-tf with this config."
        )
    if settings["fluorescence"] is not None and "fluorescence" not in tfs:
        raise ValueError(
            "Config requests fluorescence deconvolution but the transfer function "
            "store has no fluorescence OTF; re-run compute-tf with this config."
        )


def _make_recon_kernel(settings: dict, tfs: dict, zyx_shape, dev: torch.device):
    """``kernel(czyx, out)``: the input channels of one timepoint (float32
    on ``dev``) into ``out`` (C_out, Z, Y, X)."""
    biref = settings["birefringence"]
    filters = {
        name: kfft.prepare_hermitian_filter(
            zyx_shape, tfs[name],
            settings[name]["apply_inverse"]["regularization_strength"], dev)
        for name in ("phase", "fluorescence") if settings[name] is not None
    }

    def kernel(czyx: torch.Tensor, out: torch.Tensor) -> None:
        k = 0
        if biref is not None:
            inverse = biref["apply_inverse"]
            stokes = stokes_from_intensities(czyx, biref["transfer_function"]["swing"])
            out[:4] = birefringence_from_stokes(
                stokes,
                wavelength_illumination=inverse["wavelength_illumination"],
                flip_orientation=inverse["flip_orientation"],
                rotate_orientation=inverse["rotate_orientation"],
            )
            k = 4
        if "phase" in filters:
            bf = czyx[0]
            i_norm = bf / (torch.mean(bf) + 1e-12) - 1.0
            kfft.fourier_filter_zyx(i_norm, filters["phase"], out=out[k])
            k += 1
        if "fluorescence" in filters:
            for c in range(czyx.shape[0]):
                kfft.fourier_filter_zyx(czyx[c], filters["fluorescence"], out=out[k + c])

    return kernel


def apply_inverse_transfer_function_arrays(
    tczyx,
    channel_names: list[str],
    tfs: dict,
    settings: dict,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """Reconstruct the selected timepoints of ``tczyx`` (numpy or tensor,
    any real dtype; uint16 converts to float32 exactly) whose channels are
    ``channel_names``, with the transfer functions ``tfs`` (``{"phase": H,
    "fluorescence": otf}``, complex (Z, Y, X), as compute-tf makes them) and
    a reconstruction settings dict. Returns (T_sel, C_out, Z, Y, X) float32
    on ``device``."""
    s = reconstruction_settings_from_reference(settings)
    _check_transfer_functions(s, tfs)
    dev = resolve_device(device)
    idx = [list(channel_names).index(name) for name in s["input_channel_names"]]
    times = time_indices(s, tczyx.shape[0])
    zyx_shape = tuple(int(v) for v in tczyx.shape[2:])
    kernel = _make_recon_kernel(s, tfs, zyx_shape, dev)
    out = torch.empty((len(times), len(output_channel_names(s))) + zyx_shape,
                      dtype=torch.float32, device=dev)
    for i, t in enumerate(times):
        kernel(as_tensor(tczyx[t], dev)[idx], out[i])
    return out
