"""compute-tf on arrays: the reconstruction transfer functions of a volume
shape.

Counterpart of ``biahub_tpu/compute_transfer_function.py::
compute_transfer_function`` (:24-89) without its transfer-function store:
the arrays it writes there, as apply-inv-tf's ``_load_transfer_functions``
(apply_inverse_transfer_function.py:43-56) reads them back, on the device.
Birefringence needs none (the reference's store then holds an identity
channel, which the loader drops). Writing and reading the store waits on
the port's plate I/O.
"""

from __future__ import annotations

import torch

from biahub_tpu_torch.convert import reconstruction_settings_from_reference
from biahub_tpu_torch.device import resolve_device
from biahub_tpu_torch.recon.optics import fluorescence_otf_3d, phase_wotf_3d

__all__ = ["compute_transfer_function_arrays"]


def compute_transfer_function_arrays(
    zyx_shape: tuple[int, int, int],
    settings: dict,
    device: str | torch.device = "cuda",
) -> dict[str, torch.Tensor]:
    """``{"phase": H, "fluorescence": otf}`` for the modalities ``settings``
    (a reconstruction settings dict) configures: complex64 (Z, Y, X)
    tensors on ``device``, the phase WOTF and the fluorescence OTF."""
    s = reconstruction_settings_from_reference(settings)
    dev = resolve_device(device)
    shape = tuple(int(v) for v in zyx_shape)
    tfs: dict[str, torch.Tensor] = {}
    if s["phase"] is not None:
        tf = s["phase"]["transfer_function"]
        tfs["phase"] = phase_wotf_3d(
            shape,
            yx_pixel_size=tf["yx_pixel_size"],
            z_pixel_size=tf["z_pixel_size"],
            wavelength_illumination=tf["wavelength_illumination"],
            numerical_aperture_illumination=tf["numerical_aperture_illumination"],
            numerical_aperture_detection=tf["numerical_aperture_detection"],
            index_of_refraction_media=tf["index_of_refraction_media"],
            invert_phase_contrast=tf["invert_phase_contrast"],
            device=dev,
        )
    if s["fluorescence"] is not None:
        tf = s["fluorescence"]["transfer_function"]
        tfs["fluorescence"] = fluorescence_otf_3d(
            shape,
            yx_pixel_size=tf["yx_pixel_size"],
            z_pixel_size=tf["z_pixel_size"],
            wavelength_emission=tf["wavelength_emission"],
            numerical_aperture_detection=tf["numerical_aperture_detection"],
            index_of_refraction_media=tf["index_of_refraction_media"],
            device=dev,
        )
    return tfs
