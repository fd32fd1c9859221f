"""compute-tf: the reconstruction transfer functions of a volume shape.

Counterpart of ``biahub_tpu/compute_transfer_function.py``: on arrays,
:func:`compute_transfer_function_arrays` gives the transfer functions on
the device, as apply-inv-tf's loader
(:func:`~biahub_tpu_torch.apply_inverse_transfer_function.
_load_transfer_functions`) reads them back from the store; the verb,
:func:`compute_transfer_function` (:24-89), writes that store: an HCS plate
with one position ``0/0/0`` holding the real and imaginary parts as float32
channels (``phase_tf_real``, ``phase_tf_imag``, ``fluor_otf_real``,
``fluor_otf_imag``), at the input's scale, with the settings as its
``biahub-compute-tf`` attribute. Birefringence needs no transfer function:
its store holds one ``identity`` channel of ones, which the loader drops.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from biahub_tpu_torch.cli.utils import yaml_to_model
from biahub_tpu_torch.convert import (
    reconstruction_settings_dump,
    reconstruction_settings_from_reference,
)
from biahub_tpu_torch.device import resolve_device
from biahub_tpu_torch.io.ngff import TransformationMeta, open_ome_zarr
from biahub_tpu_torch.recon.optics import fluorescence_otf_3d, phase_wotf_3d

__all__ = ["compute_transfer_function_arrays", "compute_transfer_function"]

# The store's channels of each transfer function, real part then imaginary.
TF_CHANNELS = {"phase": ("phase_tf_real", "phase_tf_imag"),
               "fluorescence": ("fluor_otf_real", "fluor_otf_imag")}


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


def compute_transfer_function(
    input_position_dirpath: Path,
    config_filepath: Path,
    output_dirpath: Path,
    device: str | torch.device = "cuda",
) -> None:
    """The compute-tf verb: the transfer functions of the input position's
    ZYX shape, written to the store at ``output_dirpath`` (module
    docstring)."""
    settings = yaml_to_model(config_filepath, reconstruction_settings_dump)
    input_position = open_ome_zarr(input_position_dirpath, mode="r")
    T, C, Z, Y, X = input_position.data.shape
    tfs = compute_transfer_function_arrays((Z, Y, X), settings, device)
    channels, arrays = [], []
    for name, tf in tfs.items():
        host = tf.cpu().numpy()
        channels += TF_CHANNELS[name]
        arrays += [host.real.astype(np.float32), host.imag.astype(np.float32)]
    if not channels:
        channels, arrays = ["identity"], [np.ones((Z, Y, X), dtype=np.float32)]
    plate = open_ome_zarr(output_dirpath, layout="hcs", mode="w", channel_names=channels)
    pos = plate.create_position("0", "0", "0")
    pos.create_image("0", np.stack(arrays)[None],
                     transform=[TransformationMeta(type="scale", scale=input_position.scale)])
    pos.update_zattrs({"biahub-compute-tf": settings})
