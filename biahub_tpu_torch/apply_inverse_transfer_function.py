"""apply-inv-tf: reconstruct each timepoint of a TCZYX stack.

Counterpart of ``biahub_tpu/apply_inverse_transfer_function.py``: on
arrays, :func:`apply_inverse_transfer_function_arrays` (``_make_recon_kernel``,
:59-110, the ``time_indices`` selection, :128-133, and the refusals of a
missing transfer function, :169-178); on plates, the verb
:func:`apply_inverse_transfer_function` (:113-212), which reads the
transfer functions from compute-tf's store (:func:`_load_transfer_functions`)
and runs every (position, timepoint) through the batch runner, the recon
kernel applied to each volume of its (B, C, Z, Y, X) batches, so that the
plate equals the arrays function bit for bit. Per timepoint, on the input channels in the
settings' order: birefringence by Stokes inversion (torch), phase as the
Tikhonov inverse of ``czyx[0] / mean - 1`` through the WOTF, fluorescence
as the Tikhonov inverse of every input channel through the OTF. Each
inverse is one run of kernels A, Bc and C, or of ``torch.fft`` for a shape
the kernels do not take (``fft.deconvolve_limit``, decided and said on
stderr once per call); the filters are prepared once per call. Outputs are ordered birefringence (4), phase (1), fluorescence
(C), as :func:`~biahub_tpu_torch.recon.settings.output_channel_names`
names them.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from biahub_tpu_torch.cli.parsing import CommandError
from biahub_tpu_torch.cli.utils import PROVENANCE_METADATA_KEYS, get_output_paths, yaml_to_model
from biahub_tpu_torch.compute_transfer_function import TF_CHANNELS
from biahub_tpu_torch.convert import (
    reconstruction_settings_dump,
    reconstruction_settings_from_reference,
)
from biahub_tpu_torch.device import as_tensor, resolve_device
from biahub_tpu_torch.io.ngff import create_empty_plate, get_ome_zarr_version, open_ome_zarr
from biahub_tpu_torch.kernels import fft as kfft
from biahub_tpu_torch.parallel.mesh import Mesh
from biahub_tpu_torch.recon.birefringence import (
    birefringence_from_stokes,
    stokes_from_intensities,
)
from biahub_tpu_torch.recon.settings import output_channel_names
from biahub_tpu_torch.runtime.executor import BatchRunner, WorkUnit, resolve_cluster
from biahub_tpu_torch.runtime.resources import (
    echo_resources,
    estimate_resources,
    settings_fingerprint,
)

__all__ = ["apply_inverse_transfer_function_arrays", "apply_inverse_transfer_function",
           "time_indices"]


def time_indices(settings: dict, n_time: int) -> list[int]:
    """The timepoints a validated settings dict selects from ``n_time``."""
    sel = settings["time_indices"]
    if sel == "all":
        return list(range(n_time))
    return list(sel) if isinstance(sel, list) else [sel]


def _load_transfer_functions(transfer_function_dirpath: Path) -> dict[str, torch.Tensor]:
    """``{"phase": H, "fluorescence": otf}`` (complex64 CPU tensors) from
    compute-tf's store, the modalities it holds (reference :43-56)."""
    tf_pos = open_ome_zarr(Path(transfer_function_dirpath) / "0/0/0", mode="r")
    names = tf_pos.channel_names
    data = torch.from_numpy(np.asarray(tf_pos.data[0], dtype=np.float32))
    return {name: torch.complex(data[names.index(real)], data[names.index(imag)])
            for name, (real, imag) in TF_CHANNELS.items() if real in names}


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
    fourier_filter = kfft.fourier_filter_zyx
    if filters and kfft.takes_torch_fft("apply_inverse_transfer_function", zyx_shape):
        fourier_filter = kfft.filter_torch_fft

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
            fourier_filter(i_norm, filters["phase"], out=out[k])
            k += 1
        if "fluorescence" in filters:
            for c in range(czyx.shape[0]):
                fourier_filter(czyx[c], filters["fluorescence"], out=out[k + c])

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


def apply_inverse_transfer_function(
    input_position_dirpaths: list[Path],
    transfer_function_dirpath: Path,
    config_filepath: Path,
    output_dirpath: Path,
    sbatch_filepath: str | None = None,
    cluster: str = "slurm",
    monitor: bool = True,
    init_only: bool = False,
    device: str | torch.device = "cuda",
    mesh: Mesh | None = None,
) -> None:
    """The apply-inv-tf verb on plates (module docstring): a float32 output
    plate of the selected timepoints and the reconstructed channels, with
    the input's scale, provenance and the ``biahub-reconstruct`` attribute,
    in device batches split over ``mesh`` (default: every card);
    ``init_only`` creates it and computes nothing."""
    dev = resolve_device(device)
    output_dirpath = Path(output_dirpath)
    settings = yaml_to_model(config_filepath, reconstruction_settings_dump)
    input_dataset = open_ome_zarr(str(input_position_dirpaths[0]), mode="r")
    input_shape = input_dataset.data.shape
    T, C, Z, Y, X = input_shape
    all_channel_names = input_dataset.channel_names
    output_channels = output_channel_names(settings)
    times = time_indices(settings, T)
    input_plate = Path(input_position_dirpaths[0]).parents[2]
    create_empty_plate(
        store_path=output_dirpath,
        position_keys=[Path(p).parts[-3:] for p in input_position_dirpaths],
        channel_names=output_channels,
        shape=(len(times), len(output_channels), Z, Y, X),
        scale=input_dataset.scale,
        dtype=np.float32,
        version=get_ome_zarr_version(input_plate),
        metadata_sources=input_plate,
        metadata_keys=PROVENANCE_METADATA_KEYS,
    )
    time_minutes, num_cpus, gb_ram_per_cpu = estimate_resources(
        shape=input_shape, ram_multiplier=16, time_multiplier=3.0, max_num_cpus=16)
    echo_resources(num_cpus, num_cpus * gb_ram_per_cpu, time_minutes)
    if init_only:
        print(f"Initialized {output_dirpath} ({len(input_position_dirpaths)} positions)")
        return

    tfs = _load_transfer_functions(transfer_function_dirpath)
    try:
        _check_transfer_functions(settings, tfs)
    except ValueError as exc:
        raise CommandError(str(exc)) from None
    resolved = resolve_cluster(cluster=cluster)
    print(f"Running on-device batches (mode='{resolved}')")
    runner = BatchRunner(cluster=resolved, device=dev, mesh=mesh)
    # The prepared filters once for each device of the mesh.
    recons = {d: _make_recon_kernel(settings, tfs, (Z, Y, X), d) for d in runner.devices}
    n_out = len(output_channels)

    def kernel(vols: torch.Tensor) -> torch.Tensor:
        out = torch.empty((vols.shape[0], n_out, Z, Y, X), dtype=torch.float32,
                          device=vols.device)
        for czyx, o in zip(vols, out):
            recons[vols.device](czyx, o)
        return out

    input_channels = tuple(all_channel_names.index(n) for n in settings["input_channel_names"])
    input_positions = [open_ome_zarr(p, mode="r") for p in input_position_dirpaths]
    output_positions = [open_ome_zarr(p, mode="r+")
                        for p in get_output_paths(input_position_dirpaths, output_dirpath)]
    for out_pos in output_positions:
        out_pos.update_zattrs({"biahub-reconstruct": settings})
    units = [WorkUnit(p_idx, int(t), input_channels, tuple(range(n_out)), t_out)
             for p_idx in range(len(input_positions)) for t_out, t in enumerate(times)]
    n = runner.run_units(kernel, units, input_positions, output_positions, resume=False,
                         resume_token=settings_fingerprint(settings),
                         monitor=monitor and resolved != "debug")
    print(f"Reconstructed {n} timepoints across {len(input_positions)} positions")
    for path in input_position_dirpaths:
        print(f"Reconstruction complete: {path}")
    runner.echo_stats()
