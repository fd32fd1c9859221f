"""The deconvolve verb, on arrays in memory and on plates.

Counterpart of ``biahub_tpu/deconvolve.py`` (:47-203): the PSF's transfer
function for the plate's ZYX shape, then the Tikhonov inverse filter of
every (position, t, c) volume, on one of two routes:

- **batched** (the default): each volume through
  :func:`~biahub_tpu_torch.kernels.deconvolve.deconvolve_zyx` (kernels A,
  B, C) with the filter prepared once (:110-120);
- **sharded** (``sharded=True``, the reference's
  ``BIAHUB_TPU_SHARDED_FFT=1``, :148-193): each volume spread over a mesh
  of more than one shard (:func:`~biahub_tpu_torch.parallel.sharded_fft.
  deconvolve_zyx_sharded`) when its shape shards over the mesh (:155-159;
  else the batched route, as the reference's ``else`` at :204), the units
  taken in the reference's order and striped over processes
  (:func:`~biahub_tpu_torch.runtime.executor.stripe_units`).

:func:`deconvolve_arrays` returns the transfer function for the caller to
store; :func:`deconvolve` is the verb on plates: it writes
``transfer_function.zarr`` beside the output plate and runs the batched
route through the batch runner, each batch split over ``mesh`` (default:
every card), or, under the reference's
``BIAHUB_TPU_SHARDED_FFT=1`` with a mesh of more than one shard
(``mesh=``, default :func:`~biahub_tpu_torch.parallel.mesh.get_mesh`: every
card) over which the volume's shape shards, the sharded route (:160-203):
the units in the reference's (position, t, c) order, striped over
processes, the next volume read while the mesh computes the current one,
the writes draining asynchronously.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

import numpy as np
import torch

from biahub_tpu_torch.cli.utils import get_output_paths, yaml_to_model
from biahub_tpu_torch.convert import deconvolve_settings_from_reference
from biahub_tpu_torch.device import resolve_device
from biahub_tpu_torch.io.ngff import (
    TransformationMeta,
    create_empty_plate,
    get_ome_zarr_version,
    open_ome_zarr,
)
from biahub_tpu_torch.kernels.deconvolve import compute_transfer_function, deconvolve_zyx
from biahub_tpu_torch.kernels.fft import prepare_fourier_filter
from biahub_tpu_torch.parallel.mesh import Mesh, get_mesh
from biahub_tpu_torch.parallel.sharded_fft import (
    deconvolve_zyx_sharded,
    gather,
    prepare_sharded_filter,
    sharded_fft_supported,
)
from biahub_tpu_torch.runtime.executor import BatchRunner, resolve_cluster, stripe_units
from biahub_tpu_torch.runtime.resources import echo_resources, estimate_resources

__all__ = ["deconvolve_arrays", "deconvolve"]


def deconvolve_arrays(
    positions: dict,
    psf_zyx,
    psf_scale,
    settings: dict,
    mesh: Mesh | None = None,
    sharded: bool = False,
    device: str | torch.device = "cuda",
) -> tuple[dict[str, torch.Tensor], np.ndarray]:
    """Deconvolve every (t, c) volume of ``positions`` (``{fov:
    position-like}``, e.g. :class:`~biahub_tpu_torch.estimate_stabilization.
    ArrayPosition`, all of the first one's shape) with the PSF ``psf_zyx``
    of voxel size ``psf_scale`` and a ``DeconvolveSettings`` dict.

    Returns ``{fov: (T, C, Z, Y, X) float32 on device}`` and the (Z, Y, X)
    float32 transfer function the verb writes to ``transfer_function.zarr``.
    ``sharded=True`` shards each volume over ``mesh`` (default: every card,
    :func:`~biahub_tpu_torch.parallel.mesh.get_mesh`); a mesh of one shard
    takes the batched route and says so on stderr, as does a shape that
    does not shard over it (:func:`~biahub_tpu_torch.parallel.sharded_fft.
    sharded_fft_supported`). In a multi-process run each process
    computes its stripe of the units; the others stay zero.
    """
    dev = resolve_device(device)
    reg = deconvolve_settings_from_reference(settings)["regularization_strength"]
    first = next(iter(positions.values()))
    T, C, Z, Y, X = (int(n) for n in first.data.shape)
    scale = list(first.scale)
    if scale[-3:] != list(psf_scale)[-3:]:
        print(f"Warning: PSF scale: {list(psf_scale)[-3:]} does not match data scale: "
              f"{scale[-3:]}. Consider resampling the PSF.")
    transfer_function = compute_transfer_function(np.asarray(psf_zyx), (Z, Y, X))
    tf_half = transfer_function[..., : X // 2 + 1]

    if sharded:
        mesh = mesh if mesh is not None else get_mesh(device=dev)
        if mesh.size == 1:
            print("deconvolve: a mesh of one shard; each volume takes the batched route",
                  file=sys.stderr)
            sharded = False
        elif not sharded_fft_supported((Z, Y, X), mesh.size, mesh.devices[0]):
            print(f"deconvolve: {(Z, Y, X)} does not shard over {mesh.size} devices; each "
                  "volume takes the batched route", file=sys.stderr)
            sharded = False
    units = stripe_units([(fov, t, c) for fov in positions for t in range(T)
                          for c in range(C)])
    out = {fov: torch.zeros((T, C, Z, Y, X), dtype=torch.float32, device=dev)
           for fov in positions}
    if sharded:
        prepared = prepare_sharded_filter((Z, Y, X), tf_half, reg, mesh)
        print(f"sharded FFT: each volume sharded over {mesh.size} devices")
        for fov, t, c in units:
            slabs = deconvolve_zyx_sharded(positions[fov].data[t, c], None, mesh,
                                           prepared=prepared)
            out[fov][t, c] = gather(slabs, dev)
    else:
        filt = prepare_fourier_filter((Z, Y, X), tf_half, reg, dev)
        for fov, t, c in units:
            out[fov][t, c] = deconvolve_zyx(positions[fov].data[t, c], prepared=filt,
                                            device=dev)
    print(f"Deconvolved {len(units)} (t, c) volumes across {len(positions)} positions")
    return out, transfer_function


def deconvolve(
    input_position_dirpaths: list[Path],
    psf_dirpath: Path,
    config_filepath: Path,
    output_dirpath: Path,
    sbatch_filepath: str | None = None,
    local: bool = False,
    monitor: bool = True,
    device: str | torch.device = "cuda",
    mesh: Mesh | None = None,
) -> None:
    """The deconvolve verb on plates (the reference's ``deconvolve``,
    :45-213): the output plate, the transfer function of
    ``psf.zarr/0/0/0`` written to ``transfer_function.zarr`` (a FOV store
    beside the output, the PSF's scale), then every (t, c) volume through
    kernels A, B, C in device batches split over ``mesh`` (default: every
    card, or the CPU for ``device="cpu"``), uint16 volumes sent as they
    are; under ``BIAHUB_TPU_SHARDED_FFT=1`` each volume sharded over
    ``mesh`` (default: every card) when it has more than one shard and the
    shape shards over it (:func:`_deconvolve_sharded`)."""
    dev = resolve_device(device)
    output_dirpath = Path(output_dirpath)
    output_position_paths = get_output_paths(input_position_dirpaths, output_dirpath)
    settings = yaml_to_model(config_filepath, deconvolve_settings_from_reference)
    input_dataset = open_ome_zarr(str(input_position_dirpaths[0]), mode="r")
    shape = input_dataset.data.shape
    scale = input_dataset.scale
    T, C, Z, Y, X = shape
    print("Creating empty output zarr...")
    create_empty_plate(
        store_path=output_dirpath,
        position_keys=[Path(p).parts[-3:] for p in input_position_dirpaths],
        channel_names=input_dataset.channel_names,
        shape=shape,
        scale=scale,
        version=settings["output_ome_zarr_version"] or get_ome_zarr_version(
            Path(input_position_dirpaths[0]).parents[2]),
    )
    print("Computing transfer function...")
    psf_dataset = open_ome_zarr(Path(psf_dirpath, "0/0/0"), mode="r")
    if list(scale[-3:]) != list(psf_dataset.scale[-3:]):
        print(f"Warning: PSF scale: {psf_dataset.scale[-3:]} does not match data "
              f"scale: {scale[-3:]}. Consider resampling the PSF.")
    transfer_function = compute_transfer_function(psf_dataset.data[0, 0], (Z, Y, X))
    tf_store = open_ome_zarr(output_dirpath.parent / "transfer_function.zarr", layout="fov",
                             mode="w", channel_names=["PSF"])
    tf_store.create_image("0", transfer_function[None, None],
                          chunks=(1, 1, min(Z, 256), Y, X),
                          transform=[TransformationMeta(type="scale", scale=psf_dataset.scale)])
    _, num_cpus, gb_ram_per_cpu = estimate_resources(shape=(T, C, Z, Y, X), ram_multiplier=16,
                                                     max_num_cpus=16)
    echo_resources(num_cpus, num_cpus * gb_ram_per_cpu, 60)
    resolved = resolve_cluster(None, local)
    print(f"Running on-device batches (mode='{resolved}')")
    input_positions = [open_ome_zarr(p, mode="r") for p in input_position_dirpaths]
    output_positions = [open_ome_zarr(p, mode="r+") for p in output_position_paths]
    for out_pos in output_positions:
        out_pos.update_zattrs({"biahub-deconvolve": settings})
    tf_half = transfer_function[..., : X // 2 + 1]
    if os.environ.get("BIAHUB_TPU_SHARDED_FFT") == "1":
        mesh = mesh if mesh is not None else get_mesh(device=dev)
        if mesh.size > 1 and sharded_fft_supported((Z, Y, X), mesh.size, mesh.devices[0]):
            _deconvolve_sharded(input_positions, output_positions, tf_half,
                                settings["regularization_strength"], mesh)
            return
    runner = BatchRunner(cluster=resolved, device=dev, mesh=mesh)
    filt = prepare_fourier_filter((Z, Y, X), tf_half, settings["regularization_strength"],
                                  runner.device)

    def kernel(vols: torch.Tensor, filt: torch.Tensor) -> torch.Tensor:
        return torch.stack([deconvolve_zyx(v, prepared=filt, device=vols.device)
                            for v in vols])

    # Kernel A reads uint16 itself.
    kernel.native_ingest_dtypes = ("uint16",)
    # The reference's batch plan (input and output, no workspace); the
    # filter copied once to each device of the mesh.
    n = runner.run_zyx(kernel, input_positions, output_positions,
                       monitor=monitor and resolved != "debug", broadcast_params={"filt": filt})
    print(f"Deconvolved {n} (t, c) volumes across {len(input_positions)} positions")
    runner.echo_stats()


def _deconvolve_sharded(input_positions: list, output_positions: list, tf_half: np.ndarray,
                        regularization_strength: float, mesh: Mesh) -> None:
    """The sharded route on plates (the reference's :160-203): every
    (position, t, c) volume of this process's stripe through
    :func:`~biahub_tpu_torch.parallel.sharded_fft.deconvolve_zyx_sharded`
    over ``mesh``, with the next volume's read started before the current
    one is computed and the writes left to drain until the end."""
    T, C, Z, Y, X = input_positions[0].data.shape
    print(f"BIAHUB_TPU_SHARDED_FFT: each volume sharded over {mesh.size} local devices "
          "(per-volume spatial parallelism; the batch executor's job table is not "
          "available on this path)")
    prepared = prepare_sharded_filter((Z, Y, X), tf_half, regularization_strength, mesh)
    units = stripe_units([(p_idx, t, c) for p_idx in range(len(input_positions))
                          for t in range(T) for c in range(C)])

    def start_read(unit):
        p_idx, t, c = unit
        return input_positions[p_idx].data.read_async((t, c))

    writes = []
    pending = start_read(units[0]) if units else None
    for i, (p_idx, t, c) in enumerate(units):
        vol = pending.result()
        pending = start_read(units[i + 1]) if i + 1 < len(units) else None
        slabs = deconvolve_zyx_sharded(vol, None, mesh, prepared=prepared)
        writes.append(output_positions[p_idx]["0"].write_async(
            (t, c), gather(slabs, "cpu").numpy()))
        print(f"  sharded deconvolve {i + 1}/{len(units)}", file=sys.stderr)
    for f in writes:
        f.result()
    print(f"Deconvolved {len(units)} (t, c) volumes across {len(input_positions)} positions")
