"""deconvolve on arrays in memory: the verb's compute without its plates.

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

The OME-Zarr plates (input, output and ``transfer_function.zarr``) wait for
the port's I/O layer: the transfer function is returned for the caller to
store.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from biahub_tpu_torch.convert import deconvolve_settings_from_reference
from biahub_tpu_torch.device import resolve_device
from biahub_tpu_torch.kernels.deconvolve import compute_transfer_function, deconvolve_zyx
from biahub_tpu_torch.kernels.fft import prepare_fourier_filter
from biahub_tpu_torch.parallel.mesh import Mesh, get_mesh
from biahub_tpu_torch.parallel.sharded_fft import (
    deconvolve_zyx_sharded,
    gather,
    prepare_sharded_filter,
    sharded_fft_supported,
)
from biahub_tpu_torch.runtime.executor import stripe_units

__all__ = ["deconvolve_arrays"]


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
