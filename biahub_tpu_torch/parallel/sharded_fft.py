"""One volume's deconvolution spread over a mesh: the sharded FFT.

Counterpart of ``biahub_tpu/parallel/sharded_fft.py``, the
distributed-transpose FFT decomposition on kernels A, B (or Bc) and C of
:mod:`biahub_tpu_torch.kernels.fft`:

- **pass A** (``fwd_yx``) on each device's (Z/n, Y, X) z-slab;
- **exchange 1** (:func:`to_ky_rows`): each slab's (Z/n, Y, X//2+1)
  spectrum, packed as (n, Z/n, Y/n, X//2+1), sends piece j to shard j,
  whose receive buffer is then its contiguous (Z, Y/n, X//2+1) ky rows;
- **pass B** (``z_filter_``, or ``z_filter_complex_`` for a complex
  filter) on each shard's ky rows over the full global Z, in place;
- **exchange 2** (:func:`to_z_slabs`): each shard's rows, split along Z
  (already contiguous), go back to the slabs, unpacked to (Z/n, Y,
  X//2+1);
- **pass C** (``inv_yx``) on each slab.

The reference runs its passes' Pallas bodies on each shard under
``shard_map`` with ``all_to_all`` collectives; here a shard is a place on a
:class:`~biahub_tpu_torch.parallel.mesh.Mesh` device, the kernels launch
on that device's current stream, and the pieces move with ``copy_`` (peer
copies between cards, which torch orders against both devices' streams).
Every z slice (A, C) and every (ky, kx) column (B) is transformed alone, so
the result is bit-equal to the unsharded A -> B -> C route. The
reference's Nyquist peel and radix layouts exist for the MXU and are not
carried over.

The mesh is one process's devices, as the reference's (its deconvolve verb
shards over ``jax.local_devices()``); a process group spanning processes is
not a transport here.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from biahub_tpu_torch.device import as_tensor
from biahub_tpu_torch.kernels.fft import (
    PASS_A_DTYPES,
    fwd_yx,
    half_spectrum_shape,
    inv_yx,
    max_axis,
    prepare_fourier_filter,
    z_filter_,
    z_filter_complex_,
)
from biahub_tpu_torch.parallel.mesh import Mesh

__all__ = [
    "ShardedFilter",
    "deconvolve_zyx_sharded",
    "fourier_filter_zyx_sharded",
    "gather",
    "prepare_sharded_filter",
    "shard_filter",
    "sharded_fft_supported",
    "to_ky_rows",
    "to_z_slabs",
]


def sharded_fft_supported(shape, n_devices: int, device: str | torch.device = "cuda") -> bool:
    """True when a (Z, Y, X) volume shards over ``n_devices``: Z and Y
    divisible by it, every axis at least 2 and, on the card, within the
    kernels' limits (:func:`~biahub_tpu_torch.kernels.fft.max_axis` for Y
    and X, which A and C transform, and for Z, which B transforms whole;
    Y / n rows within B's grid)."""
    z, y, x = (int(s) for s in shape)
    if n_devices < 1 or z % n_devices or y % n_devices or min(z, y, x) < 2:
        return False
    if torch.device(device).type == "cuda":
        return all(s <= max_axis(s) for s in (z, y, x))
    return True


@dataclass(frozen=True)
class ShardedFilter:
    """A prepared filter cut into each shard's ky rows: ``shards[j]`` is the
    contiguous (Z, Y/n, X//2+1) slice of rows j*Y/n to (j+1)*Y/n on
    ``mesh.devices[j]``, float32 (Tikhonov, kernel B) or complex64
    (Hermitian, kernel Bc). Built once per mesh, shape and filter and
    passed to every call, as the reference caches its program
    (``sharded_fft.py:143-172``)."""

    mesh: Mesh
    shape: tuple[int, int, int]
    shards: tuple[torch.Tensor, ...]


def _check_shards(shape, mesh: Mesh) -> tuple[int, int, int]:
    """(Z/n, Y/n, X//2+1) of a volume of ``shape`` on ``mesh``, or raise."""
    n = mesh.size
    if not sharded_fft_supported(shape, n, mesh.devices[0]):
        raise ValueError(
            f"volume {tuple(shape)} does not shard over {n} devices: Z and Y must be "
            "divisible by the mesh size and every axis within the kernels' limits"
        )
    z, y, x = shape
    return z // n, y // n, x // 2 + 1


def _rows(j: int, y_l: int) -> slice:
    return slice(j * y_l, (j + 1) * y_l)


def prepare_sharded_filter(shape, transfer_function_half, regularization_strength,
                           mesh: Mesh) -> ShardedFilter:
    """The Tikhonov filter ``tf / (tf*tf + reg)`` (as :func:`~biahub_tpu_
    torch.kernels.fft.prepare_fourier_filter`, elementwise, so bit-equal to
    it) of each shard's ky rows, formed on the shard's device: no device
    holds the whole filter."""
    shape = tuple(int(s) for s in shape)
    _, y_l, _ = _check_shards(shape, mesh)
    tf = transfer_function_half
    if tuple(tf.shape) != half_spectrum_shape(shape):
        raise ValueError(f"transfer function half {tuple(tf.shape)} does not match volume "
                         f"shape {shape} (want {half_spectrum_shape(shape)})")
    z, _, x = shape
    return ShardedFilter(mesh, shape, tuple(
        prepare_fourier_filter((z, y_l, x), tf[:, _rows(j, y_l)], regularization_strength, dev)
        for j, dev in enumerate(mesh.devices)))


def shard_filter(filt, shape, mesh: Mesh) -> ShardedFilter:
    """Each shard's ky rows of a prepared (Z, Y, X//2+1) filter (float32,
    or the complex64 of :func:`~biahub_tpu_torch.kernels.fft.
    prepare_hermitian_filter`), copied to the shard's device."""
    shape = tuple(int(s) for s in shape)
    _, y_l, _ = _check_shards(shape, mesh)
    filt = torch.from_numpy(np.asarray(filt)) if not isinstance(filt, torch.Tensor) else filt
    if tuple(filt.shape) != half_spectrum_shape(shape):
        raise ValueError(f"filter {tuple(filt.shape)} does not match volume shape {shape}")
    return ShardedFilter(mesh, shape, tuple(
        filt[:, _rows(j, y_l)].to(dev).contiguous() for j, dev in enumerate(mesh.devices)))


def to_ky_rows(spectra: list[torch.Tensor]) -> list[torch.Tensor]:
    """Exchange 1: the n slabs' (Z/n, Y, X//2+1) spectra to each shard's
    contiguous (Z, Y/n, X//2+1) ky rows, on the device of its slab."""
    n = len(spectra)
    z_l, y, xh = spectra[0].shape
    y_l = y // n
    packed = [s.view(z_l, n, y_l, xh).permute(1, 0, 2, 3).contiguous() for s in spectra]
    rows = [torch.empty((n * z_l, y_l, xh), dtype=torch.complex64, device=s.device)
            for s in spectra]
    for i, r in enumerate(rows):
        for j, p in enumerate(packed):
            r[j * z_l:(j + 1) * z_l].copy_(p[i], non_blocking=True)
    return rows


def to_z_slabs(rows: list[torch.Tensor], spectra: list[torch.Tensor]) -> None:
    """Exchange 2: each shard's (Z, Y/n, X//2+1) rows back into the slabs'
    (Z/n, Y, X//2+1) spectra, in place."""
    n = len(rows)
    z_l, y, xh = spectra[0].shape
    y_l = y // n
    for j, s in enumerate(spectra):
        back = torch.empty((n, z_l, y_l, xh), dtype=torch.complex64, device=s.device)
        for i, r in enumerate(rows):
            back[i].copy_(r[j * z_l:(j + 1) * z_l], non_blocking=True)
        s.view(z_l, n, y_l, xh).copy_(back.permute(1, 0, 2, 3))


def _run_sharded(volume, prepared: ShardedFilter, mesh: Mesh,
                 z_filter) -> list[torch.Tensor]:
    """Passes A, exchange 1, B (``z_filter``), exchange 2, C; one float32
    (Z/n, Y, X) slab per mesh device."""
    shape = tuple(int(s) for s in volume.shape)
    if len(shape) != 3 or shape != prepared.shape or prepared.mesh != mesh:
        raise ValueError(f"volume {tuple(volume.shape)} on {mesh} for a filter prepared "
                         f"for {prepared.shape} on {prepared.mesh}")
    z_l, _, _ = _check_shards(shape, mesh)
    # Each z-slab to its device as it is (uint16 stays: A reads it exactly);
    # on the volume's own device a slab is a view, no copy.
    slabs = [as_tensor(volume[j * z_l:(j + 1) * z_l], dev, dtypes=PASS_A_DTYPES)
             for j, dev in enumerate(mesh.devices)]
    spectra = [fwd_yx(s) for s in slabs]
    rows = to_ky_rows(spectra)
    for r, f in zip(rows, prepared.shards):
        z_filter(r, f)
    to_z_slabs(rows, spectra)
    return [inv_yx(s, out=torch.empty(sl.shape, dtype=torch.float32, device=sl.device))
            for s, sl in zip(spectra, slabs)]


def deconvolve_zyx_sharded(volume, transfer_function_half, mesh: Mesh,
                           regularization_strength: float = 1e-3,
                           prepared: ShardedFilter | None = None) -> list[torch.Tensor]:
    """Tikhonov-deconvolve one (Z, Y, X) volume sharded over ``mesh``:
    one float32 (Z/n, Y, X) z-slab per mesh device (:func:`gather` joins
    them). ``prepared``: a :func:`prepare_sharded_filter` result, which
    callers hoist out of a loop over volumes (then the TF may be None).
    Raises ``ValueError`` for a shape that does not shard."""
    if prepared is None:
        prepared = prepare_sharded_filter(tuple(volume.shape), transfer_function_half,
                                          regularization_strength, mesh)
    return _run_sharded(volume, prepared, mesh, z_filter_)


def fourier_filter_zyx_sharded(volume, filt, mesh: Mesh) -> list[torch.Tensor]:
    """``irfftn(rfftn(volume) * filt)`` sharded over ``mesh`` (kernels A, Bc
    and C), with ``filt`` the complex64 (Z, Y, X//2+1) half of
    :func:`~biahub_tpu_torch.kernels.fft.prepare_hermitian_filter` or its
    :func:`shard_filter`; one float32 z-slab per mesh device. The sharded
    counterpart of :func:`~biahub_tpu_torch.kernels.fft.fourier_filter_zyx`
    (the reference takes the filter's real and imaginary halves apart)."""
    if not isinstance(filt, ShardedFilter):
        filt = shard_filter(filt, tuple(volume.shape), mesh)
    return _run_sharded(volume, filt, mesh, z_filter_complex_)


def gather(slabs: list[torch.Tensor], device: str | torch.device) -> torch.Tensor:
    """The z-slabs of a sharded result joined into one (Z, Y, X) volume on
    ``device``."""
    return torch.cat([s.to(device) for s in slabs])
