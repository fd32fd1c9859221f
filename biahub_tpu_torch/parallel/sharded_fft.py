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

The mesh is one process's devices (:class:`~biahub_tpu_torch.parallel.mesh.
Mesh`, as the reference's deconvolve verb shards over
``jax.local_devices()``), or a :class:`~biahub_tpu_torch.parallel.mesh.
GlobalMesh` that spans the processes of a started group, as the reference's
global mesh does (its ``scripts/multihost_fft_worker.py``). On a global
mesh of P processes each rank passes its own (Z/P, Y, X) rows of the volume
and gets back its own z-slabs; global shard ``p * L + i`` is local shard i
of rank p, and the exchanges move the pieces between ranks with one
:func:`~biahub_tpu_torch.parallel.distributed.all_to_all` each (NCCL for
cards, gloo for CPU tensors), staged on the rank's first device, and
between a rank's own devices with peer copies. The result is the same bits
either way.
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
from biahub_tpu_torch.parallel.distributed import all_to_all
from biahub_tpu_torch.parallel.mesh import GlobalMesh, Mesh

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
    """A prepared filter cut into each shard's ky rows: ``shards[k]`` is the
    contiguous (Z, Y/n, X//2+1) slice of rows j*Y/n to (j+1)*Y/n, j the
    global index of local shard k, on its device; float32 (Tikhonov, kernel
    B) or complex64 (Hermitian, kernel Bc). ``shape`` is the whole
    volume's. Built once per mesh, shape and filter and passed to every
    call, as the reference caches its program (``sharded_fft.py:143-172``)."""

    mesh: Mesh | GlobalMesh
    shape: tuple[int, int, int]
    shards: tuple[torch.Tensor, ...]


def _local(mesh: Mesh | GlobalMesh) -> Mesh:
    """This process's shards of ``mesh``."""
    return mesh.local if isinstance(mesh, GlobalMesh) else mesh


def _spans_processes(mesh: Mesh | GlobalMesh) -> bool:
    return isinstance(mesh, GlobalMesh) and mesh.processes > 1


def _global_index(mesh: Mesh | GlobalMesh, k: int) -> int:
    """The global index of local shard ``k``."""
    return (mesh.first_shard if isinstance(mesh, GlobalMesh) else 0) + k


def _check_shards(shape, mesh: Mesh | GlobalMesh) -> tuple[int, int, int]:
    """(Z/n, Y/n, X//2+1) of a volume of ``shape`` on ``mesh`` (n its shards
    in all), or raise."""
    n = mesh.size
    if not sharded_fft_supported(shape, n, _local(mesh).devices[0]):
        raise ValueError(
            f"volume {tuple(shape)} does not shard over {n} devices: Z and Y must be "
            "divisible by the mesh size and every axis within the kernels' limits"
        )
    z, y, x = shape
    return z // n, y // n, x // 2 + 1


def _rows(j: int, y_l: int) -> slice:
    return slice(j * y_l, (j + 1) * y_l)


def prepare_sharded_filter(shape, transfer_function_half, regularization_strength,
                           mesh: Mesh | GlobalMesh) -> ShardedFilter:
    """The Tikhonov filter ``tf / (tf*tf + reg)`` (as :func:`~biahub_tpu_
    torch.kernels.fft.prepare_fourier_filter`, elementwise, so bit-equal to
    it) of each local shard's ky rows, formed on the shard's device: no
    device holds the whole filter. ``shape`` and the transfer function are
    the whole volume's."""
    shape = tuple(int(s) for s in shape)
    _, y_l, _ = _check_shards(shape, mesh)
    tf = transfer_function_half
    if tuple(tf.shape) != half_spectrum_shape(shape):
        raise ValueError(f"transfer function half {tuple(tf.shape)} does not match volume "
                         f"shape {shape} (want {half_spectrum_shape(shape)})")
    z, _, x = shape
    return ShardedFilter(mesh, shape, tuple(
        prepare_fourier_filter((z, y_l, x), tf[:, _rows(_global_index(mesh, k), y_l)],
                               regularization_strength, dev)
        for k, dev in enumerate(_local(mesh).devices)))


def shard_filter(filt, shape, mesh: Mesh | GlobalMesh) -> ShardedFilter:
    """Each local shard's ky rows of a prepared (Z, Y, X//2+1) filter
    (float32, or the complex64 of :func:`~biahub_tpu_torch.kernels.fft.
    prepare_hermitian_filter`) of the whole volume, copied to the shard's
    device."""
    shape = tuple(int(s) for s in shape)
    _, y_l, _ = _check_shards(shape, mesh)
    filt = torch.from_numpy(np.asarray(filt)) if not isinstance(filt, torch.Tensor) else filt
    if tuple(filt.shape) != half_spectrum_shape(shape):
        raise ValueError(f"filter {tuple(filt.shape)} does not match volume shape {shape}")
    return ShardedFilter(mesh, shape, tuple(
        filt[:, _rows(_global_index(mesh, k), y_l)].to(dev).contiguous()
        for k, dev in enumerate(_local(mesh).devices)))


def to_ky_rows(spectra: list[torch.Tensor],
               mesh: GlobalMesh | None = None) -> list[torch.Tensor]:
    """Exchange 1: the n slabs' (Z/n, Y, X//2+1) spectra to each shard's
    contiguous (Z, Y/n, X//2+1) ky rows, on the device of its slab. On a
    ``mesh`` that spans processes, ``spectra`` are this rank's slabs and
    the pieces cross ranks by one all-to-all."""
    if mesh is not None and mesh.processes > 1:
        return _to_ky_rows_group(spectra, mesh)
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


def to_z_slabs(rows: list[torch.Tensor], spectra: list[torch.Tensor],
               mesh: GlobalMesh | None = None) -> None:
    """Exchange 2: each shard's (Z, Y/n, X//2+1) rows back into the slabs'
    (Z/n, Y, X//2+1) spectra, in place; across ranks as
    :func:`to_ky_rows`."""
    if mesh is not None and mesh.processes > 1:
        return _to_z_slabs_group(rows, spectra, mesh)
    n = len(rows)
    z_l, y, xh = spectra[0].shape
    y_l = y // n
    for j, s in enumerate(spectra):
        back = torch.empty((n, z_l, y_l, xh), dtype=torch.complex64, device=s.device)
        for i, r in enumerate(rows):
            back[i].copy_(r[j * z_l:(j + 1) * z_l], non_blocking=True)
        s.view(z_l, n, y_l, xh).copy_(back.permute(1, 0, 2, 3))


def _exchange_buffer(spectra: list[torch.Tensor], mesh: GlobalMesh) -> torch.Tensor:
    """A (P, L, L, Z/n, Y/n, X//2+1) complex64 buffer on the rank's first
    device, the one its all-to-all runs on."""
    P, L = mesh.shape
    z_l, y, xh = spectra[0].shape
    return torch.empty((P, L, L, z_l, y // mesh.size, xh), dtype=torch.complex64,
                       device=spectra[0].device)


def _to_ky_rows_group(spectra: list[torch.Tensor], mesh: GlobalMesh) -> list[torch.Tensor]:
    """Exchange 1 across ranks: ``send[q, k, i]`` is local slab i's piece
    for shard (q, k); after the all-to-all ``recv[p, k, i]`` is the piece
    of slab (p, i) for local shard k, so shard k's rows are ``recv[:, k]``
    in global slab order."""
    P, L = mesh.shape
    n = mesh.size
    z_l, y, xh = spectra[0].shape
    send = _exchange_buffer(spectra, mesh)
    for i, s in enumerate(spectra):
        send[:, :, i].copy_(s.view(z_l, P, L, y // n, xh).permute(1, 2, 0, 3, 4))
    recv = all_to_all(torch.empty_like(send), send)
    return [recv[:, k].reshape(n * z_l, y // n, xh).to(s.device).contiguous()
            for k, s in enumerate(spectra)]


def _to_z_slabs_group(rows: list[torch.Tensor], spectra: list[torch.Tensor],
                      mesh: GlobalMesh) -> None:
    """Exchange 2 across ranks: ``send[p, k, i]`` is local shard k's rows of
    slab (p, i); after the all-to-all ``recv[q, k, i]`` holds shard (q, k)'s
    rows of local slab i."""
    P, L = mesh.shape
    n = mesh.size
    z_l, y, xh = spectra[0].shape
    send = _exchange_buffer(spectra, mesh)
    for k, r in enumerate(rows):
        send[:, k].copy_(r.view(P, L, z_l, y // n, xh))
    recv = all_to_all(torch.empty_like(send), send)
    for i, s in enumerate(spectra):
        back = recv[:, :, i].reshape(n, z_l, y // n, xh)
        s.view(z_l, n, y // n, xh).copy_(back.permute(1, 0, 2, 3))


def _run_sharded(volume, prepared: ShardedFilter, mesh: Mesh | GlobalMesh,
                 z_filter) -> list[torch.Tensor]:
    """Passes A, exchange 1, B (``z_filter``), exchange 2, C; one float32
    (Z/n, Y, X) slab per local mesh device. On a mesh that spans P
    processes ``volume`` is this rank's (Z/P, Y, X) rows."""
    shape = tuple(int(s) for s in volume.shape)
    if _spans_processes(mesh) and len(shape) == 3:
        shape = (shape[0] * mesh.processes,) + shape[1:]
    if len(shape) != 3 or shape != prepared.shape or prepared.mesh != mesh:
        raise ValueError(f"volume {tuple(volume.shape)} on {mesh} for a filter prepared "
                         f"for {prepared.shape} on {prepared.mesh}")
    z_l, _, _ = _check_shards(shape, mesh)
    group = mesh if _spans_processes(mesh) else None
    # Each z-slab to its device as it is (uint16 stays: A reads it exactly);
    # on the volume's own device a slab is a view, no copy.
    slabs = [as_tensor(volume[k * z_l:(k + 1) * z_l], dev, dtypes=PASS_A_DTYPES)
             for k, dev in enumerate(_local(mesh).devices)]
    spectra = [fwd_yx(s) for s in slabs]
    rows = to_ky_rows(spectra, group)
    for r, f in zip(rows, prepared.shards):
        z_filter(r, f)
    to_z_slabs(rows, spectra, group)
    return [inv_yx(s, out=torch.empty(sl.shape, dtype=torch.float32, device=sl.device))
            for s, sl in zip(spectra, slabs)]


def deconvolve_zyx_sharded(volume, transfer_function_half, mesh: Mesh | GlobalMesh,
                           regularization_strength: float = 1e-3,
                           prepared: ShardedFilter | None = None) -> list[torch.Tensor]:
    """Tikhonov-deconvolve one (Z, Y, X) volume sharded over ``mesh``:
    one float32 (Z/n, Y, X) z-slab per local mesh device (:func:`gather`
    joins them). On a :class:`~biahub_tpu_torch.parallel.mesh.GlobalMesh`
    of P processes, ``volume`` is this rank's (Z/P, Y, X) rows and the
    transfer function the whole volume's. ``prepared``: a
    :func:`prepare_sharded_filter` result, which callers hoist out of a
    loop over volumes (then the TF may be None). Raises ``ValueError`` for
    a shape that does not shard."""
    if prepared is None:
        shape = tuple(volume.shape)
        if _spans_processes(mesh):
            shape = (shape[0] * mesh.processes,) + shape[1:]
        prepared = prepare_sharded_filter(shape, transfer_function_half,
                                          regularization_strength, mesh)
    return _run_sharded(volume, prepared, mesh, z_filter_)


def fourier_filter_zyx_sharded(volume, filt, mesh: Mesh | GlobalMesh) -> list[torch.Tensor]:
    """``irfftn(rfftn(volume) * filt)`` sharded over ``mesh`` (kernels A, Bc
    and C), with ``filt`` the complex64 (Z, Y, X//2+1) half of
    :func:`~biahub_tpu_torch.kernels.fft.prepare_hermitian_filter` or its
    :func:`shard_filter`; one float32 z-slab per local mesh device (on a
    mesh over processes, ``volume`` is this rank's rows, as in
    :func:`deconvolve_zyx_sharded`). The sharded counterpart of
    :func:`~biahub_tpu_torch.kernels.fft.fourier_filter_zyx` (the
    reference takes the filter's real and imaginary halves apart)."""
    if not isinstance(filt, ShardedFilter):
        filt = shard_filter(filt, tuple(filt.shape[:2]) + (int(volume.shape[-1]),), mesh)
    return _run_sharded(volume, filt, mesh, z_filter_complex_)


def gather(slabs: list[torch.Tensor], device: str | torch.device) -> torch.Tensor:
    """The z-slabs of a sharded result joined into one (Z, Y, X) volume on
    ``device``."""
    return torch.cat([s.to(device) for s in slabs])
