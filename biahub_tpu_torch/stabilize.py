"""stabilize on arrays in memory: per-timepoint 4x4 transforms.

Counterpart of ``biahub_tpu/stabilize.py`` without its plate I/O: the
first transform's rotation decides whether the output YX axes swap
(:func:`_output_yx`), every channel of a timepoint is warped by that
timepoint's matrix, and the kernel is chosen from the whole matrix list
(:160-215): all translations take :func:`~biahub_tpu_torch.kernels.affine.
translation_warp_zyx_batched`, all in-plane matrices the in-plane warp with
one matrix per volume; both run kernels E and F once per batch, with a
(B, 21) coefficient table. Any other set takes the batched multipass warp
(:func:`~biahub_tpu_torch.kernels.multipass_warp.
multipass_affine_warp_zyx_batched`: kernel H once per canonical slot and
batch, with a (B, 7, 3) table, in one frame for the whole run), or the
exact gather when a matrix has a vanishing pivot
(:func:`~biahub_tpu_torch.kernels.affine.make_batched_warp`). When one
volume, its output and its frames exceed the batch budget, each volume is
warped in output chunks (the reference's :216-262).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from biahub_tpu_torch.device import as_tensor, resolve_device
from biahub_tpu_torch.estimate_stabilization import DEFAULT_MAX_BATCH_BYTES
from biahub_tpu_torch.kernels.affine import affine_warp_auto, make_batched_warp
from biahub_tpu_torch.kernels.multipass_warp import chunked_affine_warp_zyx

__all__ = ["apply_stabilization_transform", "stabilize_tczyx", "stabilize_batch_size"]


def apply_stabilization_transform(
    zyx_data,
    list_of_shifts: list,
    input_time_index: int,
    output_shape: tuple[int, int, int] | None = None,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """Warp one (Z, Y, X) volume, or each of a (C, Z, Y, X) stack, by the
    transform of its time index (NaN read as 0)."""
    dev = resolve_device(device)
    data = torch.nan_to_num(as_tensor(zyx_data, dev), nan=0.0)
    if output_shape is None:
        output_shape = tuple(data.shape[-3:])
    matrix = np.asarray(list_of_shifts[input_time_index], dtype=np.float64)
    if data.ndim == 4:
        return torch.stack([affine_warp_auto(c, matrix, tuple(output_shape), device=dev)
                            for c in data])
    return affine_warp_auto(data, matrix, tuple(output_shape), device=dev)


def _output_yx(matrices, Y: int, X: int) -> tuple[int, int]:
    """(Yo, Xo): swapped when the first transform is a ~90 deg rotation
    about the first axis (the reference's :71)."""
    # scipy is imported at call time: its import starts a process (numpy's
    # CPU probe), and importing the port starts none.
    from scipy.linalg import svd
    from scipy.spatial.transform import Rotation

    r_matrix = np.asarray(matrices[0], dtype=np.float64)[:3, :3]
    u, _, vt = svd(r_matrix)
    euler = Rotation.from_matrix(u @ vt).as_euler("xyz", degrees=True)
    if np.isclose(euler[0], 90, atol=10):
        return X, Y
    return Y, X


def stabilize_batch_size(in_zyx, out_zyx, n_volumes: int,
                         max_batch_bytes: int = DEFAULT_MAX_BATCH_BYTES,
                         workspace_bytes: int = 0) -> int:
    """Volumes per batch: as many as fit ``max_batch_bytes`` counting each
    volume's float32 input and output and the warp's ``workspace_bytes``
    (the multipass warp's common frames, :func:`~biahub_tpu_torch.kernels.
    multipass_warp.common_frame_bytes`), the reference runner's rule for one
    chunk in flight (runtime/executor.py:264-300, stabilize.py:216-229)."""
    unit = 4 * (int(np.prod(in_zyx)) + int(np.prod(out_zyx))) + int(workspace_bytes)
    return int(max(1, min(n_volumes, max_batch_bytes // unit)))


def stabilize_tczyx(
    tczyx,
    matrices,
    time_indices="all",
    max_batch_bytes: int = DEFAULT_MAX_BATCH_BYTES,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """Stabilize a (T, C, Z, Y, X) timelapse by one 4x4 output->input
    matrix per raw timepoint -> (len(time_indices), C, Z, Yo, Xo) float32,
    fill 0. ``time_indices``: ``"all"``, a list, or one index. The (t, c)
    volumes run in batches of :func:`stabilize_batch_size`: one launch of
    kernels E and F per batch, or of H per canonical slot for general
    matrices. Past ``max_batch_bytes`` for one volume (input, output and
    the multipass frames), each volume runs in output chunks and the result
    is in host memory (:func:`_stabilize_chunked`)."""
    dev = resolve_device(device)
    T, C, Z, Y, X = tczyx.shape
    mats = np.asarray(matrices, dtype=np.float64)
    if mats.ndim != 3 or mats.shape[1:] != (4, 4) or len(mats) < T:
        raise ValueError(f"want one 4x4 matrix per timepoint ({T}), got "
                         f"{mats.shape}")
    if time_indices == "all":
        times = list(range(T))
    elif isinstance(time_indices, list):
        times = [int(t) for t in time_indices]
    else:
        times = [int(time_indices)]
    out_y, out_x = _output_yx(mats, Y, X)
    out_zyx = (Z, out_y, out_x)
    units = [(t, c) for t in times for c in range(C)]
    # The kernel is chosen from every matrix given, as the reference's
    # (:172-213), not only from the timepoints warped.
    warp, workspace = make_batched_warp(mats, (Z, Y, X), out_zyx, dev)
    volume_bytes = 4 * (Z * Y * X + int(np.prod(out_zyx))) + workspace
    if volume_bytes > max_batch_bytes:
        return _stabilize_chunked(tczyx, mats, times, out_zyx, volume_bytes,
                                  max_batch_bytes, dev)
    out = torch.empty((len(times), C) + out_zyx, dtype=torch.float32, device=dev)
    flat = out.view(len(units), *out_zyx)
    step = stabilize_batch_size((Z, Y, X), out_zyx, len(units), max_batch_bytes, workspace)
    for i in range(0, len(units), step):
        batch = units[i:i + step]
        vols = torch.stack([as_tensor(tczyx[t, c], dev) for t, c in batch])
        flat[i:i + len(batch)] = warp(vols, mats[[t for t, _ in batch]])
    return out


def _stabilize_chunked(tczyx, mats, times, out_zyx, volume_bytes: int,
                       max_batch_bytes: int, dev: torch.device) -> torch.Tensor:
    """The reference's over-budget route (stabilize.py:216-262): one
    volume and its frames exceed ``max_batch_bytes``, so each (t, c) is
    warped by its timepoint's matrix in output chunks of ``max(32, s //
    n_splits)`` through :func:`~biahub_tpu_torch.kernels.multipass_warp.
    chunked_affine_warp_zyx`, its input read box by box. The result is in
    host memory."""
    T, C, Z, Y, X = tczyx.shape
    n_splits = max(1, int(np.ceil(volume_bytes / max_batch_bytes)))
    chunk = tuple(max(32, s // n_splits) for s in out_zyx)
    print(f"Volume exceeds the device batch budget; stabilizing in output chunks of {chunk}",
          file=sys.stderr)
    out = torch.zeros((len(times), C) + out_zyx, dtype=torch.float32)
    for t_out, t in enumerate(times):
        for c in range(C):
            def read_fn(zs, ys, xs, _t=t, _c=c):
                return tczyx[_t, _c, zs, ys, xs]

            def write_fn(zs, ys, xs, data, _t=t_out, _c=c):
                out[_t, _c, zs, ys, xs] = data.cpu()

            chunked_affine_warp_zyx(read_fn, mats[t], (Z, Y, X), out_zyx, chunk,
                                    write_fn=write_fn, device=dev)
    return out
