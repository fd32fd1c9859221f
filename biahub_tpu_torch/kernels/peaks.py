"""Bead and peak detection: blur and block max on the device, selection on
the host.

Counterpart of ``biahub_tpu/kernels/peaks.py``: a box blur (hot-pixel
suppression), a strided block max for one candidate per block, the
brightest ``max_num_peaks`` candidates, then on the host an absolute
threshold, pairwise NMS, min-distance rejection and border exclusion.

:func:`block_max_candidates` launches kernel G (``csrc/peaks.cu``, through
:mod:`biahub_tpu_torch.kernels.peaks_cuda`) for a CUDA tensor and takes
:func:`block_max_candidates_plain` for a CPU tensor. Both have the
semantics of the reference's XLA formulation (``_block_max_candidates_xla``,
peaks.py:54-182), which its Pallas kernel shares: torch
``max_pool3d(stride=b, padding=b//2)`` block geometry, ``count_include_pad=
False`` blur divisors, tail voxels outside every block excluded, and per
block the smallest flat C-order index among the cells equal to its max.
"""

from __future__ import annotations

import numpy as np
import torch

from biahub_tpu_torch.device import as_tensor, resolve_device

__all__ = [
    "block_max_candidates",
    "block_max_candidates_plain",
    "block_max_topk",
    "block_grid",
    "detect_peaks",
]


def block_grid(shape, block_size) -> tuple[int, int, int]:
    """Blocks per axis, torch's ``floor((size + 2*(b//2) - b) / b) + 1``."""
    return tuple((int(s) + 2 * (int(b) // 2) - int(b)) // int(b) + 1
                 for s, b in zip(shape, block_size))


def _blur_counts(size: int, k: int) -> np.ndarray:
    """Neighbours of each position inside [0, size-1] for a k-window with
    XLA's SAME padding (low pad (k-1)//2): the count_include_pad=False
    divisor along one axis."""
    lo = (k - 1) // 2
    i = np.arange(size)
    return (np.minimum(i - lo + k - 1, size - 1) - np.maximum(i - lo, 0) + 1).astype(np.float32)


def box_blur_plain(zyx: torch.Tensor, k: int) -> torch.Tensor:
    """k^3 box mean with count_include_pad=False divisors, as separable
    window sums along z, then y, then x, each ``((a + b) + c) ...``."""
    lo = (k - 1) // 2
    sums = zyx
    for axis in range(3):
        pad = [0, 0] * 3
        pad[2 * (2 - axis)] = lo
        pad[2 * (2 - axis) + 1] = k - 1 - lo
        padded = torch.nn.functional.pad(sums, pad)
        n = sums.shape[axis]
        acc = padded.narrow(axis, 0, n)
        for j in range(1, k):
            acc = acc + padded.narrow(axis, j, n)
        sums = acc
    cz, cy, cx = (torch.from_numpy(_blur_counts(int(s), k)).to(zyx.device)
                  for s in zyx.shape)
    return sums / ((cz[:, None, None] * cy[None, :, None]) * cx)


def block_max_candidates_plain(zyx: torch.Tensor, block_size=(8, 8, 8),
                               blur_kernel_size: int = 3):
    """Plain version of kernel G: (Z, Y, X) float32 -> (values (n,) float32,
    flat indices (n,) int32), one candidate per block in C order of the
    block grid. ``blur_kernel_size`` 0 (no blur) or any odd size."""
    zyx = zyx.to(torch.float32)
    shape = tuple(int(s) for s in zyx.shape)
    block = tuple(int(b) for b in block_size)
    smooth = box_blur_plain(zyx, int(blur_kernel_size)) if blur_kernel_size else zyx
    grid = block_grid(shape, block)
    pads = [b // 2 for b in block]
    padded = [o * b for o, b in zip(grid, block)]
    # The cells some block covers; the tail past the last block is left out.
    cover = [min(s, ps - p) for s, p, ps in zip(shape, pads, padded)]
    dev = zyx.device
    vals = torch.full(padded, -float("inf"), dtype=torch.float32, device=dev)
    real = torch.zeros(padded, dtype=torch.bool, device=dev)
    where = tuple(slice(p, p + c) for p, c in zip(pads, cover))
    vals[where] = smooth[:cover[0], :cover[1], :cover[2]]
    real[where] = True
    flat = (torch.arange(padded[0], device=dev)[:, None, None] - pads[0]) * shape[1]
    flat = (flat + (torch.arange(padded[1], device=dev)[None, :, None] - pads[1])) * shape[2]
    flat = flat + (torch.arange(padded[2], device=dev)[None, None, :] - pads[2])

    def blocks(t):  # (PZ, PY, PX) -> (oz*oy*ox, bz*by*bx)
        t = t.reshape(grid[0], block[0], grid[1], block[1], grid[2], block[2])
        return t.permute(0, 2, 4, 1, 3, 5).reshape(-1, block[0] * block[1] * block[2])

    bv = blocks(vals)
    best = bv.max(dim=1).values
    big = torch.iinfo(torch.int32).max
    cand = torch.where(blocks(real) & (bv == best[:, None]), blocks(flat),
                       torch.full((), big, dtype=flat.dtype, device=dev))
    return best, cand.min(dim=1).values.to(torch.int32)


def block_max_candidates(zyx: torch.Tensor, block_size=(8, 8, 8),
                         blur_kernel_size: int = 3):
    """(values, flat indices) of one candidate per block: kernel G for a
    CUDA tensor, :func:`block_max_candidates_plain` for a CPU tensor."""
    from biahub_tpu_torch.kernels import peaks_cuda

    return peaks_cuda.block_max_argmin(zyx, tuple(int(b) for b in block_size),
                                       int(blur_kernel_size))


def block_max_topk(zyx: torch.Tensor, block_size, blur_kernel_size: int, k: int):
    """The candidates and the brightest ``k`` of them, on the device.

    ``jax.lax.top_k`` (the reference's ``_block_max_topk``, peaks.py:185)
    puts the lower index first among equal values; a stable descending sort
    does the same, and on integer camera data many blocks tie."""
    values, flat = block_max_candidates(zyx, block_size, blur_kernel_size)
    kk = min(int(k), int(values.numel()))
    order = torch.sort(values, descending=True, stable=True).indices[:kk]
    return values[order], flat[order]


def detect_peaks(
    zyx_data,
    block_size: int | tuple[int, int, int] = (8, 8, 8),
    nms_distance: int = 3,
    min_distance: int = 40,
    threshold_abs: float = 200.0,
    max_num_peaks: int = 500,
    exclude_border: tuple[int, int, int] | None = None,
    blur_kernel_size: int = 3,
    verbose: bool = False,
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """Detect local-maximum peaks of a (Z, Y, X) volume (numpy array or
    tensor); returns (N, 3) int64 ZYX coordinates (the reference's
    ``detect_peaks``, peaks.py:205, whose host filtering this copies)."""
    dev = resolve_device(device)
    if isinstance(block_size, int):
        block_size = (block_size,) * 3
    vol = as_tensor(zyx_data, dev)
    zyx_shape = tuple(int(s) for s in vol.shape[-3:])
    values_d, idx_d = block_max_topk(vol, tuple(int(b) for b in block_size),
                                     int(blur_kernel_size), int(max_num_peaks))
    peak_value, peak_idx = values_d.cpu().numpy(), idx_d.cpu().numpy()
    num_peaks = int(np.prod(block_grid(zyx_shape, block_size)))
    num_rejected_max_num_peaks = num_peaks - len(peak_value)

    num_rejected_threshold_abs = 0
    if threshold_abs:
        abs_mask = peak_value > threshold_abs
        peak_value = peak_value[abs_mask]
        peak_idx = peak_idx[abs_mask]
        num_rejected_threshold_abs = int(np.sum(~abs_mask))

    coords = np.stack(np.unravel_index(peak_idx, zyx_shape), -1)
    fcoords = coords.astype(np.float64)
    if len(coords):
        dist = np.linalg.norm(fcoords[:, None] - fcoords[None, :], axis=-1)
    else:
        dist = np.zeros((0, 0))
    dist_mask = np.ones(len(coords), dtype=bool)

    # NMS: of any candidate pair closer than nms_distance, drop the dimmer
    # (the one later in the brightness ordering).
    close = np.triu(dist < nms_distance, k=1)
    nearby_peaks = np.argwhere(close)
    dist_mask[nearby_peaks[:, 1]] = False
    num_rejected_nms_distance = int(np.sum(~dist_mask))

    num_rejected_min_distance = 0
    if min_distance:
        _dist_mask = dist < min_distance
        if len(nearby_peaks):
            _dist_mask[nearby_peaks[:, 0], nearby_peaks[:, 1]] = False
        dist_mask &= _dist_mask.sum(1) < 2
        num_rejected_min_distance = int(np.sum(~dist_mask)) - num_rejected_nms_distance
    coords = coords[dist_mask]

    num_rejected_exclude_border = 0
    if exclude_border is not None:
        if not (isinstance(exclude_border, (tuple, list)) and len(exclude_border) == 3):
            raise ValueError(f"invalid argument exclude_border={exclude_border}")
        for dim, size in enumerate(exclude_border):
            border_mask = (size < coords[:, dim]) & (coords[:, dim] < zyx_shape[dim] - size)
            num_rejected_exclude_border += int(np.sum(~border_mask))
            coords = coords[border_mask]

    if verbose:
        print(f"Number of peaks detected: {num_peaks}")
        print(f"Number of peaks rejected by max_num_peaks: {num_rejected_max_num_peaks}")
        print(f"Number of peaks rejected by threshold_abs: {num_rejected_threshold_abs}")
        print(f"Number of peaks rejected by nms_distance: {num_rejected_nms_distance}")
        print(f"Number of peaks rejected by min_distance: {num_rejected_min_distance}")
        print(f"Number of peaks rejected by exclude_border: {num_rejected_exclude_border}")
        print(f"Number of peaks returned: {len(coords)}")

    return coords
