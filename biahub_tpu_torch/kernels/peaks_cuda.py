"""Wrapper of the peak-candidate kernel G (``block_max_argmin``,
``csrc/peaks.cu``).

Counterpart of ``biahub_tpu/kernels/pallas_peaks.py``'s
``block_max_candidates_pallas`` (:262) and of the XLA formulation
``_block_max_candidates_xla`` (peaks.py:54) that serves the shapes its gate
refuses: one kernel takes every shape and block size, and every blur size
up to :data:`MAX_BLUR` (:func:`blur_plan`). A CPU tensor takes
:func:`~biahub_tpu_torch.kernels.peaks.block_max_candidates_plain`; a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from biahub_tpu_torch.kernels import _build
from biahub_tpu_torch.kernels.peaks import block_grid, block_max_candidates_plain

__all__ = ["block_max_argmin", "blur_plan", "MAX_BLUR"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"block_max_argmin": [_P, _P, _P] + [_I] * 14 + [_P]}
_MAX_GRID = 2**31 - 1
# Kernel G's sub-tiles, largest first, and the shared memory it may take:
# 113 KB with two blocks an SM, then the 227 KB a block may have less its
# 64-byte reduction buffer and a margin.
_TILES = ((8, 8, 32), (8, 8, 16), (4, 8, 16), (4, 4, 16), (4, 4, 8), (2, 4, 8), (2, 2, 8),
          (1, 2, 8), (1, 1, 8), (1, 1, 4), (1, 1, 2), (1, 1, 1))
_BUDGETS = (113 * 1024, 227 * 1024 - 256)


def _blur_smem(k: int, tile) -> int:
    """Bytes of kernel G's buffers: the sub-tile with its k-1 halo cells on
    each axis, and its z sums but for k = 3 (each cell sums its 27
    neighbours from the halo)."""
    tz, ty, tx = tile
    h = k - 1
    return 4 * ((tz + h) * (ty + h) * (tx + h) + (tz * (ty + h) * (tx + h) if k != 3 else 0))


# The largest blur whose one-cell sub-tile fits a block's shared memory.
MAX_BLUR = max(k for k in range(1, 64) if _blur_smem(k, (1, 1, 1)) <= _BUDGETS[-1])


def blur_plan(blur_kernel_size: int) -> tuple[tuple[int, int, int], int]:
    """Kernel G's sub-tile (tz, ty, tx) and dynamic shared memory (bytes)
    for a blur of ``blur_kernel_size`` (0: none): the largest sub-tile that
    lets two blocks share an SM, else the largest that fits one. Raises
    above :data:`MAX_BLUR`."""
    k = int(blur_kernel_size)
    if k < 0:
        raise ValueError(f"blur_kernel_size must be >= 0, got {k}")
    if k == 0:
        return _TILES[0], 0
    for budget in _BUDGETS:
        for tile in _TILES:
            if _blur_smem(k, tile) <= budget:
                return tile, _blur_smem(k, tile)
    raise ValueError(f"block_max_argmin: blur_kernel_size {k} exceeds kernel G's limit of "
                     f"{MAX_BLUR} (a {k}^3 halo of one cell and its z sums must fit a "
                     "block's 227 KB of shared memory)")


def block_max_argmin(zyx: torch.Tensor, block_size=(8, 8, 8), blur_kernel_size: int = 3):
    """Kernel G: (Z, Y, X) float32 -> (values (n,) float32, flat indices
    (n,) int32), one per block of the torch ``max_pool3d(stride=b,
    padding=b//2)`` grid, in C order. Launches count as
    ``block_max_argmin``."""
    if zyx.ndim != 3:
        raise ValueError(f"block_max_argmin: want a (Z, Y, X) volume, got {tuple(zyx.shape)}")
    block = tuple(int(b) for b in block_size)
    if len(block) != 3 or min(block) < 1:
        raise ValueError(f"block_max_argmin: block_size must be 3 positive ints, got {block}")
    blur = int(blur_kernel_size)
    if not _build.on_card(zyx, "block_max_argmin"):
        return block_max_candidates_plain(zyx, block, blur)
    tile, smem = blur_plan(blur)
    if zyx.numel() >= 2**31:
        raise ValueError("block_max_argmin: the volume's flat indices must fit int32")
    zyx = zyx.to(torch.float32).contiguous()
    grid = block_grid(zyx.shape, block)
    n = grid[0] * grid[1] * grid[2]
    if n > _MAX_GRID:
        raise ValueError(f"block_max_argmin: {n} blocks exceed the kernel's grid")
    vals = torch.empty(n, dtype=torch.float32, device=zyx.device)
    idx = torch.empty(n, dtype=torch.int32, device=zyx.device)
    lib = _build.library("peaks", _SIGNATURES)
    with torch.cuda.device(zyx.device):
        rc = lib.block_max_argmin(_build.ptr(zyx), _build.ptr(vals), _build.ptr(idx),
                                  *zyx.shape, *block, *grid, blur, *tile, smem,
                                  _build.stream_of(zyx))
    _build.check(rc, lib, "block_max_argmin")
    _build.count_launch("block_max_argmin")
    return vals, idx
