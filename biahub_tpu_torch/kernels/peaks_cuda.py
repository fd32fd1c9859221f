"""Wrapper of the peak-candidate kernel G (``block_max_argmin``,
``csrc/peaks.cu``).

Counterpart of ``biahub_tpu/kernels/pallas_peaks.py``'s
``block_max_candidates_pallas`` (:262) and of the XLA formulation
``_block_max_candidates_xla`` (peaks.py:54) that serves the shapes its gate
refuses: one kernel takes every shape and block size, with blur 0 or 3. A
CPU tensor takes :func:`~biahub_tpu_torch.kernels.peaks.
block_max_candidates_plain`; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from biahub_tpu_torch.kernels import _build
from biahub_tpu_torch.kernels.peaks import block_grid, block_max_candidates_plain

__all__ = ["block_max_argmin", "CUDA_BLUR_SIZES"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"block_max_argmin": [_P, _P, _P] + [_I] * 10 + [_P]}
# Kernel G stages a one-voxel halo: it blurs over 3^3 or not at all.
CUDA_BLUR_SIZES = (0, 3)
_MAX_GRID = 2**31 - 1


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
    if blur not in CUDA_BLUR_SIZES:
        raise ValueError(f"block_max_argmin: kernel G blurs over 3^3 or not at all "
                         f"(blur_kernel_size in {CUDA_BLUR_SIZES}), got {blur}")
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
                                  *zyx.shape, *block, *grid, blur,
                                  _build.stream_of(zyx))
    _build.check(rc, lib, "block_max_argmin")
    _build.count_launch("block_max_argmin")
    return vals, idx
