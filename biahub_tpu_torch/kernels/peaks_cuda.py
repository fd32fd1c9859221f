"""Wrapper of the peak-candidate kernel G (``block_max_argmin``,
``csrc/peaks.cu``).

Counterpart of ``biahub_tpu/kernels/pallas_peaks.py``'s
``block_max_candidates_pallas`` (:262) and of the XLA formulation
``_block_max_candidates_xla`` (peaks.py:54) that serves the shapes its gate
refuses: one kernel takes every shape, block size and blur size
(:func:`g_plan`). A CPU tensor takes
:func:`~biahub_tpu_torch.kernels.peaks.block_max_candidates_plain`; a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import torch

from biahub_tpu_torch.kernels import _build
from biahub_tpu_torch.kernels.peaks import block_grid, block_max_candidates_plain

__all__ = ["block_max_argmin", "GPlan", "g_plan", "walk_axis", "candidate_key"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"block_max_argmin": [_P] * 5 + [_I] * 18 + [_P]}
_MAX_GRID = 2**31 - 1
# The walk's tiles (cells along x, rows along y) in the order g_plan tries
# them, the planes a tile walks, and the shared memory two blocks an SM
# may each take (228 KB an SM, 1 KB of it reserved per block).
_STAGED_TILES = ((128, 16), (128, 8), (64, 16), (64, 8), (32, 16), (32, 8))
_DIRECT_TILE = (128, 16)
_TZ = 16
_SMEM_TWO, _SM_SMEM = 113 * 1024, 228 * 1024
# The walk's blocks an SM holds by registers (csrc/peaks.cu
# __launch_bounds__(256, 3)).
_WALK_BLOCKS = 3


@dataclass(frozen=True)
class GPlan:
    """Kernel G's plan (``csrc/peaks.cu`` GPlan) for one blur size and block
    geometry: a tile of ``tx`` cells along x, ``ty`` rows along y and ``tz``
    planes along z (walked), the window summed in the walk along each axis
    (``k``, or 1 where a pass through device memory summed that axis first),
    the lanes that merge one output block by shuffles, and the staged
    walk's shared memory."""

    k: int  # the blur size (0: none)
    tx: int
    ty: int
    tz: int
    hz: int
    hy: int
    hx: int
    seg: int
    smem: int  # bytes; 0 for a walk that loads each cell from device memory
    per_sm: int  # blocks an SM holds at that shared memory

    @property
    def passes(self) -> int:
        """Axes summed by a pass before the walk."""
        return sum(h == 1 for h in (self.hz, self.hy, self.hx)) if self.k > 1 else 0

    def args(self) -> tuple[int, ...]:
        """The C entry's plan arguments, after the geometry."""
        return (self.k, self.tx, self.ty, self.tz, self.hz, self.hy, self.hx, self.seg,
                self.smem)

    def describe(self) -> str:
        summed = "".join(a for a, h in zip("zyx", (self.hz, self.hy, self.hx))
                         if self.k > 1 and h == 1)
        route = (f"{summed} summed by passes first, " if summed else "") + (
            "cells loaded from device memory" if self.smem == 0
            else f"windows ({self.hz}, {self.hy}, {self.hx}) staged")
        return (f"blur {self.k}: {route}; tiles of ({self.tz}, {self.ty}, {self.tx}) cells, "
                f"{self.seg} lanes a block, {self.smem} B shared, {self.per_sm} blocks/SM")


def walk_floats(tx: int, ty: int, hz: int, hy: int, hx: int) -> int:
    """Floats of a staged walk's shared memory (``csrc/peaks.cu``
    walk_floats): a ring of hz + 1 planes (3 for hz = 1) of (ty + hy - 1) x
    (tx + hx - 1) cells, the z sums' plane when hz > 1, the y sums' ty rows
    when hy > 1 but at blur 3 (each thread sums its cells' 3 x 3 z sums);
    0 when no window is staged."""
    if hz == hy == hx == 1:
        return 0
    pitch = tx + hx - 1
    plane = (ty + hy - 1) * pitch
    return ((hz + 1) if hz > 1 else 3) * plane + (plane if hz > 1 else 0) + (
        ty * pitch if hy > 1 and (hz, hy, hx) != (3, 3, 3) else 0)


@functools.lru_cache(maxsize=64)
def g_plan(blur_kernel_size: int, block_size=(8, 8, 8)) -> GPlan:
    """Kernel G's plan for a blur of ``blur_kernel_size`` (0: none) and
    output blocks of ``block_size``. Blur 0 and 1 walk without a halo;
    larger blurs take, of the windows (k, k, k), (1, k, k), (1, 1, k) and
    (1, 1, 1) (1: that axis summed by a pass through device memory first)
    and the tiles of ``_STAGED_TILES`` whose staged planes let two blocks
    share an SM, the one that moves the fewest bytes by :func:`_traffic`.
    Every size has a plan."""
    k = int(blur_kernel_size)
    if k < 0:
        raise ValueError(f"blur_kernel_size must be >= 0, got {k}")
    bx = int(block_size[2])
    best = _plan(k, *_DIRECT_TILE, 1, 1, 1, bx, 0)
    if k <= 1:
        return best
    for hz, hy, hx in ((k, k, k), (1, k, k), (1, 1, k)):
        for tx, ty in _STAGED_TILES:
            smem = 4 * walk_floats(tx, ty, hz, hy, hx)
            plan = _plan(k, tx, ty, hz, hy, hx, bx, smem)
            if smem <= _SMEM_TWO and _traffic(plan) < _traffic(best):
                best = plan
    return best


# A pass through device memory reads and writes a volume, its window's
# other reads mostly from L1 and L2: counted as this many volumes.
_PASS_VOLUMES = 2.5


def _traffic(plan: GPlan) -> float:
    """Volumes a plan reads and writes: the walk's staged planes with their
    halos (its read amplification) and each pass."""
    amp = 1.0
    for t, h in ((plan.tz, plan.hz), (plan.ty, plan.hy), (plan.tx, plan.hx)):
        amp *= (t + h - 1) / t
    return amp + _PASS_VOLUMES * plan.passes


def _plan(k, tx, ty, hz, hy, hx, bx, smem) -> GPlan:
    seg = bx if bx <= 32 and 32 % bx == 0 and tx % bx == 0 else 1
    per_sm = min(_WALK_BLOCKS, _SM_SMEM // (smem + 1024))
    return GPlan(k, tx, ty, _TZ, hz, hy, hx, seg, smem, per_sm)


def walk_axis(n: int, b: int, t: int) -> list[tuple[int, int]]:
    """The cells [start, stop) of each tile of ``t`` cells along an axis of
    ``n`` cells with output blocks of ``b`` (empty where a tile holds none):
    tiles start on block boundaries, at i*t - b//2, and stop at the volume's
    end or the last block's, whichever comes first (the tail voxels past
    the last block belong to no tile), as the kernel's walk computes them."""
    o = (n + 2 * (b // 2) - b) // b + 1
    stop = min(n, o * b - b // 2)
    return [(max(i * t - b // 2, 0), max(min(i * t - b // 2 + t, stop), 0))
            for i in range(-(-o * b // t))]


def candidate_key(value: float, index: int) -> int:
    """``csrc/peaks.cu`` block_key: a candidate's 64-bit key, ordered as
    the reduction's rule (the larger value, then the smaller index; +0.0
    and -0.0 equal), the sign of a zero in the lowest bit."""
    bits = int(torch.tensor([value], dtype=torch.float32).view(torch.int32).item()) & 0xFFFFFFFF
    negzero = int(bits == 0x80000000)
    if negzero:
        bits = 0
    ordered = (~bits & 0xFFFFFFFF) if bits & 0x80000000 else bits | 0x80000000
    return (ordered << 32) | ((0x7FFFFFFF - int(index)) << 1) | negzero


@functools.lru_cache(maxsize=64)
def _launch(shape, block, blur):
    """Kernel G's plan, block grid and output blocks for a volume of
    ``shape``; raises where the kernel's indices or grid do not reach."""
    if math.prod(shape) >= 2**31:
        raise ValueError("block_max_argmin: the volume's flat indices must fit int32")
    plan = g_plan(blur, block)
    grid = block_grid(shape, block)
    tiles = math.prod(len(walk_axis(n, b, t))
                      for n, b, t in zip(shape, block, (plan.tz, plan.ty, plan.tx)))
    if tiles > _MAX_GRID:
        raise ValueError(f"block_max_argmin: {tiles} tiles exceed the kernel's grid")
    return plan, grid, math.prod(grid)


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
    zyx = zyx.to(torch.float32).contiguous()
    plan, grid, n = _launch(tuple(zyx.shape), block, blur)
    dev = zyx.device
    vals = torch.empty(n, dtype=torch.float32, device=dev)
    idx = torch.empty(n, dtype=torch.int32, device=dev)
    keys = torch.empty(n, dtype=torch.int64, device=dev)
    # the axes summed by passes before the walk go through one or two volumes
    sums = (torch.empty((min(plan.passes, 2),) + tuple(zyx.shape), dtype=torch.float32,
                        device=dev) if plan.passes else None)
    lib = _build.library("peaks", _SIGNATURES)
    with torch.cuda.device(dev):
        rc = lib.block_max_argmin(_build.ptr(zyx), _P() if sums is None else _build.ptr(sums),
                                  _build.ptr(keys),
                                  _build.ptr(vals), _build.ptr(idx), *zyx.shape, *block, *grid,
                                  *plan.args(), _build.stream_of(zyx))
    if rc:
        _build.check(rc, lib, f"block_max_argmin ({plan.describe()})")
    _build.count_launch("block_max_argmin")
    return vals, idx
