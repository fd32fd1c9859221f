"""Wrappers of the spectral deskew's kernel M (``csrc/spectral.cu``).

:func:`lerp_irfft` (kernel M, for ``pallas_spectral.py``'s
``_lerp_irfft_kernel`` and ``_lerp_irfft_xzy_kernel``): for each output
group, the lerp-DFT table contracted with the group's tilt rows of the
filtered (kz, y, kx) spectrum, then the irfft along kx; the zyx or the xzy
store. Two launches: :func:`lerp_contract` (the contraction on the tensor
cores, in split TF32, into U: (groups, X//2+1, X_out) complex64) and
:func:`irfft_columns` (the irfft of U's columns into either store). Each
takes its plain PyTorch version (an einsum over the table; ``torch.fft.
irfft``) for a CPU tensor and launches its kernel for a CUDA tensor, or
raises.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from biahub_tpu_torch.kernels import _build
from biahub_tpu_torch.kernels.fft import (
    _SMEM_ONE,
    _SMEM_TWO,
    _axis_need,
    _buffers,
    _check_out,
    _plan_code,
    _sm_count,
    max_axis,
    radix_plan,
)

__all__ = ["lerp_irfft", "lerp_irfft_plain", "lerp_contract", "lerp_contract_plain",
           "irfft_columns", "irfft_columns_plain", "lerp_irfft_fits", "ContractPlan",
           "contract_plan", "IrfftPlan", "irfft_plan", "OUT_LAYOUTS"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {"lerp_contract": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
               "lerp_irfft": [_P, _P, _L, _I, _I, _I, _I, _I, _I, _I, _I, _P]}
OUT_LAYOUTS = ("zyx", "xzy")
# The contraction's tiles (spectral.cu's kBM, kBN, kBK, kStages, kSS, kTS,
# kPlanes): 128 kx by 64 x' a block, 16 kz a stage; three raw stages of S's
# and T's complex tiles (rows padded to 132 and 20 elements) and the last
# row's 16 S values, and T's tile split into four float planes.
CONTRACT_TILE = (128, 64, 16)
_STAGES, _S_STRIDE, _T_STRIDE, _PLANES = 3, 128 + 4, 16 + 4, 4
# The irfft: 256-thread blocks, two an SM (by their registers) at up to 112
# KB of shared memory (kernels/fft.py's budgets), else one.
_LINE_THREADS = 256


@dataclass(frozen=True)
class ContractPlan:
    """Launch of kernel M's contraction (csrc/spectral.cu
    lerp_contract_kernel, which computes it from the shapes alone)."""

    grid: tuple[int, int, int]  # kx tiles, x' tiles, groups
    stages: int  # depth stages a block walks: avg * ceil(Z / 16)
    kz_pad: int  # zero kz a tilt row's last stage holds
    smem: int  # dynamic shared memory of a block, bytes

    def describe(self) -> str:
        return (f"grid {self.grid}, {CONTRACT_TILE[0]} kx x {CONTRACT_TILE[1]} x' a block, "
                f"{self.stages} stages of {CONTRACT_TILE[2]} kz ({self.kz_pad} zero), "
                f"{self.smem} B shared")


def contract_plan(z: int, x: int, x_out: int, groups: int, average_window: int) -> ContractPlan:
    """The contraction's launch for a (Z, ., X//2+1) spectrum and a table of
    ``groups * average_window`` rows of ``x_out`` x' columns: kx < X//2 in
    tiles of 128 on the tensor cores (the last row, kx = X//2, summed apart
    by the first kx tile's blocks), x' in tiles of 64, one group a grid
    row."""
    bm, bn, bk = CONTRACT_TILE
    nk = -(-z // bk)
    stage = bk * _S_STRIDE + bn * _T_STRIDE + bk
    return ContractPlan((-(-(x // 2) // bm), -(-x_out // bn), groups),
                        int(average_window) * nk, nk * bk - z,
                        4 * _PLANES * bn * bk + 8 * _STAGES * stage)


@dataclass(frozen=True)
class IrfftPlan:
    """Launch plan of kernel M's irfft (csrc/spectral.cu lerp_irfft_kernel)."""

    x: tuple[int, ...] | None  # radices of X's lines (None: Bluestein)
    log2l: int  # log2 of the column pairs a tile
    tab: int  # table elements
    tiles: int  # tiles of the whole output
    smem: int  # dynamic shared memory of a block, bytes
    per_sm: int  # blocks an SM holds at this shared memory

    def args(self, grid: int) -> tuple[int, ...]:
        """The C entry's plan arguments for ``grid`` blocks."""
        return _plan_code(self.x), self.log2l, self.tab, grid, self.smem

    def grid(self, sm_count: int) -> int:
        """Blocks to launch: every resident slot of the card, at most one a
        tile (each block walks tiles by the grid's stride)."""
        return min(self.tiles, self.per_sm * sm_count)

    def describe(self) -> str:
        axis = "x".join(map(str, self.x)) if self.x else "Bluestein"
        return (f"X {axis}, {1 << self.log2l} column pairs a tile, {self.tiles} tiles, "
                f"{_LINE_THREADS} threads, {self.smem} B shared, {self.per_sm} blocks/SM")


@functools.lru_cache(maxsize=64)
def irfft_plan(x: int, x_out: int, groups: int, out_layout: str = "zyx") -> IrfftPlan:
    """The irfft's plan for X = ``x`` and ``groups`` x ``x_out`` columns: X's
    radices (kernels/fft.py :func:`~biahub_tpu_torch.kernels.fft.radix_plan`,
    kernel C's rows) and the widest tile of column pairs (a power of two, no
    wider than the columns need) that fits: for the zyx store, whose rows
    take 2 x pairs consecutive x', at most 8 pairs in a block's 227 KB; for
    the xzy store, whose rows run along x, at most 16 pairs where two
    blocks share an SM (112 KB each), else one. The first pass reads U, the
    last writes the output, as C's column phase (one tile for at most two
    passes). At X = 1024 on an H100 (its 484 x' of 86 groups) the zyx store
    took 0.236 ms with 8 pairs against 0.287 with 4, the xzy store 0.209
    with 4 against 0.277 with 8."""
    rx = radix_plan(x)
    bufs = _buffers(rx, False)
    pairs = -(-x_out // 2)
    budgets = ((_SMEM_ONE, 3),) if out_layout == "zyx" else ((_SMEM_TWO, 4), (_SMEM_ONE, 4))
    for budget, max_log2l in budgets:
        log2l = next((l for l in range(max_log2l, -1, -1)
                      if sum(_axis_need(x, rx, 1 << l, bufs)) <= budget // 8), None)
        if log2l is not None:
            break
    else:
        raise ValueError(f"irfft_plan: X = {x} exceeds a block's shared memory")
    log2l = min(log2l, (pairs - 1).bit_length())
    tab, tile = _axis_need(x, rx, 1 << log2l, bufs)
    smem = 8 * (tab + tile)
    tiles = groups * -(-pairs >> log2l)
    return IrfftPlan(rx, log2l, tab, tiles, smem, 2 if smem <= _SMEM_TWO else 1)


def lerp_irfft_fits(x: int) -> bool:
    """Whether kernel M takes an irfft of ``x`` points: as kernels A and C,
    powers of two up to 8192, other lengths up to 4096."""
    return 2 <= x <= max_axis(x)


def _tilt_rows(y: int, rows: int, device) -> torch.Tensor:
    """The tilt row of the (kz, y, kx) spectrum that table row z' reads:
    ``max(Y-1-z', 0)``: the deskew's reversed tilt axis, its tail group
    edge-padded with row 0."""
    return (y - 1 - torch.arange(rows, device=device)).clamp_min(0)


def _check_operands(spectrum: torch.Tensor, table: torch.Tensor, x_in: int,
                    average_window: int) -> int:
    """The number of groups; raises unless the operands fit each other."""
    for t, what in ((spectrum, "spectrum"), (table, "table")):
        if t.ndim != 3 or t.dtype != torch.complex64 or not t.is_contiguous():
            raise ValueError(f"lerp_irfft: {what} must be a contiguous 3-d complex64 "
                             f"tensor, got {tuple(t.shape)} {t.dtype}")
    z, y, xh = spectrum.shape
    rows, _, zt = table.shape
    avg = int(average_window)
    groups = -(-y // avg)
    if x_in // 2 + 1 != xh or zt != z or rows != groups * avg:
        raise ValueError(f"lerp_irfft: table {tuple(table.shape)} with average_window "
                         f"{avg} and X = {x_in} do not fit spectrum {tuple(spectrum.shape)}")
    if table.device != spectrum.device:
        raise ValueError(f"lerp_irfft: table on {table.device}, spectrum on "
                         f"{spectrum.device}")
    return groups


def _out_shape(groups: int, x_in: int, x_out: int, out_layout: str) -> tuple[int, ...]:
    if out_layout not in OUT_LAYOUTS:
        raise ValueError(f"lerp_irfft: out_layout must be one of {OUT_LAYOUTS}, "
                         f"got {out_layout!r}")
    return (groups, x_in, x_out) if out_layout == "zyx" else (x_out, groups, x_in)


def _check_x(x_in: int, what: str) -> None:
    if not lerp_irfft_fits(x_in):
        raise ValueError(f"{what}: X = {x_in} exceeds the kernel's limits (powers of two "
                         "up to 8192, other lengths up to 4096)")


def lerp_contract_plain(spectrum: torch.Tensor, table: torch.Tensor, x_in: int,
                        average_window: int, out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of kernel M's contraction."""
    groups = _check_operands(spectrum, table, x_in, average_window)
    z, y, xh = spectrum.shape
    rows, x_out, _ = table.shape
    avg = int(average_window)
    s = spectrum[:, _tilt_rows(y, rows, spectrum.device), :].reshape(z, groups, avg, xh)
    u = torch.einsum("gjxk,kgjc->gcx", table.reshape(groups, avg, x_out, z), s)
    return u if out is None else out.copy_(u)


def lerp_contract(spectrum: torch.Tensor, table: torch.Tensor, x_in: int,
                  average_window: int, out: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel M's contraction: the (Z, Y, X//2+1) complex64 spectrum and the
    (groups*avg, X_out, Z) complex64 table -> U, (groups, X//2+1, X_out)
    complex64, ``U[g] = sum_j (T[g*avg+j] @ S[:, row(g*avg+j), :]).T`` with
    ``row(z') = max(Y-1-z', 0)``, on the tensor cores in split TF32 (float32
    accuracy). Launches count as ``lerp_contract``."""
    groups = _check_operands(spectrum, table, x_in, average_window)
    z, y, xh = spectrum.shape
    x_out = table.shape[1]
    out = _check_out(out, (groups, xh, x_out), torch.complex64, spectrum, "lerp_contract")
    if not _build.on_card(spectrum, "lerp_contract"):
        return lerp_contract_plain(spectrum, table, x_in, average_window, out)
    if groups > 65535:
        raise ValueError(f"lerp_contract: {groups} groups exceed the kernel's grid (65535)")
    lib = _build.library("spectral", _SIGNATURES)
    with torch.cuda.device(spectrum.device):
        rc = lib.lerp_contract(_build.ptr(spectrum), _build.ptr(table), _build.ptr(out), z, y,
                               x_in, x_out, groups, int(average_window),
                               _build.stream_of(spectrum))
    _build.check(rc, lib, "lerp_contract")
    _build.count_launch("lerp_contract")
    return out


def _irfft_plain_(u: torch.Tensor, x_in: int, out_layout: str,
                  out: torch.Tensor | None) -> torch.Tensor:
    """:func:`irfft_columns_plain`, writing into ``u``."""
    # irfft's reading of the half spectrum, made explicit: the imaginary
    # parts of kx = 0 and, for an even X, kx = X/2 are dropped (cuFFT's
    # C2R leaves them undefined, and kernel M drops them as kernel C does).
    u[:, 0].imag.zero_()
    if x_in % 2 == 0:
        u[:, -1].imag.zero_()
    res = torch.fft.irfft(u, n=x_in, dim=1)
    if out_layout == "xzy":
        res = res.permute(2, 0, 1)
    return res.contiguous() if out is None else out.copy_(res)


def irfft_columns_plain(u: torch.Tensor, x_in: int, out_layout: str = "zyx",
                        out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of kernel M's irfft."""
    return _irfft_plain_(u.clone(), x_in, out_layout, out)


def irfft_columns(u: torch.Tensor, x_in: int, out_layout: str = "zyx",
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel M's irfft: U, (groups, X//2+1, X_out) complex64 -> the irfft
    of each x' column along kx, X points with 1/X, as (groups, X, X_out)
    float32 (zyx) or (X_out, groups, X) (xzy). Launches count as
    ``lerp_irfft``."""
    if u.ndim != 3 or u.dtype != torch.complex64 or not u.is_contiguous():
        raise ValueError(f"irfft_columns: U must be a contiguous 3-d complex64 tensor, got "
                         f"{tuple(u.shape)} {u.dtype}")
    groups, xh, x_out = u.shape
    if x_in // 2 + 1 != xh:
        raise ValueError(f"irfft_columns: X = {x_in} does not fit U {tuple(u.shape)}")
    out = _check_out(out, _out_shape(groups, x_in, x_out, out_layout), torch.float32, u,
                     "irfft_columns")
    if not _build.on_card(u, "irfft_columns"):
        return irfft_columns_plain(u, x_in, out_layout, out)
    _check_x(x_in, "irfft_columns")
    plan = irfft_plan(int(x_in), x_out, groups, out_layout)
    lib = _build.library("spectral", _SIGNATURES)
    with torch.cuda.device(u.device):
        grid = plan.grid(_sm_count(u.device))
        rc = lib.lerp_irfft(_build.ptr(u), _build.ptr(out), *plan.args(grid), x_in, x_out,
                            groups, int(out_layout == "xzy"), _build.stream_of(u))
    _build.check(rc, lib, f"irfft_columns ({plan.describe()}, grid {grid})")
    _build.count_launch("lerp_irfft")
    return out


def lerp_irfft_plain(spectrum: torch.Tensor, table: torch.Tensor, x_in: int,
                     average_window: int, out_layout: str = "zyx",
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of kernel M."""
    groups = _check_operands(spectrum, table, x_in, average_window)
    _out_shape(groups, x_in, table.shape[1], out_layout)
    u = lerp_contract_plain(spectrum, table, x_in, average_window)
    return _irfft_plain_(u, x_in, out_layout, out)


def lerp_irfft(spectrum: torch.Tensor, table: torch.Tensor, x_in: int,
               average_window: int, out_layout: str = "zyx",
               out: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel M: the (Z, Y, X//2+1) complex64 spectrum left by kernels A, K
    and L, and the (groups*avg, X_out, Z) complex64 table of
    :func:`~biahub_tpu_torch.kernels.spectral.prepare_spectral_deskew` ->
    the deskewed volume, (groups, X, X_out) float32 (zyx) or (X_out,
    groups, X) (xzy), in the frame that keeps the deskew's Y reversed.
    Group g is ``irfft(sum_j T[g*avg+j] @ S[:, row(g*avg+j), :], X)``
    along kx, with ``row(z') = max(Y-1-z', 0)``: :func:`lerp_contract`,
    then :func:`irfft_columns` (launches count as ``lerp_contract`` and
    ``lerp_irfft``)."""
    groups = _check_operands(spectrum, table, x_in, average_window)
    shape = _out_shape(groups, x_in, table.shape[1], out_layout)
    out = _check_out(out, shape, torch.float32, spectrum, "lerp_irfft")
    if not _build.on_card(spectrum, "lerp_irfft"):
        return lerp_irfft_plain(spectrum, table, x_in, average_window, out_layout, out)
    _check_x(x_in, "lerp_irfft")
    u = lerp_contract(spectrum, table, x_in, average_window)
    return irfft_columns(u, x_in, out_layout, out)
