"""Wrapper of the spectral deskew's kernel M (``csrc/spectral.cu``).

:func:`lerp_irfft` (kernel M, for ``pallas_spectral.py``'s
``_lerp_irfft_kernel`` and ``_lerp_irfft_xzy_kernel``): for each output
group, the lerp-DFT table contracted with the group's tilt rows of the
filtered (kz, y, kx) spectrum, then the irfft along kx; the zyx or the xzy
store. It takes its plain PyTorch version (an einsum over the table, then
``torch.fft.irfft``) for a CPU tensor and launches its kernel for a CUDA
tensor, or raises.
"""

from __future__ import annotations

import ctypes

import torch

from biahub_tpu_torch.kernels import _build

__all__ = ["lerp_irfft", "lerp_irfft_plain", "lerp_irfft_fits", "OUT_LAYOUTS"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"lerp_irfft": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]}
OUT_LAYOUTS = ("zyx", "xzy")
# Kernel M's shared memory, as spectral.cu's lerp_smem computes it (in
# float2 elements): the X axis' tables, TX/2 irfft lines of M + 1 points
# (TX = 4*CX x' columns), and two stage buffers of 16 kz of 512 kx, one
# last-column value and TX x'; the lines reuse the stage buffers unless
# X/2 > 512. CX is the widest of 8, 4, 2 that fits.
_SMEM_MAX = 227 * 1024
_CHUNK, _KC, _COL_GROUPS = 512, 16, 4


def _is_pow2(n: int) -> bool:
    return n & (n - 1) == 0


def _even(n: int) -> int:
    return n + (n & 1)


def _lerp_smem(cx: int, x: int) -> int:
    m = 1 << max(1, (x if _is_pow2(x) else 2 * x - 1) - 1).bit_length()
    tab = _even(x // 2 if _is_pow2(x) else m // 2 + x + m)
    tx = _COL_GROUPS * cx
    lines = _even(tx // 2 * (m + 1))
    stages = 2 * _KC * (_CHUNK + 1 + tx)
    work = lines + stages if x // 2 > _CHUNK else max(lines, stages)
    return (tab + work) * 8


def lerp_irfft_fits(x: int) -> bool:
    """Whether kernel M's narrowest tile fits a block's shared memory for an
    irfft of ``x`` points: powers of two up to 2048, other lengths up to
    1025."""
    return x >= 2 and _lerp_smem(2, x) <= _SMEM_MAX


def _tilt_rows(y: int, rows: int, device) -> torch.Tensor:
    """The tilt row of the (kz, y, kx) spectrum that table row z' reads:
    ``max(Y-1-z', 0)``: the deskew's reversed tilt axis, its tail group
    edge-padded with row 0."""
    return (y - 1 - torch.arange(rows, device=device)).clamp_min(0)


def _shape(spectrum: torch.Tensor, table: torch.Tensor, x_in: int,
           average_window: int, out_layout: str) -> tuple[int, ...]:
    """The output shape; raises unless the operands fit each other."""
    for t, what in ((spectrum, "spectrum"), (table, "table")):
        if t.ndim != 3 or t.dtype != torch.complex64 or not t.is_contiguous():
            raise ValueError(f"lerp_irfft: {what} must be a contiguous 3-d complex64 "
                             f"tensor, got {tuple(t.shape)} {t.dtype}")
    if out_layout not in OUT_LAYOUTS:
        raise ValueError(f"lerp_irfft: out_layout must be one of {OUT_LAYOUTS}, "
                         f"got {out_layout!r}")
    z, y, xh = spectrum.shape
    rows, x_out, zt = table.shape
    avg = int(average_window)
    groups = -(-y // avg)
    if x_in // 2 + 1 != xh or zt != z or rows != groups * avg:
        raise ValueError(f"lerp_irfft: table {tuple(table.shape)} with average_window "
                         f"{avg} and X = {x_in} do not fit spectrum {tuple(spectrum.shape)}")
    if table.device != spectrum.device:
        raise ValueError(f"lerp_irfft: table on {table.device}, spectrum on "
                         f"{spectrum.device}")
    return (groups, x_in, x_out) if out_layout == "zyx" else (x_out, groups, x_in)


def lerp_irfft_plain(spectrum: torch.Tensor, table: torch.Tensor, x_in: int,
                     average_window: int, out_layout: str = "zyx",
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of kernel M."""
    _shape(spectrum, table, x_in, average_window, out_layout)
    z, y, xh = spectrum.shape
    rows, x_out, _ = table.shape
    avg = int(average_window)
    groups = rows // avg
    s = spectrum[:, _tilt_rows(y, rows, spectrum.device), :].reshape(z, groups, avg, xh)
    u = torch.einsum("gjxk,kgjc->gcx", table.reshape(groups, avg, x_out, z), s)
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


def lerp_irfft(spectrum: torch.Tensor, table: torch.Tensor, x_in: int,
               average_window: int, out_layout: str = "zyx",
               out: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel M: the (Z, Y, X//2+1) complex64 spectrum left by kernels A, K
    and L, and the (groups*avg, X_out, Z) complex64 table of
    :func:`~biahub_tpu_torch.kernels.spectral.prepare_spectral_deskew` ->
    the deskewed volume, (groups, X, X_out) float32 (zyx) or (X_out,
    groups, X) (xzy), in the frame that keeps the deskew's Y reversed.
    Group g is ``irfft(sum_j T[g*avg+j] @ S[:, row(g*avg+j), :], X)``
    along kx, with ``row(z') = max(Y-1-z', 0)``. Launches count as ``lerp_irfft``."""
    shape = _shape(spectrum, table, x_in, average_window, out_layout)
    if out is None:
        out = torch.empty(shape, dtype=torch.float32, device=spectrum.device)
    elif (tuple(out.shape) != shape or out.dtype != torch.float32 or not out.is_contiguous()
          or out.device != spectrum.device):
        raise ValueError(f"lerp_irfft: out must be contiguous float32 {shape} on "
                         f"{spectrum.device}, got {out.dtype} {tuple(out.shape)} on "
                         f"{out.device}")
    if not _build.on_card(spectrum, "lerp_irfft"):
        return lerp_irfft_plain(spectrum, table, x_in, average_window, out_layout, out)
    z, y, _ = spectrum.shape
    rows, x_out, _ = table.shape
    groups = rows // int(average_window)
    if not lerp_irfft_fits(x_in):
        raise ValueError(f"lerp_irfft: X = {x_in} exceeds the kernel's shared memory "
                         "(powers of two up to 2048, other lengths up to 1025)")
    if groups > 65535:
        raise ValueError(f"lerp_irfft: {groups} groups exceed the kernel's grid (65535)")
    lib = _build.library("spectral", _SIGNATURES)
    with torch.cuda.device(spectrum.device):
        rc = lib.lerp_irfft(_build.ptr(spectrum), _build.ptr(table), _build.ptr(out), z, y,
                            x_in, x_out, groups, int(average_window),
                            int(out_layout == "xzy"), _build.stream_of(spectrum))
    _build.check(rc, lib, "lerp_irfft")
    _build.count_launch("lerp_irfft")
    return out
