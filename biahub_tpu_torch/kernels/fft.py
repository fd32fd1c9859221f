"""Wrappers of the Fourier-filter kernels (``csrc/fft.cu``).

Counterpart of ``biahub_tpu/kernels/pallas_fft.py``'s engine:

- :func:`fwd_yx` (kernel A, for ``_fwd_yx_kernel``): rfft along X and DFT
  along Y of each z slice, float32 or uint16 in, half-spectrum out;
- :func:`z_filter_` (kernel B, for ``_pass_b_kernel``): DFT along Z, times
  the prepared real Tikhonov filter, inverse DFT along Z, in place;
- :func:`z_filter_complex_` (kernel Bc, for ``_pass_b_kernel`` with
  ``n_filt == 2``): the same with a complex filter, the Hermitian inverse
  filter of :func:`prepare_hermitian_filter`; A, Bc and C are
  :func:`fourier_filter_zyx` (``fourier_filter_zyx_pallas``), the
  reconstructions' Tikhonov inverse;
- :func:`inv_yx` (kernel C, for ``_inv_yx_kernel``): inverse DFT along Y
  and irfft along X of each z slice, real ZYX out;
- :func:`z_cross_` (kernel Bx, for ``_pass_b_cross_kernel``): DFT along Z
  of two spectra, their phase cross-power, inverse DFT along Z. A, A, Bx
  and C are the phase cross-correlation (:mod:`biahub_tpu_torch.kernels.
  pcc`);
- :func:`z_fwd_filter_` (kernel K, for ``pallas_spectral.py``'s
  ``_fwd_z_filter_kernel``): DFT along Z times a real or complex filter,
  in place, no inverse;
- :func:`y_inv_` (kernel L, for ``_inv_y_pad_kernel``): inverse DFT along
  Y, in place: kernel C's column phase alone (:func:`column_plan`). A, K, L and kernel M (:mod:`biahub_tpu_torch.kernels.
  spectral_cuda`) are the spectral deskew (:mod:`biahub_tpu_torch.kernels.
  spectral`).

The spectrum is the (Z, Y, X//2+1) complex64 rfft half-spectrum, the layout
of ``torch.fft.rfftn``; the TPU engine's split re/im arrays, Nyquist peel,
radix layouts and ky-parity filter blocks exist only for the MXU and are not
carried over. Each wrapper takes its plain PyTorch version (``*_plain``)
for a CPU tensor and launches its kernel for a CUDA tensor, or raises.
The kernels take axes of any length within their shared-memory limits
(:func:`max_axis`). A and C run a 2,3,5,7,11-smooth axis as mixed-radix
passes (:func:`radix_plan`) and any other as a Bluestein chirp convolution,
one thread-block cluster per z slice (:func:`slice_plan`); B and Bc run Z
on the same passes (Bluestein too on them, at :func:`z_line_length`), tiles
of consecutive (ky, kx) lines (:func:`z_plan`), and Bx the same passes in
double on tiles of both spectra's lines (:func:`cross_plan`); L runs C's
column passes, one block a column tile (:func:`column_plan`); K runs a
power of two as one radix-2 FFT and any other length as Bluestein.
"""

from __future__ import annotations

import ctypes
import functools
import math
import sys
from dataclasses import dataclass

import numpy as np
import torch

from biahub_tpu_torch.device import resolve_device
from biahub_tpu_torch.kernels import _build

__all__ = [
    "fwd_yx", "z_filter_", "z_filter_complex_", "inv_yx", "z_cross_",
    "fwd_yx_plain", "z_filter_plain_", "z_filter_complex_plain_", "inv_yx_plain",
    "z_cross_plain_", "z_fwd_filter_", "y_inv_", "z_fwd_filter_plain_", "y_inv_plain_",
    "cross_power", "prepare_fourier_filter", "prepare_hermitian_filter",
    "fourier_filter_zyx", "PASS_A_DTYPES", "half_spectrum_shape", "NORMALIZATIONS",
    "max_axis", "max_cross_z", "radix_plan", "SlicePlan", "slice_plan", "z_line_length",
    "ZPlan", "z_plan", "z_line_table", "deconvolve_limit", "pcc_limit", "takes_torch_fft",
    "filter_torch_fft", "XPlan", "cross_plan", "cross_table", "ColumnPlan", "column_plan",
]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# A and C take their slice plan (SlicePlan.args) before Z, Y, X.
_PLAN = [_L, _L, _I, _I, _I, _I, _I, _I]
# B and Bc take their Z-line plan (ZPlan.args) before Z and the lines.
_ZPLAN = [_L, _I, _I, _I, _I, _I, _I, _I, _I]
_SIGNATURES = {
    "fwd_yx": [_P, _I, _P, *_PLAN, _I, _I, _I, _P],
    "z_filter": [_P, _P, _P, *_ZPLAN, _I, _I, _P],
    "z_filter_complex": [_P, _P, _P, *_ZPLAN, _I, _I, _P],
    "inv_yx": [_P, _P, *_PLAN, _I, _I, _I, _P],
    "z_cross": [_P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "z_fwd_filter": [_P, _P, _I, _I, _I, _I, _P],
    "y_inv": [_P, _L, _I, _I, _I, _I, _I, _I, _I, _P],
}
# In K and L a line of n points runs on a radix-2 FFT of M points: M = n
# for a power of two, else the least power of two >= 2n - 1 (Bluestein);
# A, B, Bc and C take the same lengths (B and Bc's Bluestein M is
# z_line_length's, never above 8192 for n <= 4096). A row (X) or column
# tile (Y, Z) of M points and an axis' tables must fit a block's shared
# memory: M <= 8192, so powers of two up to 8192 and other lengths up to
# 4096.
_MAX_POW2, _MAX_OTHER = 8192, 4096
# Kernel Bx holds a tile of both spectra's Z-lines, one line each at the
# least, in double in shared memory (cross_plan): Z up to 2048 for a power
# of two, else up to 1024 (Bluestein's M = 2048 with its chirp and K read
# from device memory).
_MAX_CROSS_POW2, _MAX_CROSS_OTHER = 2048, 1024
# The phase cross-power's normalizations, by kernel Bx's code.
NORMALIZATIONS = {None: 0, "magnitude": 1, "classic": 2}
_F32_EPS = float(np.finfo(np.float32).eps)


def half_spectrum_shape(shape) -> tuple[int, int, int]:
    z, y, x = (int(s) for s in shape)
    return z, y, x // 2 + 1


# The dtypes kernel A reads as they are (the counterpart of
# pallas_fft.pass_a_native_dtype_ok): float32, and uint16, the camera dtype,
# which converts to float32 exactly in registers. Callers cast any other
# dtype to float32 first.
PASS_A_DTYPES = (torch.float32, torch.uint16)


def prepare_fourier_filter(shape, transfer_function_half, regularization_strength,
                           device: torch.device | str = "cuda") -> torch.Tensor:
    """The Tikhonov filter ``tf / (tf*tf + reg)`` as one float32 (Z, Y,
    X//2+1) tensor, the layout kernel B reads; computed in float32 in the
    order of ``pallas_fft.prepare_fourier_filter``, so it is bit-identical to
    the reference's. Constant across an acquisition: callers hoist it."""
    tf = transfer_function_half
    tf = torch.from_numpy(np.asarray(tf)) if not isinstance(tf, torch.Tensor) else tf
    tf = tf.to(device=resolve_device(device), dtype=torch.float32).contiguous()
    if tuple(tf.shape) != half_spectrum_shape(shape):
        raise ValueError(
            f"transfer function half {tuple(tf.shape)} does not match volume "
            f"shape {tuple(shape)} (want {half_spectrum_shape(shape)})"
        )
    reg = torch.tensor(float(regularization_strength), dtype=torch.float32)
    return tf / (tf * tf + reg.to(tf.device))


def _is_pow2(n: int) -> bool:
    return n & (n - 1) == 0


def max_axis(n: int) -> int:
    """The longest axis kernels A, B, Bc and C take of ``n``'s kind: 8192
    for a power of two, 4096 for any other length."""
    return _MAX_POW2 if _is_pow2(n) else _MAX_OTHER


def max_cross_z(z: int) -> int:
    """Kernel Bx's longest Z of ``z``'s kind: 2048 for a power of two, 1024
    for any other length."""
    return _MAX_CROSS_POW2 if _is_pow2(z) else _MAX_CROSS_OTHER


# Kernels A and C (csrc/fft_radix.cuh): the radices a line's Stockham passes
# take, and the odd ones in the order they are taken.
RADICES = (2, 3, 4, 5, 7, 8, 11, 16)
_ODD_RADICES = (11, 7, 5, 3)
# A and C run 256-thread blocks. Two fit an SM (228 KB of shared memory,
# 1 KB of it reserved per block) at 112 KB each; a tile that needs more
# takes up to the 227 KB one block may have, and one block an SM.
_SLICE_THREADS = 256
_SMEM_TWO, _SMEM_ONE = 112 * 1024, 227 * 1024
_MAX_PAIRS, _MAX_LOG2TK = 16, 5
_MAX_CLUSTER = 8  # the portable cluster size


def radix_plan(n: int) -> tuple[int, ...] | None:
    """The radices of a mixed-radix line of ``n`` points (kernels A, B, Bc
    and C), in pass order: the factor 2**a in ceil(a / 4) passes of at most
    16 (the larger first), then each factor 11, 7, 5 and 3. None when ``n``
    has a prime factor above 11: that line runs Bluestein's chirp
    convolution."""
    if n < 2:
        raise ValueError(f"radix_plan: n = {n}, want at least 2")
    rest, a = n, 0
    while rest % 2 == 0:
        rest //= 2
        a += 1
    odd = []
    for p in _ODD_RADICES:
        while rest % p == 0:
            rest //= p
            odd.append(p)
    if rest != 1:
        return None
    passes = -(-a // 4)
    bits = [a // passes + (i < a % passes) for i in range(passes)]
    return tuple(1 << b for b in bits) + tuple(odd)


def _plan_code(radices) -> int:
    """The C side's packing of a plan: 5 bits a radix, first pass lowest
    (0: Bluestein)."""
    return sum(r << (5 * i) for i, r in enumerate(radices or ()))


def _padded(e: int) -> int:
    """Elements of a padded tile of e points (one float2 in 16, pad())."""
    return e + (e >> 4) + 1


def _bluestein_m(n: int) -> int:
    """The radix-2 length of a Bluestein line: the least power of two >= 2n - 1."""
    return 1 << (2 * n - 2).bit_length()


def _axis_need(n: int, radices, lines: int, buffers: int) -> tuple[int, int]:
    """(table, tile) float2 elements of an axis' phase with ``lines`` lines:
    the radix twiddles and ``buffers`` padded tiles, or Bluestein's tables
    (fft_lines.cuh table_elems) and one tile of M-point lines."""
    if radices:
        return n, buffers * _padded(lines * n)
    m = _bluestein_m(n)
    return m // 2 + n + m, lines * m


def _buffers(radices, last_in_smem: bool) -> int:
    """Shared tiles a radix phase alternates between. The first pass reads
    device memory and, unless ``last_in_smem`` (A's rows, kept for their
    split), the last writes it: one tile holds the lines between them for
    a plan of at most two passes (one with ``last_in_smem``), two tiles for
    more. fft.cu's plan_fits counts them the same way."""
    return 1 if len(radices or ()) <= (1 if last_in_smem else 2) else 2


@dataclass(frozen=True)
class SlicePlan:
    """Launch plan of kernels A and C for one (Z, Y, X) volume."""

    y: tuple[int, ...] | None  # radices of Y's lines (None: Bluestein)
    x: tuple[int, ...] | None  # radices of X's lines
    pairs: int  # row pairs per row tile
    log2tk: int  # log2 of the kx columns per column tile
    ytab: int  # table elements of the column phase
    xtab: int  # table elements of the row phase
    cluster: int  # blocks per z slice
    smem: int  # dynamic shared memory of a block, bytes
    grid: int  # blocks
    per_sm: int  # blocks an SM holds at this shared memory

    def args(self) -> tuple[int, ...]:
        """The C entries' plan arguments."""
        return (_plan_code(self.y), _plan_code(self.x), self.pairs, self.log2tk, self.ytab,
                self.xtab, self.cluster, self.smem)

    def describe(self) -> str:
        def axis(r):
            return "x".join(map(str, r)) if r else "Bluestein"

        return (f"Y {axis(self.y)}, X {axis(self.x)}, cluster {self.cluster}, grid "
                f"{self.grid}, {_SLICE_THREADS} threads, {self.pairs} row pairs, "
                f"{1 << self.log2tk} columns a tile, {self.smem} B shared, "
                f"{self.per_sm} blocks/SM")


def slice_plan(shape) -> SlicePlan:
    """Kernels A and C's plan for a (Z, Y, X) volume: each axis' radices,
    the widest row and column tiles (powers of two, at most 16 row pairs
    and 32 columns) that let two blocks share an SM (else one), and 8
    blocks per z slice (fewer when the slice has fewer tiles). On an H100
    (132 SMs) 8 gave the least time, or within 6% of it, at every shape a
    path gives A and C (Z from 64 to 256) in chip_smoke.py's sweep over 1,
    2, 4 and 8; at Z = 64 and 86 one block a slice leaves SMs idle."""
    z, y, x = (int(s) for s in shape)
    ry, rx = radix_plan(y), radix_plan(x)
    xh, npairs = x // 2 + 1, (y + 1) // 2
    ybufs, xbufs = _buffers(ry, False), _buffers(rx, True)
    for budget, per_sm in ((_SMEM_TWO, 2), (_SMEM_ONE, 1)):
        room = budget // 8
        pairs = next((p for p in (1 << i for i in range(_MAX_PAIRS.bit_length() - 1, -1, -1))
                      if sum(_axis_need(x, rx, p, xbufs)) <= room), None)
        log2tk = next((l for l in range(_MAX_LOG2TK, -1, -1)
                       if sum(_axis_need(y, ry, 1 << l, ybufs)) <= room), None)
        if pairs is not None and log2tk is not None:
            break
    else:
        raise ValueError(f"slice_plan: Y = {y}, X = {x} exceed a block's shared memory")
    pairs = min(pairs, 1 << (npairs - 1).bit_length())
    log2tk = min(log2tk, (xh - 1).bit_length())
    ytab, ybuf = _axis_need(y, ry, 1 << log2tk, ybufs)
    xtab, xbuf = _axis_need(x, rx, pairs, xbufs)
    tiles = max(-(-npairs // pairs), -(-xh >> log2tk))
    cluster = _MAX_CLUSTER
    while cluster > tiles:
        cluster //= 2
    return SlicePlan(ry, rx, pairs, log2tk, ytab, xtab, cluster,
                     8 * max(ytab + ybuf, xtab + xbuf), z * cluster, per_sm)


@dataclass(frozen=True)
class ColumnPlan:
    """Launch plan of kernel L (csrc/fft.cu y_inv_kernel) for one (Z, Y,
    X//2+1) spectrum: kernel C's column phase, one block a column tile."""

    y: tuple[int, ...] | None  # radices of Y's lines (None: Bluestein)
    log2tk: int  # log2 of the kx columns per column tile
    ytab: int  # table elements
    tiles: int  # column tiles (blocks) per kz slice
    smem: int  # dynamic shared memory of a block, bytes
    per_sm: int  # blocks an SM holds at this shared memory

    def args(self) -> tuple[int, ...]:
        """The C entry's plan arguments."""
        return _plan_code(self.y), self.log2tk, self.ytab, self.tiles, self.smem

    def describe(self) -> str:
        axis = "x".join(map(str, self.y)) if self.y else "Bluestein"
        return (f"Y {axis}, {1 << self.log2tk} columns a tile, {self.tiles} tiles a slice, "
                f"{_SLICE_THREADS} threads, {self.smem} B shared, {self.per_sm} blocks/SM")


@functools.lru_cache(maxsize=64)
def _column_plan(y: int, xh: int) -> ColumnPlan:
    ry = radix_plan(y)
    bufs = _buffers(ry, False)
    for budget, per_sm in ((_SMEM_TWO, 2), (_SMEM_ONE, 1)):
        log2tk = next((l for l in range(_MAX_LOG2TK, -1, -1)
                       if sum(_axis_need(y, ry, 1 << l, bufs)) <= budget // 8), None)
        if log2tk is not None:
            break
    else:
        raise ValueError(f"column_plan: Y = {y} exceeds a block's shared memory")
    log2tk = min(log2tk, (xh - 1).bit_length())
    ytab, ybuf = _axis_need(y, ry, 1 << log2tk, bufs)
    return ColumnPlan(ry, log2tk, ytab, -(-xh >> log2tk), 8 * (ytab + ybuf), per_sm)


def column_plan(shape) -> ColumnPlan:
    """Kernel L's plan for a (Z, Y, X//2+1) spectrum: Y's radices
    (:func:`radix_plan`) and the widest column tile (a power of two, at
    most 32 columns, no wider than the kx axis) that lets two blocks share
    an SM (else one), as :func:`slice_plan` picks C's; one block per tile
    of each kz slice, which needs no cluster: the column phase is the
    kernel's only phase."""
    _, y, xh = (int(s) for s in shape)
    return _column_plan(y, xh)


@functools.lru_cache(maxsize=64)
def z_line_length(n: int) -> int:
    """The points of the line kernels B and Bc run a Z of ``n`` points on:
    ``n`` when :func:`radix_plan` takes it, else the length M of Bluestein's
    circular convolution, the M >= 2n - 1 whose radices take the least
    passes x M (one transform's work), the smaller on a tie: 176 = 16 x 11
    (two passes) for n = 86, where 175 = 5 x 5 x 7 would take three. M <=
    8192 for n <= 4096."""
    if radix_plan(n):
        return n
    best = None
    for m in range(2 * n - 1, 4 * n):
        r = radix_plan(m)
        if r is not None and (best is None or len(r) * m < best[0]):
            best = (len(r) * m, m)
    return best[1]


# B and Bc run blocks of at most 256 threads at up to 128 registers (two
# blocks an SM), tiles of up to 16 lines.
_Z_THREADS, _Z_MAX_LOG2TK = 256, 4


@dataclass(frozen=True)
class ZPlan:
    """Launch plan of kernels B and Bc (csrc/fft.cu z_line_kernel) for
    Z-lines of ``n`` points."""

    n: int  # Z
    m: int  # points of the line the passes run: n, or Bluestein's M
    radices: tuple[int, ...]  # radix_plan(m)
    log2tk: int  # log2 of the lines (consecutive (ky, kx) columns) a tile
    threads: int  # of a block
    stages: int  # tiles staged: 2, the next one's copies in flight while this one runs
    fstage: bool  # the filter staged with its tile (else read in place)
    tab_smem: bool  # a Bluestein line's chirp and K copied to shared memory
    complex_filter: bool  # Bc
    smem: int  # dynamic shared memory of a block, bytes
    per_sm: int  # blocks an SM holds

    def grid(self, lines: int, sms: int) -> int:
        """Blocks for ``lines`` Z-lines on ``sms`` SMs: every SM full, each
        block walking its tiles, at most one block a tile."""
        return max(1, min(-(-lines >> self.log2tk), sms * self.per_sm))

    def args(self, grid: int) -> tuple[int, ...]:
        """The C entries' plan arguments."""
        return (_plan_code(self.radices), self.m, self.log2tk, self.threads, self.stages,
                int(self.fstage), int(self.tab_smem), grid, self.smem)

    def describe(self) -> str:
        line = "x".join(map(str, self.radices))
        kind = f"Bluestein on {self.m} = {line}" if self.m != self.n else line
        return (f"Z {self.n} ({kind}), {1 << self.log2tk} lines a tile, {self.threads} "
                f"threads, {self.stages} stage(s), filter "
                f"{'staged' if self.fstage else 'read in place'}, "
                f"{'' if self.tab_smem or self.m == self.n else 'chirp in L1/L2, '}"
                f"{self.smem} B shared, {self.per_sm} blocks/SM")


def _z_plan_smem(n, m, tk, stages, fstage, tab_smem, complex_filter) -> int:
    """Bytes of B's shared memory (fft.cu z_line_kernel's layout): the m -
    1 twiddles (and with ``tab_smem`` a Bluestein line's n + m chirp and K
    entries), the stage tiles and the work tile (padded, m points a line),
    the filter's stages (n points a line)."""
    tab = m - 1 + (n + m if m != n and tab_smem else 0)
    filt = stages * tk * n * (8 if complex_filter else 4) if fstage else 0
    return 8 * (tab + (stages + 1) * _padded(tk * m)) + filt


# (stages, filter staged, chirp in shared memory), in the order z_plan
# tries them at a tile width.
_Z_LAYOUTS = ((2, True, True), (1, True, True), (1, False, True), (1, False, False))


def _z_layout(n: int, log2tk: int, stages: int, fstage: bool, tab_smem: bool,
              complex_filter: bool) -> ZPlan:
    """Kernel B's plan for Z = ``n`` at one tile width and one of
    :data:`_Z_LAYOUTS`, whether or not it fits a block."""
    m = z_line_length(n)
    radices = radix_plan(m)
    tk = 1 << log2tk
    smem = _z_plan_smem(n, m, tk, stages, fstage, tab_smem, complex_filter)
    threads = min(_Z_THREADS, max(32, -(-(tk * m // min(radices)) // 32) * 32))
    per_sm = min((_SMEM_ONE + 1024) // (smem + 1024), 65536 // (128 * threads))
    return ZPlan(n, m, radices, log2tk, threads, stages, fstage, tab_smem, complex_filter,
                 smem, per_sm)


@functools.lru_cache(maxsize=64)
def z_plan(n: int, complex_filter: bool = False) -> ZPlan:
    """Kernel B's (Bc's with ``complex_filter``) plan for Z = ``n``: the
    widest tile (at most 16 lines) at which two blocks share an SM, with the
    next tile and its filter in flight (two stages) where they fit, else one
    stage; failing that one block an SM, the filter read in place, and last
    a Bluestein line's chirp and K read from device memory (Z up to 8192).
    The line (its radices) depends on Z alone. chip_smoke.py phase 18 times
    the plan beside 8-line tiles at the paths' shapes."""
    for budget in (_SMEM_TWO, _SMEM_ONE):
        for l2 in range(_Z_MAX_LOG2TK, -1, -1):
            for layout in _Z_LAYOUTS:
                plan = _z_layout(n, l2, *layout, complex_filter)
                if plan.smem <= budget:
                    return plan
    raise ValueError(f"z_plan: Z = {n} exceeds a block's shared memory")


def z_line_table(plan: ZPlan) -> np.ndarray:
    """Kernel B's table for a plan (complex64, m - 1 entries, n + m more for
    Bluestein):
    the twiddles of ``plan.radices``' passes over ``plan.m`` points in
    fft_radix.cuh's layout (pass p's factor exp(-2 pi i q k / (ns r)) at ns -
    1 + (q - 1) ns + k); for a Bluestein line then the chirp w_k = exp(-i pi
    k^2 / n) (n entries, the phase reduced as k^2 mod 2n) and the kernel's
    spectrum fft(conj(w) wrapped to m) / m (m entries). Formed in float64."""
    return _line_table(plan.n, plan.radices).astype(np.complex64)


@functools.lru_cache(maxsize=16)
def _line_table(n: int, radices: tuple[int, ...]) -> np.ndarray:
    """The table of :func:`z_line_table` and :func:`cross_table` in
    complex128."""
    m = math.prod(radices)
    tw = np.empty(m - 1, np.complex128)
    ns = 1
    for r in radices:
        q, k = np.divmod(np.arange((r - 1) * ns), ns)
        tw[ns - 1:ns - 1 + (r - 1) * ns] = np.exp(-2j * np.pi * ((q + 1) * k) / (ns * r))
        ns *= r
    if m == n:
        return tw
    k = np.arange(n)
    w = np.exp(-1j * np.pi * ((k * k) % (2 * n)) / n)
    g = np.zeros(m, np.complex128)
    g[:n] = np.conj(w)
    g[m - n + 1:] = np.conj(w[1:][::-1])
    return np.concatenate([tw, w, np.fft.fft(g) / m])


_tables: dict = {}


def _table_on(plan, device: torch.device) -> torch.Tensor:
    """:func:`z_line_table` (a :class:`ZPlan`) or :func:`cross_table` (an
    :class:`XPlan`) on ``device``, built once per (kernel, line, device)."""
    key = (type(plan), plan.n, plan.radices, device)
    if key not in _tables:
        table = z_line_table(plan) if isinstance(plan, ZPlan) else cross_table(plan)
        _tables[key] = torch.from_numpy(table).to(device)
    return _tables[key]


@functools.lru_cache(maxsize=8)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@dataclass(frozen=True)
class XPlan:
    """Launch plan of kernel Bx (csrc/fft.cu z_cross_kernel) for Z-lines of
    ``n`` points."""

    n: int  # Z
    m: int  # points of the line the passes run: n, or Bluestein's M
    radices: tuple[int, ...]  # radix_plan(m), smallest first
    log2tk: int  # log2 of the lines of each spectrum a tile
    threads: int  # of a block
    stages: int  # tiles staged: 2, the next one's copies in flight while this one runs
    tab_smem: bool  # a Bluestein line's chirp and K copied to shared memory
    smem: int  # dynamic shared memory of a block, bytes
    per_sm: int  # blocks an SM holds

    def grid(self, lines: int, sms: int) -> int:
        """Blocks for ``lines`` Z-lines of each spectrum on ``sms`` SMs."""
        return max(1, min(-(-lines >> self.log2tk), sms * self.per_sm))

    def args(self, grid: int) -> tuple[int, ...]:
        """The C entry's plan arguments."""
        return (_plan_code(self.radices), self.m, self.log2tk, self.threads, self.stages,
                int(self.tab_smem), grid, self.smem)

    def describe(self) -> str:
        line = "x".join(map(str, self.radices))
        kind = f"Bluestein on {self.m} = {line}" if self.m != self.n else line
        return (f"Z {self.n} ({kind}, double), {1 << self.log2tk} lines of each spectrum a "
                f"tile, {self.threads} threads, {self.stages} stage(s), "
                f"{'' if self.tab_smem or self.m == self.n else 'chirp in L1/L2, '}"
                f"{self.smem} B shared, {self.per_sm} blocks/SM")


def _cross_plan_smem(n, m, tk, stages, tab_smem) -> int:
    """Bytes of Bx's shared memory (fft.cu cross_smem): the m - 1 double
    twiddles (and with ``tab_smem`` a Bluestein line's n + m chirp and K
    entries), two work tiles of 2tk lines of m double2 points, the float2
    stages of 2tk lines of n points."""
    tab = m - 1 + (n + m if m != n and tab_smem else 0)
    return 16 * (tab + 2 * _padded(2 * tk * m)) + 8 * stages * _padded(2 * tk * n)


# (stages, chirp in shared memory), in the order cross_plan tries them at
# a tile width; Bx runs blocks of at most 128 threads (csrc/fft.cu
# __launch_bounds__(128, 3): up to 170 registers, so a double radix-16
# butterfly does not spill), tiles of up to 16 lines of each spectrum.
_X_LAYOUTS = ((2, True), (1, True), (1, False))
_X_THREADS, _X_BLOCKS, _X_MAX_LOG2TK = 128, 3, 4


@functools.lru_cache(maxsize=64)
def cross_plan(n: int) -> XPlan:
    """Kernel Bx's plan for Z = ``n``: the next tile in flight (two stages)
    where it fits at two blocks an SM, at the widest tile (at most 16 lines
    of each spectrum) that allows; else one stage; failing that one block
    an SM, and last a Bluestein line's chirp and K read from device
    memory. The line depends on Z alone: B's radices (:func:`radix_plan`)
    over ``n``, or over :func:`z_line_length`'s M, smallest first (64 = 8 x
    8, 77 = 7 x 11, 176 = 11 x 16). On an H100 (NVIDIA H100 80GB HBM3,
    700 W) 8 x 8 beat 16 x 4 and 4 x 16 at the PCC crop, 7 x 11 beat 11 x
    7 and 11 x 16 beat 16 x 11, two stages of 8 lines beat one of 16 at Z
    = 77, and blocks of 128 threads beat 256."""
    m = z_line_length(n)
    radices = tuple(sorted(radix_plan(m)))
    for budget in (_SMEM_TWO, _SMEM_ONE):
        for stages, tab_smem in _X_LAYOUTS:
            for l2 in range(_X_MAX_LOG2TK, -1, -1):
                tk = 1 << l2
                smem = _cross_plan_smem(n, m, tk, stages, tab_smem)
                if smem <= budget:
                    threads = min(_X_THREADS,
                                  max(32, -(-(2 * tk * m // min(radices)) // 32) * 32))
                    per_sm = min(_X_BLOCKS, (_SMEM_ONE + 1024) // (smem + 1024))
                    return XPlan(n, m, radices, l2, threads, stages, tab_smem, smem, per_sm)
    raise ValueError(f"cross_plan: Z = {n} exceeds a block's shared memory")


def cross_table(plan: XPlan) -> np.ndarray:
    """Kernel Bx's table for a plan: :func:`z_line_table`'s entries for the
    line of ``plan``, left in complex128."""
    return _line_table(plan.n, plan.radices).copy()


def prepare_hermitian_filter(shape, transfer_function, regularization_strength,
                             device: torch.device | str = "cuda") -> torch.Tensor:
    """The Tikhonov inverse ``conj(H_half) / (abs(H_half)**2 + reg)`` of a
    Hermitian transfer function ``H`` (Z, Y, X) as one complex64 (Z, Y,
    X//2+1) tensor, the filter kernel Bc reads; ``H_half = H[..., :X//2+1]``,
    formed in complex64 in the order of the reference's
    ``tikhonov_inverse_3d`` (recon/optics.py:194-197). Constant across an
    acquisition: callers hoist it."""
    h = transfer_function
    h = torch.from_numpy(np.asarray(h)) if not isinstance(h, torch.Tensor) else h
    if tuple(h.shape) != tuple(int(s) for s in shape):
        raise ValueError(f"transfer function {tuple(h.shape)} does not match volume "
                         f"shape {tuple(shape)}")
    h = h.to(device=resolve_device(device), dtype=torch.complex64)[
        ..., : half_spectrum_shape(shape)[2]]
    denom = h.abs() ** 2 + float(regularization_strength)
    return torch.complex(h.real / denom, -h.imag / denom).contiguous()


def fwd_yx_plain(volume: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of kernel A."""
    spec = torch.fft.rfftn(volume.to(torch.float32), dim=(1, 2))
    return spec if out is None else out.copy_(spec)


def z_filter_plain_(spectrum: torch.Tensor, filt: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel B (in place)."""
    return spectrum.copy_(torch.fft.ifft(torch.fft.fft(spectrum, dim=0) * filt, dim=0))


# Kernel Bc's plain version is kernel B's expression with a complex filter.
z_filter_complex_plain_ = z_filter_plain_


def inv_yx_plain(spectrum: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of kernel C (overwrites ``spectrum`` as the kernel does)."""
    x = 2 * (spectrum.shape[2] - 1) if out is None else out.shape[-1]
    spectrum.copy_(torch.fft.ifft(spectrum, dim=1))
    real = torch.fft.irfft(spectrum, n=x, dim=2)
    return real if out is None else out.copy_(real)


def z_fwd_filter_plain_(spectrum: torch.Tensor, filt: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel K (in place)."""
    return spectrum.copy_(torch.fft.fft(spectrum, dim=0) * filt)


def y_inv_plain_(spectrum: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel L (in place)."""
    return spectrum.copy_(torch.fft.ifft(spectrum, dim=1))


def _norm_code(normalization) -> int:
    if normalization not in NORMALIZATIONS:
        raise ValueError(f"normalization must be one of {list(NORMALIZATIONS)}, "
                         f"got {normalization!r}")
    return NORMALIZATIONS[normalization]


def cross_power(h1: torch.Tensor, h2: torch.Tensor, normalization) -> torch.Tensor:
    """``h1 * conj(h2)``, divided by ``max(|c|, eps)`` ("magnitude") or by
    ``max(sqrt(|h1|^2 |h2|^2), eps)`` ("classic"), formed as the reference's
    Pallas ``_cross_power`` (pallas_fft.py:1317-1335) and kernel Bx form
    them; eps is float32's."""
    _norm_code(normalization)
    prod = h1 * h2.conj()
    if normalization is None:
        return prod
    cr, ci = prod.real, prod.imag
    if normalization == "magnitude":
        denom = torch.sqrt(cr * cr + ci * ci)
    else:
        denom = torch.sqrt((h1.real * h1.real + h1.imag * h1.imag)
                           * (h2.real * h2.real + h2.imag * h2.imag))
    denom = denom.clamp_min(_F32_EPS)
    return torch.complex(cr / denom, ci / denom)


def z_cross_plain_(ref_spec: torch.Tensor, mov_spec: torch.Tensor, out: torch.Tensor,
                   normalization=None) -> torch.Tensor:
    """Plain version of kernel Bx (into ``out``; ``ref_spec`` is kept)."""
    h1 = torch.fft.fft(ref_spec, dim=0)
    h2 = torch.fft.fft(mov_spec, dim=0)
    return out.copy_(torch.fft.ifft(cross_power(h1, h2, normalization), dim=0))


def _lib():
    return _build.library("fft", _SIGNATURES)


def _axes_limit(axes, shape=None) -> str | None:
    """Why the kernels do not take every axis of ``axes`` (of a volume of
    ``shape``, the axes by default), or None."""
    for n in axes:
        if n < 2 or n > max_axis(n):
            return (f"the CUDA kernels take axes of 2 to {_MAX_POW2} points when a power of "
                    f"two and 2 to {_MAX_OTHER} otherwise, got {tuple(shape or axes)}")
    return None


def _slices_limit(shape) -> str | None:
    """Kernels A and C: a cluster of at most 8 blocks per z slice, which they
    do not transform (Z from 1 to 2**28 - 1, so the grid stays under
    2**31); Y and X as :func:`_axes_limit`."""
    if not 1 <= shape[0] < 2**28:
        return f"Z = {shape[0]} z slices, want 1 to 2**28 - 1 (the grid)"
    return _axes_limit(shape[1:], shape)


def _cross_z_limit(z: int) -> str | None:
    """Kernel Bx's Z: 2 to 2048 when a power of two, 2 to 1024 otherwise."""
    if z > max_cross_z(z):
        kind = "a power of two" if _is_pow2(z) else "other lengths"
        return (f"Z = {z} exceeds the kernel's limit of {max_cross_z(z)} for {kind} (a "
                "line of each spectrum, in double, in a block's shared memory)")
    return _axes_limit((z,))


def _raise_if(limit: str | None, what: str) -> None:
    if limit is not None:
        raise ValueError(f"{what}: {limit}")


def _check_cuda_shape(shape, what: str) -> None:
    _raise_if(_axes_limit(shape), what)


def _check_slices(shape, what: str) -> None:
    _raise_if(_slices_limit(shape), what)


def deconvolve_limit(shape) -> str | None:
    """Why kernels A, B and C do not take a (Z, Y, X) volume of ``shape``
    (the checks their wrappers raise on), or None when they do. The
    counterpart of the reference's ``deconvolve_pallas_supported``
    (pallas_fft.py:652): where it is not None, deconvolution takes
    ``torch.fft`` as the reference takes XLA's FFT."""
    shape = tuple(int(s) for s in shape)
    return _slices_limit(shape) or _axes_limit(shape[:1], shape)


def takes_torch_fft(what: str, shape) -> bool:
    """Whether a deconvolution or Tikhonov filter of a (Z, Y, X) volume of
    ``shape`` takes ``torch.fft`` (:func:`filter_torch_fft`) because
    kernels A, B, Bc and C do not take it (:func:`deconvolve_limit`), as
    the reference takes XLA's FFT past ``deconvolve_pallas_supported``;
    decided from the shape before any launch, and said in one stderr line
    naming ``what``, the shape and the limit."""
    shape = tuple(int(s) for s in shape)
    limit = deconvolve_limit(shape)
    if limit is not None:
        print(f"{what}: {shape} takes torch.fft: {limit}", file=sys.stderr)
    return limit is not None


def filter_torch_fft(volume: torch.Tensor, filt: torch.Tensor,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """``irfftn(rfftn(volume) * filt)`` of one (Z, Y, X) volume in
    ``torch.fft``, with a real (:func:`prepare_fourier_filter`) or complex
    (:func:`prepare_hermitian_filter`) half-spectrum filter, into ``out``
    (new when None): the route of a shape past :func:`deconvolve_limit`."""
    res = torch.fft.irfftn(torch.fft.rfftn(volume.to(torch.float32)) * filt.to(volume.device),
                           s=tuple(volume.shape))
    return res if out is None else out.copy_(res)


def pcc_limit(shape) -> str | None:
    """Why kernels A, Bx and C do not take a pair of (Z, Y, X) volumes of
    ``shape``, or None when they do (the reference's
    ``pcc_pallas_supported``, pallas_fft.py:1499)."""
    shape = tuple(int(s) for s in shape)
    return _slices_limit(shape) or _cross_z_limit(shape[0])


def _check_grid_y(y: int, what: str) -> None:
    if y > 65535:
        raise ValueError(f"{what}: Y = {y} exceeds the kernel's grid (65535)")


def _check(t: torch.Tensor, what: str, ndim: int, dtypes) -> None:
    if t.ndim != ndim or t.dtype not in dtypes:
        raise ValueError(f"{what}: want a {ndim}-d {dtypes} tensor, got "
                         f"{tuple(t.shape)} {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: tensor must be contiguous")


def _check_out(out, shape, dtype, like: torch.Tensor, what: str) -> torch.Tensor:
    if out is None:
        return torch.empty(shape, dtype=dtype, device=like.device)
    if tuple(out.shape) != tuple(shape) or out.dtype != dtype or not out.is_contiguous():
        raise ValueError(f"{what}: out must be contiguous {dtype} {tuple(shape)}, "
                         f"got {out.dtype} {tuple(out.shape)}")
    if out.device != like.device:
        raise ValueError(f"{what}: out on {out.device}, input on {like.device}")
    return out


def fwd_yx(volume: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel A: (Z, Y, X) float32 or uint16 -> (Z, Y, X//2+1) complex64,
    ``rfftn`` over the Y and X axes (no scaling)."""
    _check(volume, "fwd_yx", 3, PASS_A_DTYPES)
    spec_shape = half_spectrum_shape(volume.shape)
    out = _check_out(out, spec_shape, torch.complex64, volume, "fwd_yx")
    if not _build.on_card(volume, "fwd_yx"):
        return fwd_yx_plain(volume, out)
    _check_slices(volume.shape, "fwd_yx")
    lib = _lib()
    z, y, x = volume.shape
    plan = slice_plan(volume.shape)
    with torch.cuda.device(volume.device):
        rc = lib.fwd_yx(_build.ptr(volume), int(volume.dtype == torch.uint16),
                        _build.ptr(out), *plan.args(), z, y, x, _build.stream_of(volume))
    _build.check(rc, lib, f"fwd_yx ({plan.describe()})")
    _build.count_launch("fwd_yx")
    return out


def _z_filter(spectrum: torch.Tensor, filt: torch.Tensor, filt_dtype,
              entry: str) -> torch.Tensor:
    """Kernel B or Bc (C entry and launch counter ``entry``), in place."""
    what = f"{entry}_"
    _check(spectrum, what, 3, (torch.complex64,))
    _check(filt, what, 3, (filt_dtype,))
    if filt.shape != spectrum.shape or filt.device != spectrum.device:
        raise ValueError(f"{what}: filter {tuple(filt.shape)} on {filt.device} "
                         f"for spectrum {tuple(spectrum.shape)} on {spectrum.device}")
    if not _build.on_card(spectrum, what):
        return z_filter_plain_(spectrum, filt)
    z, y, xh = spectrum.shape
    _check_cuda_shape((z,), what)
    lib = _lib()
    plan = z_plan(z, filt_dtype == torch.complex64)
    dev = spectrum.device
    with torch.cuda.device(dev):
        grid = plan.grid(y * xh, _sm_count(dev))
        rc = getattr(lib, entry)(_build.ptr(spectrum), _build.ptr(filt),
                                 _build.ptr(_table_on(plan, dev)), *plan.args(grid), z, y * xh,
                                 _build.stream_of(spectrum))
    _build.check(rc, lib, f"{what} ({plan.describe()}, grid {grid})")
    _build.count_launch(entry)
    return spectrum


def z_filter_(spectrum: torch.Tensor, filt: torch.Tensor) -> torch.Tensor:
    """Kernel B, in place: ``spectrum = ifft(fft(spectrum, Z) * filt, Z)``
    (with the inverse's 1/Z). ``filt`` is a :func:`prepare_fourier_filter`
    result of the spectrum's shape."""
    return _z_filter(spectrum, filt, torch.float32, "z_filter")


def z_filter_complex_(spectrum: torch.Tensor, filt: torch.Tensor) -> torch.Tensor:
    """Kernel Bc, in place: kernel B with a complex64 filter, a
    :func:`prepare_hermitian_filter` result of the spectrum's shape.
    Launches count as ``z_filter_complex``."""
    return _z_filter(spectrum, filt, torch.complex64, "z_filter_complex")


def z_fwd_filter_(spectrum: torch.Tensor, filt: torch.Tensor) -> torch.Tensor:
    """Kernel K, in place: ``spectrum = fft(spectrum, Z) * filt`` with no
    inverse and no scaling; ``filt`` is a float32 :func:`prepare_fourier_
    filter` or complex64 :func:`prepare_hermitian_filter` result of the
    spectrum's shape. Launches count as ``z_fwd_filter``."""
    what = "z_fwd_filter_"
    _check(spectrum, what, 3, (torch.complex64,))
    _check(filt, what, 3, (torch.float32, torch.complex64))
    if filt.shape != spectrum.shape or filt.device != spectrum.device:
        raise ValueError(f"{what}: filter {tuple(filt.shape)} on {filt.device} "
                         f"for spectrum {tuple(spectrum.shape)} on {spectrum.device}")
    if not _build.on_card(spectrum, what):
        return z_fwd_filter_plain_(spectrum, filt)
    z, y, xh = spectrum.shape
    _check_cuda_shape((z,), what)
    _check_grid_y(y, what)
    lib = _lib()
    with torch.cuda.device(spectrum.device):
        rc = lib.z_fwd_filter(_build.ptr(spectrum), _build.ptr(filt),
                              int(filt.dtype == torch.complex64), z, y, xh,
                              _build.stream_of(spectrum))
    _build.check(rc, lib, what)
    _build.count_launch("z_fwd_filter")
    return spectrum


def y_inv_(spectrum: torch.Tensor) -> torch.Tensor:
    """Kernel L, in place: ``spectrum = ifft(spectrum, Y)`` (with 1/Y) of
    a (Z, Y, X//2+1) complex64 spectrum. Launches count as ``y_inv``."""
    _check(spectrum, "y_inv_", 3, (torch.complex64,))
    if not _build.on_card(spectrum, "y_inv_"):
        return y_inv_plain_(spectrum)
    z, y, xh = spectrum.shape
    _check_cuda_shape((y,), "y_inv_")
    lib = _lib()
    plan = column_plan(spectrum.shape)
    with torch.cuda.device(spectrum.device):
        rc = lib.y_inv(_build.ptr(spectrum), *plan.args(), z, y, xh,
                       _build.stream_of(spectrum))
    _build.check(rc, lib, f"y_inv_ ({plan.describe()})")
    _build.count_launch("y_inv")
    return spectrum


def fourier_filter_zyx(volume: torch.Tensor, filt: torch.Tensor,
                       out: torch.Tensor | None = None) -> torch.Tensor:
    """``irfftn(rfftn(volume) * filt)`` of one (Z, Y, X) float32 or uint16
    volume with a complex64 half-spectrum filter (a
    :func:`prepare_hermitian_filter` result) into ``out`` (new when None):
    kernels A, Bc and C, or their plain versions for a CPU tensor. The
    counterpart of ``fourier_filter_zyx_pallas`` (pallas_fft.py:1285)."""
    spectrum = fwd_yx(volume)
    z_filter_complex_(spectrum, filt)
    if out is None:
        out = torch.empty(volume.shape, dtype=torch.float32, device=volume.device)
    return inv_yx(spectrum, out=out)


def inv_yx(spectrum: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel C: (Z, Y, X//2+1) complex64 -> (Z, Y, X) float32, ``irfftn``
    over the Y and X axes (with 1/(Y*X)). X is ``out``'s last axis, or
    2*(X//2) without ``out``. ``spectrum`` is left as scratch: both versions
    overwrite it with its inverse along Y."""
    _check(spectrum, "inv_yx", 3, (torch.complex64,))
    z, y, xh = spectrum.shape
    shape = (z, y, 2 * (xh - 1) if out is None else out.shape[-1])
    if shape[2] // 2 + 1 != xh:
        raise ValueError(f"inv_yx: out {tuple(out.shape)} does not fit "
                         f"spectrum {tuple(spectrum.shape)}")
    out = _check_out(out, shape, torch.float32, spectrum, "inv_yx")
    if not _build.on_card(spectrum, "inv_yx"):
        return inv_yx_plain(spectrum, out)
    _check_slices(shape, "inv_yx")
    lib = _lib()
    plan = slice_plan(shape)
    with torch.cuda.device(spectrum.device):
        rc = lib.inv_yx(_build.ptr(spectrum), _build.ptr(out), *plan.args(), *shape,
                        _build.stream_of(spectrum))
    _build.check(rc, lib, f"inv_yx ({plan.describe()})")
    _build.count_launch("inv_yx")
    return out


def z_cross_(ref_spec: torch.Tensor, mov_spec: torch.Tensor, out: torch.Tensor,
             normalization=None) -> torch.Tensor:
    """Kernel Bx: ``out = ifft(cross_power(fft(ref_spec, Z), fft(mov_spec,
    Z)), Z)`` (with the inverse's 1/Z) for two (Z, Y, X//2+1) complex64
    spectra of kernel A. ``out`` may be ``mov_spec``; ``ref_spec`` is never
    written. Launches count as ``z_cross``."""
    for t in (ref_spec, mov_spec, out):
        _check(t, "z_cross_", 3, (torch.complex64,))
    if not (ref_spec.shape == mov_spec.shape == out.shape
            and ref_spec.device == mov_spec.device == out.device):
        raise ValueError(f"z_cross_: spectra {tuple(ref_spec.shape)}, "
                         f"{tuple(mov_spec.shape)} and out {tuple(out.shape)} must "
                         "match in shape and device")
    on_card = _build.on_card(ref_spec, "z_cross_")
    if out.data_ptr() == ref_spec.data_ptr():
        raise ValueError("z_cross_: out must not be ref_spec (it is kept)")
    code = _norm_code(normalization)
    if not on_card:
        return z_cross_plain_(ref_spec, mov_spec, out, normalization)
    z, y, xh = ref_spec.shape
    _check_cross_z(z)
    lines = y * xh
    if lines >= 2**31:
        raise ValueError(f"z_cross_: {lines} Z-lines exceed the kernel's int32 lines")
    lib = _lib()
    plan = cross_plan(z)
    dev = ref_spec.device
    with torch.cuda.device(dev):
        grid = plan.grid(lines, _sm_count(dev))
        rc = lib.z_cross(_build.ptr(ref_spec), _build.ptr(mov_spec), _build.ptr(out),
                         _build.ptr(_table_on(plan, dev)), *plan.args(grid), z, lines, code,
                         _build.stream_of(ref_spec))
    if rc:
        _build.check(rc, lib, f"z_cross_ ({plan.describe()}, grid {grid})")
    _build.count_launch("z_cross")
    return out


def _check_cross_z(z: int) -> None:
    _raise_if(_cross_z_limit(z), "z_cross_")
