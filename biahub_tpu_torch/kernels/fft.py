"""Wrappers of the three FFT deconvolution kernels (``csrc/fft.cu``).

Counterpart of ``biahub_tpu/kernels/pallas_fft.py``'s Tikhonov engine:

- :func:`fwd_yx` (kernel A, for ``_fwd_yx_kernel``): rfft along X and DFT
  along Y of each z slice, float32 or uint16 in, half-spectrum out;
- :func:`z_filter_` (kernel B, for ``_pass_b_kernel``): DFT along Z, times
  the prepared real filter, inverse DFT along Z, in place;
- :func:`inv_yx` (kernel C, for ``_inv_yx_kernel``): inverse DFT along Y
  and irfft along X of each z slice, real ZYX out;
- :func:`z_cross_` (kernel Bx, for ``_pass_b_cross_kernel``): DFT along Z
  of two spectra, their phase cross-power, inverse DFT along Z. A, A, Bx
  and C are the phase cross-correlation (:mod:`biahub_tpu_torch.kernels.
  pcc`).

The spectrum is the (Z, Y, X//2+1) complex64 rfft half-spectrum, the layout
of ``torch.fft.rfftn``; the TPU engine's split re/im arrays, Nyquist peel,
radix layouts and ky-parity filter blocks exist only for the MXU and are not
carried over. Each wrapper takes its plain PyTorch version (``*_plain``)
for a CPU tensor and launches its kernel for a CUDA tensor, or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from biahub_tpu_torch.kernels import _build

__all__ = [
    "fwd_yx", "z_filter_", "inv_yx", "z_cross_",
    "fwd_yx_plain", "z_filter_plain_", "inv_yx_plain", "z_cross_plain_",
    "cross_power", "prepare_fourier_filter", "PASS_A_DTYPES", "half_spectrum_shape",
    "NORMALIZATIONS", "MAX_CROSS_Z",
]

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "fwd_yx": [_P, _I, _P, _I, _I, _I, _P],
    "z_filter": [_P, _P, _I, _I, _I, _P],
    "inv_yx": [_P, _P, _I, _I, _I, _P],
    "z_cross": [_P, _P, _P, _I, _I, _I, _I, _P],
}
# The kernels' radix-2 FFTs take power-of-two axes; one row (X) or column
# tile (Y, Z) must fit the kernels' shared-memory budget.
_MAX_AXIS = 8192
# Kernel Bx holds the Z-lines of two spectra in that budget (96 KB) in
# double precision: at most 3072 per line at one column, so Z <= 2048.
MAX_CROSS_Z = 2048
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
                           device: torch.device | str = "cpu") -> torch.Tensor:
    """The Tikhonov filter ``tf / (tf*tf + reg)`` as one float32 (Z, Y,
    X//2+1) tensor, the layout kernel B reads; computed in float32 in the
    order of ``pallas_fft.prepare_fourier_filter``, so it is bit-identical to
    the reference's. Constant across an acquisition: callers hoist it."""
    tf = transfer_function_half
    tf = torch.from_numpy(np.asarray(tf)) if not isinstance(tf, torch.Tensor) else tf
    tf = tf.to(device=device, dtype=torch.float32).contiguous()
    if tuple(tf.shape) != half_spectrum_shape(shape):
        raise ValueError(
            f"transfer function half {tuple(tf.shape)} does not match volume "
            f"shape {tuple(shape)} (want {half_spectrum_shape(shape)})"
        )
    reg = torch.tensor(float(regularization_strength), dtype=torch.float32)
    return tf / (tf * tf + reg.to(tf.device))


def fwd_yx_plain(volume: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of kernel A."""
    spec = torch.fft.rfftn(volume.to(torch.float32), dim=(1, 2))
    return spec if out is None else out.copy_(spec)


def z_filter_plain_(spectrum: torch.Tensor, filt: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel B (in place)."""
    return spectrum.copy_(torch.fft.ifft(torch.fft.fft(spectrum, dim=0) * filt, dim=0))


def inv_yx_plain(spectrum: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of kernel C (overwrites ``spectrum`` as the kernel does)."""
    x = 2 * (spectrum.shape[2] - 1) if out is None else out.shape[-1]
    spectrum.copy_(torch.fft.ifft(spectrum, dim=1))
    real = torch.fft.irfft(spectrum, n=x, dim=2)
    return real if out is None else out.copy_(real)


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


def _check_cuda_shape(shape, what: str) -> None:
    for n in shape:
        if n < 2 or n > _MAX_AXIS or n & (n - 1):
            raise ValueError(
                f"{what}: the CUDA kernels take power-of-two axes in "
                f"[2, {_MAX_AXIS}], got volume shape {tuple(shape)}"
            )


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
    _check_cuda_shape(volume.shape, "fwd_yx")
    lib = _lib()
    z, y, x = volume.shape
    with torch.cuda.device(volume.device):
        rc = lib.fwd_yx(_build.ptr(volume), int(volume.dtype == torch.uint16),
                        _build.ptr(out), z, y, x, _build.stream_of(volume))
    _build.check(rc, lib, "fwd_yx")
    _build.count_launch("fwd_yx")
    return out


def z_filter_(spectrum: torch.Tensor, filt: torch.Tensor) -> torch.Tensor:
    """Kernel B, in place: ``spectrum = ifft(fft(spectrum, Z) * filt, Z)``
    (with the inverse's 1/Z). ``filt`` is a :func:`prepare_fourier_filter`
    result of the spectrum's shape."""
    _check(spectrum, "z_filter_", 3, (torch.complex64,))
    _check(filt, "z_filter_", 3, (torch.float32,))
    if filt.shape != spectrum.shape or filt.device != spectrum.device:
        raise ValueError(f"z_filter_: filter {tuple(filt.shape)} on {filt.device} "
                         f"for spectrum {tuple(spectrum.shape)} on {spectrum.device}")
    if not _build.on_card(spectrum, "z_filter_"):
        return z_filter_plain_(spectrum, filt)
    z, y, xh = spectrum.shape
    _check_cuda_shape((z,), "z_filter_")
    if y > 65535:
        raise ValueError(f"z_filter_: Y = {y} exceeds the kernel's grid (65535)")
    lib = _lib()
    with torch.cuda.device(spectrum.device):
        rc = lib.z_filter(_build.ptr(spectrum), _build.ptr(filt), z, y, xh,
                          _build.stream_of(spectrum))
    _build.check(rc, lib, "z_filter_")
    _build.count_launch("z_filter")
    return spectrum


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
    _check_cuda_shape(shape, "inv_yx")
    lib = _lib()
    with torch.cuda.device(spectrum.device):
        rc = lib.inv_yx(_build.ptr(spectrum), _build.ptr(out), *shape,
                        _build.stream_of(spectrum))
    _build.check(rc, lib, "inv_yx")
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
    if y > 65535:
        raise ValueError(f"z_cross_: Y = {y} exceeds the kernel's grid (65535)")
    lib = _lib()
    with torch.cuda.device(ref_spec.device):
        rc = lib.z_cross(_build.ptr(ref_spec), _build.ptr(mov_spec), _build.ptr(out),
                         z, y, xh, code, _build.stream_of(ref_spec))
    _build.check(rc, lib, "z_cross_")
    _build.count_launch("z_cross")
    return out


def _check_cross_z(z: int) -> None:
    """Kernel Bx's Z: a power of two in [2, MAX_CROSS_Z]."""
    _check_cuda_shape((z,), "z_cross_")
    if z > MAX_CROSS_Z:
        raise ValueError(f"z_cross_: Z = {z} exceeds the kernel's limit of "
                         f"{MAX_CROSS_Z} (two spectra's Z-lines, in double, in "
                         "one shared-memory tile)")
