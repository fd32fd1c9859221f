"""Phase cross-correlation and FFT-shape utilities.

Counterpart of ``biahub_tpu/kernels/fft.py`` (the port's
:mod:`biahub_tpu_torch.kernels.fft` is the counterpart of
``pallas_fft.py``). The correlation volume of two equal-shape 3D volumes is
the fused route of the reference's ``pcc_corr_pallas`` (pallas_fft.py:1511):
kernel A on both volumes, kernel Bx (the Z-DFTs, the cross-power and the
inverse Z-DFT) and kernel C, :func:`pcc_corr`. A CUDA tensor launches the
kernels, which take axes of any length up to their limits
(``fft.max_axis``, ``fft.max_cross_z``) and raise beyond them; a CPU
tensor takes their plain versions, at any shape. 2D inputs, and 3D shapes
past the kernels' limits (``fft.pcc_limit``, decided from the shape before
any launch and said on stderr), take :func:`_pcc_core`, ``torch.fft`` as
the reference's XLA route.

The argmax of |corr| and the wrap correction are torch ops, as the
reference computes them outside any Pallas kernel; ``torch.argmax``, like
``jnp.argmax``, returns the first maximum. The shift returned maps the
MOVING image onto the REFERENCE: ``mov(x) == ref(x + shift)``.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from biahub_tpu_torch.device import as_tensor, resolve_device
from biahub_tpu_torch.kernels.fft import (
    _F32_EPS,
    PASS_A_DTYPES,
    _norm_code,
    fwd_yx,
    inv_yx,
    pcc_limit,
    z_cross_,
)

__all__ = [
    "pad_to_shape",
    "center_crop",
    "match_shape",
    "pcc_corr",
    "phase_cross_corr",
    "phase_cross_corr_padding",
    "subpixel_shift_2d",
    "pcc_shifts_vs_first",
    "pcc_shifts_pairwise",
]


def pad_to_shape(arr, shape: tuple[int, ...], mode: str = "constant", **kwargs):
    """Center-pad an array (numpy, or a tensor with constant fill) to the
    given shape."""
    if arr.ndim != len(shape):
        raise ValueError(f"shape {shape} for a {arr.ndim}-d array")
    dif = tuple(s - a for s, a in zip(shape, arr.shape))
    pad_width = [[s // 2, s - s // 2] for s in dif]
    if isinstance(arr, torch.Tensor):
        if mode != "constant":
            raise ValueError("tensors pad with mode='constant' only")
        flat = [w for pair in reversed(pad_width) for w in pair]
        return torch.nn.functional.pad(arr, flat, value=kwargs.get("constant_values", 0))
    return np.pad(arr, pad_width=pad_width, mode=mode, **kwargs)


def center_crop(arr, shape: tuple[int, ...]):
    """Center-crop an array (numpy or tensor) to the given shape."""
    if arr.ndim != len(shape):
        raise ValueError(f"shape {shape} for a {arr.ndim}-d array")
    starts = tuple((a - s) // 2 for a, s in zip(arr.shape, shape))
    return arr[tuple(slice(s, s + d) for s, d in zip(starts, shape))]


def match_shape(arr, shape: tuple[int, ...]):
    """Pad then crop so the output has exactly the given shape, centered."""
    padded_shape = tuple(max(s, a) for s, a in zip(shape, arr.shape))
    return center_crop(pad_to_shape(arr, padded_shape), shape)


def _pcc_core(ref_img: torch.Tensor, mov_img: torch.Tensor, normalization):
    """``irfftn(F_ref * conj(F_mov) / norm)`` with ``torch.fft``, the
    normalisations in the reference XLA route's form (|c| and |F1|*|F2|)."""
    _norm_code(normalization)
    f1 = torch.fft.rfftn(ref_img.to(torch.float32))
    f2 = torch.fft.rfftn(mov_img.to(torch.float32))
    prod = f1 * f2.conj()
    if normalization == "magnitude":
        prod = prod / prod.abs().clamp_min(_F32_EPS)
    elif normalization == "classic":
        prod = prod / (f1.abs() * f2.abs()).clamp_min(_F32_EPS)
    return torch.fft.irfftn(prod, s=tuple(ref_img.shape))


def _pass_a_input(t: torch.Tensor) -> torch.Tensor:
    t = t if t.dtype in PASS_A_DTYPES else t.to(torch.float32)
    return t.contiguous()


def _corr_vs_spectrum(ref_spec: torch.Tensor, mov: torch.Tensor,
                      normalization) -> torch.Tensor:
    """Kernel A on ``mov``, Bx against ``ref_spec`` (kept), C: the
    correlation volume, float32 of ``mov``'s shape."""
    spec = fwd_yx(_pass_a_input(mov))
    z_cross_(ref_spec, spec, spec, normalization)
    return inv_yx(spec, out=torch.empty(mov.shape, dtype=torch.float32, device=mov.device))


def pcc_corr(ref: torch.Tensor, mov: torch.Tensor, normalization=None) -> torch.Tensor:
    """Phase-cross-correlation volume of two equal-shape (Z, Y, X) volumes,
    ``real(ifftn(fftn(ref) * conj(fftn(mov)) / norm))``, through kernels A,
    A, Bx and C (counterpart of ``pcc_corr_pallas``)."""
    if ref.ndim != 3 or ref.shape != mov.shape:
        raise ValueError(f"want two equal-shape 3D volumes, got {tuple(ref.shape)} "
                         f"and {tuple(mov.shape)}")
    _norm_code(normalization)
    return _corr_vs_spectrum(fwd_yx(_pass_a_input(ref)), mov, normalization)


def _kernels_take(ref_shape, mov_shape) -> bool:
    """Whether a pair takes kernels A, Bx and C: two equal-shape 3D volumes
    within :func:`~biahub_tpu_torch.kernels.fft.pcc_limit` (the reference's
    ``pcc_pallas_supported``); a 3D shape past it says so on stderr."""
    if len(ref_shape) != 3 or tuple(ref_shape) != tuple(mov_shape):
        return False
    limit = pcc_limit(ref_shape)
    if limit is not None:
        print(f"phase cross-correlation: {tuple(ref_shape)} takes torch.fft: {limit}",
              file=sys.stderr)
    return limit is None


def _corr_surface(ref_img: torch.Tensor, mov_img: torch.Tensor, normalization):
    """The correlation volume: :func:`pcc_corr` for two equal-shape 3D
    volumes the kernels take, :func:`_pcc_core` otherwise."""
    if _kernels_take(ref_img.shape, mov_img.shape):
        return pcc_corr(ref_img, mov_img, normalization)
    return _pcc_core(ref_img, mov_img, normalization)


def _peak_index(corr: torch.Tensor) -> torch.Tensor:
    """Unshifted index of the first maximum of |corr|, int64 (ndim,)."""
    rem = torch.argmax(corr.abs())
    idx = []
    for s in corr.shape[::-1]:
        idx.append(rem % s)
        rem = rem // s
    return torch.stack(idx[::-1])


def _wrapped_shift(idx: torch.Tensor, shape) -> torch.Tensor:
    """A peak index as a float32 shift: indices past the midpoint wrap to
    negative shifts."""
    maxima = idx.to(torch.float32)
    midpoint = torch.tensor([np.fix(s / 2) for s in shape], dtype=torch.float32,
                            device=idx.device)
    sizes = torch.tensor(shape, dtype=torch.float32, device=idx.device)
    return torch.where(maxima > midpoint, maxima - sizes, maxima)


def _plot_corr(corr: np.ndarray, output_path) -> None:
    """The fftshifted |corr| as a heatmap (its max along Z for a volume),
    the reference's ``_plot_corr`` (kernels/fft.py:244); only where
    matplotlib is installed."""
    from biahub_tpu_torch.plots import pyplot

    plt = pyplot(output_path)
    if plt is None:
        return
    corr_to_plot = np.max(corr, axis=0) if corr.ndim == 3 else corr
    fig, ax = plt.subplots(figsize=(6, 5))
    im = ax.imshow(corr_to_plot, cmap="viridis")
    ax.set_title("Cross-Correlation")
    ax.set_xlabel("X shift (pixels)")
    ax.set_ylabel("Y shift (pixels)")
    fig.colorbar(im, ax=ax, label="Correlation strength")
    fig.tight_layout()
    fig.savefig(output_path, bbox_inches="tight")
    plt.close(fig)


def _host_corr(corr: torch.Tensor, output_path) -> np.ndarray | None:
    """None without ``output_path``; else the fftshifted |corr| on the host,
    plotted there: the correlation volume leaves the device only when a plot
    is asked for."""
    if output_path is None:
        return None
    host = np.fft.fftshift(np.abs(corr.cpu().numpy()))
    _plot_corr(host, output_path)
    return host


def phase_cross_corr(
    ref_img,
    mov_img,
    normalization: str | None = None,
    output_path=None,
    verbose: bool = False,
    device: str | torch.device = "cuda",
):
    """Integer shift (the input axes' order) between two arrays: the
    wrap-corrected argmax of ``irfftn(F_ref * conj(F_mov))``, the
    translation that maps the MOVING image onto the REFERENCE. Returns
    ``(shift, None)`` (float32 numpy); with ``output_path``, ``(shift,
    fftshift(|corr|))`` and the plot of it written there."""
    dev = resolve_device(device)
    corr = _corr_surface(as_tensor(ref_img, dev), as_tensor(mov_img, dev), normalization)
    shift = _wrapped_shift(_peak_index(corr), tuple(corr.shape)).cpu().numpy()
    host = _host_corr(corr, output_path)
    if verbose:
        print(f"phase cross corr. peak at {tuple(shift)}")
    return shift, host


def phase_cross_corr_padding(
    ref_img,
    mov_img,
    maximum_shift: float = 1.2,
    normalization: str | None = None,
    output_path=None,
    verbose: bool = False,
    device: str | torch.device = "cuda",
):
    """PCC with both arrays center-matched to ``next_fast_len(max(shape) *
    maximum_shift)`` per axis; the peak is reported relative to the
    fftshifted center. On the card those lengths run as Bluestein
    lines in kernels A, Bx and C. Returns ``(peak, None)``; with
    ``output_path``, ``(peak, fftshift(|corr|))`` and its plot written
    there."""
    # scipy is imported at call time: its import starts a process (numpy's
    # CPU probe), and importing the port starts none.
    from scipy.fft import next_fast_len

    dev = resolve_device(device)
    shape = tuple(
        int(next_fast_len(int(max(s1, s2) * maximum_shift)))
        for s1, s2 in zip(ref_img.shape, mov_img.shape)
    )
    if verbose:
        print(
            f"phase cross corr. fft shape of {shape} for arrays of shape "
            f"{tuple(ref_img.shape)} and {tuple(mov_img.shape)} with maximum shift "
            f"of {maximum_shift}"
        )
    ref_m = match_shape(as_tensor(ref_img, dev), shape)
    mov_m = match_shape(as_tensor(mov_img, dev), shape)
    # The fftshifted argmax p maps to the unshifted index p0 by
    # p = (p0 + s//2) % s, so peak = s//2 - p.
    corr = _corr_surface(ref_m, mov_m, normalization)
    p0 = _peak_index(corr).cpu().numpy()
    peak = tuple(int(s // 2 - ((q + s // 2) % s)) for s, q in zip(shape, p0))
    host = _host_corr(corr, output_path)
    if verbose:
        print(f"phase cross corr. peak at {peak}")
    return np.asarray(peak, dtype=np.float32), host


def subpixel_shift_2d(ref_img, mov_img, normalization: str | None = "magnitude",
                      device: str | torch.device = "cuda") -> np.ndarray:
    """Subpixel (y, x) translation mapping the moving image onto the
    reference: the PCC peak refined by a parabola through its neighbours
    on each axis (on the host, as the reference)."""
    dev = resolve_device(device)
    corr = _pcc_core(as_tensor(ref_img, dev), as_tensor(mov_img, dev),
                     normalization).abs().cpu().numpy()
    peak = np.unravel_index(np.argmax(corr), corr.shape)
    refined = []
    for ax, p in enumerate(peak):
        n = corr.shape[ax]
        vals = []
        for i in ((p - 1) % n, p, (p + 1) % n):
            other = list(peak)
            other[ax] = i
            vals.append(corr[tuple(other)])
        c_m, c_0, c_p = vals
        denom = c_m - 2 * c_0 + c_p
        delta = 0.0 if denom == 0 else 0.5 * (c_m - c_p) / denom
        refined.append(p + float(np.clip(delta, -1, 1)))
    shift = np.asarray(refined)
    midpoint = np.array([np.fix(s / 2) for s in corr.shape])
    wrap = shift > midpoint
    shift[wrap] -= np.array(corr.shape)[wrap]
    return shift


def _vs_first(ref, movs, normalization, reduce, device) -> torch.Tensor:
    """``reduce(corr)`` of each moving volume against one reference. For 3D
    volumes kernel A runs once for the reference per call, and Bx keeps
    its spectrum."""
    dev = resolve_device(device)
    ref, movs = as_tensor(ref, dev), as_tensor(movs, dev)
    if _kernels_take(ref.shape, movs.shape[1:]):
        _norm_code(normalization)
        ref_spec = fwd_yx(_pass_a_input(ref))
        return torch.stack([reduce(_corr_vs_spectrum(ref_spec, m, normalization))
                            for m in movs])
    return torch.stack([reduce(_pcc_core(ref, m, normalization)) for m in movs])


def _pairwise(refs, movs, normalization, reduce, device) -> torch.Tensor:
    dev = resolve_device(device)
    refs, movs = as_tensor(refs, dev), as_tensor(movs, dev)
    if _kernels_take(refs.shape[1:], movs.shape[1:]):
        return torch.stack([reduce(pcc_corr(r, m, normalization)) for r, m in zip(refs, movs)])
    return torch.stack([reduce(_pcc_core(r, m, normalization)) for r, m in zip(refs, movs)])


def _shift_of(corr: torch.Tensor) -> torch.Tensor:
    return _wrapped_shift(_peak_index(corr), tuple(corr.shape))


def pcc_shifts_vs_first(ref, movs, normalization: str | None = None,
                        device: str | torch.device = "cuda") -> torch.Tensor:
    """Wrap-corrected PCC shifts (T, ndim) float32 of a (T, ...) stack
    against one reference, on ``device``: T + 1 runs of kernel A."""
    return _vs_first(ref, movs, normalization, _shift_of, device)


def pcc_shifts_pairwise(refs, movs, normalization: str | None = None,
                        device: str | torch.device = "cuda") -> torch.Tensor:
    """Wrap-corrected PCC shifts (T, ndim) float32 for matched (T, ...)
    reference/moving pairs, on ``device``."""
    return _pairwise(refs, movs, normalization, _shift_of, device)


def _pcc_peak_indices_vs_first(ref, movs, normalization=None,
                               device: str | torch.device = "cuda") -> torch.Tensor:
    return _vs_first(ref, movs, normalization, _peak_index, device)


def _pcc_peak_indices_pairwise(refs, movs, normalization=None,
                               device: str | torch.device = "cuda") -> torch.Tensor:
    return _pairwise(refs, movs, normalization, _peak_index, device)
