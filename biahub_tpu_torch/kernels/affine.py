"""In-plane affine warp: register and stabilize as one z-decoupled affine.

Counterpart of ``biahub_tpu/kernels/affine.py``. A homogeneous 4x4 matrix
maps OUTPUT (z, y, x) index coordinates to INPUT index coordinates, as
``scipy.ndimage.affine_transform`` does with order 1 and constant fill. A
z-decoupled ("in-plane") matrix factors into two passes, as in the
reference's ``inplane_affine_warp_zyx_pallas{,_batched}`` (affine.py:
350-357, 402-456):

- pass 1 (kernel E, :func:`~biahub_tpu_torch.kernels.warp_cuda.warp_zy`):
  for each output (zo, yo) and each input column x, a lerp along z at
  ``zi = (mzz*zo + 0*x) + tz``, then along y at ``yi = (b0*yo + b1*x) + b2``;
- pass 2 (kernel F, :func:`~biahub_tpu_torch.kernels.warp_cuda.warp_x`): a
  lerp along x at ``xi = (mxx*xo + mxy*yo) + tx``, then the exact
  constant-fill mask of the original matrix.

Taps clamp to the frame edge in both passes; the mask is the only fill.
Every coordinate is float32 arithmetic on the float32 coefficients of
:func:`inplane_coefficients`, in the reference's operand order. The TPU's
(Xi, Zi, Yi) and (Yo, Xi, Zo) layouts exist for its lane tiling; here pass 1
reads (B, Zi, Yi, Xi) (or the deskew's (B, Xi, Zi, Yi) with ``input_xzy``)
and writes (B, Zo, Yo, Xi), and pass 2 writes (B, Zo, Yo, Xo).

A batch may carry one matrix per volume (the stabilize batches, the
counterpart of the reference's ``make_batched_inplane_kernel``, affine.py:
459): the coefficients are then a (B, 21) table, one row per volume, F's
mask included. Pure translations also have the reference's separable warp,
:func:`translation_warp_zyx` (affine.py:629).

Other matrices take the general branch of the reference's
``affine_warp_auto`` (affine.py:609-625): order 1 the multipass warp
(:mod:`biahub_tpu_torch.kernels.multipass_warp`, kernel H), and the exact
8-corner gather :func:`affine_warp_zyx` (torch ops, XLA in the reference)
when a pivot vanishes or for order 0 (any other order takes its trilinear
sample, as the reference's does).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from biahub_tpu_torch.device import as_tensor, resolve_device

__all__ = [
    "matrix_4x4",
    "is_translation_matrix",
    "is_inplane_matrix",
    "inplane_coefficients",
    "exact_domain_mask",
    "warp_zy_plain",
    "warp_x_plain",
    "inplane_affine_warp_zyx",
    "inplane_affine_warp_zyx_batched",
    "translation_matrix",
    "translation_warp_zyx",
    "translation_warp_zyx_batched",
    "exact_domain_mask_general",
    "affine_warp_zyx",
    "affine_warp_auto",
    "affine_warp_auto_batched",
    "make_batched_warp",
    "rotation_matrix_zyx",
    "scale_matrix_zyx",
    "flip_matrix_zyx",
]

# inplane_coefficients' layout: pass 1's z and y coefficient triples, pass
# 2's x triple, then the mask's (m[i,1], m[i,0], m[i,2], m[i,3]) per axis.
N_COEFFS = 21
_Z, _Y, _X, _MASK = slice(0, 3), slice(3, 6), slice(6, 9), 9


def matrix_4x4(matrix=None) -> np.ndarray:
    """Coerce None / 3x3 / 4x4 input into a homogeneous 4x4 float matrix."""
    if matrix is None:
        return np.eye(4)
    m = np.asarray(matrix, dtype=np.float64)
    if m.shape == (4, 4):
        return m
    if m.shape == (3, 3):
        out = np.eye(4)
        out[:3, :3] = m
        return out
    raise ValueError(f"Expected a 3x3 or 4x4 matrix, got shape {m.shape}")


def rotation_matrix_zyx(angle_deg: float, axis: int = 0, center=None) -> np.ndarray:
    """Rotation about one of the z/y/x axes, optionally about a center point."""
    theta = np.deg2rad(angle_deg)
    c, s = np.cos(theta), np.sin(theta)
    rot3 = np.eye(3)
    other = [i for i in range(3) if i != axis]
    rot3[other[0], other[0]] = c
    rot3[other[0], other[1]] = -s
    rot3[other[1], other[0]] = s
    rot3[other[1], other[1]] = c
    out = np.eye(4)
    out[:3, :3] = rot3
    if center is not None:
        center = np.asarray(center, dtype=np.float64)
        out[:3, 3] = center - rot3 @ center
    return out


def scale_matrix_zyx(scale) -> np.ndarray:
    """Axis scaling by ``scale`` (z, y, x)."""
    out = np.eye(4)
    out[:3, :3] = np.diag(np.asarray(scale, dtype=np.float64))
    return out


def flip_matrix_zyx(shape, flip=(False, False, False)) -> np.ndarray:
    """Matrix flipping selected axes of a volume of the given shape in-place."""
    out = np.eye(4)
    for ax, (do_flip, size) in enumerate(zip(flip, shape)):
        if do_flip:
            out[ax, ax] = -1.0
            out[ax, 3] = size - 1
    return out


def is_translation_matrix(matrix, atol: float = 1e-9) -> bool:
    """True when the matrix is identity-linear: a pure translation."""
    m = np.asarray(matrix, dtype=np.float64)
    return bool(np.allclose(m[:3, :3], np.eye(3), atol=atol))


def is_inplane_matrix(matrix, atol: float = 1e-9) -> bool:
    """True when z decouples from (y, x) and the in-plane map is factorable:
    z row (mzz, 0, 0), no z coefficient in the y and x rows, and a nonzero
    xx entry (the x pass's pivot)."""
    m = np.asarray(matrix, dtype=np.float64)
    return bool(
        np.allclose([m[0, 1], m[0, 2], m[1, 0], m[2, 0]], 0.0, atol=atol)
        and abs(m[2, 2]) > atol
        and abs(m[0, 0]) > atol
    )


def inplane_coefficients(matrix) -> torch.Tensor:
    """The two passes' coefficients of an in-plane ``matrix`` as one float32
    (21,) CPU tensor: ``(mzz, 0, tz, b0, b1, b2, mxx, mxy, tx)`` then, for
    each axis i, ``(m[i,1], m[i,0], m[i,2], m[i,3])`` for the mask. Formed in
    float64 as the reference does (affine.py:350-357) and cast to float32
    once."""
    m = matrix_4x4(matrix)
    if not is_inplane_matrix(m):
        raise ValueError(f"not an in-plane (z-decoupled) matrix:\n{m}")
    b1 = m[1, 2] / m[2, 2]
    b0 = m[1, 1] - b1 * m[2, 1]
    b2 = m[1, 3] - b1 * m[2, 3]
    passes = [m[0, 0], 0.0, m[0, 3], b0, b1, b2, m[2, 2], m[2, 1], m[2, 3]]
    mask = [c for i in range(3) for c in (m[i, 1], m[i, 0], m[i, 2], m[i, 3])]
    return torch.tensor(np.asarray(passes + mask, dtype=np.float32))


def coefficient_table(matrix) -> torch.Tensor:
    """:func:`inplane_coefficients` of one matrix, (21,), or of a (B, 4, 4)
    stack, (B, 21): the kernels' per-volume table."""
    if np.ndim(matrix) == 3:
        return torch.stack([inplane_coefficients(m) for m in matrix])
    return inplane_coefficients(matrix)


def _per_volume(plain):
    """Run a plain pass volume by volume when its coefficients are a (B, 21)
    table (the kernels read row b for volume b)."""
    @functools.wraps(plain)
    def run(data, coeffs, *args, **kwargs):
        if coeffs.ndim == 1:
            return plain(data, coeffs, *args, **kwargs)
        return torch.cat([plain(data[b:b + 1], coeffs[b], *args, **kwargs)
                          for b in range(data.shape[0])])
    return run


def _ramp(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.float32, device=device)


def _taps(c: torch.Tensor, n: int):
    """Both taps of a lerp at ``c``, clamped to [0, n-1], and the upper
    tap's weight ``c - floor(c)``."""
    fl = torch.floor(c)
    i0 = fl.to(torch.int64)
    return i0.clamp(0, n - 1), (i0 + 1).clamp(0, n - 1), c - fl


def _lerp(v0: torch.Tensor, v1: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    return v0 * (1.0 - f) + v1 * f


def exact_domain_mask(coeffs: torch.Tensor, in_shape, out_shape) -> torch.Tensor:
    """(Zo, Yo, Xo) bool: True where the output voxel's exact input
    coordinate lies inside the ``in_shape`` (logical ZYX) domain on all three
    axes, ``c_i = ((m[i,1]*yo + m[i,0]*zo) + m[i,2]*xo) + m[i,3]`` in float32
    (the mask of pallas_resample.py ``_resample_t_body``, :404-422)."""
    dev = coeffs.device
    zo = _ramp(out_shape[0], dev)[:, None, None]
    yo = _ramp(out_shape[1], dev)[None, :, None]
    xo = _ramp(out_shape[2], dev)[None, None, :]
    inside = None
    for i in range(3):
        a = coeffs[_MASK + 4 * i: _MASK + 4 * i + 4]
        c = ((a[0] * yo + a[1] * zo) + a[2] * xo) + a[3]
        ok = (c >= 0) & (c <= float(in_shape[i] - 1))
        inside = ok if inside is None else inside & ok
    return inside


@_per_volume
def warp_zy_plain(volumes: torch.Tensor, coeffs: torch.Tensor, out_zy,
                  input_xzy: bool = False) -> torch.Tensor:
    """Plain version of kernel E: (B, Zi, Yi, Xi) float32 (or (B, Xi, Zi, Yi)
    with ``input_xzy``) -> (B, Zo, Yo, Xi), a clamped lerp along z, then
    along y with the x-dependent shear; ``coeffs`` (21,) or (B, 21)."""
    if input_xzy:
        volumes = volumes.permute(0, 2, 3, 1)
    batch, zi_n, yi_n, xi_n = volumes.shape
    z_out, y_out = (int(s) for s in out_zy)
    dev = volumes.device
    x = _ramp(xi_n, dev)[None, :]
    cz, cy = coeffs[_Z], coeffs[_Y]
    z0, z1, fz = _taps((cz[0] * _ramp(z_out, dev)[:, None] + cz[1] * x) + cz[2], zi_n)
    y0, y1, fy = _taps((cy[0] * _ramp(y_out, dev)[:, None] + cy[1] * x) + cy[2], yi_n)

    def along_z(idx):  # (Zo, Xi) -> (B, Zo, Yi, Xi)
        return torch.gather(volumes, 1, idx[None, :, None, :].expand(
            batch, z_out, yi_n, xi_n))

    a = _lerp(along_z(z0), along_z(z1), fz[None, :, None, :])

    def along_y(idx):  # (Yo, Xi) -> (B, Zo, Yo, Xi)
        return torch.gather(a, 2, idx[None, None].expand(batch, z_out, y_out, xi_n))

    return _lerp(along_y(y0), along_y(y1), fy[None, None])


@_per_volume
def warp_x_plain(inter: torch.Tensor, coeffs: torch.Tensor, x_out: int,
                 in_shape, fill: float = 0.0) -> torch.Tensor:
    """Plain version of kernel F: (B, Zo, Yo, Xi) float32 -> (B, Zo, Yo,
    Xo), a clamped lerp along x, then ``fill`` outside
    :func:`exact_domain_mask` of the warp's logical input ``in_shape``;
    ``coeffs`` (21,) or (B, 21)."""
    batch, z_out, y_out, xi_n = inter.shape
    dev = inter.device
    cx = coeffs[_X]
    x0, x1, fx = _taps((cx[0] * _ramp(x_out, dev)[None, :]
                        + cx[1] * _ramp(y_out, dev)[:, None]) + cx[2], xi_n)

    def along_x(idx):  # (Yo, Xo) -> (B, Zo, Yo, Xo)
        return torch.gather(inter, 3, idx[None, None].expand(batch, z_out, y_out, x_out))

    out = _lerp(along_x(x0), along_x(x1), fx)
    inside = exact_domain_mask(coeffs, in_shape, (z_out, y_out, x_out))
    return torch.where(inside, out, torch.tensor(float(fill), dtype=out.dtype, device=dev))


def inplane_affine_warp_zyx_batched(
    volumes,
    matrix,
    output_shape: tuple[int, int, int],
    fill: float = 0.0,
    input_xzy: bool = False,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """Warp a (B, Z, Y, X) batch by an in-plane output->input ``matrix`` ->
    (B, Zo, Yo, Xo) float32, kernels E then F (counterpart of
    ``inplane_affine_warp_zyx_pallas_batched``). ``matrix`` is one 4x4 for
    the whole batch, or a (B, 4, 4) stack, one per volume (counterpart of
    ``make_batched_inplane_kernel``'s per-matrix kernel; still one launch of
    E and one of F). ``input_xzy``: the batch arrives as (B, X, Z, Y) of the
    logical volumes, the layout of the deskew's ``out_layout="xzy"``."""
    from biahub_tpu_torch.kernels.warp_cuda import warp_x, warp_zy

    dev = resolve_device(device)
    data = as_tensor(volumes, dev)
    if data.ndim != 4:
        raise ValueError(f"want a (B, Z, Y, X) batch, got {tuple(data.shape)}")
    coeffs = coefficient_table(matrix).to(dev)
    if coeffs.ndim == 2 and coeffs.shape[0] != data.shape[0]:
        raise ValueError(f"{coeffs.shape[0]} matrices for a batch of {data.shape[0]}")
    z_out, y_out, x_out = (int(s) for s in output_shape)
    shape = tuple(int(s) for s in data.shape[1:])
    in_shape = (shape[1], shape[2], shape[0]) if input_xzy else shape
    inter = warp_zy(data, coeffs, (z_out, y_out), input_xzy=input_xzy)
    return warp_x(inter, coeffs, x_out, in_shape, fill)


def inplane_affine_warp_zyx(
    volume,
    matrix,
    output_shape: tuple[int, int, int],
    fill: float = 0.0,
    input_xzy: bool = False,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """One volume -> (Zo, Yo, Xo) float32 (see
    :func:`inplane_affine_warp_zyx_batched`)."""
    dev = resolve_device(device)
    return inplane_affine_warp_zyx_batched(
        as_tensor(volume, dev)[None], matrix, output_shape, fill, input_xzy, dev,
    )[0]


def translation_matrix(shift_zyx) -> np.ndarray:
    """The 4x4 output->input map ``input = output + shift``."""
    m = np.eye(4)
    m[:3, 3] = np.asarray(shift_zyx, dtype=np.float64)
    return m


def _resample_axis(data: torch.Tensor, axis: int, size_out: int,
                   delta: torch.Tensor, fill: float) -> torch.Tensor:
    """The reference's per-axis translation pass (affine.py:717-741) on a
    (B, Z, Y, X) batch along ``axis`` (1-3), ``delta`` (B,) float32: a
    clamped lerp at ``arange(size_out) + delta``, ``fill`` where that
    coordinate leaves [0, size_in - 1]."""
    size_in = data.shape[axis]
    coords = _ramp(size_out, data.device)[None, :] + delta[:, None]  # (B, n)
    fl = torch.floor(coords)
    frac = coords - fl
    i0 = fl.to(torch.int64)
    inside = (coords >= 0) & (coords <= size_in - 1)
    shape = [data.shape[0], 1, 1, 1]
    shape[axis] = size_out
    full = list(data.shape)
    full[axis] = size_out

    def take(idx):
        return torch.gather(data, axis, idx.clamp(0, size_in - 1).reshape(shape).expand(full))

    frac = frac.reshape(shape)
    out = take(i0) * (1 - frac) + take(i0 + 1) * frac
    return torch.where(inside.reshape(shape), out,
                       torch.tensor(float(fill), dtype=out.dtype, device=out.device))


def translation_warp_zyx_batched(
    volumes,
    shifts,
    output_shape: tuple[int, int, int] | None = None,
    fill: float = 0.0,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """Translate each volume of a (B, Z, Y, X) batch by its own ``shifts``
    row (B, 3) (``input = output + shift``, float32) -> (B, Zo, Yo, Xo)
    float32 (counterpart of ``translation_warp_zyx``, affine.py:629).

    With ``fill == 0`` the batch takes kernels E and F with one coefficient
    row per volume, the route of the reference's Pallas passes: for a
    translation their per-axis ``mask_oob`` zeros never reach a voxel whose
    three coordinates lie in the frame, so the result is F's exact-domain
    mask. Another fill runs the reference's separable formulation
    (affine.py:717-741) as torch ops, which the reference also computes
    outside Pallas: there a voxel outside the frame on one axis is a lerp of
    fills, not the fill itself.
    """
    dev = resolve_device(device)
    data = as_tensor(volumes, dev)
    if data.ndim != 4:
        raise ValueError(f"want a (B, Z, Y, X) batch, got {tuple(data.shape)}")
    shifts = np.asarray(shifts, dtype=np.float64).reshape(-1, 3)
    if shifts.shape[0] != data.shape[0]:
        raise ValueError(f"{shifts.shape[0]} shifts for a batch of {data.shape[0]}")
    out_shape = tuple(int(s) for s in (output_shape or data.shape[1:]))
    if float(fill) == 0.0:
        mats = np.stack([translation_matrix(s) for s in shifts])
        return inplane_affine_warp_zyx_batched(data, mats, out_shape, 0.0, device=dev)
    delta = torch.tensor(shifts.astype(np.float32), device=dev)
    out = data
    for axis in range(3):
        out = _resample_axis(out, axis + 1, out_shape[axis], delta[:, axis], fill)
    return out


def translation_warp_zyx(
    volume,
    shift_zyx,
    output_shape: tuple[int, int, int] | None = None,
    fill: float = 0.0,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """One volume -> (Zo, Yo, Xo) float32 (see
    :func:`translation_warp_zyx_batched`)."""
    dev = resolve_device(device)
    return translation_warp_zyx_batched(
        as_tensor(volume, dev)[None], np.asarray(shift_zyx)[None], output_shape, fill, dev,
    )[0]


def exact_domain_mask_general(matrices, in_shape, out_shape, device) -> torch.Tensor:
    """(B, Zo, Yo, Xo) bool for a (B, 4, 4) stack (or (Zo, Yo, Xo) for one
    4x4): True where the output voxel's exact input coordinate lies inside
    the ``in_shape`` domain on all three axes, ``c_i = ((m[i,0]*zo +
    m[i,1]*yo) + m[i,2]*xo) + m[i,3]`` in float32 from the float32 matrix
    (the reference's ``_exact_domain_mask``, affine.py:246). ``matrices``
    may be a float32 tensor: the mask is then built on the device from it,
    detached, with no copy to the host."""
    if isinstance(matrices, torch.Tensor):
        one = matrices.ndim == 2
        m = matrices.detach().to(device=device, dtype=torch.float32).reshape(-1, 4, 4)
    else:
        mats = np.asarray(matrices, dtype=np.float64)
        one = mats.ndim == 2
        m = torch.tensor(mats.reshape(-1, 4, 4).astype(np.float32), device=device)
    zo = _ramp(out_shape[0], device)[None, :, None, None]
    yo = _ramp(out_shape[1], device)[None, None, :, None]
    xo = _ramp(out_shape[2], device)[None, None, None, :]
    inside = None
    for ax in range(3):
        a = m[:, ax].reshape(-1, 4, 1, 1, 1)
        c = ((a[:, 0] * zo + a[:, 1] * yo) + a[:, 2] * xo) + a[:, 3]
        ok = (c >= 0) & (c <= in_shape[ax] - 1)
        inside = ok if inside is None else inside & ok
    return inside[0] if one else inside


def affine_warp_zyx(
    volume,
    matrix,
    output_shape: tuple[int, int, int],
    fill: float = 0.0,
    order: int = 1,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """The exact warp of one (Z, Y, X) volume by an output->input ``matrix``
    -> (Zo, Yo, Xo) float32, as torch ops (the reference's
    ``affine_warp_zyx``, affine.py:85, an XLA gather): nearest neighbour for
    order 0, else the 8-corner trilinear sample, and scipy's constant fill
    where the input coordinate leaves the domain. Coordinates are float32
    from the float32 matrix, ``((m[i,0]*zo + m[i,1]*yo) + m[i,2]*xo) +
    m[i,3]``."""
    dev = resolve_device(device)
    data = as_tensor(volume, dev)
    zi_n, yi_n, xi_n = data.shape
    m = torch.tensor(matrix_4x4(matrix).astype(np.float32), device=dev)
    zo = _ramp(output_shape[0], dev)[:, None, None]
    yo = _ramp(output_shape[1], dev)[None, :, None]
    xo = _ramp(output_shape[2], dev)[None, None, :]
    zi, yi, xi = (((m[a, 0] * zo + m[a, 1] * yo) + m[a, 2] * xo) + m[a, 3] for a in range(3))
    fillv = torch.tensor(float(fill), dtype=torch.float32, device=dev)
    in_domain = ((zi >= 0) & (zi <= zi_n - 1) & (yi >= 0) & (yi <= yi_n - 1)
                 & (xi >= 0) & (xi <= xi_n - 1))
    if order == 0:
        sample = data[torch.round(zi).to(torch.int64).clamp(0, zi_n - 1),
                      torch.round(yi).to(torch.int64).clamp(0, yi_n - 1),
                      torch.round(xi).to(torch.int64).clamp(0, xi_n - 1)]
        return torch.where(in_domain, sample, fillv)
    z0, y0, x0 = torch.floor(zi), torch.floor(yi), torch.floor(xi)
    fz, fy, fx = zi - z0, yi - y0, xi - x0
    z0, y0, x0 = z0.to(torch.int64), y0.to(torch.int64), x0.to(torch.int64)
    wz, wy, wx = (1.0 - fz, fz), (1.0 - fy, fy), (1.0 - fx, fx)
    out = torch.zeros(tuple(int(s) for s in output_shape), dtype=torch.float32, device=dev)
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                corner = data[(z0 + dz).clamp(0, zi_n - 1), (y0 + dy).clamp(0, yi_n - 1),
                              (x0 + dx).clamp(0, xi_n - 1)]
                out = out + wz[dz] * wy[dy] * wx[dx] * corner
    return torch.where(in_domain, out, fillv)


def affine_warp_auto(
    volume,
    matrix,
    output_shape: tuple[int, int, int],
    fill: float = 0.0,
    order: int = 1,
    input_xzy: bool = False,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """Warp one volume by ``matrix`` with the port's kernel for it (the
    reference's ``affine_warp_auto``, affine.py:560-625).

    Order 1: every in-plane matrix, pure translations included, takes the
    in-plane warp (for a translation its coefficients are the reference's
    separable translation warp's, and its mask is that warp's per-axis
    fill); any other matrix the multipass warp, or the exact gather when a
    pivot vanishes. Other orders take the exact gather. ``input_xzy``: the
    volume arrives as (X, Z, Y); only the in-plane warp reads it as it is.
    """
    dev = resolve_device(device)
    m = matrix_4x4(matrix)
    out_shape = tuple(int(s) for s in output_shape)
    if order == 1 and is_inplane_matrix(m):
        return inplane_affine_warp_zyx(volume, m, out_shape, fill, input_xzy, dev)
    data = as_tensor(volume, dev)
    if input_xzy:
        data = data.permute(1, 2, 0).contiguous()
    if order == 1:
        from biahub_tpu_torch.kernels.multipass_warp import multipass_affine_warp_zyx

        try:
            return multipass_affine_warp_zyx(data, m, out_shape, fill, device=dev)
        except ValueError:
            pass  # a vanishing pivot (e.g. a 90 degree rotation): the exact gather
    return affine_warp_zyx(data, m, out_shape, fill, order, dev)


def affine_warp_auto_batched(
    volumes,
    matrix,
    output_shape: tuple[int, int, int],
    fill: float = 0.0,
    order: int = 1,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """:func:`affine_warp_auto` of each volume of a (B, Z, Y, X) batch by
    one ``matrix`` -> (B, Zo, Yo, Xo) float32: an order-1 in-plane matrix
    warps the whole batch with one launch of E and one of F (the same bits
    as volume by volume); any other, volume by volume."""
    dev = resolve_device(device)
    m = matrix_4x4(matrix)
    out_shape = tuple(int(s) for s in output_shape)
    data = as_tensor(volumes, dev)
    if order == 1 and is_inplane_matrix(m):
        return inplane_affine_warp_zyx_batched(data, m, out_shape, fill, device=dev)
    return torch.stack([affine_warp_auto(v, m, out_shape, fill, order, device=dev)
                        for v in data])


def make_batched_warp(matrices, in_shape, out_shape, device: str | torch.device = "cuda"):
    """The warp of one volume per matrix, its kernel chosen from every
    matrix of ``matrices`` (the reference's stabilize, :172-213, and fuse's
    ``_make_warp_stage``, :117-176): all translations take
    :func:`translation_warp_zyx_batched`, all in-plane matrices
    :func:`inplane_affine_warp_zyx_batched` with one matrix per volume (E and
    F once a batch, a (B, 21) table); any other set the batched multipass
    warp (H once per canonical slot and batch) in one frame spanning every
    matrix, or the exact gather per volume when a pivot vanishes.

    Returns ``(warp(volumes, mats) -> (B, Zo, Yo, Xo), workspace_bytes)``:
    ``mats`` the (B, 4, 4) rows of the batch's volumes, and the per-volume
    bytes of the multipass frames
    (:func:`~biahub_tpu_torch.kernels.multipass_warp.common_frame_bytes`)."""
    from biahub_tpu_torch.kernels.multipass_warp import (
        common_frame_bytes,
        multipass_affine_warp_zyx_batched,
        union_frame,
    )

    dev = resolve_device(device)
    mats = np.asarray(matrices, dtype=np.float64).reshape(-1, 4, 4)
    in_shape = tuple(int(s) for s in in_shape)
    out_shape = tuple(int(s) for s in out_shape)
    workspace = common_frame_bytes(mats, in_shape, out_shape)
    if all(is_translation_matrix(m) for m in mats):
        def warp(vols, ms):
            return translation_warp_zyx_batched(vols, np.asarray(ms)[:, :3, 3], out_shape,
                                                device=dev)
    elif all(is_inplane_matrix(m) for m in mats):
        def warp(vols, ms):
            return inplane_affine_warp_zyx_batched(vols, ms, out_shape, device=dev)
    else:
        try:
            frame = union_frame(mats, in_shape, out_shape)

            def warp(vols, ms):
                return multipass_affine_warp_zyx_batched(vols, ms, out_shape, frame=frame,
                                                         device=dev)
        except ValueError:  # a vanishing pivot (e.g. a 90 degree permutation)
            def warp(vols, ms):
                return torch.stack([affine_warp_zyx(v, m, out_shape, device=dev)
                                    for v, m in zip(vols, ms)])
    return warp, workspace
