"""General 3D affine warp as a product of elementary resampling passes.

Counterpart of the forward half of ``biahub_tpu/kernels/multipass_warp.py``:
an affine's linear part factors (LU) into the fixed :data:`CANONICAL_SLOTS`
of elementary passes, each resampling ONE axis r at ``(cr*i_r + tau) +
co*i_o``; all passes run in one common integer frame, the union box of
every stage's sampling range with a 2-voxel margin, into which the volume
is embedded by edge replication; the output is a slice of the last stage,
and the exact constant-fill mask of the original matrix (a general 3x4
form of :func:`~biahub_tpu_torch.kernels.affine.exact_domain_mask_general`)
gives scipy's fill. Each pass is Catmull-Rom (order 3) by default.

One pass is kernel H (``csrc/multipass.cu``, through
:mod:`biahub_tpu_torch.kernels.multipass_cuda`) for a CUDA tensor and
:func:`resample_pass_plain` for a CPU tensor. Its coefficients are a device
table: one row set for a single concrete matrix, or a (B, 7, 3) table, one
row set per volume, for the batched form (the reference's
``make_batched_multipass_kernel``).

The traced warp (:func:`make_traced_multipass_warp`, the reference's
:474-587) takes the matrix as a tensor and is differentiable in it: each
pass is a :class:`ResamplePass`, whose backward runs kernel I (the
coefficient gradient, :func:`resample_pass_deriv_plain`) and kernel J (the
data adjoint, :func:`resample_pass_adjoint_plain`). Its pass is the XLA
form ``_apply_pass`` (per-pass fill, taps clamped to the frame), so I and J
give that form's exact gradient.

The chunked warps (:func:`multipass_affine_warp_zyx_chunked`,
:func:`chunked_affine_warp_zyx`, the reference's :629-847) warp a volume
too large for the device one output chunk at a time: each chunk reads only
the input box its passes reach (``read_fn``) and warps it with the matrix
moved to the chunk's origin. That loop is host code around the same
kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from biahub_tpu_torch.device import as_tensor, resolve_device

__all__ = [
    "CANONICAL_SLOTS",
    "factor_affine",
    "common_frame_bytes",
    "resample_pass_plain",
    "resample_pass_deriv_plain",
    "resample_pass_adjoint_plain",
    "ResamplePass",
    "make_traced_multipass_warp",
    "traced_frame",
    "traced_pass_rows",
    "multipass_affine_warp_zyx",
    "multipass_affine_warp_zyx_batched",
    "union_frame",
    "multipass_affine_warp_zyx_chunked",
    "chunked_affine_warp_zyx",
]


def _pass_matrix(r: int, o: int, cr: float, co: float, tau: float) -> np.ndarray:
    e = np.eye(4)
    e[r, r] = cr
    if o != r:
        e[r, o] = co
    e[r, 3] = tau
    return e


# Fixed slot order shared by every factorization: the batched warp runs one
# pass per slot with a coefficient row per volume, so all matrices of a
# batch take the same passes (identity slots are exact no-ops).
CANONICAL_SLOTS: tuple[tuple[int, int], ...] = (
    (1, 0), (2, 0), (2, 1),  # L = E(1,0) E(2,0) E(2,1) exactly
    (0, 1), (0, 2), (1, 2), (2, 2),  # U row passes + final z scale
)


def _factor_canonical(matrix: np.ndarray) -> list[list[float]]:
    """Factor into the 7 CANONICAL_SLOTS passes; returns [cr, co, tau] each.

    The product of the slot pass matrices in order equals ``matrix``. Raises
    ValueError on vanishing pivots (e.g. exact 90-degree rotations)."""
    m = np.asarray(matrix, dtype=np.float64)
    a = m[:3, :3]
    if abs(np.linalg.det(a)) < 1e-12:
        raise ValueError("Singular linear part")

    lower = np.eye(3)
    upper = a.copy()
    for col in range(2):
        if abs(upper[col, col]) < 1e-9:
            raise ValueError("Zero pivot; permute axes before factoring")
        for row in range(col + 1, 3):
            f = upper[row, col] / upper[col, col]
            lower[row, col] = f
            upper[row] -= f * upper[col]
    u00, u01, u02 = upper[0]
    u11, u12 = upper[1, 1], upper[1, 2]
    u22 = upper[2, 2]
    if abs(u11) < 1e-9 or abs(u22) < 1e-9 or abs(u00) < 1e-9:
        raise ValueError("Zero pivot; permute axes before factoring")

    # U = E(0,1,u00,alpha) E(0,2,1,beta) E(1,2,u11,gamma) D(2,u22).
    alpha = u01 / u11
    gamma = u12 / u22
    beta = (u02 / u22 - alpha * gamma) / u00
    coeffs = [
        [1.0, float(lower[1, 0]), 0.0],
        [1.0, float(lower[2, 0]), 0.0],
        [1.0, float(lower[2, 1]), 0.0],
        [float(u00), float(alpha), 0.0],
        [1.0, float(beta), 0.0],
        [float(u11), float(gamma), 0.0],
        [float(u22), 0.0, 0.0],
    ]

    # Translations: each axis's unknown goes to the first slot on its row
    # (slots 0, 1, 3 for rows 1, 2, 0); the prefix-column system is
    # solvable for nonsingular linear parts.
    first_for_row = {1: 0, 2: 1, 0: 3}
    rows = sorted(first_for_row)
    cols = []
    for row_axis in rows:
        slot = first_for_row[row_axis]
        prefix = np.eye(4)
        for (r, o), (cr, co, tau) in zip(CANONICAL_SLOTS[:slot], coeffs[:slot]):
            prefix = prefix @ _pass_matrix(r, o, cr, co, tau)
        cols.append(prefix[:3, row_axis])
    taus = np.linalg.solve(np.stack(cols, axis=1), m[:3, 3])
    for row_axis, tau in zip(rows, taus):
        coeffs[first_for_row[row_axis]][2] = float(tau)

    full = np.eye(4)
    for (r, o), (cr, co, tau) in zip(CANONICAL_SLOTS, coeffs):
        full = full @ _pass_matrix(r, o, cr, co, tau)
    if not np.allclose(full, m, atol=1e-6):
        raise ValueError("Affine factorization self-check failed")
    return coeffs


def factor_affine(matrix: np.ndarray) -> list[tuple[int, int, float, float, float]]:
    """Factor a 4x4 affine into elementary (r, o, cr, co, tau) passes whose
    product in list order is ``matrix``, exact identity slots dropped.
    Raises ValueError on vanishing pivots."""
    coeffs = _factor_canonical(matrix)
    passes = [
        (r, o, cr, co, tau)
        for (r, o), (cr, co, tau) in zip(CANONICAL_SLOTS, coeffs)
        if not (cr == 1.0 and (o == r or co == 0.0) and tau == 0.0)
    ]
    return passes or [(0, 0, 1.0, 0.0, 0.0)]


def _coord_bounds(passes, in_shape, out_shape) -> tuple[np.ndarray, np.ndarray]:
    """Float (lo, hi) coordinate bounds any stage touches, the input extent
    included: each stage's sampling box, back-propagated from the output
    box through the passes."""
    in_shape = np.asarray(in_shape)
    out_shape = np.asarray(out_shape)
    n = len(passes)
    boxes = [None] * (n + 1)
    boxes[n] = (np.zeros(3), out_shape.astype(np.float64) - 1)
    for k in range(n - 1, -1, -1):
        r, o, cr, co, tau = passes[k]
        lo, hi = boxes[k + 1]
        vals = [
            cr * v + (co * w if o != r else 0.0) + tau
            for v in (lo[r], hi[r])
            for w in ((lo[o], hi[o]) if o != r else (0.0,))
        ]
        new_lo, new_hi = lo.copy(), hi.copy()
        new_lo[r], new_hi[r] = min(vals), max(vals)
        boxes[k] = (new_lo, new_hi)
    los = np.stack([b[0] for b in boxes] + [np.zeros(3)])
    his = np.stack([b[1] for b in boxes] + [in_shape.astype(np.float64) - 1])
    return los.min(axis=0), his.max(axis=0)


def _frame_from_bounds(lo: np.ndarray, hi: np.ndarray):
    """(offset, frame shape): common index = coordinate - offset, with 2
    margin voxels per side for the Catmull-Rom taps."""
    off = np.floor(lo).astype(int) - 2
    size = (np.ceil(hi).astype(int) - off) + 4
    return off, tuple(int(s) for s in size)


def _slot_passes(coeffs):
    return [(r, o, cr, co, tau) for (r, o), (cr, co, tau) in zip(CANONICAL_SLOTS, coeffs)]


def common_frame_bytes(matrices, in_shape, out_shape) -> int:
    """Per-volume device working footprint of the batched multipass warp:
    two float32 frames of the union box of every matrix's bounds (the
    reference's ``common_frame_bytes``). 0 when no matrix needs the frame
    (all translations or in-plane, or none factorable)."""
    from biahub_tpu_torch.kernels.affine import is_inplane_matrix, is_translation_matrix

    mats = np.asarray(matrices, dtype=np.float64).reshape(-1, 4, 4)
    if all(is_translation_matrix(m) or is_inplane_matrix(m) for m in mats):
        return 0
    factorable = []
    for m in mats:
        try:
            _factor_canonical(m)
        except ValueError:  # vanishing pivot: the exact gather, no frame
            continue
        factorable.append(m)
    if not factorable:
        return 0
    _, frame_shape = union_frame(factorable, in_shape, out_shape)
    return 2 * 4 * int(np.prod(frame_shape))


def _tau_eff(r, o, cr, co, tau, off) -> float:
    """The pass's offset in common-frame indices (coordinate - off)."""
    return cr * off[r] + (co * off[o] if o != r else 0.0) + tau - off[r]


def _axis_ramp(n: int, axis: int, device) -> torch.Tensor:
    shape = [1, 1, 1, 1]
    shape[axis + 1] = n
    return torch.arange(n, dtype=torch.float32, device=device).reshape(shape)


def _pass_coords(shape, coeffs: torch.Tensor, slot: int, r: int, o: int) -> torch.Tensor:
    """The pass's sampling coordinate ``(cr*i_r + tau) + co*i_o`` in float32,
    broadcastable to a (B, F0, F1, F2) frame of ``shape``."""
    batch = shape[0]
    dev = coeffs.device
    row = coeffs[slot] if coeffs.ndim == 2 else coeffs[:, slot]
    row = row.reshape(-1, 3).expand(batch, 3)
    cr, co, tau = (row[:, j].reshape(batch, 1, 1, 1) for j in range(3))
    coords = cr * _axis_ramp(shape[r + 1], r, dev) + tau
    if o != r:
        coords = coords + co * _axis_ramp(shape[o + 1], o, dev)
    return coords


def _band_weights(t: torch.Tensor, order: int):
    """(tap offset, weight) of the linear (order 1) or Catmull-Rom band."""
    if order == 1:
        return ((0, 1.0 - t), (1, t))
    t2 = t * t
    t3 = t2 * t
    return (
        (-1, -0.5 * t3 + t2 - 0.5 * t),
        (0, 1.5 * t3 - 2.5 * t2 + 1.0),
        (1, -1.5 * t3 + 2.0 * t2 + 0.5 * t),
        (2, 0.5 * t3 - 0.5 * t2),
    )


def _band_derivatives(t: torch.Tensor, order: int):
    """(tap offset, d weight / d t) of the band (pallas_resample.py:1257-1265)."""
    if order == 1:
        return ((0, -1.0), (1, 1.0))
    t2 = t * t
    return (
        (-1, -1.5 * t2 + 2.0 * t - 0.5),
        (0, 4.5 * t2 - 5.0 * t),
        (1, -4.5 * t2 + 4.0 * t + 0.5),
        (2, 1.5 * t2 - 1.0 * t),
    )


def _taps(coords: torch.Tensor, size_in: int):
    """floor(c) as int64, t = c - floor(c), and the domain [0, size_in - 1]."""
    i0 = torch.floor(coords)
    t = coords - i0
    in_domain = (coords >= 0) & (coords <= size_in - 1)
    return i0.to(torch.int64), t, in_domain


def resample_pass_plain(src: torch.Tensor, coeffs: torch.Tensor, slot: int, r: int,
                        o: int, order: int = 3, fill: float = 0.0) -> torch.Tensor:
    """Plain version of kernel H: one pass over a (B, F0, F1, F2) float32
    frame -> the same shape. ``coeffs``: float32 (S, 3), one matrix for the
    batch, or (B, S, 3), a row set per volume; row ``slot`` holds (cr, co,
    tau). Each step is one float32 op in the reference's operand order
    (``_apply_pass``, multipass_warp.py:153-209)."""
    size_in = src.shape[r + 1]
    i0, t, in_domain = _taps(_pass_coords(src.shape, coeffs, slot, r, o), size_in)
    out = None
    for k, w in _band_weights(t, order):
        idx = (i0 + k).clamp(0, size_in - 1).expand(src.shape)
        v = torch.gather(src, r + 1, idx)
        out = w * v if out is None else out + w * v
    return torch.where(in_domain, out, torch.tensor(float(fill), dtype=out.dtype,
                                                    device=src.device))


def resample_pass_deriv_plain(src: torch.Tensor, ybar: torch.Tensor, coeffs: torch.Tensor,
                              slot: int, r: int, o: int, order: int = 3) -> torch.Tensor:
    """Plain version of kernel I: the pass's coefficient cotangents -> (B, 3)
    float64, per volume ``(sum ybar*dy/dc*i_r, sum ybar*dy/dc*i_o, sum
    ybar*dy/dc)`` (the second 0 when ``o == r``). ``dy/dc`` is the band
    derivative resample of ``src`` at H's coordinates and clamped taps, 0
    where H writes the fill. The coordinate is float32 as in H; the band
    derivative, the products and the sums are float64."""
    size_in = src.shape[r + 1]
    dev = src.device
    i0, t, in_domain = _taps(_pass_coords(src.shape, coeffs, slot, r, o), size_in)
    dv = None
    for k, dw in _band_derivatives(t.to(torch.float64), order):
        idx = (i0 + k).clamp(0, size_in - 1).expand(src.shape)
        v = torch.gather(src, r + 1, idx).to(torch.float64)
        dv = dw * v if dv is None else dv + dw * v
    g = torch.where(in_domain, ybar.to(torch.float64) * dv,
                    torch.zeros((), dtype=torch.float64, device=dev))
    axes = (1, 2, 3)
    g_r = (g * _axis_ramp(size_in, r, dev).to(torch.float64)).sum(axes)
    g_o = ((g * _axis_ramp(src.shape[o + 1], o, dev).to(torch.float64)).sum(axes)
           if o != r else torch.zeros_like(g_r))
    return torch.stack([g_r, g_o, g.sum(axes)], 1)


def resample_pass_adjoint_plain(ybar: torch.Tensor, coeffs: torch.Tensor, slot: int, r: int,
                                o: int, order: int = 3) -> torch.Tensor:
    """Plain version of kernel J: the exact transpose of
    :func:`resample_pass_plain` in its data, a (B, F0, F1, F2) float32
    cotangent -> the same shape: each in-domain sample's ``w_k * ybar``
    scatter-added onto its clamped tap index along ``r``."""
    size_in = ybar.shape[r + 1]
    i0, t, in_domain = _taps(_pass_coords(ybar.shape, coeffs, slot, r, o), size_in)
    yb = torch.where(in_domain, ybar, torch.zeros((), dtype=ybar.dtype, device=ybar.device))
    out = torch.zeros_like(ybar)
    for k, w in _band_weights(t, order):
        idx = (i0 + k).clamp(0, size_in - 1).expand(ybar.shape)
        out.scatter_add_(r + 1, idx, w * yb)
    return out


def _run_passes(frame: torch.Tensor, table: torch.Tensor, slots, order: int,
                fill: float) -> torch.Tensor:
    """Every pass of ``slots`` ((r, o) per row of ``table``) in turn, kernel
    H ping-ponging two frame buffers on the card."""
    from biahub_tpu_torch.kernels import multipass_cuda

    spare = torch.empty_like(frame) if frame.device.type == "cuda" else None
    for k, (r, o) in enumerate(slots):
        out = multipass_cuda.resample_pass(frame, table, k, r, o, order, fill, out=spare)
        frame, spare = out, frame
    return frame


def _embed(volumes: torch.Tensor, off, frame_shape) -> torch.Tensor:
    """(B, Z, Y, X) -> (B, F0, F1, F2), edge-replicated into the frame."""
    size = np.asarray(frame_shape)
    in_shape = volumes.shape[1:]
    lo = [int(-off[ax]) for ax in range(3)]
    hi = [int(size[ax] - in_shape[ax] + off[ax]) for ax in range(3)]
    pad = (lo[2], hi[2], lo[1], hi[1], lo[0], hi[0])
    return torch.nn.functional.pad(volumes[:, None], pad, mode="replicate")[:, 0].contiguous()


def _crop_and_mask(frame: torch.Tensor, off, matrices, in_shape, out_shape,
                   fill: float) -> torch.Tensor:
    from biahub_tpu_torch.kernels.affine import exact_domain_mask_general

    start = (-np.asarray(off)).astype(int)
    out = frame[:, start[0]:start[0] + out_shape[0], start[1]:start[1] + out_shape[1],
                start[2]:start[2] + out_shape[2]]
    inside = exact_domain_mask_general(matrices, in_shape, out_shape, frame.device)
    return torch.where(inside, out, torch.tensor(float(fill), dtype=out.dtype,
                                                 device=out.device)).contiguous()


def multipass_affine_warp_zyx(
    volume,
    matrix,
    output_shape: tuple[int, int, int],
    fill: float = 0.0,
    order: int = 3,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """Warp one (Z, Y, X) volume by a general output->input ``matrix`` ->
    (Zo, Yo, Xo) float32, through its factored passes in the common frame
    (the reference's ``multipass_affine_warp_zyx``; identity slots
    dropped, one launch of H per remaining pass). Raises ValueError on a
    vanishing pivot."""
    dev = resolve_device(device)
    matrix = np.asarray(matrix, dtype=np.float64)
    data = as_tensor(volume, dev)
    in_shape = tuple(int(s) for s in data.shape)
    out_shape = tuple(int(s) for s in output_shape)
    passes = factor_affine(matrix)
    lo, hi = _coord_bounds(passes, in_shape, out_shape)
    off, frame_shape = _frame_from_bounds(lo, hi)
    table = torch.tensor(
        [[cr, co, _tau_eff(r, o, cr, co, tau, off)] for r, o, cr, co, tau in passes],
        dtype=torch.float32).to(dev)
    # A shear whose off-diagonal coefficient is 0 resamples along r alone.
    slots = [(r, r if co == 0.0 else o) for r, o, _, co, _ in passes]
    frame = _run_passes(_embed(data[None], off, frame_shape), table, slots, order, fill)
    return _crop_and_mask(frame, off, matrix[None], in_shape, out_shape, fill)[0]


def union_frame(matrices, in_shape, out_shape):
    """(offset, frame shape) of the frame spanning every matrix's bounds
    through the canonical slots (the frame of the reference's
    ``make_batched_multipass_kernel``). Raises ValueError when a matrix has
    a vanishing pivot."""
    lo = np.full(3, np.inf)
    hi = np.full(3, -np.inf)
    for m in np.asarray(matrices, dtype=np.float64).reshape(-1, 4, 4):
        m_lo, m_hi = _coord_bounds(_slot_passes(_factor_canonical(m)), in_shape, out_shape)
        lo = np.minimum(lo, m_lo)
        hi = np.maximum(hi, m_hi)
    return _frame_from_bounds(lo, hi)


def multipass_affine_warp_zyx_batched(
    volumes,
    matrices,
    output_shape: tuple[int, int, int],
    fill: float = 0.0,
    frame=None,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """Warp each volume of a (B, Z, Y, X) batch by its own general matrix
    -> (B, Zo, Yo, Xo) float32 (the reference's
    ``make_batched_multipass_kernel`` and its kernel): every matrix takes
    the 7 :data:`CANONICAL_SLOTS` with a (B, 7, 3) coefficient table, one
    launch of H per slot over the batch, in one frame: ``frame`` (the
    :func:`union_frame` of a larger set, so that every batch of a run
    computes alike) or the union of these matrices' bounds. Raises
    ValueError when a matrix has a vanishing pivot."""
    dev = resolve_device(device)
    data = as_tensor(volumes, dev)
    if data.ndim != 4:
        raise ValueError(f"want a (B, Z, Y, X) batch, got {tuple(data.shape)}")
    mats = np.asarray(matrices, dtype=np.float64).reshape(-1, 4, 4)
    if len(mats) != data.shape[0]:
        raise ValueError(f"{len(mats)} matrices for a batch of {data.shape[0]}")
    in_shape = tuple(int(s) for s in data.shape[1:])
    out_shape = tuple(int(s) for s in output_shape)
    all_coeffs = [_factor_canonical(m) for m in mats]
    off, frame_shape = frame if frame is not None else union_frame(mats, in_shape, out_shape)
    params = np.zeros((len(mats), len(CANONICAL_SLOTS), 3), dtype=np.float32)
    for i, coeffs in enumerate(all_coeffs):
        for k, (r, o, cr, co, tau) in enumerate(_slot_passes(coeffs)):
            params[i, k] = (cr, co, _tau_eff(r, o, cr, co, tau, off))
    table = torch.from_numpy(params).to(dev)
    frame = _run_passes(_embed(data, off, frame_shape), table, CANONICAL_SLOTS, 3, fill)
    return _crop_and_mask(frame, off, mats, in_shape, out_shape, fill)


class ResamplePass(torch.autograd.Function):
    """One pass of the traced warp, differentiable in the frame and in its
    (3,) coefficient row (cr, co, tau): the reference's ``_pallas_pass_ad``
    (:590-626) with ``_apply_pass``'s semantics. Forward: kernel H with a
    one-row table. Backward: kernel I for the row's gradient and, when the
    frame needs one, kernel J for the frame's."""

    @staticmethod
    def forward(ctx, frame, coeff_row, r: int, o: int, order: int, fill: float):
        from biahub_tpu_torch.kernels import multipass_cuda

        table = coeff_row.detach().reshape(1, 3).contiguous()
        ctx.save_for_backward(frame, table)
        ctx.pass_args = (r, o, order)
        return multipass_cuda.resample_pass(frame, table, 0, r, o, order, fill)

    @staticmethod
    def backward(ctx, ybar):
        from biahub_tpu_torch.kernels import multipass_cuda

        frame, table = ctx.saved_tensors
        r, o, order = ctx.pass_args
        ybar = ybar.contiguous()
        grad_frame = grad_row = None
        if ctx.needs_input_grad[1]:
            sums = multipass_cuda.resample_pass_deriv(frame, ybar, table, 0, r, o, order)
            grad_row = sums.sum(0).to(table.dtype)
        if ctx.needs_input_grad[0]:
            grad_frame = multipass_cuda.resample_pass_adjoint(ybar, table, 0, r, o, order)
        return grad_frame, grad_row, None, None, None, None


def _traced_coefficients(matrix: torch.Tensor):
    """The canonical slots' (cr, co, tau) of a float32 (4, 4) tensor, as
    tensors: the Doolittle LU without pivoting and the closed-form
    translations of the reference's traced warp (:530-556), op for op."""
    a = matrix[:3, :3]
    t = matrix[:3, 3]
    l10 = a[1, 0] / a[0, 0]
    l20 = a[2, 0] / a[0, 0]
    u11 = a[1, 1] - l10 * a[0, 1]
    u12 = a[1, 2] - l10 * a[0, 2]
    l21 = (a[2, 1] - l20 * a[0, 1]) / u11
    u22 = a[2, 2] - l20 * a[0, 2] - l21 * u12
    u00, u01, u02 = a[0, 0], a[0, 1], a[0, 2]
    alpha = u01 / u11
    gamma = u12 / u22
    beta = (u02 / u22 - alpha * gamma) / u00
    tau_0 = t[0]
    tau_1 = t[1] - t[0] * l10
    tau_2 = t[2] - t[0] * (l20 + l21 * l10)
    one = torch.ones((), dtype=matrix.dtype, device=matrix.device)
    zero = torch.zeros((), dtype=matrix.dtype, device=matrix.device)
    return (
        (one, l10, tau_1),
        (one, l20, tau_2),
        (one, l21, zero),
        (u00, alpha, tau_0),
        (one, beta, zero),
        (u11, gamma, zero),
        (u22, zero, zero),
    )


def traced_frame(in_shape, out_shape, margin: float):
    """(offset, frame shape, crop start) of the traced warp's static frame:
    each axis padded by ``ceil(margin * extent) + 2`` voxels, the extent
    being the larger of the input's and the output's."""
    ext = np.maximum(np.asarray(in_shape), np.asarray(out_shape))
    pad_n = np.ceil(margin * ext).astype(int) + 2
    off = -pad_n
    return off, tuple(int(s) for s in ext + 2 * pad_n + 2), (-off).astype(int)


def traced_pass_rows(matrix: torch.Tensor, off):
    """[(r, o, (3,) row (cr, co, tau))] of the canonical slots for a float32
    (4, 4) tensor, tau in the frame's indices (the reference's ``tau_eff``,
    :562), differentiable in the matrix."""
    rows = []
    for (r, o), (cr, co, tau) in zip(CANONICAL_SLOTS, _traced_coefficients(matrix)):
        tau_eff = cr * int(off[r]) + (co * int(off[o]) if o != r else 0.0) + tau - int(off[r])
        rows.append((r, o, torch.stack([cr, co, tau_eff])))
    return rows


def make_traced_multipass_warp(
    in_shape: tuple[int, int, int],
    out_shape: tuple[int, int, int],
    fill: float = 0.0,
    margin: float = 0.25,
    order: int = 3,
    device: str | torch.device = "cuda",
):
    """Differentiable multipass warp for a matrix given as a tensor (the
    reference's ``make_traced_multipass_warp``, :474-587, on its XLA pass).

    Returns ``warp(volume, matrix) -> (Zo, Yo, Xo)`` float32: ``volume`` a
    (Z, Y, X) tensor on ``device``, ``matrix`` a float32 (4, 4) tensor there,
    output->input, which may require a gradient. The frame is static
    (:func:`traced_frame`), the volume embedded in it by edge replication;
    the 7 canonical passes run as :class:`ResamplePass` (7 launches of H
    forward; 7 of I and, past the first pass, 6 of J backward); the exact
    fill mask comes from the matrix, detached, on the device. Passes
    sampling beyond the frame clamp to its edge, and vanishing pivots are
    not caught: keep the matrix near the start of a registration, away from
    90 degree permutations."""
    from biahub_tpu_torch.kernels.affine import exact_domain_mask_general

    dev = resolve_device(device)
    in_shape = tuple(int(s) for s in in_shape)
    out_shape = tuple(int(s) for s in out_shape)
    off, frame_shape, start = traced_frame(in_shape, out_shape, margin)

    def warp(volume: torch.Tensor, matrix: torch.Tensor) -> torch.Tensor:
        matrix = matrix.to(device=dev, dtype=torch.float32)
        data = _embed(volume.to(device=dev, dtype=torch.float32)[None], off, frame_shape)
        for r, o, row in traced_pass_rows(matrix, off):
            data = ResamplePass.apply(data, row, r, o, order, float(fill))
        out = data[0, start[0]:start[0] + out_shape[0], start[1]:start[1] + out_shape[1],
                   start[2]:start[2] + out_shape[2]]
        inside = exact_domain_mask_general(matrix.detach(), in_shape, out_shape, dev)
        return torch.where(inside, out, torch.tensor(float(fill), dtype=out.dtype, device=dev))

    return warp


# Catmull-Rom reads i0 - 1 .. i0 + 2: the support a chunk's input box keeps.
_SUPPORT = 3


def _pass_input_needs(passes, support: int):
    """Input-coordinate box a chunk's pass chain touches: the chunk box
    back-propagated through every pass (intermediate shears overshoot the
    plain affine image of the corners), widened by the interpolation
    support at every pass."""

    def input_needs(lo, hi):
        b_lo, b_hi = lo.copy(), hi.copy()
        for r, o, cr, co, tau in reversed(passes):
            vals = [
                cr * v + (co * w if o != r else 0.0) + tau
                for v in (b_lo[r], b_hi[r])
                for w in ((b_lo[o], b_hi[o]) if o != r else (0.0,))
            ]
            b_lo[r], b_hi[r] = min(vals) - support, max(vals) + support
        return b_lo, b_hi

    return input_needs


def _corner_input_needs(matrix: np.ndarray, support: int):
    """Input box for single-pass warps: the affine image of the 8 corners."""

    def input_needs(lo, hi):
        corners = np.array(
            [[z, y, x, 1.0] for z in (lo[0], hi[0]) for y in (lo[1], hi[1])
             for x in (lo[2], hi[2])]
        )
        imgs = (matrix @ corners.T)[:3]
        return imgs.min(axis=1) - support, imgs.max(axis=1) + support

    return input_needs


def _chunked_warp_loop(read_fn, matrix: np.ndarray, in_shape, out_shape, chunk_zyx,
                       input_needs, warp_chunk, write_fn, dev: torch.device):
    """The reference's loop (:789-847): for each output chunk in z, y, x
    order, read its input box (clipped to the volume, ``_SUPPORT`` voxels of
    margin), warp it with ``local`` (global out = chunk start + local out,
    global in = box start + local in), and hand ``(slices, chunk)`` to
    ``write_fn(zs, ys, xs, chunk)``, or collect the pairs when it is None."""
    in_shape = tuple(int(s) for s in in_shape)
    out_shape = tuple(int(s) for s in out_shape)
    results = []
    for z0 in range(0, out_shape[0], chunk_zyx[0]):
        for y0 in range(0, out_shape[1], chunk_zyx[1]):
            for x0 in range(0, out_shape[2], chunk_zyx[2]):
                lo = np.array([z0, y0, x0], dtype=np.float64)
                hi = np.minimum(lo + np.asarray(chunk_zyx) - 1,
                                np.asarray(out_shape, dtype=np.float64) - 1)
                need_lo, need_hi = input_needs(lo, hi)
                in_lo = np.clip(np.floor(need_lo) - _SUPPORT, 0, None).astype(int)
                in_hi = np.minimum(np.ceil(need_hi) + _SUPPORT,
                                   np.asarray(in_shape) - 1).astype(int)
                in_hi = np.maximum(in_hi, in_lo)  # a chunk wholly outside the input
                sub = read_fn(slice(in_lo[0], in_hi[0] + 1), slice(in_lo[1], in_hi[1] + 1),
                              slice(in_lo[2], in_hi[2] + 1))
                local = matrix.copy()
                local[:3, 3] = matrix[:3, 3] + matrix[:3, :3] @ lo - in_lo.astype(np.float64)
                chunk_shape = tuple(int(s) for s in (hi - lo).astype(int) + 1)
                out_chunk = warp_chunk(as_tensor(sub, dev), local, chunk_shape)
                sl = (slice(z0, z0 + chunk_shape[0]), slice(y0, y0 + chunk_shape[1]),
                      slice(x0, x0 + chunk_shape[2]))
                if write_fn is not None:
                    write_fn(*sl, out_chunk)
                else:
                    results.append((sl, out_chunk))
    return results if write_fn is None else None


def multipass_affine_warp_zyx_chunked(
    read_fn,
    matrix,
    in_shape: tuple[int, int, int],
    out_shape: tuple[int, int, int],
    chunk_zyx: tuple[int, int, int],
    fill: float = 0.0,
    write_fn=None,
    device: str | torch.device = "cuda",
):
    """General warp of a volume too large for the device, one output chunk
    at a time (the reference's :629-667): each chunk's input box is the
    chunk box back-propagated through the pass chain; only that box is read
    (``read_fn(z_slice, y_slice, x_slice)``, an array or a tensor) and warped
    by :func:`multipass_affine_warp_zyx` with the matrix moved to the chunk.
    Chunks go to ``write_fn(z_slice, y_slice, x_slice, chunk)``, or come
    back as a list of ``(slices, chunk)``. The fill mask is exact; interior
    values agree with the whole-volume warp at the multipass interpolation
    tolerance (the reference states ~0.3% on smooth data: the factored
    passes' intermediate lattice shifts with the chunk's offset)."""
    dev = resolve_device(device)
    matrix = np.asarray(matrix, dtype=np.float64)

    def warp_chunk(sub, local, chunk_shape):
        return multipass_affine_warp_zyx(sub, local, chunk_shape, fill=fill, device=dev)

    return _chunked_warp_loop(read_fn, matrix, in_shape, out_shape, chunk_zyx,
                              _pass_input_needs(factor_affine(matrix), _SUPPORT),
                              warp_chunk, write_fn, dev)


def chunked_affine_warp_zyx(
    read_fn,
    matrix,
    in_shape: tuple[int, int, int],
    out_shape: tuple[int, int, int],
    chunk_zyx: tuple[int, int, int],
    fill: float = 0.0,
    write_fn=None,
    order: int = 1,
    device: str | torch.device = "cuda",
):
    """The chunked warp that dispatches each chunk as
    :func:`~biahub_tpu_torch.kernels.affine.affine_warp_auto` does (the
    reference's :708-787), so results do not depend on the batch budget.
    Order 1: a translation takes ``translation_warp_zyx`` with the chunk's
    translation computed as float32(global) + an integer, so that its
    samples round as the whole-volume warp's; an in-plane matrix the
    in-plane warp (kernels E and F), its input box from the same three
    passes; any other the multipass warp, or the exact gather when a pivot
    vanishes. Other orders take the exact gather, the box from the corners.
    ``read_fn`` and ``write_fn`` as in
    :func:`multipass_affine_warp_zyx_chunked`."""
    from biahub_tpu_torch.kernels.affine import (
        affine_warp_auto,
        is_inplane_matrix,
        is_translation_matrix,
        translation_warp_zyx,
    )

    dev = resolve_device(device)
    m = np.asarray(matrix, dtype=np.float64)
    translation = order == 1 and is_translation_matrix(m)

    def warp_chunk(sub, local, chunk_shape):
        if translation:
            m_int = np.round(local[:3, 3] - m[:3, 3]).astype(np.float32)
            shift = m[:3, 3].astype(np.float32) + m_int
            return translation_warp_zyx(sub, shift, chunk_shape, fill=fill, device=dev)
        return affine_warp_auto(sub, local, chunk_shape, fill=fill, order=order, device=dev)

    if translation:
        passes = [(ax, ax, 1.0, 0.0, float(m[ax, 3])) for ax in range(3)]
        input_needs = _pass_input_needs(passes, _SUPPORT)
    elif order == 1 and is_inplane_matrix(m):
        b1 = m[1, 2] / m[2, 2]
        passes = [
            (0, 0, float(m[0, 0]), 0.0, float(m[0, 3])),
            (1, 2, float(m[1, 1] - b1 * m[2, 1]), float(b1), float(m[1, 3] - b1 * m[2, 3])),
            (2, 1, float(m[2, 2]), float(m[2, 1]), float(m[2, 3])),
        ]
        input_needs = _pass_input_needs(passes, _SUPPORT)
    elif order == 1:
        try:
            input_needs = _pass_input_needs(factor_affine(m), _SUPPORT)
        except ValueError:  # a vanishing pivot: the exact gather per chunk
            input_needs = _corner_input_needs(m, _SUPPORT)
    else:
        input_needs = _corner_input_needs(m, _SUPPORT)
    return _chunked_warp_loop(read_fn, m, in_shape, out_shape, chunk_zyx, input_needs,
                              warp_chunk, write_fn, dev)
