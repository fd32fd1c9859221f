"""Intensity-based similarity registration: the ANTs replacement, on the card.

Counterpart of ``biahub_tpu/registration/intensity.py``: a similarity warp
(rotation vector, log-scale, translation about the volume centre) is
optimized with Adam against a normalized cross-correlation loss over three
resolution levels (shrink 6/3/1, smoothing 2/1/0), the gradient flowing
through the traced multipass warp
(:func:`~biahub_tpu_torch.kernels.multipass_warp.make_traced_multipass_warp`,
order 1, margin 0.15: kernel H forward, kernels I and J backward), the
route the reference takes on its accelerator. Parameters, Adam's state and
the losses stay on the device; the losses are read once per level.
Preprocessing (initial warp, LIR crop, circular mask, clip, Sobel, channel
sum) and the composition of the result follow the reference; the LIR, the
clip's quantile and the Sobel filter run on the host with numpy and scipy,
as there. ``output_folder_path`` saves each composed transform as
``<t>.npy`` (under ``xyz_transforms/`` for a stack), as the reference's.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from biahub_tpu_torch.convert import affine_transform_settings_from_reference
from biahub_tpu_torch.device import as_tensor, resolve_device
from biahub_tpu_torch.kernels.affine import affine_warp_auto
from biahub_tpu_torch.kernels.multipass_warp import make_traced_multipass_warp

__all__ = [
    "estimate",
    "preprocess_czyx",
    "estimate_czyx",
    "postprocess_transform",
    "estimate_tczyx",
    "sobel_magnitude",
]

DEFAULT_REG_KWARGS = {
    "type_of_transform": "Similarity",
    "aff_shrink_factors": (6, 3, 1),
    "aff_iterations": (2100, 1200, 50),
    "aff_smoothing_sigmas": (2, 1, 0),
}

# Adam steps per level. ANTs' per-level gradient-descent budgets (2100/1200/50)
# are scaled down: Adam on an analytic gradient converges in far fewer steps.
MAX_ITERS_PER_LEVEL = 300
LEARNING_RATE = 0.02
# optax.adam's defaults: eps outside the square root, eps_root 0.
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def _rodrigues(rotvec: torch.Tensor) -> torch.Tensor:
    """Rotation matrix from a rotation vector (differentiable at zero)."""
    # norm() has a NaN gradient at 0; the epsilon inside the sqrt keeps the
    # derivative finite for the identity rotation the optimizer starts from.
    theta = torch.sqrt(torch.sum(rotvec * rotvec) + 1e-12)
    k = rotvec / theta
    zero = torch.zeros((), dtype=rotvec.dtype, device=rotvec.device)
    K = torch.stack([
        torch.stack([zero, -k[2], k[1]]),
        torch.stack([k[2], zero, -k[0]]),
        torch.stack([-k[1], k[0], zero]),
    ])
    eye = torch.eye(3, dtype=rotvec.dtype, device=rotvec.device)
    return eye + torch.sin(theta) * K + (1 - torch.cos(theta)) * (K @ K)


def _similarity_matrix(params: torch.Tensor, center: torch.Tensor) -> torch.Tensor:
    """Output->input warp: p_in = c + s*R(r) @ (p_out - c) + t, from
    ``params`` = rotation vector (3), log-scale (1), translation (3)."""
    lin = torch.exp(params[3]) * _rodrigues(params[:3])
    top = torch.cat([lin, (center - lin @ center + params[4:7])[:, None]], dim=1)
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=params.dtype, device=params.device)
    return torch.cat([top, bottom], dim=0)


def _gaussian_blur_zyx(vol: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur, radius ceil(3 sigma), zero "SAME" padding:
    three 1D float32 convolutions (TF32 off)."""
    if sigma <= 0:
        return vol
    radius = int(np.ceil(3 * sigma))
    x = np.arange(-radius, radius + 1)
    kernel = np.exp(-0.5 * (x / sigma) ** 2)
    kernel = torch.from_numpy((kernel / kernel.sum()).astype(np.float32)).to(vol.device)
    v = vol[None, None]
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=False,
                                    allow_tf32=False):
        for axis in range(3):
            shape = [1, 1, 1, 1, 1]
            shape[2 + axis] = len(kernel)
            padding = [0, 0, 0]
            padding[axis] = radius
            v = torch.nn.functional.conv3d(v, kernel.reshape(shape), padding=padding)
    return v[0, 0]


def _downsample(vol: torch.Tensor, factor: int) -> torch.Tensor:
    if factor == 1:
        return vol
    Z, Y, X = vol.shape
    z, y, x = Z // factor, Y // factor, X // factor
    trimmed = vol[: z * factor, : y * factor, : x * factor]
    return trimmed.reshape(z, factor, y, factor, x, factor).mean(dim=(1, 3, 5))


def _ncc_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a = a - torch.mean(a)
    b = b - torch.mean(b)
    denom = torch.sqrt(torch.sum(a * a) * torch.sum(b * b)) + 1e-8
    return 1.0 - torch.sum(a * b) / denom


def _adam_update(params, grads, mu, nu, count: int, lr: float = LEARNING_RATE):
    """One ``optax.adam(lr)`` step (scale_by_adam, then scale by -lr, then
    apply_updates) in optax's operand order. The bias corrections are
    float32 scalars computed on the host, so no step waits on the card."""
    mu = (1 - ADAM_B1) * grads + ADAM_B1 * mu
    nu = (1 - ADAM_B2) * (grads * grads) + ADAM_B2 * nu
    bc1 = float(np.float32(1) - np.float32(ADAM_B1) ** np.int32(count))
    bc2 = float(np.float32(1) - np.float32(ADAM_B2) ** np.int32(count))
    updates = (mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS)
    return params + updates * -lr, mu, nu


def _optimize_level(mov: torch.Tensor, ref: torch.Tensor, params0: torch.Tensor,
                    center: torch.Tensor, n_iters: int, out_shape):
    """Adam over the similarity params at one resolution level -> (params,
    losses), both on the device. The loss warps through the traced multipass
    warp (order 1, margin 0.15). Each step builds and frees its own graph."""
    warp = make_traced_multipass_warp(mov.shape, tuple(out_shape), margin=0.15, order=1,
                                      device=mov.device)
    params = params0.detach().clone()
    mu = torch.zeros_like(params)
    nu = torch.zeros_like(params)
    losses = torch.empty(n_iters, dtype=torch.float32, device=params.device)
    for i in range(n_iters):
        p = params.detach().requires_grad_(True)
        loss = _ncc_loss(warp(mov, _similarity_matrix(p, center)), ref)
        (grads,) = torch.autograd.grad(loss, p)
        losses[i] = loss.detach()
        params, mu, nu = _adam_update(params.detach(), grads, mu, nu, i + 1)
    return params, losses


def estimate(
    ref,
    mov,
    verbose: bool = False,
    ants_kwargs: dict | None = None,
    device: str | torch.device = "cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """Estimate a similarity warp aligning ``mov`` to ``ref`` ((Z, Y, X)
    arrays or tensors) -> (fwd, inv) float64 4x4: ``fwd`` is the
    output->input warp such that warping ``mov`` by it matches ``ref``."""
    dev = resolve_device(device)
    kwargs = {**DEFAULT_REG_KWARGS, **(ants_kwargs or {})}
    ref = as_tensor(ref, dev)
    mov = as_tensor(mov, dev)
    if ref.ndim != 3 or mov.ndim != 3:
        raise ValueError("estimate() expects 3D (Z, Y, X) volumes")

    params = torch.zeros(7, dtype=torch.float32, device=dev)
    for shrink, sigma, n in zip(kwargs["aff_shrink_factors"], kwargs["aff_smoothing_sigmas"],
                                kwargs["aff_iterations"]):
        ref_l = _downsample(_gaussian_blur_zyx(ref, sigma), shrink)
        mov_l = _downsample(_gaussian_blur_zyx(mov, sigma), shrink)
        center = (torch.tensor(ref_l.shape, dtype=torch.float32, device=dev) - 1) / 2
        # Translation transfers across levels as t_level = t_full / shrink
        level_params = torch.cat([params[:4], params[4:7] / shrink])
        level_params, losses = _optimize_level(
            mov_l, ref_l, level_params, center, int(min(n, MAX_ITERS_PER_LEVEL)),
            tuple(ref_l.shape))
        params = torch.cat([level_params[:4], level_params[4:7] * shrink])
        if verbose:
            first, last = losses[[0, -1]].tolist()
            print(f"level shrink={shrink} sigma={sigma}: loss {first:.4f} -> {last:.4f}")

    center_full = (torch.tensor(ref.shape, dtype=torch.float32, device=dev) - 1) / 2
    fwd = _similarity_matrix(params, center_full).cpu().numpy().astype(np.float64)
    return fwd, np.linalg.inv(fwd)


def sobel_magnitude(zyx: np.ndarray) -> np.ndarray:
    """3D Sobel gradient magnitude (replaces skimage.filters.sobel), on the
    host."""
    from scipy.ndimage import sobel as nd_sobel

    zyx = np.asarray(zyx, dtype=np.float32)
    total = np.zeros_like(zyx)
    for axis in range(zyx.ndim):
        g = nd_sobel(zyx, axis=axis)
        total += g * g
    # skimage normalizes by the kernel weight sum
    return np.sqrt(total) / np.sqrt(zyx.ndim) / 4.0


def preprocess_czyx(
    mov_czyx,
    ref_czyx,
    initial_tform,
    mov_channel_index: int | list = 0,
    ref_channel_index: int = 0,
    crop: bool = False,
    ref_mask_radius: float | None = None,
    clip: bool = False,
    sobel_filter: bool = False,
    verbose: bool = False,
    device: str | torch.device = "cuda",
) -> tuple[torch.Tensor, torch.Tensor, np.ndarray]:
    """Initial warp -> optional LIR crop / circular mask / clip / Sobel ->
    channel sum: (ref_zyx, mov_zyx) float32 tensors on the device and the
    crop's (z, y, x) offset, float32."""
    from biahub_tpu_torch.register import find_lir

    dev = resolve_device(device)
    mov_czyx = as_tensor(mov_czyx, dev)
    ref_czyx = as_tensor(ref_czyx, dev)
    if ref_mask_radius is not None and not (0 < ref_mask_radius <= 1):
        raise ValueError(
            "ref_mask_radius must be given as a fraction of image width, i.e. (0, 1]."
        )
    if bool((mov_czyx == 0).all()) or bool((ref_czyx == 0).all()):
        raise ValueError("Input data contains NaN or zeros.")

    ref_zyx = ref_czyx[ref_channel_index]
    if not isinstance(mov_channel_index, list):
        mov_channel_index = [mov_channel_index]
    initial = np.asarray(initial_tform, dtype=np.float64)
    mov_channels = []
    for idx in mov_channel_index:
        if verbose:
            print(f"Applying initial transform to moving channel {idx}...")
        mov_channels.append(affine_warp_auto(torch.nan_to_num(mov_czyx[idx], nan=0.0), initial,
                                             tuple(ref_zyx.shape), device=dev))

    offset = np.zeros(3, dtype=np.float32)
    if crop:
        mask = (ref_zyx != 0) & (mov_channels[0] != 0)
        if ref_mask_radius is not None:
            ref_mask = np.zeros(ref_zyx.shape[-2:], dtype=bool)
            y, x = np.ogrid[: ref_mask.shape[-2], : ref_mask.shape[-1]]
            center = (ref_mask.shape[-2] // 2, ref_mask.shape[-1] // 2)
            radius = int(ref_mask_radius * min(center))
            ref_mask[(x - center[0]) ** 2 + (y - center[1]) ** 2 <= radius**2] = True
            mask = mask & torch.from_numpy(ref_mask).to(dev)
        z_slice, y_slice, x_slice = find_lir(mask.cpu().numpy())
        if verbose:
            print(f"Cropping to region z={z_slice.start}:{z_slice.stop}, "
                  f"y={y_slice.start}:{y_slice.stop}, x={x_slice.start}:{x_slice.stop}")
        offset = np.asarray([s.start for s in (z_slice, y_slice, x_slice)], dtype=np.float32)
        ref_zyx = ref_zyx[z_slice, y_slice, x_slice]
        mov_channels = [c[z_slice, y_slice, x_slice] for c in mov_channels]

    if clip:
        ref_zyx = ref_zyx.clamp(0, 0.5)
        mov_channels = [c.clamp(110, float(np.quantile(c.cpu().numpy(), 0.99)))
                        for c in mov_channels]
    if sobel_filter:
        ref_zyx = torch.from_numpy(sobel_magnitude(ref_zyx.cpu().numpy())).to(dev)
        mov_channels = [torch.from_numpy(sobel_magnitude(c.cpu().numpy())).to(dev)
                        for c in mov_channels]

    mov_zyx = mov_channels[0]
    for c in mov_channels[1:]:
        mov_zyx = mov_zyx + c
    return ref_zyx.contiguous(), mov_zyx.contiguous(), offset


def postprocess_transform(
    initial_transform: np.ndarray,
    fwd_transform: np.ndarray,
    preprocess_offset: np.ndarray,
) -> np.ndarray:
    """composed = initial @ shift_to_roi @ fwd @ shift_back (crop-aware)."""
    shift_to_roi = np.eye(4)
    shift_to_roi[:3, -1] = preprocess_offset
    shift_back = np.eye(4)
    shift_back[:3, -1] = -preprocess_offset
    return (
        np.asarray(initial_transform)
        @ shift_to_roi
        @ np.asarray(fwd_transform)
        @ shift_back
    )


def estimate_czyx(
    mov_czyx,
    ref_czyx,
    initial_tform,
    mov_channel_index: int | list = 0,
    ref_channel_index: int = 0,
    crop: bool = False,
    ref_mask_radius: float | None = None,
    clip: bool = False,
    sobel_filter: bool = False,
    verbose: bool = False,
    t_idx: int = 0,
    output_folder_path=None,
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """Preprocess, optimize, and compose the registration of one CZYX pair
    -> the float64 4x4 output->input warp of the moving volume; saved as
    ``<t_idx>.npy`` in ``output_folder_path`` when given."""
    ref_zyx, mov_zyx, offset = preprocess_czyx(
        mov_czyx, ref_czyx, initial_tform, mov_channel_index, ref_channel_index, crop=crop,
        ref_mask_radius=ref_mask_radius, clip=clip, sobel_filter=sobel_filter,
        verbose=verbose, device=device)
    fwd, _ = estimate(ref_zyx, mov_zyx, verbose=verbose, device=device)
    composed = postprocess_transform(np.asarray(initial_tform), fwd, offset)
    if verbose:
        print(f"Composed transform:\n{composed}")
    if output_folder_path:
        output_folder_path = Path(output_folder_path)
        output_folder_path.mkdir(parents=True, exist_ok=True)
        np.save(output_folder_path / f"{t_idx}.npy", composed)
    return composed


def estimate_tczyx(
    mov_tczyx,
    ref_tczyx,
    mov_channel_index: int | list,
    ref_channel_index: int,
    ants_registration_settings: dict | None = None,
    affine_transform_settings: dict | None = None,
    verbose: bool = False,
    output_folder_path=None,
    device: str | torch.device = "cuda",
) -> list:
    """Per-timepoint intensity registration over a (T, C, Z, Y, X) stack
    (numpy or a tensor) -> one 4x4 nested list per timepoint. Settings are
    the reference models' dicts (``AntsRegistrationSettings``,
    ``AffineTransformSettings``); with ``use_prev_t_transform`` each result
    seeds the next timepoint. With ``output_folder_path`` each result is
    saved as ``xyz_transforms/<t>.npy`` there."""
    sobel = bool((ants_registration_settings or {}).get("sobel_filter", False))
    ats = affine_transform_settings_from_reference(affine_transform_settings)
    initial = np.asarray(ats["approx_transform"])
    transforms = []
    for t in range(mov_tczyx.shape[0]):
        if verbose:
            print(f"Registering timepoint {t}")
        composed = estimate_czyx(
            mov_tczyx[t], ref_tczyx[t], initial, mov_channel_index, ref_channel_index,
            sobel_filter=sobel, verbose=verbose, t_idx=t,
            output_folder_path=(Path(output_folder_path) / "xyz_transforms"
                                if output_folder_path else None), device=device)
        transforms.append(composed.tolist())
        if ats["use_prev_t_transform"]:
            initial = composed
    return transforms
