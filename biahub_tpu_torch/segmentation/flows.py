"""Cellpose-style flow dynamics: masks -> flows, flow following, flows -> masks.

Counterpart of ``biahub_tpu/segmentation/flows.py``. The host steps are the
reference's NumPy/SciPy code as it is (:func:`masks_to_flows`,
:func:`get_masks`, :func:`_fill_holes_and_filter`, :func:`flow_error`);
the Euler integration, :func:`follow_flows`, runs on the tensors' device
(the reference pins it to its host CPU, which beats the TPU's minor-axis
gathers; on the card the gathers belong on the card). It moves every
foreground pixel of every z slice of a volume in one loop of ``niter``
steps, each an order-1 interpolation of the flow field exactly as
``jax.scipy.ndimage.map_coordinates(order=1)`` computes it (its weights, its
products and its sum in its order, and a neighbour past the last row or
column contributing 0), then clipped to the frame. Background pixels do not
move, so only the foreground is integrated. :func:`compute_masks_zyx` is
the whole postprocess of a volume: threshold the cell probability, follow
the flows of all slices at once, then per slice cluster the converged
positions, drop labels whose flows disagree (``flow_threshold``), drop
small masks and fill holes. The network emits ``5 * flow``, so steps use
``dP / 5``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["masks_to_flows", "follow_flows", "get_masks", "flow_error", "compute_masks",
           "compute_masks_zyx"]


def masks_to_flows(masks: np.ndarray) -> np.ndarray:
    """Flows (2, H, W) from an instance label image by center heat diffusion.

    For each label: diffuse heat from the cell's median pixel inside its
    bounding box (n_iter ~ 2x its diameter), take the gradient of
    ``log(1 + T)``, and L2-normalise per pixel. Background flow is zero.
    """
    from scipy import ndimage

    masks = np.asarray(masks)
    H, W = masks.shape
    flows = np.zeros((2, H, W), np.float32)
    slices = ndimage.find_objects(masks)
    for label, slc in enumerate(slices, start=1):
        if slc is None:
            continue
        sy, sx = slc
        h, w = sy.stop - sy.start + 2, sx.stop - sx.start + 2
        inside = np.zeros((h, w), bool)
        inside[1:-1, 1:-1] = masks[sy, sx] == label
        ys, xs = np.nonzero(inside)
        if len(ys) == 0:
            continue
        my, mx = int(np.median(ys)), int(np.median(xs))
        # snap the seed onto the mask if the median fell outside it
        if not inside[my, mx]:
            k = np.argmin((ys - my) ** 2 + (xs - mx) ** 2)
            my, mx = int(ys[k]), int(xs[k])
        T = np.zeros((h, w), np.float64)
        n_iter = 2 * int(np.ptp(ys) + np.ptp(xs)) + 5
        for _ in range(n_iter):
            T[my, mx] += 1.0
            T = ndimage.uniform_filter(T, size=3, mode="constant")
            T *= inside
        T = np.log1p(T)
        dy = (np.roll(T, -1, axis=0) - np.roll(T, 1, axis=0)) / 2.0
        dx = (np.roll(T, -1, axis=1) - np.roll(T, 1, axis=1)) / 2.0
        norm = np.sqrt(dy**2 + dx**2) + 1e-20
        flows[0, sy, sx][inside[1:-1, 1:-1]] = (dy / norm)[inside].astype(np.float32)
        flows[1, sy, sx][inside[1:-1, 1:-1]] = (dx / norm)[inside].astype(np.float32)
    return flows


def follow_flows(dP: torch.Tensor, foreground: torch.Tensor, niter: int = 200) -> torch.Tensor:
    """Integrate pixel positions along a flow field, on ``dP``'s device.

    ``dP``: (2, H, W) or (Z, 2, H, W) flows (already divided by the
    network's 5x scaling and masked to the foreground); ``foreground``:
    (H, W) or (Z, H, W) bool, the pixels to move. Returns the final float32
    positions, (2, H, W) or (Z, 2, H, W): (y, x) of every pixel, background
    pixels at their own coordinates.
    """
    single = dP.dim() == 3
    if single:
        dP, foreground = dP[None], foreground[None]
    Z, _, H, W = dP.shape
    dev = dP.device
    flat = dP.to(torch.float32).contiguous().reshape(-1)
    grid = torch.stack(torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                                      torch.arange(W, dtype=torch.float32, device=dev),
                                      indexing="ij")).expand(Z, 2, H, W).contiguous()
    idx = torch.nonzero(foreground.reshape(-1).to(dev)).squeeze(1)
    if idx.numel():
        z, rem = idx // (H * W), idx % (H * W)
        base = z * (2 * H * W)
        py = (rem // W).to(torch.float32)
        px = (rem % W).to(torch.float32)
        one = torch.ones((), dtype=torch.float32, device=dev)
        y_max = torch.full((), H - 1.0, dtype=torch.float32, device=dev)
        x_max = torch.full((), W - 1.0, dtype=torch.float32, device=dev)
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        for _ in range(niter):
            fy, fx = torch.floor(py), torch.floor(px)
            wy1, wx1 = py - fy, px - fx
            wy0, wx0 = one - wy1, one - wx1
            iy, ix = fy.to(torch.int64), fx.to(torch.int64)
            ok_y, ok_x = iy + 1 < H, ix + 1 < W
            row0 = base + iy * W
            row1 = base + torch.where(ok_y, iy + 1, iy) * W
            ix1 = torch.where(ok_x, ix + 1, ix)
            corners = ((row0 + ix, None, wy0 * wx0), (row0 + ix1, ok_x, wy0 * wx1),
                       (row1 + ix, ok_y, wy1 * wx0), (row1 + ix1, ok_y & ok_x, wy1 * wx1))
            v = []
            for channel in (0, H * W):
                acc = None
                for pos, ok, weight in corners:
                    val = flat[pos + channel]
                    if ok is not None:
                        val = torch.where(ok, val, zero)
                    term = weight * val
                    acc = term if acc is None else acc + term
                v.append(acc)
            py = torch.minimum(torch.maximum(py + v[0], zero), y_max)
            px = torch.minimum(torch.maximum(px + v[1], zero), x_max)
        pos = grid.reshape(-1)
        pos[base + rem] = py
        pos[base + H * W + rem] = px
    return grid[0] if single else grid


def get_masks(
    p: np.ndarray,
    foreground: np.ndarray,
    h_seed_min: float = 10.0,
    grow_iters: int = 5,
) -> np.ndarray:
    """Cluster converged pixel positions into instance labels.

    Histogram the final positions of foreground pixels; seeds are local
    maxima of the arrival density with at least ``h_seed_min`` arrivals
    (scaled down for small images); seed regions grow ``grow_iters`` times
    into neighbouring bins holding >2 arrivals; each foreground pixel takes
    the label its converged position lands on.
    """
    from scipy import ndimage

    foreground = np.asarray(foreground, bool)
    H, W = foreground.shape
    py = np.clip(np.round(np.asarray(p[0])), 0, H - 1).astype(np.int64)
    px = np.clip(np.round(np.asarray(p[1])), 0, W - 1).astype(np.int64)
    ys, xs = np.nonzero(foreground)
    if len(ys) == 0:
        return np.zeros((H, W), np.uint32)
    fy, fx = py[ys, xs], px[ys, xs]
    h = np.zeros((H, W), np.float32)
    np.add.at(h, (fy, fx), 1.0)
    seed_min = min(h_seed_min, max(2.0, 0.1 * float(h.max())))
    hmax = ndimage.maximum_filter(h, size=5)
    seed_mask = (h >= hmax) & (h > seed_min)
    labels, n = ndimage.label(seed_mask, structure=np.ones((3, 3)))
    if n == 0:
        return np.zeros((H, W), np.uint32)
    dense = h > 2.0
    for _ in range(grow_iters):
        grown = ndimage.maximum_filter(labels, size=3)
        labels = np.where((labels == 0) & dense, grown, labels)
    masks = np.zeros((H, W), np.uint32)
    masks[ys, xs] = labels[fy, fx]
    return masks


def _fill_holes_and_filter(
    masks: np.ndarray, min_size: int = 15
) -> np.ndarray:
    """Fill holes per label, drop labels below ``min_size``, renumber 1..N."""
    from scipy import ndimage

    out = np.zeros_like(masks, dtype=np.uint32)
    next_label = 1
    for label, slc in enumerate(ndimage.find_objects(masks), start=1):
        if slc is None:
            continue
        region = masks[slc] == label
        if region.sum() < min_size:
            continue
        region = ndimage.binary_fill_holes(region)
        out[slc][region] = next_label
        next_label += 1
    return out


def flow_error(masks: np.ndarray, dP_net: np.ndarray) -> np.ndarray:
    """Per-label MSE between network flows and flows recomputed from masks.

    ``dP_net`` is the raw network output (5x-scaled). Matches cellpose's QC
    metric: labels whose shape is inconsistent with the predicted flow field
    score high and get dropped by ``flow_threshold``.
    """
    from scipy import ndimage

    n = int(masks.max())
    if n == 0:
        return np.zeros(0, np.float32)
    dP_masks = masks_to_flows(masks)
    err2 = ((dP_masks - np.asarray(dP_net, np.float32) / 5.0) ** 2).sum(axis=0)
    sums = ndimage.sum_labels(err2, labels=masks, index=np.arange(1, n + 1))
    counts = ndimage.sum_labels(
        np.ones_like(err2), labels=masks, index=np.arange(1, n + 1)
    )
    return (sums / np.maximum(counts, 1)).astype(np.float32)


def compute_masks_zyx(dP, cellprob, cellprob_threshold: float = 0.0,
                      flow_threshold: float | None = 0.4, min_size: int = 15,
                      niter: int = 200) -> np.ndarray:
    """Network output of a volume, flows (Z, 2, H, W) and cell probability
    (Z, H, W) as tensors, -> instance labels (Z, H, W) uint32. The flows of
    all slices are followed at once on the tensors' device; the rest runs
    per slice on the host, as the reference's ``compute_masks``."""
    dP = torch.as_tensor(dP, dtype=torch.float32)
    cellprob = torch.as_tensor(cellprob, dtype=torch.float32, device=dP.device)
    foreground = cellprob > cellprob_threshold
    fg_host = foreground.cpu().numpy()
    dP_host = dP.cpu().numpy()
    masks = np.zeros(fg_host.shape, np.uint32)
    if not fg_host.any():
        return masks
    # A tensor divisor: a scalar one is a multiply by its reciprocal on CUDA.
    five = torch.full((), 5.0, dtype=torch.float32, device=dP.device)
    p = follow_flows((dP / five) * foreground[:, None], foreground, niter=niter).cpu().numpy()
    for z in range(fg_host.shape[0]):
        if not fg_host[z].any():
            continue
        m = get_masks(p[z], fg_host[z])
        if flow_threshold is not None and m.max() > 0:
            errors = flow_error(m, dP_host[z])
            bad = np.nonzero(errors > flow_threshold)[0] + 1
            if len(bad):
                m[np.isin(m, bad)] = 0
        masks[z] = _fill_holes_and_filter(m, min_size=min_size)
    return masks


def compute_masks(dP, cellprob, cellprob_threshold: float = 0.0,
                  flow_threshold: float | None = 0.4, min_size: int = 15,
                  niter: int = 200) -> np.ndarray:
    """Network output of one slice (flows 2xHxW + cellprob HxW) ->
    instance labels HxW (:func:`compute_masks_zyx` of one slice)."""
    dP = torch.as_tensor(dP, dtype=torch.float32)
    cellprob = torch.as_tensor(cellprob, dtype=torch.float32, device=dP.device)
    return compute_masks_zyx(dP[None], cellprob[None], cellprob_threshold, flow_threshold,
                             min_size, niter)[0]
