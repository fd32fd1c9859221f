"""CPnet inference engine: CZYX volume -> instance label ZYX volume.

Counterpart of ``biahub_tpu/segmentation/engine.py``: the cellpose channel
assembly (``channels=[chan, chan2]``, 1-based into C; 0 = the channels'
mean, or a zero second channel) and the per-plane 1-99 percentile
normalisation run on the host in NumPy as the reference runs them; then on
the device the diameter rescale (:func:`resize_linear`, the reference's
``jax.image.resize(method="linear")``: half-pixel centres, a triangle
kernel widened when shrinking), the edge pad to a multiple of 16, the CPnet
in z chunks sized by ``BIAHUB_TPU_MAX_BATCH_BYTES`` (each chunk edge-padded
to one size), the resize back, and the flow following of all slices at
once (:func:`~biahub_tpu_torch.segmentation.flows.compute_masks_zyx`,
``niter`` scaled by the rescale as the reference's ``eff_niter``).
Optional IoU stitching of per-slice labels into 3D objects
(:func:`stitch_labels_3d`, ``stitch_threshold``) is the reference's.
"""

from __future__ import annotations

import os
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from biahub_tpu_torch.device import resolve_device
from biahub_tpu_torch.models import model_precision
from biahub_tpu_torch.runtime.executor import DEFAULT_MAX_BATCH_BYTES
from biahub_tpu_torch.segmentation.flows import compute_masks_zyx

__all__ = ["cpnet_segment_czyx", "stitch_labels_3d", "resize_linear", "load_engine"]


@lru_cache(maxsize=4)
def load_engine(checkpoint_path: str, device: str):
    """(CPnet on ``device``, config) of a cellpose-schema checkpoint; cached
    per path and device, as the reference caches its engine."""
    from biahub_tpu_torch.models.convert import load_cpnet_checkpoint, load_into
    from biahub_tpu_torch.models.cpnet import CPnet

    state_dict, config = load_cpnet_checkpoint(checkpoint_path)
    net = load_into(CPnet(**config), state_dict).to(torch.device(device)).eval()
    return net, config


def _resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) float32 weights of ``jax.image.resize``'s linear
    kernel with antialiasing, computed in float32 as it computes them."""
    f32 = np.float32
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = f32(max(inv_scale, 1.0))
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * f32(inv_scale) - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    weights = np.maximum(f32(0), f32(1) - np.abs(x))
    total = np.sum(weights, axis=0, keepdims=True)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], weights, f32(0)).astype(f32)


def resize_linear(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """(..., H, W) -> (..., size[0], size[1]) on ``x``'s device, as
    ``jax.image.resize(x, ..., method="linear")`` (antialiased when it
    shrinks); an axis of unchanged length is left as it is."""
    h, w = x.shape[-2:]
    if size[0] != h:
        wy = torch.from_numpy(_resize_weights(h, size[0])).to(x.device)
        x = torch.einsum("...hw,hi->...iw", x, wy)
    if size[1] != w:
        wx = torch.from_numpy(_resize_weights(w, size[1])).to(x.device)
        x = torch.einsum("...hw,wj->...hj", x, wx)
    return x


def _assemble_channels(
    czyx: np.ndarray, channels: tuple[int, int], nchan: int
) -> np.ndarray:
    """(C, Z, Y, X) -> (Z, nchan, Y, X) under cellpose channel semantics."""
    c1, c2 = channels
    chan1 = czyx.mean(axis=0) if c1 == 0 else czyx[c1 - 1]
    planes = [chan1]
    if nchan > 1:
        chan2 = np.zeros_like(chan1) if c2 == 0 else czyx[c2 - 1]
        planes.append(chan2)
    while len(planes) < nchan:
        planes.append(np.zeros_like(chan1))
    return np.stack(planes, axis=1).astype(np.float32)  # (Z, nchan, Y, X)


def _normalize(x: np.ndarray) -> np.ndarray:
    """Per-plane per-channel 1-99 percentile normalisation.

    cellpose's eval path normalises each 2D plane independently (its
    ``normalize_img`` runs per image in the slice loop), so a stack with
    depth attenuation keeps deep planes at full contrast instead of being
    squashed by bright shallow planes' pooled percentiles. The flip side —
    shared with cellpose itself — is that signal-free planes get their
    noise stretched to full contrast; cellprob_threshold is the defense.
    """
    lo = np.percentile(x, 1.0, axis=(2, 3), keepdims=True)
    hi = np.percentile(x, 99.0, axis=(2, 3), keepdims=True)
    return (x - lo) / np.maximum(hi - lo, 1e-6)


def stitch_labels_3d(labels_zyx: np.ndarray, stitch_threshold: float) -> np.ndarray:
    """Chain per-slice 2D labels into 3D objects by IoU >= threshold.

    One pass per slice pair: the (prev, cur) joint histogram comes from a
    single ``bincount`` over combined indices and the remap is a LUT gather,
    so cost is O(H*W + n_labels) per slice instead of per-label image scans.
    """
    out = np.asarray(labels_zyx).astype(np.uint32).copy()
    next_label = int(out[0].max()) + 1
    for z in range(1, out.shape[0]):
        prev, cur = out[z - 1], out[z]
        n_cur = int(cur.max())
        if n_cur == 0:
            continue
        cur_sizes = np.bincount(cur.ravel(), minlength=n_cur + 1)
        prev_sizes = np.bincount(prev.ravel())
        # Joint histogram restricted to overlapping foreground pixels.
        # Densify prev's (global, ever-growing) label ids first so the
        # combined index stays O(n_prev_local * n_cur), not O(max_label).
        both = (cur > 0) & (prev > 0)
        prev_local, prev_dense = np.unique(prev[both], return_inverse=True)
        pair = prev_dense.astype(np.int64) * (n_cur + 1) + cur[both]
        counts = np.bincount(pair, minlength=len(prev_local) * (n_cur + 1))
        inter = np.zeros(n_cur + 1, np.int64)
        best_prev = np.zeros(n_cur + 1, np.int64)
        if counts.size:
            nz = np.nonzero(counts)[0]
            prev_ids = prev_local[nz // (n_cur + 1)]
            cur_ids = nz % (n_cur + 1)
            order = np.argsort(counts[nz], kind="stable")
            # Last write wins -> the argmax-overlap previous label per cur.
            inter[cur_ids[order]] = counts[nz][order]
            best_prev[cur_ids[order]] = prev_ids[order]
        union = cur_sizes + np.where(
            best_prev > 0, prev_sizes[best_prev], 0
        ) - inter
        iou = np.where(union > 0, inter / np.maximum(union, 1), 0.0)
        keep = (best_prev > 0) & (iou >= stitch_threshold)
        lut = np.zeros(n_cur + 1, dtype=out.dtype)
        lut[keep] = best_prev[keep]
        fresh = np.nonzero(~keep)[0]
        fresh = fresh[fresh > 0]
        lut[fresh] = np.arange(next_label, next_label + len(fresh), dtype=out.dtype)
        next_label += len(fresh)
        out[z] = lut[cur]
    return out


def _apply_z_chunked(net, x: torch.Tensor, base_channels: int) -> torch.Tensor:
    """The network over Z in budgeted chunks of one size: the per-slice
    footprint is about 8 level-0 feature planes of ``base_channels`` float32
    (``BIAHUB_TPU_MAX_BATCH_BYTES``), and the last chunk is edge-padded."""
    Z = x.shape[0]
    budget = int(os.environ.get("BIAHUB_TPU_MAX_BATCH_BYTES", DEFAULT_MAX_BATCH_BYTES))
    per_slice = x.shape[2] * x.shape[3] * 4 * max(base_channels, 1) * 8
    z_chunk = int(min(Z, max(1, budget // max(per_slice, 1))))
    outs = []
    for z0 in range(0, Z, z_chunk):
        chunk = x[z0:z0 + z_chunk]
        pad_z = z_chunk - chunk.shape[0]
        if pad_z:
            chunk = torch.cat([chunk, chunk[-1:].expand(pad_z, *chunk.shape[1:])])
        with model_precision():
            y, _style = net(chunk.contiguous())
        outs.append(y[:z_chunk - pad_z])
    return torch.cat(outs)


def cpnet_segment_czyx(
    czyx: np.ndarray,
    checkpoint_path: str,
    channels: tuple[int, int] = (0, 0),
    diameter: float | None = None,
    diam_mean: float = 30.0,
    cellprob_threshold: float = 0.0,
    flow_threshold: float | None = 0.4,
    min_size: int = 15,
    niter: int = 200,
    normalize: bool = True,
    stitch_threshold: float = 0.0,
    device="cuda",
) -> np.ndarray:
    """Segment a CZYX volume slice by slice with a CPnet checkpoint ->
    (Z, Y, X) uint32 labels."""
    dev = resolve_device(device)
    czyx = np.asarray(czyx, np.float32)
    net, config = load_engine(str(checkpoint_path), str(dev))
    nchan = int(config["nbase"][0])
    x = _assemble_channels(czyx, tuple(channels), nchan)  # (Z, nchan, Y, X)
    if normalize:
        x = _normalize(x)
    Z, _, Y, X = x.shape
    rescale = 1.0 if not diameter else float(diam_mean) / float(diameter)
    ys, xs = max(1, int(round(Y * rescale))), max(1, int(round(X * rescale)))
    x = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)
    if (ys, xs) != (Y, X):
        x = resize_linear(x, (ys, xs))
    pad_y, pad_x = (-ys) % 16, (-xs) % 16
    if pad_y or pad_x:
        x = F.pad(x, (0, pad_x, 0, pad_y), mode="replicate")
    out = _apply_z_chunked(net, x, int(config["nbase"][1]))[:, :, :ys, :xs]
    if (ys, xs) != (Y, X):
        out = resize_linear(out, (Y, X))
    # Flows resized back without magnitude rescaling: each Euler step covers
    # ~rescale native pixels, so the step count scales (cellpose's niter =
    # 200 / rescale).
    eff_niter = int(np.ceil(niter / rescale)) if rescale < 1.0 else int(niter)
    labels = compute_masks_zyx(out[:, :2], out[:, 2], cellprob_threshold=cellprob_threshold,
                               flow_threshold=flow_threshold, min_size=min_size,
                               niter=eff_niter)
    if stitch_threshold > 0 and Z > 1:
        labels = stitch_labels_3d(labels, stitch_threshold)
    return labels.astype(np.uint32)
