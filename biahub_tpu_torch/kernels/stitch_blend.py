"""The stitch verb's blend of one output chunk, in PyTorch on a device.

Counterpart of ``biahub_tpu/kernels/stitch_blend.py`` (:35-102): each
contributing FOV's weight map is a window of the FOV edge-distance map,
zero-padded by the chunk extent on every side, at the FOV's offset, so
voxels outside the FOV read the padding (weight 0). The maps are raised to
the blending exponent (0: the FOV's mask, 1: the distance itself), divided
by their sum over FOVs plus 1e-8, and the float32 sum over FOVs of weight
times data is one ``einsum``. The reference's blend is one ``jax.jit``
program of ``dynamic_slice``, power, normalise and ``einsum``, not a
Pallas kernel, so its port is these PyTorch operations on the caller's
device; the stitch verb puts the padded map on the card once per well and
sends each chunk's stack of reads there.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["blend_chunk", "pad_distance_map"]


def pad_distance_map(centered_distance, chunk_extent, device: str | torch.device) -> torch.Tensor:
    """The (Z, Y, X) FOV distance map as float32 on ``device``, zero-padded
    by ``chunk_extent`` (cz, cy, cx) on both sides of each axis, so that any
    chunk-to-FOV offset is a window inside it."""
    cz, cy, cx = (int(c) for c in chunk_extent)
    dist = torch.from_numpy(np.ascontiguousarray(centered_distance, np.float32)).to(device)
    return torch.nn.functional.pad(dist, (cx, cx, cy, cy, cz, cz))


def blend_chunk(padded_distance: torch.Tensor, fov_offsets, data_stack,
                blending_exponent: float = 1.0, pad_extent=None) -> torch.Tensor:
    """The blended (T, C, cz, cy, cx) float32 chunk on ``padded_distance``'s
    device.

    ``padded_distance``: a :func:`pad_distance_map` result (padded by
    ``pad_extent``, default this chunk's extent; edge chunks, smaller than
    the nominal chunk, reuse the map padded by the nominal extent).
    ``fov_offsets``: (n, 3) ints, each FOV's ``moving.start - fixed.start``
    of ``stitch.overlap_slices``: the chunk-to-FOV index shift, so the
    windows place fractional corners as the host route's scatter does.
    ``data_stack``: (n, T, C, cz, cy, cx), each FOV's overlap read in its
    box of the chunk and zeros elsewhere (numpy or a tensor; moved to the
    map's device)."""
    dev = padded_distance.device
    stack = data_stack if isinstance(data_stack, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(data_stack, np.float32))
    stack = stack.to(dev, torch.float32)
    cz, cy, cx = (int(s) for s in stack.shape[-3:])
    pad = np.asarray(pad_extent if pad_extent is not None else (cz, cy, cx), np.int64)
    offsets = np.asarray(fov_offsets, np.int64).reshape(-1, 3) + pad
    maps = torch.stack([padded_distance[oz:oz + cz, oy:oy + cy, ox:ox + cx]
                        for oz, oy, ox in offsets.tolist()])
    exponent = float(blending_exponent)
    if exponent == 1.0:
        w = maps
    elif exponent == 0.0:
        w = (maps > 0).to(torch.float32)
    else:
        w = torch.where(maps > 0, maps.pow(exponent), torch.zeros((), device=dev))
    w = w / (w.sum(dim=0, keepdim=True) + 1e-8)
    return torch.einsum("nzyx,ntczyx->tczyx", w, stack)
