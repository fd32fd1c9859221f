"""Largest interior rectangle of a binary mask.

Counterpart of ``biahub_tpu/transforms/lir.py:15`` (which replaces the
``largestinteriorrectangle`` dependency of the reference's overlap crop):
the histogram-stack algorithm, O(H*W), on the host.
:func:`largest_interior_rectangle` runs the compiled helper
(:func:`biahub_tpu_torch._native.lir_2d`); :func:`largest_interior_rectangle_plain`
is the same loop in Python, its plain version. Both keep the first
rectangle of the largest area in row-major scan order (a strict ``>`` on
the area), as the reference's helper and loop do.
"""

from __future__ import annotations

import numpy as np

from biahub_tpu_torch._native import lir_2d

__all__ = ["largest_interior_rectangle", "largest_interior_rectangle_plain", "lir"]


def largest_interior_rectangle(mask: np.ndarray) -> tuple[int, int, int, int]:
    """Largest axis-aligned all-True rectangle of a 2D boolean mask.

    Returns (x, y, width, height) with x = column of the left edge and
    y = row of the top edge — the same convention as ``lir.lir``.
    """
    return lir_2d(np.asarray(mask, dtype=bool))


def largest_interior_rectangle_plain(mask: np.ndarray) -> tuple[int, int, int, int]:
    """:func:`largest_interior_rectangle` as a loop on Python ints."""
    mask = np.asarray(mask, dtype=bool)
    h, w = mask.shape
    best_area = 0
    best = (0, 0, 0, 0)
    heights = np.zeros(w, dtype=np.int64)
    for row in range(h):
        heights = np.where(mask[row], heights + 1, 0)
        hs = heights.tolist() + [0]
        # Largest rectangle in the histogram via a monotonic stack
        stack: list[int] = []
        col = 0
        while col <= w:
            if not stack or hs[col] >= hs[stack[-1]]:
                stack.append(col)
                col += 1
            else:
                top = stack.pop()
                width = col if not stack else col - stack[-1] - 1
                area = hs[top] * width
                if area > best_area:
                    best_area = area
                    left = 0 if not stack else stack[-1] + 1
                    best = (left, row - hs[top] + 1, width, hs[top])
    return best


# Alias matching the lir package's entry point
lir = largest_interior_rectangle
