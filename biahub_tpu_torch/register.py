"""The register verb's helpers the ported paths use.

Counterpart of ``biahub_tpu/register.py:138-163`` (``find_lir``). The rest
of the register verb (plates, the CLI) waits for the I/O layer (ROADMAP
queue 1).
"""

from __future__ import annotations

import numpy as np

from biahub_tpu_torch.transforms.lir import largest_interior_rectangle

__all__ = ["find_lir"]


def find_lir(registered_zyx: np.ndarray) -> tuple[slice, slice, slice]:
    """ZYX slices of the largest interior rectangle of a boolean volume: the
    LIR of the central YX plane, then the Z window common to the LIRs of
    probe ZY and ZX planes at its first, middle and last column and row
    (the reference's search, biahub/register.py:287-345)."""
    registered_zyx = np.asarray(registered_zyx, dtype=bool)

    registered_yx = registered_zyx[registered_zyx.shape[0] // 2]
    x, y, width, height = largest_interior_rectangle(registered_yx)
    x_start, x_stop = x, x + width
    y_start, y_stop = y, y + height
    x_slice = slice(x_start, x_stop)
    y_slice = slice(y_start, y_stop)

    coords = []
    for _x in (x_start, x_start + (x_stop - x_start) // 2, x_stop - 1):
        _, z, _, depth = largest_interior_rectangle(registered_zyx[:, y_slice, _x])
        coords.append((z, z + depth))
    for _y in (y_start, y_start + (y_stop - y_start) // 2, y_stop - 1):
        _, z, _, depth = largest_interior_rectangle(registered_zyx[:, _y, x_slice])
        coords.append((z, z + depth))

    coords = np.asarray(coords)
    z_slice = slice(int(coords.max(axis=0)[0]), int(coords.min(axis=0)[1]))
    return (z_slice, y_slice, x_slice)
