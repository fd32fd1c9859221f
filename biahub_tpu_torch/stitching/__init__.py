"""Tile stitching: pairwise PCC shifts and the global position solve.

Counterpart of ``biahub_tpu/stitching``: grid adjacency from ``RRRCCC``
FOV names, Hanning-windowed phase correlation of overlap strips (the
correlation with ``torch.fft`` on the verb's device), peak-isolation
confidence, and a robust least-squares position solve per axis on the
host.
"""

from biahub_tpu_torch.stitching.tile import (
    optimal_positions,
    pairwise_shifts,
    parse_grid_coords,
    register_translation_nd,
)

__all__ = [
    "optimal_positions",
    "pairwise_shifts",
    "parse_grid_coords",
    "register_translation_nd",
]
