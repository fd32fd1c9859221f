"""The tracking engine of the track verb (:mod:`biahub_tpu_torch.tracking.
engine`), on the host as in the reference."""

from biahub_tpu_torch.tracking.engine import (
    link_labels,
    segment_foreground_contour,
    track_from_foreground_contour,
    track_from_labels,
)

__all__ = [
    "link_labels",
    "segment_foreground_contour",
    "track_from_foreground_contour",
    "track_from_labels",
]
