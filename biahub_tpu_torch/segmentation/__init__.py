"""The segment verb's CPnet engine (:mod:`biahub_tpu_torch.segmentation.
engine`) and flow dynamics (:mod:`biahub_tpu_torch.segmentation.flows`)."""

from biahub_tpu_torch.segmentation.engine import cpnet_segment_czyx
from biahub_tpu_torch.segmentation.flows import (
    compute_masks,
    compute_masks_zyx,
    follow_flows,
    get_masks,
    masks_to_flows,
)

__all__ = [
    "cpnet_segment_czyx",
    "compute_masks",
    "compute_masks_zyx",
    "follow_flows",
    "get_masks",
    "masks_to_flows",
]
