"""Point-set transforms of the port (counterpart of
``biahub_tpu/transforms``): the :class:`Transform` class, least-squares
fits, graph matching and the largest interior rectangle, on the host
(numpy, scipy and a compiled helper); volumes are resampled on the card."""

from biahub_tpu_torch.transforms.fitting import (
    fit_affine,
    fit_euclidean,
    fit_similarity,
    fit_transform,
)
from biahub_tpu_torch.transforms.lir import largest_interior_rectangle
from biahub_tpu_torch.transforms.transform import Transform

__all__ = [
    "Transform",
    "fit_transform",
    "fit_affine",
    "fit_euclidean",
    "fit_similarity",
    "largest_interior_rectangle",
]
