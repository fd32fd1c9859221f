"""Immutable homogeneous Transform for 2D/3D ZYX volumes.

Counterpart of ``biahub_tpu/transforms/transform.py:18-173``, the same API:
the matrix maps INPUT points to OUTPUT points (forward); :meth:`Transform.
apply` resamples a volume with the inverse matrix through
:func:`~biahub_tpu_torch.kernels.affine.affine_warp_auto` (in-plane matrices
on kernels E and F, general ones on the multipass warp, kernel H), on the
card unless ``device="cpu"`` is given.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

__all__ = ["Transform"]


class Transform:
    """An immutable 2D (3x3) or 3D (4x4) homogeneous transform in ZYX order."""

    def __init__(self, matrix, transform_type: str = "affine"):
        matrix = np.asarray(matrix, dtype=np.float64)
        if matrix.shape not in ((3, 3), (4, 4)):
            raise ValueError(
                f"Transform matrix must be 3x3 or 4x4, got {matrix.shape}"
            )
        bottom = np.zeros(matrix.shape[1])
        bottom[-1] = 1.0
        if not np.allclose(matrix[-1], bottom):
            raise ValueError("Last row of a homogeneous matrix must be [0, ..., 0, 1]")
        self._matrix = matrix.copy()
        self._matrix.setflags(write=False)
        self._transform_type = transform_type

    # -- properties ----------------------------------------------------------

    @property
    def matrix(self) -> np.ndarray:
        return self._matrix

    @property
    def ndim(self) -> int:
        return self._matrix.shape[0] - 1

    @property
    def transform_type(self) -> str:
        return self._transform_type

    @property
    def translation(self) -> np.ndarray:
        return self._matrix[: self.ndim, -1]

    @property
    def linear(self) -> np.ndarray:
        return self._matrix[: self.ndim, : self.ndim]

    @property
    def is_identity(self) -> bool:
        return np.allclose(self._matrix, np.eye(self.ndim + 1))

    # -- constructors ----------------------------------------------------------

    @classmethod
    def identity(cls, ndim: int = 3) -> "Transform":
        return cls(np.eye(ndim + 1), transform_type="identity")

    @classmethod
    def from_translation(cls, offset: Sequence[float]) -> "Transform":
        offset = np.asarray(offset, dtype=np.float64)
        out = np.eye(len(offset) + 1)
        out[:-1, -1] = offset
        return cls(out, transform_type="translation")

    @classmethod
    def from_fit(
        cls, src_points: np.ndarray, dst_points: np.ndarray, transform_type: str = "euclidean"
    ) -> "Transform":
        """Least-squares fit from matched (N, D) point sets (ZYX order)."""
        from biahub_tpu_torch.transforms.fitting import fit_transform

        return cls(fit_transform(src_points, dst_points, transform_type), transform_type)

    @classmethod
    def from_skimage(cls, skimage_transform) -> "Transform":
        """Wrap any object exposing skimage's ``.params`` matrix attribute."""
        name = type(skimage_transform).__name__.lower()
        for t in ("euclidean", "similarity", "affine"):
            if t in name:
                transform_type = t
                break
        else:
            transform_type = "affine"
        return cls(np.asarray(skimage_transform.params), transform_type)

    # -- algebra ----------------------------------------------------------------

    def invert(self) -> "Transform":
        return Transform(np.linalg.inv(self._matrix), self._transform_type)

    def compose(self, other: "Transform") -> "Transform":
        """self @ other: apply ``other`` first, then ``self``."""
        if self.ndim != other.ndim:
            raise ValueError("Cannot compose transforms of different dimensionality")
        t = (
            self._transform_type
            if self._transform_type == other._transform_type
            else "affine"
        )
        return Transform(self._matrix @ other._matrix, t)

    def __matmul__(self, other: "Transform") -> "Transform":
        return self.compose(other)

    # -- application ----------------------------------------------------------

    def apply_points(self, points: np.ndarray) -> np.ndarray:
        """Map (N, D) points forward through the transform."""
        points = np.asarray(points, dtype=np.float64)
        squeeze = points.ndim == 1
        if squeeze:
            points = points[None]
        homogeneous = np.hstack([points, np.ones((points.shape[0], 1))])
        out = (self._matrix @ homogeneous.T).T[:, : self.ndim]
        return out[0] if squeeze else out

    def apply(
        self,
        volume,
        output_shape: tuple[int, ...] | None = None,
        order: int = 1,
        fill: float = 0.0,
        device: str | torch.device = "cuda",
    ) -> torch.Tensor:
        """Resample a (Z, Y, X) volume (numpy or a tensor): out[o] =
        volume[inverse(matrix) @ o], a float32 tensor on ``device``."""
        from biahub_tpu_torch.kernels.affine import affine_warp_auto

        if self.ndim != 3:
            raise NotImplementedError("Image application is 3D-only")
        out_shape = tuple(output_shape or volume.shape)
        inv = np.linalg.inv(self._matrix)
        return affine_warp_auto(volume, inv, out_shape, fill=fill, order=order, device=device)

    # -- serialization ----------------------------------------------------------

    def to_list(self) -> list[list[float]]:
        return self._matrix.tolist()

    @classmethod
    def from_list(cls, data: list, transform_type: str = "affine") -> "Transform":
        return cls(np.asarray(data), transform_type)

    def to_dict(self) -> dict:
        return {
            "matrix": self.to_list(),
            "transform_type": self._transform_type,
        }

    @classmethod
    def from_dict(cls, data: dict) -> "Transform":
        return cls(np.asarray(data["matrix"]), data.get("transform_type", "affine"))

    # -- dunder ----------------------------------------------------------------

    def __repr__(self) -> str:
        return f"Transform(ndim={self.ndim}, type={self._transform_type})"

    def __str__(self) -> str:
        return f"{self.__repr__()}\n{self._matrix}"

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Transform) and np.allclose(self._matrix, other._matrix)

    def __hash__(self) -> int:
        return hash(self._matrix.tobytes())
