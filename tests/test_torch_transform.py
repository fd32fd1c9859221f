"""The port's ``transforms.Transform`` against biahub_tpu's.

Every constructor, property, the algebra, points, serialization and the
dunders equal the reference's exactly (the same float64 numpy). ``apply``
resamples with the inverse matrix: an in-plane matrix against the
reference's ``apply`` within 1e-5 of max|ref| (the warps' tolerance); a
general matrix against the reference's multipass warp at the same
tolerance (its CPU ``affine_warp_auto`` takes the exact gather instead;
ROADMAP, "The multipass warp against scipy").
"""

import numpy as np
import pytest
import torch

import biahub_tpu.transforms as jtransforms
from biahub_tpu.kernels.multipass_warp import multipass_affine_warp_zyx
from biahub_tpu.transforms import Transform as J
from biahub_tpu_torch import transforms as ttransforms
from biahub_tpu_torch.transforms import Transform as T

SHAPE = (10, 24, 20)


def inplane() -> np.ndarray:
    theta = np.deg2rad(4.0)
    m = np.eye(4)
    m[1:3, 1:3] = [[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]]
    m[:3, 3] = [0.5, 1.25, -0.75]
    return m


def general() -> np.ndarray:
    m = inplane()
    m[0, 2] = m[2, 0] = 0.03
    m[0, 1] = -0.02
    return m


def same(a, b) -> None:
    assert type(a).__name__ == type(b).__name__
    if isinstance(a, J):
        np.testing.assert_array_equal(a.matrix, b.matrix)
        assert a.transform_type == b.transform_type and a.ndim == b.ndim
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


class Skimage:
    """An object exposing skimage's ``params`` (a similarity by its name)."""

    def __init__(self, params):
        self.params = params


Skimage.__name__ = "SimilarityTransform"


def test_exports_equal_the_reference():
    assert ttransforms.__all__ == jtransforms.__all__


def test_constructors_properties_and_algebra_equal_the_reference():
    rng = np.random.default_rng(0)
    src = rng.random((12, 3)) * 30
    dst = src @ general()[:3, :3].T + [1.0, -2.0, 0.5]
    cases = [
        lambda m: m.identity(3), lambda m: m.identity(2),
        lambda m: m.from_translation([1.0, -2.5, 3.0]),
        lambda m: m.from_fit(src, dst, "affine"),
        lambda m: m.from_fit(src, dst),
        lambda m: m.from_fit(src[:, 1:], dst[:, 1:], "similarity"),
        lambda m: m.from_skimage(Skimage(np.eye(3))),
        lambda m: m(general(), "affine"),
        lambda m: m.from_list(inplane().tolist()),
        lambda m: m.from_dict({"matrix": inplane().tolist(), "transform_type": "euclidean"}),
    ]
    for make in cases:
        a, b = make(J), make(T)
        same(a, b)
        for name in ("translation", "linear", "is_identity", "ndim"):
            same(getattr(a, name), getattr(b, name))
        same(a.invert(), b.invert())
        assert a.to_list() == b.to_list() and a.to_dict() == b.to_dict()
        assert repr(a) == repr(b) and str(a) == str(b) and hash(a) == hash(b)
        pts = rng.random((5, a.ndim)) * 10
        same(a.apply_points(pts), b.apply_points(pts))
        same(a.apply_points(pts[0]), b.apply_points(pts[0]))
    a1, a2 = J(general()), J.from_translation([1.0, 2.0, 3.0])
    b1, b2 = T(general()), T.from_translation([1.0, 2.0, 3.0])
    same(a1 @ a2, b1 @ b2)
    same(a2.compose(a2), b2.compose(b2))
    assert (b1 == T(general())) and not (b1 == b2) and not (b1 == general())
    with pytest.raises(ValueError, match="different dimensionality"):
        b1.compose(T.identity(2))
    with pytest.raises(ValueError, match="3x3 or 4x4"):
        T(np.eye(5))
    with pytest.raises(ValueError, match="Last row"):
        T(np.ones((4, 4)))
    with pytest.raises(NotImplementedError, match="3D-only"):
        T.identity(2).apply(np.zeros((4, 4)), device="cpu")
    assert not b1.matrix.flags.writeable


@pytest.mark.parametrize("kind", ["inplane", "general"])
@pytest.mark.parametrize("fill", [0.0, -1.0])
def test_apply_equals_the_reference(kind, fill):
    vol = np.random.default_rng(1).random(SHAPE).astype(np.float32) * 100
    m = inplane() if kind == "inplane" else general()
    out_shape = (9, 22, 21)
    got = T(m).apply(vol, out_shape, fill=fill, device="cpu")
    assert isinstance(got, torch.Tensor) and tuple(got.shape) == out_shape
    if kind == "inplane":
        want = np.asarray(J(m).apply(vol, out_shape, fill=fill))
    else:
        want = np.asarray(multipass_affine_warp_zyx(vol, np.linalg.inv(m), out_shape,
                                                    fill=fill))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    same_shape = T(m).apply(torch.from_numpy(vol), device="cpu")
    assert tuple(same_shape.shape) == SHAPE
