"""biahub_tpu_torch deskew against biahub_tpu on the same inputs.

The port runs its plain PyTorch version here (CPU tensors). The reference
runs ``deskew_zyx`` (its XLA lerp gather on the CPU) and
``deskew_zyx_pallas_batched`` (the zyx batched kernel, interpret mode);
conftest pins the reference's warp precision to ``highest``. Tolerance:
atol 1e-5 on unit-range data. Y = 14 is not a multiple of 3, so
``average_window=3`` exercises the edge-padded tail group.
"""

import jax
import numpy as np
import pytest
import torch

from biahub_tpu.kernels import deskew as jdk
from biahub_tpu.kernels.pallas_deskew import deskew_zyx_pallas_batched
from biahub_tpu_torch.kernels import deskew as tdk
from biahub_tpu_torch.kernels.deskew_cuda import deskew as deskew_kernel

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ATOL = 1e-5
SHAPE = (12, 14, 40)
ANGLE, RATIO = 36.17, 0.371
CASES = [
    (avg, skip_flip, keep_overhang)
    for avg in (1, 3) for skip_flip in (True, False) for keep_overhang in (True, False)
]


@pytest.mark.parametrize("avg,skip_flip,keep_overhang", CASES)
def test_deskew_zyx_matches_reference(avg, skip_flip, keep_overhang):
    vol = np.random.default_rng(11).random(SHAPE, dtype=np.float32)
    want = np.asarray(jdk.deskew_zyx(
        vol, ANGLE, RATIO, keep_overhang, average_window=avg, skip_flip=skip_flip,
    ))
    got = tdk.deskew_zyx(vol, ANGLE, RATIO, keep_overhang, average_window=avg,
                         skip_flip=skip_flip, device="cpu").numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("avg,skip_flip,keep_overhang", CASES)
def test_deskew_batched_matches_pallas_batched(avg, skip_flip, keep_overhang, monkeypatch):
    monkeypatch.setenv("BIAHUB_TPU_FORCE_PALLAS", "1")
    jax.clear_caches()
    vols = np.random.default_rng(12).random((2,) + SHAPE, dtype=np.float32)
    want = np.asarray(deskew_zyx_pallas_batched(
        vols, ANGLE, RATIO, keep_overhang, average_window=avg, skip_flip=skip_flip,
    ))
    got = tdk.deskew_zyx_batched(vols, ANGLE, RATIO, keep_overhang, average_window=avg,
                                 skip_flip=skip_flip, device="cpu").numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    jax.clear_caches()


def test_deskewed_shape_and_matrix_match_reference():
    for shape in [(12, 14, 40), (256, 256, 1024), (100, 64, 33), (7, 30, 5)]:
        for angle in (30.0, 36.17, 45.0):
            for ratio in (0.2, 0.371, 1.0):
                for keep in (True, False):
                    for avg in (1, 3):
                        args = (shape, angle, ratio, keep, avg, 0.116)
                        try:
                            want = jdk.get_deskewed_data_shape(*args)
                        except ValueError:
                            with pytest.raises(ValueError, match="only overhang"):
                                tdk.get_deskewed_data_shape(*args)
                            continue
                        assert tdk.get_deskewed_data_shape(*args) == want
                np.testing.assert_array_equal(
                    tdk.deskew_transform_matrix(angle, ratio),
                    jdk.deskew_transform_matrix(angle, ratio),
                )
    headline, _ = tdk.get_deskewed_data_shape((256, 256, 1024), ANGLE, RATIO, False, 3)
    assert headline == (86, 1024, 484)


@pytest.mark.parametrize("window", [1, 2, 3])
def test_average_n_slices_matches_reference(window):
    data = np.random.default_rng(13).random((7, 3, 5), dtype=np.float32)
    want = np.asarray(jdk.average_n_slices(data, window))
    got = tdk.average_n_slices(torch.from_numpy(data), window).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


@pytest.mark.parametrize("fill", ["mean", 2.5])
def test_overhang_fill_matches_reference(fill):
    """keep_overhang with a fill: the dilated zero mask filled with the
    valid voxels' mean or the constant, within ATOL of the reference."""
    vol = np.random.default_rng(14).random(SHAPE, dtype=np.float32)
    for avg, skip_flip in ((1, False), (3, True)):
        want = np.asarray(jdk.deskew_zyx(vol, ANGLE, RATIO, True, average_window=avg,
                                         overhang_fill=fill, skip_flip=skip_flip))
        got = tdk.deskew_zyx(vol, ANGLE, RATIO, True, average_window=avg, overhang_fill=fill,
                             skip_flip=skip_flip, device="cpu").numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    # Without keep_overhang the reference ignores the fill, and so does the port.
    assert tdk.deskew_zyx(vol, ANGLE, RATIO, False, overhang_fill=fill,
                          device="cpu").shape == (14, 40, 22)


@pytest.mark.parametrize("avg,keep_overhang", [(1, False), (3, True)])
def test_deskew_xzy_layout_matches_pallas_batched(avg, keep_overhang, monkeypatch):
    """Kernel D's ``out_layout="xzy"`` (its plain version here) against the
    reference's xzy store, (B, X_out, groups, Y_out)."""
    monkeypatch.setenv("BIAHUB_TPU_FORCE_PALLAS", "1")
    jax.clear_caches()
    vols = np.random.default_rng(14).random((2,) + SHAPE, dtype=np.float32)
    want = np.asarray(deskew_zyx_pallas_batched(
        vols, ANGLE, RATIO, keep_overhang, average_window=avg, skip_flip=True,
        out_layout="xzy",
    ))
    geo = tdk.deskew_geometry(SHAPE, ANGLE, RATIO, keep_overhang, avg, skip_flip=True)
    got = deskew_kernel(torch.from_numpy(vols), geo, out_layout="xzy")
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    assert torch.equal(got, deskew_kernel(torch.from_numpy(vols), geo).permute(0, 3, 1, 2))
    with pytest.raises(ValueError, match="skip_flip"):
        deskew_kernel(torch.from_numpy(vols), geo._replace(skip_flip=False), "xzy")
    jax.clear_caches()
