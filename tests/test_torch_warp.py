"""The port's in-plane warp (the plain versions of kernels E and F) against
biahub_tpu's.

The reference runs its Pallas route in interpret mode (``pallas_route``:
``BIAHUB_TPU_FORCE_PALLAS=1``, ``BIAHUB_TPU_WARP_PRECISION=highest``); the
port runs its plain PyTorch versions on the CPU. Layouts: the reference's
pass 1 takes (Xi, Zi, Yi) and writes (Yo, Xi, Zo), the port's kernel E takes
(B, Zi, Yi, Xi) and writes (B, Zo, Yo, Xi), so E's output is the
reference's transposed (2, 0, 1); its pass 2 takes (Yo, Xi, Zo), kernel F
takes (B, Zo, Yo, Xi), and both write (Zo, Yo, Xo). Tolerance: max |port -
ref| <= 1e-5 * max |ref| (the reference's pallas and XLA warps differ by
about 3e-6 of max |ref| at ``highest``), and the fill mask equal voxel for
voxel.
"""

import numpy as np
import pytest
import torch

from biahub_tpu.kernels import affine as jaff
from biahub_tpu.kernels.chain import flip_y_matrix
from biahub_tpu.kernels.multipass_warp import multipass_affine_warp_zyx
from biahub_tpu.kernels.pallas_resample import (
    shear_resample2_pallas_t,
    shear_resample_pallas_t,
)
from biahub_tpu_torch.kernels import affine as taff
from biahub_tpu_torch.kernels.warp_cuda import warp_x, warp_zy
from tests.test_torch_chain import pallas_route  # noqa: F401  (fixture)

RTOL = 1e-5


def rotation_scale(theta_deg: float, shift, dtype=np.float64) -> np.ndarray:
    """An in-plane rotation by ``theta_deg`` scaled by 1.01, then a shift:
    bench.py's ``reg_stab`` (bench.py:757-763) with float32 entries."""
    theta = np.deg2rad(theta_deg)
    m = np.eye(4, dtype=dtype)
    m[1:3, 1:3] = 1.01 * np.array(
        [[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]], dtype)
    m[:3, 3] = shift
    return m


REG_STAB = rotation_scale(2.0, [0.5, -1.25, 2.0], np.float32).astype(np.float64)
# tests/test_pallas_resample.py:411-416
RESAMPLE_TEST = rotation_scale(2.0, [0.3, -0.6, 0.9])


def assert_close(got: torch.Tensor, want: np.ndarray) -> None:
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= RTOL * np.abs(want).max()


def coeffs_of(m: np.ndarray):
    c = taff.inplane_coefficients(m).tolist()
    return tuple(c[0:3]), tuple(c[3:6]), tuple(c[6:9])


# (matrix, logical ZYX input, output ZYX, fill): bench's matrix after the
# chain's flip at a ragged O (Xi = 21 and Yo = 37 are not multiples of 8),
# the same leaving the frame on every side, and the reference test's matrix.
PASS_CASES = {
    "reg_stab": (flip_y_matrix(37) @ REG_STAB, (5, 37, 21), (5, 37, 21), 0.0),
    "off_frame": (flip_y_matrix(37) @ rotation_scale(9.0, [-1.5, 4.0, -3.0]),
                  (6, 37, 21), (8, 40, 26), -1.0),
    "resample_test": (RESAMPLE_TEST, (9, 21, 27), (9, 21, 27), -1.0),
}


@pytest.mark.parametrize("case", sorted(PASS_CASES))
def test_pass1_matches_shear_resample2(case, pallas_route):
    m, in_shape, out_shape, _ = PASS_CASES[case]
    zc, yc, _ = coeffs_of(m)
    vol = np.random.default_rng(31).random(in_shape, dtype=np.float32)
    want = np.asarray(shear_resample2_pallas_t(
        np.ascontiguousarray(vol.transpose(2, 0, 1)), out_shape[0], out_shape[1],
        zc, yc, order=1,
    ))  # (Yo, Xi, Zo)
    got = warp_zy(torch.from_numpy(vol)[None], taff.inplane_coefficients(m),
                  out_shape[:2])
    assert_close(got[0], want.transpose(2, 0, 1))


@pytest.mark.parametrize("case", sorted(PASS_CASES))
def test_pass2_with_mask_matches_shear_resample(case, pallas_route):
    m, in_shape, out_shape, fill = PASS_CASES[case]
    _, _, xc = coeffs_of(m)
    z_out, y_out, x_out = out_shape
    inter = np.random.default_rng(32).random((y_out, in_shape[2], z_out),
                                             dtype=np.float32)
    a_flat = tuple(float(c) for i in range(3)
                   for c in (m[i, 1], m[i, 0], m[i, 2], m[i, 3]))
    want = np.asarray(shear_resample_pallas_t(
        inter, x_out, *xc, order=1, mask=(a_flat, in_shape, fill)))
    got = warp_x(torch.from_numpy(inter.transpose(2, 0, 1).copy())[None],
                 taff.inplane_coefficients(m), x_out, in_shape, fill)[0]
    assert_close(got, want)
    assert np.array_equal(got.numpy() == fill, want == fill)
    # The plain mask is the reference's whole-sample domain rule.
    ref_mask = np.asarray(jaff._exact_domain_mask(
        np.ones(out_shape, np.float32), m.astype(np.float32), in_shape, out_shape, 0.0))
    assert np.array_equal(
        taff.exact_domain_mask(taff.inplane_coefficients(m), in_shape, out_shape).numpy(),
        ref_mask == 1.0)


# (matrix, batch shape as given, output ZYX, fill, input_xzy)
WARP_CASES = {
    "reg_stab_ragged_o": (flip_y_matrix(37) @ REG_STAB, (2, 5, 37, 21), (5, 37, 21), 0.0, False),
    "other_output_shape_fill": (REG_STAB, (2, 6, 30, 19), (4, 33, 25), -1.0, False),
    "input_xzy": (RESAMPLE_TEST, (2, 27, 9, 21), (9, 21, 27), -1.0, True),
    "resample_test": (RESAMPLE_TEST, (2, 9, 21, 27), (9, 21, 27), 0.0, False),
}


@pytest.mark.parametrize("case", sorted(WARP_CASES))
def test_inplane_warp_batched_matches_reference(case, pallas_route):
    m, shape, out_shape, fill, input_xzy = WARP_CASES[case]
    vols = np.random.default_rng(33).random(shape, dtype=np.float32)
    want = np.asarray(jaff.inplane_affine_warp_zyx_pallas_batched(
        vols, m, out_shape, fill=fill, input_xzy=input_xzy))
    got = taff.inplane_affine_warp_zyx_batched(
        vols, m, out_shape, fill=fill, input_xzy=input_xzy, device="cpu")
    assert_close(got, want)
    assert np.array_equal(got.numpy() == fill, want == fill)
    one = taff.inplane_affine_warp_zyx(vols[1], m, out_shape, fill=fill,
                                       input_xzy=input_xzy, device="cpu")
    assert torch.equal(one, got[1])


def test_affine_warp_auto_translation_matches_reference(pallas_route):
    """A pure translation takes the port's in-plane warp; the reference's
    takes its separable translation warp."""
    m = np.eye(4)
    m[:3, 3] = [0.4, -2.3, 1.7]
    assert jaff.is_translation_matrix(m) and taff.is_translation_matrix(m)
    vol = np.random.default_rng(34).random((6, 20, 24), dtype=np.float32)
    want = np.asarray(jaff.affine_warp_auto(vol, m, (6, 20, 24)))
    got = taff.affine_warp_auto(vol, m, (6, 20, 24), device="cpu")
    assert_close(got, want)
    assert np.array_equal(got.numpy() == 0.0, want == 0.0)


def test_matrix_helpers_match_reference():
    mats = [np.eye(4), REG_STAB, RESAMPLE_TEST, jaff.rotation_matrix_zyx(10.0, axis=1),
            jaff.rotation_matrix_zyx(10.0, axis=0), np.eye(3) * 2.0, None]
    for m in mats:
        assert np.array_equal(taff.matrix_4x4(m), jaff.matrix_4x4(m))
        m4 = jaff.matrix_4x4(m)
        assert taff.is_inplane_matrix(m4) == jaff.is_inplane_matrix(m4)
        assert taff.is_translation_matrix(m4) == jaff.is_translation_matrix(m4)


@pytest.mark.parametrize("order,matrix", [
    (1, jaff.rotation_matrix_zyx(10.0, axis=1)),  # mixes z into x: 3D
    (3, REG_STAB),
])
def test_affine_warp_auto_raises_for_what_is_not_ported(order, matrix):
    """Nothing here is left unported: the general branch of
    affine_warp_auto takes, for order 1, the multipass warp (the
    reference's accelerator route), for another order the exact gather
    (its trilinear sample, as the reference's)."""
    vol = np.random.default_rng(36).random((4, 8, 8), dtype=np.float32)
    got = taff.affine_warp_auto(vol, matrix, (4, 8, 8), order=order, device="cpu")
    if order == 1:
        want = multipass_affine_warp_zyx(vol, matrix, (4, 8, 8))
    else:
        want = jaff.affine_warp_auto(vol, matrix, (4, 8, 8), order=order)
    assert_close(got, np.asarray(want))


def test_pass1_clamps_to_the_frame_past_the_reference_window(pallas_route):
    """Zi = 150 > the reference pass 1's z window (144 rows at mzz = 1), and
    150 - 144 is not a multiple of 8: the reference's Pallas pass clamps the
    top rows to its window's end (ROADMAP queue 3), its XLA warp and the
    port clamp to the frame. The port is held to the XLA warp everywhere and
    to the Pallas pass below the window's end."""
    m = np.eye(4)
    m[0, 3] = 0.6
    vol = np.random.default_rng(35).random((150, 8, 16), dtype=np.float32)
    coeffs = taff.inplane_coefficients(m)
    got = warp_zy(torch.from_numpy(vol)[None], coeffs, (150, 8))[0].numpy()
    want_xla = np.asarray(jaff.inplane_affine_warp_zyx(vol, m, (150, 8, 16)))
    want_pallas = np.asarray(shear_resample2_pallas_t(
        np.ascontiguousarray(vol.transpose(2, 0, 1)), 150, 8, *coeffs_of(m)[:2],
        order=1)).transpose(2, 0, 1)
    # Pass 2 of an identity x row is exact, so the XLA warp's output is pass
    # 1's, apart from the last row (zi = 149.6), which its mask fills.
    np.testing.assert_allclose(got[:149], want_xla[:149], rtol=0, atol=RTOL)
    np.testing.assert_allclose(got[:143], want_pallas[:143], rtol=0, atol=RTOL)
    assert np.abs(got[143:] - want_pallas[143:]).max() > 0.1
