"""The port's general 3D warp (the factorization, kernel H's plain version,
the multipass warp, its batched form, the exact gather and stabilize with
general matrices) against biahub_tpu's.

The reference runs its multipass warp on the XLA route on the CPU (its
``_apply_pass``) and, where stated, on its Pallas route in interpret mode;
the port runs its plain PyTorch versions on the CPU. Tolerance: max |port
- ref| <= 1e-5 * max |ref| (the warp's envelope; the XLA route and the port
differ by ~2e-6 in the order of float32 operations), and the fill mask
equal voxel for voxel. The factorization, the frame and the exact gather
are equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter
from scipy.spatial.transform import Rotation

from biahub_tpu.kernels import affine as jaff
from biahub_tpu.kernels import multipass_warp as jmp
from biahub_tpu_torch import stabilize_tczyx
from biahub_tpu_torch.kernels import affine as taff
from biahub_tpu_torch.kernels import multipass_warp as tmp
from biahub_tpu_torch.kernels.multipass_cuda import resample_pass
from tests.test_torch_chain import pallas_route  # noqa: F401  (fixture)

RTOL = 1e-5
SHAPE = (12, 20, 24)


def rigid(angles_deg, shift, scale: float = 1.0) -> np.ndarray:
    """A rotation about z, y and x (scipy's "xyz" Euler angles), scaled,
    then a shift, with float32 entries (as stabilize reads its YAML)."""
    m = np.eye(4)
    m[:3, :3] = scale * Rotation.from_euler("xyz", angles_deg, degrees=True).as_matrix()
    m[:3, 3] = shift
    return m.astype(np.float32).astype(np.float64)


MATRICES = {
    "rotation": (rigid([3, -2, 5], [0.3, -1.2, 0.7]), SHAPE),
    "small_rotation": (rigid([1, 1, 1], [0.5, 0.25, -0.75]), SHAPE),
    "similarity": (rigid([2, 4, -3], [0.2, 0.4, -0.3], 1.05), SHAPE),
    "other_output_shape": (rigid([10, 0, 0], [1, 2, 3]), (10, 22, 20)),
}
QUARTER = rigid([0, 90, 0], [1, 2, 3])  # a vanishing pivot


def volume(shape=SHAPE, seed=1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return gaussian_filter(rng.random(shape), 1.0).astype(np.float32)


def assert_close(got: torch.Tensor, want: np.ndarray, fill: float = 0.0) -> None:
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= RTOL * np.abs(want).max()
    assert np.array_equal(got == fill, want == fill)


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_factorization_and_frame_equal_the_reference(name):
    m, out = MATRICES[name]
    assert tmp.factor_affine(m) == jmp.factor_affine(m)
    assert tmp._factor_canonical(m) == jmp._factor_canonical(m)
    assert tmp.common_frame_bytes(m, SHAPE, out) == jmp.common_frame_bytes(m, SHAPE, out)
    mats = np.stack([MATRICES[k][0] for k in sorted(MATRICES)])
    assert tmp.common_frame_bytes(mats, SHAPE, out) == jmp.common_frame_bytes(mats, SHAPE, out)
    with pytest.raises(ValueError, match="pivot"):
        tmp.factor_affine(QUARTER)
    assert tmp.common_frame_bytes(np.eye(4), SHAPE, SHAPE) == 0


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_multipass_warp_matches_the_reference(name):
    m, out = MATRICES[name]
    vol = volume()
    want = np.asarray(jmp.multipass_affine_warp_zyx(jnp.asarray(vol), m, out))
    got = tmp.multipass_affine_warp_zyx(vol, m, out, device="cpu")
    assert_close(got, want)
    # Order 1 and another fill take the same passes.
    want1 = np.asarray(jmp.multipass_affine_warp_zyx(jnp.asarray(vol), m, out, fill=-1.0))
    assert_close(tmp.multipass_affine_warp_zyx(vol, m, out, fill=-1.0, device="cpu"),
                 want1, -1.0)


def test_multipass_warp_matches_the_pallas_route(pallas_route):
    m, out = MATRICES["rotation"]
    vol = volume()
    want = np.asarray(jmp.multipass_affine_warp_zyx(jnp.asarray(vol), m, out))
    assert_close(tmp.multipass_affine_warp_zyx(vol, m, out, device="cpu"), want)


@pytest.mark.parametrize("order", [1, 3])
def test_resample_pass_plain_matches_apply_pass(order):
    """One pass with a shear, in the frame: the reference's _apply_pass."""
    frame = volume((10, 14, 16), 5)
    want = np.asarray(jmp._apply_pass(jnp.asarray(frame), 1, 2, 0.97, 0.05, 0.4, -2.0,
                                      False, order=order))
    coeffs = torch.tensor([[0.97, 0.05, 0.4]], dtype=torch.float32)
    got = resample_pass(torch.from_numpy(frame)[None], coeffs, 0, 1, 2, order, -2.0)[0]
    assert_close(got, want, -2.0)


def batch_matrices() -> np.ndarray:
    rng = np.random.default_rng(7)
    rot = [rigid(rng.uniform(-3, 3, 3), rng.uniform(-2, 2, 3)) for _ in range(3)]
    shift = np.eye(4)
    shift[:3, 3] = [1.5, -0.25, 2.0]
    return np.stack(rot[:2] + [np.eye(4), shift, rot[2]])


def test_batched_warp_matches_make_batched_multipass_kernel():
    mats = batch_matrices()
    vols = np.stack([volume(seed=s) for s in range(len(mats))])
    kernel, params = jmp.make_batched_multipass_kernel(mats, SHAPE, SHAPE)
    want = np.stack([np.asarray(kernel(jnp.asarray(v), jnp.asarray(m, jnp.float32),
                                       jnp.asarray(p)))
                     for v, m, p in zip(vols, mats.astype(np.float32), params)])
    got = tmp.multipass_affine_warp_zyx_batched(vols, mats, SHAPE, device="cpu")
    assert_close(got, want)
    # The frame of a larger set gives the same warp.
    frame = tmp.union_frame(np.concatenate([mats, [rigid([0, 0, 20], [5, 5, 5])]]),
                            SHAPE, SHAPE)
    wide = tmp.multipass_affine_warp_zyx_batched(vols, mats, SHAPE, frame=frame, device="cpu")
    assert_close(wide, want)
    with pytest.raises(ValueError, match="4 matrices for a batch of 5"):
        tmp.multipass_affine_warp_zyx_batched(vols, mats[:4], SHAPE, device="cpu")


def test_identity_rows_are_bit_exact():
    """An identity matrix in a batch of general ones: every slot is an
    exact no-op (Catmull-Rom weights (0, 1, 0, 0) at t = 0), so its row
    is its volume bit for bit."""
    mats = batch_matrices()
    vols = np.stack([volume(seed=s) for s in range(len(mats))])
    got = tmp.multipass_affine_warp_zyx_batched(vols, mats, SHAPE, device="cpu")
    assert torch.equal(got[2], torch.from_numpy(vols[2]))


@pytest.mark.parametrize("order", [0, 1])
def test_vanishing_pivot_takes_the_exact_gather(order):
    """Order 0 is equal; order 1 sums eight products, which XLA may
    contract differently (within the warp's envelope)."""
    vol = volume()
    check = ((lambda got, want: np.testing.assert_array_equal(got.numpy(), want))
             if order == 0 else assert_close)
    for m in (QUARTER, MATRICES["rotation"][0]):
        want = np.asarray(jaff.affine_warp_zyx(jnp.asarray(vol), jnp.asarray(m, jnp.float32),
                                               SHAPE, order=order))
        check(taff.affine_warp_zyx(vol, m, SHAPE, order=order, device="cpu"), want)
    want = np.asarray(jaff.affine_warp_zyx(jnp.asarray(vol), jnp.asarray(QUARTER, jnp.float32),
                                           SHAPE, order=order))
    check(taff.affine_warp_auto(vol, QUARTER, SHAPE, order=order, device="cpu"), want)


def test_exact_domain_mask_general_equals_the_reference():
    m, out = MATRICES["other_output_shape"]
    ones = jnp.ones(out, jnp.float32)
    want = np.asarray(jaff._exact_domain_mask(ones, jnp.asarray(m, jnp.float32), SHAPE, out,
                                              0.0)) == 1.0
    got = taff.exact_domain_mask_general(m, SHAPE, out, torch.device("cpu"))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < want.size


def test_stabilize_with_general_matrices_matches_the_reference_kernel_choice():
    """stabilize's general branch (stabilize.py:199-213): the batched
    multipass kernel over one frame for every matrix, unit by unit; a batch
    budget that splits the units changes nothing. A vanishing pivot sends
    the whole run to the exact gather."""
    mats = batch_matrices()[:4]
    T = len(mats)
    tczyx = np.stack([[volume(seed=10 * t + c) for c in range(2)] for t in range(T)])
    kernel, params = jmp.make_batched_multipass_kernel(mats.astype(np.float32), SHAPE, SHAPE)
    want = np.stack([[np.asarray(kernel(jnp.asarray(tczyx[t, c]),
                                        jnp.asarray(mats[t], jnp.float32),
                                        jnp.asarray(params[t]))) for c in range(2)]
                     for t in range(T)])
    got = stabilize_tczyx(tczyx, mats, device="cpu")
    assert_close(got, want)
    unit = 4 * 2 * int(np.prod(SHAPE)) + tmp.common_frame_bytes(mats, SHAPE, SHAPE)
    assert torch.equal(stabilize_tczyx(tczyx, mats, max_batch_bytes=3 * unit, device="cpu"),
                       got)
    quarter = mats.copy()
    quarter[1] = QUARTER
    want_q = np.stack([[np.asarray(jaff.affine_warp_zyx(
        jnp.asarray(tczyx[t, c]), jnp.asarray(quarter[t], jnp.float32), SHAPE))
        for c in range(2)] for t in range(T)])
    assert_close(stabilize_tczyx(tczyx, quarter, device="cpu"), want_q)
