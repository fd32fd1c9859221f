"""The port's stabilize (kernels E and F with one matrix per volume, the
translation warp, ``stabilize_tczyx``) against biahub_tpu's.

The reference runs ``make_batched_inplane_kernel``'s kernel and
``translation_warp_zyx`` on their Pallas route in interpret mode
(``pallas_route``) and on their XLA route; the port runs the plain versions
of E and F on the CPU. Tolerance: max |port - ref| <= 1e-5 * max |ref| (the
warp's envelope), and the fill mask equal voxel for voxel. Integer
stabilization shifts are exact: the stabilized frames equal the first frame
inside the frame and are 0 outside.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from biahub_tpu import stabilize as jstab
from biahub_tpu.kernels import affine as jaff
from biahub_tpu.kernels import multipass_warp as jmp
from biahub_tpu_torch import (
    ArrayPosition,
    estimate_stabilization_arrays,
    phase_cross_corr,
    stabilize_tczyx,
)
from biahub_tpu_torch import stabilize as tstab
from biahub_tpu_torch.kernels import affine as taff
from biahub_tpu_torch.kernels.focus import focus_from_transverse_band_tzyx
from tests.test_torch_chain import pallas_route  # noqa: F401  (fixture)
from tests.test_torch_warp import rotation_scale

RTOL = 1e-5
SHAPE = (6, 24, 20)


def assert_close(got, want, fill=0.0) -> None:
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= RTOL * np.abs(want).max()
    assert np.array_equal(got == fill, want == fill)


def inplane_matrices(n: int, seed: int = 41) -> np.ndarray:
    """Small in-plane rotations and shifts, as stabilize's per-timepoint
    matrices, one leaving the frame."""
    rng = np.random.default_rng(seed)
    return np.stack([rotation_scale(rng.uniform(-3, 3), rng.uniform(-2.5, 2.5, 3))
                     for _ in range(n)])


@pytest.mark.parametrize("route", ["pallas", "xla"])
def test_per_volume_inplane_batch_matches_make_batched_inplane_kernel(route, request):
    if route == "pallas":
        request.getfixturevalue("pallas_route")
    mats = inplane_matrices(3)
    vols = np.random.default_rng(42).random((3,) + SHAPE, dtype=np.float32)
    kernel, params = jaff.make_batched_inplane_kernel(mats, SHAPE, SHAPE)
    want = np.stack([np.asarray(kernel(vols[i], mats[i].astype(np.float32), params[i]))
                     for i in range(3)])
    got = taff.inplane_affine_warp_zyx_batched(vols, mats, SHAPE, device="cpu")
    assert_close(got, want)
    table = taff.coefficient_table(mats)
    assert table.shape == (3, taff.N_COEFFS)
    np.testing.assert_array_equal(table[:, 3:9].reshape(3, 2, 3)[:, :, :].numpy(),
                                  params[:, 1:].reshape(3, 2, 3))
    with pytest.raises(ValueError, match="2 matrices for a batch of 3"):
        taff.inplane_affine_warp_zyx_batched(vols, mats[:2], SHAPE, device="cpu")


SHIFTS = [(0.4, -2.3, 1.7), (-1.0, 3.0, -4.0), (2.6, 0.5, 25.0)]  # the last leaves in x


@pytest.mark.parametrize("route,fill", [("pallas", 0.0), ("xla", 0.0), ("xla", -1.0)])
def test_translation_warp_matches_reference(route, fill, request):
    """fill 0 takes E and F with the exact-domain mask; the reference's
    Pallas passes use per-axis mask_oob and its XLA warp per-axis fill, and
    all three agree. Another fill runs the reference's separable passes."""
    if route == "pallas":
        request.getfixturevalue("pallas_route")
    vols = np.random.default_rng(43).random((3,) + SHAPE, dtype=np.float32)
    want = np.stack([np.asarray(jaff.translation_warp_zyx(v, np.float32(s), SHAPE, fill))
                     for v, s in zip(vols, SHIFTS)])
    got = taff.translation_warp_zyx_batched(vols, SHIFTS, fill=fill, device="cpu")
    assert_close(got, want, fill)
    one = taff.translation_warp_zyx(vols[1], SHIFTS[1], (5, 20, 22), fill, device="cpu")
    assert_close(one, np.asarray(jaff.translation_warp_zyx(
        vols[1], np.float32(SHIFTS[1]), (5, 20, 22), fill)), fill)


def test_stabilize_matches_reference_per_volume():
    """Every (t, c) volume warped by its timepoint's matrix, as the
    reference's kernel does unit by unit; time_indices and a batch budget
    that splits the units change nothing else."""
    mats = inplane_matrices(4, 44)
    tczyx = np.random.default_rng(45).random((4, 2) + SHAPE, dtype=np.float32)
    kernel, params = jaff.make_batched_inplane_kernel(mats, SHAPE, SHAPE)
    want = np.stack([[np.asarray(kernel(tczyx[t, c], mats[t].astype(np.float32), params[t]))
                      for c in range(2)] for t in range(4)])
    got = stabilize_tczyx(tczyx, mats, device="cpu")
    assert_close(got, want)
    unit = 2 * 4 * np.prod(SHAPE)
    small = stabilize_tczyx(tczyx, mats, [3, 1], max_batch_bytes=3 * unit, device="cpu")
    assert tstab.stabilize_batch_size(SHAPE, SHAPE, 4, 3 * unit) == 3
    assert torch.equal(small, got[[3, 1]])
    assert torch.equal(stabilize_tczyx(tczyx, mats, 2, device="cpu"), got[[2]])
    want_apply = np.asarray(jstab.apply_stabilization_transform(tczyx[2], mats, 2))
    assert_close(tstab.apply_stabilization_transform(tczyx[2], mats, 2, device="cpu"),
                 want_apply)


def test_output_yx_and_what_is_not_ported():
    quarter = np.eye(4)
    quarter[1:3, 1:3] = [[0, -1], [1, 0]]
    for m in (np.eye(4), quarter):
        assert tstab._output_yx([m], 24, 20) == jstab._output_yx(
            SimpleNamespace(affine_transform_zyx_list=[m.tolist()]), 24, 20)
    # A general 3D matrix now takes the batched multipass warp, as the
    # reference's kernel choice does (tests/test_torch_multipass.py).
    tilt = jaff.rotation_matrix_zyx(10.0, axis=1).astype(np.float32)
    vol = np.random.default_rng(47).random(SHAPE, dtype=np.float32)
    kernel, params = jmp.make_batched_multipass_kernel([tilt], SHAPE, SHAPE)
    want = np.asarray(kernel(vol, tilt, params[0]))
    assert_close(stabilize_tczyx(vol[None, None], [tilt], device="cpu")[0, 0], want)


def test_kernel_is_chosen_from_every_matrix_not_the_selected_ones():
    """time_indices select two in-plane timepoints while a later one is a
    10 deg tilt: the reference chooses its kernel from every matrix
    (stabilize.py:172-213), so all take the batched multipass warp."""
    tilt = jaff.rotation_matrix_zyx(10.0, axis=1).astype(np.float32).astype(np.float64)
    mats = np.concatenate([inplane_matrices(2, 48), tilt[None]])
    tczyx = np.random.default_rng(49).random((3, 1) + SHAPE, dtype=np.float32)
    kernel, params = jmp.make_batched_multipass_kernel(mats.astype(np.float32), SHAPE, SHAPE)
    want = np.stack([np.asarray(kernel(tczyx[t, 0], mats[t].astype(np.float32), params[t]))
                     for t in (0, 1)])
    got = stabilize_tczyx(tczyx, mats, [0, 1], device="cpu")
    assert_close(got[:, 0], want)


def test_estimate_then_stabilize_roundtrip():
    """As tests/test_stabilization.py:98, on arrays: drift estimated by PCC,
    then corrected, gives the first frame back inside the frame."""
    base = ndi.uniform_filter(np.random.default_rng(46).random((12, 32, 40),
                                                               dtype=np.float32), 3)
    drifts = [(0, 0, 0), (1, 2, -1), (2, -2, 3), (0, 4, 2)]
    tczyx = np.stack([np.roll(base, d, axis=(0, 1, 2)) for d in drifts])[:, None]
    pos = ArrayPosition(tczyx, [1.0] * 5, ["GFP"])
    mats = estimate_stabilization_arrays(
        {"A/1/0": pos},
        {"stabilization_estimation_channel": "GFP", "stabilization_channels": ["GFP"],
         "stabilization_type": "xyz", "stabilization_method": "phase-cross-corr",
         "phase_cross_corr_settings": {"normalization": "magnitude"}},
        device="cpu")["xyz"]["A_1_0"]
    np.testing.assert_array_equal(np.asarray(mats)[:, :3, 3], drifts)
    out = stabilize_tczyx(tczyx, mats, device="cpu").numpy()[:, 0]
    grid = np.indices(base.shape)
    for t, d in enumerate(drifts):
        inside = np.all([(g + s >= 0) & (g + s <= n - 1)
                         for g, s, n in zip(grid, d, base.shape)], axis=0)
        np.testing.assert_array_equal(out[t][inside], base[inside])
        assert (out[t][~inside] == 0).all()


ENTRY_POINTS = {
    "estimate_stabilization_arrays": lambda: estimate_stabilization_arrays(
        {"A/1/0": ArrayPosition(np.zeros((1, 1, 4, 8, 8)), [1] * 5, ["c"])},
        {"stabilization_estimation_channel": "c", "stabilization_channels": ["c"],
         "stabilization_type": "z"}),
    "stabilize_tczyx": lambda: stabilize_tczyx(np.zeros((1, 1, 4, 8, 8)), [np.eye(4)]),
    "translation_warp_zyx": lambda: taff.translation_warp_zyx(np.zeros((4, 8, 8)),
                                                              (0, 0, 0)),
    "phase_cross_corr": lambda: phase_cross_corr(np.zeros((4, 8, 8)), np.zeros((4, 8, 8))),
    "focus_from_transverse_band_tzyx": lambda: focus_from_transverse_band_tzyx(
        np.zeros((1, 4, 8, 8))),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_new_entry_points_default_to_the_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name]()
