"""The port's intensity registration (registration/intensity.py, the LIR,
optimize-registration and estimate-registration on arrays) against
biahub_tpu's.

On a CPU the reference optimizes through its exact trilinear gather
(intensity.py:174-191) and sends general matrices to that gather too
(affine.py:609-623); only on its accelerator does it take the traced
multipass warp and the multipass warp, which the port always takes. So the
reference runs here with its accelerator route patched in, in the tests
only: ``_optimize_level`` gets ``make_traced_multipass_warp(...,
margin=0.15, order=1, use_pallas=False)`` and ``affine_warp_auto`` sends
general matrices to ``multipass_affine_warp_zyx``. Levels are shortened
for the CPU. Tolerances: the helpers within 1e-6 of JAX; Adam within 1e-6
relative of optax; 5 steps of a level within 1e-4; recovered transforms
within 0.01 (linear part) and 0.3 voxel of the truth and of the reference
(an optimizer amplifies float32 rounding over hundreds of steps), and a
chain of three within 0.02 and 1 voxel of the reference's chain;
preprocessing within 1e-5 * max|ref|; the LIR, the composition and the
settings equal.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml
from scipy.ndimage import affine_transform as sp_affine
from scipy.ndimage import gaussian_filter
from scipy.spatial.transform import Rotation

import biahub_tpu._native
from biahub_tpu import estimate_registration as jer
from biahub_tpu import register as jreg
from biahub_tpu.kernels import affine as jaff
from biahub_tpu.kernels.multipass_warp import (
    make_traced_multipass_warp,
    multipass_affine_warp_zyx,
)
from biahub_tpu.registration import intensity as ji
from biahub_tpu.settings import (
    AffineTransformSettings,
    AntsRegistrationSettings,
    EstimateRegistrationSettings,
    RegistrationSettings,
    StabilizationSettings,
)
from biahub_tpu.transforms import lir as jlir
from biahub_tpu_torch.convert import registration_estimate_settings_from_reference
from biahub_tpu_torch.estimate_registration import estimate_registration_arrays
from biahub_tpu_torch.optimize_registration import optimize_registration_arrays
from biahub_tpu_torch.register import find_lir
from biahub_tpu_torch.registration import intensity as ti
from biahub_tpu_torch.transforms.lir import largest_interior_rectangle

LEVELS = {"aff_shrink_factors": (4, 2, 1), "aff_iterations": (150, 100, 30),
          "aff_smoothing_sigmas": (2, 1, 0)}
SHORT = {"aff_shrink_factors": (2, 1), "aff_iterations": (30, 10),
         "aff_smoothing_sigmas": (1, 0)}


def bead_volume(shape=(24, 96, 96), n=40, seed=0, sigma=1.0) -> np.ndarray:
    """tests/test_registration.py's rendered beads."""
    rng = np.random.default_rng(seed)
    vol = np.zeros(shape, np.float32)
    pts = np.stack([rng.integers(4, s - 4, n) for s in shape], 1)
    vol[pts[:, 0], pts[:, 1], pts[:, 2]] = 1000.0
    return gaussian_filter(vol, sigma)


def similarity_pair():
    """tests/test_registration.py:64-87: a 4 deg rotation about z scaled
    by 1.03 and shifted, about the volume's centre; mov = ref warped by its
    inverse."""
    ref = bead_volume((24, 64, 64), n=30, sigma=2.5)
    theta = np.deg2rad(4.0)
    c, s = np.cos(theta), np.sin(theta)
    lin = 1.03 * np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
    center = (np.array(ref.shape) - 1) / 2
    w_true = np.eye(4)
    w_true[:3, :3] = lin
    w_true[:3, 3] = center - lin @ center + np.array([1.0, -2.0, 1.5])
    w_inv = np.linalg.inv(w_true)
    return ref, sp_affine(ref, w_inv[:3, :3], w_inv[:3, 3], order=1), w_true


@pytest.fixture
def accelerator_route(monkeypatch):
    """The reference's accelerator route on the CPU: the traced XLA
    multipass warp in every level (one warp per shape, so that the jitted
    level loop is traced once per shape) and the multipass warp for general
    initial matrices."""
    warps = {}
    level = ji._optimize_level

    def optimize_level(mov, ref, params0, center, n_iters, out_shape, warp_fn=None):
        key = (tuple(mov.shape), tuple(out_shape))
        if key not in warps:
            warps[key] = make_traced_multipass_warp(mov.shape, out_shape, margin=0.15,
                                                    order=1, use_pallas=False)
        return level(mov, ref, params0, center, n_iters, out_shape, warp_fn=warps[key])

    def warp_auto(zyx, matrix, out_shape, fill=0.0, order=1):
        m = np.asarray(matrix, dtype=np.float64)
        if order == 1 and not jaff.is_inplane_matrix(m):
            return multipass_affine_warp_zyx(zyx, m, out_shape, fill=fill)
        return jaff.affine_warp_auto(zyx, m, out_shape, fill=fill, order=order)

    monkeypatch.setattr(ji, "_optimize_level", optimize_level)
    monkeypatch.setattr(ji, "affine_warp_auto", warp_auto)


def shorten_levels(monkeypatch, levels):
    monkeypatch.setattr(ji, "DEFAULT_REG_KWARGS", {**ji.DEFAULT_REG_KWARGS, **levels})
    monkeypatch.setattr(ti, "DEFAULT_REG_KWARGS", {**ti.DEFAULT_REG_KWARGS, **levels})


def assert_transform_close(got, want) -> None:
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got[:3, :3] - want[:3, :3]).max() < 0.01
    assert np.abs(got[:3, 3] - want[:3, 3]).max() < 0.3


def test_helpers_match_jax():
    rng = np.random.default_rng(0)
    rotvec = np.array([0.03, -0.05, 0.02], np.float32)
    for rv in (rotvec, np.zeros(3, np.float32)):
        np.testing.assert_allclose(ti._rodrigues(torch.from_numpy(rv)).numpy(),
                                   np.asarray(ji._rodrigues(jnp.asarray(rv))), atol=1e-6)
    params = np.array([0.03, -0.05, 0.02, 0.01, 1.5, -2.0, 0.7], np.float32)
    center = np.array([5.5, 9.5, 8.0], np.float32)
    np.testing.assert_allclose(
        ti._similarity_matrix(torch.from_numpy(params), torch.from_numpy(center)).numpy(),
        np.asarray(ji._similarity_matrix(jnp.asarray(params), jnp.asarray(center))), atol=1e-6)
    # The identity's gradient is finite (the 1e-12 inside the square root).
    p = torch.zeros(7, requires_grad=True)
    ti._similarity_matrix(p, torch.from_numpy(center)).sum().backward()
    assert torch.isfinite(p.grad).all()
    vol = rng.random((12, 20, 17)).astype(np.float32)
    for sigma in (0, 1, 2):
        np.testing.assert_allclose(ti._gaussian_blur_zyx(torch.from_numpy(vol), sigma).numpy(),
                                   np.asarray(ji._gaussian_blur_zyx(jnp.asarray(vol), sigma)),
                                   atol=1e-6)
    for factor in (1, 3, 4):
        np.testing.assert_allclose(ti._downsample(torch.from_numpy(vol), factor).numpy(),
                                   np.asarray(ji._downsample(jnp.asarray(vol), factor)),
                                   atol=1e-6)
    other = rng.random((12, 20, 17)).astype(np.float32)
    np.testing.assert_allclose(
        float(ti._ncc_loss(torch.from_numpy(vol), torch.from_numpy(other))),
        float(ji._ncc_loss(jnp.asarray(vol), jnp.asarray(other))), atol=1e-6)


def test_adam_matches_optax():
    """20 fixed gradients through optax.adam(0.02) and the port's update."""
    grads = np.random.default_rng(1).standard_normal((20, 7)).astype(np.float32)
    opt = optax.adam(ti.LEARNING_RATE)
    p_ref = jnp.asarray(np.linspace(-1, 1, 7, dtype=np.float32))
    state = opt.init(p_ref)
    p = torch.from_numpy(np.linspace(-1, 1, 7, dtype=np.float32))
    mu, nu = torch.zeros(7), torch.zeros(7)
    for i, g in enumerate(grads):
        updates, state = opt.update(jnp.asarray(g), state)
        p_ref = optax.apply_updates(p_ref, updates)
        p, mu, nu = ti._adam_update(p, torch.from_numpy(g), mu, nu, i + 1)
        np.testing.assert_allclose(p.numpy(), np.asarray(p_ref), rtol=1e-6, atol=1e-7)


def test_optimize_level_matches_the_reference_with_the_traced_warp():
    """5 Adam steps at one level, the reference with its traced XLA warp."""
    ref, mov, _ = similarity_pair()
    center = (np.array(ref.shape, np.float32) - 1) / 2
    params0 = np.array([0.0, 0.01, 0.0, 0.0, 0.5, -1.0, 0.5], np.float32)
    warp = make_traced_multipass_warp(mov.shape, ref.shape, margin=0.15, order=1,
                                      use_pallas=False)
    want, want_losses = ji._optimize_level(jnp.asarray(mov), jnp.asarray(ref),
                                           jnp.asarray(params0), jnp.asarray(center), 5,
                                           ref.shape, warp_fn=warp)
    got, losses = ti._optimize_level(torch.from_numpy(mov), torch.from_numpy(ref),
                                     torch.from_numpy(params0), torch.from_numpy(center), 5,
                                     ref.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    # The losses along the two paths, whose params differ by up to 1e-4.
    np.testing.assert_allclose(losses.numpy(), np.asarray(want_losses), rtol=1e-3)


def test_estimate_recovers_the_rendered_similarity(accelerator_route):
    ref, mov, w_true = similarity_pair()
    fwd, inv = ti.estimate(ref, mov, ants_kwargs=LEVELS, device="cpu")
    assert fwd.dtype == np.float64
    np.testing.assert_allclose(fwd @ inv, np.eye(4), atol=1e-9)
    assert_transform_close(fwd, w_true)
    want, _ = ji.estimate(ref, mov, ants_kwargs=LEVELS)
    assert_transform_close(fwd, want)


TIE_MASKS = [
    np.ones((4, 6), bool),
    np.array([[1, 1, 0, 1, 1], [1, 1, 0, 1, 1]], bool),  # two equal rectangles
    np.array([[1, 1, 1, 0], [1, 1, 1, 0], [0, 1, 1, 1], [0, 1, 1, 1]], bool),
    np.zeros((3, 3), bool),
]


@pytest.mark.parametrize("native", [True, False])
def test_largest_interior_rectangle_equals_the_reference(native, monkeypatch):
    """The reference's compiled helper and its Python fallback, ties
    included (the first of the largest area in scan order wins)."""
    if not native:
        monkeypatch.setattr(biahub_tpu._native, "lir_2d", lambda mask: None)
    rng = np.random.default_rng(2)
    masks = TIE_MASKS + [rng.random((30, 40)) > p for p in (0.05, 0.2, 0.5)]
    for mask in masks:
        assert largest_interior_rectangle(mask) == jlir.largest_interior_rectangle(mask)
    vol = np.zeros((12, 30, 40), np.uint8)
    vol[2:11, 3:27, 5:36] = 1
    vol[5, 10:12, 4:9] = 0
    assert find_lir(vol) == jreg.find_lir(vol)


def rotated_matrix(shape) -> np.ndarray:
    """A small 3D rotation about the centre: a general matrix."""
    m = np.eye(4)
    m[:3, :3] = Rotation.from_euler("xyz", [1.5, -1.0, 2.0], degrees=True).as_matrix()
    centre = (np.asarray(shape) - 1) / 2
    m[:3, 3] = centre - m[:3, :3] @ centre + [0.4, -0.6, 0.8]
    return m


@pytest.mark.parametrize("options", [
    {"crop": True},
    {"crop": True, "ref_mask_radius": 0.8, "clip": True},
    {"sobel_filter": True, "mov_channel_index": [0, 1]},
])
def test_preprocess_czyx_matches_the_reference(options, accelerator_route):
    rng = np.random.default_rng(3)
    shape = (14, 40, 36)
    ref = gaussian_filter(rng.random((2,) + shape), 1.0).astype(np.float32)
    mov = (300 * gaussian_filter(rng.random((2,) + shape), 1.0)).astype(np.float32)
    initial = rotated_matrix(shape)
    want = ji.preprocess_czyx(mov, ref, initial, **options)
    got = ti.preprocess_czyx(mov, ref, initial, **options, device="cpu")
    np.testing.assert_array_equal(got[2], want[2])
    for g, w in zip(got[:2], want[:2]):
        assert g.shape == w.shape
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()
    if options.get("crop"):
        assert got[0].shape != shape
    with pytest.raises(ValueError, match="zeros"):
        ti.preprocess_czyx(np.zeros_like(mov), ref, initial, device="cpu")
    with pytest.raises(ValueError, match="fraction"):
        ti.preprocess_czyx(mov, ref, initial, ref_mask_radius=1.5, device="cpu")


def test_postprocess_transform_is_exact():
    rng = np.random.default_rng(4)
    initial, fwd = rng.standard_normal((2, 4, 4))
    offset = np.array([3, 5, 7], np.float32)
    np.testing.assert_array_equal(ti.postprocess_transform(initial, fwd, offset),
                                  ji.postprocess_transform(initial, fwd, offset))


def registration_stack(T: int):
    """(T, 2, Z, Y, X) source and target stacks: the target is the bead
    volume of :func:`similarity_pair` at every timepoint, the source that
    volume moved by a similarity that changes with t (3 deg about each
    axis, 3% of scale and 2 voxels a timepoint), so that each timepoint's
    start (the previous result) is well off its optimum; and the truths."""
    ref = similarity_pair()[0]
    centre = (np.array(ref.shape) - 1) / 2
    sources, truths = [], []
    for t in range(T):
        w = np.eye(4)
        w[:3, :3] = (1.03 + 0.03 * t) * Rotation.from_euler(
            "xyz", [4 - 3 * t, 3 * t, -3 * t], degrees=True).as_matrix()
        w[:3, 3] = centre - w[:3, :3] @ centre + np.array([1.0, -2.0, 1.5]) + 2 * t
        w_inv = np.linalg.inv(w)
        mov = sp_affine(ref, w_inv[:3, :3], w_inv[:3, 3], order=1)
        sources.append(np.stack([mov, 0.5 * mov]))
        truths.append(w)
    return np.stack(sources), np.stack([np.stack([ref, ref])] * T), truths


def test_optimize_registration_arrays(accelerator_route, monkeypatch):
    """Refining timepoint 1's registration from timepoint 0's truth, with
    the LIR crop, as the reference's _optimize_registration does."""
    shorten_levels(monkeypatch, SHORT)
    source, target, truths = registration_stack(2)
    assert optimize_registration_arrays(np.zeros_like(source[1]), target[1], truths[0],
                                        device="cpu") is None
    got = optimize_registration_arrays(source[1], target[1], truths[0], crop=True,
                                       device="cpu")
    want = ji.estimate_czyx(source[1], target[1], truths[0], crop=True)
    assert got.shape == (4, 4) and got.dtype == np.float64
    assert_transform_close(got, want)


# The port's chain of shortened registrations against the reference's chain.
CHAIN_LINEAR_TOL, CHAIN_SHIFT_TOL = 0.02, 1.0


def ants_settings(**extra) -> dict:
    return {"target_channel_name": "Phase3D", "source_channel_name": "GFP",
            "estimation_method": "ants", **extra}


@pytest.mark.parametrize("T", [1, 3])
def test_estimate_registration_ants_matches_the_reference(T, accelerator_route, monkeypatch):
    """One timepoint gives the RegistrationSettings fields, three the
    StabilizationSettings fields. With use_prev_t_transform each timepoint
    starts from the previous result. Each step is held against the
    reference's per-timepoint step (estimate_czyx) from the same start at
    0.01 / 0.3 voxel, and the chain against the reference's own chain
    (estimate_tczyx) at CHAIN_LINEAR_TOL / CHAIN_SHIFT_TOL: from starts a
    few 1e-5 apart the shortened optimizer ends up to 1.2e-2 (linear part)
    and 0.47 voxel apart by the third timepoint, while a chain that starts
    every timepoint from the identity ends 0.034 and 2.6 voxels from the
    reference's at the second."""
    shorten_levels(monkeypatch, SHORT)
    source, target, _ = registration_stack(T)
    settings = ants_settings(affine_transform_settings={"use_prev_t_transform": True})
    voxel = [1.0, 1.0, 0.174, 0.1494, 0.1494]
    got = estimate_registration_arrays(source, target, ["GFP", "BF"], ["Phase3D", "DAPI"],
                                       settings, voxel, device="cpu")
    want = ji.estimate_tczyx(source, target, 0, 0, AntsRegistrationSettings(),
                             AffineTransformSettings(use_prev_t_transform=True))
    if T == 1:
        expected = RegistrationSettings(source_channel_names=["GFP"],
                                        target_channel_name="Phase3D",
                                        affine_transform_zyx=want[0]).model_dump()
        assert_transform_close(got.pop("affine_transform_zyx"), want[0])
        expected.pop("affine_transform_zyx")
    else:
        got_list = got.pop("affine_transform_zyx_list")
        assert len(got_list) == T
        assert_transform_close(got_list[0], want[0])
        for t in range(1, T):
            assert_transform_close(got_list[t], ji.estimate_czyx(source[t], target[t],
                                                                 np.asarray(got_list[t - 1])))
            g, w = np.asarray(got_list[t]), np.asarray(want[t])
            assert np.abs(g[:3, :3] - w[:3, :3]).max() < CHAIN_LINEAR_TOL
            assert np.abs(g[:3, 3] - w[:3, 3]).max() < CHAIN_SHIFT_TOL
        expected = StabilizationSettings(
            stabilization_estimation_channel="Phase3D", stabilization_type="affine",
            stabilization_method="ants", stabilization_channels=["GFP", "Phase3D"],
            affine_transform_zyx_list=got_list, time_indices="all",
            output_voxel_size=voxel).model_dump()
        expected.pop("affine_transform_zyx_list")
    assert got == expected


def test_estimate_registration_dispatches_beads_and_refuses_manual(monkeypatch):
    calls = []

    def fake_beads(*args, **kwargs):
        calls.append((args, kwargs))
        return [np.eye(4).tolist()] * 12

    from biahub_tpu_torch.registration import beads

    monkeypatch.setattr(beads, "estimate_tczyx", fake_beads)
    stack = np.ones((12, 1, 4, 8, 8), np.float32)
    with open("settings/example_estimate_registration_settings_beads.yml") as f:
        settings = yaml.safe_load(f)
    out = estimate_registration_arrays(stack, stack, ["GFP"], ["Phase3D"], settings,
                                       [1.0] * 5, (0.2, 0.1, 0.1), device="cpu")
    (args, kwargs), = calls
    assert args[2:] == (0, 0)
    assert kwargs["mov_voxel_size"] == (0.2, 0.1, 0.1)
    assert kwargs["beads_match_settings"]["hungarian_match_settings"]["edge_graph_settings"] \
        == {"method": "knn", "k": 5, "radius": None}
    assert out["stabilization_method"] == "beads"
    assert len(out["affine_transform_zyx_list"]) == 12
    # The manual method: headless without point pairs, the fitted pairs with.
    manual = {**settings, "estimation_method": "manual"}
    with pytest.raises(RuntimeError, match="requires an interactive napari session"):
        estimate_registration_arrays(stack, stack, ["GFP"], ["Phase3D"], manual, [1.0] * 5,
                                     device="cpu")
    pts = np.random.default_rng(2).random((4, 3)) * [4, 8, 8]
    out = estimate_registration_arrays(stack, stack, ["GFP"], ["Phase3D"], manual, [1.0] * 5,
                                       (0.2, 0.1, 0.1), source_points=pts,
                                       target_points=pts + 0.5, device="cpu")
    assert out["affine_transform_zyx"] == jer.registration_from_point_pairs(
        pts, pts + 0.5, (4, 8, 8), (4, 8, 8), (0.2, 0.1, 0.1), (1.0, 1.0, 1.0),
        source_points_frame="pre_aligned").tolist()


@pytest.mark.parametrize("name", ["", "_beads", "_manual"])
def test_registration_estimate_settings_equal_the_reference_model(name):
    with open(f"settings/example_estimate_registration_settings{name}.yml") as f:
        d = yaml.safe_load(f)
    got = registration_estimate_settings_from_reference(d)
    assert got == EstimateRegistrationSettings(**d).model_dump()
    assert registration_estimate_settings_from_reference(got) == got
    with pytest.raises(ValueError, match="unknown fields"):
        registration_estimate_settings_from_reference({**d, "bogus": 1})
    with pytest.raises(ValueError, match="4x4"):
        registration_estimate_settings_from_reference(
            {**d, "affine_transform_settings": {"approx_transform": [[1, 0], [0, 1]]}})
