"""The port's peak detection (kernel G's plain version, the top-k and
``detect_peaks``) against biahub_tpu's.

Volumes are integer-valued (camera counts), where the reference's blur sums
are exact in any order: there the port's candidates must equal the
reference's XLA formulation and its Pallas kernel (interpret mode) value
for value and index for index, and ``detect_peaks`` must return the same
coordinates in the same order. Tolerance: none (exact).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from biahub_tpu.kernels import peaks as jpeaks
from biahub_tpu.settings import DetectPeaksSettings
from biahub_tpu_torch.estimate_psf import BEAD_DETECTION_SETTINGS
from biahub_tpu_torch.kernels import peaks as tpeaks


def render_beads(shape, n, seed=0, sigma=(1.2, 1.6, 1.6), peak=4000.0, background=20.0):
    """Gaussian beads in integer camera counts over a flat background."""
    rng = np.random.default_rng(seed)
    vol = np.zeros(shape, np.float32)
    pts = np.stack([rng.integers(3, s - 3, n) for s in shape], 1)
    vol[tuple(pts.T)] = peak
    vol = gaussian_filter(vol, sigma) * 10 + background
    return np.round(vol + rng.normal(0, 2, shape)).clip(0).astype(np.float32)


def candidates(vol, block, blur):
    got_v, got_i = tpeaks.block_max_candidates(torch.from_numpy(vol), block, blur)
    assert got_v.dtype == torch.float32 and got_i.dtype == torch.int32
    return got_v.numpy(), got_i.numpy()


@pytest.mark.parametrize("shape,block,blur", [
    ((16, 16, 16), (8, 8, 8), 3),
    ((16, 16, 16), (8, 8, 8), 0),
    ((13, 21, 30), (8, 8, 8), 3),   # not divisible: tail voxels in no block
    ((13, 21, 30), (8, 8, 8), 0),
    ((70, 70, 40), (64, 64, 32), 3),  # estimate-psf's blocks
    ((40, 100, 70), (64, 64, 32), 0),
    ((13, 21, 30), (8, 8, 8), 5),   # other blur sizes: wider halos
    ((13, 21, 30), (8, 8, 8), 2),   # even: one more cell above than below
    ((20, 24, 40), (8, 8, 8), 15),
])
def test_block_max_candidates_match_the_xla_route_exactly(shape, block, blur):
    vol = np.random.default_rng(1).integers(0, 1000, shape).astype(np.float32)
    want_v, want_i = jpeaks._block_max_candidates_xla(jnp.asarray(vol), block, blur)
    got_v, got_i = candidates(vol, block, blur)
    np.testing.assert_array_equal(got_v, np.asarray(want_v))
    np.testing.assert_array_equal(got_i, np.asarray(want_i))


@pytest.mark.parametrize("shape,blur", [((16, 32, 128), 3), ((16, 16, 128), 0)])
def test_block_max_candidates_match_the_pallas_route_exactly(shape, blur, monkeypatch):
    """Gated shapes, where the reference runs its Pallas kernel
    (interpret mode on the CPU)."""
    monkeypatch.setenv("BIAHUB_TPU_FORCE_PALLAS", "1")
    from biahub_tpu.kernels.pallas_peaks import peaks_pallas_supported

    assert peaks_pallas_supported(shape, (8, 8, 8), blur)
    vol = np.random.default_rng(2).integers(0, 1000, shape).astype(np.float32)
    want_v, want_i = jpeaks.block_max_candidates(jnp.asarray(vol), (8, 8, 8), blur)
    got_v, got_i = candidates(vol, (8, 8, 8), blur)
    np.testing.assert_array_equal(got_v, np.asarray(want_v))
    np.testing.assert_array_equal(got_i, np.asarray(want_i))


@pytest.mark.parametrize("blur", [0, 3])
def test_ties_take_the_smallest_flat_index(blur):
    """A constant volume: every cell of a block ties, so each block's
    candidate is its first real cell in C order."""
    shape = (12, 20, 18)
    got_v, got_i = candidates(np.full(shape, 7.0, np.float32), (8, 8, 8), blur)
    grid = tpeaks.block_grid(shape, (8, 8, 8))
    first = [np.maximum(np.arange(g) * 8 - 4, 0) for g in grid]
    want = ((first[0][:, None, None] * shape[1] + first[1][None, :, None]) * shape[2]
            + first[2][None, None, :]).ravel()
    np.testing.assert_array_equal(got_v, 7.0)
    np.testing.assert_array_equal(got_i, want)


def plateaus(shape=(24, 48, 48), value=300.0, seed=3):
    """Equal 3^3 plateaus in many blocks: their blurred maxima tie."""
    vol = np.zeros(shape, np.float32)
    rng = np.random.default_rng(seed)
    for z in range(2, shape[0] - 3, 8):
        for y in range(2, shape[1] - 3, 8):
            for x in range(2, shape[2] - 3, 8):
                dz, dy, dx = rng.integers(0, 4, 3)
                vol[z + dz:z + dz + 3, y + dy:y + dy + 3, x + dx:x + dx + 3] = value
    return vol


def test_block_max_topk_keeps_the_reference_order_among_ties():
    vol = plateaus()
    want_v, want_i = jpeaks._block_max_topk(jnp.asarray(vol), (8, 8, 8), 3, 20)
    got_v, got_i = tpeaks.block_max_topk(torch.from_numpy(vol), (8, 8, 8), 3, 20)
    assert len(np.unique(np.asarray(want_v))) == 1  # all 20 tie
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


DEFAULTS = DetectPeaksSettings()
BEADS_KW = dict(block_size=tuple(DEFAULTS.block_size), threshold_abs=DEFAULTS.threshold_abs,
                nms_distance=DEFAULTS.nms_distance, min_distance=DEFAULTS.min_distance)


@pytest.mark.parametrize("case", ["beads_defaults", "psf_settings", "ties", "beads_blur5"])
def test_detect_peaks_matches_the_reference(case):
    if case == "beads_defaults":  # peaks_from_beads' call
        vol, kw = render_beads((32, 96, 80), 40), BEADS_KW
    elif case == "beads_blur5":  # DetectPeaksSettings(blur_kernel_size=5)
        vol, kw = render_beads((32, 96, 80), 40, seed=5), dict(BEADS_KW, blur_kernel_size=5)
    elif case == "psf_settings":  # estimate-psf's call
        vol, kw = render_beads((40, 192, 128), 12, seed=4), BEAD_DETECTION_SETTINGS
    else:  # more tied blocks than max_num_peaks
        vol, kw = plateaus(), dict(BEADS_KW, nms_distance=3, max_num_peaks=15)
    want = jpeaks.detect_peaks(vol, **kw)
    got = tpeaks.detect_peaks(vol, **kw, device="cpu")
    assert len(want) >= 3
    np.testing.assert_array_equal(got, want)


def test_kernel_g_plans_every_blur_up_to_its_limit():
    """Kernel G's plan (g_plan) for blur sizes from 0 to 300: none raises
    (kernel G has no limit any more: larger windows are summed by passes
    through device memory first), every staged walk fits two blocks an SM,
    and blur 3 stages its 3^3 windows in (16, 128) tiles."""
    from biahub_tpu_torch.kernels import peaks_cuda

    plan = peaks_cuda.g_plan(3, (8, 8, 8))
    assert (plan.hz, plan.hy, plan.hx, plan.ty, plan.tx, plan.passes) == (3, 3, 3, 16, 128, 0)
    assert plan.smem == 4 * peaks_cuda.walk_floats(128, 16, 3, 3, 3) == 4 * 5 * 18 * 130
    for k in range(301):
        for block in ((8, 8, 8), (64, 64, 32)):
            plan = peaks_cuda.g_plan(k, block)
            assert plan.smem <= 113 * 1024 and plan.per_sm >= 2
            assert {plan.hz, plan.hy, plan.hx} <= {1, k} and plan.passes <= 3
            assert plan.smem == 4 * peaks_cuda.walk_floats(plan.tx, plan.ty, plan.hz, plan.hy,
                                                           plan.hx)