"""The port's bead registration (fits, graph matching, the beads estimate,
estimate-stabilization's ``beads`` branch) against biahub_tpu's.

On the accelerator the reference warps a general matrix with its
multipass warp (``affine_warp_auto``, affine.py:609-623); on the CPU it
takes the exact gather instead. The tests send its general matrices to
``multipass_affine_warp_zyx`` (a patch of the test, not of the package),
so both sides warp as the accelerator does. Volumes are beads rendered in
integer camera counts at known rigid drifts.

Tolerances: fits and cost matrices equal; matches equal; the estimated
warps within 1e-9 of the reference's (the same peaks, matches and float64
fits; the warps between them agree to ~2e-6 of max|ref|, far from moving a
bead's brightest voxel), and within 0.5 voxel and 0.05 (linear part) of
the drift put in.
"""

import copy

import numpy as np
import pytest
import yaml
from scipy.spatial.transform import Rotation

from biahub_tpu.kernels import affine as jaff
from biahub_tpu.kernels.multipass_warp import multipass_affine_warp_zyx
from biahub_tpu.registration import beads as jbeads
from biahub_tpu.settings import (
    AffineTransformSettings,
    BeadsMatchSettings,
    EstimateStabilizationSettings,
)
from biahub_tpu.transforms import fitting as jfit
from biahub_tpu.transforms import graph_matching as jgm
from biahub_tpu_torch import ArrayPosition, estimate_stabilization_arrays
from biahub_tpu_torch.registration import beads as tbeads
from biahub_tpu_torch.transforms import fitting as tfit
from biahub_tpu_torch.transforms import graph_matching as tgm
from tests.test_torch_estimate_stabilization import ROOT

BEADS_YML = ROOT / "settings/example_estimate_stabilization_settings_xyz_beads.yml"
SHAPE = (32, 128, 128)


def drift(angles_deg, shift, shape=SHAPE) -> np.ndarray:
    """The output->input warp of a rigid drift about the volume's centre."""
    c = (np.asarray(shape) - 1) / 2
    rot = Rotation.from_euler("xyz", angles_deg, degrees=True).as_matrix()
    m = np.eye(4)
    m[:3, :3] = rot
    m[:3, 3] = c - rot @ c + np.asarray(shift)
    return m


def bead_positions(shape, n, seed, spacing=20.0) -> np.ndarray:
    """Up to ``n`` points at least ``spacing`` apart (NMS keeps them all),
    8 voxels from the border."""
    rng = np.random.default_rng(seed)
    pts = []
    for _ in range(50 * n):
        p = np.array([rng.uniform(8, s - 8) for s in shape])
        if all(np.linalg.norm(p - q) >= spacing for q in pts):
            pts.append(p)
            if len(pts) == n:
                break
    return np.stack(pts)


def render_frames(warps, shape=SHAPE, n=40, seed=0) -> np.ndarray:
    """(T, Z, Y, X) float32: Gaussian beads in integer counts over a
    background of ~20, frame t holding bead q at ``warps[t] @ q`` (each
    frame rendered anew, not warped)."""
    rng = np.random.default_rng(seed)
    pts = bead_positions(shape, n, seed)
    frames = []
    for w in warps:
        vol = np.zeros(shape, np.float64)
        moved = pts @ np.asarray(w)[:3, :3].T + np.asarray(w)[:3, 3]
        for p in moved:
            lo = np.maximum(np.floor(p).astype(int) - 5, 0)
            hi = np.minimum(np.floor(p).astype(int) + 6, shape)
            d2 = sum((((np.arange(a, b) - q) / sig) ** 2).reshape([-1 if i == ax else 1
                                                                   for i in range(3)])
                     for ax, (a, b, q, sig) in enumerate(zip(lo, hi, p, (1.2, 1.5, 1.5))))
            vol[tuple(slice(a, b) for a, b in zip(lo, hi))] += 1500.0 * np.exp(-0.5 * d2)
        frames.append(np.round(vol + rng.normal(20, 2, shape)).clip(0))
    return np.stack(frames).astype(np.float32)


def accelerator_warp(vol, matrix, output_shape, fill=0.0, order=1, input_xzy=False):
    """The reference's affine_warp_auto as it dispatches on the accelerator
    (affine.py:609-623): general order-1 matrices to the multipass warp."""
    m = np.asarray(matrix, dtype=np.float64)
    if order == 1 and not jaff.is_inplane_matrix(m) and not input_xzy:
        try:
            return multipass_affine_warp_zyx(vol, m, tuple(output_shape), fill=fill)
        except ValueError:
            pass
    return jaff.affine_warp_auto(vol, m, output_shape, fill=fill, order=order,
                                 input_xzy=input_xzy)


@pytest.fixture
def accelerator_route(monkeypatch):
    monkeypatch.setattr(jbeads, "affine_warp_auto", accelerator_warp)


def test_fits_match_the_reference():
    rng = np.random.default_rng(1)
    src = rng.random((25, 3)) * 50
    dst = src @ drift([4, -3, 2], [1, -2, 0.5])[:3, :3].T * 1.02 + [2.0, -1.0, 3.0]
    dst += rng.normal(0, 0.1, dst.shape)
    for kind in ("affine", "euclidean", "similarity"):
        np.testing.assert_array_equal(tfit.fit_transform(src, dst, kind),
                                      jfit.fit_transform(src, dst, kind))
    with pytest.raises(ValueError, match="Unknown transform type"):
        tfit.fit_transform(src, dst, "projective")


def test_sorted_assignment_costs_equal_the_dp_for_every_pair():
    rng = np.random.default_rng(2)
    mov = [np.sort(rng.random(n) * 30) for n in rng.integers(0, 9, 40)]
    ref = [np.sort(rng.random(n) * 30) for n in rng.integers(0, 9, 35)]
    got = tgm.sorted_assignment_costs(mov, ref, 1e6)
    assert got.dtype == np.float32
    for i, a in enumerate(mov):
        for j, b in enumerate(ref):
            want = 1e6 if not len(a) or not len(b) else jgm._sorted_assignment_cost(a, b)
            assert got[i, j] == np.float32(want)


def bead_peaks(seed=3, n=60):
    rng = np.random.default_rng(seed)
    ref = rng.uniform(0, 100, (n, 3)).round()
    mov = ref[rng.permutation(n)[: n - 5]] + [1.0, -2.0, 1.5]
    mov += rng.normal(0, 0.3, mov.shape)
    return np.vstack([mov, rng.uniform(0, 100, (4, 3))]).round(), ref


@pytest.mark.parametrize("mode", ["knn", "radius"])
def test_cost_matrix_equals_the_reference(mode):
    """The radius graphs' neighbour lists have every length, the knn ones
    k: both through the same DP."""
    mov, ref = bead_peaks()
    kw = {"k": 5} if mode == "knn" else {"radius": 25.0}
    tg = [tgm.Graph.from_nodes(p, mode=mode, **kw) for p in (mov, ref)]
    jg = [jgm.Graph.from_nodes(p, mode=mode, **kw) for p in (mov, ref)]
    lengths = {len(v) for v in tg[0].neighbor_map.values()}
    assert len(lengths) > 1 if mode == "radius" else lengths == {5}
    weights = {"dist": 0.5, "edge_length": 1.0, "pca_dir": 0.3, "pca_aniso": 0.2,
               "edge_descriptor": 0.1}
    got = tgm.GraphMatcher(weights=weights).compute_cost_matrix(*tg)
    want = jgm.GraphMatcher(weights=weights).compute_cost_matrix(*jg)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("algorithm", ["hungarian", "match_descriptor"])
def test_matches_equal_the_reference(algorithm):
    mov, ref = bead_peaks(seed=4)
    d = {"algorithm": algorithm, "filter_matches_settings": {"direction_threshold": 30},
         "hungarian_match_settings": {"cross_check": True, "max_ratio": 0.9}}
    want = jbeads.matches_from_beads(mov, ref, BeadsMatchSettings(**d))
    got = tbeads.matches_from_beads(mov, ref, tbeads.beads_match_settings_from_reference(d))
    assert len(want) >= 10
    np.testing.assert_array_equal(got, want)


PEAKS = {"threshold_abs": 110, "nms_distance": 16, "min_distance": 0, "block_size": [8, 8, 8]}
TRUTH = [drift([0, 0, 0], [0, 0, 0]), drift([0.6, -0.4, 0.8], [0.8, -1.5, 2.0]),
         drift([-0.5, 0.7, -0.6], [-1.2, 2.5, -0.7])]


def assert_near_truth(w, truth):
    np.testing.assert_allclose(np.asarray(w)[:3, 3], truth[:3, 3], atol=0.5)
    np.testing.assert_allclose(np.asarray(w)[:3, :3], truth[:3, :3], atol=0.05)


def test_estimate_matches_the_reference(accelerator_route, tmp_path):
    frames = render_frames(TRUTH[:2])
    bms = {"source_peaks_settings": PEAKS, "target_peaks_settings": PEAKS}
    ats = {"transform_type": "euclidean"}
    want = jbeads.estimate(frames[1], frames[0], BeadsMatchSettings(**bms),
                           AffineTransformSettings(**ats))
    got = tbeads.estimate(frames[1], frames[0], bms, ats, device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    assert_near_truth(got, TRUTH[1])
    assert not np.allclose(got, np.eye(4))
    assert tbeads.estimate(np.zeros(SHAPE, np.float32), frames[0], bms, ats,
                           device="cpu") is None
    jbeads.estimate(frames[1], frames[0], BeadsMatchSettings(**bms),
                    AffineTransformSettings(**ats), output_filepath=tmp_path / "ref.npy")
    tbeads.estimate(frames[1], frames[0], bms, ats, output_filepath=tmp_path / "port.npy",
                    device="cpu")
    np.testing.assert_allclose(np.load(tmp_path / "port.npy"), np.load(tmp_path / "ref.npy"),
                               rtol=0, atol=1e-9)


def beads_settings() -> dict:
    d = yaml.safe_load(BEADS_YML.read_text())
    d["beads_match_settings"].update(source_peaks_settings=PEAKS, target_peaks_settings=PEAKS)
    return d


def reference_stabilization(tczyx, d):
    s = EstimateStabilizationSettings(**copy.deepcopy(d))
    return jbeads.estimate_tczyx(tczyx, tczyx, 0, 0, s.beads_match_settings,
                                 s.affine_transform_settings, mode="stabilization")


def test_estimate_tczyx_stabilization_matches_the_reference(accelerator_route):
    tczyx = render_frames(TRUTH)[:, None]
    d = beads_settings()
    want = reference_stabilization(tczyx, d)
    got = tbeads.estimate_tczyx(tczyx, tczyx, 0, 0, d["beads_match_settings"],
                                d["affine_transform_settings"], mode="stabilization",
                                device="cpu")
    assert len(got) == 3 and got[0] == np.eye(4).tolist()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    for w, truth in zip(got, TRUTH):
        assert_near_truth(w, truth)


def test_beads_branch_of_estimate_stabilization_matches_the_reference(accelerator_route):
    tczyx = render_frames(TRUTH[:2], seed=5)[:, None]
    d = beads_settings()
    want = reference_stabilization(tczyx, d)
    got = estimate_stabilization_arrays(
        {"A/1/0": ArrayPosition(tczyx, [1.0] * 5, ["GFP"]),
         "B/1/0": ArrayPosition(np.zeros_like(tczyx), [1.0] * 5, ["GFP"])},
        d, device="cpu")
    assert list(got) == ["xyz"] and list(got["xyz"]) == ["A_1_0"]
    np.testing.assert_allclose(got["xyz"]["A_1_0"], want, rtol=0, atol=1e-9)
    assert_near_truth(got["xyz"]["A_1_0"][1], TRUTH[1])
