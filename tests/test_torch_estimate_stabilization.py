"""The port's estimate-stabilization on arrays (focus finding, transform QC,
the settings reader and the dispatch) against biahub_tpu's.

Both packages get the same :class:`ArrayPosition` of seeded numpy data. The
reference's per-position functions run on its XLA route (its PCC kernels'
Pallas route is held to the port in tests/test_torch_pcc.py). Tolerances:
PCC transforms are integers and must be equal; subpixel xy shifts within
1e-4 px (a parabola through correlation values that differ in the last
ulps); the focus metric within 1e-5 of max |ref|; focus indices equal.
"""

import glob
import pathlib

import numpy as np
import pandas as pd
import pytest
import scipy.ndimage as ndi
import torch
import yaml

from biahub_tpu import estimate_stabilization as jes
from biahub_tpu.kernels import focus as jfocus
from biahub_tpu.registration.utils import evaluate_transforms as j_evaluate
from biahub_tpu.settings import (
    EstimateStabilizationSettings,
    FocusFindingSettings,
    PhaseCrossCorrSettings,
)
from biahub_tpu_torch import (
    ArrayPosition,
    estimate_stabilization_arrays,
    stabilization_settings_from_reference,
)
from biahub_tpu_torch import estimate_stabilization as tes
from biahub_tpu_torch.kernels import focus as tfocus
from biahub_tpu_torch.registration.utils import evaluate_transforms as t_evaluate

ROOT = pathlib.Path(__file__).resolve().parents[1]
CHANNELS = ["BF", "GFP"]
SCALE = [1.0, 1.0, 0.5, 0.2, 0.2]


def focus_stack(focus_z, drift_yx, shape=(9, 48, 40), seed=1):
    """A (Z, Y, X) stack whose sharpest slice is ``focus_z``, shifted by
    ``drift_yx`` (as tests/test_stabilization.py's focus test)."""
    sharp = np.random.default_rng(seed).random(shape[1:]).astype(np.float32)
    vol = np.stack([ndi.gaussian_filter(sharp, abs(z - focus_z) * 1.2 + 0.1)
                    for z in range(shape[0])])
    return np.roll(vol, drift_yx, axis=(1, 2)).astype(np.float32)


def focus_position(focus, drifts, seed=1) -> ArrayPosition:
    vols = np.stack([focus_stack(f, d, seed=seed) for f, d in zip(focus, drifts)])
    data = np.stack([vols * 0.5, vols], axis=1)  # (T, C, Z, Y, X)
    return ArrayPosition(data, SCALE, CHANNELS)


def drift_position(drifts, shape=(12, 32, 40), seed=3) -> ArrayPosition:
    base = ndi.uniform_filter(np.random.default_rng(seed).random(shape).astype(np.float32), 3)
    vols = np.stack([np.roll(base, d, axis=(0, 1, 2)) for d in drifts])
    return ArrayPosition(np.stack([vols, vols], axis=1), SCALE, CHANNELS)


def settings(kind, method, **blocks) -> dict:
    return {"stabilization_estimation_channel": "GFP", "stabilization_channels": ["GFP"],
            "stabilization_type": kind, "stabilization_method": method, **blocks}


# -- focus ------------------------------------------------------------------


def test_focus_matches_reference():
    pos = focus_position([4, 2, 6], [(0, 0)] * 3)
    tzyx = pos.data[:, 1]
    want = np.asarray(jfocus.midband_power_zyx(tzyx[0], pixel_size=0.2))
    got = tfocus.midband_power_zyx(torch.from_numpy(tzyx[0]), pixel_size=0.2).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    np.testing.assert_array_equal(
        tfocus.focus_from_transverse_band_tzyx(tzyx, pixel_size=0.2, device="cpu"),
        jfocus.focus_from_transverse_band_tzyx(tzyx, pixel_size=0.2))
    for mode in ("max", "min"):
        assert tfocus.focus_from_transverse_band(
            tzyx[1], pixel_size=0.2, mode=mode, device="cpu"
        ) == jfocus.focus_from_transverse_band(tzyx[1], pixel_size=0.2, mode=mode)
    for degenerate in (np.zeros((5, 16, 16)), np.ones((1, 16, 16))):
        assert tfocus.focus_from_transverse_band(degenerate, device="cpu") == 0


def test_fill_focus_matches_pandas():
    for focus in ([0, 4, 0, 6, 5], [3, 0, 0, 7], [0, 0, 2]):
        want = pd.Series(focus).replace(0, np.nan).ffill().fillna(
            pd.Series(focus).mean()).astype(int).to_list()
        assert tes._fill_focus(focus) == want


# -- transform QC -------------------------------------------------------------


@pytest.mark.parametrize("interpolation_type", ["linear", "cubic"])
def test_evaluate_transforms_interpolates_an_outlier(interpolation_type):
    """As tests/test_stabilization.py:67, against the reference's result."""
    rng = np.random.default_rng(5)
    transforms = []
    for _ in range(12):
        m = np.eye(4)
        m[:3, 3] = rng.normal(0, 0.3, 3)
        transforms.append(m.tolist())
    bad = np.eye(4)
    bad[0, 3] = 500.0
    transforms[7] = bad.tolist()
    kw = dict(shape_zyx=(10, 50, 50), validation_window_size=4, validation_tolerance=10.0,
              interpolation_window_size=3, interpolation_type=interpolation_type)
    want = j_evaluate([list(map(list, t)) for t in transforms], **kw)
    got = t_evaluate([list(map(list, t)) for t in transforms], **kw)
    assert abs(np.asarray(got[7])[0, 3]) < 1.0
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=1e-12)


# -- settings ------------------------------------------------------------------

EXAMPLES = sorted(glob.glob(str(ROOT / "settings/example_estimate_stabilization_settings_*.yml")))


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: pathlib.Path(p).stem)
def test_settings_reader_matches_the_reference_model(path):
    d = yaml.safe_load(open(path))
    got = stabilization_settings_from_reference(d)
    assert stabilization_settings_from_reference(got) == got
    assert got == EstimateStabilizationSettings(**d).model_dump()
    if d["stabilization_method"] == "beads":
        # The beads branch runs (tests/test_torch_beads.py holds it to the
        # reference); a single timepoint is its own reference.
        pos = drift_position([(0, 0, 0)])
        assert estimate_stabilization_arrays({"A/1/0": pos}, d, device="cpu") == {
            "xyz": {"A_1_0": [np.eye(4).tolist()]}}


@pytest.mark.parametrize("bad,match", [
    ({"phase_cross_corr_settings": {"normalisation": "magnitude"}}, "unknown fields"),
    ({"phase_cross_corr_settings": {"t_reference": "last"}}, "must be one of"),
    ({"stabilization_method": "ants"}, "must be one of"),
    ({"stack_reg_settings": {"center_crop_xy": "800"}}, "list of integers"),
    ({"verbose": "maybe"}, "want bool"),
    ({"eval_transform_settings": {"validation_window_size": 2.5}}, "want int"),
])
def test_settings_reader_refuses_what_the_model_refuses(bad, match):
    d = {**settings("xyz", "phase-cross-corr"), **bad}
    with pytest.raises(ValueError, match=match):
        stabilization_settings_from_reference(d)
    with pytest.raises(ValueError):
        EstimateStabilizationSettings(**d)
    with pytest.raises(ValueError, match="required"):
        stabilization_settings_from_reference({"stabilization_type": "z"})


def test_settings_reader_coerces_as_the_model_does():
    d = settings("xyz", "phase-cross-corr", verbose="yes",
                 phase_cross_corr_settings={"maximum_shift": "2"},
                 eval_transform_settings={"validation_window_size": 4.0})
    assert stabilization_settings_from_reference(d) == \
        EstimateStabilizationSettings(**d).model_dump()


# -- estimate_stabilization_arrays against the reference's per-position functions

DRIFTS = [(0, 0, 0), (1, 2, -1), (2, -2, 3), (0, 4, 2), (-1, -3, -2)]


@pytest.mark.parametrize("t_reference", ["first", "previous"])
@pytest.mark.parametrize("function_type", ["custom", "custom_padding"])
def test_xyz_pcc_matches_reference(t_reference, function_type):
    pos = drift_position(DRIFTS)
    pcc = {"normalization": "magnitude", "t_reference": t_reference,
           "function_type": function_type, "Z_slice": [1, 11], "X_slice": [2, 38]}
    evals = {"validation_window_size": 3, "validation_tolerance": 1000.0,
             "interpolation_window_size": 3, "interpolation_type": "linear"}
    got = estimate_stabilization_arrays(
        {"A/1/0": pos}, settings("xyz", "phase-cross-corr", phase_cross_corr_settings=pcc,
                                 eval_transform_settings=evals), device="cpu")
    want = jes.estimate_xyz_stabilization_pcc_per_position(
        pos, "A_1_0", 1, PhaseCrossCorrSettings(**pcc))
    want = j_evaluate(want, (12, 32, 40), 3, 1000.0, 3, "linear")
    assert got == {"xyz": {"A_1_0": want}}
    if function_type == "custom":
        np.testing.assert_array_equal(np.asarray(want)[:, :3, 3], DRIFTS)
    # A budget of one pair per chunk runs the same pairs.
    few = tes.estimate_xyz_stabilization_pcc_per_position(
        pos, "A_1_0", 1, stabilization_settings_from_reference(
            settings("xyz", "phase-cross-corr", phase_cross_corr_settings=pcc)
        )["phase_cross_corr_settings"], max_batch_bytes=1, device="cpu")
    assert few == jes.estimate_xyz_stabilization_pcc_per_position(
        pos, "A_1_0", 1, PhaseCrossCorrSettings(**pcc))


FOCUS = [4, 5, 3, 4]
XY_DRIFTS = [(0, 0), (2, -1), (-1, 3), (1, 1)]


def reference_focus(positions: dict, crop) -> pd.DataFrame:
    return pd.concat([
        jes.estimate_z_focus_per_position(pos, key.replace("/", "_"), 1, crop)
        for key, pos in positions.items()
    ]).sort_values(["position", "time_idx"])


def test_z_focus_finding_matches_reference(tmp_path):
    positions = {"A/1/0": focus_position(FOCUS, XY_DRIFTS),
                 "B/2/0": focus_position([5, 0, 4, 6], XY_DRIFTS, seed=2)}
    df = reference_focus(positions, [32, 32])
    rows = [r for key, pos in positions.items() for r in tes.estimate_z_focus_per_position(
        pos, key.replace("/", "_"), 1, [32, 32], device="cpu")]
    assert rows == df.to_dict("records")
    csv = tmp_path / "positions_focus.csv"
    df.to_csv(csv, index=False)
    for average, method in ((False, "mean"), (True, "mean"), (True, "median")):
        ff = {"average_across_wells": average, "average_across_wells_method": method,
              "center_crop_xy": [32, 32]}
        got = estimate_stabilization_arrays(
            positions, settings("z", "focus-finding", focus_finding_settings=ff),
            device="cpu")
        if average:
            mean = jes.get_mean_z_positions(csv, method=method)
            want = {"average": jes._z_transforms_from_focus(list(mean)).tolist()}
        else:
            want = {key.replace("/", "_"): jes._z_transforms_from_focus(
                df[df["position"] == key]["focus_idx"].tolist()).tolist()
                for key in positions}
        assert got == {"z": want}


@pytest.mark.parametrize("kind", ["xy", "xyz"])
def test_xy_and_xyz_focus_finding_match_reference(kind):
    pos = focus_position(FOCUS, XY_DRIFTS)
    ff = FocusFindingSettings(center_crop_xy=[40, 32])
    stack_reg = {"center_crop_xy": [32, 32], "t_reference": "previous",
                 "focus_finding_settings": ff.model_dump()}
    blocks = {"stack_reg_settings": stack_reg}
    if kind == "xyz":
        blocks["focus_finding_settings"] = ff.model_dump()
    got = estimate_stabilization_arrays({"A/1/0": pos}, settings(kind, "focus-finding",
                                                                 **blocks), device="cpu")
    focus = reference_focus({"A/1/0": pos}, [40, 32])["focus_idx"].tolist()
    assert focus == FOCUS
    xy = jes.estimate_xy_stabilization_per_position(pos, focus, 1, [32, 32], "previous")
    np.testing.assert_allclose(xy[:, 1:3, 3], XY_DRIFTS, atol=0.3)
    want = {"xy": xy}
    if kind == "xyz":
        z = jes._z_transforms_from_focus(focus)
        want = {"xyz": np.asarray([a @ b for a, b in zip(xy, z)]), "z": z, "xy": xy}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]["A_1_0"]), want[k], rtol=0, atol=1e-4)
