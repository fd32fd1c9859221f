"""The port's ``registration.beads.optimize_matches`` against biahub_tpu's.

On a small rendered beads pair the port's chosen settings dict equals the
reference's ``model_dump()``, under the default grid (every trial scores
alike, so the first wins) and under a grid whose first trials find too few
matches and whose scores differ. Every trial's score (the overlap of its
warped peaks), and so the best, agrees within 1e-6. The reference runs with its
accelerator dispatch patched in (``accelerator_route``): on the CPU it
would warp general matrices by the exact gather, not the multipass warp.
A trial's host failure (too few or degenerate matches) is skipped; a
device error is not. The port on one torch thread.
"""

import numpy as np
import pytest
import torch

from biahub_tpu.registration import beads as jbeads
from biahub_tpu.settings import AffineTransformSettings, BeadsMatchSettings
from biahub_tpu_torch.registration import beads as tbeads
from tests.test_torch_beads import PEAKS, accelerator_route, drift, render_frames  # noqa: F401

SHAPE = (24, 80, 80)
APPROX = drift([0.3, -0.2, 0.4], [0.5, -1.0, 1.0], SHAPE)
ATS = {"transform_type": "affine"}
GRIDS = {
    "default": (None, {}),
    "cost": ({"cost_threshold": [0.01, 0.05, 0.1, 0.5], "weights_dist": [0.5, 1.0]},
             {"score_centroid_mask_radius": 1}),
}


@pytest.fixture(scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frames():
    truth = drift([0.6, -0.4, 0.8], [0.8, -1.5, 2.0], SHAPE)
    return render_frames([np.eye(4), truth], shape=SHAPE, n=25)


def settings(qc: dict) -> dict:
    return {"source_peaks_settings": PEAKS, "target_peaks_settings": PEAKS, "qc_settings": qc}


def recording(monkeypatch, beads) -> list:
    """The overlap score of each of ``beads``' trials, in order."""
    scores, score = [], beads.overlap_score

    def record(*args, **kwargs):
        scores.append(score(*args, **kwargs))
        return scores[-1]

    monkeypatch.setattr(beads, "overlap_score", record)
    return scores


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_chosen_settings_equal_the_reference(grid, frames, one_thread, accelerator_route,
                                             monkeypatch):
    param_grid, qc = GRIDS[grid]
    mov, ref = frames[1], frames[0]
    want_scores, got_scores = recording(monkeypatch, jbeads), recording(monkeypatch, tbeads)
    want = jbeads.optimize_matches(mov, ref, APPROX, BeadsMatchSettings(**settings(qc)),
                                   AffineTransformSettings(**ATS), param_grid=param_grid)
    got = tbeads.optimize_matches(mov, ref, APPROX, settings(qc), ATS, param_grid=param_grid,
                                  device="cpu")
    assert got == want.model_dump()
    if grid == "cost":
        hm = got["hungarian_match_settings"]
        assert (hm["cost_threshold"], hm["cost_matrix_settings"]["weights"]["dist"]) == (0.1, 0.5)
        assert len(set(got_scores)) > 1
    assert len(got_scores) == len(want_scores) > 0
    np.testing.assert_allclose(got_scores, want_scores, rtol=0, atol=1e-6)
    assert abs(max(got_scores) - max(want_scores)) <= 1e-6 and max(got_scores) > 0.8


def test_host_failures_are_skipped_and_device_errors_raised(frames, one_thread, monkeypatch):
    mov, ref = frames[1], frames[0]
    grid = {"k": [5, 10]}

    def degenerate(*args, **kwargs):
        raise np.linalg.LinAlgError("Singular matrix")

    with monkeypatch.context() as mp:
        mp.setattr(tbeads, "transform_from_matches", degenerate)
        got = tbeads.optimize_matches(mov, ref, APPROX, settings({}), ATS, param_grid=grid,
                                      verbose=True, device="cpu")
    assert got == tbeads.beads_match_settings_from_reference(settings({}))

    warp, calls = tbeads._warp, []

    def failing_warp(*args, **kwargs):
        calls.append(1)
        if len(calls) > 1:
            raise RuntimeError("warp_zy: CUDA error 700 (an illegal memory access)")
        return warp(*args, **kwargs)

    monkeypatch.setattr(tbeads, "_warp", failing_warp)
    with pytest.raises(RuntimeError, match="CUDA error"):
        tbeads.optimize_matches(mov, ref, APPROX, settings({}), ATS, param_grid=grid,
                                device="cpu")
    assert len(calls) == 2
