"""The port's estimate-psf (``extract_beads``, ``estimate_psf_arrays``)
against biahub_tpu's.

The reference's ``estimate-psf`` verb runs through click's ``CliRunner`` on
a tiny two-position bead plate written to a temporary directory; the port
takes the same positions as arrays. Tolerance: patches equal; the PSF
within 1e-6 (float32 peak normalization and mean in another summation
order than numpy's).
"""

import numpy as np
import pytest
import yaml
from click.testing import CliRunner
from scipy.ndimage import gaussian_filter

from biahub_tpu.cli.main import cli
from biahub_tpu.io.ngff import TransformationMeta, open_ome_zarr
from biahub_tpu.psf import analysis as janalysis
from biahub_tpu_torch.estimate_psf import estimate_psf_arrays
from biahub_tpu_torch.psf import analysis as tanalysis

SCALE = (0.2, 0.1, 0.1)
SHAPE = (40, 192, 192)


def beads(seed: int) -> np.ndarray:
    """Six beads, one in each of six (64, 64, 32) detection blocks and 64
    voxels apart (estimate-psf's min_distance is 50), in integer counts."""
    rng = np.random.default_rng(seed)
    vol = np.zeros(SHAPE, np.float32)
    for y in (64, 128):
        for x in (32, 96, 160):
            vol[tuple(np.array([16, y, x]) + rng.integers(-3, 4, 3))] = 5000.0
    vol = gaussian_filter(vol, (1.2, 1.8, 1.8)) * 30
    return np.round(vol + rng.normal(10, 1, SHAPE)).astype(np.float32)


def test_extract_beads_and_noise_level_match_the_reference():
    vol = beads(0)
    points = [(16, 40, 40), (1, 15, 15), (20, 60, 30), (16, 190, 50)]
    for size in (None, (1.0, 0.9, 0.9)):
        got, got_off = tanalysis.extract_beads(vol, points, SCALE, patch_size=size)
        want, want_off = janalysis.extract_beads(vol, points, SCALE, patch_size=size)
        assert got_off == want_off and len(got) == len(want) == 2
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert tanalysis.compute_noise_level(vol, points, (5, 9, 9)) == \
        janalysis.compute_noise_level(vol, points, (5, 9, 9))


def test_estimate_psf_matches_the_reference_verb(tmp_path):
    vols = [beads(1), beads(2)]
    plate_path = tmp_path / "beads.zarr"
    plate = open_ome_zarr(plate_path, layout="hcs", mode="w", channel_names=["GFP"])
    for i, vol in enumerate(vols):
        pos = plate.create_position("0", str(i), "0")
        pos.create_image("0", vol[None, None], transform=[
            TransformationMeta(type="scale", scale=(1, 1) + SCALE)])
    config = {"axis0_patch_size": 9, "axis1_patch_size": 15, "axis2_patch_size": 15}
    config_path = tmp_path / "psf_params.yml"
    config_path.write_text(yaml.dump(config))
    out_path = tmp_path / "psf.zarr"
    result = CliRunner().invoke(cli, [
        "estimate-psf", "-i", str(plate_path / "0/0/0"), str(plate_path / "0/1/0"),
        "-c", str(config_path), "-o", str(out_path)])
    assert result.exit_code == 0, result.output
    want = np.asarray(open_ome_zarr(out_path)["0/0/0"].data[0, 0])
    got = estimate_psf_arrays(np.stack(vols), SCALE, (9, 15, 15), device="cpu").numpy()
    assert got.shape == want.shape == (9, 15, 15) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="No beads"):
        estimate_psf_arrays(np.zeros((1,) + SHAPE, np.float32), SCALE, (9, 15, 15),
                            device="cpu")
