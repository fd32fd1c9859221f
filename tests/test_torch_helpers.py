"""The port's small public helpers against biahub_tpu's, one case each.

Matrices, crops, frame indices, sizes and the merged settings equal the
reference's exactly; the console helpers print the same lines (standard
output is not a terminal here, so no color); ``plot_bleaching_curves``
prints the reference's fit lines with the statistics on the card's route
(here the CPU's), and writes its plot where matplotlib is installed.
"""

import threading

import numpy as np
import pytest
import torch
import yaml

from biahub_tpu import estimate_bleaching as jbleach
from biahub_tpu.cli import disk as jdisk
from biahub_tpu.cli import monitor as jmonitor
from biahub_tpu.cli import printing as jprinting
from biahub_tpu.cli import slurm as jslurm
from biahub_tpu.cli import utils as jutils
from biahub_tpu.kernels import affine as jaff
from biahub_tpu.registration import utils as jregutils
from biahub_tpu.settings import EstimateRegistrationSettings
from biahub_tpu.transforms import lir as jlir
from biahub_tpu_torch import estimate_bleaching as tbleach
from biahub_tpu_torch.cli import disk as tdisk
from biahub_tpu_torch.cli import monitor as tmonitor
from biahub_tpu_torch.cli import printing as tprinting
from biahub_tpu_torch.cli import slurm as tslurm
from biahub_tpu_torch.cli import utils as tutils
from biahub_tpu_torch.convert import registration_estimate_settings_from_reference
from biahub_tpu_torch.kernels import affine as taff
from biahub_tpu_torch.registration import utils as tregutils
from biahub_tpu_torch.transforms import lir as tlir

RNG = np.random.default_rng(0)


def matrices(tmp_path, capsys):
    for args in ((30.0, 0), (-12.5, 1, (4.0, 10.0, 7.5)), (90.0, 2, [1, 2, 3])):
        np.testing.assert_array_equal(taff.rotation_matrix_zyx(*args),
                                      jaff.rotation_matrix_zyx(*args))
    np.testing.assert_array_equal(taff.scale_matrix_zyx((0.5, 2, 3.25)),
                                  jaff.scale_matrix_zyx((0.5, 2, 3.25)))
    for flip in ((False, False, False), (True, False, True), (False, True, False)):
        np.testing.assert_array_equal(taff.flip_matrix_zyx((5, 8, 9), flip),
                                      jaff.flip_matrix_zyx((5, 8, 9), flip))


def load_transforms(tmp_path, capsys):
    for name in ("A_1_0", "B_2_0", "0"):
        np.save(tmp_path / f"{name}.npy", RNG.random((3, 4, 4)))
    (tmp_path / "notes.txt").write_text("x")
    got, want = tregutils.load_transforms(tmp_path), jregutils.load_transforms(tmp_path)
    assert list(got) == list(want) == ["0", "A_1_0", "B_2_0"]
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    assert list(tregutils.load_transforms(tmp_path, "A*")) == ["A_1_0"]


def update_model(tmp_path, capsys):
    settings = yaml.safe_load(open("settings/example_estimate_registration_settings_beads.yml"))
    update = {"verbose": True, "affine_transform_settings": {"transform_type": "similarity"},
              "beads_match_settings": {"algorithm": "match_descriptor"},
              "source_channel_name": "BF"}
    want = jutils.update_model(EstimateRegistrationSettings(**settings), update)
    got = tutils.update_model(registration_estimate_settings_from_reference(settings), update)
    assert got == want.model_dump()


def crops(tmp_path, capsys):
    zyx = RNG.random((6, 9, 11)).astype(np.float32)
    zyx[1, 2, 3] = np.nan
    zyx[[0, 4]] = 0
    zyx[5] = np.nan
    slicing = [slice(0, 5), slice(1, 8), slice(2, 10)]
    want = jutils.copy_n_paste(zyx, slicing)
    np.testing.assert_array_equal(tutils.copy_n_paste(zyx, slicing), want)
    np.testing.assert_array_equal(tutils.copy_n_paste(torch.from_numpy(zyx), slicing).numpy(),
                                  want)
    czyx = np.stack([zyx, zyx + 1])
    np.testing.assert_array_equal(tutils.copy_n_paste_czyx(czyx, slicing),
                                  jutils.copy_n_paste_czyx(czyx, slicing))
    assert tutils.get_empty_frame_indices(zyx) == jutils.get_empty_frame_indices(zyx) == [0, 4, 5]
    assert tutils.get_empty_frame_indices(torch.from_numpy(zyx)) == [0, 4, 5]
    with pytest.raises(ValueError, match="must be 3D"):
        tutils.get_empty_frame_indices(czyx)


def size_bytes(tmp_path, capsys):
    (tmp_path / "d").mkdir()
    (tmp_path / "d" / "a.bin").write_bytes(b"x" * 5000)
    (tmp_path / "b.bin").write_bytes(b"y" * 123)
    for path in (tmp_path, tmp_path / "b.bin", tmp_path / "d"):
        assert tdisk.get_size_bytes(path) == jdisk.get_size_bytes(path)


def jobs(tmp_path, capsys):
    outputs = []
    for slurm, monitor in ((jslurm, jmonitor), (tslurm, tmonitor)):
        job = monitor.JobLike("p")
        assert (job.name, job.state, job.error, job.done()) == ("p", "PENDING", None, False)
        job.cancel()
        assert job.state == "CANCELLED" and job.done()
        done = monitor.JobLike("q")
        done.state = "COMPLETED"
        done.cancel()
        assert done.state == "COMPLETED"
        late = monitor.JobLike("r")
        timer = threading.Timer(0.1, lambda: setattr(late, "state", "DONE"))
        timer.start()
        slurm.wait_for_jobs_to_finish([job, late, object()], poll_seconds=0.02)
        timer.join(timeout=5)
        assert not timer.is_alive()
        outputs.append(capsys.readouterr().out)
    assert outputs[1] == outputs[0] == "2/3 jobs finished\n3/3 jobs finished\n"


def console(tmp_path, capsys):
    settings = {"a": 1, "b": [0.5, 2], "c": None}

    class Model:
        def model_dump(self):
            return settings

    jprinting.echo_headline("Headline")
    jprinting.echo_settings(Model())
    want = capsys.readouterr().out
    tprinting.echo_headline("Headline")
    tprinting.echo_settings(settings)
    assert capsys.readouterr().out == want == "Headline\n  a: 1\n  b: [0.5, 2]\n  c: None\n"


def bleaching_curves(tmp_path, capsys):
    times = np.arange(8, dtype=np.float32) * 10
    decay = 100 * np.exp(-times / np.array([[30.0], [55.0]])).T + 20  # (T, C)
    tczyx = decay[:, :, None, None, None] * (1 + 0.01 * RNG.standard_normal((8, 2, 3, 8, 6)))
    jbleach.plot_bleaching_curves(times, tczyx, ["GFP", "mCherry"], tmp_path / "ref.svg", "t")
    want = capsys.readouterr().out
    tbleach.plot_bleaching_curves(times, tczyx, ["GFP", "mCherry"], tmp_path / "port.svg", "t",
                                  device="cpu")
    assert capsys.readouterr().out == want
    assert (tmp_path / "port.svg").exists() == (tmp_path / "ref.svg").exists()


def lir_alias(tmp_path, capsys):
    mask = RNG.random((30, 25)) < 0.9
    assert tlir.lir(mask) == tuple(jlir.lir(mask))


CASES = {f.__name__: f for f in (matrices, load_transforms, update_model, crops, size_bytes,
                                 jobs, console, bleaching_curves, lir_alias)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_helper_equals_the_reference(name, tmp_path, capsys):
    CASES[name](tmp_path, capsys)
