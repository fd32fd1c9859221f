"""biahub_tpu_torch's virtual-stain against biahub_tpu's.

- ``normalize_with_stats`` with the store's statistics and without them (the
  volume's median and IQR, on an even count: NumPy averages the middle two)
  bit-equal;
- ``sliding_window_predict`` with one shared predict function (NumPy,
  direction-dependent so rotations count; the port's side wraps it for
  tensors): a step of 2, a model that emits fewer slices than its window
  (the step clamped, with the reference's line), a stack shallower than the
  window, and rotation TTA on a non-square plane; bit-equal;
- the verb against the reference verb (click's runner) on one checkpoint file
  that both load, ``fcmae`` and ``2.5D``, on a two-timepoint plate whose Y
  and X need padding: within 1e-5 * max|ref|, the attributes equal, and the
  port's plate bit-equal to ``virtual_stain_arrays``;
- the TorchScript route on both, ``--init`` (the plate created, the same
  stdout as the reference's, which prints no ``RESOURCES:`` line) and the
  reference's errors.
"""

import json

import numpy as np
import pytest
import torch
import yaml
from click.testing import CliRunner

from biahub_tpu import virtual_stain as reference_vs
from biahub_tpu.cli.main import cli as reference_cli
from biahub_tpu.io.ngff import open_ome_zarr as reference_open
from biahub_tpu.models.torch_twin import TorchUNet25D, TorchUNeXt2
from biahub_tpu_torch import virtual_stain as vs
from biahub_tpu_torch.cli.main import main
from biahub_tpu_torch.cli.parsing import CommandError
from biahub_tpu_torch.io.ngff import TransformationMeta, open_ome_zarr

SHAPE = (2, 2, 9, 20, 24)  # T, C, Z, Y, X: Y and X pad to the encoder's 32
UNEXT2 = {"in_channels": 1, "out_channels": 2, "in_stack_depth": 5,
          "encoder_blocks": [1, 1, 1, 1], "dims": [8, 16, 32, 64], "decoder_conv_blocks": 1,
          "stem_kernel_size": [5, 4, 4]}
UNET25D = {"in_channels": 1, "out_channels": 2, "in_stack_depth": 5, "out_stack_depth": 1,
           "num_filters": [4, 8]}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's side on one torch thread: the suite runs several test
    processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_normalize_with_stats():
    zyx = np.random.default_rng(0).gamma(2.0, 3.0, (4, 6, 10)).astype(np.float32)
    assert zyx.size % 2 == 0
    for meta in (None, {}, {"median": 2.5, "iqr": 4.0}, {"median": 1.0}):
        np.testing.assert_array_equal(vs.normalize_with_stats(zyx, meta),
                                      reference_vs.normalize_with_stats(zyx, meta))


def shared_predict(c_out: int, z_out: int):
    """A (C, Z, Y, X) -> (c_out, z_out, Y, X) NumPy function whose output
    depends on direction (a cumulative sum along X), so rotations matter."""
    def fn(window: np.ndarray) -> np.ndarray:
        z = window.shape[1]
        start = (z - z_out) // 2
        core = np.cumsum(window[:, start:start + z_out], axis=-1, dtype=np.float32)
        return np.stack([core.sum(axis=0) * np.float32(k + 1) for k in range(c_out)])
    return fn


@pytest.mark.parametrize("window_z, z_out, step, tta, shape", [
    (5, 5, 2, False, (1, 11, 6, 8)),
    (5, 3, 4, False, (2, 12, 6, 8)),
    (7, 7, 1, False, (1, 4, 6, 8)),
    (5, 5, 3, True, (1, 9, 6, 10)),
], ids=["step", "narrow_output", "shallow_stack", "tta_non_square"])
def test_sliding_window_predict_matches_the_reference(window_z, z_out, step, tta, shape,
                                                       capsys):
    czyx = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    fn = shared_predict(2, min(z_out, shape[1]))
    want = reference_vs.sliding_window_predict(fn, czyx, window_z, step=step, rotation_tta=tta)
    ref_text = capsys.readouterr().out
    got = vs.sliding_window_predict(lambda w: torch.from_numpy(fn(w.numpy())),
                                    torch.from_numpy(czyx), window_z, step=step,
                                    rotation_tta=tta)
    assert capsys.readouterr().out == ref_text
    np.testing.assert_array_equal(got.numpy(), want)


def write_plate(path) -> np.ndarray:
    data = np.random.default_rng(2).gamma(2.0, 1.0, SHAPE).astype(np.float32)
    plate = open_ome_zarr(path, layout="hcs", mode="w", channel_names=["BF", "Phase3D"])
    position = plate.create_position("A", "1", "0")
    position.create_image("0", data, transform=[TransformationMeta(
        type="scale", scale=[1, 1, 2.0, 0.325, 0.325])])
    position.update_zattrs({"normalization": {"Phase3D": {"fov_statistics": {
        "median": 1.5, "iqr": 1.25}}}})
    return data


@pytest.fixture(scope="module")
def plate(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("virtual_stain")
    write_plate(tmp / "in.zarr")
    return tmp


def run_both(tmp, config: dict, name: str, extra=()):
    cfg = tmp / f"{name}.yml"
    cfg.write_text(yaml.safe_dump(json.loads(json.dumps(config))))
    position = str(tmp / "in.zarr/A/1/0")
    result = CliRunner().invoke(reference_cli, ["virtual-stain", "-i", position, "-c",
                                                str(cfg), "-o", str(tmp / f"ref_{name}.zarr"),
                                                *extra])
    assert result.exit_code == 0, result.output
    assert main(["virtual-stain", "-i", position, "-c", str(cfg), "-o",
                 str(tmp / f"port_{name}.zarr"), *extra], device="cpu") == 0
    return result.output


@pytest.mark.parametrize("arch", ["fcmae", "2.5D"])
def test_verb_matches_the_reference(plate, arch):
    torch.manual_seed(3)
    if arch == "fcmae":
        twin = TorchUNeXt2(**{k: tuple(v) if isinstance(v, list) else v
                              for k, v in UNEXT2.items()})
        model_config = UNEXT2
    else:
        twin = TorchUNet25D(**{k: tuple(v) if isinstance(v, list) else v
                               for k, v in UNET25D.items()})
        model_config = UNET25D
    ckpt = plate / f"{arch}.pth"
    torch.save(twin.state_dict(), ckpt)
    config = {"architecture": arch, "model_config": model_config, "ckpt_path": str(ckpt),
              "source_channel": "Phase3D", "output_channels": ["nuc", "mem"],
              "sliding_window_step": 2, "rotation_tta": arch == "fcmae"}
    run_both(plate, config, arch)
    want = reference_open(plate / f"ref_{arch}.zarr/A/1/0")
    got = open_ome_zarr(plate / f"port_{arch}.zarr/A/1/0", mode="r")
    pred = got.data[...]
    assert got.channel_names == ["nuc", "mem"] and pred.shape == SHAPE
    ref = np.asarray(want.data[...])
    np.testing.assert_allclose(pred, ref, atol=1e-5 * np.abs(ref).max(), rtol=0)
    assert got.zattrs == dict(want.zattrs)
    arrays = vs.virtual_stain_arrays(open_ome_zarr(plate / "in.zarr/A/1/0", mode="r").data[...],
                                     ["BF", "Phase3D"], config,
                                     norm_meta={"Phase3D": {"fov_statistics": {
                                         "median": 1.5, "iqr": 1.25}}}, device="cpu")
    np.testing.assert_array_equal(pred, arrays)


def test_torchscript_route_and_init(plate, capsys):
    class TinyStain(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = torch.nn.Conv3d(1, 2, kernel_size=(3, 1, 3), padding=(1, 0, 1))

        def forward(self, x):
            return self.conv(x)

    torch.manual_seed(4)
    ckpt = plate / "tiny.pt"
    torch.jit.script(TinyStain()).save(str(ckpt))
    config = {"ckpt_path": str(ckpt), "source_channel": "BF", "n_output_channels": 2,
              "sliding_window_z": 5, "sliding_window_step": 3, "output_channels": ["a", "b"]}
    run_both(plate, config, "script")
    ref = np.asarray(reference_open(plate / "ref_script.zarr/A/1/0").data[...])
    got = open_ome_zarr(plate / "port_script.zarr/A/1/0", mode="r").data[...]
    np.testing.assert_allclose(got, ref, atol=1e-6 * np.abs(ref).max(), rtol=0)

    capsys.readouterr()
    ref_text = run_both(plate, config, "init", extra=["--init"])
    assert capsys.readouterr().out == ref_text
    assert open_ome_zarr(plate / "port_init.zarr/A/1/0", mode="r").data.shape == (
        2, 2) + SHAPE[2:]


@pytest.mark.parametrize("config, fragment", [
    ({"architecture": "resnet", "ckpt_path": "x.pth"}, "unknown architecture"),
    ({"architecture": "fcmae"}, "ckpt_path"),
    ({"ckpt_path": "model.ckpt"}, "VisCy/cytoland is not installed"),
])
def test_errors_carry_the_reference_messages(config, fragment):
    with pytest.raises(CommandError) as got:
        vs.load_model(config, "cpu")
    with pytest.raises(Exception) as want:
        reference_vs._load_model(config)
    assert str(got.value) == want.value.message and fragment in str(got.value)
