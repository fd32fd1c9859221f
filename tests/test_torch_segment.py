"""biahub_tpu_torch's segment verb and CPnet engine against biahub_tpu's.

- Otsu instance labels bit-equal (host NumPy/SciPy in both);
- the flow round trip (rendered masks -> ``masks_to_flows`` -> 5x flows):
  ``follow_flows``' positions within 1e-4 px of the reference's JAX
  integration on the same masked flows, and ``compute_masks`` labels equal,
  one slice at a time and for a volume at once (an empty slice included);
- the diameter resize against ``jax.image.resize(method="linear")``,
  shrinking and enlarging, at non-square sizes;
- ``cpnet_segment_czyx`` on one checkpoint file both packages load (the
  reference's torch twin, random BatchNorm statistics), with a rescale and
  IoU stitching: labels equal;
- the verb against the reference verb (click's runner) with a
  ``threshold_otsu`` model and a 2D CPnet model on one plate: arrays
  bit-equal, attributes equal;
- the refusals (``do_3D``, an unknown eval arg, a cellpose built-in name, a
  file that is not a CPnet checkpoint) with the reference's messages, and the
  settings reader against the reference model's dump.
"""

import json

import click
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from click.testing import CliRunner
from scipy.ndimage import gaussian_filter

from biahub_tpu import segment as reference_segment
from biahub_tpu.cli.main import cli as reference_cli
from biahub_tpu.io.ngff import open_ome_zarr as reference_open
from biahub_tpu.models.torch_twin import TorchCPnet
from biahub_tpu.segmentation import engine as reference_engine
from biahub_tpu.segmentation import flows as reference_flows
from biahub_tpu.settings import SegmentationSettings
from biahub_tpu_torch import segment
from biahub_tpu_torch.cli.main import main
from biahub_tpu_torch.cli.parsing import CommandError
from biahub_tpu_torch.convert import segmentation_settings_from_reference
from biahub_tpu_torch.io.ngff import TransformationMeta, open_ome_zarr
from biahub_tpu_torch.segmentation import engine, flows
from tests.test_cpnet import _blob_masks

NBASE = (2, 8, 16, 32, 64)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's side on one torch thread: the suite runs several test
    processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    torch.manual_seed(0)
    twin = TorchCPnet(nbase=NBASE).eval()
    with torch.no_grad():
        for m in twin.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.5, 0.5)
                m.running_var.uniform_(0.5, 2.0)
    path = tmp_path_factory.mktemp("cpnet") / "cpnet.pt"
    torch.save(twin.state_dict(), path)
    return str(path)


def _blobs(shape, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    vol = np.zeros(shape, np.float32)
    pts = np.stack([rng.integers(min(3, s // 3), s - min(3, s // 3), size=n) for s in shape],
                   axis=1)
    vol[tuple(pts.T)] = 50.0
    return gaussian_filter(vol, 1.5) + 0.01 * rng.random(shape).astype(np.float32)


def test_otsu_labels_are_bit_equal():
    zyx = _blobs((6, 40, 52), 8, seed=1)
    assert segment.otsu_threshold(zyx) == reference_segment.otsu_threshold(zyx)
    for min_size in (2, 20):
        want = reference_segment.threshold_instance_labels(zyx, min_size=min_size)
        got = segment.threshold_instance_labels(zyx, min_size=min_size)
        assert got.dtype == want.dtype and got.max() >= 1
        np.testing.assert_array_equal(got, want)


def test_flow_round_trip_matches_the_reference():
    masks = _blob_masks(96, 128)
    dP_net = flows.masks_to_flows(masks) * 5.0
    np.testing.assert_array_equal(dP_net, reference_flows.masks_to_flows(masks) * 5.0)
    cellprob = np.where(masks > 0, 4.0, -4.0).astype(np.float32)
    fg = cellprob > 0
    masked = (dP_net / 5.0) * fg[None]
    want = np.asarray(reference_flows.follow_flows(jnp.asarray(masked), jnp.asarray(fg),
                                                   niter=200))
    got = flows.follow_flows(torch.from_numpy(masked), torch.from_numpy(fg), niter=200)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    want_labels = reference_flows.compute_masks(dP_net, cellprob)
    np.testing.assert_array_equal(flows.compute_masks(dP_net, cellprob), want_labels)
    assert int(want_labels.max()) == int(masks.max())
    # A volume at once: the same labels per slice, an empty slice stays 0.
    vol_dP = np.stack([dP_net, dP_net[:, ::-1].copy(), dP_net])
    vol_dP[1, 0] *= -1
    vol_cp = np.stack([cellprob, cellprob[::-1].copy(), np.full_like(cellprob, -4.0)])
    got = flows.compute_masks_zyx(torch.from_numpy(vol_dP), torch.from_numpy(vol_cp))
    for z in range(3):
        np.testing.assert_array_equal(got[z], reference_flows.compute_masks(vol_dP[z],
                                                                            vol_cp[z]))
    assert got[2].max() == 0


@pytest.mark.parametrize("size", [(13, 29), (70, 45)], ids=["shrink", "enlarge"])
def test_resize_matches_jax_image_resize(size):
    x = np.random.default_rng(3).standard_normal((2, 2, 37, 23)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 2) + size, method="linear"))
    got = engine.resize_linear(torch.from_numpy(x), size).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)


def test_cpnet_segment_matches_the_reference(checkpoint):
    czyx = np.stack([_blobs((3, 64, 80), 12, seed=4), _blobs((3, 64, 80), 12, seed=5)])
    kwargs = dict(channels=(1, 2), diameter=40.0, niter=40, cellprob_threshold=0.0,
                  flow_threshold=None, stitch_threshold=0.2)
    want = reference_engine.cpnet_segment_czyx(czyx, checkpoint, **kwargs)
    got = engine.cpnet_segment_czyx(czyx, checkpoint, device="cpu", **kwargs)
    assert got.dtype == np.uint32 and got.shape == (3, 64, 80)
    assert want.max() > 0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("two_d", [False, True], ids=["3d", "2d"])
def test_segment_verb_matches_the_reference(tmp_path, checkpoint, capsys, two_d):
    plate = open_ome_zarr(tmp_path / "in.zarr", layout="hcs", mode="w",
                          channel_names=["GFP", "RFP"])
    data = np.stack([np.stack([_blobs((4, 48, 40), 6, seed=10 * t + c) for c in range(2)])
                     for t in range(2)])
    plate.create_position("A", "1", "0").create_image(
        "0", data, transform=[TransformationMeta(type="scale", scale=[1, 1, 1, 0.1, 0.1])])
    # Every model 2D (Z collapses to 1) or every model 3D: the reference
    # stacks the models' outputs, so it cannot mix them.
    z_slice = 1 if two_d else None
    config = {"models": {
        "nuclei": {"path_to_model": "threshold_otsu", "eval_args": {"min_size": 2},
                   "z_slice_2D": z_slice, "preprocessing": []},
        "cells": {"path_to_model": checkpoint, "z_slice_2D": z_slice,
                  "eval_args": {"channels": [1, 0], "diameter": 30, "niter": 20,
                                "flow_threshold": None if two_d else 0.4,
                                "batch_size": 8},
                  "preprocessing": [{"function": "np.sqrt", "channel": "1"}]},
    }}
    cfg = tmp_path / "seg.yml"
    cfg.write_text(yaml.safe_dump(config, sort_keys=False))
    position = str(tmp_path / "in.zarr/A/1/0")
    result = CliRunner().invoke(reference_cli, ["segment", "-i", position, "-c", str(cfg),
                                                "-o", str(tmp_path / "ref.zarr"), "--local"])
    assert result.exit_code == 0, result.output
    assert main(["segment", "-i", position, "-c", str(cfg), "-o", str(tmp_path / "port.zarr"),
                 "--local"], device="cpu") == 0
    want = reference_open(tmp_path / "ref.zarr/A/1/0")
    got = open_ome_zarr(tmp_path / "port.zarr/A/1/0", mode="r")
    assert got.channel_names == ["nuclei_labels", "cells_labels"]
    labels = got.data[...]
    assert labels.dtype == np.uint32 and labels.shape == (2, 2, 1 if two_d else 4, 48, 40)
    np.testing.assert_array_equal(labels, np.asarray(want.data[...]))
    assert labels[:, 0].max() >= 1
    assert two_d is False or labels[:, 1].max() >= 1
    assert got.zattrs == dict(want.zattrs)
    assert "Segmentation complete" in capsys.readouterr().out


def _message(fn) -> str:
    with pytest.raises((click.ClickException, CommandError, ValueError)) as info:
        fn()
    exc = info.value
    return exc.message if isinstance(exc, click.ClickException) else str(exc)


def test_refusals_carry_the_reference_messages(tmp_path, checkpoint):
    vol = np.zeros((1, 1, 32, 32), np.float32)
    for args in ({"do_3D": True}, {"anisotropy": 2.0}):
        assert _message(lambda: segment._cpnet_eval(vol, checkpoint, args, "cpu")) == _message(
            lambda: reference_segment._cpnet_eval(vol, checkpoint, args))
    models = {"nucleus": {"path_to_model": "nuclei", "eval_args": {}, "preprocessing": []}}
    port_models = segmentation_settings_from_reference({"models": models})["models"]
    ref_models = SegmentationSettings(models=models).models
    assert _message(lambda: segment.segment_data(vol, port_models, device="cpu")) == _message(
        lambda: reference_segment.segment_data(vol, ref_models))
    bogus = tmp_path / "bogus.pt"
    torch.save({"weight": torch.zeros(2)}, bogus)
    assert _message(lambda: engine.load_engine(str(bogus), "cpu")) == _message(
        lambda: reference_engine._load_engine(str(bogus)))


def test_settings_reader_matches_the_reference_dump():
    settings = {"models": {
        "a": {"path_to_model": "threshold_otsu", "eval_args": {"min_size": 5},
              "z_slice_2D": 7, "extra": 1,
              "preprocessing": [{"function": "np.abs", "channel": "0", "x": 2}]},
        "b": {"path_to_model": "x.pt", "eval_args": {"do_3D": False}}},
        "output_ome_zarr_version": "0.5"}
    want = SegmentationSettings(**json.loads(json.dumps(settings))).model_dump(mode="json")
    assert segmentation_settings_from_reference(settings) == want
    with pytest.raises(ValueError, match="do_3D"):
        segmentation_settings_from_reference({"models": {"a": {
            "path_to_model": "x", "eval_args": {"do_3D": True}, "z_slice_2D": 3}}})
    with pytest.raises(ValueError, match="unknown fields"):
        segmentation_settings_from_reference({"models": {}, "other": 1})
