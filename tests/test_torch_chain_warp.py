"""The port's full chain, deconvolve -> deskew -> in-plane warp, against
biahub_tpu's.

The reference runs ``deconvolve_deskew_warp_batched`` and
``deskew_then_warp`` on its Pallas route in interpret mode
(``pallas_route``: forced Pallas, FFT and warp precision ``highest``); the
port runs its chain of plain PyTorch versions on the CPU. The matrix is
bench.py's ``reg_stab`` (bench.py:757-763). Tolerance: max |port - ref| <=
1e-5 * max |ref|, well inside the 5e-5 absolute of the reference's own
chain tests (tests/test_chain_fusion.py:164).
"""

import pathlib

import numpy as np
import pytest
import torch
import yaml

from biahub_tpu import fuse as jfuse
from biahub_tpu.kernels import chain as jchain
from biahub_tpu.settings import FusePipelineSettings
from biahub_tpu_torch import DeconvolveDeskewWarp, chain_from_reference
from biahub_tpu_torch.kernels import chain as tchain
from biahub_tpu_torch.kernels.deskew import deskew_geometry
from tests.test_torch_chain import (  # noqa: F401  (pallas_route: fixture)
    ANGLE,
    RATIO,
    SHAPE,
    assert_close,
    pallas_route,
    tf_half,
)
from tests.test_torch_warp import REG_STAB

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_flip_y_matrix_matches_reference():
    for y in (1, 40, 1024):
        assert np.array_equal(tchain.flip_y_matrix(y), jchain.flip_y_matrix(y))


# (average_window, output_shape, fill): the default output and fill, and an
# output shape other than the deskewed one with fill -1.
CHAIN_CASES = {"avg1_default": (1, None, 0.0), "avg3_shape_fill": (3, (4, 36, 30), -1.0)}


@pytest.mark.parametrize("case", sorted(CHAIN_CASES))
def test_deconvolve_deskew_warp_batched_matches_reference(case, pallas_route):
    avg, out_shape, fill = CHAIN_CASES[case]
    vols = np.random.default_rng(41).random((2,) + SHAPE, dtype=np.float32)
    tf = tf_half(SHAPE)
    want = np.asarray(jchain.deconvolve_deskew_warp_batched(
        vols, tf, 1e-3, ANGLE, RATIO, REG_STAB, output_shape=out_shape,
        average_window=avg, fill=fill,
    ))
    got = tchain.deconvolve_deskew_warp_batched(
        vols, tf, 1e-3, ANGLE, RATIO, REG_STAB, output_shape=out_shape,
        average_window=avg, fill=fill, device="cpu",
    )
    assert_close(got, want)
    assert np.array_equal(got.numpy() == fill, want == fill)

    chain = DeconvolveDeskewWarp(tf, SHAPE, 1e-3, ANGLE, RATIO, REG_STAB,
                                 output_shape=out_shape, average_window=avg,
                                 fill=fill, device="cpu")
    assert torch.equal(chain(vols), got)
    assert torch.equal(tchain.run_chain_warp(
        torch.from_numpy(vols), chain.filter, chain.geometry, chain.warp,
        chain.output_shape, fill, out_layout="xzy"), got)
    assert set(chain.state_dict()) == {"filter", "warp"}
    assert chain.logical_zyx_shape == deskew_geometry(
        SHAPE, ANGLE, RATIO, False, avg).out_shape
    one = tchain.deconvolve_deskew_warp(
        vols[1], tf, 1e-3, ANGLE, RATIO, REG_STAB, output_shape=out_shape,
        average_window=avg, fill=fill, device="cpu",
    )
    assert torch.equal(one, got[1])


@pytest.mark.parametrize("avg", [1, 3])
def test_deskew_then_warp_matches_reference(avg, pallas_route):
    vol = np.random.default_rng(42).random(SHAPE, dtype=np.float32)
    want = np.asarray(jchain.deskew_then_warp(vol, ANGLE, RATIO, REG_STAB,
                                              average_window=avg))
    got = tchain.deskew_then_warp(vol, ANGLE, RATIO, REG_STAB, average_window=avg,
                                  device="cpu")
    assert_close(got, want)


def test_uint16_chain_equals_its_float32_copy():
    vols = np.random.default_rng(43).integers(0, 65536, (2,) + SHAPE, dtype=np.uint16)
    chain = DeconvolveDeskewWarp(tf_half(SHAPE), SHAPE, 1e-3, ANGLE, RATIO, REG_STAB,
                                 average_window=3, device="cpu")
    assert torch.equal(chain(vols), chain(vols.astype(np.float32)))


def test_chain_raises_for_a_general_affine(monkeypatch):
    """A general affine no longer raises: the chain takes the reference's
    other route (chain.py:439-472), the deskew, then affine_warp_auto's
    multipass warp (the reference's accelerator route, patched in here as
    in tests/test_torch_beads.py)."""
    from biahub_tpu.kernels import affine as jaff
    from tests.test_torch_beads import accelerator_warp

    monkeypatch.setattr(jaff, "affine_warp_auto", accelerator_warp)
    rot = np.eye(4)
    rot[0, 2] = rot[2, 0] = 0.1  # mixes z and x
    vols = np.random.default_rng(44).random((2,) + SHAPE, dtype=np.float32)
    tf = tf_half(SHAPE)
    want = np.asarray(jchain.deconvolve_deskew_warp_batched(
        vols, tf, 1e-3, ANGLE, RATIO, rot, average_window=3))
    chain = DeconvolveDeskewWarp(tf, SHAPE, 1e-3, ANGLE, RATIO, rot, average_window=3,
                                 device="cpu")
    assert chain.warp is None and set(chain.state_dict()) == {"filter"}
    got = chain(vols)
    assert_close(got, want)
    assert torch.equal(tchain.deconvolve_deskew_warp_batched(
        vols, tf, 1e-3, ANGLE, RATIO, rot, average_window=3, device="cpu"), got)


def fuse_settings(stabilization: bool) -> dict:
    d = yaml.safe_load((ROOT / "settings/example_fuse_pipeline_settings.yml").read_text())
    if stabilization:
        shift = np.eye(4)
        shift[:3, 3] = [0.0, 1.5, -0.75]
        d["stabilization"] = {"affine_transform_zyx_list": [
            np.eye(4).tolist(), shift.tolist(), np.eye(4).tolist()]}
    return d


@pytest.mark.parametrize("stabilization", [False, True])
def test_chain_from_reference_settings(stabilization):
    d = fuse_settings(stabilization)
    t = 1
    single, per_t = jfuse._warp_matrices(FusePipelineSettings(**d), [0, 1, 2])
    want_m = per_t[t] if stabilization else single
    tf = tf_half(SHAPE)
    chain = chain_from_reference(tf, d, SHAPE, time_index=t, device="cpu")
    dk = FusePipelineSettings(**d).deskew
    assert chain.geometry == deskew_geometry(
        SHAPE, dk.ls_angle_deg, dk.px_to_scan_ratio, dk.keep_overhang,
        dk.average_n_slices, skip_flip=True)
    assert torch.equal(chain.warp, tchain.chain_warp_coefficients(want_m, chain.geometry))
    vols = np.random.default_rng(44).random((1,) + SHAPE, dtype=np.float32)
    assert torch.equal(chain(vols), tchain.deconvolve_deskew_warp_batched(
        vols, tf, d["deconvolve"]["regularization_strength"], dk.ls_angle_deg,
        dk.px_to_scan_ratio, want_m, average_window=dk.average_n_slices,
        device="cpu"))


def test_chain_from_reference_checks_fields():
    d = fuse_settings(False)
    with pytest.raises(ValueError, match="unknown fields"):
        chain_from_reference(tf_half(SHAPE), dict(d, warp={}), SHAPE, device="cpu")
    with pytest.raises(ValueError, match="unknown fields"):
        chain_from_reference(tf_half(SHAPE), dict(d, registration={"matrix": []}),
                             SHAPE, device="cpu")
    with pytest.raises(ValueError, match="timepoint 3"):
        chain_from_reference(tf_half(SHAPE), fuse_settings(True), SHAPE,
                             time_index=3, device="cpu")
    out = chain_from_reference(tf_half(SHAPE), dict(d, output_shape_zyx=[3, 20, 10]),
                               SHAPE, device="cpu")
    assert out.output_shape == (3, 20, 10)
    # A flat_field block is validated and left to fuse_arrays (a per-channel
    # prefix on the raw volume): the module runs the rest of the chain.
    with_ff = chain_from_reference(tf_half(SHAPE), dict(d, flat_field={"channel_names": ["a"]}),
                                   SHAPE, device="cpu")
    assert with_ff.geometry == chain_from_reference(tf_half(SHAPE), d, SHAPE,
                                                    device="cpu").geometry
    with pytest.raises(ValueError, match="unknown fields"):
        chain_from_reference(tf_half(SHAPE), dict(d, flat_field={"channels": ["a"]}),
                             SHAPE, device="cpu")

