"""The port's headline deconvolve -> deskew step against biahub_tpu's.

The reference runs ``deconvolve_then_deskew_batched`` on its Pallas route
in interpret mode (pass-C handoff into the batched zyx deskew kernel); the
port runs its chain of plain PyTorch versions on the CPU. Tolerance: max
|port - ref| <= 1e-5 * max |ref| (the FFT engine's envelope; the deskew
stage adds ~1e-7).
"""

import jax
import numpy as np
import pytest
import torch

from biahub_tpu.kernels import chain as jchain
from biahub_tpu.kernels import deskew as jdk
from biahub_tpu.kernels.deconvolve import compute_transfer_function
from biahub_tpu_torch import DeconvolveDeskew, module_from_reference
from biahub_tpu_torch.kernels import chain as tchain

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

RTOL = 1e-5
SHAPE = (16, 14, 40)
ANGLE, RATIO, AVG = 36.17, 0.371, 3


def tf_half(shape) -> np.ndarray:
    r = min(4, (min(shape) - 1) // 2)
    grid = np.mgrid[-r : r + 1, -r : r + 1, -r : r + 1] / 1.5
    psf = np.exp(-np.sum(np.square(grid), axis=0)).astype(np.float32)
    return compute_transfer_function(psf, shape)[..., : shape[-1] // 2 + 1]


@pytest.fixture
def pallas_route(monkeypatch):
    monkeypatch.setenv("BIAHUB_TPU_FORCE_PALLAS", "1")
    monkeypatch.setenv("BIAHUB_TPU_FFT_RADIX_MIN", "16")
    monkeypatch.setenv("BIAHUB_TPU_FFT_PRECISION", "highest")
    monkeypatch.setenv("BIAHUB_TPU_WARP_PRECISION", "highest")
    jax.clear_caches()
    yield
    jax.clear_caches()


def assert_close(got: torch.Tensor, want: np.ndarray) -> None:
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= RTOL * np.abs(want).max()


@pytest.mark.parametrize("skip_flip", [True, False])
def test_chain_and_module_match_reference(skip_flip, pallas_route):
    vols = np.random.default_rng(21).random((2,) + SHAPE, dtype=np.float32)
    tf = tf_half(SHAPE)
    want = np.asarray(jchain.deconvolve_then_deskew_batched(
        vols, tf, 1e-3, ANGLE, RATIO, average_window=AVG, skip_flip=skip_flip,
    ))
    got = tchain.deconvolve_then_deskew_batched(
        vols, tf, 1e-3, ANGLE, RATIO, average_window=AVG, skip_flip=skip_flip,
        device="cpu",
    )
    assert_close(got, want)
    step = DeconvolveDeskew(tf, SHAPE, 1e-3, ANGLE, RATIO, average_window=AVG,
                            skip_flip=skip_flip, device="cpu")
    assert torch.equal(step(vols), got)
    assert torch.equal(step.filter, step.state_dict()["filter"])
    one = tchain.deconvolve_then_deskew(
        vols[1], tf, 1e-3, ANGLE, RATIO, average_window=AVG, skip_flip=skip_flip,
        device="cpu",
    )
    assert torch.equal(one, got[1])


def test_module_from_reference_settings(example_deskew_settings,
                                        example_deconvolve_settings, pallas_route):
    _, deskew = example_deskew_settings
    _, deconvolve = example_deconvolve_settings
    # The example keeps the overhang and fills it with the mean: the module
    # fills each deskewed volume as the reference's fill_overhang does.
    assert deskew["keep_overhang"] and deskew["overhang_fill"] == "mean"
    vols = np.random.default_rng(22).random((2,) + SHAPE, dtype=np.float32)
    tf = tf_half(SHAPE)
    want = np.asarray(jchain.deconvolve_then_deskew_batched(
        vols, tf, deconvolve["regularization_strength"], deskew["ls_angle_deg"],
        deskew["px_to_scan_ratio"], keep_overhang=deskew["keep_overhang"],
        average_window=deskew["average_n_slices"],
    ))
    filled = np.stack([np.asarray(jdk.fill_overhang(v)) for v in want])
    step = module_from_reference(tf, deskew, deconvolve, SHAPE, device="cpu")
    assert step.overhang_fill == "mean"
    assert_close(step(vols), filled)
    unfilled = module_from_reference(tf, dict(deskew, overhang_fill=0), deconvolve, SHAPE,
                                     device="cpu")
    assert unfilled.overhang_fill is None
    assert_close(unfilled(vols), want)
    # px_to_scan_ratio derived as round(pixel_size_um / scan_step_um, 3).
    derived = dict(deskew)
    del derived["px_to_scan_ratio"]
    assert module_from_reference(tf, derived, deconvolve, SHAPE,
                                 device="cpu").geometry == step.geometry
