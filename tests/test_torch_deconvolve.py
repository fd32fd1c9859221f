"""biahub_tpu_torch deconvolution against biahub_tpu on the same inputs.

The port runs its plain PyTorch versions here (CPU tensors); the reference
runs its XLA route (``BIAHUB_TPU_NO_PALLAS=1``) or its Pallas engine in
interpret mode (``BIAHUB_TPU_FORCE_PALLAS=1``, radix kernels engaged from
16, full float32 DFT precision). Tolerance: max |port - ref| <= 1e-5 *
max |ref|, the reference engine's own envelope.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biahub_tpu.kernels import deconvolve as jdec
from biahub_tpu_torch.kernels import deconvolve as tdec
from biahub_tpu_torch.kernels import fft as tfft

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

RTOL = 1e-5


def gaussian_psf(shape) -> np.ndarray:
    """bench.py's Gaussian PSF (radius 4, sigma 1.5), cut to fit ``shape``."""
    r = min(4, (min(shape) - 1) // 2)
    grid = np.mgrid[-r : r + 1, -r : r + 1, -r : r + 1] / 1.5
    return np.exp(-np.sum(np.square(grid), axis=0)).astype(np.float32)


def tf_half(shape) -> np.ndarray:
    tf = jdec.compute_transfer_function(gaussian_psf(shape), shape)
    return tf[..., : shape[-1] // 2 + 1]


@pytest.fixture
def jax_route(request, monkeypatch):
    """Pin the reference's deconvolution route: 'xla' or 'pallas'."""
    if request.param == "xla":
        monkeypatch.setenv("BIAHUB_TPU_NO_PALLAS", "1")
    else:
        monkeypatch.setenv("BIAHUB_TPU_FORCE_PALLAS", "1")
        monkeypatch.setenv("BIAHUB_TPU_FFT_RADIX_MIN", "16")
    monkeypatch.setenv("BIAHUB_TPU_FFT_PRECISION", "highest")
    jax.clear_caches()
    yield request.param
    jax.clear_caches()


@pytest.mark.parametrize(
    "jax_route,shape",
    [
        ("xla", (16, 14, 40)),
        ("xla", (16, 16, 64)),
        ("xla", (9, 10, 17)),  # odd Z, Y and X
        ("pallas", (16, 14, 40)),
        ("pallas", (16, 16, 64)),
    ],
    indirect=["jax_route"],
)
def test_deconvolve_zyx_matches_reference(jax_route, shape):
    vol = np.random.default_rng(1).random(shape, dtype=np.float32)
    tf = tf_half(shape)
    want = np.asarray(jdec.deconvolve_zyx(jnp.asarray(vol), jnp.asarray(tf), 1e-3))
    got = tdec.deconvolve_zyx(vol, tf, 1e-3, device="cpu").numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= RTOL * np.abs(want).max()


@pytest.mark.parametrize("psf_shape,shape", [((9, 9, 9), (16, 14, 40)), ((4, 5, 6), (9, 10, 17))])
def test_compute_transfer_function_is_bit_exact(psf_shape, shape):
    psf = np.random.default_rng(2).random(psf_shape).astype(np.float32)
    np.testing.assert_array_equal(
        tdec.compute_transfer_function(psf, shape),
        jdec.compute_transfer_function(psf, shape),
    )


@pytest.mark.parametrize("shape", [(16, 16, 64), (9, 10, 17)])
def test_uint16_input_is_bit_exact_with_its_float32_copy(shape):
    raw = np.random.default_rng(5).integers(0, 65536, size=shape, dtype=np.uint16)
    tf = tf_half(shape)
    got = tdec.deconvolve_zyx(raw, tf, 1e-3, device="cpu")
    want = tdec.deconvolve_zyx(raw.astype(np.float32), tf, 1e-3, device="cpu")
    assert torch.equal(got, want)


def test_prepared_filter_equals_unprepared_path():
    shape = (16, 14, 40)
    vol = np.random.default_rng(3).random(shape, dtype=np.float32)
    tf = tf_half(shape)
    prepared = tfft.prepare_fourier_filter(shape, tf, 1e-3, device="cpu")
    # The reference's Tikhonov transform, in the same float32 order.
    jtf = jnp.asarray(tf)
    np.testing.assert_array_equal(prepared.numpy(), np.asarray(jtf / (jtf * jtf + 1e-3)))
    assert torch.equal(
        tdec.deconvolve_zyx(vol, prepared=prepared, device="cpu"),
        tdec.deconvolve_zyx(vol, tf, 1e-3, device="cpu"),
    )
    with pytest.raises(ValueError, match="does not match"):
        tfft.prepare_fourier_filter((16, 14, 42), tf, 1e-3, device="cpu")


@pytest.mark.parametrize("jax_route", ["xla"], indirect=True)
def test_deconvolve_czyx_matches_reference(jax_route):
    shape = (8, 10, 12)
    data = np.random.default_rng(4).random((2,) + shape, dtype=np.float32)
    tf = tf_half(shape)
    want = np.asarray(jdec.deconvolve_czyx(jnp.asarray(data), jnp.asarray(tf), 1e-3))
    got = tdec.deconvolve_czyx(data, tf, 1e-3, device="cpu").numpy()
    assert np.abs(got - want).max() <= RTOL * np.abs(want).max()
