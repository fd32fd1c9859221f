"""Kernel Bc's module and the FFT kernels' any-length gates, on the CPU.

Bc's plain version (``z_filter_complex_plain_``) and the A -> Bc -> C route
(``fourier_filter_zyx``) against the reference's
``fourier_filter_zyx_pallas`` in interpret mode (``BIAHUB_TPU_FORCE_PALLAS=
1``, radix kernels engaged from 16, full float32 DFT precision) at the
shapes of ``tests/test_pallas_fft.py``'s Hermitian-filter test and an odd
one; tolerance 1e-5 x max|ref|. The CUDA kernels themselves run only on the
card (``chip_smoke.py`` phase 13 holds them against these plain versions
at prime, odd and the deskewed FOV's lengths).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biahub_tpu_torch.kernels import _build
from biahub_tpu_torch.kernels import fft as tfft

RTOL = 1e-5


@pytest.fixture
def pallas_route(monkeypatch):
    monkeypatch.setenv("BIAHUB_TPU_FORCE_PALLAS", "1")
    monkeypatch.setenv("BIAHUB_TPU_FFT_RADIX_MIN", "16")
    monkeypatch.setenv("BIAHUB_TPU_FFT_PRECISION", "highest")
    jax.clear_caches()
    yield
    jax.clear_caches()


def hermitian_transfer_function(shape, seed: int) -> np.ndarray:
    """The FFT of a real kernel, as the reconstructions' transfer functions."""
    return np.fft.fftn(np.random.default_rng(seed).standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("shape", [(8, 16, 24), (9, 10, 17)])
def test_prepare_hermitian_filter_follows_the_reference_formula(shape):
    h = hermitian_transfer_function(shape, 0)
    jh = jnp.asarray(h)[..., : shape[-1] // 2 + 1]
    want = np.asarray(jnp.conj(jh) / (jnp.abs(jh) ** 2 + 1e-3))
    got = tfft.prepare_hermitian_filter(shape, h, 1e-3, device="cpu")
    assert got.dtype == torch.complex64 and got.is_contiguous()
    assert tuple(got.shape) == tfft.half_spectrum_shape(shape)
    # XLA divides by the complex (d, 0); the port divides re and im by d.
    assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()
    with pytest.raises(ValueError, match="does not match"):
        tfft.prepare_hermitian_filter((8, 16, 26), h, 1e-3, device="cpu")


@pytest.mark.parametrize("shape", [(8, 16, 24), (9, 10, 17)])
def test_fourier_filter_zyx_matches_reference_pallas(shape, pallas_route):
    from biahub_tpu.kernels.pallas_fft import fourier_filter_zyx_pallas

    rng = np.random.default_rng(21)
    vol = rng.standard_normal(shape).astype(np.float32)
    filt = tfft.prepare_hermitian_filter(shape, hermitian_transfer_function(shape, 1), 1e-2,
                                         device="cpu")
    want = np.asarray(fourier_filter_zyx_pallas(
        jnp.asarray(vol), jnp.asarray(filt.real.numpy()), jnp.asarray(filt.imag.numpy())))
    _build.reset_launch_counts()
    got = tfft.fourier_filter_zyx(torch.from_numpy(vol), filt)
    assert _build.launch_counts == {}
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    assert np.abs(got.numpy() - want).max() <= RTOL * np.abs(want).max()


def test_z_filter_complex_checks_its_filter():
    spec = torch.zeros((4, 6, 5), dtype=torch.complex64)
    with pytest.raises(ValueError, match="z_filter_complex_"):
        tfft.z_filter_complex_(spec, torch.zeros((4, 6, 5)))  # a real filter
    with pytest.raises(ValueError, match="filter"):
        tfft.z_filter_complex_(spec, torch.zeros((4, 6, 4), dtype=torch.complex64))
    meta = torch.empty((4, 6, 5), dtype=torch.complex64, device="meta")
    with pytest.raises(ValueError, match="no kernel or plain version"):
        tfft.z_filter_complex_(meta, meta.clone())
    filt = torch.complex(torch.rand(4, 6, 5), torch.rand(4, 6, 5))
    spec = torch.complex(torch.rand(4, 6, 5), torch.rand(4, 6, 5))
    want = torch.fft.ifft(torch.fft.fft(spec, dim=0) * filt, dim=0)
    assert torch.allclose(tfft.z_filter_complex_(spec.clone(), filt), want)


@pytest.mark.parametrize("n,limit", [(2, 8192), (1024, 8192), (8192, 8192), (3, 4096),
                                     (484, 4096), (4095, 4096)])
def test_axis_limits(n, limit):
    assert tfft.max_axis(n) == limit
    assert tfft.max_cross_z(n) == (2048 if limit == 8192 else 1024)
