"""The port's spectral deconvolve + deskew against biahub_tpu's.

The reference's engine (``kernels/pallas_spectral.py``) runs in interpret
mode, as tests/test_pallas_spectral.py runs it (``BIAHUB_TPU_FORCE_PALLAS``
and ``BIAHUB_TPU_SPECTRAL_DESKEW`` set, radix splits from 16), with its
matmul DFTs at precision ``highest``; the port runs kernels A, K, L and M's
plain PyTorch versions on the CPU. The lerp-DFT matrices and the table are
held to the reference's numpy functions in float64 (1e-12) and float32
(1e-6 of the largest entry); the engine to the reference's within 2e-4 of
max|ref|, the reference's own bound between its engine and its composition
(tests/test_pallas_spectral.py:95).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biahub_tpu.kernels import chain as jchain
from biahub_tpu.kernels import fourier_resample as jfr
from biahub_tpu.kernels import pallas_spectral as jspec
from biahub_tpu_torch import DeconvolveDeskew, DeconvolveDeskewWarp
from biahub_tpu_torch.convert import spectral_table_from_reference
from biahub_tpu_torch.kernels import _build, chain, spectral, spectral_cuda
from biahub_tpu_torch.kernels import fourier_resample as tfr
from biahub_tpu_torch.kernels.fft import prepare_hermitian_filter
from tests.test_torch_chain import tf_half
from tests.test_torch_fft_lengths import hermitian_transfer_function
from tests.test_torch_warp import REG_STAB

ANGLE, RATIO = 36.17, 0.371
ENGINE_TOL = 2e-4


@pytest.fixture
def spectral_route(monkeypatch):
    monkeypatch.setenv("BIAHUB_TPU_FORCE_PALLAS", "1")
    monkeypatch.setenv("BIAHUB_TPU_SPECTRAL_DESKEW", "1")
    monkeypatch.setenv("BIAHUB_TPU_FFT_RADIX_MIN", "16")
    monkeypatch.setenv("BIAHUB_TPU_FFT_PRECISION", "highest")
    jax.clear_caches()
    yield
    jax.clear_caches()


def volume(shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def rel_err(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


# Positions with taps below 0, above n-1, both out, integer and fractional.
@pytest.mark.parametrize("n", [7, 8, 16])
@pytest.mark.parametrize("masked", [False, True], ids=["lerp", "masked"])
def test_lerp_dft_matrices_match_reference(n, masked):
    p = np.concatenate([np.linspace(-2.5, n + 1.5, 23), [0.0, n - 1.0, -1.0, n, 3.25]])
    want = (jfr.masked_lerp_dft_matrix if masked else jfr.lerp_dft_matrix)(n, p)
    got = (tfr.masked_lerp_dft_matrix if masked else tfr.lerp_dft_matrix)(n, p, device="cpu")
    assert got.dtype == torch.complex128
    assert np.abs(got.numpy() - want).max() <= 1e-12


def test_masked_matrix_is_the_zero_padded_lerp():
    n = 11
    v = np.random.default_rng(3).standard_normal(n)
    p = np.linspace(-1.7, n + 0.6, 40)
    m = tfr.masked_lerp_dft_matrix(n, p, device="cpu").numpy()
    padded = np.concatenate([[0.0], v, [0.0]])
    i0 = np.floor(p).astype(int)
    f = p - i0
    want = (1 - f) * padded[np.clip(i0 + 1, 0, n + 1)] + f * padded[np.clip(i0 + 2, 0, n + 1)]
    want[(i0 < -1) | (i0 > n - 1)] = 0.0
    assert np.abs((m @ np.fft.fft(v)).real - want).max() <= 1e-12


@pytest.mark.parametrize("keep_overhang", [False, True])
def test_deskew_sample_positions_match_reference(keep_overhang):
    shape = (16, 16, 64)
    want_z, want_exact = jfr.deskew_sample_positions(shape, ANGLE, RATIO, keep_overhang)
    got_z, got_exact = tfr.deskew_sample_positions(shape, ANGLE, RATIO, keep_overhang,
                                                   device="cpu")
    assert np.array_equal(got_z.numpy(), want_z)
    assert np.array_equal(got_exact.numpy(), want_exact)


@pytest.mark.parametrize("layout", ["zyx", "xzy"])
@pytest.mark.parametrize("shape,avg", [((8, 8, 32), 3), ((16, 16, 64), 2)])
def test_table_matches_reference(shape, avg, layout):
    mr, mi = jspec._spectral_table_np(shape, ANGLE, RATIO, True, avg, layout == "xzy")
    groups = -(-shape[1] // avg)
    want = spectral_table_from_reference(mr, mi, groups, avg)
    got = spectral.prepare_spectral_deskew(shape, ANGLE, RATIO, True, avg, device="cpu")
    assert got.dtype == torch.complex64 and tuple(got.shape) == tuple(want.shape)
    assert tuple(got.shape) == (groups * avg, mr.shape[1], shape[0])
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
    if layout == "xzy":  # the dropped rows are the reference's zero pad groups
        assert not mr[groups * avg:].any() and not mi[groups * avg:].any()


# (shape, average_window, keep_overhang): an avg that does not divide Y; the
# overhang kept; X = 256, where the reference peels the Nyquist column; an
# odd length (Z = 12 and Y = 20, which the reference's engine does not take:
# Z % 8, so that case is held to the reference's chain, its composition).
# Measured max |port - ref| / max |ref| on the CPU, in this order: 2.0e-7,
# 2.1e-7, 2.9e-7 and 6.2e-7 (the xzy store 2.6e-7, the complex filter
# 2.6e-7).
ENGINE_CASES = {
    "avg3": ((8, 8, 32), 3, False),
    "avg2_overhang": ((8, 8, 32), 2, True),
    "nyquist_peel": ((16, 16, 256), 2, False),
    "odd_lengths": ((12, 20, 48), 2, False),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_matches_reference(case, spectral_route):
    shape, avg, keep = ENGINE_CASES[case]
    vol, tf = volume(shape, 11), tf_half(shape)
    kw = dict(ls_angle_deg=ANGLE, px_to_scan_ratio=RATIO, keep_overhang=keep,
              average_window=avg)
    if jspec.spectral_deskew_supported(shape, ANGLE, RATIO, keep, avg):
        want = jspec.deconvolve_deskew_zyx_spectral(jnp.asarray(vol), jnp.asarray(tf), 1e-3,
                                                    **kw)
    else:
        assert case == "odd_lengths"
        want = jchain.deconvolve_then_deskew(jnp.asarray(vol), jnp.asarray(tf), 1e-3, ANGLE,
                                             RATIO, keep, avg, skip_flip=True)
    assert spectral.spectral_deskew_supported(shape, ANGLE, RATIO, keep, avg)
    got = spectral.deconvolve_deskew_zyx_spectral(vol, tf, 1e-3, **kw, device="cpu")
    assert got.dtype == torch.float32
    assert rel_err(got, want) <= ENGINE_TOL


def test_xzy_store_is_the_zyx_store_transposed(spectral_route):
    shape, avg = (8, 8, 32), 3
    vol, tf = volume(shape, 12), tf_half(shape)
    kw = dict(ls_angle_deg=ANGLE, px_to_scan_ratio=RATIO, keep_overhang=False,
              average_window=avg)
    zyx = spectral.deconvolve_deskew_zyx_spectral(vol, tf, 1e-3, **kw, device="cpu")
    xzy = spectral.deconvolve_deskew_zyx_spectral(vol, tf, 1e-3, **kw, out_layout="xzy",
                                                  device="cpu")
    assert torch.equal(xzy, zyx.permute(2, 0, 1))
    want = np.asarray(jspec.deconvolve_deskew_zyx_spectral(
        jnp.asarray(vol), jnp.asarray(tf), 1e-3, **kw, out_layout="xzy"))
    groups = zyx.shape[0]
    assert want.shape[1] > groups  # the reference pads the groups to 8
    assert rel_err(xzy, want[:, :groups, :]) <= ENGINE_TOL
    # One table serves both stores, as it is passed in.
    table = spectral.prepare_spectral_deskew(shape, ANGLE, RATIO, False, avg, device="cpu")
    again = spectral.deconvolve_deskew_zyx_spectral(vol, tf, 1e-3, **kw, out_layout="xzy",
                                                    deskew_table=table, device="cpu")
    assert torch.equal(again, xzy)


def test_complex_filter_matches_reference(spectral_route):
    shape, avg = (8, 8, 32), 2
    vol = volume(shape, 13)
    filt = prepare_hermitian_filter(shape, hermitian_transfer_function(shape, 2), 1e-2,
                                    device="cpu")
    kw = dict(ls_angle_deg=ANGLE, px_to_scan_ratio=RATIO, keep_overhang=False,
              average_window=avg)
    want = jspec.deconvolve_deskew_zyx_spectral(
        jnp.asarray(vol), None, None, **kw,
        filter_halves=(jnp.asarray(filt.real.numpy()), jnp.asarray(filt.imag.numpy())))
    got = spectral.deconvolve_deskew_zyx_spectral(vol, None, None, **kw, filter=filt,
                                                  device="cpu")
    assert rel_err(got, want) <= ENGINE_TOL


def test_engine_refuses_what_it_does_not_take():
    shape = (8, 8, 32)
    vol, tf = volume(shape, 14), tf_half(shape)
    kw = dict(ls_angle_deg=ANGLE, px_to_scan_ratio=RATIO, keep_overhang=False, device="cpu")
    table = spectral.prepare_spectral_deskew(shape, ANGLE, RATIO, False, 2, device="cpu")
    with pytest.raises(ValueError, match="does not match this geometry"):
        spectral.deconvolve_deskew_zyx_spectral(vol, tf, 1e-3, average_window=3,
                                                deskew_table=table, **kw)
    with pytest.raises(ValueError, match="needs a complex filter"):
        spectral.deconvolve_deskew_zyx_spectral(vol, tf, None, **kw)
    with pytest.raises(ValueError, match="does not take"):  # X past kernel M's limit
        spectral.deconvolve_deskew_zyx_spectral(np.zeros((8, 8, 4097), np.float32), None,
                                                **kw)
    # Overhang only (Z / ratio < Y cos(angle)), and an axis of length 1.
    assert not spectral.spectral_deskew_supported((4, 64, 32), ANGLE, RATIO, False)
    assert not spectral.spectral_deskew_supported((1, 8, 32), ANGLE, RATIO, True)
    assert spectral.spectral_deskew_supported((256, 256, 1024), ANGLE, RATIO, False, 3)
    assert spectral_cuda.lerp_irfft_fits(8192) and not spectral_cuda.lerp_irfft_fits(16384)
    assert spectral_cuda.lerp_irfft_fits(4095) and not spectral_cuda.lerp_irfft_fits(4097)


@pytest.fixture
def plain_m_calls(monkeypatch):
    """Counts the calls of kernel M's plain version: the CPU route's proof
    that the spectral engine ran."""
    calls = []
    plain = spectral_cuda.lerp_irfft_plain

    def counting(*args, **kwargs):
        calls.append(args[4] if len(args) > 4 else kwargs.get("out_layout", "zyx"))
        return plain(*args, **kwargs)

    monkeypatch.setattr(spectral_cuda, "lerp_irfft_plain", counting)
    return calls


# The port's composition route is held against the reference in
# test_torch_chain.py and test_torch_chain_warp.py.
SHAPE = (16, 14, 40)


@pytest.mark.parametrize("skip_flip", [True, False])
def test_step_spectral_route_matches_composition(skip_flip, plain_m_calls):
    vols = np.random.default_rng(21).random((2,) + SHAPE, dtype=np.float32)
    tf = tf_half(SHAPE)
    args = (vols, tf, 1e-3, ANGLE, RATIO, False, 3)
    want = chain.deconvolve_then_deskew_batched(*args, skip_flip=skip_flip, device="cpu")
    assert plain_m_calls == []
    got = chain.deconvolve_then_deskew_batched(*args, skip_flip=skip_flip, device="cpu",
                                               spectral=True)
    assert plain_m_calls == ["zyx"] * 2
    assert rel_err(got, want) <= ENGINE_TOL
    step = DeconvolveDeskew(tf, SHAPE, 1e-3, ANGLE, RATIO, average_window=3,
                            skip_flip=skip_flip, device="cpu", spectral=True)
    assert torch.equal(step.deskew_table, step.state_dict()["deskew_table"])
    assert torch.equal(step(vols), got)
    assert torch.equal(chain.deconvolve_then_deskew(vols[1], tf, 1e-3, ANGLE, RATIO, False, 3,
                                                    skip_flip=skip_flip, device="cpu",
                                                    spectral=True), got[1])
    assert DeconvolveDeskew(tf, SHAPE, 1e-3, ANGLE, RATIO, device="cpu").deskew_table is None


def test_chain_spectral_route_matches_composition(plain_m_calls):
    vols = np.random.default_rng(41).random((2,) + SHAPE, dtype=np.float32)
    tf = tf_half(SHAPE)
    args = (vols, tf, 1e-3, ANGLE, RATIO, REG_STAB)
    kw = dict(output_shape=(4, 36, 30), average_window=3, fill=-1.0, device="cpu")
    want = chain.deconvolve_deskew_warp_batched(*args, **kw)
    assert chain.chain_warp_spectral_route(SHAPE, ANGLE, RATIO, False, 3, REG_STAB)
    got = chain.deconvolve_deskew_warp_batched(*args, **kw, spectral=True)
    assert plain_m_calls == ["xzy"] * 2
    assert rel_err(got, want) <= ENGINE_TOL
    module = DeconvolveDeskewWarp(tf, SHAPE, 1e-3, ANGLE, RATIO, REG_STAB, (4, 36, 30),
                                  average_window=3, fill=-1.0, device="cpu", spectral=True)
    assert module.deskew_table is not None
    assert torch.equal(module(vols), got)
    # A general 3D matrix takes the multipass route, whatever ``spectral``.
    tilt = np.eye(4)
    tilt[0, 2] = tilt[2, 0] = 0.1
    assert not chain.chain_warp_spectral_route(SHAPE, ANGLE, RATIO, False, 3, tilt)
    assert DeconvolveDeskewWarp(tf, SHAPE, 1e-3, ANGLE, RATIO, tilt, device="cpu",
                                spectral=True).deskew_table is None


def test_cpu_spectral_route_counts_no_launch():
    _build.reset_launch_counts()
    vol = volume((8, 8, 32), 15)
    spectral.deconvolve_deskew_zyx_spectral(vol, tf_half((8, 8, 32)), 1e-3, ls_angle_deg=ANGLE,
                                            px_to_scan_ratio=RATIO, keep_overhang=False,
                                            device="cpu")
    assert _build.launch_counts == {}


def test_build_target_follows_included_headers(tmp_path, monkeypatch):
    for name in ("spectral.cu", "fft_lines.cuh", "fft_radix.cuh", "cp_async.cuh", "deskew.cu"):
        (tmp_path / name).write_bytes((_build._CSRC / name).read_bytes())
    monkeypatch.setattr(_build, "_CSRC", tmp_path)
    before = {name: _build._target(name) for name in ("spectral", "deskew")}
    assert before["spectral"] == _build._target("spectral")
    header = tmp_path / "fft_lines.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    assert _build._target("spectral") != before["spectral"]
    assert _build._target("deskew") == before["deskew"]  # does not include fft_lines.cuh
    shared = tmp_path / "cp_async.cuh"
    shared.write_bytes(shared.read_bytes() + b"\n// edited\n")
    assert _build._target("deskew") != before["deskew"]  # includes cp_async.cuh
    assert "spectral" in _build.SOURCES
