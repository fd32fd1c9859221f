"""The port's phase cross-correlation (kernels A, Bx, C and
``kernels/pcc.py``) against biahub_tpu's.

The reference's fused route ``pcc_corr_pallas`` runs in interpret mode
(``pallas_route``, FFT precision ``highest``); the port runs the plain
versions of its kernels on the CPU. Tolerance: max |port - ref| <= 1e-5 *
max |ref|, the FFT engine's envelope (the plain versions and the XLA route
differ by about 1e-6 of max |ref| here). Integer shifts are recovered
exactly.
"""

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from biahub_tpu.kernels import fft as jfft
from biahub_tpu.kernels.pallas_fft import pcc_corr_pallas
from biahub_tpu_torch.kernels import fft as tfft
from biahub_tpu_torch.kernels import pcc as tpcc
from tests.test_torch_chain import pallas_route  # noqa: F401  (fixture)

RTOL = 1e-5
NORMS = [None, "magnitude", "classic"]


def assert_close(got, want) -> None:
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= RTOL * np.abs(want).max()


def pair(shape, seed=11):
    rng = np.random.default_rng(seed)
    return rng.random(shape).astype(np.float32), rng.random(shape).astype(np.float32)


@pytest.mark.parametrize(
    # One normalization per shape, cycled as tests/test_pallas_fft.py does:
    # the cross-power is elementwise, the shapes exercise the passes (even
    # and odd X, so the DC and Nyquist kx columns).
    "shape,normalization",
    [((16, 16, 32), None), ((8, 16, 33), "magnitude"), ((16, 8, 64), "classic")],
)
def test_z_cross_and_pcc_corr_match_the_pallas_route(shape, normalization, pallas_route):
    a, b = pair(shape)
    want = np.asarray(pcc_corr_pallas(a, b, normalization))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    s1, s2 = tfft.fwd_yx_plain(ta), tfft.fwd_yx_plain(tb)
    kept = s1.clone()
    tfft.z_cross_plain_(s1, s2, s2, normalization)
    assert torch.equal(s1, kept)  # the reference spectrum is never written
    assert_close(tfft.inv_yx_plain(s2, out=torch.empty(shape)), want)
    assert_close(tpcc.pcc_corr(ta, tb, normalization), want)


@pytest.mark.parametrize("shape", [(8, 16, 32), (6, 10, 15)])
@pytest.mark.parametrize("normalization", NORMS)
def test_pcc_corr_matches_the_xla_route(shape, normalization):
    """Every normalization, on a power-of-two and an odd shape (the CPU path
    takes any shape): the kernels' route and the port's ``_pcc_core``
    against the reference's ``_pcc_core``."""
    a, b = pair(shape, 12)
    want = np.asarray(jfft._pcc_core(a, b, normalization))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert_close(tpcc.pcc_corr(ta, tb, normalization), want)
    assert_close(tpcc._pcc_core(ta, tb, normalization), want)
    wrapper = torch.empty(tfft.half_spectrum_shape(shape), dtype=torch.complex64)
    tfft.z_cross_(tfft.fwd_yx(ta), tfft.fwd_yx(tb), wrapper, normalization)
    assert_close(tfft.inv_yx(wrapper, out=torch.empty(shape)), want)


def smooth(shape, seed=3):
    rng = np.random.default_rng(seed)
    return ndi.gaussian_filter(rng.random(shape).astype(np.float32), 2)


def same_plot(got, want) -> bool:
    """Two plots of the same size whose pixels agree but for at most 0.1%
    of them (a colorbar tick label may move where the arrays differ in the
    last float32 bit)."""
    import matplotlib.image as mimage

    a, b = mimage.imread(got), mimage.imread(want)
    return a.shape == b.shape and (np.abs(a - b).max(-1) > 0).mean() <= 1e-3


def test_phase_cross_corr_matches_reference(tmp_path):
    base = smooth((16, 32, 24))
    moved = np.roll(base, (2, -3, 5), axis=(0, 1, 2))
    for ref, mov in ((base, moved), (base[3], moved[3])):  # 3D kernels, 2D torch.fft
        want, _ = jfft.phase_cross_corr(ref, mov, "magnitude")
        got, corr = tpcc.phase_cross_corr(ref, mov, "magnitude", device="cpu")
        assert corr is None and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [3, -5])
    want, want_corr = jfft.phase_cross_corr(base, moved, "magnitude",
                                            output_path=tmp_path / "ref.png")
    got, got_corr = tpcc.phase_cross_corr(base, moved, "magnitude",
                                          output_path=tmp_path / "port.png", device="cpu")
    np.testing.assert_array_equal(got, want)
    assert_close(got_corr, want_corr)
    assert same_plot(tmp_path / "port.png", tmp_path / "ref.png")


def test_phase_cross_corr_padding_matches_reference():
    base = smooth((12, 20, 18))
    moved = np.roll(base, (1, 2, -3), axis=(0, 1, 2))
    want, _ = jfft.phase_cross_corr_padding(base, moved, normalization="classic")
    got, _ = tpcc.phase_cross_corr_padding(base, moved, normalization="classic",
                                           device="cpu")
    np.testing.assert_array_equal(got, want)
    m = tpcc.match_shape(torch.from_numpy(base), (15, 16, 25)).numpy()
    np.testing.assert_array_equal(m, jfft.match_shape(base, (15, 16, 25)))


def test_subpixel_shift_2d_matches_reference():
    img = smooth((64, 64), 4)
    moved = ndi.shift(img, (1.5, -2.25), order=1)
    for norm in ("magnitude", None):
        want = jfft.subpixel_shift_2d(img, moved, norm)
        got = tpcc.subpixel_shift_2d(img, moved, norm, device="cpu")
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_pcc_shifts_recover_integer_shifts_exactly():
    """As tests/test_pallas_fft.py's shift recovery: vs-first and pairwise,
    and their peak-index forms, against the reference's."""
    base = smooth((16, 32, 64))
    shifts = [(2, -3, 5), (-1, 4, -7)]
    movs = np.stack([np.roll(base, s, axis=(0, 1, 2)) for s in shifts])
    refs = np.stack([base, base])
    want = -np.asarray(shifts, np.float32)
    got = tpcc.pcc_shifts_vs_first(base, movs, "magnitude", device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    got = tpcc.pcc_shifts_pairwise(refs, movs, "magnitude", device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tpcc._pcc_peak_indices_vs_first(base, movs, None, device="cpu").numpy(),
        np.asarray(jfft._pcc_peak_indices_vs_first(base, movs, None)))
    np.testing.assert_array_equal(
        tpcc._pcc_peak_indices_pairwise(refs, movs, "classic", device="cpu").numpy(),
        np.asarray(jfft._pcc_peak_indices_pairwise(refs, movs, "classic")))


def test_z_cross_refuses_what_the_kernel_does_not_take():
    for z in (2, 48, 80, 1024, 2048):  # 80: custom_padding's next_fast_len(76)
        tfft._check_cross_z(z)
    with pytest.raises(ValueError, match="limit of 2048 for a power of two"):
        tfft._check_cross_z(4096)
    with pytest.raises(ValueError, match="limit of 1024 for other lengths"):
        tfft._check_cross_z(1100)
    with pytest.raises(ValueError, match="2 to 4096 otherwise"):
        tfft._check_cross_z(1)
    spec = torch.zeros((4, 4, 3), dtype=torch.complex64)
    with pytest.raises(ValueError, match="must not be ref_spec"):
        tfft.z_cross_(spec, spec.clone(), spec)
    with pytest.raises(ValueError, match="normalization"):
        tfft.z_cross_(spec, spec.clone(), spec.clone(), "phase")
    meta = torch.empty((4, 4, 3), dtype=torch.complex64, device="meta")
    with pytest.raises(ValueError, match="no kernel or plain version"):
        tfft.z_cross_(meta, meta.clone(), meta.clone())
