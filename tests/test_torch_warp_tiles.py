"""Kernels E and J's tile plans, J's exact arithmetic, and the FFT entry
points' route past the kernels' limits, against biahub_tpu where it has a
counterpart.

- Kernel E (``csrc/warp.cu``) stages each output tile's input window:
  ``warp_cuda.zy_window``, computed in the kernel's float32 operand order
  from the tile's corners, must hold every tap of the tile (hypothesis over
  scales, shears, shifts, tile positions and both reads); at the headline
  every tile is staged, and a 40-degree rotation sends about half of them
  to the direct gathers.
- Kernel J (``csrc/multipass.cu``) gathers each output over a q range
  solved once per tile: ``multipass_cuda.adjoint_q_range`` must contain
  every q whose clamped taps reach any output of the tile, edge taps
  included, for cr of both signs and |cr| from 0.5 to 2.
- ``chip_smoke.adjoint_exact`` (J's arithmetic, the card's bit-for-bit
  yardstick) within 1e-6 of max |plain| of kernel J's plain version (float32
  sums in another order) and within 1e-5 of jax.vjp of the reference's
  ``_apply_pass``, the tolerance of test_torch_multipass_vjp.py.
- ``fft.deconvolve_limit`` and ``fft.pcc_limit`` are the checks the kernels'
  wrappers raise on; past them the deconvolve and PCC entry points compute
  the reference's XLA formula with ``torch.fft`` (within 2e-5 of max |ref|,
  the FFT tolerance), launch no kernel and say so on stderr.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import chip_smoke
from biahub_tpu.kernels import deconvolve as jdecon
from biahub_tpu.kernels import fft as jfft
from biahub_tpu_torch.kernels import deconvolve as tdecon
from biahub_tpu_torch.kernels import fft as tfft
from biahub_tpu_torch.kernels import multipass_cuda as mc
from biahub_tpu_torch.kernels import multipass_warp as tmp
from biahub_tpu_torch.kernels import pcc as tpcc
from biahub_tpu_torch.kernels import warp_cuda as wc
from biahub_tpu_torch.kernels.affine import inplane_coefficients
from tests.test_torch_multipass_vjp import FRAME, pass_coefficients, reference_vjp, smooth

F32 = np.float32
FFT_TOL = 2e-5


def _taps(coords: np.ndarray, n: int) -> np.ndarray:
    """The clamped taps of float32 coordinates, both of each."""
    fl = np.clip(np.floor(coords), -1, n).astype(np.int64)
    return np.stack([np.clip(fl, 0, n - 1), np.clip(fl + 1, 0, n - 1)])


@settings(max_examples=80, deadline=None)
@given(mzz=st.floats(0.3, 3.0), zco=st.sampled_from([0.0, 0.01, -0.03]),
       tz=st.floats(-10.0, 10.0), b0=st.floats(0.3, 3.0), flip=st.booleans(),
       b1=st.floats(-0.8, 0.8), b2=st.floats(-40.0, 40.0), layout=st.sampled_from(["zyx", "xzy"]),
       zi=st.integers(1, 40), yi=st.integers(1, 300), xi=st.integers(1, 300),
       zo=st.integers(0, 50), yo_out=st.integers(1, 400), pick=st.integers(0, 10**6))
def test_e_window_holds_every_tap(mzz, zco, tz, b0, flip, b1, b2, layout, zi, yi, xi, zo,
                                  yo_out, pick):
    t, w = wc.E_TILES[layout]
    yt, xt = pick % -(-yo_out // t), (pick // 7) % -(-xi // w)
    yo_range = (yt * t, min(yt * t + t, yo_out) - 1)
    x_range = (xt * w, min(xt * w + w, xi) - 1)
    coeffs = np.array([mzz, zco, tz, -b0 if flip else b0, b1, b2], F32)
    (zlo, zhi), (ylo, yhi), finite = wc.zy_window(coeffs, zo, yo_range, x_range, (zi, yi))
    assert finite
    yo = np.arange(yo_range[0], yo_range[1] + 1, dtype=F32)[:, None]
    x = np.arange(x_range[0], x_range[1] + 1, dtype=F32)[None, :]
    zc = (coeffs[0] * F32(zo) + coeffs[1] * x) + coeffs[2]
    yc = (coeffs[3] * yo + coeffs[4] * x) + coeffs[5]
    ztaps, ytaps = _taps(zc, zi), _taps(yc, yi)
    assert zlo <= ztaps.min() and ztaps.max() <= zhi
    assert ylo <= ytaps.min() and ytaps.max() <= yhi


def _staged_share(matrix, shape, layout) -> float:
    c = inplane_coefficients(matrix).numpy()
    z, y, x = shape
    t, w = wc.E_TILES[layout]
    staged = [wc.zy_staged(wc.zy_window(c, zo, (y0, min(y0 + t, y) - 1),
                                        (x0, min(x0 + w, x) - 1), (z, y)), layout)
              for zo in (0, z // 2, z - 1) for y0 in range(0, y, t) for x0 in range(0, x, w)]
    return sum(staged) / len(staged)


@pytest.mark.parametrize("layout", ["zyx", "xzy"])
def test_e_stages_the_headline_and_not_a_40_degree_rotation(layout):
    """The chain's matrix (reg_stab after the deskew's Y flip) stages every
    tile of the deskewed headline volume; chip_smoke.py's overflowing matrix
    (40 degrees in plane about the centre) sends the tiles whose window the
    frame does not clip to the direct gathers, in both reads."""
    from biahub_tpu_torch.kernels.chain import flip_y_matrix

    shape = chip_smoke.LAPSE_SHAPE
    assert _staged_share(flip_y_matrix(shape[1]) @ chip_smoke.reg_stab_matrix(), shape,
                         layout) == 1.0
    assert 0.3 < _staged_share(chip_smoke.overflow_matrix(), shape, layout) < 0.7


def _reaching_q(cr, co, tau, shear, i_o, order, size_r) -> dict:
    """{p: [q, ...]}: every in-domain q whose clamped taps reach p, from H's
    float32 coordinate (cr*q + tau) + co*i_o."""
    q = np.arange(size_r, dtype=F32)
    c = F32(cr) * q + F32(tau)
    if shear:
        c = c + F32(co) * F32(i_o)
    inside = (c >= 0) & (c <= size_r - 1)
    fl = np.floor(c).astype(np.int64)
    kmin, kmax = (0, 1) if order == 1 else (-1, 2)
    out: dict = {}
    for qi in np.nonzero(inside)[0]:
        for k in range(kmin, kmax + 1):
            out.setdefault(int(np.clip(fl[qi] + k, 0, size_r - 1)), set()).add(int(qi))
    return out


@settings(max_examples=80, deadline=None)
@given(cr=st.floats(0.5, 2.0), neg=st.booleans(), co=st.floats(-0.3, 0.3),
       tau=st.floats(-6.0, 6.0), r=st.sampled_from([0, 1, 2]), o=st.sampled_from([0, 1, 2]),
       order=st.sampled_from([1, 3]), size_r=st.integers(2, 150), size_o=st.integers(1, 80),
       pick=st.integers(0, 10**6))
def test_j_windows_hold_every_q_that_reaches_the_tile(cr, neg, co, tau, r, o, order, size_r,
                                                      size_o, pick):
    if neg:  # a mirror that still meets the axis
        cr, tau = -cr, tau + size_r - 1
    p_tile, lanes = mc.ADJOINT_TILES[r]
    shear = o != r
    pt = pick % -(-size_r // p_tile)
    p_range = (pt * p_tile, min(pt * p_tile + p_tile, size_r) - 1)
    # The other index's range over the tile: the lanes when o is the last
    # axis and r is not, else one index.
    if shear and o == 2 and r != 2:
        lt = (pick // 3) % -(-size_o // lanes)
        o_range = (lt * lanes, min(lt * lanes + lanes, size_o) - 1)
    else:
        o_range = ((pick // 5) % size_o,) * 2
    q_range = mc.adjoint_q_range(cr, co, tau, shear, o_range, p_range, order, size_r)
    assert q_range is not None
    for i_o in range(o_range[0], o_range[1] + 1):
        reach = _reaching_q(cr, co, tau, shear, i_o, order, size_r)
        for p in range(p_range[0], p_range[1] + 1):
            assert all(q_range[0] <= q <= q_range[1] for q in reach.get(p, set()))
    # The range spans the tile's span and few q more.
    span = (p_range[1] - p_range[0] + 5) / abs(cr)
    if shear:
        span += abs(co) * (o_range[1] - o_range[0]) / abs(cr)
    assert q_range[1] - q_range[0] + 1 <= span + 5


def test_j_stages_every_tile_of_the_registration_frame():
    """At the traced frame of the deskewed FOV (chip_smoke.py phase 11),
    with the registration truth's passes, every tile's q range fits its
    stage."""
    shape = chip_smoke.LAPSE_SHAPE
    truth = torch.tensor(chip_smoke.similarity_about_centre(shape), dtype=torch.float32)
    off, frame, _ = tmp.traced_frame(shape, shape, chip_smoke.REG_MARGIN)
    for r, o, row in tmp.traced_pass_rows(truth, off):
        cr, co, tau = (float(v) for v in row)
        p_tile, lanes = mc.ADJOINT_TILES[r]
        size_r, size_o = frame[r], frame[o]
        for p_lo in range(0, size_r, p_tile):
            p_range = (p_lo, min(p_lo + p_tile, size_r) - 1)
            if o != r and o == 2 and r != 2:
                o_ranges = [(l0, min(l0 + lanes, size_o) - 1) for l0 in range(0, size_o, lanes)]
            else:
                o_ranges = [(0, 0), (size_o - 1, size_o - 1)]
            for order in (1, 3):
                for o_range in o_ranges:
                    q0, q1 = mc.adjoint_q_range(cr, co, tau, o != r, o_range, p_range, order,
                                                size_r)
                    assert q1 - q0 + 1 <= mc.adjoint_max_q(r, o)


@pytest.mark.parametrize("slot", range(len(tmp.CANONICAL_SLOTS)))
@pytest.mark.parametrize("order", [1, 3])
def test_adjoint_exact_is_the_adjoint(slot, order):
    r, o = tmp.CANONICAL_SLOTS[slot]
    coeffs = pass_coefficients(10 * slot + order, negative=slot == 5)
    ybar = np.random.default_rng(100 + slot).uniform(-1, 1, FRAME).astype(np.float32)
    table = torch.from_numpy(coeffs)[None]
    yb = torch.from_numpy(ybar)[None]
    exact = chip_smoke.adjoint_exact(yb, table, 0, r, o, order)[0].numpy()
    plain = tmp.resample_pass_adjoint_plain(yb, table, 0, r, o, order)[0].numpy()
    assert np.abs(exact - plain).max() <= 1e-6 * np.abs(plain).max()
    want_d, _ = reference_vjp(smooth(FRAME, slot), ybar, coeffs, r, o, order)
    assert np.abs(exact - want_d).max() <= 1e-5 * np.abs(want_d).max()


def _raises(check) -> bool:
    try:
        check()
    except ValueError:
        return True
    return False


SHAPES = [(86, 1024, 484), (256, 256, 1024), (2, 8192, 8192), (2, 4, 4099), (1, 16, 16),
          (4097, 4, 4), (2048, 4, 4), (1025, 4, 4), (4096, 4, 6), (2, 16384, 4), (64, 1024, 256)]


@pytest.mark.parametrize("shape", SHAPES)
def test_fft_gates_are_the_wrappers_checks(shape):
    z = shape[0]
    decon = not (_raises(lambda: tfft._check_slices(shape, "fwd_yx"))
                 or _raises(lambda: tfft._check_cuda_shape((z,), "z_filter_")))
    pcc = not (_raises(lambda: tfft._check_slices(shape, "fwd_yx"))
               or _raises(lambda: tfft._check_cross_z(z)))
    assert (tfft.deconvolve_limit(shape) is None) == decon
    assert (tfft.pcc_limit(shape) is None) == pcc
    takes = {(86, 1024, 484): (True, True), (2, 8192, 8192): (True, True),
             (2, 4, 4099): (False, False), (1, 16, 16): (False, False),
             (2048, 4, 4): (True, True), (1025, 4, 4): (True, False),
             (4096, 4, 6): (True, False)}
    if shape in takes:
        assert (decon, pcc) == takes[shape]


PAST = (2, 4, 4099)  # X past the kernels' 4096 for a length not a power of two


@pytest.fixture
def no_kernels(monkeypatch):
    """The kernels' wrappers raise if called: the route past the limits
    calls none of them."""
    def refuse(*args, **kwargs):
        raise AssertionError("a kernel wrapper was called")

    for name in ("fwd_yx", "inv_yx", "z_filter_", "z_cross_"):
        monkeypatch.setattr(tdecon, name, refuse, raising=False)
        monkeypatch.setattr(tpcc, name, refuse, raising=False)


def test_deconvolve_past_the_limits_takes_the_reference_route(no_kernels, capsys):
    rng = np.random.default_rng(7)
    vol = rng.random(PAST).astype(np.float32)
    tf_half = rng.random(tfft.half_spectrum_shape(PAST)).astype(np.float32)
    want = np.asarray(jdecon.deconvolve_zyx(jnp.asarray(vol), jnp.asarray(tf_half), 1e-3))
    got = tdecon.deconvolve_zyx(vol, tf_half, 1e-3, device="cpu").numpy()
    assert got.shape == PAST and got.dtype == np.float32
    assert np.abs(got - want).max() <= FFT_TOL * np.abs(want).max()
    err = capsys.readouterr().err
    assert f"deconvolve_zyx: {PAST} takes torch.fft" in err and "4096 otherwise" in err


@pytest.mark.parametrize("normalization", [None, "magnitude", "classic"])
def test_pcc_past_the_limits_takes_the_reference_route(normalization, no_kernels, capsys):
    rng = np.random.default_rng(8)
    ref = rng.random(PAST).astype(np.float32)
    mov = np.roll(ref, (1, -2, 5), axis=(0, 1, 2))
    want = np.asarray(jfft._corr_surface(jnp.asarray(ref), jnp.asarray(mov), normalization))
    got = tpcc._corr_surface(torch.from_numpy(ref), torch.from_numpy(mov), normalization).numpy()
    assert np.abs(got - want).max() <= FFT_TOL * np.abs(want).max()
    shifts = tpcc.pcc_shifts_vs_first(ref, mov[None], normalization, device="cpu").numpy()
    np.testing.assert_array_equal(
        shifts[0], np.asarray(jfft._pcc_shift_device(jnp.asarray(ref), jnp.asarray(mov),
                                                     normalization)))
    err = capsys.readouterr().err
    assert f"phase cross-correlation: {PAST} takes torch.fft" in err
