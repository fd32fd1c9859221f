"""Kernels H and I's tile walk and windows, and the chain, the step and the
Tikhonov filter past the FFT kernels' limits, against biahub_tpu where it
has a counterpart.

- Kernels H and I (``csrc/multipass.cu``) stage each tile's source window:
  ``multipass_cuda.pass_window``, computed in the kernels' float32 operand
  order from the tile's corners, must hold every clamped tap of every
  output of the tile (hypothesis over cr of both signs, shears, shifts,
  axes, orders, axis lengths and tile positions, the registration's and
  the beads' passes among them).
- ``multipass_cuda.pass_walk`` (the kernels' blocks and their tiles) covers
  every voxel of the frame exactly once, in ``pass_blocks`` blocks: a
  dropped or doubled voxel would change I's sums without failing a
  tolerance on noise.
- Every tile of ``chip_smoke.py``'s phase 8 frame (a rigid matrix) and
  phase 11 frame (the registration's traced frame) stages its window.
- Past ``fft.deconvolve_limit`` (an axis of 4099), the step, the chain and
  ``tikhonov_inverse_3d`` / apply-inv-tf take the reference's XLA route in
  ``torch.fft``: within 2e-5 of max |ref| (the FFT tolerance) of
  biahub_tpu's functions, with every kernel wrapper of A, B, Bc and C made
  to raise, and one stderr line naming the shape and the limit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import chip_smoke
from biahub_tpu.kernels import chain as jchain
from biahub_tpu.recon import optics as joptics
from biahub_tpu_torch import (
    DeconvolveDeskew,
    DeconvolveDeskewWarp,
    apply_inverse_transfer_function_arrays,
    transfer_functions_from_reference,
)
from biahub_tpu_torch.kernels import chain as tchain
from biahub_tpu_torch.kernels import fft as tfft
from biahub_tpu_torch.kernels import multipass_cuda as mc
from biahub_tpu_torch.kernels import multipass_warp as tmp
from biahub_tpu_torch.recon import optics as toptics
from tests.test_torch_chain import ANGLE, RATIO, tf_half
from tests.test_torch_recon import (
    CHANNELS,
    FULL,
    polarization_stack,
    reference_reconstruction,
    reference_tfs,
)
from tests.test_torch_warp import REG_STAB

F32 = np.float32
FFT_TOL = 2e-5


def _taps(cr, co, tau, shear, p, i_o, order, size_r) -> np.ndarray:
    """Every clamped tap of the outputs at p (by i_o), from H's float32
    coordinate (cr*p + tau) + co*i_o and its floor clamped to [-3, size_r + 1]."""
    with np.errstate(over="ignore", invalid="ignore"):
        c = F32(cr) * p.astype(F32) + F32(tau)
        if shear:
            c = c + F32(co) * i_o.astype(F32)
        fl = np.where(np.isnan(c), -3, np.clip(np.floor(c), -3, size_r + 1)).astype(np.int64)
    kmin, kmax = (0, 1) if order == 1 else (-1, 2)
    return np.clip(fl[None] + np.arange(kmin, kmax + 1).reshape((-1,) + (1,) * fl.ndim), 0,
                   size_r - 1)


@settings(max_examples=120, deadline=None)
@given(cr=st.one_of(st.floats(0.0, 3.0), st.sampled_from([1.0, 0.999695, 1.000305, 1.01])),
       neg=st.booleans(),
       co=st.one_of(st.floats(-1.0, 1.0), st.sampled_from([0.0, 0.017450, -0.017752, 0.0087])),
       tau=st.floats(-80.0, 80.0), r=st.sampled_from([0, 1, 2]), o=st.sampled_from([0, 1, 2]),
       order=st.sampled_from([1, 3]), size_r=st.integers(1, 2200), size_o=st.integers(1, 300),
       kernel=st.sampled_from(["H", "I"]), pick=st.integers(0, 10**6))
def test_pass_window_holds_every_tap(cr, neg, co, tau, r, o, order, size_r, size_o, kernel,
                                     pick):
    if neg:  # a mirror that still meets the axis
        cr, tau = -cr, tau + size_r - 1
    shear = o != r
    tp, lanes = mc.PASS_TILES[kernel][r]
    pt = pick % -(-size_r // tp)
    p_range = (pt * tp, min(pt * tp + tp, size_r) - 1)
    # The shear's index over the tile: the lanes when it is the last axis
    # and r is not, else one index.
    if shear and o == 2 and r != 2:
        lt = (pick // 3) % -(-size_o // lanes)
        o_range = (lt * lanes, min(lt * lanes + lanes, size_o) - 1)
    else:
        o_range = ((pick // 5) % size_o,) * 2
    lo, hi, finite = mc.pass_window(cr, co, tau, shear, o_range, p_range, order, size_r)
    assert finite
    p = np.arange(p_range[0], p_range[1] + 1)[:, None]
    i_o = np.arange(o_range[0], o_range[1] + 1)[None, :]
    taps = _taps(cr, co, tau, shear, p, i_o, order, size_r)
    assert lo <= taps.min() and taps.max() <= hi
    # The window is the span of the taps: its ends are taps of the corners.
    assert lo == taps.min() and hi == taps.max()


def test_pass_window_of_coordinates_that_are_not_finite():
    for cr, tau in ((float("nan"), 0.0), (1.0, float("inf")), (3e38, 0.0)):
        assert not mc.pass_window(cr, 0.0, tau, False, (0, 0), (0, 31), 3, 40)[2]
    # cr = 0 stages: every output reads the same four rows.
    assert mc.pass_window(0.0, 0.0, 5.5, False, (0, 0), (0, 31), 3, 40) == (4, 7, True)


@pytest.mark.parametrize("kernel", ["H", "I"])
@pytest.mark.parametrize("r", [0, 1, 2])
@pytest.mark.parametrize("shape", [(5, 40, 70), (33, 9, 131), (2, 17, 2100)])
def test_pass_walk_covers_the_frame_once(shape, r, kernel):
    seen = np.zeros(shape, dtype=np.int64)
    blocks = 0
    for tiles in mc.pass_walk(shape, r, kernel):
        blocks += 1
        assert tiles
        for (a0, a1), (b0, b1), (c0, c1) in tiles:
            seen[a0:a1 + 1, b0:b1 + 1, c0:c1 + 1] += 1
    assert blocks == mc.pass_blocks(shape, r, kernel)
    assert (seen == 1).all()


def _frame_8():
    m = chip_smoke.rigid_about_centre((1.0, 1.0, 1.0), (0.3, -0.4, 0.25), chip_smoke.LAPSE_SHAPE)
    off, frame = tmp.union_frame(m, chip_smoke.LAPSE_SHAPE, chip_smoke.LAPSE_SHAPE)
    rows = [(r, o, (cr, co, tmp._tau_eff(r, o, cr, co, tau, off)))
            for (r, o), (cr, co, tau) in zip(tmp.CANONICAL_SLOTS, tmp._factor_canonical(m))]
    return frame, rows


def _frame_11():
    shape = chip_smoke.LAPSE_SHAPE
    truth = torch.tensor(chip_smoke.similarity_about_centre(shape), dtype=torch.float32)
    off, frame, _ = tmp.traced_frame(shape, shape, chip_smoke.REG_MARGIN)
    return frame, [(r, o, tuple(float(v) for v in row))
                   for r, o, row in tmp.traced_pass_rows(truth, off)]


@pytest.mark.parametrize("kernel", ["H", "I"])
@pytest.mark.parametrize("phase", [8, 11])
def test_every_tile_of_the_smoke_frames_stages(phase, kernel):
    """Every tile of phase 8's frame and phase 11's traced frame stages its
    window, at both orders and every slot (chip_smoke.direct_tiles, which
    phase 20 prints on the card, counts the tiles that do not)."""
    frame, rows = _frame_8() if phase == 8 else _frame_11()
    table = torch.tensor([row for _, _, row in rows], dtype=torch.float32)
    for k, (r, o, _) in enumerate(rows):
        for order in (1, 3):
            n = chip_smoke.direct_tiles(frame, r, o, table, k, order, kernel)
            assert n == 0, f"slot ({r}, {o}) order {order}: {n} tiles read their taps directly"


# -- the step, the chain and the Tikhonov filter past the kernels' limits --

PAST = (8, 4, 4099)  # X past the kernels' 4096 for a length not a power of two


@pytest.fixture
def no_kernels(monkeypatch):
    """The wrappers of kernels A, B, Bc and C raise if called: the route
    past the limits calls none of them."""
    def refuse(*args, **kwargs):
        raise AssertionError("a kernel wrapper was called")

    for name in ("fwd_yx", "inv_yx", "z_filter_", "z_filter_complex_", "fourier_filter_zyx"):
        monkeypatch.setattr(tfft, name, refuse)
        monkeypatch.setattr(tchain, name, refuse, raising=False)


def _close(got, want) -> None:
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= FFT_TOL * np.abs(want).max()


def test_step_past_the_limits_takes_the_reference_route(no_kernels, capsys):
    vols = np.random.default_rng(13).random((2,) + PAST, dtype=np.float32)
    tf = tf_half(PAST)
    want = np.asarray(jchain.deconvolve_then_deskew_batched(vols, tf, 1e-3, ANGLE, RATIO,
                                                            average_window=3))
    got = tchain.deconvolve_then_deskew_batched(vols, tf, 1e-3, ANGLE, RATIO, average_window=3,
                                                device="cpu")
    _close(got, want)
    step = DeconvolveDeskew(tf, PAST, 1e-3, ANGLE, RATIO, average_window=3, device="cpu")
    assert torch.equal(step(vols), got)
    err = capsys.readouterr().err
    assert err.count(f"deconvolve_then_deskew: {PAST} takes torch.fft") == 2
    assert "4096 otherwise" in err


def test_chain_past_the_limits_takes_the_reference_route(no_kernels, capsys):
    vols = np.random.default_rng(14).random((2,) + PAST, dtype=np.float32)
    tf = tf_half(PAST)
    want = np.asarray(jchain.deconvolve_deskew_warp_batched(vols, tf, 1e-3, ANGLE, RATIO,
                                                            REG_STAB, average_window=3))
    got = tchain.deconvolve_deskew_warp_batched(vols, tf, 1e-3, ANGLE, RATIO, REG_STAB,
                                                average_window=3, device="cpu")
    _close(got, want)
    chain = DeconvolveDeskewWarp(tf, PAST, 1e-3, ANGLE, RATIO, REG_STAB, average_window=3,
                                 device="cpu")
    assert torch.equal(chain(vols), got)
    assert capsys.readouterr().err.count(f"deconvolve_then_deskew: {PAST} takes torch.fft") == 2


def test_tikhonov_past_the_limits_takes_the_reference_route(no_kernels, capsys):
    vol = np.random.default_rng(15).standard_normal(PAST).astype(np.float32)
    h = reference_tfs(PAST, {"phase": {}})["phase"]
    want = np.asarray(joptics.tikhonov_inverse_3d(jnp.asarray(vol), jnp.asarray(h), 1e-3,
                                                  assume_hermitian=True))
    _close(toptics.tikhonov_inverse_3d(vol, h, 1e-3, device="cpu"), want)
    assert f"tikhonov_inverse_3d: {PAST} takes torch.fft" in capsys.readouterr().err

    tczyx = polarization_stack(PAST)
    tfs = reference_tfs(PAST, FULL)
    want = reference_reconstruction(tczyx, CHANNELS, FULL, tfs, [0])
    got = apply_inverse_transfer_function_arrays(
        tczyx, CHANNELS, transfer_functions_from_reference(tfs), FULL, device="cpu").numpy()
    assert got.shape == want.shape
    for c in range(got.shape[1]):
        _close(got[0, c], want[0, c])
    err = capsys.readouterr().err
    assert err.count(f"apply_inverse_transfer_function: {PAST} takes torch.fft") == 1
