"""Kernels B, Bc (the Z-line filter) and D (the deskew): their plans and
index math on the CPU.

- A numpy model of ``csrc/fft.cu``'s ``z_line_kernel`` line: the Stockham
  passes of ``radix_plan`` with the twiddles of ``z_line_table``, the
  filter (real or complex) applied by the last forward pass, the inverse
  passes and 1/Z; a Z with a prime above 11 as Bluestein on the passes at
  ``z_line_length``'s M (176 for 86), its forward closing chirp and the
  inverse's opening chirp cancelled. Against ``torch.fft`` forward,
  filter, inverse within 1e-5 x max|ref|, at the Z the paths give B and Bc.
- ``z_line_length``'s rule (the least passes x M) and ``z_plan``'s limits.
- The wrapper hands the plan and the table to the C entry (a fake library).
- D's staging windows (``deskew_plan``, ``scan_windows``) over hypothesis'
  geometries: every in-range tap of every output lies in its chunk's
  window, the window fits the plan's rows and the plan a block's shared
  memory.
- B and Bc's plain versions through ``deconvolve_zyx`` and
  ``fourier_filter_zyx`` against the reference's Pallas engine in interpret
  mode at Z = 86 and 43 (Bluestein lines).

The kernels run only on the card (``chip_smoke.py`` phases 2, 13, 17, 18).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, assume, given, settings
from hypothesis import strategies as st

from biahub_tpu_torch.kernels import _build
from biahub_tpu_torch.kernels import deskew_cuda as dc
from biahub_tpu_torch.kernels import fft as tfft
from biahub_tpu_torch.kernels.deskew import deskew_geometry

RTOL = 1e-5
# Z of the paths' B and Bc: the headline (256), the deskewed FOV (86), the
# PCC crop (64), custom_padding (77), the odd test shape (43), and 9, 17.
Z_LENGTHS = (256, 86, 64, 77, 43, 9, 17)


def passes_model(x: np.ndarray, radices, tw: np.ndarray, inverse: bool) -> np.ndarray:
    """fft_radix.cuh's Stockham passes over lines x (..., m) with the
    table's twiddles: pass p (radix r, ns points combined) loads points j +
    q m/r of butterfly j, multiplies point q by tw[ns - 1 + (q - 1) ns + k]
    (k = j mod ns; conjugated inverse), takes the r-point DFT and stores
    output q at (j - k) r + k + q ns."""
    m = x.shape[-1]
    src, ns = x.astype(np.complex64), 1
    for r in radices:
        nr = m // r
        j = np.arange(nr)
        k = j % ns
        v = np.stack([src[..., j + q * nr] for q in range(r)], -1)
        if ns > 1:
            w = np.stack([np.ones(nr, np.complex64)]
                         + [tw[ns - 1 + (q - 1) * ns + k] for q in range(1, r)], -1)
            v = v * (np.conj(w) if inverse else w)
        sign = 1 if inverse else -1
        dft = np.exp(sign * 2j * np.pi * np.outer(np.arange(r), np.arange(r)) / r)
        v = (v @ dft.astype(np.complex64)).astype(np.complex64)
        dst = np.empty_like(src)
        d = (j - k) * r + k
        for q in range(r):
            dst[..., d + q * ns] = v[..., q]
        src, ns = dst, ns * r
    return src


def z_line_model(x: np.ndarray, filt: np.ndarray, plan) -> np.ndarray:
    """One z_line_kernel line per row of x (lines, n) with filter rows filt."""
    n, m, radices = plan.n, plan.m, plan.radices
    table = tfft.z_line_table(plan)
    tw = table[:m - 1]
    if m == n:
        y = passes_model(x, radices, tw, False) * filt
        return passes_model(y, radices, tw, True) * np.float32(1 / n)
    chirp, kern = table[m - 1:m - 1 + n], table[m - 1 + n:]
    a = np.zeros((x.shape[0], m), np.complex64)
    a[:, :n] = x * chirp
    a = passes_model(passes_model(a, radices, tw, False) * kern, radices, tw, True)
    b = np.zeros_like(a)
    b[:, :n] = a[:, :n] * filt
    b = passes_model(passes_model(b, radices, tw, False) * np.conj(kern), radices, tw, True)
    return b[:, :n] * np.conj(chirp) * np.float32(1 / n)


@pytest.mark.parametrize("complex_filter", [False, True])
@pytest.mark.parametrize("n", Z_LENGTHS)
def test_z_line_model_matches_torch_fft(n, complex_filter):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal((5, n)) + 1j * rng.standard_normal((5, n))).astype(np.complex64)
    if complex_filter:
        filt = (rng.standard_normal((5, n)) + 1j * rng.standard_normal((5, n))).astype(np.complex64)
    else:
        filt = rng.random((5, n)).astype(np.float32)
    plan = tfft.z_plan(n, complex_filter)
    got = z_line_model(x, filt, plan)
    t = torch.from_numpy(x.astype(np.complex128))
    want = torch.fft.ifft(torch.fft.fft(t, dim=1) * torch.from_numpy(filt.astype(np.complex128)),
                          dim=1).numpy()
    assert np.abs(got - want).max() <= RTOL * np.abs(want).max()


def test_z_line_length_rule():
    assert {n: tfft.z_line_length(n) for n in (86, 256, 64, 77, 43)} == {
        86: 176, 256: 256, 64: 64, 77: 77, 43: 88}
    assert tfft.radix_plan(176) == (16, 11) and tfft.radix_plan(175) == (7, 5, 5)
    for n in (13, 17, 43, 86, 97, 1021, 4093):
        m = tfft.z_line_length(n)
        cost = len(tfft.radix_plan(m)) * m
        assert m >= 2 * n - 1 and m <= 8192
        # no other smooth length of the convolution takes fewer passes x M
        for other in range(2 * n - 1, 4 * n):
            r = tfft.radix_plan(other)
            assert r is None or len(r) * other > cost or (len(r) * other == cost and other >= m)


@pytest.mark.parametrize("n", [2, 3, 86, 256, 4093, 4096, 8192])
@pytest.mark.parametrize("complex_filter", [False, True])
def test_z_plan_fits_a_block(n, complex_filter):
    plan = tfft.z_plan(n, complex_filter)
    assert plan.smem <= tfft._SMEM_ONE and plan.per_sm >= 1 and 32 <= plan.threads <= 256
    assert plan.smem == tfft._z_plan_smem(n, plan.m, 1 << plan.log2tk, plan.stages,
                                          plan.fstage, plan.tab_smem, complex_filter)
    assert int(np.prod(plan.radices)) == plan.m == tfft.z_line_length(n)
    # the line depends on Z alone: every tile width gives the same radices
    assert {tfft._z_layout(n, l, *layout, complex_filter).radices
            for l in range(plan.log2tk + 1) for layout in tfft._Z_LAYOUTS} == {plan.radices}


class ZLib:
    """B and Bc's C entries: record the arguments, return ``rc``."""

    def __init__(self, rc: int = 0):
        self.rc, self.calls = rc, []

    def _entry(self, *args):
        self.calls.append(args)
        return self.rc

    z_filter = z_filter_complex = _entry

    def error_string(self, rc):
        return b"invalid argument"


@contextlib.contextmanager
def fake_card(monkeypatch, lib):
    monkeypatch.setattr(_build, "on_card", lambda t, what: True)
    monkeypatch.setattr(_build, "stream_of", lambda t: None)
    monkeypatch.setattr(tfft, "_lib", lambda: lib)
    monkeypatch.setattr(tfft, "_sm_count", lambda d: 132)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    _build.reset_launch_counts()
    yield


@pytest.mark.parametrize("complex_filter", [False, True])
def test_z_filter_wrappers_pass_the_plan(complex_filter, monkeypatch):
    shape = (86, 12, 9)
    spec = torch.zeros(shape, dtype=torch.complex64)
    filt = torch.zeros(shape, dtype=torch.complex64 if complex_filter else torch.float32)
    run = tfft.z_filter_complex_ if complex_filter else tfft.z_filter_
    entry = "z_filter_complex" if complex_filter else "z_filter"
    plan = tfft.z_plan(86, complex_filter)
    lib = ZLib()
    with fake_card(monkeypatch, lib):
        run(spec, filt)
        assert _build.launch_counts == {entry: 1}
    args = lib.calls[0]
    lines = 12 * 9
    assert args[3:-3] == plan.args(plan.grid(lines, 132)) and args[-3:-1] == (86, lines)
    assert args[3:-3][-2] == min(-(-lines // 16), 132 * plan.per_sm)
    with fake_card(monkeypatch, ZLib(rc=1)):
        with pytest.raises(RuntimeError, match="Bluestein on 176.*invalid argument"):
            run(spec, filt)
        assert _build.launch_counts == {}


def deskew_taps(geo):
    """Every output's two scan taps (zo, xo) in float32 as the kernel forms
    them: (Y_in, X_out) arrays of i0 and i0 + 1."""
    _, y_in, _ = geo.zyx_shape
    px, pxct, off = (np.float32(v) for v in (geo.px, geo.pxct, geo.offset))
    xo = np.arange(geo.x_out, dtype=np.float32)[None, :]
    zo = np.arange(y_in, dtype=np.float32)[:, None]
    i0 = np.floor((px * xo - pxct * zo) + off).astype(np.int64)
    return i0, i0 + 1


@settings(max_examples=40, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(z_in=st.integers(2, 60), y_in=st.integers(1, 40), x_in=st.integers(1, 300),
       angle=st.floats(5.0, 75.0), ratio=st.floats(0.1, 3.0), keep=st.booleans(),
       avg=st.integers(1, 5), skip_flip=st.booleans())
def test_deskew_window_holds_every_tap(z_in, y_in, x_in, angle, ratio, keep, avg, skip_flip):
    try:
        geo = deskew_geometry((z_in, y_in, x_in), angle, ratio, keep, avg, skip_flip=skip_flip)
    except ValueError:  # only overhang without keep_overhang
        assume(False)
    plan = dc.deskew_plan(geo)
    assert plan.smem <= dc._SMEM_ONE and plan.smem == dc._smem(avg, plan.rows, plan.cx)
    lo, rows = dc.scan_windows(geo, plan.cx)
    assert rows.max() <= plan.rows
    for tap in deskew_taps(geo):
        chunk = np.arange(geo.x_out) // plan.cx
        first = lo[:, chunk]
        inside = (tap >= 0) & (tap < z_in)
        assert ((tap >= first) & (tap < first + rows[:, chunk]))[inside].all()


@pytest.fixture
def pallas_route(monkeypatch):
    monkeypatch.setenv("BIAHUB_TPU_FORCE_PALLAS", "1")
    monkeypatch.setenv("BIAHUB_TPU_FFT_RADIX_MIN", "16")
    monkeypatch.setenv("BIAHUB_TPU_FFT_PRECISION", "highest")
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.mark.parametrize("shape", [(86, 6, 10), (43, 4, 12)])
def test_b_and_bc_match_reference_pallas(shape, pallas_route):
    from biahub_tpu.kernels.pallas_fft import deconvolve_zyx_pallas, fourier_filter_zyx_pallas
    from biahub_tpu_torch.kernels.deconvolve import deconvolve_zyx

    rng = np.random.default_rng(11)
    vol = rng.standard_normal(shape).astype(np.float32)
    tf_half = rng.random(tfft.half_spectrum_shape(shape)).astype(np.float32)
    want = np.asarray(deconvolve_zyx_pallas(jnp.asarray(vol), jnp.asarray(tf_half), 1e-2))
    got = deconvolve_zyx(torch.from_numpy(vol), tf_half, 1e-2, device="cpu")
    assert np.abs(got.numpy() - want).max() <= RTOL * np.abs(want).max()
    h = np.fft.fftn(rng.standard_normal(shape)).astype(np.complex64)
    filt = tfft.prepare_hermitian_filter(shape, h, 1e-2, device="cpu")
    want = np.asarray(fourier_filter_zyx_pallas(
        jnp.asarray(vol), jnp.asarray(filt.real.numpy()), jnp.asarray(filt.imag.numpy())))
    got = tfft.fourier_filter_zyx(torch.from_numpy(vol), filt)
    assert np.abs(got.numpy() - want).max() <= RTOL * np.abs(want).max()
