"""Kernels L and M's designs, on the CPU.

- M's contraction on the tensor cores in split TF32 (``csrc/spectral.cu``):
  each float32 operand as a TF32 high part (round to nearest, ties away)
  and a TF32 remainder, a real product as hi*hi + hi*lo + lo*hi, four real
  products a complex one, emulated here by masking mantissa bits, with the
  float32 accumulation of each 8-deep MMA step; at a depth of avg * Z =
  768 (the headline's), on narrow widths, within SPECTRAL_TOL (2e-5 of
  max|U|) of float64, where a single TF32 product is not.
- The plans: L's ``column_plan`` (kernel C's column phase, one block a
  tile), M's ``contract_plan`` (tiles of 128 kx x 128 x', 16 kz a stage,
  three stages; the constants parsed from the source) and ``irfft_plan``
  (tiles of column pairs, kernel C's row passes in column layout), at every
  shape of chip_smoke.py's SPECTRAL_CASES and at the ragged edges (Z = 43,
  X = 3, X = 2048 and up to the A/C limits, x_out not a multiple of 128):
  the tiles cover the output, the padding, and the shared memory under 227
  KB and equal to the C side's layout; the plans handed to the C entries
  through a fake library.
- The split of M into its two launches: the plain contraction and irfft
  compose to M's plain version bit for bit, on the CPU no launch counts.
- ``deconvolve_deskew_zyx_spectral`` against the reference's spectral
  engine in interpret mode (``BIAHUB_TPU_SPECTRAL_DESKEW=1``) at an X past
  the previous kernel M's limit of 2048, within 2e-4 of max|ref| (the
  reference's own bound between its engine and its composition).
"""

import contextlib
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from biahub_tpu.kernels import pallas_spectral as jspec
from biahub_tpu_torch.kernels import _build, fft, spectral, spectral_cuda
from tests.test_torch_chain import tf_half

ANGLE, RATIO = 36.17, 0.371
SPECTRAL_TOL = 2e-5
ENGINE_TOL = 2e-4
SMEM_MAX = 227 * 1024
CSRC = Path(spectral_cuda.__file__).resolve().parents[1] / "csrc"


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: float32 rounded to 10 mantissa bits, to nearest,
    ties away from zero (the sign-magnitude bits plus half a TF32 ulp,
    truncated)."""
    bits = x.to(torch.float32).view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def mma_sum(a_parts, b_parts, k_step: int = 8) -> torch.Tensor:
    """sum_k a[m, k] b[k, n] as the tensor cores take it: the products of
    the (a, b) part pairs exact (float64), each 8-deep step added to a
    float32 accumulator."""
    m, k = a_parts[0].shape
    acc = torch.zeros((m, b_parts[0].shape[1]), dtype=torch.float32)
    for k0 in range(0, k, k_step):
        step = sum(a[:, k0:k0 + k_step].double() @ b[k0:k0 + k_step].double()
                   for a, b in zip(a_parts, b_parts))
        acc = (acc.double() + step).float()
    return acc


def tf32x3_contraction(s: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """U = S^T T^T for S (K, M) and T (N, K) complex64, as kernel M's
    contraction computes it: Ur = Sr Tr + (-Si) Ti, Ui = Sr Ti + Si Tr, each
    real product hi*hi + hi*lo + lo*hi (the small ones first)."""
    sr, si = split_tf32(s.real.T.contiguous()), split_tf32(s.imag.T.contiguous())
    tr, ti = split_tf32(t.real.T.contiguous()), split_tf32(t.imag.T.contiguous())
    nsi = (-si[0], -si[1])

    def terms(a, b):  # lo*hi, hi*lo, hi*hi
        return [(a[1], b[0]), (a[0], b[1]), (a[0], b[0])]

    ur = terms(sr, tr) + terms(nsi, ti)
    ui = terms(sr, ti) + terms(si, tr)
    re_ = mma_sum([a for a, _ in ur], [b for _, b in ur])
    im_ = mma_sum([a for a, _ in ui], [b for _, b in ui])
    return torch.complex(re_, im_)


def test_tf32_split_is_exact_to_float32_rounding():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    hi, lo = split_tf32(x)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()  # TF32: 13 low bits clear
    assert float((hi - x).abs().max() / x.abs().max()) <= 2.0**-11
    # lo is x - hi rounded to TF32: hi + lo within 2^-22 of x.
    assert bool(((hi.double() + lo.double() - x.double()).abs()
                 <= 2.0**-22 * x.double().abs()).all())
    assert torch.equal(tf32_rna(-x), -tf32_rna(x))  # negation commutes with the split


def test_tf32x3_contraction_holds_float64_at_depth_768():
    """The headline's depth: avg 3 tilt rows of Z = 256 kz, on the real table
    of a narrow geometry and a filtered spectrum of random data; U within
    SPECTRAL_TOL of float64 (a single TF32 product is not)."""
    shape, avg = (256, 6, 16), 3
    table = spectral.spectral_table(shape, ANGLE, RATIO, False, avg, torch.device("cpu"))
    rows, x_out, z = table.shape
    groups = rows // avg
    vol = torch.from_numpy(np.random.default_rng(1).random(shape, dtype=np.float32))
    spec = fft.y_inv_plain_(fft.fwd_yx_plain(vol))
    rows_y = spectral_cuda._tilt_rows(shape[1], rows, "cpu")
    s64 = spec[:, rows_y, :].to(torch.complex128).reshape(z, groups, avg, -1)
    u64 = torch.einsum("gjxk,kgjc->gcx", table.to(torch.complex128).reshape(
        groups, avg, x_out, z), s64)
    u_plain = spectral_cuda.lerp_contract_plain(spec, table, shape[2], avg)
    scale = float(u64.abs().max())
    worst, worst_single = 0.0, 0.0
    for g in range(groups):
        # depth avg * Z: the group's tilt rows one after another
        s = torch.cat([spec[:, rows_y[g * avg + j], :] for j in range(avg)])  # (768, xh)
        t = torch.cat([table[g * avg + j] for j in range(avg)], dim=1)  # (x_out, 768)
        assert s.shape[0] == avg * z == 768
        got = tf32x3_contraction(s, t)
        worst = max(worst, float((got.to(torch.complex128) - u64[g]).abs().max()) / scale)
        single = torch.complex(tf32_rna(s.real).double().T @ tf32_rna(t.real).double().T
                               - tf32_rna(s.imag).double().T @ tf32_rna(t.imag).double().T,
                               tf32_rna(s.real).double().T @ tf32_rna(t.imag).double().T
                               + tf32_rna(s.imag).double().T @ tf32_rna(t.real).double().T)
        worst_single = max(worst_single, float((single - u64[g]).abs().max()) / scale)
    plain_err = float((u_plain.to(torch.complex128) - u64).abs().max()) / scale
    assert worst <= SPECTRAL_TOL
    assert worst <= 10 * max(plain_err, 1e-7)  # as close as float32 itself
    assert worst_single > SPECTRAL_TOL


def _source_constants() -> dict:
    text = (CSRC / "spectral.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", text))
    return {k: int(v) for k, v in consts.items()}


def test_contract_plan_matches_the_source():
    c = _source_constants()
    assert spectral_cuda.CONTRACT_TILE == (c["kBM"], c["kBN"], c["kBK"])
    assert spectral_cuda._STAGES == c["kStages"]
    assert spectral_cuda._S_STRIDE == c["kBM"] + 4 and spectral_cuda._T_STRIDE == c["kBK"] + 4
    assert spectral_cuda._PLANES == c["kPlanes"]
    assert c["kThreads"] == 2 * c["kBM"]  # a warpgroup's 64 rows each, 16 a warp
    # the MMA fragment loads, 8 bytes a lane: 16 distinct bank pairs a half-warp
    for stride in (spectral_cuda._S_STRIDE, spectral_cuda._T_STRIDE):
        assert len({(stride * r + col) % 16 for r in range(4) for col in range(4)}) == 16


def _spectral_shapes():
    """(Z, Y, X, x_out, groups, avg) at chip_smoke.py's SPECTRAL_CASES and at
    the ragged edges."""
    out = []
    for shape, avg, keep in chip_smoke.SPECTRAL_CASES:
        geo = spectral.deskew_geometry(shape, ANGLE, RATIO, keep, avg)
        out.append((*shape, geo.x_out, geo.groups, avg))
    out += [(43, 5, 3, 7, 2, 3), (16, 4, 2048, 129, 4, 1), (17, 3, 300, 257, 2, 2),
            (8, 2, 8192, 3, 1, 2), (8, 2, 4095, 5, 1, 2), (5, 3, 97, 128, 3, 1)]
    return out


@pytest.mark.parametrize("z,y,x,x_out,groups,avg", _spectral_shapes())
def test_contract_plan_covers_and_pads(z, y, x, x_out, groups, avg):
    bm, bn, bk = spectral_cuda.CONTRACT_TILE
    plan = spectral_cuda.contract_plan(z, x, x_out, groups, avg)
    gx, gy, gz = plan.grid
    assert gz == groups <= 65535
    # kx < X//2 on the tensor cores (the last row apart), no empty tile
    assert (gx - 1) * bm < max(x // 2, 1) <= gx * bm
    assert (gy - 1) * bn < x_out <= gy * bn
    assert 0 <= plan.kz_pad < bk and (z + plan.kz_pad) % bk == 0
    assert plan.stages == avg * (z + plan.kz_pad) // bk
    assert plan.smem == 4 * 4 * bn * bk + 8 * 3 * (bk * (bm + 4) + bn * (bk + 4) + bk) <= SMEM_MAX


def _irfft_elems(x: int, radices, tab: int, lines: int) -> int:
    """csrc/spectral.cu irfft_elems."""
    if radices:
        return tab + (1 if len(radices) <= 2 else 2) * (lines * x + lines * x // 16 + 1)
    m = 1 << (2 * x - 2).bit_length()
    assert tab >= m // 2 + x + m
    return tab + lines * m


@pytest.mark.parametrize("layout", ["zyx", "xzy"])
@pytest.mark.parametrize("z,y,x,x_out,groups,avg", _spectral_shapes())
def test_irfft_plan_covers_and_fits(z, y, x, x_out, groups, avg, layout):
    plan = spectral_cuda.irfft_plan(x, x_out, groups, layout)
    lines = 1 << plan.log2l
    pairs = -(-x_out // 2)
    assert plan.x == fft.radix_plan(x)
    assert lines <= (8 if layout == "zyx" else 16)
    assert lines // 2 < pairs or lines == 1  # no tile wider than the columns need
    assert plan.tiles == groups * -(-pairs // lines)
    assert plan.smem == 8 * _irfft_elems(x, plan.x, plan.tab, lines) <= SMEM_MAX
    assert plan.per_sm == (2 if plan.smem <= 112 * 1024 else 1)
    assert 1 <= plan.grid(132) <= min(plan.tiles, 2 * 132)


def test_irfft_plan_at_the_headline():
    """The zyx store's rows take 8 column pairs (a block an SM), the xzy
    store 4 (two blocks an SM)."""
    zyx = spectral_cuda.irfft_plan(1024, 484, 86, "zyx")
    xzy = spectral_cuda.irfft_plan(1024, 484, 86, "xzy")
    assert zyx.x == xzy.x == (16, 8, 8)
    assert (1 << zyx.log2l, zyx.per_sm, zyx.tiles) == (8, 1, 86 * 31)
    assert (1 << xzy.log2l, xzy.per_sm, xzy.tiles) == (4, 2, 86 * 61)


@pytest.mark.parametrize("z,y,x,x_out,groups,avg", _spectral_shapes())
def test_column_plan_covers_and_fits(z, y, x, x_out, groups, avg):
    xh = x // 2 + 1
    plan = fft.column_plan((z, y, xh))
    tk = 1 << plan.log2tk
    assert plan.y == fft.radix_plan(y) and plan.log2tk <= 5
    assert (plan.tiles - 1) * tk < xh <= plan.tiles * tk  # one block a tile, none empty
    if plan.y:
        bufs = 1 if len(plan.y) <= 2 else 2
        want = plan.ytab + bufs * (tk * y + tk * y // 16 + 1)
        assert plan.ytab == y
    else:
        m = 1 << (2 * y - 2).bit_length()
        assert plan.ytab == m // 2 + y + m
        want = plan.ytab + tk * m
    assert plan.smem == 8 * want <= SMEM_MAX


def test_column_plan_takes_c_columns_at_the_headline():
    plan = fft.column_plan((256, 256, 513))
    c = fft.slice_plan((256, 256, 1024))
    assert (plan.y, plan.log2tk, plan.ytab) == (c.y, c.log2tk, c.ytab) == ((16, 16), 5, 256)
    assert plan.tiles == 17 and plan.per_sm == 2


class FakeLib:
    """The C entries of L and M: record the arguments, return ``rc``."""

    def __init__(self, rc: int = 0):
        self.rc, self.calls = rc, []

    def _entry(self, name):
        def call(*args):
            self.calls.append((name, args))
            return self.rc
        return call

    def __getattr__(self, name):
        if name in ("y_inv", "lerp_contract", "lerp_irfft"):
            return self._entry(name)
        raise AttributeError(name)

    def error_string(self, rc):
        return b"launch refused"


@contextlib.contextmanager
def fake_card(monkeypatch, lib):
    monkeypatch.setattr(_build, "on_card", lambda t, what: True)
    monkeypatch.setattr(_build, "stream_of", lambda t: None)
    monkeypatch.setattr(_build, "library", lambda name, sigs: lib)
    monkeypatch.setattr(fft, "_lib", lambda: lib)
    monkeypatch.setattr(spectral_cuda, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    _build.reset_launch_counts()
    yield


def test_wrappers_pass_the_plans(monkeypatch):
    shape, avg = (43, 97, 121), 3
    geo = spectral.deskew_geometry(shape, ANGLE, RATIO, False, avg)
    xh = shape[2] // 2 + 1
    spec = torch.zeros((shape[0], shape[1], xh), dtype=torch.complex64)
    table = torch.zeros((geo.groups * avg, geo.x_out, shape[0]), dtype=torch.complex64)
    lib = FakeLib()
    with fake_card(monkeypatch, lib):
        fft.y_inv_(spec)
        spectral_cuda.lerp_irfft(spec, table, shape[2], avg, "xzy")
        assert _build.launch_counts == {"y_inv": 1, "lerp_contract": 1, "lerp_irfft": 1}
    (n0, a0), (n1, a1), (n2, a2) = lib.calls
    assert n0 == "y_inv" and a0[1:6] == fft.column_plan(spec.shape).args()
    assert a0[6:9] == spec.shape
    assert n1 == "lerp_contract" and a1[3:9] == (*shape, geo.x_out, geo.groups, avg)
    plan = spectral_cuda.irfft_plan(shape[2], geo.x_out, geo.groups, "xzy")
    assert n2 == "lerp_irfft" and a2[2:7] == plan.args(plan.grid(132))
    assert a2[7:11] == (shape[2], geo.x_out, geo.groups, 1)
    with fake_card(monkeypatch, FakeLib(rc=1)):
        with pytest.raises(RuntimeError, match=r"y_inv_ \(Y Bluestein.*launch refused"):
            fft.y_inv_(spec)
        with pytest.raises(RuntimeError, match=r"lerp_contract: CUDA error 1"):
            spectral_cuda.lerp_contract(spec, table, shape[2], avg)
        assert _build.launch_counts == {}


def test_m_beyond_the_previous_x_limit_and_up_to_the_fft_limits():
    for x in (2048, 4096, 8192, 1027, 4095):
        assert spectral_cuda.lerp_irfft_fits(x)
    for x in (1, 4097, 16384):
        assert not spectral_cuda.lerp_irfft_fits(x)
    with pytest.raises(ValueError, match="exceeds the kernel's limits"):
        spectral_cuda._check_x(4097, "lerp_irfft")


@pytest.mark.parametrize("layout", ["zyx", "xzy"])
def test_plain_launches_compose_to_m(layout):
    shape, avg = (16, 10, 40), 2
    geo = spectral.deskew_geometry(shape, ANGLE, RATIO, False, avg)
    g = torch.Generator().manual_seed(3)
    xh = shape[2] // 2 + 1
    spec = torch.randn((shape[0], shape[1], xh), dtype=torch.complex64, generator=g)
    table = torch.randn((geo.groups * avg, geo.x_out, shape[0]), dtype=torch.complex64,
                        generator=g)
    _build.reset_launch_counts()
    u = spectral_cuda.lerp_contract(spec, table, shape[2], avg)
    assert u.shape == (geo.groups, xh, geo.x_out)
    got = spectral_cuda.irfft_columns(u, shape[2], layout)
    assert _build.launch_counts == {}
    want = spectral_cuda.lerp_irfft_plain(spec, table, shape[2], avg, layout)
    assert torch.equal(got, want)
    assert torch.equal(spectral_cuda.lerp_irfft(spec, table, shape[2], avg, layout), want)
    # the irfft reads U and leaves it as it was (the plain version drops the
    # imaginary parts of kx = 0 and X/2 on a copy)
    assert u[:, 0].imag.any()


@pytest.fixture
def spectral_route(monkeypatch):
    monkeypatch.setenv("BIAHUB_TPU_FORCE_PALLAS", "1")
    monkeypatch.setenv("BIAHUB_TPU_SPECTRAL_DESKEW", "1")
    monkeypatch.setenv("BIAHUB_TPU_FFT_RADIX_MIN", "16")
    monkeypatch.setenv("BIAHUB_TPU_FFT_PRECISION", "highest")
    jax.clear_caches()
    yield
    jax.clear_caches()


def test_engine_past_the_previous_x_limit_matches_reference(spectral_route):
    """X = 2560 (the previous kernel M took at most 2048 for a power of two
    and 1025 otherwise): the port's spectral route against the reference's
    engine in interpret mode, within ENGINE_TOL of max|ref|."""
    shape, avg = (8, 8, 2560), 2
    vol = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    tf = tf_half(shape)
    kw = dict(ls_angle_deg=ANGLE, px_to_scan_ratio=RATIO, keep_overhang=False,
              average_window=avg)
    assert jspec.spectral_deskew_supported(shape, ANGLE, RATIO, False, avg)
    assert spectral.spectral_deskew_supported(shape, ANGLE, RATIO, False, avg)
    want = np.asarray(jspec.deconvolve_deskew_zyx_spectral(jnp.asarray(vol), jnp.asarray(tf),
                                                           1e-3, **kw))
    got = spectral.deconvolve_deskew_zyx_spectral(vol, tf, 1e-3, **kw, device="cpu").numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= ENGINE_TOL * np.abs(want).max()
    assert math.isfinite(float(np.abs(got).max()))
