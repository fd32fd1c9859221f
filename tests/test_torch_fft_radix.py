"""Kernels A and C's mixed-radix plan and line passes, on the CPU.

- :func:`radix_plan` at every length the port's paths meet: the radices
  multiply back to n, come from the radix set, and the plan is None (a
  Bluestein line) exactly when n has a prime factor above 11.
- A numpy model of ``csrc/fft_radix.cuh``'s Stockham passes (the index map
  of each pass, the twiddle table's layout, the in-register DFTs' formulas
  and their literal coefficients) against ``torch.fft`` forward and inverse,
  within 1e-5 of max|ref|; the model is the tests' only, the kernel runs on
  the card (``chip_smoke.py`` phase 13).
- :func:`slice_plan`: every accepted axis fits a block's shared memory, a
  slice takes 8 blocks (at most its tiles), and the wrapper hands the plan to the C
  entry (a fake library) and names it when the launch is refused.
- ``fwd_yx`` and ``inv_yx`` (their plain versions on the CPU) at radix-7
  and radix-11 shapes through ``fourier_filter_zyx`` against the reference's
  ``fourier_filter_zyx_pallas`` in interpret mode, as
  ``tests/test_torch_fft_lengths.py`` runs it; tolerance 1e-5 x max|ref|.
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

from biahub_tpu_torch.kernels import _build
from biahub_tpu_torch.kernels import fft as tfft

RTOL = 1e-5
RADIX_SRC = Path(tfft.__file__).resolve().parents[1] / "csrc" / "fft_radix.cuh"
# Every axis length the port's paths give A and C: the PCC crop's and the
# headline's powers of two, the deskewed FOV's 484 (and its crop 121),
# custom_padding's next_fast_len 1232 and 308, and the odd test shapes.
PATH_LENGTHS = (2, 3, 9, 10, 17, 97, 121, 256, 308, 484, 1024, 1232, 4096)


def prime_factors(n: int) -> list[int]:
    out, p = [], 2
    while p * p <= n:
        while n % p == 0:
            out.append(p)
            n //= p
        p += 1
    return out + ([n] if n > 1 else [])


@pytest.mark.parametrize("n", PATH_LENGTHS)
def test_radix_plan_covers_every_path_length(n):
    plan = tfft.radix_plan(n)
    if max(prime_factors(n)) > 11:
        assert plan is None
        return
    assert plan is not None and math.prod(plan) == n
    assert set(plan) <= set(tfft.RADICES)
    pow2 = [r for r in plan if r & (r - 1) == 0]
    assert plan[:len(pow2)] == tuple(pow2) == tuple(sorted(pow2, reverse=True))
    assert len(pow2) == -(-int(math.log2(math.prod(pow2))) // 4)
    # the C side's packing: 5 bits a radix, first pass lowest
    code = tfft._plan_code(plan)
    assert [(code >> (5 * i)) & 31 for i in range(len(plan) + 1)] == [*plan, 0]


def test_radix_plan_examples():
    assert tfft.radix_plan(1024) == (16, 8, 8)
    assert tfft.radix_plan(484) == (4, 11, 11)
    assert tfft.radix_plan(1232) == (16, 11, 7)
    assert tfft.radix_plan(8192) == (16, 8, 8, 8)
    with pytest.raises(ValueError, match="at least 2"):
        tfft.radix_plan(1)


def literal_table(func: str) -> dict:
    """The float literals a constexpr switch of fft_radix.cuh returns, by
    case label (its default under the label its comment names)."""
    body = RADIX_SRC.read_text().split(f"constexpr float {func}(int")[1].split("\n}\n")[0]
    table = {}
    for label, value in re.findall(r"case ([^:]+): return (-?[0-9.e+-]+)f;", body):
        table[eval(label)] = float(value)  # labels are integer expressions
    default = re.search(r"default: return (-?[0-9.e+-]+)f;(?:\s*// (\d+), (\d+))?", body)
    return table, default


def unit(r: int, m: int) -> tuple[float, float]:
    """cos and sin of 2 pi m / r as the kernel's literals give them."""
    cos_t, cos_d = literal_table("unit_cos")
    sin_t, sin_d = literal_table("unit_sin")
    key = r * 16 + m
    c = cos_t.get(key, float(cos_d.group(1)) if (r, m) == (11, 5) else None)
    s = sin_t.get(key, float(sin_d.group(1)) if (r, m) == (11, 5) else None)
    return c, s


@pytest.mark.parametrize("r", [3, 5, 7, 11])
def test_odd_radix_literals(r):
    for m in range(1, (r - 1) // 2 + 1):
        c, s = unit(r, m)
        assert abs(c - math.cos(2 * math.pi * m / r)) < 1e-7
        assert abs(s - math.sin(2 * math.pi * m / r)) < 1e-7


def test_radix16_literals():
    table, default = literal_table("cos16")
    table[7] = float(default.group(1))
    for m in range(8):
        assert abs(table[m] - math.cos(2 * math.pi * m / 16)) < 1e-7


def dft_model(v: np.ndarray, r: int, inverse: bool) -> np.ndarray:
    """The in-register r-point DFT of each row of v (..., r): a radix-2 DIF
    and a bit-reversal for powers of two, the symmetric sums for odd primes,
    with the kernel's literal coefficients in float32."""
    sign = 1.0 if inverse else -1.0
    if r & (r - 1) == 0:
        v = v.copy()
        h = r // 2
        while h >= 1:
            for i0 in range(0, r, 2 * h):
                for k in range(h):
                    a, b = v[..., i0 + k].copy(), v[..., i0 + k + h].copy()
                    m = k * (8 // h)
                    w = np.complex64(np.float32(math.cos(2 * math.pi * m / 16))
                                     + 1j * sign * np.float32(math.sin(2 * math.pi * m / 16)))
                    v[..., i0 + k] = a + b
                    v[..., i0 + k + h] = (a - b) * w
            h //= 2
        bits = r.bit_length() - 1
        rev = [int(format(i, f"0{bits}b")[::-1], 2) if bits else 0 for i in range(r)]
        out = np.empty_like(v)
        out[..., rev] = v
        return out
    h = (r - 1) // 2
    a = {n: v[..., n] + v[..., r - n] for n in range(1, h + 1)}
    b = {n: v[..., n] - v[..., r - n] for n in range(1, h + 1)}
    out = np.empty_like(v)
    out[..., 0] = v[..., 0] + sum(a.values())
    for k in range(1, h + 1):
        ac, bs = v[..., 0].copy(), np.zeros_like(v[..., 0])
        for n in range(1, h + 1):
            m = (n * k) % r
            c, s = unit(r, m if 2 * m < r else r - m)
            s = s if 2 * m < r else -s
            ac = ac + a[n] * np.float32(c)
            bs = bs + b[n] * np.float32(s)
        minus, plus = ac - 1j * bs, ac + 1j * bs
        out[..., k], out[..., r - k] = (plus, minus) if inverse else (minus, plus)
    return out


def stockham_model(x: np.ndarray, plan, inverse: bool) -> np.ndarray:
    """The kernel's passes over lines x (..., n): pass p (radix r, ns points
    combined) loads points j + q n/r of butterfly j, multiplies point q by
    the table entry ns - 1 + (q - 1) ns + k (k = j mod ns), takes the r-point
    DFT and stores output q at (j - k) r + k + q ns."""
    n = x.shape[-1]
    table = np.zeros(n - 1, np.complex64)
    ns = 1
    for r in plan:
        for i in range((r - 1) * ns):
            q, k = i // ns + 1, i % ns
            table[ns - 1 + i] = np.exp(-2j * np.pi * (q * k) / (ns * r))
        ns *= r
    src, ns = x.astype(np.complex64), 1
    for r in plan:
        nr = n // r
        j = np.arange(nr)
        k = j % ns
        v = np.stack([src[..., j + q * nr] for q in range(r)], -1)
        if ns > 1:
            w = np.stack([np.ones(nr, np.complex64)]
                         + [table[ns - 1 + (q - 1) * ns + k] for q in range(1, r)], -1)
            v = v * (np.conj(w) if inverse else w)
        v = dft_model(v, r, inverse)
        dst = np.empty_like(src)
        d = (j - k) * r + k
        for q in range(r):
            dst[..., d + q * ns] = v[..., q]
        src, ns = dst, ns * r
    return src


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", [n for n in PATH_LENGTHS if tfft.radix_plan(n)] + [96, 160, 2187])
def test_stockham_model_matches_torch_fft(n, inverse):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))).astype(np.complex64)
    got = stockham_model(x, tfft.radix_plan(n), inverse)
    t = torch.from_numpy(x.astype(np.complex128))
    want = (torch.fft.ifft(t, dim=-1) * n if inverse else torch.fft.fft(t, dim=-1)).numpy()
    assert np.abs(got - want).max() <= RTOL * np.abs(want).max()


def test_plan_codes_follow_radix_plan():
    plan = tfft.slice_plan((77, 1232, 308))
    ycode, xcode = plan.args()[:2]
    assert (plan.y, plan.x) == (tfft.radix_plan(1232), tfft.radix_plan(308))
    assert (ycode, xcode) == (tfft._plan_code(plan.y), tfft._plan_code(plan.x))
    blue = tfft.slice_plan((43, 97, 121))
    assert blue.y is None and blue.args()[0] == 0 and blue.x == (11, 11)


@pytest.mark.parametrize("n", [2, 3, 17, 484, 1232, 4093, 4096, 8192])
def test_every_accepted_axis_fits_a_block(n):
    for shape in ((1, n, 8192), (1, 8192, n), (1, n, 4093), (1, 4093, n), (3, n, n)):
        plan = tfft.slice_plan(shape)
        assert plan.smem <= tfft._SMEM_ONE
        assert plan.per_sm == (2 if plan.smem <= tfft._SMEM_TWO else 1)
        assert plan.cluster in (1, 2, 4, 8) and plan.grid == shape[0] * plan.cluster


@pytest.mark.parametrize("shape,cluster", [((256, 256, 1024), 8), ((64, 256, 1024), 8),
                                           ((86, 1024, 484), 8), ((64, 1024, 256), 8),
                                           ((77, 1232, 308), 8), ((4, 64, 40), 2), ((1, 2, 2), 1)])
def test_cluster_is_8_blocks_at_most_the_tiles(shape, cluster):
    plan = tfft.slice_plan(shape)
    assert plan.cluster == cluster and plan.grid == shape[0] * cluster


class PlanLib:
    """A and C's C entries: record the arguments, return ``rc``."""

    def __init__(self, rc: int = 0):
        self.rc, self.calls = rc, []

    def _entry(self, *args):
        self.calls.append(args)
        return self.rc

    fwd_yx = inv_yx = _entry

    def error_string(self, rc):
        return b"cluster misconfiguration"


@contextlib.contextmanager
def fake_card(monkeypatch, lib):
    monkeypatch.setattr(_build, "on_card", lambda t, what: True)
    monkeypatch.setattr(_build, "stream_of", lambda t: None)
    monkeypatch.setattr(tfft, "_lib", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    _build.reset_launch_counts()
    yield


@pytest.mark.parametrize("kernel", ["fwd_yx", "inv_yx"])
def test_wrappers_pass_the_plan_and_name_it_on_failure(kernel, monkeypatch):
    shape = (86, 44, 484)
    vol = torch.zeros(shape)
    spec = torch.zeros(tfft.half_spectrum_shape(shape), dtype=torch.complex64)
    call = (lambda: tfft.fwd_yx(vol)) if kernel == "fwd_yx" else (
        lambda: tfft.inv_yx(spec, out=torch.empty(shape)))
    plan = tfft.slice_plan(shape)
    lib = PlanLib()
    with fake_card(monkeypatch, lib):
        call()
        assert _build.launch_counts == {kernel: 1}
    args = lib.calls[0]
    assert args[-12:-4] == plan.args() and args[-4:-1] == shape
    with fake_card(monkeypatch, PlanLib(rc=9)):
        with pytest.raises(RuntimeError, match=r"cluster 8, grid 688.*misconfiguration"):
            call()
        assert _build.launch_counts == {}


@pytest.fixture
def pallas_route(monkeypatch):
    monkeypatch.setenv("BIAHUB_TPU_FORCE_PALLAS", "1")
    monkeypatch.setenv("BIAHUB_TPU_FFT_RADIX_MIN", "16")
    monkeypatch.setenv("BIAHUB_TPU_FFT_PRECISION", "highest")
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.mark.parametrize("shape", [(3, 44, 121), (2, 154, 77)])
def test_radix_shapes_match_reference_pallas(shape, pallas_route):
    from biahub_tpu.kernels.pallas_fft import fourier_filter_zyx_pallas

    rng = np.random.default_rng(7)
    vol = rng.standard_normal(shape).astype(np.float32)
    h = np.fft.fftn(rng.standard_normal(shape)).astype(np.complex64)
    filt = tfft.prepare_hermitian_filter(shape, h, 1e-2, device="cpu")
    want = np.asarray(fourier_filter_zyx_pallas(
        jnp.asarray(vol), jnp.asarray(filt.real.numpy()), jnp.asarray(filt.imag.numpy())))
    _build.reset_launch_counts()
    got = tfft.fourier_filter_zyx(torch.from_numpy(vol), filt)
    assert _build.launch_counts == {}
    assert np.abs(got.numpy() - want).max() <= RTOL * np.abs(want).max()
    # and A and C alone against numpy's transforms in float64
    spec = tfft.fwd_yx(torch.from_numpy(vol))
    ref = np.fft.rfft2(vol.astype(np.float64))
    assert np.abs(spec.numpy() - ref).max() <= RTOL * np.abs(ref).max()
    back = tfft.inv_yx(spec, out=torch.empty(shape))
    assert np.abs(back.numpy() - vol).max() <= RTOL * np.abs(vol).max()
