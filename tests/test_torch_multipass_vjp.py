"""The port's multipass VJP (kernels I and J's plain versions, the
differentiable pass and the traced warp) against biahub_tpu's.

The port's pass is the reference's XLA pass ``_apply_pass`` (per-pass fill,
taps clamped to the frame), so its VJP is held against ``jax.vjp`` of that
pass and ``jax.grad`` of the reference's traced warp with
``use_pallas=False``: the data cotangent within 1e-5 * max|ref|; the
coefficient cotangents within 5e-5 * the largest of the three, because
JAX's float32 autodiff is itself that far from exact (it multiplies the
cotangent into each tap before the taps cancel, and sums ~2000 such terms
in float32: up to 2e-5 of the largest here), while the port's float64 sums
are held within 1e-6 relative of float64 central differences of the pass;
the warp within 1e-5 * max|ref|, a loss gradient within rtol 1e-4. The reference's Pallas VJP (interpret mode) has no per-pass fill and
drops clamped edge taps: it is held on the interior only, and the whole
warp's gradient at the reference's own tolerance between its two routes
(tests/test_warp_kernels.py:272-305: loss within 1e-5 relative, gradient
rtol 1e-3, atol 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter
from scipy.spatial.transform import Rotation

from biahub_tpu.kernels import multipass_warp as jmp
from biahub_tpu.kernels import pallas_resample as jpr
from biahub_tpu_torch.kernels import multipass_cuda
from biahub_tpu_torch.kernels import multipass_warp as tmp
from tests.test_torch_chain import pallas_route  # noqa: F401  (fixture)

RTOL = 1e-5
COEFF_TOL = 5e-5
FRAME = (10, 13, 15)
FILL = -0.5


def smooth(shape, seed) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return gaussian_filter(rng.random(shape), 1.5).astype(np.float32)


def pass_coefficients(seed: int, negative: bool = False) -> np.ndarray:
    """(cr, co, tau) with cr in [0.7, 1.4] (or its negative) and a shift
    that sends part of the frame out of the domain."""
    rng = np.random.default_rng(seed)
    cr = rng.uniform(0.7, 1.4)
    tau = rng.uniform(-1.5, 1.5)
    if negative:
        cr, tau = -cr, tau + 12.0
    return np.array([cr, rng.uniform(-0.2, 0.2), tau], np.float32)


def pass_layout(r: int, o: int) -> tuple[int, int, int]:
    """_apply_pass's (o, r, third) layout of the frame's axes."""
    if o == r:
        others = [ax for ax in range(3) if ax != r]
        return (others[0], r, others[1])
    return (o, r, 3 - r - o)


def reference_vjp(frame, ybar, coeffs, r, o, order):
    """jax.vjp of the reference's _apply_pass: (data cotangent, (cr, co,
    tau) cotangents)."""
    def f(d, cr, co, tau):
        return jmp._apply_pass(d, r, o, cr, co, tau, FILL, r == o, order=order)

    args = (jnp.asarray(frame),) + tuple(jnp.float32(c) for c in coeffs)
    _, vjp = jax.vjp(f, *args)
    cot = vjp(jnp.asarray(ybar))
    return np.asarray(cot[0]), np.array([float(c) for c in cot[1:]])


CASES = [(slot, order, False) for slot in range(len(tmp.CANONICAL_SLOTS)) for order in (1, 3)]
CASES += [(5, 3, True), (0, 1, True)]


@pytest.mark.parametrize("slot,order,negative", CASES)
def test_pass_vjp_matches_jax_vjp_of_apply_pass(slot, order, negative):
    r, o = tmp.CANONICAL_SLOTS[slot]
    coeffs = pass_coefficients(10 * slot + order, negative)
    frame = smooth(FRAME, slot)
    ybar = np.random.default_rng(100 + slot).uniform(-1, 1, FRAME).astype(np.float32)
    want_d, want_c = reference_vjp(frame, ybar, coeffs, r, o, order)
    if o == r:
        want_c[1] = 0.0  # the pass has no co term
    table = torch.from_numpy(coeffs)[None]
    src, yb = torch.from_numpy(frame)[None], torch.from_numpy(ybar)[None]
    got_c = multipass_cuda.resample_pass_deriv(src, yb, table, 0, r, o, order)
    assert got_c.shape == (1, 3) and got_c.dtype == torch.float64
    assert np.abs(got_c[0].numpy() - want_c).max() <= COEFF_TOL * np.abs(want_c).max()
    got_d = multipass_cuda.resample_pass_adjoint(yb, table, 0, r, o, order)[0].numpy()
    assert got_d.dtype == np.float32
    assert np.abs(got_d - want_d).max() <= RTOL * np.abs(want_d).max()
    # The domain test is H's: some samples leave the domain, some stay.
    c = tmp._pass_coords(src.shape, table, 0, r, o)
    inside = ((c >= 0) & (c <= FRAME[r] - 1)).expand(src.shape)
    assert 0 < int(inside.sum()) < inside.numel()


@pytest.mark.parametrize("slot,order,negative", [(0, 1, False), (4, 3, False), (5, 3, True),
                                                  (6, 3, False)])
def test_deriv_is_the_exact_gradient_of_the_pass(slot, order, negative):
    """Kernel I's plain version against float64 central differences of
    <ybar, pass(src; cr, co, tau)>, the pass evaluated in float64."""
    r, o = tmp.CANONICAL_SLOTS[slot]
    coeffs = pass_coefficients(10 * slot + order, negative)
    src = torch.from_numpy(smooth(FRAME, slot))[None]
    yb = torch.from_numpy(np.random.default_rng(100 + slot).uniform(-1, 1, FRAME)
                          .astype(np.float32))[None]
    got = multipass_cuda.resample_pass_deriv(src, yb, torch.from_numpy(coeffs)[None], 0, r, o,
                                             order)[0].numpy()

    def objective(c):
        out = tmp.resample_pass_plain(src.double(), torch.from_numpy(c)[None], 0, r, o, order)
        return float((out * yb.double()).sum())

    h = 1e-7
    c0 = coeffs.astype(np.float64)
    fd = np.array([(objective(c0 + h * e) - objective(c0 - h * e)) / (2 * h)
                   for e in np.eye(3)])
    if o == r:
        fd[1] = 0.0
    np.testing.assert_allclose(got, fd, rtol=1e-6, atol=1e-9)


def test_adjoint_is_the_transpose_of_the_pass():
    """<H x, y> == <x, J y> for both orders and a table of one row per
    volume, within 1e-5 relative (float64 sums of float32 outputs)."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2,) + FRAME).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((2,) + FRAME).astype(np.float32))
    table = torch.from_numpy(np.stack([pass_coefficients(1), pass_coefficients(2, True)])
                             [:, None])
    for order in (1, 3):
        hx = multipass_cuda.resample_pass(x, table, 0, 1, 0, order, 0.0)
        jy = multipass_cuda.resample_pass_adjoint(y, table, 0, 1, 0, order)
        lhs = (hx.double() * y.double()).sum((1, 2, 3))
        rhs = (x.double() * jy.double()).sum((1, 2, 3))
        np.testing.assert_allclose(lhs.numpy(), rhs.numpy(), rtol=RTOL)


@pytest.mark.parametrize("slot", [0, 3, 6])
def test_pass_vjp_matches_the_pallas_kernels_on_the_interior(slot, pallas_route):
    """The reference's Pallas deriv and adjoint kernels in their (O, R, T)
    layout, with a cotangent that is 0 within 3 voxels of the r edges, so
    that no sample leaves the domain or clamps a tap."""
    r, o = tmp.CANONICAL_SLOTS[slot]
    order = 3
    rng = np.random.default_rng(slot)
    coeffs = np.array([rng.uniform(0.95, 1.05), rng.uniform(-0.05, 0.05),
                       rng.uniform(-0.5, 0.5)], np.float32)
    frame = smooth(FRAME, 20 + slot)
    ybar = rng.uniform(-1, 1, FRAME).astype(np.float32)
    edge = [slice(None)] * 3
    edge[r] = np.r_[0:3, FRAME[r] - 3:FRAME[r]]
    ybar[tuple(edge)] = 0.0
    if o == r:
        coeffs[1] = 0.0  # the Pallas kernel always adds co * o
    o_ax, _, third = perm = pass_layout(r, o)
    d_ort = jnp.transpose(jnp.asarray(frame), perm)
    k_bound = int(np.ceil(jpr.TILE_R * 1.5)) + 4
    jc = jnp.asarray(coeffs)
    dv = jpr.shear_resample_deriv_dyn(d_ort, FRAME[r], jc, k_bound, order)  # (O, T, R)
    yb_otr = jnp.transpose(jnp.asarray(ybar), (o_ax, third, r))
    q = jnp.arange(FRAME[r], dtype=jnp.float32)[None, None, :]
    oi = jnp.arange(FRAME[o_ax], dtype=jnp.float32)[:, None, None]
    want_c = np.array([float(jnp.sum(yb_otr * dv * q)), float(jnp.sum(yb_otr * dv * oi)),
                       float(jnp.sum(yb_otr * dv))])
    if o == r:
        want_c[1] = 0.0
    dbar = jpr.shear_resample_adjoint_dyn(jnp.transpose(yb_otr, (0, 2, 1)), FRAME[r], jc,
                                          k_bound, order)  # (O, T, R_in)
    want_d = np.transpose(np.asarray(dbar), np.argsort((o_ax, third, r)))
    table = torch.from_numpy(coeffs)[None]
    src, yb = torch.from_numpy(frame)[None], torch.from_numpy(ybar)[None]
    got_c = multipass_cuda.resample_pass_deriv(src, yb, table, 0, r, o, order)[0].numpy()
    np.testing.assert_allclose(got_c, want_c, rtol=1e-4, atol=1e-6 * np.abs(want_c).max())
    got_d = multipass_cuda.resample_pass_adjoint(yb, table, 0, r, o, order)[0].numpy()
    assert np.abs(got_d - want_d).max() <= RTOL * np.abs(want_d).max()


def similarity(angles_deg, shift, scale: float = 1.0) -> np.ndarray:
    m = np.eye(4)
    m[:3, :3] = scale * Rotation.from_euler("xyz", angles_deg, degrees=True).as_matrix()
    m[:3, 3] = shift
    return m.astype(np.float32)


@pytest.mark.parametrize("order", [1, 3])
def test_traced_warp_matches_the_reference_xla_route(order):
    vol = smooth((12, 20, 18), 4)
    m = similarity([3, -2, 4], [0.6, -1.1, 0.8], 1.02)
    out_shape = (11, 21, 18)
    ref = jmp.make_traced_multipass_warp(vol.shape, out_shape, fill=FILL, margin=0.2,
                                         order=order, use_pallas=False)
    want = np.asarray(ref(vol, m))
    warp = tmp.make_traced_multipass_warp(vol.shape, out_shape, fill=FILL, margin=0.2,
                                          order=order, device="cpu")
    got = warp(torch.from_numpy(vol), torch.from_numpy(m)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= RTOL * np.abs(want).max()
    np.testing.assert_array_equal(got == FILL, want == FILL)


def test_traced_warp_matches_the_concrete_multipass_warp():
    """As tests/test_registration.py:89-121: the traced warp (default
    margin and order) within 2e-3 of the concrete-matrix warp."""
    vol = gaussian_filter(np.random.default_rng(1).random((20, 32, 28)), 2.0).astype(np.float32)
    m = np.eye(4)
    m[:3, :3] = 1.03 * Rotation.from_euler("xyz", [7, -4, 10], degrees=True).as_matrix()
    m[:3, 3] = [1.0, -2.0, 1.5]
    warp = tmp.make_traced_multipass_warp(vol.shape, vol.shape, device="cpu")
    got = warp(torch.from_numpy(vol), torch.tensor(m, dtype=torch.float32)).numpy()
    want = np.asarray(jmp.multipass_affine_warp_zyx(vol, m, vol.shape))
    assert np.abs(got - want).max() < 2e-3


def loss_setup():
    """tests/test_warp_kernels.py:272-305's optimizer-style loss."""
    rng = np.random.default_rng(3)
    vol = gaussian_filter(rng.random((16, 40, 36)), 2.0).astype(np.float32)
    target = gaussian_filter(rng.random((16, 40, 36)), 2.0).astype(np.float32)
    p0 = np.array([0.5, -1.0, 0.7, 0.03, -0.05], np.float32)
    return vol, target, p0


def reference_loss_and_grad(use_pallas: bool):
    vol, target, p0 = loss_setup()
    w = jmp.make_traced_multipass_warp(vol.shape, vol.shape, margin=0.2, order=1,
                                       use_pallas=use_pallas)

    def loss(p):
        m = jnp.eye(4).at[:3, 3].set(p[:3])
        m = m.at[0, 0].set(1.0 + p[3]).at[1, 2].set(p[4])
        return jnp.sum((w(vol, m) - target) ** 2)

    value, grad = jax.value_and_grad(loss)(jnp.asarray(p0))
    return float(value), np.asarray(grad)


def port_loss_and_grad():
    vol, target, p0 = loss_setup()
    w = tmp.make_traced_multipass_warp(vol.shape, vol.shape, margin=0.2, order=1, device="cpu")
    p = torch.tensor(p0, requires_grad=True)
    m = torch.eye(4).index_put((torch.arange(3), torch.full((3,), 3)), p[:3])
    m = m.index_put((torch.tensor([0, 1]), torch.tensor([0, 2])),
                    torch.stack([1.0 + p[3], p[4]]))
    loss = torch.sum((w(torch.from_numpy(vol), m) - torch.from_numpy(target)) ** 2)
    loss.backward()
    return float(loss.detach()), p.grad.numpy()


def test_loss_gradient_matches_the_reference_xla_route():
    f_x, g_x = reference_loss_and_grad(use_pallas=False)
    f_t, g_t = port_loss_and_grad()
    assert abs(f_t - f_x) / abs(f_x) < 1e-5
    np.testing.assert_allclose(g_t, g_x, rtol=1e-4)


def test_loss_gradient_matches_the_reference_pallas_route(pallas_route):
    f_p, g_p = reference_loss_and_grad(use_pallas=True)
    f_t, g_t = port_loss_and_grad()
    assert abs(f_t - f_p) / abs(f_p) < 1e-5
    np.testing.assert_allclose(g_t, g_p, rtol=1e-3, atol=1e-5)


def test_a_step_runs_seven_derivs_and_six_adjoints(monkeypatch):
    """The first pass's input is the embedded volume, which needs no
    gradient: a backward takes I for each of the 7 passes and J for 6."""
    calls = {"deriv": 0, "adjoint": 0}
    deriv, adjoint = multipass_cuda.resample_pass_deriv, multipass_cuda.resample_pass_adjoint

    def count(name, fn):
        def run(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return run

    monkeypatch.setattr(multipass_cuda, "resample_pass_deriv", count("deriv", deriv))
    monkeypatch.setattr(multipass_cuda, "resample_pass_adjoint", count("adjoint", adjoint))
    vol = torch.from_numpy(smooth((8, 12, 10), 5))
    m = torch.tensor(similarity([2, 1, -1], [0.3, 0.2, -0.4]), requires_grad=True)
    warp = tmp.make_traced_multipass_warp(vol.shape, vol.shape, order=1, device="cpu")
    warp(vol, m).square().sum().backward()
    assert calls == {"deriv": 7, "adjoint": 6}
    assert torch.isfinite(m.grad).all() and bool((m.grad != 0).any())
