"""Kernels G (the bead-peak candidates), Bx (the PCC cross-power's
Z-lines) and D's batch chunks: their plans and arithmetic on the CPU.

- G's walk (``kernels/peaks_cuda.py`` ``walk_axis``, ``g_plan``): the
  tiles partition the cells that output blocks cover, at the beads
  geometry, at estimate-psf's (64, 64, 32) blocks and at a shape with tail
  voxels; each thread's cells of a tile are its own; every plan for the
  blur sizes the paths and the tests use fits a block; the 64-bit key that
  merges partial candidates (``candidate_key``, ``csrc/peaks.cu``
  block_key) orders like the reduction's rule on ties, +-0.0 and +-inf;
  ``block_max_candidates`` at blur 41 against the reference.
- Bx's plan (``kernels/fft.py`` ``cross_plan``) and a
  float64 model of one line pair through its passes with the fused
  cross-power, against ``np.fft`` at Z = 64, 77 and 67 (Bluestein).
- D's chunks (``kernels/deskew_cuda.py`` ``batch_chunks``).

The kernels run only on the card (``chip_smoke.py`` phase 21).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biahub_tpu.kernels import peaks as jpeaks
from biahub_tpu_torch.kernels import deskew_cuda as dc
from biahub_tpu_torch.kernels import fft as tfft
from biahub_tpu_torch.kernels import peaks_cuda as pc
from biahub_tpu_torch.kernels.peaks import block_grid

BEADS = ((86, 1024, 484), (8, 8, 8))
BLURS = (0, 1, 3, 5, 15, 39, 63)


@pytest.mark.parametrize("shape,block", [BEADS, ((40, 150, 100), (64, 64, 32)),
                                         ((21, 30, 13), (8, 4, 8))])
def test_g_walk_covers_every_output_block_once(shape, block):
    """Along each axis the tiles' cells are disjoint, in order, cover
    exactly the cells some output block covers (tail voxels left out), and
    reach every output block; each thread of a tile owns distinct cells,
    all of them together; the lanes merged by shuffles share a block."""
    for blur in BLURS:
        plan = pc.g_plan(blur, block)
        for n, b, t, o in zip(shape, block, (plan.tz, plan.ty, plan.tx),
                              block_grid(shape, block)):
            stop = min(n, o * b - b // 2)
            cells = [c for lo, hi in pc.walk_axis(n, b, t) for c in range(lo, hi)]
            assert cells == list(range(stop))
            assert len(pc.walk_axis(n, b, t)) == -(-o * b // t)
            assert {(c + b // 2) // b for c in cells} == set(range(o))
        groups = 256 // plan.tx
        owned = sorted((grp + groups * j, tid % plan.tx) for tid in range(256)
                       for grp in [tid // plan.tx] for j in range(plan.ty // groups))
        assert owned == [(r, c) for r in range(plan.ty) for c in range(plan.tx)]
        for warp in range(plan.tx // 32):  # the lanes of a segment share kx
            kx = [(3 * plan.tx + 32 * warp + lane) // block[2] for lane in range(32)]
            assert all(kx[lane] == kx[lane - lane % plan.seg] for lane in range(32))


def test_g_beads_geometry_has_tail_voxels():
    (z, _, _), (b, _, _) = BEADS
    o = block_grid(*BEADS)[0]
    assert o * b - b // 2 == 84 < z  # voxels 84 and 85 belong to no block


@pytest.mark.parametrize("blur", BLURS)
def test_g_plans_fit_a_block(blur):
    """The plan's shared memory covers the C entry's layout and lets two
    blocks share an SM; its tile and windows are ones the C entry takes."""
    for block in ((8, 8, 8), (64, 64, 32)):
        plan = pc.g_plan(blur, block)
        groups = 256 // plan.tx
        assert plan.tx in (32, 64, 128) and plan.ty % groups == 0 and plan.ty // groups <= 8
        assert plan.smem == 4 * pc.walk_floats(plan.tx, plan.ty, plan.hz, plan.hy, plan.hx)
        assert plan.smem <= 113 * 1024 and plan.per_sm >= 2
        windows = {plan.hz, plan.hy, plan.hx}
        assert windows == {1} if blur <= 1 else windows <= {1, blur}
    assert pc.g_plan(3).passes == 0 and pc.g_plan(63).passes >= 1


def better(a, b):
    """csrc/peaks.cu's reduction rule: the larger value, the smaller index
    among equals (+0.0 == -0.0)."""
    return b if (b[0] > a[0] or (b[0] == a[0] and b[1] < a[1])) else a


def test_g_key_orders_like_the_rule():
    rng = np.random.default_rng(14)
    values = [0.0, -0.0, float("inf"), -float("inf"), 1.0, -1.0, 1.5, -2.5e-38, 3.4e38,
              -3.4e38, 1e-45, -1e-45] + rng.standard_normal(20).astype(np.float32).tolist()
    cands = [(np.float32(v), int(i)) for v in values for i in (0, 1, 7, 2**31 - 1)]
    for a in cands:
        for b in cands:
            if a[1] == b[1] and (a[0] == b[0]):
                continue  # one cell: its value decides nothing
            ka, kb = pc.candidate_key(float(a[0]), a[1]), pc.candidate_key(float(b[0]), b[1])
            assert (ka > kb) == (better(a, b) is a and better(b, a) is a), (a, b)
    assert pc.candidate_key(-float("inf"), 2**31 - 1) > 0
    assert pc.candidate_key(-0.0, 5) & 1 == 1 and pc.candidate_key(0.0, 5) & 1 == 0
    assert pc.candidate_key(-0.0, 5) >> 1 == pc.candidate_key(0.0, 5) >> 1


def test_g_blur_past_the_old_limit_matches_the_reference():
    rng = np.random.default_rng(41)
    vol = rng.integers(0, 50, (10, 52, 47)).astype(np.float32)
    for block in ((8, 8, 8), (64, 64, 32)):
        got_v, got_i = pc.block_max_argmin(torch.from_numpy(vol), block, 41)
        want_v, want_i = jpeaks.block_max_candidates(jnp.asarray(vol), block, 41)
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


def test_cross_plan_radices_and_limits():
    assert tfft.cross_plan(64).radices == (8, 8) and tfft.cross_plan(77).radices == (7, 11)
    assert tfft.cross_plan(67).m == tfft.z_line_length(67) == 176
    assert tfft.max_cross_z(2048) >= 2048 and tfft.max_cross_z(1024 - 1) >= 1024
    pow2 = [1 << i for i in range(1, 12)]
    for z in sorted(set(pow2) | set(range(2, 1025, 7)) | {1021, 1023, 1019, 1000, 77, 86}):
        plan = tfft.cross_plan(z)
        assert plan.smem <= 227 * 1024 and plan.per_sm >= 1 and 32 <= plan.threads <= 128
        assert plan.smem == tfft._cross_plan_smem(z, plan.m, 1 << plan.log2tk, plan.stages,
                                                  plan.tab_smem)
        assert plan.radices == tuple(sorted(tfft.radix_plan(plan.m)))
        assert plan.m == tfft.z_line_length(z)


def passes64(x, radices, tw, inverse):
    """fft_radix.cuh's Stockham passes in complex128 over lines x (..., m)
    with the table's twiddles (pass p's factor at ns - 1 + (q - 1) ns + k)."""
    m = x.shape[-1]
    src, ns = x.astype(np.complex128), 1
    for r in radices:
        nr = m // r
        j = np.arange(nr)
        k = j % ns
        v = np.stack([src[..., j + q * nr] for q in range(r)], -1)
        if ns > 1:
            w = np.stack([np.ones(nr)] + [tw[ns - 1 + (q - 1) * ns + k] for q in range(1, r)], -1)
            v = v * (np.conj(w) if inverse else w)
        dft = np.exp((1 if inverse else -1) * 2j * np.pi * np.outer(np.arange(r), np.arange(r))
                     / r)
        v = v @ dft
        dst = np.empty_like(src)
        for q in range(r):
            dst[..., (j - k) * r + k + q * ns] = v[..., q]
        src, ns = dst, ns * r
    return src


def cross64(a, b, norm):
    """csrc/fft.cu CrossLines' cross-power of two spectra, in float64."""
    cr = a.real * b.real + a.imag * b.imag
    ci = a.imag * b.real - a.real * b.imag
    if norm is not None:
        d = np.sqrt(cr * cr + ci * ci) if norm == "magnitude" else np.sqrt(
            (a.real ** 2 + a.imag ** 2) * (b.real ** 2 + b.imag ** 2))
        d = np.maximum(d, np.finfo(np.float32).eps)
        cr, ci = cr / d, ci / d
    return cr + 1j * ci


def z_cross_model(ref, mov, plan, norm):
    """One z_cross_kernel line pair per row of ref, mov (lines, n)."""
    n, m, radices = plan.n, plan.m, plan.radices
    table = tfft.cross_table(plan)
    tw = table[:m - 1]
    if m == n:
        c = cross64(passes64(ref, radices, tw, False), passes64(mov, radices, tw, False), norm)
        return passes64(c, radices, tw, True) / n
    w, kern = table[m - 1:m - 1 + n], table[m - 1 + n:]

    def conv(x, k):  # iFFT(FFT(x padded to m) k)[:n]
        pad = np.zeros((x.shape[0], m), np.complex128)
        pad[:, :n] = x
        return passes64(passes64(pad, radices, tw, False) * k, radices, tw, True)[:, :n]

    c = cross64(conv(ref * w, kern), conv(mov * w, kern), norm) * np.conj(w)
    return conv(c, np.conj(kern)) * np.conj(w) / n


@pytest.mark.parametrize("norm", [None, "magnitude", "classic"])
@pytest.mark.parametrize("z", [64, 77, 67])
def test_z_cross_model_matches_np_fft(z, norm):
    rng = np.random.default_rng(z)
    ref, mov = ((rng.standard_normal((6, z)) + 1j * rng.standard_normal((6, z)))
                .astype(np.complex64) for _ in range(2))
    plan = tfft.cross_plan(z)
    assert (plan.m == z) == (z != 67)
    got = z_cross_model(ref, mov, plan, norm)
    h1, h2 = (torch.from_numpy(np.fft.fft(x.astype(np.complex128), axis=1)) for x in (ref, mov))
    want = np.fft.ifft(tfft.cross_power(h1, h2, norm).numpy(), axis=1)
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("groups,batch", [(86, 800), (86, 762), (3, 65535), (1, 200000)])
def test_deskew_chunks_cover_the_batch_in_order(groups, batch):
    chunks = dc.batch_chunks(batch, groups)
    assert chunks[0][0] == 0 and chunks[-1][1] == batch
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
    assert all(0 < (hi - lo) * groups <= 65535 for lo, hi in chunks)
    assert len(chunks) == -(-batch // (65535 // groups))
