#!/usr/bin/env python3
"""Time the port's kernels E, H, I, J, G, A, B, Bc, C, Bx, L and M against
another commit's, in turns, on one NVIDIA card.

    git show <commit>:biahub_tpu_torch/csrc/multipass.cu > build/parent_csrc/multipass.cu
    (and, to compare E or G, warp.cu or peaks.cu the same way; to compare
    the FFT kernels, fft.cu with fft_radix.cuh, fft_lines.cuh and
    cp_async.cuh; to compare M, spectral.cu with the same headers)
    python3 scripts/compare_parent_kernels.py build/parent_csrc

Builds those of ``warp.cu``, ``multipass.cu``, ``peaks.cu``, ``fft.cu`` and
``spectral.cu`` that the given directory holds, with the port's nvcc flags
(headers from the directory first, then from this checkout's ``csrc``),
into libraries beside them, loads them with ctypes (the C entries must
keep this checkout's signatures: ``warp_zy``, ``resample_pass``,
``resample_pass_adjoint``, ``fwd_yx``, ``z_filter``, ``z_filter_complex``,
``inv_yx``, ``z_cross``; ``resample_pass_deriv`` with one partial triple
per frame row, as before H and I took tiles; ``block_max_argmin`` with a
sub-tile and no scratch, as before G was redesigned; ``y_inv`` with no
plan and ``lerp_irfft`` as one launch from the spectrum, as before L and M
were), and at the shapes of ``chip_smoke.py`` times each kernel against
this checkout's in the order other, this, this, other (CUDA-event
medians): E on the chain's batch (zyx and xzy reads) and on stabilize's
table batch of 12; H at each slot and order of phase 8's frame (one
coefficient set, and a (2, 21) table over two volumes) and of the
registration's traced frame (its output bit-equal to the other's), I at
each slot and order of the traced frame (within DERIV_TOL of the
other's), J at each slot and order of the traced frame (bit-equal to the
other's); G at both geometries and blur 0, 3, 5 and 15 on integer-valued
and on randn data (values and indices bit-equal); A, B, Bc and C at the
headline and Bx at the PCC crop's and custom_padding's shapes (bit-equal),
L at the headline (within FFT_TOL), and M (both launches, both stores) at
the headline (within SPECTRAL_TOL). Prints the card's name and power limit
first, and fails if an output differs. Imports no JAX.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from biahub_tpu_torch.kernels import _build  # noqa: E402
from biahub_tpu_torch.kernels import fft as kfft  # noqa: E402
from biahub_tpu_torch.kernels import multipass_warp as mw  # noqa: E402
from biahub_tpu_torch.kernels import spectral as kspec  # noqa: E402
from biahub_tpu_torch.kernels import spectral_cuda as kspc  # noqa: E402
from biahub_tpu_torch.kernels.affine import (  # noqa: E402
    coefficient_table,
    inplane_coefficients,
    translation_matrix,
)
from biahub_tpu_torch.kernels.chain import flip_y_matrix  # noqa: E402
from biahub_tpu_torch.kernels.multipass_cuda import (  # noqa: E402
    resample_pass,
    resample_pass_adjoint,
    resample_pass_deriv,
)
from biahub_tpu_torch.kernels.peaks import block_grid  # noqa: E402
from biahub_tpu_torch.kernels.peaks_cuda import block_max_argmin  # noqa: E402
from biahub_tpu_torch.kernels.warp_cuda import warp_zy  # noqa: E402

P, I = ctypes.c_void_p, ctypes.c_int


def build_other(src_dir: str, names) -> dict:
    procs = {}
    for name in names:
        out = os.path.join(src_dir, f"{name}.so")
        procs[name] = (out, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build._CSRC), "-o", out,
             os.path.join(src_dir, f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc {name}.cu failed:\n{log}")
        libs[name] = ctypes.CDLL(out)
    argtypes = {
        "warp": {"warp_zy": [P, P, P] + [I] * 8 + [P]},
        "multipass": {"resample_pass": [P, P, P] + [I] * 9 + [ctypes.c_float, P],
                      "resample_pass_deriv": [P, P, P] + [I] * 9 + [P, P],
                      "resample_pass_adjoint": [P, P, P] + [I] * 9 + [P]},
        "peaks": {"block_max_argmin": [P, P, P] + [I] * 14 + [P]},
        "fft": dict({k: kfft._SIGNATURES[k] for k in ("fwd_yx", "z_filter", "z_filter_complex",
                                                        "inv_yx", "z_cross")},
                    y_inv=[P, I, I, I, P]),
        "spectral": {"lerp_irfft": [P, P, P] + [I] * 7 + [P]},
    }
    for name, lib in libs.items():
        lib.error_string.argtypes = [I]
        lib.error_string.restype = ctypes.c_char_p
        for fn, types in argtypes[name].items():
            getattr(lib, fn).argtypes = types
            getattr(lib, fn).restype = I
    return libs


def stream(t: torch.Tensor) -> P:
    return P(torch.cuda.current_stream(t.device).cuda_stream)


def turns(other, this, setup=None) -> str:
    t = [cs.time_ms(other, setup), cs.time_ms(this, setup), cs.time_ms(this, setup),
         cs.time_ms(other, setup)]
    return f"other {t[0]:.4f} {t[3]:.4f}, this {t[1]:.4f} {t[2]:.4f} ms"


def main() -> int:
    if not torch.cuda.is_available() or len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    names = [n for n in ("warp", "multipass", "peaks", "fft", "spectral")
             if os.path.exists(os.path.join(sys.argv[1], f"{n}.cu"))]
    _build.build(names)
    libs = build_other(sys.argv[1], names)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(12)
    if "warp" in libs:
        compare_e(libs, dev, gen)
    if "multipass" in libs:
        compare_h(libs, dev)
        compare_ij(libs, dev, gen)
    if "peaks" in libs:
        compare_g(libs, dev, gen)
    if "fft" in libs:
        compare_fft(libs, dev, gen)
    if "spectral" in libs:
        compare_m(libs, dev, gen)
    return 0


def compare_e(libs, dev, gen) -> None:
    z, y, x = cs.LAPSE_SHAPE

    def other_e(vols, coeffs, xzy):
        b = vols.shape[0]
        out = torch.empty((b, z, y, x), device=dev)
        rc = libs["warp"].warp_zy(P(vols.data_ptr()), P(out.data_ptr()), P(coeffs.data_ptr()),
                                  0 if coeffs.ndim == 1 else 21, b, z, y, x, z, y, int(xzy),
                                  stream(vols))
        if rc:
            raise SystemExit(f"other warp_zy: error {rc}")
        return out

    chain_c = inplane_coefficients(flip_y_matrix(y) @ cs.reg_stab_matrix()).to(dev)
    rng = np.random.default_rng(12)
    drift = np.stack([rng.integers(-m, m + 1, cs.T_LAPSE) for m in cs.MAX_DRIFT], axis=1)
    table = coefficient_table(np.stack([translation_matrix(d) for d in drift])).to(dev)
    for key, batch, c in (("zyx", cs.BATCH, chain_c), ("xzy", cs.BATCH, chain_c),
                          ("table", cs.T_LAPSE, table)):
        vols = torch.rand((batch,) + cs.LAPSE_SHAPE, generator=gen, device=dev)
        xzy = key == "xzy"
        src = vols.permute(0, 3, 1, 2).contiguous() if xzy else vols
        a, b = other_e(src, c, xzy), warp_zy(src, c, (z, y), input_xzy=xzy)
        err = float((a - b).abs().max() / a.abs().max())
        print(f"E {key}, batch {batch}: " + turns(lambda: other_e(src, c, xzy),
                                                  lambda: warp_zy(src, c, (z, y), input_xzy=xzy))
              + f"; rel diff {err:.3g}")
        del vols, src, a, b
    torch.cuda.empty_cache()


def other_h(libs, frame, table, k, r, o, order, out) -> None:
    cstride = 0 if table.ndim == 2 else table.shape[1] * 3
    rc = libs["multipass"].resample_pass(P(frame.data_ptr()), P(out.data_ptr()),
                                         P(table.data_ptr()), cstride, k, *frame.shape, r, o,
                                         order, 0.0, stream(frame))
    if rc:
        raise SystemExit(f"other resample_pass: error {rc}")


def compare_h(libs, dev) -> None:
    """H at phase 8's frame (one coefficient set; a (2, 21) table over that
    frame and a rolled copy, the second row set the identity's) and phase
    11's traced frame (the registration truth), each slot, orders 1 and 3:
    bit-equal to the other H, timed in turns."""
    _, _, _, frame, table = cs.rigid_frame(dev)
    frame2 = torch.cat([frame, torch.roll(frame, (1, -2, 3), (1, 2, 3))]).contiguous()
    ident = torch.tensor([[1.0, 0.0, 0.0]] * len(mw.CANONICAL_SLOTS), device=dev)
    table2 = torch.stack([table, ident]).contiguous()
    shape11, rows11, table11 = cs.traced_rows(dev)
    gen = torch.Generator(device=dev).manual_seed(13)
    frame11 = torch.nn.functional.avg_pool3d(
        torch.rand(shape11, generator=gen, device=dev)[None, None], 3, 1, 1)[0]
    for name, src, tab in (("phase 8 frame", frame, table), ("phase 8 frame, (2, 21) table",
                                                            frame2, table2),
                           ("traced frame", frame11, table11)):
        oa, ob = torch.empty_like(src), torch.empty_like(src)
        ms_other, ms_this = [], []
        for order in (1, 3):
            for k, (r, o) in enumerate(mw.CANONICAL_SLOTS):
                other_h(libs, src, tab, k, r, o, order, oa)
                resample_pass(src, tab, k, r, o, order, out=ob)
                same = torch.equal(oa.view(torch.int32), ob.view(torch.int32))
                t = [cs.time_ms(lambda: other_h(libs, src, tab, k, r, o, order, oa)),
                     cs.time_ms(lambda: resample_pass(src, tab, k, r, o, order, out=ob)),
                     cs.time_ms(lambda: resample_pass(src, tab, k, r, o, order, out=ob)),
                     cs.time_ms(lambda: other_h(libs, src, tab, k, r, o, order, oa))]
                ms_other.append((t[0] + t[3]) / 2)
                ms_this.append((t[1] + t[2]) / 2)
                print(f"H {name} {tuple(src.shape)} slot {k} (r {r}, o {o}) order {order}: "
                      f"other {t[0]:.4f} {t[3]:.4f}, this {t[1]:.4f} {t[2]:.4f} ms; "
                      f"bit-equal {same}")
                cs.require(same, f"H {name} slot {k} order {order} differs from the other H")
        n = len(mw.CANONICAL_SLOTS)
        print(f"H {name}: mean of the slots, order 1 other {np.mean(ms_other[:n]):.4f} this "
              f"{np.mean(ms_this[:n]):.4f} ms; order 3 other {np.mean(ms_other[n:]):.4f} this "
              f"{np.mean(ms_this[n:]):.4f} ms")
        del oa, ob
    del frame, frame2, frame11
    torch.cuda.empty_cache()


def compare_ij(libs, dev, gen) -> None:
    """I and J at each slot and order of the registration's traced frame: I
    within DERIV_TOL of the other I (the sums' order differs), J bit-equal
    to the other J, timed in turns."""
    frame_shape, rows, jt = cs.traced_rows(dev)
    frame = torch.nn.functional.avg_pool3d(
        torch.rand(frame_shape, generator=gen, device=dev)[None, None], 3, 1, 1)[0]
    ybar = torch.randn((1,) + tuple(frame_shape), generator=gen, device=dev)
    parts = torch.empty((frame_shape[0] * frame_shape[1], 3), dtype=torch.float64, device=dev)

    def other_i(k, r, o, order):
        rc = libs["multipass"].resample_pass_deriv(
            P(frame.data_ptr()), P(ybar.data_ptr()), P(jt.data_ptr()), 0, k, *frame.shape, r, o,
            order, P(parts.data_ptr()), stream(frame))
        if rc:
            raise SystemExit(f"other resample_pass_deriv: error {rc}")
        return parts.sum(0)

    ms_other, ms_this = [], []
    for order in (1, 3):
        for k, (r, o, _) in enumerate(rows):
            a = other_i(k, r, o, order)
            b = resample_pass_deriv(frame, ybar, jt, k, r, o, order)[0]
            again = resample_pass_deriv(frame, ybar, jt, k, r, o, order)[0]
            err = float((a - b).abs().max() / a.abs().max())
            t = [cs.time_ms(lambda: other_i(k, r, o, order)),
                 cs.time_ms(lambda: resample_pass_deriv(frame, ybar, jt, k, r, o, order)),
                 cs.time_ms(lambda: resample_pass_deriv(frame, ybar, jt, k, r, o, order)),
                 cs.time_ms(lambda: other_i(k, r, o, order))]
            ms_other.append((t[0] + t[3]) / 2)
            ms_this.append((t[1] + t[2]) / 2)
            print(f"I slot {k} (r {r}, o {o}) order {order}: other {t[0]:.4f} {t[3]:.4f}, this "
                  f"{t[1]:.4f} {t[2]:.4f} ms; rel diff {err:.3g} (tol {cs.DERIV_TOL}); two runs "
                  f"bit-equal {torch.equal(b, again)}")
            cs.require(err <= cs.DERIV_TOL, f"I slot {k} order {order}: rel diff {err:.3g}")
            cs.require(torch.equal(b, again), f"I slot {k} order {order}: runs differ")
    n = len(rows)
    print(f"I traced frame: mean of the slots, order 1 other {np.mean(ms_other[:n]):.4f} this "
          f"{np.mean(ms_this[:n]):.4f} ms; order 3 other {np.mean(ms_other[n:]):.4f} this "
          f"{np.mean(ms_this[n:]):.4f} ms")
    del frame, parts
    oa, ob = torch.empty_like(ybar), torch.empty_like(ybar)

    def other_j(k, r, o, order):
        rc = libs["multipass"].resample_pass_adjoint(
            P(ybar.data_ptr()), P(oa.data_ptr()), P(jt.data_ptr()), 0, k, *ybar.shape, r, o,
            order, stream(ybar))
        if rc:
            raise SystemExit(f"other resample_pass_adjoint: error {rc}")

    for order in (1, 3):
        for k, (r, o, _) in enumerate(rows):
            other_j(k, r, o, order)
            resample_pass_adjoint(ybar, jt, k, r, o, order, out=ob)
            same = torch.equal(oa.view(torch.int32), ob.view(torch.int32))
            print(f"J slot {k} (r {r}, o {o}) order {order}: "
                  + turns(lambda: other_j(k, r, o, order),
                          lambda: resample_pass_adjoint(ybar, jt, k, r, o, order, out=ob))
                  + f"; bit-equal {same}")
            cs.require(same, f"J slot {k} order {order} differs from the other J")
    del ybar, oa, ob
    torch.cuda.empty_cache()


# The previous G's sub-tile plan (its kernels/peaks_cuda.py blur_plan): the
# largest of these (tz, ty, tx) whose halo and z sums (none at blur 3) fit
# 113 KB, else 227 KB less 256 bytes; blur 0 stages nothing.
OTHER_G_TILES = ((8, 8, 32), (8, 8, 16), (4, 8, 16), (4, 4, 16), (4, 4, 8), (2, 4, 8),
                 (2, 2, 8), (1, 2, 8), (1, 1, 8), (1, 1, 4), (1, 1, 2), (1, 1, 1))


def other_g_plan(k: int):
    if k == 0:
        return OTHER_G_TILES[0], 0
    for budget in (113 * 1024, 227 * 1024 - 256):
        for tz, ty, tx in OTHER_G_TILES:
            h = k - 1
            smem = 4 * ((tz + h) * (ty + h) * (tx + h) + (tz * (ty + h) * (tx + h) if k != 3 else 0))
            if smem <= budget:
                return (tz, ty, tx), smem
    raise SystemExit(f"the other G takes no blur {k}")


def compare_g(libs, dev, gen) -> None:
    """G at both geometries and blur 0, 3, 5 and 15 on integer-valued and on
    randn data: values and indices bit-equal to the other G's, timed in
    turns."""
    vols = {"integer": torch.randint(0, 4096, cs.LAPSE_SHAPE, generator=gen, device=dev).float(),
            "randn": torch.randn(cs.LAPSE_SHAPE, generator=gen, device=dev)}
    for data, vol in vols.items():
        for blur in (3, 0, 5, 15):
            tile, smem = other_g_plan(blur)
            for block in cs.PEAK_BLOCKS:
                grid = block_grid(cs.LAPSE_SHAPE, block)
                n = int(np.prod(grid))
                vals = torch.empty(n, device=dev)
                idx = torch.empty(n, dtype=torch.int32, device=dev)

                def other_g():
                    rc = libs["peaks"].block_max_argmin(
                        P(vol.data_ptr()), P(vals.data_ptr()), P(idx.data_ptr()),
                        *cs.LAPSE_SHAPE, *block, *grid, blur, *tile, smem, stream(vol))
                    if rc:
                        raise SystemExit(f"other block_max_argmin: error {rc}")

                other_g()
                gv, gi = block_max_argmin(vol, block, blur)
                same = torch.equal(vals.view(torch.int32), gv.view(torch.int32)) and torch.equal(
                    idx, gi)
                print(f"G {data} blur {blur} {block}: "
                      + turns(other_g, lambda: block_max_argmin(vol, block, blur))
                      + f"; bit-equal {same}")
                cs.require(same, f"G {data} blur {blur} {block} differs from the other G")
    del vols
    torch.cuda.empty_cache()


@contextlib.contextmanager
def other_fft(libs):
    """The FFT wrappers launch the other library's kernels, with this
    checkout's plans, inside the block."""
    saved = kfft._lib
    kfft._lib = lambda: libs["fft"]
    try:
        yield
    finally:
        kfft._lib = saved


def bits(t: torch.Tensor) -> torch.Tensor:
    return torch.view_as_real(t).view(torch.int32) if t.is_complex() else t.view(torch.int32)


def compare_fft(libs, dev, gen) -> None:
    """A, B, Bc and C at the headline and Bx at the PCC crop's and
    custom_padding's shapes (magnitude), bit-equal to the other's; L at the
    headline within FFT_TOL of the other's; each timed in turns."""
    vol = torch.rand(cs.SHAPE, generator=gen, device=dev)
    spec_shape = kfft.half_spectrum_shape(cs.SHAPE)
    filt = torch.rand(spec_shape, generator=gen, device=dev)
    cfilt = torch.randn(spec_shape, dtype=torch.complex64, generator=gen, device=dev)
    spec = kfft.fwd_yx(vol)
    work = torch.empty_like(spec)
    real = torch.empty(cs.SHAPE, device=dev)
    cases = (("A fwd_yx", lambda: kfft.fwd_yx(vol, out=work), None),
             ("B z_filter", lambda: kfft.z_filter_(work, filt), lambda: work.copy_(spec)),
             ("Bc z_filter_complex", lambda: kfft.z_filter_complex_(work, cfilt),
              lambda: work.copy_(spec)),
             ("C inv_yx", lambda: kfft.inv_yx(work, out=real), lambda: work.copy_(spec)))
    for name, fn, setup in cases:
        same = same_outputs(libs, fn, setup)

        def other():
            with other_fft(libs):
                fn()

        print(f"{name} {cs.SHAPE}: " + turns(other, fn, setup) + f"; bit-equal {same}")
        cs.require(same, f"{name} differs from the other's")

    def other_l():
        rc = libs["fft"].y_inv(P(work.data_ptr()), *spec.shape, stream(work))
        if rc:
            raise SystemExit(f"other y_inv: error {rc}")

    work.copy_(spec)
    other_l()
    want = work.clone()
    work.copy_(spec)
    kfft.y_inv_(work)
    err = float((work - want).abs().max() / want.abs().max())
    print(f"L y_inv {tuple(spec.shape)}: "
          + turns(other_l, lambda: kfft.y_inv_(work), lambda: work.copy_(spec))
          + f"; rel diff {err:.3g} (tol {cs.FFT_TOL})")
    cs.require(err <= cs.FFT_TOL, f"L: rel diff {err:.3g} from the other's")
    del vol, filt, cfilt, spec, work, real, want
    torch.cuda.empty_cache()
    for name, shape in (("PCC crop", cs.BX_SHAPES["PCC crop"]),
                        ("custom_padding", cs.BX_SHAPES["custom_padding"])):
        ref = torch.randn(shape, dtype=torch.complex64, generator=gen, device=dev)
        mov = torch.randn(shape, dtype=torch.complex64, generator=gen, device=dev)
        ob = torch.empty_like(ref)

        def bx():
            return kfft.z_cross_(ref, mov, ob, "magnitude")

        same = same_outputs(libs, bx, None)

        def other_bx():
            with other_fft(libs):
                bx()

        print(f"Bx {name} {shape} (magnitude): " + turns(other_bx, bx)
              + f"; bit-equal {same}")
        cs.require(same, f"Bx {name} differs from the other's")
        del ref, mov, ob
    torch.cuda.empty_cache()


def same_outputs(libs, fn, setup) -> bool:
    """Whether ``fn`` gives the same bits through the other library's FFT
    kernels and through this checkout's."""
    outs = []
    for use_other in (True, False):
        with other_fft(libs) if use_other else contextlib.nullcontext():
            if setup is not None:
                setup()
            outs.append(fn().clone())
    return torch.equal(bits(outs[0]), bits(outs[1]))


def compare_m(libs, dev, gen) -> None:
    """M (contraction and irfft, both stores) at the headline, on a filtered
    spectrum and the headline table, within SPECTRAL_TOL of the other M (a
    one-launch kernel from the spectrum), timed in turns."""
    z, y, x = cs.SHAPE
    vol = torch.rand(cs.SHAPE, generator=gen, device=dev)
    filt = torch.rand(kfft.half_spectrum_shape(cs.SHAPE), generator=gen, device=dev)
    spec = kfft.y_inv_(kfft.z_fwd_filter_(kfft.fwd_yx(vol), filt))
    del vol, filt
    table = kspec.prepare_spectral_deskew(cs.SHAPE, cs.ANGLE, cs.RATIO, False, cs.AVG, dev)
    rows, x_out, _ = table.shape
    groups = rows // cs.AVG
    for layout in kspc.OUT_LAYOUTS:
        shape = (groups, x, x_out) if layout == "zyx" else (x_out, groups, x)
        oa, ob = torch.empty(shape, device=dev), torch.empty(shape, device=dev)

        def other_m():
            rc = libs["spectral"].lerp_irfft(P(spec.data_ptr()), P(table.data_ptr()),
                                             P(oa.data_ptr()), z, y, x, x_out, groups, cs.AVG,
                                             int(layout == "xzy"), stream(spec))
            if rc:
                raise SystemExit(f"other lerp_irfft: error {rc}")

        def this_m():
            kspc.lerp_irfft(spec, table, x, cs.AVG, layout, out=ob)

        other_m()
        this_m()
        err = float((oa - ob).abs().max() / oa.abs().max())
        print(f"M lerp_irfft {layout} {cs.SHAPE} avg {cs.AVG}: " + turns(other_m, this_m)
              + f"; rel diff {err:.3g} (tol {cs.SPECTRAL_TOL})")
        cs.require(err <= cs.SPECTRAL_TOL, f"M {layout}: rel diff {err:.3g} from the other's")
        del oa, ob
    del spec, table
    torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
