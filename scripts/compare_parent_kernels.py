#!/usr/bin/env python3
"""Time the port's kernels E, H, I, J and G against another commit's, in
turns, on one NVIDIA card.

    git show <commit>:biahub_tpu_torch/csrc/multipass.cu > build/parent_csrc/multipass.cu
    (and, to compare E or G, warp.cu or peaks.cu the same way)
    python3 scripts/compare_parent_kernels.py build/parent_csrc

Builds those of ``warp.cu``, ``multipass.cu`` and ``peaks.cu`` that the
given directory holds, with the port's nvcc flags (headers from the
directory first, then from this checkout's ``csrc``), into libraries beside
them, loads them with ctypes (the C entries must keep this checkout's
signatures: ``warp_zy``, ``resample_pass``, ``resample_pass_adjoint``;
``resample_pass_deriv`` with one partial triple per frame row, as before H
and I took tiles; ``block_max_argmin`` without the sub-tile arguments, as
before blur sizes other than 0 and 3), and at the shapes of
``chip_smoke.py`` times each kernel against this checkout's in the order
other, this, this, other (CUDA-event medians): E on the chain's batch
(zyx and xzy reads) and on stabilize's table batch of 12; H at each slot
and order of phase 8's frame (one coefficient set, and a (2, 21) table
over two volumes) and of the registration's traced frame (its output
bit-equal to the other's), I at each slot and order of the traced frame
(within DERIV_TOL of the other's), J at each slot and order of the traced
frame (bit-equal to the other's); G at blur 3 and 0 (values and indices
equal). Prints the card's name and power limit first, and fails if an
output differs. Imports no JAX.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from biahub_tpu_torch.kernels import _build  # noqa: E402
from biahub_tpu_torch.kernels import multipass_warp as mw  # noqa: E402
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
        "peaks": {"block_max_argmin": [P, P, P] + [I] * 10 + [P]},
    }
    for name, lib in libs.items():
        for fn, types in argtypes[name].items():
            getattr(lib, fn).argtypes = types
    return libs


def stream(t: torch.Tensor) -> P:
    return P(torch.cuda.current_stream(t.device).cuda_stream)


def turns(other, this) -> str:
    t = [cs.time_ms(other), cs.time_ms(this), cs.time_ms(this), cs.time_ms(other)]
    return f"other {t[0]:.4f} {t[3]:.4f}, this {t[1]:.4f} {t[2]:.4f} ms"


def main() -> int:
    if not torch.cuda.is_available() or len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    names = [n for n in ("warp", "multipass", "peaks")
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


def compare_g(libs, dev, gen) -> None:
    vol = torch.randint(0, 4096, cs.LAPSE_SHAPE, generator=gen, device=dev).float()
    for blur in (3, 0):
        for block in cs.PEAK_BLOCKS:
            grid = block_grid(cs.LAPSE_SHAPE, block)
            n = int(np.prod(grid))
            vals = torch.empty(n, device=dev)
            idx = torch.empty(n, dtype=torch.int32, device=dev)

            def other_g():
                rc = libs["peaks"].block_max_argmin(P(vol.data_ptr()), P(vals.data_ptr()),
                                                    P(idx.data_ptr()), *cs.LAPSE_SHAPE, *block,
                                                    *grid, blur, stream(vol))
                if rc:
                    raise SystemExit(f"other block_max_argmin: error {rc}")

            other_g()
            gv, gi = block_max_argmin(vol, block, blur)
            same = torch.equal(vals, gv) and torch.equal(idx, gi)
            print(f"G blur {blur} {block}: "
                  + turns(other_g, lambda: block_max_argmin(vol, block, blur))
                  + f"; equal {same}")


if __name__ == "__main__":
    sys.exit(main())
