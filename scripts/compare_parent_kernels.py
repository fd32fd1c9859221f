#!/usr/bin/env python3
"""Time the port's kernels E, J and G against another commit's, in turns,
on one NVIDIA card.

    git show <commit>:biahub_tpu_torch/csrc/warp.cu > build/parent_csrc/warp.cu
    (the same for multipass.cu and peaks.cu)
    python3 scripts/compare_parent_kernels.py build/parent_csrc

Builds the given directory's ``warp.cu``, ``multipass.cu`` and ``peaks.cu``
with the port's nvcc flags into libraries beside them, loads them with
ctypes (the C entries must keep this checkout's signatures: ``warp_zy``,
``resample_pass_adjoint``; ``block_max_argmin`` without the sub-tile
arguments, as before blur sizes other than 0 and 3), and at the shapes of
``chip_smoke.py`` times each kernel against this checkout's in the order
other, this, this, other (CUDA-event medians): E on the chain's batch
(zyx and xzy reads) and on stabilize's table batch of 12, J at each slot
and order of the registration frame (its output bit-equal to the other's),
G at blur 3 and 0 (values and indices equal). Prints the card's name and
power limit first. Imports no JAX.
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
from biahub_tpu_torch.kernels.multipass_cuda import resample_pass_adjoint  # noqa: E402
from biahub_tpu_torch.kernels.peaks import block_grid  # noqa: E402
from biahub_tpu_torch.kernels.peaks_cuda import block_max_argmin  # noqa: E402
from biahub_tpu_torch.kernels.warp_cuda import warp_zy  # noqa: E402

P, I = ctypes.c_void_p, ctypes.c_int


def build_other(src_dir: str) -> dict:
    procs = {}
    for name in ("warp", "multipass", "peaks"):
        out = os.path.join(src_dir, f"{name}.so")
        procs[name] = (out, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", out, os.path.join(src_dir, f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc {name}.cu failed:\n{log}")
        libs[name] = ctypes.CDLL(out)
    libs["warp"].warp_zy.argtypes = [P, P, P] + [I] * 8 + [P]
    libs["multipass"].resample_pass_adjoint.argtypes = [P, P, P] + [I] * 9 + [P]
    libs["peaks"].block_max_argmin.argtypes = [P, P, P] + [I] * 10 + [P]
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
    _build.build(("warp", "multipass", "peaks"))
    libs = build_other(sys.argv[1])
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(12)
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

    truth = torch.tensor(cs.similarity_about_centre(cs.LAPSE_SHAPE), dtype=torch.float32,
                         device=dev)
    off, frame_shape, _ = mw.traced_frame(cs.LAPSE_SHAPE, cs.LAPSE_SHAPE, cs.REG_MARGIN)
    rows = mw.traced_pass_rows(truth, off)
    jt = torch.stack([row for _, _, row in rows]).contiguous()
    ybar = torch.randn((1,) + tuple(frame_shape), generator=gen, device=dev)
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
    del ybar, oa, ob
    torch.cuda.empty_cache()

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
    return 0


if __name__ == "__main__":
    sys.exit(main())
