#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``biahub_tpu_torch/csrc`` (into
``build/biahub_tpu_torch/``), then, at the headline volume (256x256x1024,
batch 8, Tikhonov reg 1e-3, deskew at 36.17 deg, px_to_scan_ratio 0.371,
average_window 3, keep_overhang False, skip_flip True) and bench.py's
register+stabilize matrix ``reg_stab``:

1. holds each kernel against its plain PyTorch version: A, B, C (the FFT
   deconvolution), D (deskew, both stores), E and F (the in-plane warp,
   F's fill mask voxel for voxel, and once more with fill -1 and another
   output shape);
2. runs the headline step deconvolve -> deskew (``DeconvolveDeskew``);
3. runs the full chain deconvolve -> deskew -> warp
   (``DeconvolveDeskewWarp``), and the same through the xzy handoff;

each path against the plain chain, with uint16 input bit-identical to its
float32 copy, and with the launches of each kernel counted over that path
alone. Times are CUDA-event medians on this card.

Prints the card's ``nvidia-smi`` name and power limit, one JSON line of
per-kernel numbers, and last ``{"ok": true, "device": {...}}``. Exits
non-zero without printing a result when there is no CUDA device, the
package is missing, or any check fails. Imports no JAX.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import sys
import time

import numpy as np
import torch

SHAPE = (256, 256, 1024)
BATCH = 8
REG = 1e-3
ANGLE, RATIO, AVG = 36.17, 0.371, 3
# Peak rates of one H100 SXM at its 700 W limit (NVIDIA data sheet): HBM3
# bandwidth, and float32 outside the tensor cores (the kernels use none).
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
FFT_TOL = 2e-5     # max |kernel - plain| / max |plain| for A, B, C, the step and the chain
DESKEW_TOL = 1e-5  # max |kernel - plain| for D on unit-range data
WARP_TOL = 1e-5    # max |kernel - plain| / max |plain| for E and F (the warp's envelope)
OTHER_OUT = (80, 1000, 500)  # an output shape other than the deskewed (86, 1024, 484)
REPS, WARMUP = 7, 2
# Samples of the whole step: the median, and p75 with ten samples beyond it.
STEP_REPS = 40


def samples_ms(fn, setup=None, reps: int = REPS) -> list[float]:
    """CUDA-event times of ``reps`` runs of ``fn`` after WARMUP; ``setup``
    runs before each, outside the timed span."""
    times = []
    for i in range(WARMUP + reps):
        if setup is not None:
            setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        if i >= WARMUP:
            times.append(start.elapsed_time(end))
    return times


def time_ms(fn, setup=None) -> float:
    return statistics.median(samples_ms(fn, setup))


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """Least time on the card (ms) for the work, and what bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    diff = float((got - want).abs().max())
    return diff, diff / float(want.abs().max())


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def reg_stab_matrix() -> np.ndarray:
    """bench.py's register+stabilize warp (bench.py:757-763): a 2 deg
    in-plane rotation scaled by 1.01, then a shift, in float32 entries."""
    theta = np.deg2rad(2.0)
    m = np.eye(4, dtype=np.float32)
    m[1:3, 1:3] = 1.01 * np.array(
        [[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]], np.float32)
    m[:3, 3] = [0.5, -1.25, 2.0]
    return m.astype(np.float64)


def lerp_grid(c: torch.Tensor, size: int) -> torch.Tensor:
    """Coordinates as grid_sample's align_corners=True normalised grid."""
    return c * (2.0 / (size - 1)) - 1.0


def describe(rec: dict) -> str:
    return ", ".join(f"{k} {rec[k]:.4f}" for k in ("ms", "plain_ms", "library_ms", "bound_ms")
                     if rec[k] is not None)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from biahub_tpu_torch import DeconvolveDeskew, DeconvolveDeskewWarp, gpu_info
    from biahub_tpu_torch.kernels import _build
    from biahub_tpu_torch.kernels import fft as kfft
    from biahub_tpu_torch.kernels.affine import (
        inplane_coefficients,
        warp_x_plain,
        warp_zy_plain,
    )
    from biahub_tpu_torch.kernels.chain import flip_y_matrix, run_chain_warp
    from biahub_tpu_torch.kernels.deconvolve import compute_transfer_function
    from biahub_tpu_torch.kernels.deskew import deskew_geometry, deskew_plain
    from biahub_tpu_torch.kernels.deskew_cuda import deskew
    from biahub_tpu_torch.kernels.warp_cuda import warp_x, warp_zy

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(gpu_info())

    t0 = time.perf_counter()
    _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc, {len(_build.SOURCES)} "
          "sources in parallel)")

    z, y, x = SHAPE
    xh = x // 2 + 1
    nvox = z * y * x
    rng = np.random.default_rng(0)
    r = 4
    psf = np.exp(-np.sum(np.square(np.mgrid[-r:r + 1, -r:r + 1, -r:r + 1] / 1.5),
                         axis=0)).astype(np.float32)
    tf_half = compute_transfer_function(psf, SHAPE)[..., :xh]
    filt = kfft.prepare_fourier_filter(SHAPE, tf_half, REG, dev)
    geo = deskew_geometry(SHAPE, ANGLE, RATIO, False, AVG, skip_flip=True)
    records = {}

    # -- 2. each kernel against its plain version, one headline volume ------
    gen = torch.Generator(device=dev).manual_seed(0)
    vol = torch.rand(SHAPE, generator=gen, device=dev)
    u16_np = rng.integers(0, 65536, size=SHAPE, dtype=np.uint16)
    vol_u16 = torch.from_numpy(u16_np).to(dev)
    vol_u16f = torch.from_numpy(u16_np.astype(np.float32)).to(dev)
    fft_flops = z * y * 2.5 * x * math.log2(x) + z * xh * 5 * y * math.log2(y)
    spec_bytes = z * y * xh * 8

    spec = torch.empty((z, y, xh), dtype=torch.complex64, device=dev)
    kfft.fwd_yx(vol, out=spec)
    want = kfft.fwd_yx_plain(vol)
    err_abs, err = rel_err(spec, want)
    require(err <= FFT_TOL, f"kernel A f32 rel err {err:.3g} > {FFT_TOL}")
    bms, bby = bound(nvox * 4 + spec_bytes, fft_flops)
    records["fwd_yx"] = dict(
        replaces="biahub_tpu/kernels/pallas_fft.py:286", source="biahub_tpu_torch/csrc/fft.cu",
        max_abs_err=err_abs, ms=time_ms(lambda: kfft.fwd_yx(vol, out=spec)),
        plain_ms=time_ms(lambda: kfft.fwd_yx_plain(vol)), bound_ms=bms, bound_by=bby,
        library_ms=time_ms(lambda: torch.fft.rfft2(vol)))
    print(f"A fwd_yx f32: rel err {err:.3g} (tol {FFT_TOL}), " + describe(records["fwd_yx"]))

    spec16 = torch.empty_like(spec)
    kfft.fwd_yx(vol_u16, out=spec16)
    spec16f = kfft.fwd_yx(vol_u16f)
    _, err16 = rel_err(spec16, kfft.fwd_yx_plain(vol_u16f))
    require(err16 <= FFT_TOL, f"kernel A uint16 rel err {err16:.3g} > {FFT_TOL}")
    require(torch.equal(torch.view_as_real(spec16).view(torch.int32),
                        torch.view_as_real(spec16f).view(torch.int32)),
            "kernel A: uint16 input differs from its float32 copy")
    ms16 = time_ms(lambda: kfft.fwd_yx(vol_u16, out=spec16))
    bms16, _ = bound(nvox * 2 + spec_bytes, fft_flops)
    print(f"A fwd_yx uint16: rel err {err16:.3g} (tol {FFT_TOL}), bit-exact vs its "
          f"float32 copy, ms {ms16:.4f}, bound_ms {bms16:.4f}")

    work = torch.empty_like(spec)
    work.copy_(spec)
    kfft.z_filter_(work, filt)
    spec_b = work.clone()
    err_abs, err = rel_err(spec_b, kfft.z_filter_plain_(spec.clone(), filt))
    require(err <= FFT_TOL, f"kernel B rel err {err:.3g} > {FFT_TOL}")
    bms, bby = bound(2 * spec_bytes + z * y * xh * 4,
                     2 * y * xh * 5 * z * math.log2(z) + 2 * z * y * xh)
    records["z_filter"] = dict(
        replaces="biahub_tpu/kernels/pallas_fft.py:442", source="biahub_tpu_torch/csrc/fft.cu",
        max_abs_err=err_abs,
        ms=time_ms(lambda: kfft.z_filter_(work, filt), setup=lambda: work.copy_(spec)),
        plain_ms=time_ms(lambda: kfft.z_filter_plain_(work, filt),
                         setup=lambda: work.copy_(spec)),
        bound_ms=bms, bound_by=bby, library_ms=None)
    print(f"B z_filter: rel err {err:.3g} (tol {FFT_TOL}), " + describe(records["z_filter"]))

    decon = torch.empty(SHAPE, dtype=torch.float32, device=dev)
    work.copy_(spec_b)
    kfft.inv_yx(work, out=decon)
    want = torch.fft.irfft2(spec_b, s=(y, x))
    err_abs, err = rel_err(decon, kfft.inv_yx_plain(spec_b.clone()))
    require(err <= FFT_TOL, f"kernel C rel err {err:.3g} > {FFT_TOL}")
    bms, bby = bound(spec_bytes + nvox * 4, fft_flops)
    records["inv_yx"] = dict(
        replaces="biahub_tpu/kernels/pallas_fft.py:530", source="biahub_tpu_torch/csrc/fft.cu",
        max_abs_err=err_abs,
        ms=time_ms(lambda: kfft.inv_yx(work, out=decon), setup=lambda: work.copy_(spec_b)),
        plain_ms=time_ms(lambda: kfft.inv_yx_plain(work, out=decon),
                         setup=lambda: work.copy_(spec_b)),
        bound_ms=bms, bound_by=bby,
        library_ms=time_ms(lambda: torch.fft.irfft2(spec_b, s=(y, x))))
    require(rel_err(want, decon)[1] <= FFT_TOL, "kernel C disagrees with irfft2")
    print(f"C inv_yx: rel err {err:.3g} (tol {FFT_TOL}), " + describe(records["inv_yx"]))
    del spec16, spec16f, spec_b, work, want

    # D on the batch the main path gives it: unit-range data for the
    # absolute tolerance, then the deconvolved volume as a second input.
    batch_in = torch.rand((BATCH,) + SHAPE, generator=gen, device=dev)
    got = deskew(batch_in, geo)
    err_abs = float((got - deskew_plain(batch_in, geo)).abs().max())
    require(err_abs <= DESKEW_TOL, f"kernel D abs err {err_abs:.3g} > {DESKEW_TOL}")
    _, err_real = rel_err(deskew(decon[None], geo), deskew_plain(decon[None], geo))
    require(err_real <= DESKEW_TOL, f"kernel D on a deconvolved volume: rel err {err_real:.3g}")
    # Bytes: the scan rows the geometry reads (every tilt row, the span of
    # in_z over X_out), once, plus the output.
    in_z = (torch.tensor(geo.px, dtype=torch.float32) * torch.arange(geo.x_out, dtype=torch.float32)[None]
            - torch.tensor(geo.pxct, dtype=torch.float32) * torch.arange(y, dtype=torch.float32)[:, None]
            + torch.tensor(geo.offset, dtype=torch.float32))
    lo = torch.floor(in_z).amin(dim=1).clamp(0, z - 1)
    hi = (torch.floor(in_z).amax(dim=1) + 1).clamp(0, z - 1)
    rows = int((hi - lo + 1).sum())
    out_elems = BATCH * geo.groups * x * geo.x_out
    bms, bby = bound(BATCH * rows * x * 4 + out_elems * 4, out_elems * AVG * 8)
    records["deskew"] = dict(
        replaces="biahub_tpu/kernels/pallas_deskew.py:210", source="biahub_tpu_torch/csrc/deskew.cu",
        max_abs_err=err_abs, ms=time_ms(lambda: deskew(batch_in, geo)),
        plain_ms=time_ms(lambda: deskew_plain(batch_in, geo)),
        bound_ms=bms, bound_by=bby, library_ms=None)
    print(f"D deskew (batch {BATCH}): abs err {err_abs:.3g} (tol {DESKEW_TOL}), "
          f"on a deconvolved volume rel err {err_real:.3g}, "
          + describe(records["deskew"]))

    # D's xzy store, the layout the warp's input_xzy read takes.
    got_xzy = deskew(batch_in, geo, "xzy")
    err_abs = float((got_xzy - deskew_plain(batch_in, geo).permute(0, 3, 1, 2)).abs().max())
    require(err_abs <= DESKEW_TOL, f"kernel D xzy abs err {err_abs:.3g} > {DESKEW_TOL}")
    require(torch.equal(got_xzy, got.permute(0, 3, 1, 2)), "kernel D: xzy store differs from zyx")
    records["deskew_xzy"] = dict(
        replaces="biahub_tpu/kernels/pallas_deskew.py:137", source="biahub_tpu_torch/csrc/deskew.cu",
        max_abs_err=err_abs, ms=time_ms(lambda: deskew(batch_in, geo, "xzy")),
        plain_ms=time_ms(lambda: deskew_plain(batch_in, geo).permute(0, 3, 1, 2).contiguous()),
        bound_ms=bms, bound_by=bby, library_ms=None)
    print(f"D deskew xzy (batch {BATCH}): abs err {err_abs:.3g} (tol {DESKEW_TOL}), "
          f"equal to the zyx store permuted, " + describe(records["deskew_xzy"]))

    # E and F on the deskewed batch the chain gives them, (8, 86, 1024, 484),
    # with the chain's matrix: reg_stab after the deskew's Y flip.
    desk = got
    b_, zi, yi, xi = desk.shape
    coeffs = inplane_coefficients(flip_y_matrix(yi) @ reg_stab_matrix()).to(dev)
    inter = warp_zy(desk, coeffs, (zi, yi))
    inter_p = warp_zy_plain(desk, coeffs, (zi, yi))
    err_abs, err = rel_err(inter, inter_p)
    require(err <= WARP_TOL, f"kernel E rel err {err:.3g} > {WARP_TOL}")
    require(torch.equal(warp_zy(got_xzy, coeffs, (zi, yi), input_xzy=True), inter),
            "kernel E: the xzy read differs from the zyx read")
    # One library call for E's function: grid_sample over B*Xi images of
    # (Zi, Yi), which are the xzy store's rows; border padding clamps.
    c = coeffs.cpu()
    xs = torch.arange(xi, dtype=torch.float32)[None, :]
    zc = (c[0] * torch.arange(zi, dtype=torch.float32)[:, None] + c[1] * xs) + c[2]
    yc = (c[3] * torch.arange(yi, dtype=torch.float32)[:, None] + c[4] * xs) + c[5]
    grid = torch.stack(torch.broadcast_tensors(
        lerp_grid(yc, yi).T[:, None, :], lerp_grid(zc, zi).T[:, :, None]), -1).to(dev)
    grid = grid.expand(b_, xi, zi, yi, 2).reshape(b_ * xi, zi, yi, 2)
    img = got_xzy.reshape(b_ * xi, 1, zi, yi)

    def library_zy():
        return torch.nn.functional.grid_sample(
            img, grid, mode="bilinear", padding_mode="border", align_corners=True)

    _, lib_err = rel_err(library_zy().reshape(b_, xi, zi, yi).permute(0, 2, 3, 1), inter)
    vol_bytes = desk.numel() * 4
    bms_w, bby_w = bound(2 * vol_bytes, desk.numel() * 15)
    records["warp_zy"] = dict(
        replaces="biahub_tpu/kernels/pallas_resample.py:857", source="biahub_tpu_torch/csrc/warp.cu",
        max_abs_err=err_abs, ms=time_ms(lambda: warp_zy(desk, coeffs, (zi, yi))),
        plain_ms=time_ms(lambda: warp_zy_plain(desk, coeffs, (zi, yi))),
        bound_ms=bms_w, bound_by=bby_w, library_ms=time_ms(library_zy))
    xzy_read_ms = time_ms(lambda: warp_zy(got_xzy, coeffs, (zi, yi), input_xzy=True))
    print(f"E warp_zy (batch {BATCH}): rel err {err:.3g} (tol {WARP_TOL}), grid_sample "
          f"within {lib_err:.3g} of it, " + describe(records["warp_zy"])
          + f"; the xzy read bit-equal, ms {xzy_read_ms:.4f}")
    del grid, img, inter_p

    # F with fill NaN, so that its mask reads off its output, voxel for voxel.
    nan = float("nan")
    out_k = warp_x(inter, coeffs, xi, geo.out_shape, nan)
    out_p = warp_x_plain(inter, coeffs, xi, geo.out_shape, nan)
    mask_k, mask_p = torch.isnan(out_k), torch.isnan(out_p)
    require(torch.equal(mask_k, mask_p), "kernel F: fill mask differs from the plain mask")
    n_masked = int(mask_k.sum())
    err_abs, err = rel_err(out_k[~mask_p], out_p[~mask_p])
    require(err <= WARP_TOL, f"kernel F rel err {err:.3g} > {WARP_TOL}")
    # grid_sample computes F's lerp (not its mask) over B*Zo images of (Yo, Xi).
    xc = (c[6] * torch.arange(xi, dtype=torch.float32)[None, :]
          + c[7] * torch.arange(yi, dtype=torch.float32)[:, None]) + c[8]
    grid = torch.stack(torch.broadcast_tensors(
        lerp_grid(xc, xi), lerp_grid(torch.arange(yi, dtype=torch.float32), yi)[:, None]),
        -1).to(dev)
    grid = grid.expand(b_ * zi, yi, xi, 2)
    img = inter.reshape(b_ * zi, 1, yi, xi)
    lerp_only_ms = time_ms(lambda: torch.nn.functional.grid_sample(
        img, grid, mode="bilinear", padding_mode="border", align_corners=True))
    records["warp_x"] = dict(
        replaces="biahub_tpu/kernels/pallas_resample.py:426", source="biahub_tpu_torch/csrc/warp.cu",
        max_abs_err=err_abs, ms=time_ms(lambda: warp_x(inter, coeffs, xi, geo.out_shape)),
        plain_ms=time_ms(lambda: warp_x_plain(inter, coeffs, xi, geo.out_shape)),
        bound_ms=bms_w, bound_by=bby_w, library_ms=None)
    print(f"F warp_x (batch {BATCH}): rel err {err:.3g} (tol {WARP_TOL}), fill mask equal "
          f"({n_masked} masked voxels in both), " + describe(records["warp_x"])
          + f", grid_sample lerp only (no mask) {lerp_only_ms:.4f}")
    del grid, img, out_k, out_p, mask_k, mask_p

    # E and F once more with fill -1 and another output shape.
    inter2 = warp_zy(desk, coeffs, OTHER_OUT[:2])
    _, err2 = rel_err(inter2, warp_zy_plain(desk, coeffs, OTHER_OUT[:2]))
    require(err2 <= WARP_TOL, f"kernel E to {OTHER_OUT}: rel err {err2:.3g}")
    out_k = warp_x(inter2, coeffs, OTHER_OUT[2], geo.out_shape, -1.0)
    out_p = warp_x_plain(inter2, coeffs, OTHER_OUT[2], geo.out_shape, -1.0)
    fill_k, fill_p = out_k == -1.0, out_p == -1.0
    require(torch.equal(fill_k, fill_p), f"kernel F to {OTHER_OUT}: fill mask differs")
    _, err3 = rel_err(out_k, out_p)
    require(err3 <= WARP_TOL, f"kernel F to {OTHER_OUT}, fill -1: rel err {err3:.3g}")
    print(f"E, F to {OTHER_OUT} with fill -1: rel err {err2:.3g}, {err3:.3g} "
          f"(tol {WARP_TOL}), {int(fill_k.sum())} fill voxels in both")
    del batch_in, got, got_xzy, desk, inter, inter2, out_k, out_p, fill_k, fill_p
    del decon, vol, vol_u16, vol_u16f, spec

    # -- 3. the headline step end to end -------------------------------------
    step = DeconvolveDeskew(tf_half, SHAPE, REG, ANGLE, RATIO, keep_overhang=False,
                            average_window=AVG, skip_flip=True, device=dev)
    vols_np = rng.integers(0, 65536, size=(BATCH,) + SHAPE, dtype=np.uint16)
    vols_f = torch.from_numpy(vols_np.astype(np.float32)).to(dev)
    vols_u = torch.from_numpy(vols_np).to(dev)
    del vols_np

    torch.cuda.synchronize()
    _build.reset_launch_counts()
    out_f = step(vols_f)
    torch.cuda.synchronize()
    launches = dict(_build.launch_counts)

    plain = []
    for v in vols_f:
        sp = kfft.fwd_yx_plain(v)
        kfft.z_filter_plain_(sp, step.filter)
        plain.append(kfft.inv_yx_plain(sp))
    ref = deskew_plain(torch.stack(plain), geo)
    del plain, sp
    require(out_f.shape == (BATCH,) + geo.out_shape, f"step output shape {tuple(out_f.shape)}")
    require(bool(torch.isfinite(out_f).all()), "step output is not finite")
    step_abs, step_err = rel_err(out_f, ref)
    require(step_err <= FFT_TOL, f"step rel err {step_err:.3g} > {FFT_TOL}")

    _build.reset_launch_counts()
    out_u = step(vols_u)
    torch.cuda.synchronize()
    launches_u = dict(_build.launch_counts)
    require(torch.equal(out_u.view(torch.int32), out_f.view(torch.int32)),
            "step: uint16 input differs from its float32 copy")
    for dtype, vols in (("float32", vols_f), ("uint16", vols_u)):
        q = statistics.quantiles(samples_ms(lambda: step(vols), reps=STEP_REPS), n=4)
        print(f"step (batch {BATCH}, {SHAPE}, {dtype} in): "
              f"{q[1] / BATCH:.4f} ms/volume median, {q[2] / BATCH:.4f} p75 "
              f"({STEP_REPS} samples), {BATCH * nvox / (q[1] / 1e3):.4g} voxels/s")
    print(f"step: rel err {step_err:.3g} vs the plain chain (tol {FFT_TOL}); uint16 "
          f"input bit-exact vs its float32 copy (launches {launches_u})")

    step_want = {"fwd_yx": BATCH, "z_filter": BATCH, "inv_yx": BATCH, "deskew": 1}
    require(launches == step_want, f"step launches {launches}, want {step_want}")
    print(f"step launches (float32 batch of {BATCH}): {launches}")
    del out_f, out_u

    # -- 4. the full chain end to end, and through the xzy handoff ---------
    chain = DeconvolveDeskewWarp(tf_half, SHAPE, REG, ANGLE, RATIO, reg_stab_matrix(),
                                 keep_overhang=False, average_window=AVG, device=dev)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    out_c = chain(vols_f)
    torch.cuda.synchronize()
    launches_c = dict(_build.launch_counts)
    chain_want = dict(step_want, warp_zy=1, warp_x=1)
    require(launches_c == chain_want, f"chain launches {launches_c}, want {chain_want}")

    zo_, yo_, xo_ = chain.output_shape
    ref_c = warp_x_plain(warp_zy_plain(ref, chain.warp, (zo_, yo_)), chain.warp, xo_,
                         chain.logical_zyx_shape, chain.fill)
    require(out_c.shape == (BATCH,) + chain.output_shape, f"chain output shape {tuple(out_c.shape)}")
    require(bool(torch.isfinite(out_c).all()), "chain output is not finite")
    chain_abs, chain_err = rel_err(out_c, ref_c)
    require(chain_err <= FFT_TOL, f"chain rel err {chain_err:.3g} > {FFT_TOL}")
    del ref_c, ref

    out_cu = chain(vols_u)
    require(torch.equal(out_cu.view(torch.int32), out_c.view(torch.int32)),
            "chain: uint16 input differs from its float32 copy")
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    out_x = run_chain_warp(vols_f, chain.filter, chain.geometry, chain.warp,
                           chain.output_shape, chain.fill, out_layout="xzy")
    torch.cuda.synchronize()
    launches_x = dict(_build.launch_counts)
    xzy_want = dict(chain_want, deskew_xzy=1)
    del xzy_want["deskew"]
    require(launches_x == xzy_want, f"xzy chain launches {launches_x}, want {xzy_want}")
    require(torch.equal(out_x.view(torch.int32), out_c.view(torch.int32)),
            "chain: the xzy route differs from the zyx route")
    for dtype, vols in (("float32", vols_f), ("uint16", vols_u)):
        q = statistics.quantiles(samples_ms(lambda: chain(vols), reps=STEP_REPS), n=4)
        print(f"chain (batch {BATCH}, {SHAPE}, {dtype} in, reg_stab): "
              f"{q[1] / BATCH:.4f} ms/volume median, {q[2] / BATCH:.4f} p75 "
              f"({STEP_REPS} samples), {BATCH * nvox / (q[1] / 1e3):.4g} input voxels/s")
    print(f"chain: rel err {chain_err:.3g} vs the plain chain (tol {FFT_TOL}); uint16 "
          "input bit-exact vs its float32 copy; the xzy route bit-equal to the zyx route")
    print(f"chain launches (float32 batch of {BATCH}): {launches_c}; xzy route: {launches_x}")

    # -- 5. the per-kernel line: launches from the chain's run, D's xzy store's
    # from the xzy route's --------------------------------------------------
    for name in records:
        runs = launches_x if name == "deskew_xzy" else launches_c
        require(runs.get(name, 0) >= 1, f"kernel {name} was not launched on its path")
        records[name]["launches"] = runs[name]
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": rec["source"], "replaces": rec["replaces"],
         "launches": rec["launches"], "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
         "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
         "library_ms": rec["library_ms"]}
        for name, rec in records.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
