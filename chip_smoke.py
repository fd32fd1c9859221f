#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's headline step on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``biahub_tpu_torch/csrc`` (into
``build/biahub_tpu_torch/``), holds each kernel against its plain PyTorch
version at the headline volume (256x256x1024), then runs the headline
deconvolve -> deskew step (``DeconvolveDeskew``: batch 8, Tikhonov reg 1e-3,
deskew at 36.17 deg, px_to_scan_ratio 0.371, average_window 3,
keep_overhang False, skip_flip True) against the plain chain, checks that
uint16 input gives the bits of its float32 copy, and that every kernel of
the path was launched. Times are CUDA-event medians on this card.

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
FFT_TOL = 2e-5     # max |kernel - plain| / max |plain| for A, B, C and the step
DESKEW_TOL = 1e-5  # max |kernel - plain| for D on unit-range data
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from biahub_tpu_torch import DeconvolveDeskew, gpu_info
    from biahub_tpu_torch.kernels import _build
    from biahub_tpu_torch.kernels import fft as kfft
    from biahub_tpu_torch.kernels.deconvolve import compute_transfer_function
    from biahub_tpu_torch.kernels.deskew import deskew_geometry, deskew_plain
    from biahub_tpu_torch.kernels.deskew_cuda import deskew

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
    print(f"A fwd_yx f32: rel err {err:.3g} (tol {FFT_TOL}), "
          + ", ".join(f"{k} {records['fwd_yx'][k]:.4f}" for k in
                      ("ms", "plain_ms", "library_ms", "bound_ms")))

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
    print(f"B z_filter: rel err {err:.3g} (tol {FFT_TOL}), "
          + ", ".join(f"{k} {records['z_filter'][k]:.4f}" for k in
                      ("ms", "plain_ms", "bound_ms")))

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
    print(f"C inv_yx: rel err {err:.3g} (tol {FFT_TOL}), "
          + ", ".join(f"{k} {records['inv_yx'][k]:.4f}" for k in
                      ("ms", "plain_ms", "library_ms", "bound_ms")))
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
          + ", ".join(f"{k} {records['deskew'][k]:.4f}" for k in
                      ("ms", "plain_ms", "bound_ms")))
    del batch_in, got, decon, vol, vol_u16, vol_u16f, spec

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

    # -- 4. launch counts on the path ----------------------------------------
    for name in records:
        require(launches.get(name, 0) >= 1, f"kernel {name} was not launched on the path")
        records[name]["launches"] = launches[name]
    print(f"launches on the path (float32 batch of {BATCH}): {launches}")
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
