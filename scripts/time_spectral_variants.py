#!/usr/bin/env python3
"""Time variants of kernel M (``csrc/spectral.cu``) against each other on
one NVIDIA card.

    python3 scripts/time_spectral_variants.py DIR

Builds every ``DIR/*.cu`` (edited copies of ``csrc/spectral.cu`` with its C
entries' signatures; headers from this checkout's ``csrc``) and this
checkout's ``spectral.cu``, each with the port's nvcc flags, in parallel,
and prints each build's ptxas registers and spills of the contraction. At
the headline (256, 256, 1024) with average_window 3, at the headline with
average_window 1, and at (43, 97, 121), on a spectrum filtered by
``torch.fft`` and the table of ``prepare_spectral_deskew``: each variant's
contraction against float64 and against its plain version; at the
headline its CUDA-event median, then all of them in turns (each variant,
then each again in reverse order). Then this checkout's irfft at the
headline, both stores, with 2, 4 and 8 column pairs a tile. Prints the
card's name and power limit first. Imports no JAX.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from biahub_tpu_torch.kernels import _build  # noqa: E402
from biahub_tpu_torch.kernels import spectral as kspec  # noqa: E402
from biahub_tpu_torch.kernels import spectral_cuda as kspc  # noqa: E402

P = ctypes.c_void_p
CASES = ((cs.SHAPE, cs.AVG, False), (cs.SHAPE, 1, True), ((43, 97, 121), 3, False))


def build(sources: dict) -> dict:
    procs = {}
    for name, path in sources.items():
        out = os.path.join(os.path.dirname(path), f"{name}.so")
        procs[name] = (out, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build._CSRC), "-o", out, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc {name} failed:\n{log[-3000:]}")
        m = re.search(r"lerp_contract_kernel.*?\n(?:.*\n){0,3}?.*?(\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads\n.*?Used (\d+) registers", log)
        print(f"{name}: ptxas lerp_contract_kernel " + (
            f"{m.group(3)} registers, {m.group(1)} bytes spill stores" if m else "not found"))
        lib = ctypes.CDLL(out)
        for fn, types in kspc._SIGNATURES.items():
            getattr(lib, fn).argtypes = types
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available() or len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    out_dir = os.path.join("build", "spectral_variants")
    os.makedirs(out_dir, exist_ok=True)
    sources = {"this": str(_build._CSRC / "spectral.cu")}
    for f in sorted(os.listdir(sys.argv[1])):
        if f.endswith(".cu"):
            sources[f[:-3]] = os.path.join(sys.argv[1], f)
    t0 = time.perf_counter()
    libs = build({k: v for k, v in sources.items()})
    print(f"build {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(16)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for shape, avg, keep in CASES:
        z, y, x = shape
        vol = torch.rand(shape, generator=gen, device=dev)
        filt = torch.rand((z, y, x // 2 + 1), generator=gen, device=dev)
        spec = torch.fft.ifft(torch.fft.fft(torch.fft.rfft2(vol), dim=0) * filt,
                              dim=1).contiguous()
        del vol, filt
        table = kspec.prepare_spectral_deskew(shape, cs.ANGLE, cs.RATIO, keep, avg, dev)
        rows, x_out, _ = table.shape
        groups = rows // avg
        xh = x // 2 + 1
        u64 = torch.einsum("gjxk,kgjc->gcx",
                           table.to(torch.complex128).reshape(groups, avg, x_out, z),
                           spec[:, kspc._tilt_rows(y, rows, dev), :].to(torch.complex128)
                           .reshape(z, groups, avg, xh))
        scale = float(u64.abs().max())
        u32 = kspc.lerp_contract_plain(spec, table, x, avg)
        line = (f"{shape} avg {avg}: plain vs float64 "
                f"{float((u32.to(torch.complex128) - u64).abs().max()) / scale:.3g}")
        u = torch.empty((groups, xh, x_out), dtype=torch.complex64, device=dev)

        def run(lib):
            rc = lib.lerp_contract(P(spec.data_ptr()), P(table.data_ptr()), P(u.data_ptr()), z,
                                   y, x, x_out, groups, avg, P(stream))
            if rc:
                raise SystemExit(f"lerp_contract: error {rc}")

        headline = shape == cs.SHAPE and avg == cs.AVG
        for name, lib in libs.items():
            run(lib)
            torch.cuda.synchronize()
            line += (f"; {name} vs float64 "
                     f"{float((u.to(torch.complex128) - u64).abs().max()) / scale:.3g}, vs plain "
                     f"{float((u - u32).abs().max() / u32.abs().max()):.3g}")
            if headline:
                line += f", {cs.time_ms(lambda: run(lib)):.4f} ms"
        print(line)
        if headline:
            turns = {}
            for name in list(libs) + list(libs)[::-1]:
                turns.setdefault(name, []).append(cs.time_ms(lambda: run(libs[name])))
            print("contraction in turns: " + "; ".join(
                f"{k} {' '.join(f'{t:.4f}' for t in v)} ms" for k, v in turns.items()))
            run(libs["this"])
            base = kspc.irfft_plan(x, x_out, groups)
            for layout in kspc.OUT_LAYOUTS:
                shp = (groups, x, x_out) if layout == "zyx" else (x_out, groups, x)
                o = torch.empty(shp, device=dev)
                want = kspc.irfft_columns_plain(u, x, layout)
                for log2l in (1, 2, 3):
                    tab, tile = kspc._axis_need(x, base.x, 1 << log2l,
                                                kspc._buffers(base.x, False))
                    smem = 8 * (tab + tile)
                    tiles = groups * -(-(-(-x_out // 2)) >> log2l)
                    grid = min(tiles, (2 if smem <= kspc._SMEM_TWO else 1)
                               * torch.cuda.get_device_properties(dev).multi_processor_count)

                    def irfft():
                        rc = libs["this"].lerp_irfft(P(u.data_ptr()), P(o.data_ptr()),
                                                     kspc._plan_code(base.x), log2l, tab, grid,
                                                     smem, x, x_out, groups,
                                                     int(layout == "xzy"), P(stream))
                        if rc:
                            raise SystemExit(f"lerp_irfft: error {rc}")

                    irfft()
                    torch.cuda.synchronize()
                    err = float((o - want).abs().max() / want.abs().max())
                    print(f"irfft {layout}, {1 << log2l} column pairs a tile ({smem} B shared, "
                          f"grid {grid}): rel err {err:.3g}, {cs.time_ms(irfft):.4f} ms")
        del spec, table, u, u64, u32
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
