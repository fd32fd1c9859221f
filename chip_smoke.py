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
alone. Then, on a timelapse of 12 deskewed volumes (86, 1024, 484), each a
smooth random volume rolled by a known integer drift, with the settings of
settings/example_estimate_stabilization_settings_xyz_pcc.yml cropped to a
(64, 1024, 256) PCC window:

4. holds kernel Bx (the PCC cross-power) against its plain version for
   all three normalizations;
5. runs estimate-stabilization (``estimate_stabilization_arrays``): the
   drift recovered exactly, the transforms equal to the plain route's,
   launches A 11 + one per chunk, Bx 11, C 11;
6. runs stabilize (``stabilize_tczyx``) with those transforms: equal to the
   base volume inside the frame and 0 outside, and to the plain warp; then
   with 12 in-plane matrices, E and F reading one coefficient row per
   volume (F's mask voxel for voxel); E and F once per batch.

Then, at the same deskewed shape:

7. holds kernel G (bead-peak candidates: 3^3 blur, block max, smallest
   index among ties) against its plain version on integer-valued data,
   values and indices equal, for (8, 8, 8) and estimate-psf's (64, 64, 32)
   blocks, blurred and not;
8. holds kernel H (one multipass pass) against its plain version for each
   canonical slot of a 3D euclidean matrix (1 deg about each axis and a
   subvoxel shift), then the whole multipass warp, and the batched form
   with a 6-row table of translations and rotations (the translation rows
   bit-equal to the plain route);
9. renders a beads timelapse (6 volumes, ~200 Gaussian beads in integer
   counts, each timepoint a known small rigid drift, rendered anew) and
   runs estimate-stabilization with
   settings/example_estimate_stabilization_settings_xyz_beads.yml: the
   transforms within 0.5 voxel and 0.05 (linear part) of the truth and
   equal to the same call with G and H replaced by their plain versions;
   then stabilize with them through H (launches counted per phase);
10. runs estimate-psf (``estimate_psf_arrays``) on two bead positions,
   equal to the plain route within 1e-6.

Then intensity registration, at the same deskewed shape:

11. holds kernels I and J (the multipass pass's VJP) against their plain
    versions in the traced warp's full-resolution frame (margin 0.15), for
    each canonical slot of a similarity (1.5 deg about z, 0.5 deg about y,
    scale 1.01), orders 1 and 3: I's three sums within 1e-6 relative of the
    plain version in float64, J within 1e-5 of max|ref|; then the NCC
    loss's 7-parameter gradient through the whole traced warp (H, I, J)
    within 1e-4 of the same through the plain versions; times H, I, J, and
    grid_sample forward and backward for one order-1 pass as the library;
12. runs optimize-registration (``optimize_registration_arrays``, crop
    True) on a rendered pair: zero-mean noise blurred by a Gaussian of 4
    voxels, and that
    volume warped by the inverse of a known similarity (1.5 deg about z,
    0.5 deg about y, scale 1.01, shift (0.8, -2.5, 3.0)), from the truth
    with its translation 2 voxels off on each axis: the result within 0.01
    (linear part) of the truth, within 0.05 voxel of it at the volume's
    centre and within 1 voxel at each of its corners (limits that the
    start fails), and within 1e-3 and 0.05 voxel (translation column) of
    the same call with H, I and J replaced by their plain versions;
    launches per level (H 7, I 7, J 6 per step), ms per level and per
    step, and ms per step at bench.py's optimizer shape (64, 256, 256).

Then reconstruction, at the deskewed FOV (86, 1024, 484), with
settings/example_reconstruct_settings.yml's optics (lambda 0.532 um, yx
pixel 0.325 um, z step 2.0 um, NA 1.2 detection and 0.52 illumination, n
1.3, reg 1e-3), birefringence at the default swing 0.1, T = 4:

13. holds A, B, Bc (the complex Hermitian filter) and C against their
    plain versions at that shape, at prime and odd lengths ((43, 97,
    121), (9, 10, 17)), which run as Bluestein lines, and at lengths that
    take the mixed-radix passes' radices 3 and 5 ((4, 96, 160)) and 7 and
    11 ((77, 1232, 308), and X = 484), A's uint16 input bit-exact; Bx at
    custom_padding's next_fast_len shape of the PCC crop in all three
    normalizations; one custom_padding PCC of two timelapse volumes (the
    drift exact, equal to the plain route); each kernel's time at those
    shapes beside its bound and rfft2 / irfft2; then (13b) A and C at
    every shape a path gives them (SLICE_SHAPES): ptxas' registers, stack
    and spills of both kernels, each shape's plan (radices, cluster, grid,
    shared memory), the error against the plain version, the time beside
    the plain version and rfft2 / irfft2, and a sweep of the cluster size
    (1, 2, 4, 8; A and C bit-equal across it);
14. runs compute-tf (``compute_transfer_function_arrays``) for phase and
    fluorescence, each transfer function within TF_TOL of the same
    formulas in float64 numpy;
15. renders a 4-timepoint, 5-state polarization timelapse (smooth
    retardance and orientation maps through the instrument matrix, times
    1 + the WOTF image of a weak phase object) in uint16 counts and runs
    reconstruct (``reconstruct_arrays``, birefringence + phase): every
    channel within 2e-5 of the route with A, Bc and C replaced by their
    plain versions, uint16 bit-exact vs its float32 copy, retardance and
    orientation within 1e-3 of the truth, the phase (of a State0 that the
    retardance modulates) within PHASE64_TOL of the exact Tikhonov solution
    in float64, launches A, Bc, C once per timepoint and no B; then phase
    and fluorescence on one brightfield channel, counts x (1 + the WOTF
    image) in float32: both within 2e-5 of the plain route, the phase
    within PHASE_OBJECT_TOL of the phase object through the Tikhonov
    passband |H|^2 / (|H|^2 + reg), launches A, Bc, C twice per timepoint.

Then the spectral deconvolve + deskew, the engine that evaluates the
deskew's lerp from the spectrum (kernels A, K, L, M):

16. holds kernels K (DFT along Z times a real or a complex filter), L
    (inverse DFT along Y) and M (the lerp-DFT contraction and the irfft,
    both stores) against their plain versions, K and L within FFT_TOL, M
    within SPECTRAL_TOL, M's xzy store equal to its zyx store transposed,
    at the headline (avg 3; avg 1 with the overhang kept), at (43, 97,
    121) avg 3, (16, 16, 2048) avg 2 and (16, 10, 3) avg 2 (SPECTRAL_CASES);
    then ``DeconvolveDeskew(spectral=True)`` and
    ``DeconvolveDeskewWarp(spectral=True)`` (reg_stab) on the headline
    batch, each within ENGINE_TOL of its composition route, uint16
    bit-exact, launches A, K, L, M 8 each and no B, C, D (E 1, F 1 for the
    chain); K, L, M's times beside their bounds, the table's build, and the
    step's and the chain's ms/volume on both routes.

Then the sharded deconvolution (the counterpart of
``biahub_tpu/parallel/sharded_fft.py``: kernels A, B or Bc, and C on
z-slab and ky-row shards, with two exchanges between them), on a virtual
mesh of this card (its shards run one after another on it, so nothing
crosses NVLink):

17. (a) deconvolves the headline volume (seed 17) over SHARD_N = 4 shards:
    bit-equal to the unsharded ``deconvolve_zyx``, uint16 bit-exact vs its
    float32 copy, launches A, B, C 4 each; both routes' ms/volume, each
    shard's A, B and C times, the two exchanges' times beside their byte
    bound, shard 0's B also with L2 cold, and A, B, C at the shard shapes
    beside their plain versions;
    over the real cards too where the machine has several; (b) the complex
    Hermitian filter at the deskewed FOV over 2 shards (z_l 43, Bluestein
    lines) bit-equal to ``fourier_filter_zyx``; (c) one z slice per shard,
    (8, 64, 128) over 8: A and C at Z = 1 against their plain versions,
    bit-equal to the unsharded route; (d) ``deconvolve_arrays`` on 2
    timepoints of the headline FOV, sharded and batched routes equal; (e)
    (86, 1024, 484) over 4 shards is not supported: ``deconvolve_zyx_sharded``
    raises, and ``deconvolve_arrays(sharded=True)`` takes the batched route,
    says so on stderr and is bit-equal to it.

Then kernels B, Bc and D after their redesign:

18. ptxas' registers, stack and spills of B's and D's kernels; B (headline),
    Bc (86, 1024, 484) and the sharded route's B (256, 64, 513) and D (both
    stores) beside the previous kernels' times and their bounds; at each
    Z-line shape the plan (kernels/fft.py z_plan), the error against the
    plain version, one tile a block and 8-line tiles bit-equal to the plan,
    and times with L2 warm (the input just copied, as the other phases
    time) and cold (L2_FLUSH_BYTES read after the copy): through the
    wrapper, the plan's launch alone, 8-line tiles, one tile a block, and
    torch.profiler's device time of the wrapper's kernel; D held bit for
    bit to ``deskew_exact`` (the per-voxel float32 arithmetic of the kernel
    it replaced) in both stores; torch.profiler's device time of B, Bc and
    D beside the previous kernels' readings.

Then kernels E and J after their redesign, and the repairs:

19. ptxas' registers, stack and spills of E's ``warp_zy_kernel`` and J's
    ``resample_pass_adjoint`` kernels; E on the chain's batch (8, 86, 1024,
    484) through both reads and on stabilize's batch of 12 with a table of
    translations, each within WARP_TOL of the plain version, its two reads
    bit-equal, its time beside the previous E's (PREVIOUS_MS), its bound,
    grid_sample's at the same shape and torch.profiler's device time; E
    with a 40 deg rotation (``overflow_matrix``: tile windows past their
    stage take the direct gathers) within WARP_TOL, both reads bit-equal; J
    at each slot and order of phase 11's traced frame bit for bit against
    ``adjoint_exact`` and within WARP_TOL of the plain version, its times
    beside the previous J's and its bound; G at blur 0, 3, 5 and 15 (G_BLURS)
    on integer-valued data, values and indices equal to the plain version;
    one deconvolution and one PCC pair at PAST_LIMITS (X = 4099, past the
    FFT kernels' 4096), within FFT_TOL of the plain route, no kernel
    launched, the stderr line printed.

Then kernels H and I after their redesign, and the last repair:

20. ptxas' registers, stack and spills of H's and I's kernels; H at each
    slot, orders 1 and 3, of phase 8's frame (one coefficient set, and a
    (2, 21) table over it and a rolled copy, the second row set the
    identity's) and of phase 11's traced frame, bit for bit against the
    plain version, with the tiles that read their taps from device memory
    (``multipass_cuda.pass_window``) counted; I at each slot and order of
    the traced frame within DERIV_TOL of the plain version, two runs
    bit-equal; their mean times beside the previous kernels' (PREVIOUS_MS),
    their bounds, grid_sample's forward pass (H, order 1) and torch.profiler's
    device time; then the step, the chain, ``tikhonov_inverse_3d`` and
    apply-inv-tf at PAST_FILTER (X = 4099) against the reference's formulas
    (torch.fft, and numpy in float64 for the filter), no launch of kernels A,
    B, Bc or C, each stderr line printed.

Times are CUDA-event medians on this card.

Prints the card's ``nvidia-smi`` name and power limit, one JSON line of
per-kernel numbers, and last ``{"ok": true, "device": {...}}``. Exits
non-zero without printing a result when there is no CUDA device, the
package is missing, or any check fails. Imports no JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
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
# The stabilization timelapse: T volumes of the deskewed headline shape,
# drifts |dz| <= 4, |dy|, |dx| <= 12 (zero at t = 0). T = 12 because
# evaluate_transforms needs validation_window_size (10) transforms.
T_LAPSE = 12
LAPSE_SHAPE = (86, 1024, 484)
MAX_DRIFT = (4, 12, 12)
# settings/example_estimate_stabilization_settings_xyz_pcc.yml, with Z and X
# slices that make the PCC crop (64, 1024, 256), a power of two.
PCC_SETTINGS = {
    "stabilization_estimation_channel": "Phase3D",
    "stabilization_channels": ["Phase3D"],
    "stabilization_type": "xyz",
    "stabilization_method": "phase-cross-corr",
    "phase_cross_corr_settings": {
        "normalization": "magnitude", "t_reference": "first", "function_type": "custom",
        "X_slice": [114, 370], "Y_slice": "all", "Z_slice": [11, 75],
    },
    "affine_transform_settings": {"transform_type": "euclidean"},
    "eval_transform_settings": {
        "validation_window_size": 10, "validation_tolerance": 1000.0,
        "interpolation_window_size": 3, "interpolation_type": "linear",
    },
    "verbose": False,
}
NORMS = (None, "magnitude", "classic")
# The chain's E and F with one coefficient set, per batch of 8, as PERF.md
# records them from before the per-volume table; this run's times are
# printed beside them.
RECORDED_WARP_MS = {"warp_zy": 1.733, "warp_x": 1.214}
# Kernel G's block geometries: beads' (DetectPeaksSettings) and
# estimate-psf's (estimate_psf.py:61-69).
PEAK_BLOCKS = ((8, 8, 8), (64, 64, 32))
# The beads timelapse (phases 9-10): T volumes of the deskewed headline
# shape, N Gaussian beads of peak BEAD_PEAK counts and BEAD_SIGMA voxels
# over a background of 20 +- 2 counts (DetectPeaksSettings' threshold_abs
# is 110), each timepoint a rigid drift of up to DRIFT_DEG about each axis
# and DRIFT_SHIFT voxels, about the volume's centre.
T_BEADS = 6
N_BEADS = 200
BEAD_PEAK = 1500.0
BEAD_SIGMA = (1.2, 1.5, 1.5)
DRIFT_DEG, DRIFT_SHIFT = 0.5, 3.0
TRUTH_SHIFT_TOL, TRUTH_LINEAR_TOL = 0.5, 0.05
# settings/example_estimate_stabilization_settings_xyz_beads.yml
BEADS_SETTINGS = {
    "stabilization_estimation_channel": "GFP",
    "stabilization_channels": ["GFP"],
    "stabilization_type": "xyz",
    "stabilization_method": "beads",
    "beads_match_settings": {"algorithm": "hungarian"},
    "affine_transform_settings": {"transform_type": "euclidean", "t_reference": "first"},
    "verbose": False,
}
# estimate-psf's patch in voxels (PsfFromBeadsSettings axis{0,1,2}_patch_size).
PSF_PATCH = (21, 41, 41)
PSF_TOL = 1e-6
# Intensity registration (phases 11-12): the truth's rotation (deg about z
# and y), scale and shift; the initial transform's translation error per
# axis; the reference volume's blur (zero-mean noise: a constant offset
# would make the zero fill of the warp's out-of-domain voxels an outlier
# that dominates the NCC as soon as Adam's first step rotates the edges
# out); the traced warp's margin (intensity.py). The result is held to the
# truth in its linear part, in its displacement at the volume's centre and
# in its largest displacement over the volume's eight corners: on a
# 1024-voxel axis a linear-part error of 1e-3 moves a corner by 0.5 voxel.
# The start (2 voxels off everywhere) must fail the same limits.
REG_ANGLES, REG_SCALE, REG_SHIFT = (1.5, 0.5), 1.01, (0.8, -2.5, 3.0)
REG_START_ERROR = (2.0, -2.0, 2.0)
REG_SIGMA, REG_MARGIN = 4.0, 0.15
TRUTH_REG_LINEAR_TOL, TRUTH_REG_CENTRE_TOL, TRUTH_REG_CORNER_TOL = 0.01, 0.05, 1.0
DERIV_TOL = 1e-6   # max |I - plain| / max |plain| (float64 sums)
GRAD_TOL = 1e-4    # the whole warp's gradient, kernels vs plain versions
PLAIN_LINEAR_TOL, PLAIN_SHIFT_TOL = 1e-3, 0.05
# bench.py's intensity-registration optimizer shape (bench.py:366-387).
BENCH_REG_SHAPE = (64, 256, 256)
BENCH_REG_STEPS = 20
# An H100 SXM's float64 rate outside the tensor cores (NVIDIA data sheet):
# kernel I's band derivative and sums are double.
F64_FLOP_PER_S = 34e12
# Reconstruction (phases 13-15): T_RECON timepoints of 5 polarization
# states at the deskewed FOV, with settings/example_reconstruct_settings.yml's
# optics, birefringence at the default swing; then phase and fluorescence
# on one brightfield channel (the fluorescence defaults: emission 0.507 um,
# NA 1.2, n 1.3).
T_RECON = 4
RECON_CHANNELS = ["State0", "State1", "State2", "State3", "State4"]
RECON_SETTINGS = {
    "input_channel_names": RECON_CHANNELS,
    "reconstruction_dimension": 3,
    "birefringence": {"transfer_function": {"swing": 0.1}},
    "phase": {
        "transfer_function": {
            "wavelength_illumination": 0.532, "yx_pixel_size": 0.325, "z_pixel_size": 2.0,
            "index_of_refraction_media": 1.3, "numerical_aperture_detection": 1.2,
            "numerical_aperture_illumination": 0.52,
        },
        "apply_inverse": {"reconstruction_algorithm": "Tikhonov",
                          "regularization_strength": 0.001},
    },
}
BF_SETTINGS = {
    "input_channel_names": ["BF"],
    "phase": RECON_SETTINGS["phase"],
    "fluorescence": {
        "transfer_function": {"yx_pixel_size": 0.325, "z_pixel_size": 2.0},
        "apply_inverse": {"regularization_strength": 0.001},
    },
}
# Small shapes with prime and odd lengths for the any-length kernels
# (Bluestein lines), and shapes whose lines take A and C's mixed-radix
# passes of radix 3 and 5 (96 = 8x4x3, 160 = 8x4x5) and 7 and 11
# (custom_padding's 1232 = 16x11x7, 308 = 4x11x7).
ODD_SHAPES = ((43, 97, 121), (9, 10, 17))
RADIX_SHAPES = ((4, 96, 160), (77, 1232, 308))
# Phase 13b: kernels A and C at every shape a path gives them: the headline
# volume, its z-slab over SHARD_N shards, the deskewed FOV (reconstruction),
# the PCC crop and custom_padding's next_fast_len shape of the crop; the
# launches of the last two come from estimate-stabilization and the
# custom_padding PCC.
SLICE_SHAPES = {"headline": (256, 256, 1024), "shard": (64, 256, 1024),
                "reconstruction": (86, 1024, 484), "PCC crop": (64, 1024, 256),
                "custom_padding": (77, 1232, 308)}
CLUSTER_SWEEP = (1, 2, 4, 8)
# The rendered polarization states: counts per unit transmittance, the
# retardance range (rad) and the weak phase object's amplitude (rad).
RECON_COUNTS, RETARDANCE_RANGE, PHASE_AMPLITUDE = 15000.0, (0.3, 1.2), 0.2
# Retardance (rad), orientation (mod pi), BF (of the counts) and Pol from
# the rendered truth, as tests/test_recon_golden.py holds them.
BIREF_TOL = 1e-3
# The port's float32 transfer functions against the same formulas in
# float64, and its phase against the exact float64 Tikhonov solution:
# measured 3.5e-6 (WOTF), 1.1e-7 (OTF) and 7.3e-7 on an NVIDIA H100 80GB
# HBM3, 700 W (the WOTF's float32 defocus phase, up to ~1300 rad, rounds
# to ~6e-5 rad); held at about five times that.
TF_TOL = 2e-5
PHASE64_TOL = 5e-6
# The brightfield channel's phase against the phase object through the
# Tikhonov passband, in float64.
PHASE_OBJECT_TOL = 1e-3
# Phase 16: (raw shape, average_window, keep_overhang) of the K, L and M
# checks: an odd shape (Bluestein lines), X = 2048 (M's kx in two chunks,
# its lines beside its stage buffers), X = 3 (the least irfft), the
# headline with the overhang kept and no averaging, and the headline last.
SPECTRAL_CASES = (((43, 97, 121), 3, False), ((16, 16, 2048), 2, False), ((16, 10, 3), 2, True),
                  (SHAPE, 1, True), (SHAPE, AVG, False))
SPECTRAL_TOL = 2e-5  # max |M - plain| / max |plain|
ENGINE_TOL = 2e-4    # the spectral step and chain vs their composition routes
# Phase 17: the headline volume sharded over SHARD_N shards of one card
# (a virtual mesh), the reconstruction's FOV over 2 with the complex filter,
# and one z slice per shard; the verb on arrays over T_SHARD timepoints.
SHARD_N = 4
SHARD_RECON = (LAPSE_SHAPE, 2)
SHARD_ONE_SLICE = ((8, 64, 128), 8)
T_SHARD = 2

# Phase 18: kernels B, Bc and D after their redesign. PREVIOUS_MS: the
# times of the kernels they replaced (PERF.md section 6, their proof run:
# NVIDIA H100 80GB HBM3, 700.00 W); PREVIOUS_TRACE: trace_b_and_d's
# readings of those kernels (commit da77dae, same card and limit: device
# time a launch and the bound's bytes over it; neither ncu, "Failed to
# initialize the profiler: LibraryNotLoaded", nor CUPTI's counters through
# torch.profiler read anything on that machine). Z_SHAPES: the Z-line
# shapes the paths give B and Bc, the headline spectrum, the deskewed
# FOV's (Bc) and a headline shard's ky rows (the sharded route's B).
# L2_FLUSH_BYTES (flush_l2), read after a timed run's input is copied,
# leave none of it in the H100's 50 MB L2 (phases 17 and 18).
PREVIOUS_MS = {"z_filter": 0.552, "z_filter_complex": 1.799, "z_filter_shard": 0.1607,
               "deskew": 3.219, "deskew_xzy": 2.896,
               # Phase 19: E (the chain's batch of 8, its xzy read, stabilize's
               # batch of 12 with a table) and J (the mean of phase 11's order-1
               # slots) before their redesign (PERF.md section 6, rows 8, 12, 13).
               "warp_zy": 1.7399, "warp_zy_xzy": 6.4767, "warp_zy_per_volume": 2.619,
               "resample_pass_adjoint": 1.700,
               # Phase 20: H (the mean of phase 8's order-3 slots; of phase 11's
               # order-1 slots) and I (the mean of phase 11's order-1 slots)
               # before their redesign (PERF.md section 6, rows 11, 13).
               "resample_pass": 0.3702, "resample_pass_traced": 0.4136,
               "resample_pass_deriv": 0.7381}
PHASE_18_KEYS = ("z_filter", "z_filter_complex", "z_filter_shard", "deskew", "deskew_xzy")
CARD_OF_PREVIOUS = "NVIDIA H100 80GB HBM3, 700.00 W"
# Phase 19: kernel G's blur sizes, and a volume past the FFT kernels' limits
# (X = 4099: not a power of two, above 4096).
G_BLURS = (0, 3, 5, 15)
PAST_LIMITS = (4, 64, 4099)
# Phase 20: a volume past the FFT kernels' limits that the deskew takes
# (8 scan planes of 4 x 4099 pixels; deskewed (2, 4099, 19) at average 3).
PAST_FILTER = (8, 4, 4099)
PREVIOUS_TRACE = {
    "z_filter": "z_filter_kernel<false, false, true>: 0.5482 ms device, 1227 GB/s (37% of HBM)",
    "z_filter_complex": "z_filter_kernel<true, true, true>: 1.7909 ms device, 287 GB/s (9% of "
                        "HBM)",
    "deskew": "deskew_kernel<false>: 3.1631 ms device, 912 GB/s (27% of HBM)",
    "deskew_xzy": "deskew_kernel<true>: 2.8124 ms device, 1025 GB/s (31% of HBM)",
}
Z_SHAPES = {"z_filter": ((256, 256, 513), False), "z_filter_complex": ((86, 1024, 243), True),
            "z_filter_shard": ((256, 64, 513), False)}
TRACE_REPS = 20
L2_FLUSH_BYTES = 256 << 20


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


_L2_FLUSH: dict = {}


def flush_l2(dev: torch.device) -> None:
    """Reads L2_FLUSH_BYTES, so that nothing written or read before stays in
    L2 (clean lines: nothing is left to write back)."""
    if dev not in _L2_FLUSH:
        _L2_FLUSH[dev] = torch.zeros(L2_FLUSH_BYTES // 4, device=dev)
    _L2_FLUSH[dev].sum()


def bound(nbytes: float, flops: float, f64_flops: float = 0.0) -> tuple[float, str]:
    """Least time on the card (ms) for the work, and what bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / F32_FLOP_PER_S + f64_flops / F64_FLOP_PER_S
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


def overflow_matrix() -> np.ndarray:
    """A 40 deg in-plane rotation about the deskewed volume's centre: kernel
    E's tile windows exceed their stage (|b1| = tan 40 deg), so its tiles
    take the direct gathers (phase 19)."""
    theta = np.deg2rad(40.0)
    m = np.eye(4)
    m[1:3, 1:3] = [[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]]
    centre = (np.asarray(LAPSE_SHAPE, float) - 1) / 2
    m[:3, 3] = centre - m[:3, :3] @ centre
    return m


def lerp_grid(c: torch.Tensor, size: int) -> torch.Tensor:
    """Coordinates as grid_sample's align_corners=True normalised grid."""
    return c * (2.0 / (size - 1)) - 1.0


def host_ms(fn, reps: int = 3) -> float:
    """Median host-clock time of ``fn`` ending in a synchronize, after one
    warm-up run (for calls that read results back to the host)."""
    times = []
    for i in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if i:
            times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def counted(fn) -> tuple[object, dict]:
    """``fn()``'s result and the kernel launches it made, counted from 0."""
    from biahub_tpu_torch.kernels import _build

    torch.cuda.synchronize()
    _build.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(_build.launch_counts)


def zy_grid(c: torch.Tensor, zi: int, yi: int, xi: int) -> torch.Tensor:
    """grid_sample's grid for E's function over the (Zi, Yi) images of each
    input column x: (B*Xi, Zi, Yi, 2) from a (B, 21) coefficient table."""
    xs = torch.arange(xi, dtype=torch.float32, device=c.device)[None, None, :]
    zo = torch.arange(zi, dtype=torch.float32, device=c.device)[None, :, None]
    yo = torch.arange(yi, dtype=torch.float32, device=c.device)[None, :, None]
    zc = (c[:, 0, None, None] * zo + c[:, 1, None, None] * xs) + c[:, 2, None, None]
    yc = (c[:, 3, None, None] * yo + c[:, 4, None, None] * xs) + c[:, 5, None, None]
    zg = lerp_grid(zc, zi).permute(0, 2, 1)[:, :, :, None]  # (B, Xi, Zo, 1)
    yg = lerp_grid(yc, yi).permute(0, 2, 1)[:, :, None, :]  # (B, Xi, 1, Yo)
    return torch.stack(torch.broadcast_tensors(yg, zg), -1).reshape(-1, zi, yi, 2)


def describe(rec: dict) -> str:
    return ", ".join(f"{k} {rec[k]:.4f}" for k in ("ms", "plain_ms", "library_ms", "bound_ms")
                     if rec[k] is not None)


def pcc_timelapse(dev: torch.device):
    """The PCC timelapse (T_LAPSE, 1, *LAPSE_SHAPE): a smooth base rolled by
    known integer drifts (zero at t = 0); returns it, the drifts, the base
    and the generator that drew the drifts."""
    gen = torch.Generator(device=dev).manual_seed(0)
    # Noise blurred by a 3-voxel box: a correlation length of a few voxels.
    # Heavier blurs leave too little high-frequency power for the
    # magnitude-normalized PCC, which then locks onto the crop's edges.
    base = torch.nn.functional.avg_pool3d(
        torch.rand(LAPSE_SHAPE, generator=gen, device=dev)[None, None], 3, 1, 1)[0, 0]
    rng = np.random.default_rng(0)
    drift = np.stack([rng.integers(-m, m + 1, T_LAPSE) for m in MAX_DRIFT], axis=1)
    drift[0] = 0
    lapse = torch.stack([torch.roll(base, tuple(int(d) for d in dt), (0, 1, 2))
                         for dt in drift])[:, None]  # (T, C=1, Z, Y, X)
    return lapse, drift, base, rng


def pcc_crop(lapse: torch.Tensor) -> torch.Tensor:
    """The PCC settings' (Z, X) crop of every timepoint, (T, 64, 1024, 256)."""
    pcc = PCC_SETTINGS["phase_cross_corr_settings"]
    zs, xs = slice(*pcc["Z_slice"]), slice(*pcc["X_slice"])
    return lapse[:, 0, zs, :, xs].contiguous()


def stabilization_phases(dev: torch.device, records: dict) -> None:
    """Phases 4-6 on the timelapse: Bx against its plain version,
    estimate-stabilization, stabilize; adds the records of Bx and of E and F
    with a per-volume coefficient table."""
    from biahub_tpu_torch import ArrayPosition, estimate_stabilization_arrays, stabilize_tczyx
    from biahub_tpu_torch.estimate_stabilization import (
        DEFAULT_MAX_BATCH_BYTES,
        get_tform_from_pcc,
    )
    from biahub_tpu_torch.kernels import fft as kfft
    from biahub_tpu_torch.kernels import pcc as kpcc
    from biahub_tpu_torch.kernels.affine import coefficient_table, warp_x_plain, warp_zy_plain
    from biahub_tpu_torch.kernels.warp_cuda import warp_x, warp_zy
    from biahub_tpu_torch.registration.utils import evaluate_transforms
    from biahub_tpu_torch.stabilize import stabilize_batch_size

    z, y, x = LAPSE_SHAPE
    lapse, drift, base, rng = pcc_timelapse(dev)
    crop = pcc_crop(lapse)  # (T, 64, 1024, 256)
    cz, cy, cx = crop.shape[1:]
    cxh = cx // 2 + 1
    print(f"timelapse: {T_LAPSE} x {LAPSE_SHAPE}, drift (dz, dy, dx) {drift[1:].tolist()}; "
          f"PCC crop {tuple(crop.shape[1:])}")

    # -- 4. Bx against its plain version, all three normalizations ----------
    ref_spec, mov_spec = kfft.fwd_yx(crop[0]), kfft.fwd_yx(crop[1])
    kept = ref_spec.clone()
    out = torch.empty_like(mov_spec)
    # The plain version runs on the same spectra promoted to complex128, as
    # the kernel computes in double: the normalizations divide by |c|, so
    # a bin near zero beside a large one turns float32 rounding of the
    # Z-transform into an error of order one in its phase, and the plain
    # version in float32 (cuFFT) is itself ~2e-5 of max|ref| from exact
    # with magnitude. Its distance is printed beside the kernel's.
    worst = 0.0
    for norm in NORMS:
        kfft.z_cross_(ref_spec, mov_spec, out, norm)
        want = kfft.z_cross_plain_(ref_spec.to(torch.complex128),
                                   mov_spec.to(torch.complex128),
                                   torch.empty_like(mov_spec), norm)
        err_abs, err = rel_err(out, want)
        require(err <= FFT_TOL, f"kernel Bx ({norm}) rel err {err:.3g} > {FFT_TOL}")
        _, err32 = rel_err(kfft.z_cross_plain_(ref_spec, mov_spec,
                                               torch.empty_like(mov_spec), norm), want)
        worst = max(worst, err_abs)
        alias = mov_spec.clone()
        kfft.z_cross_(ref_spec, alias, alias, norm)
        require(torch.equal(alias, out), f"kernel Bx ({norm}): out = mov differs")
        print(f"Bx z_cross ({norm}): rel err {err:.3g} (tol {FFT_TOL}) vs the plain "
              f"version in float64; the plain version in float32 {err32:.3g} from it")
    require(torch.equal(ref_spec, kept), "kernel Bx wrote the reference spectrum")
    cspec = cz * cy * cxh * 8
    bms, bby = bound(3 * cspec, 3 * cy * cxh * 5 * cz * math.log2(cz) + 20 * cz * cy * cxh)
    records["z_cross"] = dict(
        replaces="biahub_tpu/kernels/pallas_fft.py:1338", source="biahub_tpu_torch/csrc/fft.cu",
        max_abs_err=worst,
        ms=time_ms(lambda: kfft.z_cross_(ref_spec, mov_spec, out, "magnitude")),
        plain_ms=time_ms(lambda: kfft.z_cross_plain_(ref_spec, mov_spec, out, "magnitude")),
        bound_ms=bms, bound_by=bby, library_ms=None)
    print("Bx z_cross (magnitude, the settings'): " + describe(records["z_cross"])
          + "; no single PyTorch call computes it")
    pair_ms = time_ms(lambda: kpcc.pcc_corr(crop[0], crop[1], "magnitude"))
    a_ms = time_ms(lambda: kfft.fwd_yx(crop[0], out=mov_spec))
    print(f"one PCC pair (A, A, Bx, C): {pair_ms:.4f} ms; A at the crop {a_ms:.4f} ms, "
          f"bound {bound(cz * cy * cx * 4 + cspec, 0)[0]:.4f}")
    del ref_spec, mov_spec, kept, out, want, alias

    # -- 5. estimate-stabilization ------------------------------------------
    positions = {"A/1/0": ArrayPosition(lapse, [1.0] * 5, ["Phase3D"])}

    def estimate():
        return estimate_stabilization_arrays(positions, PCC_SETTINGS, device=dev)

    result, launches_e = counted(estimate)
    transforms = result["xyz"]["A_1_0"]
    got_shift = np.asarray(transforms)[:, :3, 3]
    require(np.array_equal(got_shift, drift), f"estimated drift {got_shift.tolist()} "
            f"differs from {drift.tolist()}")
    t_chunk = max(1, DEFAULT_MAX_BATCH_BYTES // (crop[0].numel() * 4 * 8))
    chunks = math.ceil((T_LAPSE - 1) / t_chunk)
    want_e = {"fwd_yx": T_LAPSE - 1 + chunks, "z_cross": T_LAPSE - 1, "inv_yx": T_LAPSE - 1}
    require(launches_e == want_e, f"estimate launches {launches_e}, want {want_e}")
    # The plain route on the card: torch.fft's correlation per pair.
    plain = [np.eye(4).tolist()] + [
        get_tform_from_pcc(kpcc._shift_of(kpcc._pcc_core(crop[0], crop[t], "magnitude"))
                           .cpu().numpy().astype(np.float64))
        for t in range(1, T_LAPSE)]
    ev = PCC_SETTINGS["eval_transform_settings"]
    plain = evaluate_transforms(plain, LAPSE_SHAPE, ev["validation_window_size"],
                                ev["validation_tolerance"], ev["interpolation_window_size"],
                                ev["interpolation_type"])
    require(transforms == plain, "estimate: transforms differ from the plain route's")
    est_ms = host_ms(estimate)
    print(f"estimate-stabilization ({T_LAPSE} timepoints, {T_LAPSE - 1} pairs in {chunks} "
          f"chunks of <= {t_chunk}): drift recovered exactly, transforms equal to the "
          f"plain route's; {est_ms:.3f} ms for the call, {est_ms / (T_LAPSE - 1):.4f} ms "
          f"per pair; launches {launches_e}")
    del crop

    # -- 6. stabilize with those transforms, then 12 in-plane matrices -------
    batches = math.ceil(T_LAPSE / stabilize_batch_size(LAPSE_SHAPE, LAPSE_SHAPE, T_LAPSE))
    want_s = {"warp_zy": batches, "warp_x": batches}
    stab, launches_s = counted(lambda: stabilize_tczyx(lapse, transforms, device=dev))
    require(launches_s == want_s, f"stabilize launches {launches_s}, want {want_s}")
    require(stab.shape == lapse.shape, f"stabilize output shape {tuple(stab.shape)}")
    vols = lapse[:, 0]
    table = coefficient_table(np.asarray(transforms)).to(dev)
    ref_s = warp_x_plain(warp_zy_plain(vols, table, (z, y)), table, x, LAPSE_SHAPE)
    _, err_s = rel_err(stab[:, 0], ref_s)
    require(err_s <= WARP_TOL, f"stabilize rel err {err_s:.3g} > {WARP_TOL}")
    grid = [torch.arange(n, device=dev).reshape([-1 if i == a else 1 for i in range(3)])
            for a, n in enumerate(LAPSE_SHAPE)]
    n_out = 0
    for t in range(T_LAPSE):
        inside = torch.ones(LAPSE_SHAPE, dtype=torch.bool, device=dev)
        for g, d, n in zip(grid, drift[t], LAPSE_SHAPE):
            inside &= (g + int(d) >= 0) & (g + int(d) <= n - 1)
        require(torch.equal(stab[t, 0][inside], base[inside]),
                f"stabilize: timepoint {t} differs from the base inside the frame")
        require(bool((stab[t, 0][~inside] == 0).all()),
                f"stabilize: timepoint {t} is not 0 outside the frame")
        n_out += int((~inside).sum())
    stab_ms = host_ms(lambda: stabilize_tczyx(lapse, transforms, device=dev))
    print(f"stabilize (translations): equal to the base inside the frame, 0 on the "
          f"{n_out} voxels outside; rel err {err_s:.3g} vs the plain warp (tol {WARP_TOL}); "
          f"{stab_ms:.3f} ms for {T_LAPSE} volumes; launches {launches_s}")
    del stab, ref_s

    theta = rng.uniform(-1.0, 1.0, T_LAPSE)
    mats = np.stack([np.eye(4)] * T_LAPSE)
    for m, th, sh in zip(mats, np.deg2rad(theta), rng.uniform(-3.0, 3.0, (T_LAPSE, 3))):
        m[1:3, 1:3] = [[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]]
        m[:3, 3] = sh
    stab_ip, launches_ip = counted(lambda: stabilize_tczyx(lapse, mats, device=dev))
    require(launches_ip == want_s, f"in-plane stabilize launches {launches_ip}, want {want_s}")
    table_ip = coefficient_table(mats).to(dev)
    inter = warp_zy(vols, table_ip, (z, y))
    _, err_e = rel_err(inter, warp_zy_plain(vols, table_ip, (z, y)))
    require(err_e <= WARP_TOL, f"per-volume E rel err {err_e:.3g} > {WARP_TOL}")
    nan = float("nan")
    out_k = warp_x(inter, table_ip, x, LAPSE_SHAPE, nan)
    out_p = warp_x_plain(inter, table_ip, x, LAPSE_SHAPE, nan)
    mask_k, mask_p = torch.isnan(out_k), torch.isnan(out_p)
    require(torch.equal(mask_k, mask_p), "per-volume F: fill mask differs from the plain mask")
    _, err_f = rel_err(out_k[~mask_p], out_p[~mask_p])
    require(err_f <= WARP_TOL, f"per-volume F rel err {err_f:.3g} > {WARP_TOL}")
    ref_ip = torch.nan_to_num(out_p, nan=0.0)
    err_abs_ip, err_ip = rel_err(stab_ip[:, 0], ref_ip)
    require(err_ip <= WARP_TOL, f"in-plane stabilize rel err {err_ip:.3g} > {WARP_TOL}")
    print(f"stabilize (12 in-plane matrices): rel err {err_ip:.3g} (tol {WARP_TOL}); "
          f"per-volume E {err_e:.3g}, F {err_f:.3g}, F's mask equal on "
          f"{int(mask_k.sum())} voxels; launches {launches_ip}")
    del stab_ip, out_k, out_p, mask_k, mask_p, ref_ip, inter

    # The per-volume E and F on the translation batch stabilize ran.
    vol_bytes = vols.numel() * 4
    bms_w, bby_w = bound(2 * vol_bytes, vols.numel() * 15)
    img = vols.permute(0, 3, 1, 2).reshape(-1, 1, z, y)
    grid_zy = zy_grid(table, z, y, x)

    def library_zy():
        return torch.nn.functional.grid_sample(
            img, grid_zy, mode="bilinear", padding_mode="border", align_corners=True)

    inter = warp_zy(vols, table, (z, y))
    inter_p = warp_zy_plain(vols, table, (z, y))
    err_abs, err = rel_err(inter, inter_p)
    _, lib_err = rel_err(library_zy().reshape(T_LAPSE, x, z, y).permute(0, 2, 3, 1), inter)
    records["warp_zy_per_volume"] = dict(
        replaces="biahub_tpu/kernels/pallas_resample.py:862",
        source="biahub_tpu_torch/csrc/warp.cu", counter="warp_zy", runs=launches_s,
        max_abs_err=err_abs, ms=time_ms(lambda: warp_zy(vols, table, (z, y))),
        plain_ms=time_ms(lambda: warp_zy_plain(vols, table, (z, y))),
        bound_ms=bms_w, bound_by=bby_w, library_ms=time_ms(library_zy))
    print(f"E warp_zy, one row per volume (batch {T_LAPSE}): rel err {err:.3g}, grid_sample "
          f"within {lib_err:.3g}, " + describe(records["warp_zy_per_volume"]))
    del img, grid_zy, inter_p
    out_p = warp_x_plain(inter, table, x, LAPSE_SHAPE)
    err_abs, err = rel_err(warp_x(inter, table, x, LAPSE_SHAPE), out_p)
    require(err <= WARP_TOL, f"per-volume F on translations: rel err {err:.3g}")
    records["warp_x_per_volume"] = dict(
        replaces="biahub_tpu/kernels/pallas_resample.py:430",
        source="biahub_tpu_torch/csrc/warp.cu", counter="warp_x", runs=launches_s,
        max_abs_err=err_abs, ms=time_ms(lambda: warp_x(inter, table, x, LAPSE_SHAPE)),
        plain_ms=time_ms(lambda: warp_x_plain(inter, table, x, LAPSE_SHAPE)),
        bound_ms=bms_w, bound_by=bby_w, library_ms=None)
    print(f"F warp_x, one row per volume (batch {T_LAPSE}): rel err {err:.3g}, "
          + describe(records["warp_x_per_volume"]))
    records["z_cross"].update(runs=launches_e)
    del lapse, vols, inter, out_p, base
    torch.cuda.empty_cache()


@contextlib.contextmanager
def plain_kernels():
    """Kernels G, H, I and J replaced by their plain PyTorch versions on the
    card, for the plain route of a whole call (the wrappers are looked up at
    each call); nothing is counted."""
    from biahub_tpu_torch.kernels import multipass_cuda, multipass_warp, peaks, peaks_cuda

    saved = (multipass_cuda.resample_pass, multipass_cuda.resample_pass_deriv,
             multipass_cuda.resample_pass_adjoint, peaks_cuda.block_max_argmin)
    multipass_cuda.resample_pass = (
        lambda frame, coeffs, slot, r, o, order=3, fill=0.0, out=None:
        multipass_warp.resample_pass_plain(frame, coeffs, slot, r, o, order, fill))
    multipass_cuda.resample_pass_deriv = multipass_warp.resample_pass_deriv_plain
    multipass_cuda.resample_pass_adjoint = (
        lambda ybar, coeffs, slot, r, o, order=3, out=None:
        multipass_warp.resample_pass_adjoint_plain(ybar, coeffs, slot, r, o, order))
    peaks_cuda.block_max_argmin = peaks.block_max_candidates_plain
    try:
        yield
    finally:
        (multipass_cuda.resample_pass, multipass_cuda.resample_pass_deriv,
         multipass_cuda.resample_pass_adjoint, peaks_cuda.block_max_argmin) = saved


def rigid_about_centre(angles_deg, shift, shape) -> np.ndarray:
    """The output->input warp of a rotation by ``angles_deg`` about the x,
    y and z axes in turn (in ZYX index space), about the volume's centre,
    then ``shift``."""
    rot = np.eye(3)
    for axis, deg in zip((2, 1, 0), angles_deg):
        i, j = (a for a in range(3) if a != axis)
        c, s_ = np.cos(np.deg2rad(deg)), np.sin(np.deg2rad(deg))
        r = np.eye(3)
        r[i, i], r[i, j], r[j, i], r[j, j] = c, -s_, s_, c
        rot = r @ rot
    centre = (np.asarray(shape) - 1) / 2
    m = np.eye(4)
    m[:3, :3] = rot
    m[:3, 3] = centre - rot @ centre + np.asarray(shift)
    return m


def render_beads(points: torch.Tensor, shape, gen: torch.Generator) -> torch.Tensor:
    """(Z, Y, X) float32 camera counts: a Gaussian bead at each of the (N, 3)
    float64 ``points`` (11^3 voxels around it), plus noise of 20 +- 2,
    rounded and clipped at 0."""
    dev = points.device
    r = torch.arange(-5, 6, device=dev)
    off = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)
    cells = torch.floor(points).long()[:, None, :] + off[None]
    sig = torch.tensor(BEAD_SIGMA, dtype=torch.float64, device=dev)
    val = BEAD_PEAK * torch.exp(-0.5 * (((cells.double() - points[:, None]) / sig) ** 2).sum(-1))
    ok = ((cells >= 0) & (cells < torch.tensor(shape, device=dev))).all(-1)
    flat = (cells[..., 0] * shape[1] + cells[..., 1]) * shape[2] + cells[..., 2]
    vol = torch.normal(20.0, 2.0, (math.prod(shape),), generator=gen, device=dev,
                       dtype=torch.float64)
    vol.index_add_(0, flat[ok], val[ok])
    return torch.round(vol).clamp_(min=0).float().reshape(shape)


def peaks_phase(dev: torch.device, records: dict) -> None:
    """Phase 7: kernel G against its plain version on integer-valued data."""
    import torch.nn.functional as F

    from biahub_tpu_torch.kernels.peaks import block_grid, block_max_candidates_plain
    from biahub_tpu_torch.kernels.peaks_cuda import block_max_argmin

    gen = torch.Generator(device=dev).manual_seed(7)
    vol = torch.randint(0, 4096, LAPSE_SHAPE, generator=gen, device=dev).float()
    # Bytes: the volume once, a value and an index per block; operations:
    # 26 adds, 3 multiplies and a divide per voxel for the blur.
    bounds = {b: bound(vol.numel() * 4 + math.prod(block_grid(LAPSE_SHAPE, b)) * 8,
                       vol.numel() * 30) for b in PEAK_BLOCKS}
    worst = 0.0
    for block in PEAK_BLOCKS:
        for blur in (3, 0):
            gv, gi = block_max_argmin(vol, block, blur)
            pv, pi = block_max_candidates_plain(vol, block, blur)
            worst = max(worst, float((gv - pv).abs().max()))
            require(torch.equal(gv, pv) and torch.equal(gi, pi),
                    f"kernel G {block} blur {blur}: {int((gv != pv).sum())} values and "
                    f"{int((gi != pi).sum())} indices differ from the plain version")
            n = gv.numel()
            ms = time_ms(lambda: block_max_argmin(vol, block, blur))
            print(f"G block_max_argmin {block} blur {blur}: {n} blocks, values and indices "
                  f"equal to the plain version; ms {ms:.4f}, bound {bounds[block][0]:.4f}")
    block = PEAK_BLOCKS[0]
    n = math.prod(block_grid(LAPSE_SHAPE, block))
    bms, bby = bounds[block]

    def two_calls():
        smooth = F.avg_pool3d(vol[None, None], 3, 1, 1, count_include_pad=False)
        return F.max_pool3d(smooth, block, block, [b // 2 for b in block], return_indices=True)

    lib_v, lib_i = two_calls()
    gv, gi = block_max_argmin(vol, block, 3)
    same = int((lib_i.flatten().to(torch.int32) == gi).sum())
    records["block_max_argmin"] = dict(
        replaces="biahub_tpu/kernels/pallas_peaks.py:125", source="biahub_tpu_torch/csrc/peaks.cu",
        max_abs_err=worst, ms=time_ms(lambda: block_max_argmin(vol, block, 3)),
        plain_ms=time_ms(lambda: block_max_candidates_plain(vol, block, 3)),
        bound_ms=bms, bound_by=bby, library_ms=time_ms(two_calls))
    print(f"G block_max_argmin {block} blur 3 (beads'): " + describe(records["block_max_argmin"])
          + f"; library = two calls, avg_pool3d(count_include_pad=False) then "
          f"max_pool3d(return_indices=True), whose indices agree on {same} of {n} blocks")
    del vol, lib_v, lib_i, gv, gi
    torch.cuda.empty_cache()


def rigid_frame(dev: torch.device):
    """Phase 8's pass inputs: a smoothed random volume of LAPSE_SHAPE (seed
    8), a rigid matrix (1 deg about each axis, a subvoxel shift), its 7
    canonical (cr, co, tau), the volume embedded in the matrix's frame
    (1, F0, F1, F2) and the float32 (7, 3) table of the frame's
    coefficients."""
    from biahub_tpu_torch.kernels import multipass_warp as mw

    gen = torch.Generator(device=dev).manual_seed(8)
    vol = torch.nn.functional.avg_pool3d(
        torch.rand(LAPSE_SHAPE, generator=gen, device=dev)[None, None], 3, 1, 1)[0, 0]
    m = rigid_about_centre((1.0, 1.0, 1.0), (0.3, -0.4, 0.25), LAPSE_SHAPE)
    coeffs = mw._factor_canonical(m)
    off, frame_shape = mw.union_frame(m, LAPSE_SHAPE, LAPSE_SHAPE)
    frame = mw._embed(vol[None], off, frame_shape)
    table = torch.tensor([[cr, co, mw._tau_eff(r, o, cr, co, tau, off)]
                          for (r, o), (cr, co, tau) in zip(mw.CANONICAL_SLOTS, coeffs)],
                         dtype=torch.float32, device=dev)
    return vol, m, coeffs, frame, table


def traced_rows(dev: torch.device):
    """Phase 11's traced frame of LAPSE_SHAPE at REG_MARGIN: its shape, the
    registration truth's [(r, o, row)] and their float32 (7, 3) table."""
    from biahub_tpu_torch.kernels import multipass_warp as mw

    truth = torch.tensor(similarity_about_centre(LAPSE_SHAPE), dtype=torch.float32, device=dev)
    off, frame_shape, _ = mw.traced_frame(LAPSE_SHAPE, LAPSE_SHAPE, REG_MARGIN)
    rows = mw.traced_pass_rows(truth, off)
    return tuple(frame_shape), rows, torch.stack([row for _, _, row in rows]).contiguous()


def multipass_phase(dev: torch.device, records: dict) -> None:
    """Phase 8: kernel H against its plain version for each canonical slot
    of a 3D euclidean matrix, the whole warp, and the batched form."""
    from biahub_tpu_torch.kernels import multipass_warp as mw
    from biahub_tpu_torch.kernels.multipass_cuda import resample_pass

    vol, m, coeffs, frame, table = rigid_frame(dev)
    frame_shape = tuple(frame.shape[1:])
    out = torch.empty_like(frame)
    worst, bit_equal, ms, plain_ms = 0.0, 0, [], []
    for k, (r, o) in enumerate(mw.CANONICAL_SLOTS):
        got = resample_pass(frame, table, k, r, o, out=out)
        want = mw.resample_pass_plain(frame, table, k, r, o)
        err_abs, err = rel_err(got, want)
        require(err <= WARP_TOL, f"kernel H slot {k} ({r}, {o}): rel err {err:.3g} > {WARP_TOL}")
        worst = max(worst, err_abs)
        bit_equal += int(torch.equal(got, want))
        ms.append(time_ms(lambda: resample_pass(frame, table, k, r, o, out=out)))
        plain_ms.append(time_ms(lambda: mw.resample_pass_plain(frame, table, k, r, o)))
        print(f"H resample_pass slot {k} (r {r}, o {o}; cr {coeffs[k][0]:.6f}, co "
              f"{coeffs[k][1]:.6f}): rel err {err:.3g} (tol {WARP_TOL}), ms {ms[-1]:.4f}, "
              f"plain {plain_ms[-1]:.4f}")
        del want
    fbytes = frame.numel() * 4
    bms, bby = bound(2 * fbytes, frame.numel() * 30)
    records["resample_pass"] = dict(
        replaces="biahub_tpu/kernels/pallas_resample.py:129",
        source="biahub_tpu_torch/csrc/multipass.cu", max_abs_err=worst,
        ms=statistics.mean(ms), plain_ms=statistics.mean(plain_ms),
        bound_ms=bms, bound_by=bby, library_ms=None)
    print(f"H resample_pass, mean of the 7 slots on the {frame_shape} frame of {LAPSE_SHAPE} "
          f"({bit_equal} of 7 bit-equal to the plain version): "
          + describe(records["resample_pass"]) + "; no PyTorch call computes a Catmull-Rom pass")
    del frame, out, got

    warped, launches = counted(lambda: mw.multipass_affine_warp_zyx(vol, m, LAPSE_SHAPE,
                                                                     device=dev))
    with plain_kernels():
        want = mw.multipass_affine_warp_zyx(vol, m, LAPSE_SHAPE, device=dev)
    _, err = rel_err(warped, want)
    require(err <= WARP_TOL, f"multipass warp rel err {err:.3g} > {WARP_TOL}")
    require(bool(torch.isfinite(warped).all()), "multipass warp is not finite")
    warp_ms = time_ms(lambda: mw.multipass_affine_warp_zyx(vol, m, LAPSE_SHAPE, device=dev))
    print(f"multipass warp ({LAPSE_SHAPE}, 1 deg about each axis): rel err {err:.3g} vs the "
          f"plain route (bit-equal: {torch.equal(warped, want)}), {warp_ms:.4f} ms; "
          f"launches {launches}")
    del warped, want

    mats = [np.eye(4) for _ in range(3)] + [
        rigid_about_centre(a, s_, LAPSE_SHAPE)
        for a, s_ in (((1.0, 1.0, 1.0), (0.3, -0.4, 0.25)), ((-0.5, 0.8, 0.3), (1.5, 2.0, -1.0)),
                      ((0.2, -1.0, 0.6), (-2.0, 0.5, 3.0)))]
    for mt, sh in zip(mats[:3], ((0.5, -1.25, 2.0), (-1.0, 3.0, 0.25), (2.0, 0.0, -0.75))):
        mt[:3, 3] = sh
    vols = torch.stack([torch.roll(vol, (i, 2 * i, -i), (0, 1, 2)) for i in range(len(mats))])
    got, launches_b = counted(lambda: mw.multipass_affine_warp_zyx_batched(
        vols, np.stack(mats), LAPSE_SHAPE, device=dev))
    with plain_kernels():
        want = mw.multipass_affine_warp_zyx_batched(vols, np.stack(mats), LAPSE_SHAPE,
                                                    device=dev)
    for i in range(3):
        require(torch.equal(got[i], want[i]), f"batched multipass: translation row {i} "
                "differs from the plain route")
    _, err = rel_err(got, want)
    require(err <= WARP_TOL, f"batched multipass rel err {err:.3g} > {WARP_TOL}")
    batch_ms = time_ms(lambda: mw.multipass_affine_warp_zyx_batched(
        vols, np.stack(mats), LAPSE_SHAPE, device=dev))
    print(f"batched multipass (6 rows: 3 translations, 3 rotations): translation rows "
          f"bit-equal to the plain route, rel err {err:.3g}, {batch_ms:.4f} ms; "
          f"launches {launches_b}")
    del vol, vols, got, want
    torch.cuda.empty_cache()


def beads_phases(dev: torch.device, records: dict) -> None:
    """Phases 9-10: estimate-stabilization with beads, stabilize with its
    transforms, and estimate-psf, on rendered beads."""
    from biahub_tpu_torch import (
        ArrayPosition,
        estimate_psf_arrays,
        estimate_stabilization_arrays,
        stabilize_tczyx,
    )
    from biahub_tpu_torch.kernels.peaks import detect_peaks
    from biahub_tpu_torch.registration.beads import overlap_score

    gen = torch.Generator(device=dev).manual_seed(9)
    rng = np.random.default_rng(9)
    lo = np.array([10.0, 10.0, 10.0])
    hi = np.asarray(LAPSE_SHAPE) - 10.0
    points = rng.uniform(lo, hi, (N_BEADS, 3))
    truth = [np.eye(4)] + [
        rigid_about_centre(rng.uniform(-DRIFT_DEG, DRIFT_DEG, 3),
                           rng.uniform(-DRIFT_SHIFT, DRIFT_SHIFT, 3), LAPSE_SHAPE)
        for _ in range(T_BEADS - 1)]
    lapse = torch.stack([
        render_beads(torch.tensor(points @ w[:3, :3].T + w[:3, 3], device=dev), LAPSE_SHAPE,
                     gen) for w in truth])[:, None]
    print(f"beads timelapse: {T_BEADS} x {LAPSE_SHAPE}, {N_BEADS} beads, drifts up to "
          f"{DRIFT_DEG} deg and {DRIFT_SHIFT} voxels")

    # -- 9. estimate-stabilization with beads, then stabilize ---------------
    positions = {"A/1/0": ArrayPosition(lapse, [1.0] * 5, ["GFP"])}

    def estimate():
        return estimate_stabilization_arrays(positions, BEADS_SETTINGS, device=dev)

    result, launches_e = counted(estimate)
    transforms = result["xyz"]["A_1_0"]
    got = np.asarray(transforms)
    worst_shift = float(np.abs(got[:, :3, 3] - np.stack(truth)[:, :3, 3]).max())
    worst_lin = float(np.abs(got[:, :3, :3] - np.stack(truth)[:, :3, :3]).max())
    require(worst_shift <= TRUTH_SHIFT_TOL and worst_lin <= TRUTH_LINEAR_TOL,
            f"beads estimate: {worst_shift:.3g} voxels and {worst_lin:.3g} (linear part) from "
            f"the truth (tol {TRUTH_SHIFT_TOL}, {TRUTH_LINEAR_TOL})")
    with plain_kernels():
        plain = estimate()["xyz"]["A_1_0"]
    require(transforms == plain, "beads estimate: transforms differ from the plain route's")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    estimate()
    torch.cuda.synchronize()
    est_ms = 1e3 * (time.perf_counter() - t0)
    print(f"estimate-stabilization (beads, {T_BEADS} timepoints): within {worst_shift:.3g} "
          f"voxels and {worst_lin:.3g} (linear part) of the truth, equal to the plain route's; "
          f"{est_ms:.1f} ms for the call (host clock, one run); launches {launches_e}")

    stab, launches_s = counted(lambda: stabilize_tczyx(lapse, transforms, device=dev))
    with plain_kernels():
        stab_p = stabilize_tczyx(lapse, transforms, device=dev)
    _, err_s = rel_err(stab, stab_p)
    require(err_s <= WARP_TOL, f"beads stabilize rel err {err_s:.3g} > {WARP_TOL}")
    require(stab.shape == lapse.shape and bool(torch.isfinite(stab).all()),
            f"beads stabilize output {tuple(stab.shape)} is not finite and of the input's shape")
    del stab_p
    peak_kw = dict(block_size=(8, 8, 8), threshold_abs=110, nms_distance=16, min_distance=0,
                   device=dev)
    ref_peaks = detect_peaks(lapse[0, 0], **peak_kw)
    scores = [overlap_score(detect_peaks(stab[t, 0], **peak_kw), ref_peaks)
              for t in range(T_BEADS)]
    require(min(scores) >= 0.9, f"stabilized beads overlap the first frame's: {scores}")
    stab_ms = host_ms(lambda: stabilize_tczyx(lapse, transforms, device=dev), reps=1)
    print(f"stabilize (beads transforms): rel err {err_s:.3g} vs the plain route, bead "
          f"overlap with t = 0 {min(scores):.3f}-{max(scores):.3f}; {stab_ms:.1f} ms for "
          f"{T_BEADS} volumes; launches {launches_s}")
    runs = dict(launches_e)
    for k, v in launches_s.items():
        runs[k] = runs.get(k, 0) + v
    records["block_max_argmin"]["runs"] = runs
    records["resample_pass"]["runs"] = runs
    del stab

    # -- 10. estimate-psf on two bead positions -----------------------------
    pzyx = lapse[:2, 0]
    psf, launches_p = counted(lambda: estimate_psf_arrays(pzyx, (1.0, 1.0, 1.0), PSF_PATCH,
                                                          device=dev))
    with plain_kernels():
        psf_p = estimate_psf_arrays(pzyx, (1.0, 1.0, 1.0), PSF_PATCH, device=dev)
    err_p = float((psf - psf_p).abs().max())
    require(err_p <= PSF_TOL, f"estimate-psf: {err_p:.3g} from the plain route (tol {PSF_TOL})")
    require(psf.shape == PSF_PATCH and bool(torch.isfinite(psf).all())
            and float(psf.max()) == 1.0, f"estimate-psf output {tuple(psf.shape)}")
    centre = np.unravel_index(int(psf.argmax()), PSF_PATCH)
    require(all(abs(c - n // 2) <= 1 for c, n in zip(centre, PSF_PATCH)),
            f"estimate-psf: peak at {centre}, not the patch centre")
    psf_ms = host_ms(lambda: estimate_psf_arrays(pzyx, (1.0, 1.0, 1.0), PSF_PATCH, device=dev))
    print(f"estimate-psf (2 positions, patch {PSF_PATCH}): {err_p:.3g} from the plain route "
          f"(tol {PSF_TOL}), peak at the centre; {psf_ms:.1f} ms; launches {launches_p}")
    del lapse, pzyx, psf, psf_p
    torch.cuda.empty_cache()

def sync() -> None:
    torch.cuda.synchronize()


def similarity_about_centre(shape) -> np.ndarray:
    """The registration truth: the output->input warp of REG_SCALE times a
    rotation by REG_ANGLES (about z, then y) about the volume's centre,
    then REG_SHIFT."""
    rot = rigid_about_centre((0.0, REG_ANGLES[1], REG_ANGLES[0]), (0.0, 0.0, 0.0), shape)
    lin = REG_SCALE * rot[:3, :3]
    centre = (np.asarray(shape) - 1) / 2
    m = np.eye(4)
    m[:3, :3] = lin
    m[:3, 3] = centre - lin @ centre + np.asarray(REG_SHIFT)
    return m


def gaussian_noise(shape, sigma: float, gen: torch.Generator) -> torch.Tensor:
    """Zero-mean uniform noise blurred by a Gaussian of ``sigma`` voxels
    (three 1D float32 convolutions, zero padding)."""
    dev = gen.device
    radius = int(math.ceil(3 * sigma))
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=dev)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    k = k / k.sum()
    v = torch.rand(shape, generator=gen, device=dev)[None, None] - 0.5
    for axis in range(3):
        size, pad = [1, 1, 1], [0, 0, 0]
        size[axis], pad[axis] = len(k), radius
        v = torch.nn.functional.conv3d(v, k.reshape(1, 1, *size), padding=pad)
    return v[0, 0].contiguous()


def warp_trilinear(vol: torch.Tensor, matrix: np.ndarray) -> torch.Tensor:
    """``vol`` warped by an output->input ``matrix``, trilinear, 0 outside
    (grid_sample, independent of the port's warps)."""
    shape = vol.shape
    m = torch.tensor(matrix, dtype=torch.float64, device=vol.device)
    ramps = [torch.arange(n, dtype=torch.float64, device=vol.device).reshape(
        [-1 if i == a else 1 for i in range(3)]) for a, n in enumerate(shape)]
    coords = [((m[a, 0] * ramps[0] + m[a, 1] * ramps[1]) + m[a, 2] * ramps[2]) + m[a, 3]
              for a in range(3)]
    grid = torch.stack([lerp_grid(coords[a], shape[a]).float().expand(shape)
                        for a in (2, 1, 0)], -1)[None]
    return torch.nn.functional.grid_sample(vol[None, None], grid, mode="bilinear",
                                           padding_mode="zeros", align_corners=True)[0, 0]


def vjp_phase(dev: torch.device, records: dict) -> None:
    """Phase 11: kernels I and J against their plain versions in the traced
    warp's full-resolution frame, each canonical slot of the registration
    truth, orders 1 and 3; the whole warp's gradient; the library's pass."""
    from biahub_tpu_torch.kernels import multipass_warp as mw
    from biahub_tpu_torch.kernels.multipass_cuda import (
        resample_pass,
        resample_pass_adjoint,
        resample_pass_deriv,
    )
    from biahub_tpu_torch.registration import intensity as ti

    shape = LAPSE_SHAPE
    gen = torch.Generator(device=dev).manual_seed(11)
    vol = torch.nn.functional.avg_pool3d(
        torch.rand(shape, generator=gen, device=dev)[None, None], 3, 1, 1)[0, 0]
    truth = torch.tensor(similarity_about_centre(shape), dtype=torch.float32, device=dev)
    off, frame_shape, _ = mw.traced_frame(shape, shape, REG_MARGIN)
    rows = mw.traced_pass_rows(truth, off)
    table = torch.stack([row for _, _, row in rows]).contiguous()
    frame = mw._embed(vol[None], off, frame_shape)
    ybar = torch.randn(frame.shape, generator=gen, device=dev)
    out = torch.empty_like(frame)
    nvox = frame.numel()
    print(f"traced frame of {shape} at margin {REG_MARGIN}: {frame_shape}, "
          f"{frame.numel() * 4 / 1e6:.1f} MB")
    fbytes = nvox * 4
    bms_h, bby_h = bound(2 * fbytes, 12 * nvox)
    # I: reads the frame and ybar once (and writes 3 doubles a row); the
    # order-1 band derivative, product and three sums are ~9 double ops.
    bms_i, bby_i = bound(2 * fbytes + frame_shape[0] * frame_shape[1] * 24, 0, 9 * nvox)
    # J: reads ybar, writes dbar; each sample's 2 weights and 2 products.
    bms_j, bby_j = bound(2 * fbytes, 6 * nvox)
    bounds = {"H": bms_h, "I": bms_i, "J": bms_j}
    worst_i, worst_j = 0.0, 0.0
    ms = {name: [] for name in ("H", "I", "J", "H plain", "I plain", "J plain")}
    for order in (1, 3):
        for k, (r, o, _) in enumerate(rows):
            got_i = resample_pass_deriv(frame, ybar, table, k, r, o, order)
            want_i = mw.resample_pass_deriv_plain(frame, ybar, table, k, r, o, order)
            err_i = float((got_i - want_i).abs().max() / want_i.abs().max())
            require(err_i <= DERIV_TOL, f"kernel I slot {k} order {order}: rel err {err_i:.3g}")
            worst_i = max(worst_i, float((got_i - want_i).abs().max()))
            got_j = resample_pass_adjoint(ybar, table, k, r, o, order, out=out)
            want_j = mw.resample_pass_adjoint_plain(ybar, table, k, r, o, order)
            err_abs_j, err_j = rel_err(got_j, want_j)
            require(err_j <= WARP_TOL, f"kernel J slot {k} order {order}: rel err {err_j:.3g}")
            worst_j = max(worst_j, err_abs_j)
            del want_j
            line = f"slot {k} (r {r}, o {o}) order {order}: I rel err {err_i:.3g}, J {err_j:.3g}"
            if order == 1:
                times = {
                    "H": time_ms(lambda: resample_pass(frame, table, k, r, o, 1, out=out)),
                    "I": time_ms(lambda: resample_pass_deriv(frame, ybar, table, k, r, o, 1)),
                    "J": time_ms(lambda: resample_pass_adjoint(ybar, table, k, r, o, 1, out=out)),
                    "H plain": time_ms(lambda: mw.resample_pass_plain(frame, table, k, r, o, 1)),
                    "I plain": time_ms(lambda: mw.resample_pass_deriv_plain(frame, ybar, table,
                                                                            k, r, o, 1)),
                    "J plain": time_ms(lambda: mw.resample_pass_adjoint_plain(ybar, table, k, r,
                                                                              o, 1)),
                }
                for name, t in times.items():
                    ms[name].append(t)
                line += "; ms " + ", ".join(
                    f"{n} {t:.4f}" + (f" (bound {bounds[n]:.4f})" if n in bounds else "")
                    for n, t in times.items())
            print(line)
    mean = {name: statistics.mean(v) for name, v in ms.items()}

    # The library: grid_sample forward and backward (input and grid) for
    # slot 0's order-1 pass on the same frame.
    r, o, _ = rows[0]
    zyx = [mw._pass_coords(frame.shape, table, 0, r, o) if a == r
           else mw._axis_ramp(frame_shape[a], a, dev) for a in range(3)]
    zyx = torch.broadcast_tensors(*zyx)
    grid = torch.stack([lerp_grid(zyx[a][0], frame_shape[a]) for a in (2, 1, 0)], -1)[None]
    inp = frame[:, None].clone().requires_grad_(True)
    grid.requires_grad_(True)
    del zyx

    def library():
        lib_out = torch.nn.functional.grid_sample(inp, grid, mode="bilinear",
                                                  padding_mode="border", align_corners=True)
        return torch.autograd.grad(lib_out, (inp, grid), ybar[:, None])

    lib_ms = time_ms(library)
    del grid, inp

    records["resample_pass_deriv"] = dict(
        replaces="biahub_tpu/kernels/pallas_resample.py:1226",
        source="biahub_tpu_torch/csrc/multipass.cu", max_abs_err=worst_i, ms=mean["I"],
        plain_ms=mean["I plain"], bound_ms=bms_i, bound_by=bby_i, library_ms=lib_ms)
    records["resample_pass_adjoint"] = dict(
        replaces="biahub_tpu/kernels/pallas_resample.py:1271",
        source="biahub_tpu_torch/csrc/multipass.cu", max_abs_err=worst_j, ms=mean["J"],
        plain_ms=mean["J plain"], bound_ms=bms_j, bound_by=bby_j, library_ms=lib_ms)
    print(f"order-1 passes in the {frame_shape} frame, mean of the 7 slots: H {mean['H']:.4f} "
          f"ms (plain {mean['H plain']:.4f}, bound {bms_h:.4f} {bby_h}); I "
          + describe(records["resample_pass_deriv"]) + "; J "
          + describe(records["resample_pass_adjoint"])
          + f"; library = grid_sample fwd+bwd, order 1 (slot 0): {lib_ms:.4f} ms")
    del frame, ybar, out, got_i, got_j

    # The NCC loss's gradient in the 7 similarity parameters through the
    # whole traced warp, kernels against plain versions.
    target = torch.nn.functional.avg_pool3d(
        torch.rand(shape, generator=gen, device=dev)[None, None], 3, 1, 1)[0, 0]
    center = (torch.tensor(shape, dtype=torch.float32, device=dev) - 1) / 2
    p0 = torch.tensor([0.01, -0.005, 0.008, 0.005, 0.3, -0.2, 0.4], device=dev)
    warp = mw.make_traced_multipass_warp(shape, shape, margin=REG_MARGIN, order=1, device=dev)

    def gradient():
        p = p0.clone().requires_grad_(True)
        loss = ti._ncc_loss(warp(vol, ti._similarity_matrix(p, center)), target)
        return torch.autograd.grad(loss, p)[0]

    g_k, launches = counted(gradient)
    with plain_kernels():
        g_p = gradient()
    err_g = float((g_k - g_p).abs().max() / g_p.abs().max())
    require(err_g <= GRAD_TOL, f"warp gradient: rel err {err_g:.3g} > {GRAD_TOL}")
    want_l = {"resample_pass": 7, "resample_pass_deriv": 7, "resample_pass_adjoint": 6}
    require(launches == want_l, f"one gradient: launches {launches}, want {want_l}")
    grad_ms = host_ms(gradient)
    print(f"NCC gradient through the traced warp at {shape}: rel err {err_g:.3g} vs the plain "
          f"versions (tol {GRAD_TOL}); {grad_ms:.3f} ms (host clock, loss and gradient); "
          f"launches {launches}")
    del vol, target
    torch.cuda.empty_cache()


def registration_phase(dev: torch.device, records: dict) -> None:
    """Phase 12: optimize-registration on a rendered pair, against the truth
    and the plain route; per-level launches and times; ms per step at
    bench.py's optimizer shape."""
    from biahub_tpu_torch import optimize_registration_arrays
    from biahub_tpu_torch.kernels import _build
    from biahub_tpu_torch.kernels.multipass_warp import traced_frame
    from biahub_tpu_torch.registration import intensity as ti

    shape = LAPSE_SHAPE
    gen = torch.Generator(device=dev).manual_seed(12)
    ref = gaussian_noise(shape, REG_SIGMA, gen)
    truth = similarity_about_centre(shape)
    mov = warp_trilinear(ref, np.linalg.inv(truth))
    initial = truth.copy()
    initial[:3, 3] += REG_START_ERROR
    print(f"registration pair: {shape}, noise blurred by sigma {REG_SIGMA}; truth "
          f"{REG_ANGLES} deg about (z, y), scale {REG_SCALE}, shift {REG_SHIFT}; start "
          f"{REG_START_ERROR} voxels off")

    levels = []
    level_fn = ti._optimize_level

    def timed_level(mov_l, ref_l, params0, center, n_iters, out_shape):
        sync()
        before = dict(_build.launch_counts)
        t0 = time.perf_counter()
        result = level_fn(mov_l, ref_l, params0, center, n_iters, out_shape)
        sync()
        spent = 1e3 * (time.perf_counter() - t0)
        after = dict(_build.launch_counts)
        levels.append(dict(shape=tuple(mov_l.shape), steps=n_iters, ms=spent,
                           launches={k: v - before.get(k, 0) for k, v in after.items()
                                     if v != before.get(k, 0)}))
        return result

    def run():
        return optimize_registration_arrays(mov[None], ref[None], initial, crop=True, device=dev)

    ti._optimize_level = timed_level
    try:
        sync()
        t0 = time.perf_counter()
        got, launches = counted(run)
        call_ms = 1e3 * (time.perf_counter() - t0)
        kernel_levels = list(levels)
        with plain_kernels():
            plain = run()
    finally:
        ti._optimize_level = level_fn
    centre = np.append((np.asarray(shape) - 1) / 2, 1.0)
    corners = np.array([[z, y, x, 1.0] for z in (0, shape[0] - 1) for y in (0, shape[1] - 1)
                        for x in (0, shape[2] - 1)])

    def truth_errors(m):
        """(linear part, voxels at the centre, voxels at the worst corner)."""
        return (float(np.abs(m[:3, :3] - truth[:3, :3]).max()),
                float(np.abs((m - truth) @ centre)[:3].max()),
                float(np.abs((m - truth) @ corners.T)[:3].max()))

    def near_truth(errs):
        return (errs[0] <= TRUTH_REG_LINEAR_TOL and errs[1] <= TRUTH_REG_CENTRE_TOL
                and errs[2] <= TRUTH_REG_CORNER_TOL)

    lin_err, centre_err, corner_err = truth_errors(got)
    column_err = float(np.abs(got[:3, 3] - truth[:3, 3]).max())
    require(not near_truth(truth_errors(initial)), "optimize-registration: the start passes "
            "the truth check, which therefore cannot fail")
    require(near_truth((lin_err, centre_err, corner_err)),
            f"optimize-registration: {lin_err:.3g} (linear part), {centre_err:.3g} voxels at the "
            f"centre and {corner_err:.3g} at the worst corner from the truth (tol "
            f"{TRUTH_REG_LINEAR_TOL}, {TRUTH_REG_CENTRE_TOL}, {TRUTH_REG_CORNER_TOL})")
    lin_p = float(np.abs(got[:3, :3] - plain[:3, :3]).max())
    shift_p = float(np.abs(got[:3, 3] - plain[:3, 3]).max())
    require(lin_p <= PLAIN_LINEAR_TOL and shift_p <= PLAIN_SHIFT_TOL,
            f"optimize-registration: {lin_p:.3g} and {shift_p:.3g} voxels from the plain route "
            f"(tol {PLAIN_LINEAR_TOL}, {PLAIN_SHIFT_TOL})")
    for lv in kernel_levels:
        n = lv["steps"]
        want = {"resample_pass": 7 * n, "resample_pass_deriv": 7 * n,
                "resample_pass_adjoint": 6 * n}
        require(lv["launches"] == want, f"level {lv['shape']}: launches {lv['launches']}, "
                f"want {want}")
    for name in ("resample_pass_deriv", "resample_pass_adjoint"):
        records[name]["runs"] = launches
    print(f"optimize-registration (crop): from the truth {lin_err:.3g} (linear part), "
          f"{centre_err:.3g} voxels at the centre ({column_err:.3g} in the translation column, "
          f"{corner_err:.3g} at the worst corner); {lin_p:.3g} and {shift_p:.3g} from the plain "
          f"route; "
          f"{call_ms:.1f} ms for the call (host clock, one run); launches {launches}")
    for lv in kernel_levels:
        print(f"  level {lv['shape']}: {lv['steps']} steps, {lv['ms']:.1f} ms, "
              f"{lv['ms'] / lv['steps']:.3f} ms/step; launches {lv['launches']}")
    del ref, mov

    # bench.py's optimizer shape: Adam steps through the traced warp.
    bref = gaussian_noise(BENCH_REG_SHAPE, REG_SIGMA, gen)
    bmov = torch.roll(bref, (1, 2, -2), (0, 1, 2))
    center = (torch.tensor(BENCH_REG_SHAPE, dtype=torch.float32, device=dev) - 1) / 2
    zeros = torch.zeros(7, device=dev)
    bench_ms = host_ms(lambda: ti._optimize_level(bmov, bref, zeros, center, BENCH_REG_STEPS,
                                                  BENCH_REG_SHAPE), reps=1)
    _, frame_shape, _ = traced_frame(BENCH_REG_SHAPE, BENCH_REG_SHAPE, REG_MARGIN)
    print(f"Adam steps at bench.py's {BENCH_REG_SHAPE} (frame {frame_shape}): "
          f"{bench_ms / BENCH_REG_STEPS:.3f} ms/step ({BENCH_REG_STEPS} steps, host clock)")
    del bref, bmov
    torch.cuda.empty_cache()


@contextlib.contextmanager
def plain_fft_kernels():
    """Kernels A, Bc, C and Bx replaced by their plain PyTorch versions on
    the card (in ``kernels.fft``, which the reconstruction calls, and in
    ``kernels.pcc``, which imports them by name); nothing is counted."""
    from biahub_tpu_torch.kernels import fft as kfft
    from biahub_tpu_torch.kernels import pcc as kpcc

    plain = {"fwd_yx": kfft.fwd_yx_plain, "inv_yx": kfft.inv_yx_plain,
             "z_filter_complex_": kfft.z_filter_complex_plain_,
             "z_cross_": kfft.z_cross_plain_}
    saved = [(mod, name, getattr(mod, name)) for mod in (kfft, kpcc) for name in plain
             if hasattr(mod, name)]
    for mod, name, _ in saved:
        setattr(mod, name, plain[name])
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def smooth_rand(shape, gen: torch.Generator, width: int = 9) -> torch.Tensor:
    """Uniform noise in [0, 1) averaged over a box of ``width`` voxels."""
    return torch.nn.functional.avg_pool3d(
        torch.rand(shape, generator=gen, device=gen.device)[None, None], width, 1,
        width // 2, count_include_pad=False)[0, 0]


def any_length_phase(dev: torch.device, records: dict) -> None:
    """Phase 13: A, B, Bc and C against their plain versions at the deskewed
    FOV and at prime and odd lengths; Bx at custom_padding's shape; one
    custom_padding PCC on the card; each kernel's time at those shapes."""
    from scipy.fft import next_fast_len

    from biahub_tpu_torch import stabilization_settings_from_reference
    from biahub_tpu_torch.kernels import fft as kfft
    from biahub_tpu_torch.kernels import pcc as kpcc

    gen = torch.Generator(device=dev).manual_seed(13)
    # The deskewed FOV last: its tensors stay for the timings below.
    for shape in ODD_SHAPES + RADIX_SHAPES + (LAPSE_SHAPE,):
        half = kfft.half_spectrum_shape(shape)
        vol = torch.rand(shape, generator=gen, device=dev)
        spec = kfft.fwd_yx(vol)
        err = {"A": rel_err(spec, kfft.fwd_yx_plain(vol))}
        u16 = torch.randint(0, 65536, shape, generator=gen, device=dev, dtype=torch.int32)
        spec16 = kfft.fwd_yx(u16.to(torch.uint16))
        require(torch.equal(torch.view_as_real(spec16).view(torch.int32),
                            torch.view_as_real(kfft.fwd_yx(u16.float())).view(torch.int32)),
                f"kernel A at {shape}: uint16 input differs from its float32 copy")
        filt = torch.rand(half, generator=gen, device=dev)
        filt_c = torch.complex(torch.randn(half, generator=gen, device=dev),
                               torch.randn(half, generator=gen, device=dev))
        err["B"] = rel_err(kfft.z_filter_(spec.clone(), filt),
                           kfft.z_filter_plain_(spec.clone(), filt))
        spec_c = kfft.z_filter_complex_(spec.clone(), filt_c)
        err["Bc"] = rel_err(spec_c, kfft.z_filter_complex_plain_(spec.clone(), filt_c))
        err["C"] = rel_err(kfft.inv_yx(spec_c.clone(), out=torch.empty_like(vol)),
                           kfft.inv_yx_plain(spec_c.clone(), out=torch.empty_like(vol)))
        for name, (_, e) in err.items():
            require(e <= FFT_TOL, f"kernel {name} at {shape}: rel err {e:.3g} > {FFT_TOL}")
        print(f"any length {shape}: rel err " + ", ".join(f"{n} {e:.3g}" for n, (_, e) in
                                                         err.items())
              + f" (tol {FFT_TOL}); A's uint16 input bit-exact vs its float32 copy")

    # The kernels' times at the deskewed FOV, the reconstruction's shape.
    z, y, x = LAPSE_SHAPE
    xh = x // 2 + 1
    nvox, spec_bytes = z * y * x, z * y * xh * 8
    fft_flops = z * y * 2.5 * x * math.log2(x) + z * xh * 5 * y * math.log2(y)
    z_flops = 2 * y * xh * 5 * z * math.log2(z)
    work, decon = torch.empty_like(spec), torch.empty_like(vol)
    bms, bby = bound(nvox * 4 + spec_bytes, fft_flops)
    records["fwd_yx_recon"] = dict(
        replaces="biahub_tpu/kernels/pallas_fft.py:286", source="biahub_tpu_torch/csrc/fft.cu",
        counter="fwd_yx", max_abs_err=err["A"][0],
        ms=time_ms(lambda: kfft.fwd_yx(vol, out=work)),
        plain_ms=time_ms(lambda: kfft.fwd_yx_plain(vol)), bound_ms=bms, bound_by=bby,
        library_ms=time_ms(lambda: torch.fft.rfft2(vol)))
    bms_c, bby_c = bound(3 * spec_bytes, z_flops + 6 * z * y * xh)
    records["z_filter_complex"] = dict(
        replaces="biahub_tpu/kernels/pallas_fft.py:442", source="biahub_tpu_torch/csrc/fft.cu",
        max_abs_err=err["Bc"][0],
        ms=time_ms(lambda: kfft.z_filter_complex_(work, filt_c),
                   setup=lambda: work.copy_(spec)),
        plain_ms=time_ms(lambda: kfft.z_filter_complex_plain_(work, filt_c),
                         setup=lambda: work.copy_(spec)),
        bound_ms=bms_c, bound_by=bby_c, library_ms=None)
    records["inv_yx_recon"] = dict(
        replaces="biahub_tpu/kernels/pallas_fft.py:530", source="biahub_tpu_torch/csrc/fft.cu",
        counter="inv_yx", max_abs_err=err["C"][0],
        ms=time_ms(lambda: kfft.inv_yx(work, out=decon), setup=lambda: work.copy_(spec_c)),
        plain_ms=time_ms(lambda: kfft.inv_yx_plain(work, out=decon),
                         setup=lambda: work.copy_(spec_c)),
        bound_ms=bms, bound_by=bby,
        library_ms=time_ms(lambda: torch.fft.irfft2(spec_c, s=(y, x))))
    b_ms = time_ms(lambda: kfft.z_filter_(work, filt), setup=lambda: work.copy_(spec))
    b_plain = time_ms(lambda: kfft.z_filter_plain_(work, filt), setup=lambda: work.copy_(spec))
    b_bound, _ = bound(2 * spec_bytes + z * y * xh * 4, z_flops + 2 * z * y * xh)
    print(f"A fwd_yx at {LAPSE_SHAPE}: " + describe(records["fwd_yx_recon"]))
    print(f"Bc z_filter_complex at {LAPSE_SHAPE}: " + describe(records["z_filter_complex"])
          + "; no single PyTorch call computes it (fft, mul, ifft: three)")
    print(f"C inv_yx at {LAPSE_SHAPE}: " + describe(records["inv_yx_recon"]))
    print(f"B z_filter at {LAPSE_SHAPE}: ms {b_ms:.4f}, plain_ms {b_plain:.4f}, "
          f"bound_ms {b_bound:.4f}")
    del vol, spec, spec16, spec_c, work, decon, filt, filt_c, u16

    # Bx at custom_padding's shape, and one custom_padding PCC.
    lapse, drift, _, _ = pcc_timelapse(dev)
    crop = pcc_crop(lapse)
    del lapse
    shift = stabilization_settings_from_reference(
        PCC_SETTINGS)["phase_cross_corr_settings"]["maximum_shift"]
    pad_shape = tuple(int(next_fast_len(int(n * shift))) for n in crop.shape[1:])
    require(pad_shape == SLICE_SHAPES["custom_padding"]
            and tuple(crop.shape[1:]) == SLICE_SHAPES["PCC crop"],
            f"PCC crop {tuple(crop.shape[1:])}, custom_padding {pad_shape}: SLICE_SHAPES "
            "is out of date")
    ref_spec = kfft.fwd_yx(kpcc.match_shape(crop[0], pad_shape).contiguous())
    mov_spec = kfft.fwd_yx(kpcc.match_shape(crop[1], pad_shape).contiguous())
    out = torch.empty_like(mov_spec)
    worst = 0.0
    for norm in NORMS:
        kfft.z_cross_(ref_spec, mov_spec, out, norm)
        want = kfft.z_cross_plain_(ref_spec.to(torch.complex128), mov_spec.to(torch.complex128),
                                   torch.empty_like(mov_spec), norm)
        err_abs, err_bx = rel_err(out, want)
        require(err_bx <= FFT_TOL, f"kernel Bx ({norm}) at {pad_shape}: rel err {err_bx:.3g}")
        worst = max(worst, err_abs)
        print(f"Bx z_cross ({norm}) at custom_padding's {pad_shape}: rel err {err_bx:.3g} "
              f"(tol {FFT_TOL}) vs the plain version in float64")
    pz, py, px = pad_shape
    pspec = pz * py * (px // 2 + 1) * 8
    bms, bby = bound(3 * pspec, 3 * py * (px // 2 + 1) * 5 * pz * math.log2(pz)
                     + 20 * pz * py * (px // 2 + 1))
    records["z_cross_padding"] = dict(
        replaces="biahub_tpu/kernels/pallas_fft.py:1338", source="biahub_tpu_torch/csrc/fft.cu",
        counter="z_cross", max_abs_err=worst,
        ms=time_ms(lambda: kfft.z_cross_(ref_spec, mov_spec, out, "magnitude")),
        plain_ms=time_ms(lambda: kfft.z_cross_plain_(ref_spec, mov_spec, out, "magnitude")),
        bound_ms=bms, bound_by=bby, library_ms=None)
    print(f"Bx z_cross (magnitude) at {pad_shape}: " + describe(records["z_cross_padding"]))
    del ref_spec, mov_spec, out, want

    t = 1
    (peak, _), launches = counted(lambda: kpcc.phase_cross_corr_padding(
        crop[0], crop[t], shift, "magnitude", device=dev))
    with plain_fft_kernels():
        plain_peak, _ = kpcc.phase_cross_corr_padding(crop[0], crop[t], shift, "magnitude",
                                                       device=dev)
    require(np.array_equal(peak, drift[t]), f"custom_padding PCC: peak {peak.tolist()}, "
            f"drift {drift[t].tolist()}")
    require(np.array_equal(peak, plain_peak), "custom_padding PCC differs from the plain route")
    want_l = {"fwd_yx": 2, "z_cross": 1, "inv_yx": 1}
    require(launches == want_l, f"custom_padding PCC launches {launches}, want {want_l}")
    pcc_ms = host_ms(lambda: kpcc.phase_cross_corr_padding(crop[0], crop[t], shift,
                                                           "magnitude", device=dev))
    records["z_cross_padding"]["runs"] = launches
    print(f"custom_padding PCC of timepoints 0 and {t} at {pad_shape}: peak {peak.tolist()} = "
          f"the drift, equal to the plain route; {pcc_ms:.3f} ms (host clock); "
          f"launches {launches}")
    del crop
    torch.cuda.empty_cache()


def ptxas_lines(names, source: str = "fft") -> list[str]:
    """ptxas' registers, stack frame and spills of the ``csrc/<source>.cu``
    kernels whose mangled names contain one of ``names``, from the build's
    log."""
    from biahub_tpu_torch.kernels import _build

    log = _build.build_log(source).splitlines()
    out = []
    for i, line in enumerate(log):
        for name in names:
            if "Compiling entry function" in line and name in line:
                props = [part.replace("ptxas info    :", "").strip() for part in log[i + 1:i + 4]
                         if "stack frame" in part or "Used" in part]
                mangled = line.split("'")[1] if "'" in line else name
                out.append(f"{mangled}: " + "; ".join(props))
    return out


def launch_planned(entry: str, plan, src: torch.Tensor, out: torch.Tensor, shape) -> None:
    """Kernel A's or C's C entry with ``plan`` in place of the card's (the
    cluster sweep); counts no launch."""
    from biahub_tpu_torch.kernels import _build
    from biahub_tpu_torch.kernels import fft as kfft

    lib = kfft._lib()
    head = (_build.ptr(src), int(src.dtype == torch.uint16)) if entry == "fwd_yx" else (
        _build.ptr(src),)
    rc = getattr(lib, entry)(*head, _build.ptr(out), *plan.args(), *shape,
                             _build.stream_of(src))
    _build.check(rc, lib, f"{entry} ({plan.describe()})")


def slice_phase(dev: torch.device, records: dict) -> None:
    """Phase 13b: kernels A and C at every shape a path gives them
    (SLICE_SHAPES): ptxas' figures, each shape's plan, the error against
    the plain version, the time beside the plain version and rfft2 /
    irfft2, and the cluster sweep; adds the records of A and C at the PCC
    crop and at custom_padding's shape."""
    from biahub_tpu_torch.kernels import fft as kfft

    for line in ptxas_lines(("fwd_yx_kernel", "inv_yx_kernel")):
        print(f"ptxas {line}")
    gen = torch.Generator(device=dev).manual_seed(18)
    runs = {"PCC crop": records["z_cross"]["runs"],
            "custom_padding": records["z_cross_padding"]["runs"]}
    for name, shape in SLICE_SHAPES.items():
        z, y, x = shape
        xh = x // 2 + 1
        plan = kfft.slice_plan(shape)
        vol = torch.rand(shape, generator=gen, device=dev)
        spec = kfft.fwd_yx(vol)
        err_a = rel_err(spec, kfft.fwd_yx_plain(vol))
        work, dec = torch.empty_like(spec), torch.empty_like(vol)
        out_c = kfft.inv_yx(spec.clone(), out=torch.empty_like(vol))
        err_c = rel_err(out_c, kfft.inv_yx_plain(spec.clone(), out=torch.empty_like(vol)))
        for kernel, (_, e) in (("A", err_a), ("C", err_c)):
            require(e <= FFT_TOL, f"kernel {kernel} at {shape}: rel err {e:.3g} > {FFT_TOL}")
        bms, bby = bound(z * y * x * 4 + z * y * xh * 8,
                         z * y * 2.5 * x * math.log2(x) + z * xh * 5 * y * math.log2(y))
        rec = {}
        for kernel, entry, err, run, plain_run, lib_run, setup in (
                ("A", "fwd_yx", err_a, lambda: kfft.fwd_yx(vol, out=work),
                 lambda: kfft.fwd_yx_plain(vol), lambda: torch.fft.rfft2(vol), None),
                ("C", "inv_yx", err_c, lambda: kfft.inv_yx(work, out=dec),
                 lambda: kfft.inv_yx_plain(work, out=dec),
                 lambda: torch.fft.irfft2(spec, s=(y, x)), lambda: work.copy_(spec))):
            rec[kernel] = dict(
                replaces="biahub_tpu/kernels/pallas_fft.py:" + ("286" if kernel == "A" else "530"),
                source="biahub_tpu_torch/csrc/fft.cu", counter=entry, max_abs_err=err[0],
                ms=time_ms(run, setup), plain_ms=time_ms(plain_run, setup),
                bound_ms=bms, bound_by=bby, library_ms=time_ms(lib_run))
            if name in runs:
                records[f"{entry}_{name.replace(' ', '_').lower()}"] = dict(
                    rec[kernel], runs=runs[name])
        print(f"A and C at the {name} shape {shape}: plan {plan.describe()}; rel err A "
              f"{err_a[1]:.3g}, C {err_c[1]:.3g} (tol {FFT_TOL}); A " + describe(rec["A"])
              + " (library: rfft2); C " + describe(rec["C"]) + " (library: irfft2)")
        sweep = []
        for c in CLUSTER_SWEEP:
            p = dataclasses.replace(plan, cluster=c, grid=z * c)
            got_a, got_c = torch.empty_like(spec), torch.empty_like(vol)
            launch_planned("fwd_yx", p, vol, got_a, shape)
            launch_planned("inv_yx", p, spec.clone(), got_c, shape)
            require(torch.equal(torch.view_as_real(got_a), torch.view_as_real(spec))
                    and torch.equal(got_c, out_c), f"A or C at {shape}: cluster {c} is not "
                    f"bit-equal to cluster {plan.cluster}")
            a_ms = time_ms(lambda: launch_planned("fwd_yx", p, vol, work, shape))
            c_ms = time_ms(lambda: launch_planned("inv_yx", p, work, dec, shape),
                           lambda: work.copy_(spec))
            sweep.append(f"{c}: A {a_ms:.4f}, C {c_ms:.4f}")
        print(f"  cluster sweep at {shape} (ms; the plan takes {plan.cluster}, every size "
              "bit-equal): " + "; ".join(sweep))
        del vol, spec, work, dec, out_c
    torch.cuda.empty_cache()


def tf_float64(shape, settings: dict) -> dict:
    """The phase WOTF and fluorescence OTF of ``settings`` in float64 numpy
    (scipy's FFTs on every core): the port's formulas without float32."""
    from scipy import fft as sfft

    workers = os.cpu_count()

    def grids(wavelength, n_media, yx_px, z_px):
        fy, fx = np.fft.fftfreq(shape[1], d=yx_px), np.fft.fftfreq(shape[2], d=yx_px)
        f2 = fy[:, None] ** 2 + fx[None, :] ** 2
        kz = np.sqrt(np.maximum((n_media / wavelength) ** 2 - f2, 0.0))
        z = np.fft.fftfreq(shape[0]) * shape[0] * z_px
        theta = (2 * np.pi * z)[:, None, None] * kz[None]
        defocus = np.empty(theta.shape, np.complex128)  # exp(i theta), as cos and sin
        np.cos(theta, out=defocus.real)
        np.sin(theta, out=defocus.imag)
        return np.sqrt(f2), defocus

    out = {}
    if settings.get("phase") is not None:
        tf = settings["phase"]["transfer_function"]
        fr, defocus = grids(tf["wavelength_illumination"], tf["index_of_refraction_media"],
                            tf["yx_pixel_size"], tf["z_pixel_size"])
        p = (fr <= tf["numerical_aperture_detection"] / tf["wavelength_illumination"]) * 1.0
        src = (fr <= tf["numerical_aperture_illumination"] / tf["wavelength_illumination"]) * 1.0
        fa = sfft.fft2((src * p) * defocus, workers=workers, overwrite_x=True)
        defocus *= p
        fb = sfft.fft2(defocus, workers=workers, overwrite_x=True)
        del defocus
        np.conj(fa, out=fa)
        fa *= fb
        del fb
        corr = sfft.ifft2(fa, workers=workers, overwrite_x=True) / np.sum(src * p * p)
        del fa
        out["phase"] = -sfft.fft(2.0 * corr.imag, axis=0, workers=workers) / shape[0]
    if settings.get("fluorescence") is not None:
        tf = settings["fluorescence"]["transfer_function"]
        wl = tf.get("wavelength_emission", 0.507)
        fr, defocus = grids(wl, tf.get("index_of_refraction_media", 1.3), tf["yx_pixel_size"],
                            tf["z_pixel_size"])
        p = (fr <= tf.get("numerical_aperture_detection", 1.2) / wl) * 1.0
        defocus *= p
        psf = np.abs(sfft.ifft2(defocus, workers=workers, overwrite_x=True)) ** 2
        del defocus
        otf = sfft.fftn(psf, workers=workers)
        out["fluorescence"] = otf / otf[0, 0, 0]
    return out


def compute_tf_phase(dev: torch.device) -> dict:
    """Phase 14: compute-tf for phase and fluorescence at the deskewed FOV,
    against the same formulas in float64; returns the port's transfer
    functions."""
    from biahub_tpu_torch import compute_transfer_function_arrays

    both = dict(RECON_SETTINGS, fluorescence=BF_SETTINGS["fluorescence"])
    tfs, launches = counted(lambda: compute_transfer_function_arrays(LAPSE_SHAPE, both,
                                                                     device=dev))
    require(launches == {}, f"compute-tf launched kernels: {launches}")
    t0 = time.perf_counter()
    ref = tf_float64(LAPSE_SHAPE, both)
    host64 = time.perf_counter() - t0
    for name, tf in tfs.items():
        require(tf.shape == LAPSE_SHAPE and tf.dtype == torch.complex64
                and bool(torch.isfinite(torch.view_as_real(tf)).all()),
                f"compute-tf {name}: {tuple(tf.shape)} {tf.dtype}")
        got = tf.cpu().numpy()
        err = float(np.abs(got - ref[name]).max() / np.abs(ref[name]).max())
        require(err <= TF_TOL, f"compute-tf {name}: rel err {err:.3g} vs float64 > {TF_TOL}")
        print(f"compute-tf {name} at {LAPSE_SHAPE}: rel err {err:.3g} vs float64 numpy "
              f"(tol {TF_TOL})")
    del ref
    tf_ms = host_ms(lambda: compute_transfer_function_arrays(LAPSE_SHAPE, both, device=dev))
    print(f"compute-tf (phase and fluorescence) at {LAPSE_SHAPE}: {tf_ms:.3f} ms (host clock); "
          f"float64 reference {host64:.1f} s on the host")
    return tfs


def render_polarization(dev: torch.device, h: torch.Tensor, gen: torch.Generator):
    """T_RECON timepoints of 5 polarization states (T, 5, Z, Y, X) in uint16
    counts: smooth retardance and orientation maps through the default
    swing's instrument matrix, times 1 + I_norm, the WOTF forward model
    ``real(ifftn(H * fftn(phi)))`` of a weak smooth phase object phi.
    Returns the stack and the truth (retardance rad, orientation, BF)."""
    from biahub_tpu_torch.recon.birefringence import instrument_matrix

    a = torch.from_numpy(instrument_matrix(5, 0.1)).to(dev)
    stack = torch.empty((T_RECON, 5) + LAPSE_SHAPE, dtype=torch.uint16, device=dev)
    truth = []
    lo, hi = RETARDANCE_RANGE
    for t in range(T_RECON):
        ret = lo + (hi - lo) * smooth_rand(LAPSE_SHAPE, gen)
        theta = math.pi * smooth_rand(LAPSE_SHAPE, gen)
        phi = PHASE_AMPLITUDE * (smooth_rand(LAPSE_SHAPE, gen, 5) - 0.5)
        bf = RECON_COUNTS * (1.0 + torch.fft.ifftn(h * torch.fft.fftn(phi)).real)
        stokes = torch.stack([bf, bf * torch.sin(ret) * torch.sin(2 * theta),
                              bf * torch.sin(ret) * torch.cos(2 * theta), bf * torch.cos(ret)])
        states = torch.einsum("sk,k...->s...", a, stokes)
        require(float(states.max()) < 65535 and float(states.min()) > 0,
                "rendered polarization states leave the uint16 range")
        stack[t] = torch.round(states).to(torch.uint16)
        truth.append((ret, theta, bf))
    return stack, truth


def reconstruction_phase(dev: torch.device, records: dict, tfs: dict) -> None:
    """Phase 15: apply-inv-tf and reconstruct on a rendered polarization
    timelapse (birefringence and phase), then phase and fluorescence on one
    rendered brightfield channel."""
    from biahub_tpu_torch import apply_inverse_transfer_function_arrays, reconstruct_arrays
    from biahub_tpu_torch.kernels import fft as kfft

    gen = torch.Generator(device=dev).manual_seed(15)
    stack, truth = render_polarization(dev, tfs["phase"], gen)
    stack_f = stack.to(torch.float32)
    print(f"polarization timelapse: {T_RECON} x 5 states x {LAPSE_SHAPE}, uint16 counts "
          f"<= {int(stack_f.max())}")

    def run(data):
        return reconstruct_arrays(data, RECON_CHANNELS, RECON_SETTINGS, device=dev)

    out, launches = counted(lambda: run(stack))
    want_l = {"fwd_yx": T_RECON, "z_filter_complex": T_RECON, "inv_yx": T_RECON}
    require(launches == want_l, f"reconstruct launches {launches}, want {want_l} (A, Bc, C "
            "once per phase volume, no Tikhonov B)")
    require(out.shape == (T_RECON, 5) + LAPSE_SHAPE and bool(torch.isfinite(out).all()),
            f"reconstruct output {tuple(out.shape)} is not finite of the expected shape")
    require(torch.equal(run(stack_f).view(torch.int32), out.view(torch.int32)),
            "reconstruct: uint16 input differs from its float32 copy")
    with plain_fft_kernels():
        plain = run(stack_f)
    names = ["Retardance", "Orientation", "BF", "Pol", "Phase3D"]
    errs = {n: rel_err(out[:, c], plain[:, c])[1] for c, n in enumerate(names)}
    for n, e in errs.items():
        require(e <= FFT_TOL, f"reconstruct {n}: rel err {e:.3g} vs the plain route > {FFT_TOL}")
    del plain

    worst_ret = worst_theta = worst_bf = worst_pol = 0.0
    for t, (ret, theta, bf) in enumerate(truth):
        worst_ret = max(worst_ret, float((out[t, 0] * 2 * math.pi / 0.532 - ret).abs().max()))
        d = torch.remainder(out[t, 1] - theta, math.pi)
        worst_theta = max(worst_theta, float(torch.minimum(d, math.pi - d).max()))
        worst_bf = max(worst_bf, float(((out[t, 2] - bf) / RECON_COUNTS).abs().max()))
        worst_pol = max(worst_pol, float((out[t, 3] - 1.0).abs().max()))
    require(max(worst_ret, worst_theta, worst_bf, worst_pol) <= BIREF_TOL,
            f"birefringence from the truth: retardance {worst_ret:.3g} rad, orientation "
            f"{worst_theta:.3g}, BF {worst_bf:.3g} of the counts, Pol {worst_pol:.3g} "
            f"(tol {BIREF_TOL})")

    # The phase of timepoint 0 against the exact Tikhonov solution in float64.
    from scipy import fft as sfft

    bf64 = stack_f[0, 0].cpu().numpy().astype(np.float64)
    i_norm = bf64 / bf64.mean() - 1.0
    h = tfs["phase"].cpu().numpy().astype(np.complex128)[..., : LAPSE_SHAPE[2] // 2 + 1]
    reg = RECON_SETTINGS["phase"]["apply_inverse"]["regularization_strength"]
    workers = os.cpu_count()
    exact = sfft.irfftn(sfft.rfftn(i_norm, workers=workers) * np.conj(h)
                        / (np.abs(h) ** 2 + reg), s=LAPSE_SHAPE, workers=workers)
    phase64 = float(np.abs(out[0, 4].cpu().numpy() - exact).max() / np.abs(exact).max())
    require(phase64 <= PHASE64_TOL, f"phase: rel err {phase64:.3g} vs float64 > {PHASE64_TOL}")
    del bf64, i_norm, exact

    call_ms = host_ms(lambda: run(stack), reps=2)
    apply_ms = host_ms(lambda: apply_inverse_transfer_function_arrays(
        stack, RECON_CHANNELS, tfs, RECON_SETTINGS, device=dev), reps=2)
    print(f"reconstruct (birefringence + phase, {T_RECON} timepoints): rel err vs the plain "
          "route " + ", ".join(f"{n} {e:.3g}" for n, e in errs.items())
          + f" (tol {FFT_TOL}); uint16 input bit-exact vs its float32 copy; from the truth "
          f"retardance {worst_ret:.3g} rad, orientation {worst_theta:.3g}, BF {worst_bf:.3g} "
          f"of the counts, Pol {worst_pol:.3g}; phase {phase64:.3g} from float64 (tol "
          f"{PHASE64_TOL}); launches {launches}")
    print(f"reconstruct: {call_ms:.3f} ms for the call (host clock), {call_ms / T_RECON:.3f} "
          f"ms per timepoint and per phase volume; apply-inv-tf alone {apply_ms:.3f} ms, "
          f"{apply_ms / T_RECON:.3f} per timepoint")
    for name in ("fwd_yx_recon", "z_filter_complex", "inv_yx_recon"):
        records[name]["runs"] = launches
    del out, stack, stack_f, truth

    # Phase and fluorescence on one brightfield channel: the phase object
    # alone through the WOTF forward model, in float32 counts so that the
    # check below sees the model and not the camera's rounding.
    h = tfs["phase"]
    phis = [PHASE_AMPLITUDE * (smooth_rand(LAPSE_SHAPE, gen, 5) - 0.5) for _ in range(T_RECON)]
    bf = torch.stack([RECON_COUNTS * (1.0 + torch.fft.ifftn(h * torch.fft.fftn(phi)).real)
                      for phi in phis])[:, None]

    def run_bf():
        return reconstruct_arrays(bf, ["BF"], BF_SETTINGS, device=dev)

    out_b, launches_b = counted(run_bf)
    want_b = {name: 2 * T_RECON for name in want_l}
    require(launches_b == want_b, f"brightfield launches {launches_b}, want {want_b}")
    require(out_b.shape == (T_RECON, 2) + LAPSE_SHAPE and bool(torch.isfinite(out_b).all()),
            f"brightfield output {tuple(out_b.shape)}")
    with plain_fft_kernels():
        plain = run_bf()
    errs_b = {n: rel_err(out_b[:, c], plain[:, c])[1]
              for c, n in enumerate(("Phase3D", "BF_decon"))}
    for n, e in errs_b.items():
        require(e <= FFT_TOL, f"brightfield {n}: rel err {e:.3g} vs the plain route > {FFT_TOL}")
    # Both routes' deconvolution of timepoint 0 against float64: the channel's
    # large mean puts float32 rounding into every bin, which the filter's
    # gain of up to 1 / (2 sqrt(reg)) then raises.
    reg_f = BF_SETTINGS["fluorescence"]["apply_inverse"]["regularization_strength"]
    filt64 = kfft.prepare_hermitian_filter(LAPSE_SHAPE, tfs["fluorescence"], reg_f, dev)
    decon64 = torch.fft.irfftn(torch.fft.rfftn(bf[0, 0].double()) * filt64.to(torch.complex128),
                               s=LAPSE_SHAPE)
    decon_errs = [rel_err(x[0, 1].double(), decon64)[1] for x in (out_b, plain)]
    del plain, filt64, decon64
    # The phase object through the Tikhonov passband, in float64.
    h_half = h[..., : LAPSE_SHAPE[2] // 2 + 1].to(torch.complex128)
    passband = h_half.abs() ** 2 / (h_half.abs() ** 2 + reg)
    del h_half
    worst_obj = 0.0
    for t, phi in enumerate(phis):
        band = torch.fft.irfftn(torch.fft.rfftn(phi.double()) * passband, s=LAPSE_SHAPE)
        worst_obj = max(worst_obj, rel_err(out_b[t, 0].double(), band)[1])
    require(worst_obj <= PHASE_OBJECT_TOL, f"phase: rel err {worst_obj:.3g} from the phase "
            f"object through the passband > {PHASE_OBJECT_TOL}")
    del passband, band, phis
    b_ms = host_ms(run_bf, reps=2)
    print(f"reconstruct (phase + fluorescence on 1 brightfield channel, {T_RECON} timepoints): "
          "rel err vs the plain route " + ", ".join(f"{n} {e:.3g}" for n, e in errs_b.items())
          + f" (tol {FFT_TOL}); BF_decon of timepoint 0 from float64: {decon_errs[0]:.3g} "
          f"(kernels), {decon_errs[1]:.3g} (plain); phase {worst_obj:.3g} from the phase object "
          f"through the Tikhonov passband (tol {PHASE_OBJECT_TOL}); {b_ms:.3f} ms, "
          f"{b_ms / (2 * T_RECON):.3f} per volume; launches {launches_b}")
    del bf, out_b
    torch.cuda.empty_cache()


def spectral_phase(dev: torch.device, records: dict, tf_half: np.ndarray) -> None:
    """Phase 16: kernels K, L and M against their plain versions (the
    headline avg 3 and avg 1 with the overhang kept, and SPECTRAL_CASES'
    smaller shapes), then
    the headline step and the full chain through the spectral engine
    against their composition routes, with launches, times and bounds."""
    from biahub_tpu_torch import DeconvolveDeskew, DeconvolveDeskewWarp
    from biahub_tpu_torch.kernels import fft as kfft
    from biahub_tpu_torch.kernels import spectral as kspec
    from biahub_tpu_torch.kernels import spectral_cuda as kspc
    from biahub_tpu_torch.kernels.deskew import deskew_geometry

    gen = torch.Generator(device=dev).manual_seed(16)
    # The headline avg 3 last: its tensors stay for the timings below.
    for shape, avg, keep in SPECTRAL_CASES:
        vol = torch.rand(shape, generator=gen, device=dev)
        half = kfft.half_spectrum_shape(shape)
        spec = kfft.fwd_yx(vol)
        filt = torch.rand(half, generator=gen, device=dev)
        filt_c = torch.complex(torch.randn(half, generator=gen, device=dev),
                               torch.randn(half, generator=gen, device=dev))
        err = {"K": rel_err(kfft.z_fwd_filter_(spec.clone(), filt),
                            kfft.z_fwd_filter_plain_(spec.clone(), filt)),
               "K complex": rel_err(kfft.z_fwd_filter_(spec.clone(), filt_c),
                                    kfft.z_fwd_filter_plain_(spec.clone(), filt_c))}
        spec_k = kfft.z_fwd_filter_(spec.clone(), filt)
        spec_l = kfft.y_inv_(spec_k.clone())
        err["L"] = rel_err(spec_l, kfft.y_inv_plain_(spec_k.clone()))
        table = kspec.prepare_spectral_deskew(shape, ANGLE, RATIO, keep, avg, dev)
        m_zyx = kspc.lerp_irfft(spec_l, table, shape[2], avg)
        err["M"] = rel_err(m_zyx, kspc.lerp_irfft_plain(spec_l, table, shape[2], avg))
        m_xzy = kspc.lerp_irfft(spec_l, table, shape[2], avg, "xzy")
        err["M xzy"] = rel_err(m_xzy, kspc.lerp_irfft_plain(spec_l, table, shape[2], avg,
                                                             "xzy"))
        require(torch.equal(m_xzy, m_zyx.permute(2, 0, 1)),
                f"kernel M at {shape} avg {avg}: the xzy store is not the zyx store transposed")
        for name, (_, e) in err.items():
            tol = SPECTRAL_TOL if name.startswith("M") else FFT_TOL
            require(e <= tol, f"kernel {name} at {shape} avg {avg} keep_overhang {keep}: "
                    f"rel err {e:.3g} > {tol}")
        print(f"spectral {shape} avg {avg} keep_overhang {keep}: rel err "
              + ", ".join(f"{n} {e:.3g}" for n, (_, e) in err.items())
              + f" (tol {FFT_TOL} K, L; {SPECTRAL_TOL} M); M's xzy store equal to its zyx "
              "store transposed")

    z, y, x = SHAPE
    xh = x // 2 + 1
    spec_bytes = z * y * xh * 8
    rows, x_out, _ = table.shape
    groups = rows // AVG
    work = torch.empty_like(spec)
    bms, bby = bound(2 * spec_bytes + z * y * xh * 4,
                     y * xh * 5 * z * math.log2(z) + 2 * z * y * xh)
    records["z_fwd_filter"] = dict(
        replaces="biahub_tpu/kernels/pallas_spectral.py:198",
        source="biahub_tpu_torch/csrc/fft.cu", max_abs_err=err["K"][0],
        ms=time_ms(lambda: kfft.z_fwd_filter_(work, filt), setup=lambda: work.copy_(spec)),
        plain_ms=time_ms(lambda: kfft.z_fwd_filter_plain_(work, filt),
                         setup=lambda: work.copy_(spec)),
        bound_ms=bms, bound_by=bby, library_ms=None)
    k_complex_ms = time_ms(lambda: kfft.z_fwd_filter_(work, filt_c),
                           setup=lambda: work.copy_(spec))
    bms, bby = bound(2 * spec_bytes, z * xh * 5 * y * math.log2(y))
    records["y_inv"] = dict(
        replaces="biahub_tpu/kernels/pallas_spectral.py:249",
        source="biahub_tpu_torch/csrc/fft.cu", max_abs_err=err["L"][0],
        ms=time_ms(lambda: kfft.y_inv_(work), setup=lambda: work.copy_(spec_k)),
        plain_ms=time_ms(lambda: kfft.y_inv_plain_(work), setup=lambda: work.copy_(spec_k)),
        bound_ms=bms, bound_by=bby, library_ms=time_ms(lambda: torch.fft.ifft(spec_k, dim=1)))
    # M's work: the contraction's complex multiply-adds (8 flop each) over
    # every table row, and the irfft of each output column.
    m_flops = 8 * rows * xh * x_out * z + groups * x_out * 2.5 * x * math.log2(x)
    bms, bby = bound(spec_bytes + table.numel() * 8 + groups * x * x_out * 4, m_flops)
    for name, layout, replaces in (("lerp_irfft", "zyx", 327), ("lerp_irfft_xzy", "xzy", 434)):
        records[name] = dict(
            replaces=f"biahub_tpu/kernels/pallas_spectral.py:{replaces}",
            source="biahub_tpu_torch/csrc/spectral.cu", counter="lerp_irfft",
            max_abs_err=err["M" if layout == "zyx" else "M xzy"][0],
            ms=time_ms(lambda: kspc.lerp_irfft(spec_l, table, x, AVG, layout)),
            plain_ms=time_ms(lambda: kspc.lerp_irfft_plain(spec_l, table, x, AVG, layout)),
            bound_ms=bms, bound_by=bby, library_ms=None)
    print("K z_fwd_filter: " + describe(records["z_fwd_filter"])
          + f"; complex filter ms {k_complex_ms:.4f}; no single PyTorch call computes it")
    print("L y_inv: " + describe(records["y_inv"]) + " (library: torch.fft.ifft dim 1)")
    for name in ("lerp_irfft", "lerp_irfft_xzy"):
        print(f"M {name}: " + describe(records[name]) + f", {m_flops:.4g} flop; no single "
              "PyTorch call computes it")
    table_ms = host_ms(lambda: kspec.spectral_table(SHAPE, ANGLE, RATIO, False, AVG, dev))
    print(f"lerp-DFT table {tuple(table.shape)} complex64: {table.numel() * 8 / 1e6:.1f} MB, "
          f"built in {table_ms:.3f} ms on the card (host clock)")
    del vol, spec, spec_k, spec_l, work, filt, filt_c, m_zyx, m_xzy, table
    torch.cuda.empty_cache()

    # The headline step and the full chain through the engine, against the
    # composition routes (A, B, C, D and E, F) in the same run.
    geo = deskew_geometry(SHAPE, ANGLE, RATIO, False, AVG, skip_flip=True)
    rng = np.random.default_rng(16)
    vols_np = rng.integers(0, 65536, size=(BATCH,) + SHAPE, dtype=np.uint16)
    vols_f = torch.from_numpy(vols_np.astype(np.float32)).to(dev)
    vols_u = torch.from_numpy(vols_np).to(dev)
    del vols_np
    kw = dict(keep_overhang=False, average_window=AVG, device=dev)
    step_s = DeconvolveDeskew(tf_half, SHAPE, REG, ANGLE, RATIO, skip_flip=True,
                              spectral=True, **kw)
    step_c = DeconvolveDeskew(tf_half, SHAPE, REG, ANGLE, RATIO, skip_flip=True, **kw)
    require(step_s.deskew_table is not None, "the step did not take the spectral route")
    out_s, launches = counted(lambda: step_s(vols_f))
    want = {"fwd_yx": BATCH, "z_fwd_filter": BATCH, "y_inv": BATCH, "lerp_irfft": BATCH}
    require(launches == want, f"spectral step launches {launches}, want {want}")
    out_c = step_c(vols_f)
    require(out_s.shape == (BATCH,) + geo.out_shape, f"spectral step shape {out_s.shape}")
    require(bool(torch.isfinite(out_s).all()), "spectral step output is not finite")
    _, step_err = rel_err(out_s, out_c)
    require(step_err <= ENGINE_TOL, f"spectral step vs composition: rel err {step_err:.3g}")
    require(torch.equal(step_s(vols_u).view(torch.int32), out_s.view(torch.int32)),
            "spectral step: uint16 input differs from its float32 copy")
    for name in ("z_fwd_filter", "y_inv", "lerp_irfft"):
        records[name]["runs"] = launches
    print(f"spectral step (batch {BATCH}): rel err {step_err:.3g} vs the composition route "
          f"(tol {ENGINE_TOL}); uint16 input bit-exact vs its float32 copy; launches "
          f"{launches}")
    del out_s, out_c

    chain_s = DeconvolveDeskewWarp(tf_half, SHAPE, REG, ANGLE, RATIO, reg_stab_matrix(),
                                   spectral=True, **kw)
    chain_c = DeconvolveDeskewWarp(tf_half, SHAPE, REG, ANGLE, RATIO, reg_stab_matrix(), **kw)
    require(chain_s.deskew_table is not None, "the chain did not take the spectral route")
    out_s, launches_c = counted(lambda: chain_s(vols_f))
    want_c = dict(want, warp_zy=1, warp_x=1)
    require(launches_c == want_c, f"spectral chain launches {launches_c}, want {want_c}")
    out_c = chain_c(vols_f)
    require(bool(torch.isfinite(out_s).all()), "spectral chain output is not finite")
    _, chain_err = rel_err(out_s, out_c)
    require(chain_err <= ENGINE_TOL, f"spectral chain vs composition: rel err {chain_err:.3g}")
    require(torch.equal(chain_s(vols_u).view(torch.int32), out_s.view(torch.int32)),
            "spectral chain: uint16 input differs from its float32 copy")
    records["lerp_irfft_xzy"]["runs"] = launches_c
    print(f"spectral chain (batch {BATCH}, reg_stab): rel err {chain_err:.3g} vs the "
          f"composition route (tol {ENGINE_TOL}); uint16 bit-exact; launches {launches_c}")
    del out_s, out_c

    for what, mods in (("step", (step_s, step_c)), ("chain", (chain_s, chain_c))):
        for route, mod in zip(("spectral", "composition"), mods):
            q = statistics.quantiles(samples_ms(lambda: mod(vols_f), reps=STEP_REPS), n=4)
            print(f"{what} via the {route} route (batch {BATCH}, {SHAPE}, float32 in): "
                  f"{q[1] / BATCH:.4f} ms/volume median, {q[2] / BATCH:.4f} p75 "
                  f"({STEP_REPS} samples)")
    del vols_f, vols_u, step_s, step_c, chain_s, chain_c
    torch.cuda.empty_cache()


def sharded_phase(dev: torch.device, records: dict, tf_half: np.ndarray,
                  psf: np.ndarray) -> None:
    """Phase 17: the sharded deconvolution (kernels A, B or Bc, and C on
    z-slab and ky-row shards) on a virtual mesh of this card, bit-equal to
    the unsharded route; launches, per-shard kernel times, the exchanges'
    times beside their byte bound, and both routes' ms/volume."""
    from biahub_tpu_torch import ArrayPosition, Mesh, deconvolve_arrays, get_mesh
    from biahub_tpu_torch.kernels import fft as kfft
    from biahub_tpu_torch.kernels.deconvolve import deconvolve_zyx
    from biahub_tpu_torch.parallel import sharded_fft as ksf

    n = SHARD_N
    mesh = Mesh.virtual(dev, n)
    z, y, x = SHAPE
    xh = x // 2 + 1
    z_l, y_l = z // n, y // n
    gen = torch.Generator(device=dev).manual_seed(17)
    vol = torch.rand(SHAPE, generator=gen, device=dev)
    prepared = ksf.prepare_sharded_filter(SHAPE, tf_half, REG, mesh)
    filt = kfft.prepare_fourier_filter(SHAPE, tf_half, REG, dev)

    # (a) the headline FOV over n shards: bit-equal to the unsharded route.
    def sharded(v):
        return ksf.deconvolve_zyx_sharded(v, None, mesh, prepared=prepared)

    slabs, launches = counted(lambda: sharded(vol))
    want_l = {"fwd_yx": n, "z_filter": n, "inv_yx": n}
    require(launches == want_l, f"sharded launches {launches}, want {want_l}")
    require([tuple(s.shape) for s in slabs] == [(z_l, y, x)] * n,
            f"sharded slabs {[tuple(s.shape) for s in slabs]}")
    got = ksf.gather(slabs, dev)
    want = deconvolve_zyx(vol, prepared=filt, device=dev)
    require(bool(torch.isfinite(got).all()), "sharded output is not finite")
    require(torch.equal(got, want), f"sharded route differs from the unsharded one: rel err "
            f"{rel_err(got, want)[1]:.3g}")
    u16 = torch.randint(0, 65536, SHAPE, generator=gen, device=dev,
                        dtype=torch.int32).to(torch.uint16)
    require(torch.equal(ksf.gather(sharded(u16), dev), ksf.gather(sharded(u16.float()), dev)),
            "sharded route: uint16 input differs from its float32 copy")
    del got, want, slabs, u16
    print(f"sharded {SHAPE} over {n} shards (a virtual mesh of one card): bit-equal to the "
          f"unsharded route; uint16 bit-exact vs its float32 copy; launches {launches}")
    routes = {"sharded": lambda: sharded(vol),
              "unsharded": lambda: deconvolve_zyx(vol, prepared=filt, device=dev)}
    route_ms = {}
    for name, fn in routes.items():
        q = statistics.quantiles(samples_ms(fn, reps=STEP_REPS), n=4)
        route_ms[name] = q[1]
        print(f"deconvolve {SHAPE} via the {name} route: {q[1]:.4f} ms/volume median, "
              f"{q[2]:.4f} p75 ({STEP_REPS} samples)")

    # Each shard's kernels at its shape, and the two exchanges.
    vol_slabs = [vol[j * z_l:(j + 1) * z_l] for j in range(n)]
    spectra = [kfft.fwd_yx(s) for s in vol_slabs]
    rows = ksf.to_ky_rows(spectra)
    filtered = [kfft.z_filter_(r.clone(), f) for r, f in zip(rows, prepared.shards)]
    work_r, work_s = torch.empty_like(rows[0]), torch.empty_like(spectra[0])
    out_s = torch.empty_like(vol_slabs[0])
    shard_ms = {"A": [], "B": [], "C": []}
    for j in range(n):
        shard_ms["A"].append(time_ms(lambda: kfft.fwd_yx(vol_slabs[j], out=work_s)))
        shard_ms["B"].append(time_ms(lambda: kfft.z_filter_(work_r, prepared.shards[j]),
                                     setup=lambda: work_r.copy_(rows[j])))
        shard_ms["C"].append(time_ms(lambda: kfft.inv_yx(work_s, out=out_s),
                                     setup=lambda: work_s.copy_(spectra[j])))
    spec_bytes = z * y * xh * 8
    ex_bound, _ = bound(4 * spec_bytes, 0)  # pack and copy: each reads and writes it once
    ex1 = time_ms(lambda: ksf.to_ky_rows(spectra))
    back = [s.clone() for s in spectra]
    ex2 = time_ms(lambda: ksf.to_z_slabs(filtered, back))
    del back
    for name, ms in shard_ms.items():
        print(f"sharded {name} per shard (ms): " + ", ".join(f"{t:.4f}" for t in ms))
    b_cold = time_ms(lambda: kfft.z_filter_(work_r, prepared.shards[0]),
                     setup=lambda: (work_r.copy_(rows[0]), flush_l2(dev)))
    print(f"sharded B shard 0 with L2 cold (the input copied, then {L2_FLUSH_BYTES >> 20} MiB "
          f"read): {b_cold:.4f} ms")
    print(f"exchange to ky rows {ex1:.4f} ms, back to z-slabs {ex2:.4f} ms, byte bound "
          f"{ex_bound:.4f} each (pack + copy: 2 x {spec_bytes / 1e6:.1f} MB read and written); "
          f"the exchanges take {(ex1 + ex2) / route_ms['sharded']:.1%} of the sharded route")

    slab_vox, slab_spec = z_l * y * x, z_l * y * xh * 8
    slab_flops = z_l * y * 2.5 * x * math.log2(x) + z_l * xh * 5 * y * math.log2(y)
    bms, bby = bound(slab_vox * 4 + slab_spec, slab_flops)
    slab, spec0 = vol_slabs[0], spectra[0]
    err = {"fwd_yx_shard": rel_err(kfft.fwd_yx(slab), kfft.fwd_yx_plain(slab)),
           "z_filter_shard": rel_err(filtered[0], kfft.z_filter_plain_(rows[0].clone(),
                                                                       prepared.shards[0])),
           "inv_yx_shard": rel_err(kfft.inv_yx(spec0.clone(), out=torch.empty_like(slab)),
                                   kfft.inv_yx_plain(spec0.clone(),
                                                     out=torch.empty_like(slab)))}
    for name, (_, e) in err.items():
        require(e <= FFT_TOL, f"{name} (shard 0): rel err {e:.3g} > {FFT_TOL}")
    records["fwd_yx_shard"] = dict(
        replaces="biahub_tpu/parallel/sharded_fft.py:247", source="biahub_tpu_torch/csrc/fft.cu",
        counter="fwd_yx", runs=launches, max_abs_err=err["fwd_yx_shard"][0],
        ms=shard_ms["A"][0], plain_ms=time_ms(lambda: kfft.fwd_yx_plain(slab)),
        bound_ms=bms, bound_by=bby, library_ms=time_ms(lambda: torch.fft.rfft2(slab)))
    row_bytes = z * y_l * xh * 8
    bms_b, bby_b = bound(2 * row_bytes + z * y_l * xh * 4,
                         2 * y_l * xh * 5 * z * math.log2(z) + 2 * z * y_l * xh)
    records["z_filter_shard"] = dict(
        replaces="biahub_tpu/parallel/sharded_fft.py:291", source="biahub_tpu_torch/csrc/fft.cu",
        counter="z_filter", runs=launches, max_abs_err=err["z_filter_shard"][0],
        ms=shard_ms["B"][0],
        plain_ms=time_ms(lambda: kfft.z_filter_plain_(work_r, prepared.shards[0]),
                         setup=lambda: work_r.copy_(rows[0])),
        bound_ms=bms_b, bound_by=bby_b, library_ms=None)
    records["inv_yx_shard"] = dict(
        replaces="biahub_tpu/parallel/sharded_fft.py:331", source="biahub_tpu_torch/csrc/fft.cu",
        counter="inv_yx", runs=launches, max_abs_err=err["inv_yx_shard"][0],
        ms=shard_ms["C"][0],
        plain_ms=time_ms(lambda: kfft.inv_yx_plain(work_s, out=out_s),
                         setup=lambda: work_s.copy_(spec0)),
        bound_ms=bms, bound_by=bby,
        library_ms=time_ms(lambda: torch.fft.irfft2(spec0, s=(y, x))))
    for name, (_, e) in err.items():
        print(f"{name} at the shard shape (shard 0): rel err {e:.3g} (tol {FFT_TOL}), "
              + describe(records[name]))
    del spectra, rows, filtered, work_r, work_s, out_s, vol_slabs, slab, spec0

    # Over the real cards too, where this machine has several (peer copies).
    cards = get_mesh(device=dev)
    if cards.size > 1 and ksf.sharded_fft_supported(SHAPE, cards.size):
        prepared_c = ksf.prepare_sharded_filter(SHAPE, tf_half, REG, cards)
        slabs = ksf.deconvolve_zyx_sharded(vol, None, cards, prepared=prepared_c)
        require([s.device for s in slabs] == list(cards.devices),
                 f"slabs on {[str(s.device) for s in slabs]}")
        require(torch.equal(ksf.gather(slabs, dev), deconvolve_zyx(vol, prepared=filt,
                                                                   device=dev)),
                f"sharded over {cards.size} cards differs from the unsharded route")

        def all_cards():
            for d in cards.devices:
                torch.cuda.synchronize(d)

        times = []
        for i in range(WARMUP + STEP_REPS):
            all_cards()
            t0 = time.perf_counter()
            ksf.deconvolve_zyx_sharded(vol, None, cards, prepared=prepared_c)
            all_cards()
            if i >= WARMUP:
                times.append(1e3 * (time.perf_counter() - t0))
        q = statistics.quantiles(times, n=4)
        print(f"sharded over {cards.size} cards ({', '.join(map(str, cards.devices))}): the "
              f"pieces crossed devices; bit-equal to the unsharded route; {q[1]:.4f} ms/volume "
              f"median, {q[2]:.4f} p75 (host clock, every card synchronized, input and "
              f"output slabs from and to {dev})")
        del slabs, prepared_c
    del vol, filt, prepared
    torch.cuda.empty_cache()

    # (b) the reconstruction's FOV, complex Hermitian filter (kernel Bc),
    # Bluestein lines on Z and X, z_l odd.
    shape_b, n_b = SHARD_RECON
    vol_b = torch.rand(shape_b, generator=gen, device=dev)
    h = torch.fft.fftn(torch.rand(shape_b, generator=gen, device=dev))
    filt_c = kfft.prepare_hermitian_filter(shape_b, h, 1e-3, dev)
    del h
    mesh_b = Mesh.virtual(dev, n_b)
    got, launches_b = counted(lambda: ksf.gather(
        ksf.fourier_filter_zyx_sharded(vol_b, filt_c, mesh_b), dev))
    want = kfft.fourier_filter_zyx(vol_b, filt_c)
    want_lb = {"fwd_yx": n_b, "z_filter_complex": n_b, "inv_yx": n_b}
    require(launches_b == want_lb, f"sharded complex filter launches {launches_b}, "
            f"want {want_lb}")
    require(torch.equal(got, want), f"sharded complex filter at {shape_b} differs from the "
            f"unsharded route: rel err {rel_err(got, want)[1]:.3g}")
    print(f"sharded complex filter {shape_b} over {n_b} shards (z_l {shape_b[0] // n_b}): "
          f"bit-equal to fourier_filter_zyx; launches {launches_b}")
    del vol_b, filt_c, got, want

    # (c) one z slice per shard: kernels A and C at Z = 1.
    shape_c, n_c = SHARD_ONE_SLICE
    vol_c = torch.rand(shape_c, generator=gen, device=dev)
    tf_c = torch.rand(kfft.half_spectrum_shape(shape_c), generator=gen, device=dev)
    one = vol_c[:1]
    err_a = rel_err(kfft.fwd_yx(one), kfft.fwd_yx_plain(one))[1]
    spec1 = kfft.fwd_yx_plain(one)
    err_c = rel_err(kfft.inv_yx(spec1.clone(), out=torch.empty_like(one)),
                    kfft.inv_yx_plain(spec1.clone(), out=torch.empty_like(one)))[1]
    require(max(err_a, err_c) <= FFT_TOL, f"kernels A, C at Z = 1: rel err {err_a:.3g}, "
            f"{err_c:.3g}")
    got, launches_c = counted(lambda: ksf.gather(ksf.deconvolve_zyx_sharded(
        vol_c, tf_c, Mesh.virtual(dev, n_c), REG), dev))
    want_lc = {"fwd_yx": n_c, "z_filter": n_c, "inv_yx": n_c}
    require(launches_c == want_lc, f"one z slice per shard: launches {launches_c}")
    require(torch.equal(got, deconvolve_zyx(vol_c, tf_c, REG, device=dev)),
            f"one z slice per shard at {shape_c} differs from the unsharded route")
    print(f"one z slice per shard {shape_c} over {n_c}: A and C at Z = 1 within {err_a:.3g}, "
          f"{err_c:.3g} of their plain versions; bit-equal to the unsharded route")
    del vol_c, tf_c, one, spec1, got

    # (d) the deconvolve verb on arrays, both routes.
    tczyx = torch.rand((T_SHARD, 1) + SHAPE, generator=gen, device=dev)
    positions = {"A/1/0": ArrayPosition(tczyx, [1.0, 1.0, 1.0, 0.1, 0.1], ["GFP"])}
    scale = [1.0, 0.1, 0.1]
    (out_s, tf_s), launches_d = counted(lambda: deconvolve_arrays(
        positions, psf, scale, {"regularization_strength": REG}, mesh=mesh, sharded=True,
        device=dev))
    out_b, tf_b = deconvolve_arrays(positions, psf, scale, {"regularization_strength": REG},
                                    device=dev)
    want_ld = {k: T_SHARD * n for k in want_l}
    require(launches_d == want_ld, f"deconvolve_arrays sharded launches {launches_d}")
    require(np.array_equal(tf_s, tf_b) and np.array_equal(tf_s[..., :xh], tf_half),
            "deconvolve_arrays: transfer functions differ")
    require(torch.equal(out_s["A/1/0"], out_b["A/1/0"]),
            "deconvolve_arrays: the sharded and batched routes differ")
    print(f"deconvolve_arrays ({T_SHARD} timepoints x 1 channel of {SHAPE}): sharded over "
          f"{n} shards equal to the batched route; launches {launches_d}")
    del tczyx, positions, out_s, out_b

    # (e) a shape that does not shard: the verb takes the batched route and
    # says so on stderr, as the reference's verb does; the sharded function
    # itself raises.
    shape_e = LAPSE_SHAPE
    require(not ksf.sharded_fft_supported(shape_e, 4), f"{shape_e} over 4 shards is accepted")
    try:
        ksf.deconvolve_zyx_sharded(torch.zeros(shape_e, device=dev),
                                   np.zeros(kfft.half_spectrum_shape(shape_e), np.float32),
                                   Mesh.virtual(dev, 4))
        require(False, f"deconvolve_zyx_sharded: {shape_e} over 4 shards did not raise")
    except ValueError as exc:
        require("divisible" in str(exc), f"{shape_e} over 4 shards: {exc}")
    tczyx = torch.rand((1, 1) + shape_e, generator=gen, device=dev)
    positions = {"A/1/0": ArrayPosition(tczyx, [1.0, 1.0, 1.0, 0.1, 0.1], ["GFP"])}
    stderr = io.StringIO()
    with contextlib.redirect_stderr(stderr):
        (out_e, _), launches_e = counted(lambda: deconvolve_arrays(
            positions, psf, scale, {"regularization_strength": REG}, mesh=Mesh.virtual(dev, 4),
            sharded=True, device=dev))
    sys.stderr.write(stderr.getvalue())
    out_be, _ = deconvolve_arrays(positions, psf, scale, {"regularization_strength": REG},
                                  device=dev)
    require("batched route" in stderr.getvalue(),
            f"deconvolve_arrays: {shape_e} over 4 shards did not say it takes the batched route")
    require(launches_e == {"fwd_yx": 1, "z_filter": 1, "inv_yx": 1},
            f"deconvolve_arrays at {shape_e} over 4 shards: launches {launches_e}")
    require(torch.equal(out_e["A/1/0"], out_be["A/1/0"]),
            f"deconvolve_arrays at {shape_e} over 4 shards differs from the batched route")
    print(f"{shape_e} over 4 shards: not supported; deconvolve_zyx_sharded raises ValueError, "
          f"and deconvolve_arrays(sharded=True) takes the batched route (said on stderr), "
          f"bit-equal to it; launches {launches_e}")
    del tczyx, positions, out_e, out_be
    torch.cuda.empty_cache()


def launch_zplan(plan, spec: torch.Tensor, filt: torch.Tensor) -> None:
    """Kernel B's or Bc's C entry with ``plan`` in place of the card's (the
    tile sweep); counts no launch."""
    from biahub_tpu_torch.kernels import _build
    from biahub_tpu_torch.kernels import fft as kfft

    lib = kfft._lib()
    z, y, xh = spec.shape
    grid = plan.grid(y * xh, kfft._sm_count(spec.device))
    entry = "z_filter_complex" if plan.complex_filter else "z_filter"
    rc = getattr(lib, entry)(_build.ptr(spec), _build.ptr(filt),
                             _build.ptr(kfft._z_table_on(plan, spec.device)), *plan.args(grid), z,
                             y * xh, _build.stream_of(spec))
    _build.check(rc, lib, f"{entry} ({plan.describe()})")


def deskew_exact(vols: torch.Tensor, geo, out_layout: str = "zyx") -> torch.Tensor:
    """Kernel D's per-voxel float32 arithmetic, one torch op at a time (each
    rounded, none fused): in_z = (px*xo - pxct*zo) + offset, taps outside
    [0, Z_in) zero, the tail group's zo clamped, the lerps summed over j in
    order, times 1/avg. The kernel must give these bits."""
    b, z_in, y_in, x_in = vols.shape
    dev = vols.device
    px, pxct, off = (torch.tensor(v, dtype=torch.float32, device=dev)
                     for v in (geo.px, geo.pxct, geo.offset))
    xo = torch.arange(geo.x_out, dtype=torch.float32, device=dev)
    yo = torch.arange(x_in, device=dev)
    xi = yo if geo.skip_flip else x_in - 1 - yo
    avg = geo.average_window
    out = torch.empty((b, geo.groups, x_in, geo.x_out), dtype=torch.float32, device=dev)
    for g in range(geo.groups):
        acc = torch.zeros((b, x_in, geo.x_out), dtype=torch.float32, device=dev)
        for j in range(avg):
            zo = min(g * avg + j, y_in - 1)
            in_z = (px * xo - pxct * float(zo)) + off
            f0 = torch.floor(in_z)
            frac = in_z - f0
            i0 = f0.long()
            rows = vols[:, :, y_in - 1 - zo, :][:, :, xi]  # (B, Z_in, X_in)

            def tap(i):
                v = rows[:, i.clamp(0, z_in - 1), :].transpose(1, 2)
                return torch.where((i >= 0) & (i < z_in), v, torch.zeros((), device=dev))

            acc = acc + (tap(i0) * (1.0 - frac) + tap(i0 + 1) * frac)
        out[:, g] = acc if avg == 1 else acc * torch.tensor(1.0 / avg, dtype=torch.float32,
                                                            device=dev)
    return out.permute(0, 3, 1, 2).contiguous() if out_layout == "xzy" else out


def adjoint_exact(ybar: torch.Tensor, coeffs: torch.Tensor, slot: int, r: int, o: int,
                  order: int) -> torch.Tensor:
    """Kernel J's arithmetic, one torch op at a time: H's float32 coordinate
    and band weights, then for each q in ascending order and each tap k in
    ascending order, the in-domain samples' products w_k * ybar[q], each
    rounded, added to dbar at clamp(floor(c_q) + k), so that every output
    takes its terms in ascending q, then k, one rounded add each. One
    scatter adds at most one term to an output. The kernel must give these
    bits."""
    from biahub_tpu_torch.kernels import multipass_warp as mw

    size_r = ybar.shape[r + 1]
    i0, t, inside = mw._taps(mw._pass_coords(ybar.shape, coeffs, slot, r, o), size_r)
    bands = mw._band_weights(t, order)
    out = torch.zeros_like(ybar)
    zero = torch.zeros((), dtype=ybar.dtype, device=ybar.device)

    def at(a: torch.Tensor, q: int) -> torch.Tensor:
        return a.narrow(r + 1, q, 1) if a.shape[r + 1] == size_r else a

    for q in range(size_r):
        yq = ybar.narrow(r + 1, q, 1)
        for k, w in bands:
            idx = (at(i0, q) + k).clamp(0, size_r - 1).expand(yq.shape)
            out.scatter_add_(r + 1, idx, torch.where(at(inside, q), at(w, q) * yq, zero))
    return out


def profiler_readings(fn, names: tuple, nbytes: float) -> str:
    """``fn``'s launches of the kernels whose names contain one of ``names``, as
    torch.profiler's CUDA activity reads them over TRACE_REPS calls: name,
    launches a call, mean device time, the bytes its bound counts per
    device-time as a share of HBM's 3.35 TB/s. Neither ncu nor CUPTI's
    counters read anything on the card, so these are all the readings."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(TRACE_REPS):
            fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        if any(n in ev.key for n in names) and ev.device_type == DeviceType.CUDA and dev_us > 0:
            per = dev_us / ev.count
            rows.append(f"{ev.key[:60]}: {ev.count / TRACE_REPS:g} a call, {per / 1e3:.4f} ms "
                        f"device, {nbytes / (per * 1e-6) / 1e9:.0f} GB/s of the bound's bytes "
                        f"({nbytes / (per * 1e-6) / HBM_BYTES_PER_S:.0%} of HBM)")
    text = "; ".join(rows) if rows else f"no CUDA activity named {names}"
    return text


def trace_b_and_d(dev: torch.device) -> dict:
    """Profiler readings of B at the headline, Bc at the deskewed FOV and
    D (both stores) on the headline batch; D held to deskew_exact bit for
    bit. PREVIOUS_TRACE holds the same readings of the kernels these
    replaced."""
    from biahub_tpu_torch.kernels import fft as kfft
    from biahub_tpu_torch.kernels.deskew import deskew_geometry
    from biahub_tpu_torch.kernels.deskew_cuda import deskew

    gen = torch.Generator(device=dev).manual_seed(18)
    out = {}
    for key in ("z_filter", "z_filter_complex"):
        shape, cplx = Z_SHAPES[key]
        spec = torch.randn(shape, dtype=torch.complex64, generator=gen, device=dev)
        filt = (torch.randn(shape, dtype=torch.complex64, generator=gen, device=dev) if cplx
                else torch.rand(shape, generator=gen, device=dev))
        work = spec.clone()
        run = kfft.z_filter_complex_ if cplx else kfft.z_filter_
        nbytes = 2 * spec.numel() * 8 + filt.numel() * filt.element_size()
        out[key] = profiler_readings(lambda: run(work.copy_(spec), filt),
                                     ("z_line_kernel", "z_filter_kernel"), nbytes)
        del spec, filt, work
    geo = deskew_geometry(SHAPE, ANGLE, RATIO, False, AVG, skip_flip=True)
    vols = torch.rand((BATCH,) + SHAPE, generator=gen, device=dev)
    rows, out_elems = deskew_rows(geo), BATCH * geo.groups * SHAPE[2] * geo.x_out
    nbytes = BATCH * rows * SHAPE[2] * 4 + out_elems * 4
    exact = deskew_exact(vols[:2], geo)
    for layout in ("zyx", "xzy"):
        key = "deskew" if layout == "zyx" else "deskew_xzy"
        got = deskew(vols[:2], geo, layout)
        want = exact if layout == "zyx" else exact.permute(0, 3, 1, 2)
        out[key + "_exact"] = torch.equal(got.view(torch.int32), want.contiguous().view(torch.int32))
        out[key] = profiler_readings(lambda: deskew(vols, geo, layout), ("deskew_kernel",),
                                     nbytes)
    return out


def deskew_rows(geo) -> int:
    """The scan rows D's bound counts: for every tilt row the span of
    floor(in_z) over X_out and one more, clipped to the volume."""
    z, y, _ = geo.zyx_shape
    in_z = (torch.tensor(geo.px, dtype=torch.float32)
            * torch.arange(geo.x_out, dtype=torch.float32)[None]
            - torch.tensor(geo.pxct, dtype=torch.float32)
            * torch.arange(y, dtype=torch.float32)[:, None]
            + torch.tensor(geo.offset, dtype=torch.float32))
    lo = torch.floor(in_z).amin(dim=1).clamp(0, z - 1)
    hi = (torch.floor(in_z).amax(dim=1) + 1).clamp(0, z - 1)
    return int((hi - lo + 1).sum())


def redesign_phase(dev: torch.device, records: dict) -> None:
    """Phase 18: kernels B, Bc and D redesigned. ptxas' figures; each
    kernel's time on its path beside the previous kernel's and its bound;
    each Z-line shape's plan, error against the plain version, its variants
    bit-equal to it, and its times with L2 warm and cold; D held to
    deskew_exact bit for bit in both stores; the profiler's readings beside
    the previous kernels' (PREVIOUS_TRACE)."""
    from biahub_tpu_torch.kernels import fft as kfft
    from biahub_tpu_torch.kernels.deskew_cuda import deskew_plan
    from biahub_tpu_torch.kernels.deskew import deskew_geometry

    for line in (ptxas_lines(("z_line_kernel",)) + ptxas_lines(("deskew_kernel",), "deskew")):
        print(f"ptxas {line}")
    for key in PHASE_18_KEYS:
        rec, was = records.get(key), PREVIOUS_MS[key]
        if rec is None:
            continue
        print(f"{key}: {rec['ms']:.4f} ms (before: {was}, {rec['ms'] / was - 1:+.1%}), bound "
              f"{rec['bound_ms']:.4f} ({rec['ms'] / rec['bound_ms']:.2f}x the bound)")
    gen = torch.Generator(device=dev).manual_seed(18)
    for key, (shape, cplx) in Z_SHAPES.items():
        spec = torch.randn(shape, dtype=torch.complex64, generator=gen, device=dev)
        filt = (torch.randn(shape, dtype=torch.complex64, generator=gen, device=dev) if cplx
                else torch.rand(shape, generator=gen, device=dev))
        plan = kfft.z_plan(shape[0], cplx)
        want = kfft.z_filter_plain_(spec.clone(), filt)
        got = spec.clone()
        launch_zplan(plan, got, filt)
        _, err = rel_err(got, want)
        require(err <= FFT_TOL, f"{key} at {shape}: rel err {err:.3g} > {FFT_TOL}")
        narrow = next(p for budget in (kfft._SMEM_TWO, kfft._SMEM_ONE)
                      for p in (kfft._z_layout(shape[0], max(plan.log2tk - 1, 0), *layout, cplx)
                                for layout in kfft._Z_LAYOUTS) if p.smem <= budget)
        variants = {f"{1 << narrow.log2tk} lines": narrow,
                    "one tile a block": dataclasses.replace(plan, per_sm=1 << 30)}
        for name, p in variants.items():
            other = spec.clone()
            launch_zplan(p, other, filt)
            require(torch.equal(torch.view_as_real(other), torch.view_as_real(got)),
                    f"{key} at {shape}: {name} ({p.describe()}) is not bit-equal to the plan")
        work = torch.empty_like(spec)
        run = kfft.z_filter_complex_ if cplx else kfft.z_filter_

        def warm():
            work.copy_(spec)

        def cold():
            work.copy_(spec)
            flush_l2(dev)

        times = {"wrapper, L2 warm": time_ms(lambda: run(work, filt), warm),
                 "wrapper, L2 cold": time_ms(lambda: run(work, filt), cold),
                 "plan's launch, L2 cold": time_ms(lambda: launch_zplan(plan, work, filt), cold)}
        for name, p in variants.items():
            times[f"{name}, L2 cold"] = time_ms(lambda: launch_zplan(p, work, filt), cold)
        nbytes = 2 * spec.numel() * 8 + filt.numel() * filt.element_size()

        def traced():
            cold()
            run(work, filt)

        device = profiler_readings(traced, ("z_line_kernel",), nbytes)
        print(f"{key} at {shape}: plan {plan.describe()}; rel err {err:.3g} (tol {FFT_TOL}); "
              f"{' and '.join(variants)} bit-equal to it; ms (CUDA events): "
              + ", ".join(f"{name} {ms:.4f}" for name, ms in times.items())
              + f"; the wrapper's kernel with L2 cold (torch.profiler): {device}")
        del spec, filt, want, got, work, other
    geo = deskew_geometry(SHAPE, ANGLE, RATIO, False, AVG, skip_flip=True)
    print(f"D plan (both stores): {deskew_plan(geo)}")
    readings = trace_b_and_d(dev)
    for key in ("deskew", "deskew_xzy"):
        require(readings.pop(key + "_exact"), f"kernel {key}: not bit-equal to deskew_exact")
    print("D (both stores) bit-equal to deskew_exact, the per-voxel arithmetic of the kernel "
          "it replaced")
    for key, text in readings.items():
        print(f"profiler {key} (after): {text}")
        print(f"profiler {key} (before): {PREVIOUS_TRACE.get(key, 'not measured')}")
    torch.cuda.empty_cache()


def warp_zy_library(vols_xzy: torch.Tensor, coeffs: torch.Tensor, zi: int, yi: int):
    """One grid_sample call computing E's function over the B*Xi (Zi, Yi)
    images of an xzy batch, border padding (E's clamped taps); ``coeffs``
    (21,) or (B, 21). Returns the call."""
    b, xi = vols_xzy.shape[:2]
    table = coeffs.expand(b, -1) if coeffs.ndim == 1 else coeffs
    grid = zy_grid(table, zi, yi, xi)
    img = vols_xzy.reshape(b * xi, 1, zi, yi)
    return lambda: torch.nn.functional.grid_sample(img, grid, mode="bilinear",
                                                   padding_mode="border", align_corners=True)


def ej_phase(dev: torch.device, records: dict) -> None:
    """Phase 19: kernels E and J redesigned, G at other blur sizes, and the
    deconvolve and PCC entry points past the FFT kernels' limits. ptxas'
    figures of E and J; E on the headline batch (zyx and xzy reads) and on
    stabilize's (12, 86, 1024, 484) table batch beside the previous E, its
    bound, grid_sample and torch.profiler's device time; E's direct gathers
    (overflow_matrix) against the plain version; J at each slot and order
    of phase 11's frame bit for bit against adjoint_exact and against the
    plain version; G at blur 0, 3, 5 and 15, exact; one deconvolution and
    one PCC past the limits."""
    from biahub_tpu_torch.kernels import fft as kfft
    from biahub_tpu_torch.kernels import multipass_warp as mw
    from biahub_tpu_torch.kernels.affine import (
        coefficient_table,
        inplane_coefficients,
        translation_matrix,
        warp_zy_plain,
    )
    from biahub_tpu_torch.kernels.chain import flip_y_matrix
    from biahub_tpu_torch.kernels.deconvolve import deconvolve_zyx
    from biahub_tpu_torch.kernels.multipass_cuda import resample_pass_adjoint
    from biahub_tpu_torch.kernels.pcc import _corr_surface, pcc_shifts_vs_first
    from biahub_tpu_torch.kernels.peaks import block_max_candidates_plain
    from biahub_tpu_torch.kernels.peaks_cuda import block_max_argmin, blur_plan
    from biahub_tpu_torch.kernels.warp_cuda import warp_zy

    for line in (ptxas_lines(("warp_zy_kernel",), "warp")
                 + ptxas_lines(("resample_pass_adjoint",), "multipass")):
        print(f"ptxas {line}")
    print(f"before: {CARD_OF_PREVIOUS}")
    gen = torch.Generator(device=dev).manual_seed(19)
    z, y, x = LAPSE_SHAPE

    # -- E: the chain's batch in both reads, and stabilize's table batch ----
    chain_c = inplane_coefficients(flip_y_matrix(y) @ reg_stab_matrix()).to(dev)
    rng = np.random.default_rng(19)
    drift = np.stack([rng.integers(-m, m + 1, T_LAPSE) for m in MAX_DRIFT], axis=1)
    table = coefficient_table(np.stack([translation_matrix(d) for d in drift])).to(dev)
    vol_bytes = math.prod(LAPSE_SHAPE) * 4
    for key, batch, coeffs in (("warp_zy", BATCH, chain_c), ("warp_zy_xzy", BATCH, chain_c),
                               ("warp_zy_per_volume", T_LAPSE, table)):
        vols = torch.rand((batch,) + LAPSE_SHAPE, generator=gen, device=dev)
        xzy = vols.permute(0, 3, 1, 2).contiguous()
        got = warp_zy(vols, coeffs, (z, y))
        _, err = rel_err(got, warp_zy_plain(vols, coeffs, (z, y)))
        require(err <= WARP_TOL, f"E {key}: rel err {err:.3g} > {WARP_TOL}")
        got_x = warp_zy(xzy, coeffs, (z, y), input_xzy=True)
        require(torch.equal(got_x.view(torch.int32), got.view(torch.int32)),
                f"E {key}: the xzy read differs from the zyx read")
        src, read_xzy = (xzy, True) if key == "warp_zy_xzy" else (vols, False)
        ms = time_ms(lambda: warp_zy(src, coeffs, (z, y), input_xzy=read_xzy))
        lib_ms = time_ms(warp_zy_library(xzy, coeffs, z, y))
        bms, _ = bound(2 * batch * vol_bytes, batch * math.prod(LAPSE_SHAPE) * 15)
        device = profiler_readings(lambda: warp_zy(src, coeffs, (z, y), input_xzy=read_xzy),
                                   ("warp_zy_kernel",), 2 * batch * vol_bytes)
        was = PREVIOUS_MS[key]
        print(f"E {key} ({batch}, {z}, {y}, {x}): rel err {err:.3g} (tol {WARP_TOL}), zyx and "
              f"xzy reads bit-equal; {ms:.4f} ms (before: {was}, {ms / was - 1:+.1%}), bound "
              f"{bms:.4f} ({ms / bms:.2f}x), grid_sample {lib_ms:.4f} "
              f"({'E faster' if ms < lib_ms else 'grid_sample faster'}); profiler: {device}")
        del vols, xzy, got, got_x
    torch.cuda.empty_cache()

    # E's direct gathers: a matrix whose tile windows exceed their stage.
    vols = torch.rand((2,) + LAPSE_SHAPE, generator=gen, device=dev)
    over = inplane_coefficients(overflow_matrix()).to(dev)
    got = warp_zy(vols, over, (z, y))
    _, err = rel_err(got, warp_zy_plain(vols, over, (z, y)))
    require(err <= WARP_TOL, f"E with overflowing windows: rel err {err:.3g} > {WARP_TOL}")
    got_x = warp_zy(vols.permute(0, 3, 1, 2).contiguous(), over, (z, y), input_xzy=True)
    require(torch.equal(got_x.view(torch.int32), got.view(torch.int32)),
            "E with overflowing windows: the xzy read differs from the zyx read")
    print(f"E with a 40 deg rotation (tile windows past the stage: direct gathers): rel err "
          f"{err:.3g} (tol {WARP_TOL}), zyx and xzy reads bit-equal; "
          f"{time_ms(lambda: warp_zy(vols, over, (z, y))):.4f} ms for 2 volumes")
    del vols, got, got_x
    torch.cuda.empty_cache()

    # -- J: each slot and order of phase 11's traced frame -----------------
    truth = torch.tensor(similarity_about_centre(LAPSE_SHAPE), dtype=torch.float32, device=dev)
    off, frame_shape, _ = mw.traced_frame(LAPSE_SHAPE, LAPSE_SHAPE, REG_MARGIN)
    rows = mw.traced_pass_rows(truth, off)
    jtable = torch.stack([row for _, _, row in rows]).contiguous()
    ybar = torch.randn((1,) + tuple(frame_shape), generator=gen, device=dev)
    out = torch.empty_like(ybar)
    fbytes = ybar.numel() * 4
    bms_j, _ = bound(2 * fbytes, 6 * ybar.numel())
    times = []
    for order in (1, 3):
        for k, (r, o, _) in enumerate(rows):
            got = resample_pass_adjoint(ybar, jtable, k, r, o, order, out=out)
            exact = adjoint_exact(ybar, jtable, k, r, o, order)
            require(torch.equal(got.view(torch.int32), exact.view(torch.int32)),
                    f"J slot {k} order {order}: not bit-equal to adjoint_exact")
            _, err = rel_err(got, mw.resample_pass_adjoint_plain(ybar, jtable, k, r, o, order))
            require(err <= WARP_TOL, f"J slot {k} order {order}: rel err {err:.3g}")
            ms = time_ms(lambda: resample_pass_adjoint(ybar, jtable, k, r, o, order, out=out))
            times.append(ms)
            print(f"J slot {k} (r {r}, o {o}) order {order}: bit-equal to adjoint_exact, rel err "
                  f"{err:.3g} vs plain (tol {WARP_TOL}); {ms:.4f} ms, bound {bms_j:.4f} "
                  f"({ms / bms_j:.2f}x)")
            del exact
    r, o, _ = rows[3]
    device = profiler_readings(lambda: resample_pass_adjoint(ybar, jtable, 3, r, o, 1, out=out),
                               ("resample_pass_adjoint",), 2 * fbytes)
    was = PREVIOUS_MS["resample_pass_adjoint"]
    mean1 = statistics.mean(times[:len(rows)])
    print(f"J in the {tuple(frame_shape)} frame: order 1 mean of the 7 slots {mean1:.4f} ms "
          f"(before: {was}, {mean1 / was - 1:+.1%}), order 3 mean "
          f"{statistics.mean(times[len(rows):]):.4f}, bound {bms_j:.4f}; slot 3 order 1 "
          f"profiler: {device}")
    del ybar, out
    torch.cuda.empty_cache()

    # -- G at other blur sizes, exact on integer-valued data ---------------
    vol = torch.randint(0, 4096, LAPSE_SHAPE, generator=gen, device=dev).float()
    for blur in G_BLURS:
        for block in PEAK_BLOCKS:
            gv, gi = block_max_argmin(vol, block, blur)
            pv, pi = block_max_candidates_plain(vol, block, blur)
            require(torch.equal(gv, pv) and torch.equal(gi, pi),
                    f"kernel G {block} blur {blur}: {int((gv != pv).sum())} values and "
                    f"{int((gi != pi).sum())} indices differ from the plain version")
        ms = time_ms(lambda: block_max_argmin(vol, PEAK_BLOCKS[0], blur))
        print(f"G blur {blur} (sub-tile, shared memory: {blur_plan(blur)}): values and indices "
              f"equal to the plain version at {PEAK_BLOCKS}; {ms:.4f} ms at {PEAK_BLOCKS[0]}, "
              f"bound {records['block_max_argmin']['bound_ms']:.4f}")
    del vol

    # -- the deconvolve and PCC entry points past the kernels' limits ------
    vol = torch.rand(PAST_LIMITS, generator=gen, device=dev)
    tf_half = torch.rand(kfft.half_spectrum_shape(PAST_LIMITS), generator=gen, device=dev)
    filt = kfft.prepare_fourier_filter(PAST_LIMITS, tf_half, REG, dev)
    err_text = io.StringIO()
    with contextlib.redirect_stderr(err_text):
        got, launches = counted(lambda: deconvolve_zyx(vol, prepared=filt, device=dev))
    spec = kfft.fwd_yx_plain(vol)
    want = kfft.inv_yx_plain(kfft.z_filter_plain_(spec, filt), torch.empty_like(vol))
    _, err = rel_err(got, want)
    require(err <= FFT_TOL, f"deconvolve past the limits: rel err {err:.3g} > {FFT_TOL}")
    require(not launches, f"deconvolve past the limits launched {launches}")
    require(f"{PAST_LIMITS} takes torch.fft" in err_text.getvalue(),
            "deconvolve past the limits: no stderr line")
    print(f"deconvolve_zyx at {PAST_LIMITS}: rel err {err:.3g} vs the plain route (tol "
          f"{FFT_TOL}), no kernel launched; stderr: {err_text.getvalue().strip()}")
    mov = torch.roll(vol, (1, -3, 7), (0, 1, 2))
    err_text = io.StringIO()
    with contextlib.redirect_stderr(err_text):
        shift, launches = counted(lambda: pcc_shifts_vs_first(vol, mov[None], None, device=dev))
        corr_route = _corr_surface(vol, mov, None)
    h1, h2 = kfft.fwd_yx_plain(vol), kfft.fwd_yx_plain(mov)
    corr = kfft.inv_yx_plain(kfft.z_cross_plain_(h1, h2, h2), torch.empty_like(vol))
    _, err = rel_err(corr_route, corr)
    require(err <= FFT_TOL, f"PCC past the limits: rel err {err:.3g} > {FFT_TOL}")
    require(not launches, f"PCC past the limits launched {launches}")
    require(shift[0].tolist() == [-1.0, 3.0, -7.0], f"PCC past the limits: shift {shift[0]}")
    require(f"{PAST_LIMITS} takes torch.fft" in err_text.getvalue(),
            "PCC past the limits: no stderr line")
    print(f"PCC at {PAST_LIMITS}: shift {shift[0].tolist()} exact, correlation rel err "
          f"{err:.3g} vs the plain route (tol {FFT_TOL}), no kernel launched; stderr: "
          f"{err_text.getvalue().strip()}")
    torch.cuda.empty_cache()


def hi_phase(dev: torch.device, records: dict) -> None:
    """Phase 20: kernels H and I redesigned, and the step, the chain and
    the Tikhonov filter past the FFT kernels' limits."""
    from biahub_tpu_torch import (
        DeconvolveDeskew,
        DeconvolveDeskewWarp,
        apply_inverse_transfer_function_arrays,
        compute_transfer_function_arrays,
    )
    from biahub_tpu_torch.kernels import fft as kfft
    from biahub_tpu_torch.kernels import multipass_cuda as mc
    from biahub_tpu_torch.kernels import multipass_warp as mw
    from biahub_tpu_torch.kernels.affine import warp_x_plain, warp_zy_plain
    from biahub_tpu_torch.kernels.deconvolve import compute_transfer_function
    from biahub_tpu_torch.kernels.deskew import deskew_plain
    from biahub_tpu_torch.recon.optics import tikhonov_inverse_3d

    for line in ptxas_lines(("resample_pass_kernel", "resample_pass_row_kernel",
                             "resample_pass_deriv"), "multipass"):
        print(f"ptxas {line}")
    print(f"before: {CARD_OF_PREVIOUS}")

    # -- H: both frames, both orders, one coefficient set and a table ------
    _, _, _, frame8, table8 = rigid_frame(dev)
    frame8b = torch.cat([frame8, torch.roll(frame8, (1, -2, 3), (1, 2, 3))]).contiguous()
    table8b = torch.stack([table8, torch.tensor([[1.0, 0.0, 0.0]] * len(table8),
                                                device=dev)]).contiguous()
    shape11, rows11, table11 = traced_rows(dev)
    gen = torch.Generator(device=dev).manual_seed(20)
    frame11 = torch.nn.functional.avg_pool3d(
        torch.rand(shape11, generator=gen, device=dev)[None, None], 3, 1, 1)[0]
    cases = (("phase 8 frame", frame8, table8), ("phase 8 frame, (2, 21) table", frame8b,
                                                  table8b), ("traced frame", frame11, table11))
    mean_ms = {}
    for name, frame, table in cases:
        out = torch.empty_like(frame)
        bms, _ = bound(2 * frame.numel() * 4, frame.numel() * 30)
        for order in (1, 3):
            ms, bit_equal, direct = [], 0, 0
            for k, (r, o) in enumerate(mw.CANONICAL_SLOTS):
                got = mc.resample_pass(frame, table, k, r, o, order, out=out)
                want = mw.resample_pass_plain(frame, table, k, r, o, order)
                _, err = rel_err(got, want)
                require(err <= WARP_TOL, f"H {name} slot {k} order {order}: rel err {err:.3g}")
                bit_equal += int(torch.equal(got.view(torch.int32), want.view(torch.int32)))
                del want
                direct += direct_tiles(tuple(frame.shape[1:]), r, o, table, k, order, "H")
                ms.append(time_ms(lambda: mc.resample_pass(frame, table, k, r, o, order,
                                                           out=out)))
            mean_ms[(name, order)] = statistics.mean(ms)
            print(f"H {name} {tuple(frame.shape)} order {order}: {bit_equal} of 7 slots "
                  f"bit-equal to the plain version, tiles with direct taps {direct}; ms by slot "
                  + ", ".join(f"{t:.4f}" for t in ms) + f"; mean {mean_ms[(name, order)]:.4f}, "
                  f"bound {bms:.4f} ({mean_ms[(name, order)] / bms:.2f}x)")
        del out
    r, o = mw.CANONICAL_SLOTS[0]
    out = torch.empty_like(frame11)
    device = profiler_readings(lambda: mc.resample_pass(frame11, table11, 0, r, o, 1, out=out),
                               ("resample_pass",), 2 * frame11.numel() * 4)
    lib = pass_library(frame11, table11, 0, r, o)
    lib_ms = time_ms(lib)
    was, was11 = PREVIOUS_MS["resample_pass"], PREVIOUS_MS["resample_pass_traced"]
    now, now11 = mean_ms[("phase 8 frame", 3)], mean_ms[("traced frame", 1)]
    print(f"H: phase 8 frame order 3 mean {now:.4f} ms (before: {was}, {now / was - 1:+.1%}); "
          f"traced frame order 1 mean {now11:.4f} (before: {was11}, {now11 / was11 - 1:+.1%}); "
          f"grid_sample forward, slot 0 order 1 on the traced frame {lib_ms:.4f} ms "
          f"({'H faster' if now11 < lib_ms else 'grid_sample faster'}); slot 0 order 1 "
          f"profiler: {device}")
    del frame8, frame8b, out
    torch.cuda.empty_cache()

    # -- I: each slot and order of the traced frame --------------------------
    ybar = torch.randn(frame11.shape, generator=gen, device=dev)
    fbytes = frame11.numel() * 4
    bms_i, _ = bound(2 * fbytes, 0, 9 * frame11.numel())
    for order in (1, 3):
        ms, worst = [], 0.0
        for k, (r, o, _) in enumerate(rows11):
            got = mc.resample_pass_deriv(frame11, ybar, table11, k, r, o, order)
            again = mc.resample_pass_deriv(frame11, ybar, table11, k, r, o, order)
            want = mw.resample_pass_deriv_plain(frame11, ybar, table11, k, r, o, order)
            err = float((got - want).abs().max() / want.abs().max())
            require(err <= DERIV_TOL, f"I slot {k} order {order}: rel err {err:.3g}")
            require(torch.equal(got, again), f"I slot {k} order {order}: two runs differ")
            worst = max(worst, err)
            ms.append(time_ms(lambda: mc.resample_pass_deriv(frame11, ybar, table11, k, r, o,
                                                             order)))
        mean = statistics.mean(ms)
        mean_ms[("I", order)] = mean
        print(f"I traced frame order {order}: rel err at most {worst:.3g} (tol {DERIV_TOL}), two "
              f"runs bit-equal; ms by slot " + ", ".join(f"{t:.4f}" for t in ms)
              + f"; mean {mean:.4f}, bound {bms_i:.4f} ({mean / bms_i:.2f}x)")
    r, o, _ = rows11[0]
    device = profiler_readings(
        lambda: mc.resample_pass_deriv(frame11, ybar, table11, 0, r, o, 1),
        ("resample_pass_deriv",), 2 * fbytes)
    was = PREVIOUS_MS["resample_pass_deriv"]
    print(f"I: order 1 mean {mean_ms[('I', 1)]:.4f} ms (before: {was}, "
          f"{mean_ms[('I', 1)] / was - 1:+.1%}); slot 0 order 1 profiler: {device}")
    del frame11, ybar
    torch.cuda.empty_cache()

    # -- the step, the chain and the Tikhonov filter past the limits -------
    z, y, x = PAST_FILTER
    vols = torch.rand((2,) + PAST_FILTER, generator=gen, device=dev)
    rr = (min(PAST_FILTER) - 1) // 2  # a Gaussian PSF that fits the volume
    psf = np.exp(-np.sum(np.square(np.mgrid[-rr:rr + 1, -rr:rr + 1, -rr:rr + 1] / 1.5),
                         axis=0)).astype(np.float32)
    tf_half = compute_transfer_function(psf, PAST_FILTER)[..., :x // 2 + 1]
    filt = kfft.prepare_fourier_filter(PAST_FILTER, tf_half, REG, dev)
    decon = torch.stack([torch.fft.irfftn(torch.fft.rfftn(v) * filt, s=PAST_FILTER)
                         for v in vols])
    step = DeconvolveDeskew(tf_half, PAST_FILTER, REG, ANGLE, RATIO, average_window=AVG,
                            skip_flip=True, device=dev)
    err_text = io.StringIO()
    with contextlib.redirect_stderr(err_text):
        got, launches = counted(lambda: step(vols))
    want = deskew_plain(decon, step.geometry)
    _, err = rel_err(got, want)
    require(err <= FFT_TOL, f"step past the limits: rel err {err:.3g} > {FFT_TOL}")
    require(launches == {"deskew": 1}, f"step past the limits launched {launches}")
    line = err_text.getvalue().strip()
    require(f"deconvolve_then_deskew: {PAST_FILTER} takes torch.fft" in line,
            "step past the limits: no stderr line")
    print(f"step at {PAST_FILTER} (batch 2): rel err {err:.3g} vs torch.fft then the plain "
          f"deskew (tol {FFT_TOL}); launches {launches}; stderr: {line}")
    chain = DeconvolveDeskewWarp(tf_half, PAST_FILTER, REG, ANGLE, RATIO, reg_stab_matrix(),
                                 average_window=AVG, device=dev)
    with contextlib.redirect_stderr(io.StringIO()):
        got, launches = counted(lambda: chain(vols))
    zo, yo, xo = chain.output_shape
    want = warp_x_plain(warp_zy_plain(want, chain.warp, (zo, yo)), chain.warp, xo,
                        chain.logical_zyx_shape, chain.fill)
    _, err = rel_err(got, want)
    require(err <= FFT_TOL, f"chain past the limits: rel err {err:.3g} > {FFT_TOL}")
    want_l = {"deskew": 1, "warp_zy": 1, "warp_x": 1}
    require(launches == want_l, f"chain past the limits launched {launches}")
    print(f"chain at {PAST_FILTER} (batch 2): rel err {err:.3g} vs the plain chain; launches "
          f"{launches}")
    del vols, decon, got, want, step, chain

    tfs = compute_transfer_function_arrays(PAST_FILTER, BF_SETTINGS, device=dev)
    h = tfs["phase"]
    bf = 1000.0 + 10.0 * torch.rand(PAST_FILTER, generator=gen, device=dev)
    i_norm = bf / bf.mean() - 1.0
    reg_p = BF_SETTINGS["phase"]["apply_inverse"]["regularization_strength"]
    h64 = h.cpu().numpy().astype(np.complex128)
    exact = np.real(np.fft.ifftn(np.fft.fftn(i_norm.cpu().numpy().astype(np.float64))
                                 * np.conj(h64) / (np.abs(h64) ** 2 + reg_p)))
    err_text = io.StringIO()
    with contextlib.redirect_stderr(err_text):
        got, launches = counted(lambda: tikhonov_inverse_3d(i_norm, h, reg_p, device=dev))
        recon, launches_a = counted(lambda: apply_inverse_transfer_function_arrays(
            bf[None, None], ["BF"], tfs, BF_SETTINGS, device=dev))
    lines = err_text.getvalue().strip().splitlines()
    err = float(np.abs(got.cpu().numpy() - exact).max() / np.abs(exact).max())
    err_a = float(np.abs(recon[0, 0].cpu().numpy() - exact).max() / np.abs(exact).max())
    require(err <= FFT_TOL and err_a <= FFT_TOL,
            f"Tikhonov past the limits: rel err {err:.3g}, apply-inv-tf {err_a:.3g}")
    require(not launches and not launches_a,
            f"Tikhonov past the limits launched {launches}, {launches_a}")
    require(any(f"tikhonov_inverse_3d: {PAST_FILTER} takes torch.fft" in ln for ln in lines)
            and any(f"apply_inverse_transfer_function: {PAST_FILTER} takes torch.fft" in ln
                    for ln in lines), "Tikhonov past the limits: no stderr line")
    print(f"tikhonov_inverse_3d and apply-inv-tf (phase) at {PAST_FILTER}: rel err {err:.3g}, "
          f"{err_a:.3g} vs the full-spectrum formula in float64 (tol {FFT_TOL}); no kernel "
          f"launched; stderr: " + " | ".join(lines))
    torch.cuda.empty_cache()


def direct_tiles(shape, r: int, o: int, table: torch.Tensor, slot: int, order: int,
                 kernel: str) -> int:
    """The tiles of one pass of kernel H or I over a frame of ``shape`` (per
    volume of ``table``) whose window exceeds its stage, from
    ``multipass_cuda.pass_window`` at every tile of ``pass_walk``'s tiles
    (vectorized; r = 2 by row)."""
    from biahub_tpu_torch.kernels import multipass_cuda as mc

    tp, lanes = mc.PASS_TILES[kernel][r]
    shear = o != r
    rows = table.reshape(-1, table.shape[-2], 3)[:, slot].cpu().numpy()
    n = 0
    for cr, co, tau in rows:
        p_lo = np.arange(0, shape[r], tp)
        p_hi = np.minimum(p_lo + tp, shape[r]) - 1
        if r < 2 and o == 2:
            l0 = np.arange(0, shape[2], lanes)[:, None]
            o_range = (l0, np.minimum(l0 + lanes, shape[2]) - 1)
        else:
            i_o = np.arange(shape[o])[:, None] if shear else np.zeros((1, 1), np.int64)
            o_range = (i_o, i_o)
        window = mc.pass_window(cr, co, tau, shear, o_range, (p_lo[None], p_hi[None]), order,
                                shape[r])
        n += int((~mc.pass_staged(window, r, kernel)).sum())
    return n


def pass_library(frame: torch.Tensor, table: torch.Tensor, slot: int, r: int, o: int):
    """One grid_sample call computing H's order-1 pass ``slot`` over a (1,
    F0, F1, F2) frame (trilinear, border padding: the clamped taps; not the
    fill, which the traced frame's margin leaves unused). Returns the
    call."""
    from biahub_tpu_torch.kernels import multipass_warp as mw

    shape = frame.shape[1:]
    zyx = [mw._pass_coords(frame.shape, table, slot, r, o) if a == r
           else mw._axis_ramp(shape[a], a, frame.device) for a in range(3)]
    zyx = torch.broadcast_tensors(*zyx)
    grid = torch.stack([lerp_grid(zyx[a][0], shape[a]) for a in (2, 1, 0)], -1)[None]
    img = frame[:, None]
    return lambda: torch.nn.functional.grid_sample(img, grid, mode="bilinear",
                                                   padding_mode="border", align_corners=True)


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
    rows = deskew_rows(geo)
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
    for name, ms in RECORDED_WARP_MS.items():
        print(f"chain {name} with one coefficient set: {records[name]['ms']:.4f} ms per "
              f"batch of {BATCH} (PERF.md: {ms}, {records[name]['ms'] / ms - 1:+.1%})")
    del vols_f, vols_u, out_c, out_cu, out_x, chain, step
    torch.cuda.empty_cache()
    for rec in records.values():
        rec["runs"] = launches_c
    records["deskew_xzy"]["runs"] = launches_x

    stabilization_phases(dev, records)
    peaks_phase(dev, records)
    multipass_phase(dev, records)
    beads_phases(dev, records)
    vjp_phase(dev, records)
    registration_phase(dev, records)
    any_length_phase(dev, records)
    slice_phase(dev, records)
    tfs = compute_tf_phase(dev)
    reconstruction_phase(dev, records, tfs)
    del tfs
    spectral_phase(dev, records, tf_half)
    sharded_phase(dev, records, tf_half, psf)
    redesign_phase(dev, records)
    ej_phase(dev, records)
    hi_phase(dev, records)

    # -- the per-kernel line: launches from each kernel's path (the chain's,
    # D's xzy store's from the xzy route's, Bx's from estimate-stabilization,
    # the per-volume E and F from stabilize, G and H from the beads estimate
    # and the stabilize that follows it, I and J from optimize-registration,
    # K, L and M from the spectral step, M's xzy store from the spectral chain,
    # A, B and C at the shard shapes from the sharded headline volume)
    for name, rec in records.items():
        counter = rec.get("counter", name)
        require(rec["runs"].get(counter, 0) >= 1, f"kernel {name} was not launched on its path")
        rec["launches"] = rec["runs"][counter]
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
