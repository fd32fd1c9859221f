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
    (inverse DFT along Y: C's column passes) and M (the lerp-DFT
    contraction on the tensor cores in split TF32, then the irfft, both
    stores) against their plain versions, K and L within FFT_TOL, M and its
    contraction within SPECTRAL_TOL, M's xzy store equal to its zyx store
    transposed, at the headline (avg 3; avg 1 with the overhang kept), at
    (43, 97, 121) avg 3, (16, 16, 2048) avg 2 and (16, 10, 3) avg 2
    (SPECTRAL_CASES); ptxas' registers and spills of L's and M's kernels;
    K, L, M's contraction and M's irfft (each store) timed beside their
    bounds (the contraction's on the tensor cores, its CUDA-core bound
    beside it), their plain versions and one PyTorch call (ifft; one
    complex64 matmul for the contraction alone; irfft), L and M (both
    launches) beside the kernels they replaced (PREVIOUS_MS) and with
    torch.profiler's device times; the table's build; then
    ``DeconvolveDeskew(spectral=True)`` and
    ``DeconvolveDeskewWarp(spectral=True)`` (reg_stab) on the headline
    batch, each within ENGINE_TOL of its composition route, uint16
    bit-exact, launches A, K, L, M's two 8 each and no B, C, D (E 1, F 1
    for the chain); the step's and the chain's ms/volume on both routes.

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

Then kernels G and Bx after their redesign, and D's batch chunks:

21. ptxas' registers, stack and spills of G's kernels (the walk, the axis
    passes, the decode) and of Bx's; G at both geometries (beads' (8, 8,
    8), estimate-psf's (64, 64, 32)) at (86, 1024, 484) for each blur of
    G21_BLURS (0 to 63, past the previous kernel's limit of 38) on
    integer-valued data, values and indices equal to the plain version,
    each time beside its bound and its plan, blur 3 and 0 beside the
    previous G (PREVIOUS_MS) with torch.profiler's device time; Bx at each
    shape of BX_SHAPES (the PCC crop's spectrum, custom_padding's, a prime
    Z and each Z limit) in all three normalizations within FFT_TOL of its
    plain version in complex128, out = mov equal, ref kept, the crop and
    custom_padding timed beside the previous Bx, their bounds and
    torch.profiler; D on D_CHUNK_BATCH volumes of D_CHUNK_SHAPE (86 groups:
    past the kernel's grid of 65535), launched in chunks, both stores bit-
    equal to deskewing the volumes one by one.

Then the fused pipeline and the verbs on arrays, at full width:

22. (a) ``fuse_arrays`` on the mantis FOV (T 2, C 2, uint16 from seed 0)
    at the users' settings: flat-field on channel 0, deconvolve (reg 1e-3,
    the main path's PSF), deskew with settings/example_deskew_settings.yml
    (36.17 deg, ratio 0.371, the overhang kept and filled with the mean,
    avg 3: the frame (86, 1024, 897)), and the registration block of
    settings/example_fuse_pipeline_settings.yml (its -5, 2.5 shift with a
    0.5 deg rotation) composed with one in-plane stabilization matrix per
    timepoint: launches A, B, C 4, D, E, F 2; held within FFT_TOL of the
    same call through every kernel's plain version (``all_plain``) outside
    the voxels that an exact zero of one route's deconvolution moves (the
    fill masks data == 0; both routes' zero sets are checked to differ only
    where the other route is within FFT_TOL of 0), D equal to its plain
    version on each route's deconvolution; ms/volume (host clock) and the
    fill's share; (b) the route with no fill and one matrix (``reg_stab``)
    at the headline, 4 volumes: equal to ``run_chain_warp`` with the xzy
    handoff bit for bit, launches A, B, C 4, D, E, F 1, ms/volume; (c)
    general per-timepoint matrices (rotations about (1, 1, 1)) after the
    deskew (86, 1024, 484): H 7 launches in one union frame, within 1e-5 of
    the plain route; (d) flat-field -> deskew (mean fill) -> warp over a
    FUSE_BUDGET of 256 MiB (flat-field in Y slabs, the deskew in X slabs,
    the fill in Y slabs, the warp in output chunks) against the in-budget
    result, on the users' data and on smooth data, within the warp's float32
    coordinate rounding (COORD_ULPS ulp of the largest coordinate in each
    of its two passes times the largest step of its input), the deskew's
    slabs bit-equal and the chunked fill equal to the whole fill, and the
    chunked warp against the whole warp on smooth data: translation and
    in-plane within 1e-5, general within MULTIPASS_TOL, every voxel that
    one float32 mask fills and the other does not within EDGE_EPS of the
    volume's edge; (e) ``deskew_arrays`` with the example deskew settings
    against its own X-slab route, and ``flat_field_arrays`` (no kernel);
    (f) ``register_arrays`` at (86, 1024, 484) with ``keep_overhang``
    false: the crop the LIR of the warped frame, the target copied cropped,
    the source equal to ``affine_warp_auto`` with the crop folded in.

Then the verbs on plates, through the command line a user calls:

23. writes the users' plate (22a's T 2, C 2 uint16 volumes) and a PSF
    plate with the port's OME-Zarr writer in a ``tempfile.mkdtemp()``
    directory, runs ``python -m biahub_tpu_torch.cli fuse`` there (as
    ``cli.main``) at 22a's settings with ``--resume``: launches A, B, C 4
    and D, E, F 2, the plate read back bit-equal to ``fuse_arrays`` on the
    same arrays; prints the verb's ms a volume (host clock, the whole call
    and the runner's part), the runner's split (host time waiting on
    reads, the copies to the card, the kernels, the copies back, host time
    waiting on writes; the copies and kernels by CUDA events) and the bytes
    read and written, beside ``fuse_arrays``' ms a volume in this run; runs
    it again with ``--resume`` (no unit computed, the plate's chunks
    untouched), the deskew verb on the same plate (bit-equal to
    ``deskew_arrays``), the flat-field verb into an OME-Zarr 0.5 plate on a
    small cut (bit-equal to ``flat_field_arrays``, read back as written),
    and requires a v2 filter (``delta``, outside the store's codecs) to
    raise naming itself; the
    directory is deleted at the end.
24. the reconstruction and estimate verbs on plates at full width, each
    plate written by the port in a ``tempfile.mkdtemp()`` directory and
    deleted once its verb is checked: reconstruct on 15's polarization
    timelapse cut to T_PLATE_RECON timepoints (launches A, Bc, C once a
    timepoint; the plate bit-equal to ``reconstruct_arrays``; apply-inv-tf's
    runner split and bytes); estimate-stabilization with phase-cross-corr
    on 5's timelapse (the drift exact, the YAML's transforms equal to
    ``estimate_stabilization_arrays``', launches as 5) and with beads on
    9's (equal, ``xyz_transforms/`` written, G and H launched);
    estimate-psf on two of its volumes (bit-equal to
    ``estimate_psf_arrays``, G 2); estimate-registration (ants) on 12's
    pair started REG_START_ERROR off (equal to
    ``estimate_registration_arrays``), optimize-registration on the YAML it
    wrote (two runs of ``optimize_registration_arrays`` measure the
    run-to-run difference, which the verb must keep within), and register
    on the optimized YAML (bit-equal to ``register_arrays``); H, I and J
    launched. Each verb's ms for the whole call (host clock) is printed
    beside its ``*_arrays`` function's on the same arrays in this run.
25. the stitching and assembly verbs on plates at full width, in a
    ``tempfile.mkdtemp()`` directory (page cache warm), through
    ``cli.main``: a 3x3 well of (2, 2, 16, 1024, 1024) float32 tiles, windows
    of one smooth random mosaic (seed 25) at the pitch of
    ``settings/example_stitch_settings.yml`` with up to 3 px of integer
    jitter, the stage positions in the plate's micromanager metadata up to
    5 px off: estimate-stitch with the strips' PCC (every tile within 1 px
    of its true offset), stitch -b 1.0 on the true offsets (within one
    float16 ulp of the mosaic wherever a tile weighs, 0 elsewhere; the
    workers' reads, stacking, copies, blend by CUDA events, writes, bytes
    and the peak card memory), the same with ``BIAHUB_TPU_HOST_BLEND=1``
    (within one float16 ulp of the card's blend) and under
    ``BIAHUB_TPU_PROFILE=<dir>`` (bit-equal; its device table printed, and
    the device operations of one ``blend_chunk`` traced alone all in it);
    flip -x and pyramid --levels 4 on a copy of the mosaic (bit-equal to
    NumPy's flip and to the 2x2 means); the pipeline's assemble step
    (three (T 2, 86, 1024, 897) float32 plates: concatenate's resolve mode
    with three ``--concat-data-paths``, then ``--cluster debug --resume``
    into OME-Zarr 0.5, bit-equal channel by channel, GB/s; a second
    ``--resume`` writes nothing); the deconvolve verb on a (T 2, C 1,
    256, 256, 1024) plate under ``BIAHUB_TPU_SHARDED_FFT=1`` over
    ``Mesh.virtual(cuda:0, 4)`` (bit-equal to ``deconvolve_arrays(
    sharded=True)``, within FFT_TOL of the batched verb, A, B, C 4 each a
    volume), ms/volume beside the batched verb's.
26. the model verbs on plates through ``cli.main``, in a
    ``tempfile.mkdtemp()`` directory: virtual-stain with the example
    settings' UNeXt2 at full width (dims 96/192/384/768, blocks 3/3/9/3,
    depth 15, stem (5, 4, 4), 2 outputs; random weights from seed 26 saved
    as a checkpoint) on a (T 2, C 1) x (86, 1024, 484) Phase3D plate, step 1,
    under ``BIAHUB_TPU_MODEL_PRECISION`` default (TF32): the plate bit-equal
    to ``predict_timepoint`` on the card, rotation TTA on one timepoint, ms a
    window, a timepoint and the whole call, and the peak card memory; one
    full-width window within MODEL_HIGHEST_TOL (highest) and
    MODEL_DEFAULT_TOL (default) x max|ref| of the same weights in float32 on
    the host; segment on a (T 1, C 2, 8, 1024, 484) plate with
    ``threshold_otsu`` (bit-equal to the host function) and a CPnet at
    cellpose's default width (random weights and BatchNorm statistics,
    diameter 40: resized on the card), its output on one slice within the
    same bounds of the host's float32 run and that slice's labels under
    TF32 and under highest against the plain route's up to a permutation
    (both counts printed; under highest none may differ); the flow round trip on
    rendered instance masks at 1024 x 484 (``masks_to_flows`` ->
    ``compute_masks_zyx`` on the card: every instance recovered, equal to
    the plain route up to a permutation; ``follow_flows`` timed per
    volume); track with settings/example_track_settings.yml on a rendered
    (8, 1024, 484) time-lapse of 40 moving nuclei (labels bit-equal to the
    engine on arrays, each nucleus one track); then the pipeline's order:
    virtual-stain's plate (its TorchScript route on the card: a model that
    passes its input through, on the nuclei repeated over 5 planes) joined
    by concatenate into an assembled plate, and track on its
    ``nuclei_prediction`` (each nucleus one track).
27. the store's codecs and the last eight CLI entries, in a
    ``tempfile.mkdtemp()`` directory (page cache warm): the libraries
    ``ctypes.util.find_library`` finds (``zstd`` must be found); phase 23's
    fuse input (uniform random: blosc's memcpyed route) and a camera-like
    copy (Poisson noise around a smooth field with an offset of 100) written
    uncompressed and in the reference's three layouts (v2 blosc-zstd with
    byte shuffle, v3 ``bytes`` + ``zstd``, v3 ``sharding_indexed``) on the
    store's I/O threads, each read back bit-equal (write and read ms,
    MB/s, the compression ratio); the fuse verb once over all eight plates'
    positions (A-F launched; each compressed plate's output bit-equal to
    the uncompressed plate's); the fused volume written uncompressed and at
    zstd level 1; process-with-config's example binning on phase 23's plate
    (bit-equal to the rule in NumPy); characterize-psf with the example
    settings on a (118, 1043, 518) volume of rendered integer-valued beads
    (G launched once, the peaks equal to the plain route's, the mean fitted
    FWHM within FWHM_TOL of the rendered one; whole-call ms and its host
    part); estimate-crop on two (T 2, 86, 1024, 484) arms with zero borders
    (the boxes' intersection); estimate-bleaching on a (6, 2, 86, 1024, 484)
    rendered decay (the card's means within BLEACH_MEAN_TOL of NumPy's, the
    lifetimes within BLEACH_TAU_TOL); estimate-deskew from point files (the
    known angle and ratio); check-disk-space, nf list-positions and
    crop-background.
28. the last library modules: ``optimize_matches`` with the default grid
    on a (118, 1043, 518) pair of rendered beads an affine offset apart
    (whole-call ms, G's and H's launches, which join the kernels line's,
    the host share against torch.profiler's device time; the chosen trial's
    overlap at least 0.9), and on a small pair the card's chosen settings
    and score equal to the CPU route's; ``Transform.apply`` with an
    in-plane (E, F) and a general (H) matrix within WARP_TOL of the plain
    route; estimate-registration's manual method through ``cli.main`` on
    two plates of other voxel sizes with point files (.npy and napari's
    CSV; the YAML's matrix within 1e-12 of ``registration_from_point_pairs``
    on the host) and without (exit 1, the headless message); the compiled
    host helper's ``find_lir`` on the register verb's mask at (86, 1024,
    484) equal to the Python loop, ms for both, and the register verb's
    whole call with each in turns (loop, helper, helper, loop), the plates
    equal; ``composite_channels`` (``render_frame``'s composite) on the
    card equal to the CPU route's, and ``render_frame`` drawing with PIL or
    raising its ``ImportError`` where PIL is absent.
29. the batch verbs over several shards, in a ``tempfile.mkdtemp()``
    directory: phase 23's fuse verb (its settings, a (T 2, C 2) uint16 plate
    of the headline volume, seed 29) and the deconvolve verb on the same
    plate, each through the runner over one shard and over
    ``Mesh.virtual(cuda:0, SHARDS_N)``: the plates bit-equal, every shard's
    stream launching the verb's kernels (A-F, A-C), whole-call ms and the
    ``RUN_STATS`` split of each; over ``get_mesh()`` (every card) the same
    where the process has more than one card; the process-group sharded
    FFT (``deconvolve_zyx_sharded`` over a ``GlobalMesh`` of PG_FFT_RANKS
    NCCL processes, one card each, this script's ``--pg-fft-worker``) on
    the headline volume within 1e-5 x max|ref| of the one-process route,
    where there are that many cards. On one card the last two print why
    they did not run.

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
# bandwidth, float32 outside the tensor cores, and dense TF32 on them (kernel
# M's contraction, the only kernel that uses them).
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
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
# checks: an odd shape (Z = 43: a ragged last kz stage of M's contraction;
# Y = 97 and X = 121: Bluestein lines in L, 11 x 11 in M's irfft), X = 2048
# (8 kx tiles of the contraction, 2 column pairs an irfft tile), X = 3 (the
# least irfft), the headline with the overhang kept and no averaging, and
# the headline last.
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
               "resample_pass_deriv": 0.7381,
               # Phase 21: G (beads' blocks, blur 3 and 0) and Bx (the PCC crop,
               # custom_padding's shape) before their redesign (PERF.md section
               # 6, rows 10 and 14).
               "block_max_argmin": 0.7997, "block_max_argmin_blur0": 0.3513,
               "z_cross": 0.3192, "z_cross_padding": 3.7868,
               # Phase 16: L and M (contraction + irfft, both stores) before
               # their redesign, at the headline (PERF.md section 6, row 15).
               "y_inv": 0.4201, "lerp_irfft": 4.3803, "lerp_irfft_xzy": 4.4779}
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
    # Phase 21: the previous G and Bx (commit 428e5e4's sources built beside
    # this checkout's, same card and limit): torch.profiler's device time a
    # launch at beads' (8, 8, 8) blocks and at the PCC crop and
    # custom_padding's shape (magnitude).
    "block_max_argmin": "block_max_argmin_kernel<3>: 0.7680 ms device, 223 GB/s (7% of HBM)",
    "block_max_argmin_blur0": "block_max_argmin_kernel<0>: 0.3126 ms device, 548 GB/s (16% of "
                              "HBM)",
    "z_cross": "z_cross_kernel<false>: 0.2958 ms device",
    "z_cross_padding": "z_cross_kernel<true>: 3.6961 ms device",
}
# Phase 21: G's blur sizes (39 and 63 past the previous kernel's limit of
# 38); Bx's shapes: the PCC crop's spectrum, custom_padding's, a prime Z
# (Bluestein) and each Z limit on a small plane; D's batch past its grid
# (800 x 86 groups > 65535), each volume narrow.
G21_BLURS = (0, 3, 5, 15, 39, 63)
BX_SHAPES = {"PCC crop": (64, 1024, 129), "custom_padding": (77, 1232, 155),
             "prime Z": (67, 256, 129), "power-of-two limit": (2048, 8, 9),
             "other limit": (1023, 8, 9)}
D_CHUNK_SHAPE, D_CHUNK_BATCH = (256, 256, 8), 800
Z_SHAPES = {"z_filter": ((256, 256, 513), False), "z_filter_complex": ((86, 1024, 243), True),
            "z_filter_shard": ((256, 64, 513), False)}
TRACE_REPS = 20
L2_FLUSH_BYTES = 256 << 20
# Phase 22, the fused pipeline and the verbs on arrays: T and C of the
# mantis FOV, settings/example_deskew_settings.yml's fields, the
# registration block of settings/example_fuse_pipeline_settings.yml (its
# -5, 2.5 shift, with a small rotation added), a budget that forces the
# over-budget routes at full width, and the chunked multipass warp's
# tolerance on smooth data (biahub_tpu/kernels/multipass_warp.py:646-648).
FUSE_T, FUSE_C = 2, 2
FUSE_DESKEW = {"pixel_size_um": 0.116, "ls_angle_deg": 36.17, "px_to_scan_ratio": 0.371,
               "scan_step_um": 0.313, "keep_overhang": True, "average_n_slices": 3,
               "overhang_fill": "mean"}
FUSE_REG_DEG, FUSE_REG_SHIFT = 0.5, (-5.0, 2.5)
FUSE_BUDGET = 256 << 20
FUSE_REPS = 3
MULTIPASS_TOL = 3e-3
# Phase 22d: the in- and over-budget routes' coordinates round apart by at
# most this many float32 ulp of the largest coordinate in each warp pass.
COORD_ULPS = 4
# Phase 22d: voxels whose exact input coordinate lies this close (voxels) to
# the volume's edge may be filled by one float32 mask and not by another.
EDGE_EPS = 1e-3


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


def bound(nbytes: float, flops: float, f64_flops: float = 0.0,
          tf32_flops: float = 0.0) -> tuple[float, str]:
    """Least time on the card (ms) for the work, and what bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = (flops / F32_FLOP_PER_S + f64_flops / F64_FLOP_PER_S
             + tf32_flops / TF32_FLOP_PER_S)
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


def beads_timelapse(dev: torch.device):
    """The beads timelapse (T_BEADS, 1, *LAPSE_SHAPE) and its drifts (seed
    9): N_BEADS beads, each timepoint a rigid drift about the centre."""
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
    return lapse, truth


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

    lapse, truth = beads_timelapse(dev)
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


def registration_pair(dev: torch.device):
    """The registration pair at LAPSE_SHAPE (seed 12): the reference volume,
    the moving one (the reference through the truth's inverse), the truth,
    the start (REG_START_ERROR off) and the generator, drawn on."""
    gen = torch.Generator(device=dev).manual_seed(12)
    ref = gaussian_noise(LAPSE_SHAPE, REG_SIGMA, gen)
    truth = similarity_about_centre(LAPSE_SHAPE)
    mov = warp_trilinear(ref, np.linalg.inv(truth))
    initial = truth.copy()
    initial[:3, 3] += REG_START_ERROR
    return ref, mov, truth, initial, gen


def registration_phase(dev: torch.device, records: dict) -> None:
    """Phase 12: optimize-registration on a rendered pair, against the truth
    and the plain route; per-level launches and times; ms per step at
    bench.py's optimizer shape."""
    from biahub_tpu_torch import optimize_registration_arrays
    from biahub_tpu_torch.kernels import _build
    from biahub_tpu_torch.kernels.multipass_warp import traced_frame
    from biahub_tpu_torch.registration import intensity as ti

    shape = LAPSE_SHAPE
    ref, mov, truth, initial, gen = registration_pair(dev)
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
        err["M contraction"] = rel_err(kspc.lerp_contract(spec_l, table, shape[2], avg),
                                       kspc.lerp_contract_plain(spec_l, table, shape[2], avg))
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
              f"store transposed; L {kfft.column_plan(spec_l.shape).describe()}; M "
              f"{kspc.contract_plan(shape[0], shape[2], table.shape[1], m_zyx.shape[0], avg).describe()}"
              f"; zyx {kspc.irfft_plan(shape[2], table.shape[1], m_zyx.shape[0]).describe()}")

    for line in (ptxas_lines(("y_inv_kernel",), "fft")
                 + ptxas_lines(("lerp_contract_kernel", "lerp_irfft_kernel"), "spectral")):
        print(f"ptxas {line}")
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
    l_device = profiler_readings(lambda: kfft.y_inv_(work), ("y_inv",), 2 * spec_bytes)

    # M's contraction: 8 flop a complex multiply-add over every table row,
    # each float32 product three TF32 products on the tensor cores; its
    # yardstick is one complex64 matmul of the gathered operands (full
    # float32: allow_tf32 is False), the contraction without the irfft.
    macs = rows * xh * x_out * z
    u = torch.empty((groups, xh, x_out), dtype=torch.complex64, device=dev)
    u_bytes = u.numel() * 8
    out_bytes = groups * x * x_out * 4
    bms_c, bby_c = bound(spec_bytes + table.numel() * 8 + u_bytes, 0, tf32_flops=3 * 8 * macs)
    f32_bound_c, _ = bound(spec_bytes + table.numel() * 8 + u_bytes, 8 * macs)
    s_g = (spec_l[:, kspc._tilt_rows(y, rows, dev), :].reshape(z, groups, AVG, xh)
           .permute(1, 2, 0, 3).reshape(groups, AVG * z, xh).contiguous())
    t_g = (table.reshape(groups, AVG, x_out, z).permute(0, 2, 1, 3)
           .reshape(groups, x_out, AVG * z).contiguous())
    u_plain = kspc.lerp_contract_plain(spec_l, table, x, AVG)
    err_c, _ = rel_err(kspc.lerp_contract(spec_l, table, x, AVG, out=u), u_plain)
    require(rel_err(torch.matmul(t_g, s_g).transpose(1, 2), u_plain)[1] <= SPECTRAL_TOL,
            "the contraction's yardstick (one matmul) disagrees with the plain version")
    records["lerp_contract"] = dict(
        replaces="biahub_tpu/kernels/pallas_spectral.py:327",
        source="biahub_tpu_torch/csrc/spectral.cu", max_abs_err=err_c,
        ms=time_ms(lambda: kspc.lerp_contract(spec_l, table, x, AVG, out=u)),
        plain_ms=time_ms(lambda: kspc.lerp_contract_plain(spec_l, table, x, AVG)),
        bound_ms=bms_c, bound_by=bby_c, library_ms=time_ms(lambda: torch.matmul(t_g, s_g)))
    del s_g, t_g, u_plain
    # M's irfft: U in, the volume out; one irfft call computes it (its
    # imaginary parts at kx = 0 and X/2 are zero or ignored alike here).
    i_flops = groups * x_out * 2.5 * x * math.log2(x)
    bms_i, bby_i = bound(u_bytes + out_bytes, i_flops)
    outs = {"zyx": torch.empty((groups, x, x_out), device=dev),
            "xzy": torch.empty((x_out, groups, x), device=dev)}
    for name, layout, replaces in (("lerp_irfft", "zyx", 327), ("lerp_irfft_xzy", "xzy", 434)):
        o = outs[layout]
        err_i, _ = rel_err(kspc.irfft_columns(u, x, layout, out=o),
                           kspc.irfft_columns_plain(u, x, layout))
        records[name] = dict(
            replaces=f"biahub_tpu/kernels/pallas_spectral.py:{replaces}",
            source="biahub_tpu_torch/csrc/spectral.cu", counter="lerp_irfft",
            max_abs_err=err_i, ms=time_ms(lambda: kspc.irfft_columns(u, x, layout, out=o)),
            plain_ms=time_ms(lambda: kspc.irfft_columns_plain(u, x, layout)),
            bound_ms=bms_i, bound_by=bby_i,
            library_ms=time_ms(lambda: torch.fft.irfft(u, n=x, dim=1)))
    m_bound, _ = bound(spec_bytes + table.numel() * 8 + out_bytes, i_flops,
                       tf32_flops=3 * 8 * macs)
    m_ms = {layout: time_ms(lambda: kspc.lerp_irfft(spec_l, table, x, AVG, layout,
                                                     out=outs[layout]))
            for layout in ("zyx", "xzy")}
    m_plain = {layout: time_ms(lambda: kspc.lerp_irfft_plain(spec_l, table, x, AVG, layout))
               for layout in ("zyx", "xzy")}
    m_device = profiler_readings(
        lambda: kspc.lerp_irfft(spec_l, table, x, AVG, "zyx", out=outs["zyx"]),
        ("lerp_contract", "lerp_irfft"), spec_bytes + table.numel() * 8 + u_bytes)
    print("K z_fwd_filter: " + describe(records["z_fwd_filter"])
          + f"; complex filter ms {k_complex_ms:.4f}; no single PyTorch call computes it")
    print("L y_inv: " + describe(records["y_inv"]) + " (library: torch.fft.ifft dim 1); "
          f"before {PREVIOUS_MS['y_inv']} ({records['y_inv']['ms'] / PREVIOUS_MS['y_inv'] - 1:+.1%}); "
          f"{kfft.column_plan(spec_k.shape).describe()}; profiler: {l_device}")
    print("M lerp_contract (the contraction alone): " + describe(records["lerp_contract"])
          + f" (library: one complex64 torch.matmul of the gathered operands, the "
          f"contraction without the irfft, allow_tf32 False); {macs:.4g} complex multiply-"
          f"adds; bound {bms_c:.4f} ms on the tensor cores (3xTF32, {3 * 8 * macs:.4g} "
          f"flop at {TF32_FLOP_PER_S:.3g}/s), {f32_bound_c:.4f} ms on the CUDA cores "
          f"({8 * macs:.4g} flop at {F32_FLOP_PER_S:.3g}/s); "
          f"{kspc.contract_plan(z, x, x_out, groups, AVG).describe()}")
    for name, layout in (("lerp_irfft", "zyx"), ("lerp_irfft_xzy", "xzy")):
        print(f"M {name} (the irfft alone): " + describe(records[name])
              + " (library: torch.fft.irfft dim 1); "
              + kspc.irfft_plan(x, x_out, groups, layout).describe())
    for layout, name in (("zyx", "lerp_irfft"), ("xzy", "lerp_irfft_xzy")):
        was = PREVIOUS_MS[name]
        print(f"M {layout} (contraction + irfft, lerp_irfft): {m_ms[layout]:.4f} ms, plain "
              f"{m_plain[layout]:.4f}, bound {m_bound:.4f} (tensor cores; "
              f"{bound(spec_bytes + table.numel() * 8 + out_bytes, 8 * macs + i_flops)[0]:.4f}"
              f" on the CUDA cores); before {was} ({m_ms[layout] / was - 1:+.1%})")
    print(f"M device (profiler, zyx): {m_device}")
    del u, outs
    table_ms = host_ms(lambda: kspec.spectral_table(SHAPE, ANGLE, RATIO, False, AVG, dev))
    print(f"lerp-DFT table {tuple(table.shape)} complex64: {table.numel() * 8 / 1e6:.1f} MB, "
          f"built in {table_ms:.3f} ms on the card (host clock); M's U scratch "
          f"{groups * xh * x_out * 8 / 1e6:.1f} MB a call")
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
    want = {"fwd_yx": BATCH, "z_fwd_filter": BATCH, "y_inv": BATCH, "lerp_contract": BATCH,
            "lerp_irfft": BATCH}
    require(launches == want, f"spectral step launches {launches}, want {want}")
    out_c = step_c(vols_f)
    require(out_s.shape == (BATCH,) + geo.out_shape, f"spectral step shape {out_s.shape}")
    require(bool(torch.isfinite(out_s).all()), "spectral step output is not finite")
    _, step_err = rel_err(out_s, out_c)
    require(step_err <= ENGINE_TOL, f"spectral step vs composition: rel err {step_err:.3g}")
    require(torch.equal(step_s(vols_u).view(torch.int32), out_s.view(torch.int32)),
            "spectral step: uint16 input differs from its float32 copy")
    for name in ("z_fwd_filter", "y_inv", "lerp_contract", "lerp_irfft"):
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
                             _build.ptr(kfft._table_on(plan, spec.device)), *plan.args(grid), z,
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
    from biahub_tpu_torch.kernels.peaks_cuda import block_max_argmin, g_plan
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
        print(f"G blur {blur} ({g_plan(blur, PEAK_BLOCKS[0]).describe()}): values and indices "
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


def gbx_phase(dev: torch.device, records: dict) -> None:
    """Phase 21: kernels G and Bx redesigned, and D's batch past its grid."""
    from biahub_tpu_torch.kernels import fft as kfft
    from biahub_tpu_torch.kernels.deskew import deskew_geometry
    from biahub_tpu_torch.kernels.deskew_cuda import batch_chunks, deskew
    from biahub_tpu_torch.kernels.peaks import block_grid, block_max_candidates_plain
    from biahub_tpu_torch.kernels.peaks_cuda import block_max_argmin, g_plan

    for line in (ptxas_lines(("block_walk_kernel", "axis_sum_kernel", "decode_kernel"), "peaks")
                 + ptxas_lines(("z_cross_kernel",), "fft")):
        print(f"ptxas {line}")
    print(f"before: {CARD_OF_PREVIOUS}")
    gen = torch.Generator(device=dev).manual_seed(21)

    # -- G: both geometries, every blur of G21_BLURS, exact on integer data --
    vol = torch.randint(0, 4096, LAPSE_SHAPE, generator=gen, device=dev).float()
    ms = {}
    for blur in G21_BLURS:
        for block in PEAK_BLOCKS:
            gv, gi = block_max_argmin(vol, block, blur)
            pv, pi = block_max_candidates_plain(vol, block, blur)
            require(torch.equal(gv, pv) and torch.equal(gi, pi),
                    f"kernel G {block} blur {blur}: {int((gv != pv).sum())} values and "
                    f"{int((gi != pi).sum())} indices differ from the plain version")
            ms[(blur, block)] = time_ms(lambda: block_max_argmin(vol, block, blur))
            nbytes = vol.numel() * 4 + math.prod(block_grid(LAPSE_SHAPE, block)) * 8
            bms, _ = bound(nbytes, vol.numel() * (3 * blur + 3))
            print(f"G {block} blur {blur}: values and indices equal to the plain version; "
                  f"{ms[(blur, block)]:.4f} ms, bound {bms:.4f} "
                  f"({ms[(blur, block)] / bms:.2f}x); {g_plan(blur, block).describe()}")
    block = PEAK_BLOCKS[0]
    nbytes = vol.numel() * 4 + math.prod(block_grid(LAPSE_SHAPE, block)) * 8
    for blur, key in ((3, "block_max_argmin"), (0, "block_max_argmin_blur0")):
        device = profiler_readings(lambda: block_max_argmin(vol, block, blur),
                                   ("block_walk", "axis_sum", "decode"), nbytes)
        was = PREVIOUS_MS[key]
        print(f"G {block} blur {blur}: {ms[(blur, block)]:.4f} ms (before: {was}, "
              f"{ms[(blur, block)] / was - 1:+.1%}); profiler: {device}; before: "
              f"{PREVIOUS_TRACE[key]}")
    del vol, gv, gi, pv, pi
    torch.cuda.empty_cache()

    # -- Bx: each shape of BX_SHAPES, all three normalizations -------------
    for name, shape in BX_SHAPES.items():
        ref = torch.randn(shape, dtype=torch.complex64, generator=gen, device=dev)
        mov = torch.randn(shape, dtype=torch.complex64, generator=gen, device=dev)
        kept = ref.clone()
        out = torch.empty_like(mov)
        worst = 0.0
        for norm in NORMS:
            kfft.z_cross_(ref, mov, out, norm)
            want = kfft.z_cross_plain_(ref.to(torch.complex128), mov.to(torch.complex128),
                                       torch.empty(shape, dtype=torch.complex128, device=dev),
                                       norm)
            _, err = rel_err(out.to(torch.complex128), want)
            require(err <= FFT_TOL, f"kernel Bx {name} {shape} ({norm}): rel err {err:.3g}")
            alias = mov.clone()
            kfft.z_cross_(ref, alias, alias, norm)
            require(torch.equal(alias, out), f"kernel Bx {name} ({norm}): out = mov differs")
            worst = max(worst, err)
        require(torch.equal(ref, kept), f"kernel Bx {name}: wrote the reference spectrum")
        line = (f"Bx {name} {shape}: rel err at most {worst:.3g} vs complex128 (tol {FFT_TOL}), "
                f"out = mov equal, ref kept; {kfft.cross_plan(shape[0]).describe()}")
        key = {"PCC crop": "z_cross", "custom_padding": "z_cross_padding"}.get(name)
        if key is not None:
            z, y, xh = shape
            nbytes = 3 * ref.numel() * 8
            bms, bby = bound(nbytes, 0, 3 * y * xh * 5 * z * math.log2(z) + 20 * z * y * xh)
            now = time_ms(lambda: kfft.z_cross_(ref, mov, out, "magnitude"))
            device = profiler_readings(lambda: kfft.z_cross_(ref, mov, out, "magnitude"),
                                       ("z_cross",), nbytes)
            was = PREVIOUS_MS[key]
            line += (f"; magnitude {now:.4f} ms (before: {was}, {now / was - 1:+.1%}), bound "
                     f"{bms:.4f} ({bby}, {now / bms:.2f}x); profiler: {device}; before: "
                     f"{PREVIOUS_TRACE[key]}")
        print(line)
        del ref, mov, kept, out, want, alias
    torch.cuda.empty_cache()

    # -- D: a batch past its grid, in chunks --------------------------------
    geo = deskew_geometry(D_CHUNK_SHAPE, ANGLE, RATIO, False, AVG, skip_flip=True)
    vols = torch.rand((D_CHUNK_BATCH,) + D_CHUNK_SHAPE, generator=gen, device=dev)
    chunks = batch_chunks(D_CHUNK_BATCH, geo.groups)
    require(D_CHUNK_BATCH * geo.groups > 65535 and len(chunks) > 1,
            f"D's chunk case: {D_CHUNK_BATCH} x {geo.groups} groups fits one grid")
    for layout in ("zyx", "xzy"):
        got, launches = counted(lambda: deskew(vols, geo, layout))
        one = torch.cat([deskew(v[None], geo, layout) for v in vols])
        require(torch.equal(got.view(torch.int32), one.view(torch.int32)),
                f"kernel D ({layout}): the chunked batch differs from volume by volume")
        counter = "deskew" if layout == "zyx" else "deskew_xzy"
        require(launches == {counter: len(chunks)}, f"kernel D chunks launched {launches}")
        print(f"D {layout}, {D_CHUNK_BATCH} volumes of {D_CHUNK_SHAPE} ({geo.groups} groups): "
              f"{len(chunks)} launches ({chunks}), bit-equal to deskewing volume by volume")
        del got, one
    del vols
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


@contextlib.contextmanager
def all_plain():
    """Every kernel wrapper takes its plain PyTorch version, on the card
    (``_build.on_card`` is consulted at each call); nothing is counted."""
    from biahub_tpu_torch.kernels import _build

    saved = _build.on_card
    _build.on_card = lambda t, what: False
    try:
        yield
    finally:
        _build.on_card = saved


def inplane_about_centre(deg: float, shift, zyx_shape) -> np.ndarray:
    """Output->input rotation by ``deg`` in the YX plane about the centre
    of ``zyx_shape``, then ``shift`` (y, x)."""
    t = np.deg2rad(deg)
    m = np.eye(4)
    m[1:3, 1:3] = [[np.cos(t), -np.sin(t)], [np.sin(t), np.cos(t)]]
    c = (np.asarray(zyx_shape[1:], float) - 1) / 2
    m[1:3, 3] = c - m[1:3, 1:3] @ c + np.asarray(shift, float)
    return m


def tilted_rotation(deg: float, shift, zyx_shape) -> np.ndarray:
    """Output->input rotation by ``deg`` about the axis (1, 1, 1) through the
    centre of ``zyx_shape``, then ``shift``: every canonical slot of the
    multipass warp is a shear."""
    axis = np.ones(3) / np.sqrt(3.0)
    t = np.deg2rad(deg)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    r = np.eye(3) + np.sin(t) * k + (1 - np.cos(t)) * (k @ k)
    m = np.eye(4)
    m[:3, :3] = r
    c = (np.asarray(zyx_shape, float) - 1) / 2
    m[:3, 3] = c - r @ c + np.asarray(shift, float)
    return m


def edge_voxels(matrix: np.ndarray, in_shape, out_shape, dev: torch.device) -> torch.Tensor:
    """(Zo, Yo, Xo) bool: the output voxels whose exact input coordinate
    (float64) lies within EDGE_EPS of an edge of the ``in_shape`` domain on
    some axis, where float32 masks computed in different frames may
    disagree."""
    m = torch.tensor(np.asarray(matrix, dtype=np.float64), device=dev)
    grid = [torch.arange(n, dtype=torch.float64, device=dev) for n in out_shape]
    zo, yo, xo = grid[0][:, None, None], grid[1][None, :, None], grid[2][None, None, :]
    near = torch.zeros(tuple(out_shape), dtype=torch.bool, device=dev)
    for a in range(3):
        c = m[a, 0] * zo + m[a, 1] * yo + m[a, 2] * xo + m[a, 3]
        near |= ((c.abs() <= EDGE_EPS) | ((c - (in_shape[a] - 1)).abs() <= EDGE_EPS))
        del c
    return near


def fuse_phase(dev: torch.device, tf_half: np.ndarray) -> None:
    """Phase 22: the fused pipeline and the deskew, flat-field and register
    verbs on arrays at full width (module docstring, 22a-f)."""
    from biahub_tpu_torch import deskew_arrays, flat_field_arrays, fuse_arrays, register_arrays
    from biahub_tpu_torch.deskew import deskew_slabbed, fill_overhang_chunked
    from biahub_tpu_torch.kernels import fft as kfft
    from biahub_tpu_torch.kernels.affine import (
        affine_warp_auto,
        inplane_affine_warp_zyx,
        inplane_affine_warp_zyx_batched,
        inplane_coefficients,
    )
    from biahub_tpu_torch.kernels.chain import chain_warp_matrix, flip_y_matrix, run_chain_warp
    from biahub_tpu_torch.kernels.deconvolve import deconvolve_zyx
    from biahub_tpu_torch.kernels.deskew import (
        deskew_geometry,
        deskew_plain,
        deskew_zyx,
        fill_overhang,
        get_deskewed_data_shape,
        overhang_mask,
    )
    from biahub_tpu_torch.kernels.deskew_cuda import deskew
    from biahub_tpu_torch.kernels.flat_field import flat_field_zyx
    from biahub_tpu_torch.kernels.multipass_warp import (
        chunked_affine_warp_zyx,
        multipass_affine_warp_zyx,
    )
    from biahub_tpu_torch.device import gpu_info

    card = gpu_info()
    names = ["GFP", "Phase3D"]
    # The transfer function lives on the card, as a caller that runs many
    # timepoints holds it: the times below are the volumes', not its upload.
    tf_half = torch.from_numpy(np.ascontiguousarray(tf_half)).to(dev)
    z, y, x = SHAPE
    frame, _ = get_deskewed_data_shape(SHAPE, ANGLE, RATIO, True, AVG)
    print(f"22. fused pipeline at the users' settings: raw {SHAPE}, deskewed frame {frame}")
    gen = torch.Generator(device=dev).manual_seed(0)
    raw = torch.randint(0, 65536, (FUSE_T, FUSE_C) + SHAPE, generator=gen, device=dev,
                        dtype=torch.int32).to(torch.uint16)
    m_reg = inplane_about_centre(FUSE_REG_DEG, FUSE_REG_SHIFT, frame)
    m_stab = [inplane_about_centre(0.2 * t, (0.5 * t, -0.75 * t), frame)
              for t in range(FUSE_T)]
    users = {"flat_field": {"channel_names": ["GFP"]},
             "deconvolve": {"regularization_strength": REG}, "deskew": FUSE_DESKEW,
             "registration": {"affine_transform_zyx": m_reg.tolist()},
             "stabilization": {"affine_transform_zyx_list": [m.tolist() for m in m_stab]}}

    # (a) the users' settings: flat-field on channel 0, then deconvolve,
    # deskew with the mean fill, and register∘stabilize, per timepoint.
    out_a, launches_a = counted(lambda: fuse_arrays(raw, names, users, tf_half, device=dev))
    n_units = FUSE_T * FUSE_C
    want_a = {"fwd_yx": n_units, "z_filter": n_units, "inv_yx": n_units, "deskew": 2,
              "warp_zy": 2, "warp_x": 2}
    require(launches_a == want_a, f"fuse (a) launches {launches_a}, want {want_a}")
    require(out_a.shape == (FUSE_T, FUSE_C) + tuple(frame), f"fuse (a) shape {out_a.shape}")
    require(bool(torch.isfinite(out_a).all()), "fuse (a) output is not finite")
    with all_plain():
        plain_a = fuse_arrays(raw, names, users, tf_half, device=dev)
    # The fill masks data == 0 (fill_overhang), and a deconvolved volume can
    # hold exact zeros of its own: where two FFT routes that agree to ~1e-6
    # round a voxel to 0 in one and not in the other, the mask, and so the
    # fill, differs in the 7^3 box around it. So: D exact on each route's
    # deconvolution (values, and so zeros, equal to its plain version); every
    # difference of the two routes' deskewed zero sets a value within FFT_TOL
    # of 0 in the other route; the output within FFT_TOL of the plain route
    # outside those boxes as the warp carries them.
    filt = kfft.prepare_fourier_filter(SHAPE, tf_half, REG, dev)
    geo_f = deskew_geometry(SHAPE, ANGLE, RATIO, True, AVG, skip_flip=True)
    affected = torch.zeros(out_a.shape, dtype=torch.bool, device=dev)
    data_zeros, d_exact, masked = 0, True, 0
    for t in range(FUSE_T):
        m_t = flip_y_matrix(frame[1]) @ m_reg @ m_stab[t]
        for c in range(FUSE_C):
            v = flat_field_zyx(raw[t, c], device=dev) if c == 0 else raw[t, c]
            dec_k = deconvolve_zyx(v, prepared=filt, device=dev)
            with all_plain():
                dec_p = deconvolve_zyx(v, prepared=filt, device=dev)
            data_zeros += int((dec_k == 0).sum()) + int((dec_p == 0).sum())
            desk_k = deskew(dec_k[None], geo_f)[0]
            d_exact = d_exact and torch.equal(desk_k, deskew_plain(dec_k[None], geo_f)[0])
            desk_p = deskew_plain(dec_p[None], geo_f)[0]
            zk, zp = desk_k == 0, desk_p == 0
            if not torch.equal(zk, zp):
                other = torch.where(zk, desk_p, desk_k)[zk != zp]
                require(float(other.abs().max()) <= FFT_TOL * float(desk_p.abs().max()),
                        "fuse (a): the zero sets differ by more than the FFT's rounding")
            mask_k = overhang_mask(desk_k)
            masked += int(mask_k.sum())
            diff = (mask_k != overhang_mask(desk_p)).to(torch.float32)
            affected[t, c] = inplane_affine_warp_zyx(diff, m_t, tuple(frame), device=dev) > 0
            del dec_k, dec_p, desk_p, zk, zp, diff
    require(d_exact, "fuse (a): kernel D differs from its plain version")
    keep = ~affected
    a_abs, a_err = rel_err(out_a[keep], plain_a[keep])
    require(a_err <= FFT_TOL, f"fuse (a) rel err {a_err:.3g} > {FFT_TOL}")
    n_affected = int(affected.sum())
    # The fill value: the float64 sum against the float32 sum the reference
    # takes (jnp.sum), reported.
    valid = ~mask_k
    f64 = float(torch.where(valid, desk_k, 0.0).sum(dtype=torch.float64)) / int(valid.sum())
    f32 = float(torch.where(valid, desk_k, 0.0).sum()) / int(valid.sum())
    ms_a = host_ms(lambda: fuse_arrays(raw, names, users, tf_half, device=dev),
                   reps=FUSE_REPS) / n_units
    fill_ms = time_ms(lambda: fill_overhang(desk_k))
    # The dilation as the port computes it (per axis an OR of shifted
    # copies) beside three 1-D max-pools of width 7, one 7^3 max-pool and the
    # reference's three 3^3 pools: the same mask, timed.
    zero = (desk_k == 0).to(torch.float32)[None, None]

    def pools(kernels):
        m = zero
        for k in kernels:
            m = torch.nn.functional.max_pool3d(m, k, stride=1, padding=[w // 2 for w in k])
        return m

    variants = {"three 1-D max-pools": [(7, 1, 1), (1, 7, 1), (1, 1, 7)],
                "one 7^3 max-pool": [(7, 7, 7)], "three 3^3 max-pools": [(3, 3, 3)] * 3}
    require(all(torch.equal(pools(k)[0, 0] > 0.5, mask_k) for k in variants.values()),
            "fuse (a): the dilations disagree")
    mask_ms = {"the port's OR passes": time_ms(lambda: overhang_mask(desk_k))}
    mask_ms.update({name: time_ms(lambda k=k: pools(k)) for name, k in variants.items()})
    del zero
    print("22a the fill's mask, ms a volume: " + ", ".join(f"{k} {v:.4f}" for k, v in mask_ms.items()))
    # The stages one by one, per volume: flat-field, A + B + C, D (a batch
    # of FUSE_T), the fill, E + F with the (FUSE_T, 21) table.
    vol0 = raw[0, 0]
    batch_d = torch.stack([deconvolve_zyx(raw[t, 1], prepared=filt, device=dev)
                           for t in range(FUSE_T)])
    desk_b = deskew(batch_d, geo_f)
    mats_a = np.stack([flip_y_matrix(frame[1]) @ m_reg @ m for m in m_stab])
    stages = {
        "flat-field": time_ms(lambda: flat_field_zyx(vol0, device=dev)),
        "deconvolve (A, B, C)": time_ms(lambda: deconvolve_zyx(vol0, prepared=filt,
                                                               device=dev)),
        "deskew (D)": time_ms(lambda: deskew(batch_d, geo_f)) / FUSE_T,
        "fill": fill_ms,
        "warp (E, F)": time_ms(lambda: inplane_affine_warp_zyx_batched(
            desk_b, mats_a, tuple(frame), device=dev)) / FUSE_T,
    }
    del batch_d, desk_b
    print("22a stages, ms per volume: " + ", ".join(f"{k} {v:.4f}" for k, v in stages.items())
          + f"; sum {sum(stages.values()):.4f} (flat-field on half the volumes)")
    print(f"22a fuse_arrays (T {FUSE_T}, C {FUSE_C}, uint16 {SHAPE} -> {tuple(frame)}, "
          f"flat-field ch 0, reg {REG}, deskew keep_overhang + mean fill, avg {AVG}, "
          f"in-plane register x stabilize): {ms_a:.4f} ms/volume (host clock, "
          f"{FUSE_REPS} runs); the fill {fill_ms:.4f} ms/volume = {fill_ms / ms_a:.1%} of it; "
          f"rel err {a_err:.3g} vs every kernel's plain version (tol {FFT_TOL}) outside "
          f"{n_affected} of {out_a.numel()} output voxels near {data_zeros} exact zeros "
          f"of the deconvolutions (either route); D equal to its plain version; "
          f"{masked / n_units:.0f} voxels masked a volume; fill value of the last volume: "
          f"float64 sum {f64:.9g}, float32 sum {f32:.9g} (rel {abs(f32 - f64) / abs(f64):.3g}); "
          f"launches {launches_a}; card {card}")
    del out_a, plain_a, affected, keep, desk_k, mask_k, valid

    # (b) no fill, one matrix, at the headline: the main path's chain.
    vols_b = raw.reshape((-1,) + SHAPE)
    chain_cfg = {"deconvolve": {"regularization_strength": REG},
                 "deskew": dict(FUSE_DESKEW, keep_overhang=False, overhang_fill=0.0),
                 "registration": {"affine_transform_zyx": reg_stab_matrix().tolist()}}
    big = 16 << 30
    out_b, launches_b = counted(lambda: fuse_arrays(vols_b[:, None], ["GFP"], chain_cfg, tf_half,
                                                    max_batch_bytes=big, device=dev))
    geo = deskew_geometry(SHAPE, ANGLE, RATIO, False, AVG, skip_flip=True)
    coeffs = inplane_coefficients(chain_warp_matrix(reg_stab_matrix(), geo)).to(dev)
    want_b = run_chain_warp(vols_b, filt, geo, coeffs, geo.out_shape, out_layout="xzy")
    require(torch.equal(out_b[:, 0].view(torch.int32), want_b.view(torch.int32)),
            "fuse (b): differs from run_chain_warp")
    nb = vols_b.shape[0]
    want_lb = {"fwd_yx": nb, "z_filter": nb, "inv_yx": nb, "deskew_xzy": 1, "warp_zy": 1,
               "warp_x": 1}
    require(launches_b == want_lb, f"fuse (b) launches {launches_b}, want {want_lb}")
    ms_b = host_ms(lambda: fuse_arrays(vols_b[:, None], ["GFP"], chain_cfg, tf_half,
                                       max_batch_bytes=big, device=dev), reps=FUSE_REPS) / nb
    print(f"22b fuse_arrays, no fill, one matrix (reg_stab), {nb} volumes {SHAPE}: "
          f"{ms_b:.4f} ms/volume (host clock), bit-equal to run_chain_warp (xzy handoff); "
          f"launches {launches_b}; card {card}")
    del out_b, want_b

    # (c) general per-timepoint matrices: H in one union frame.
    dk_c = dict(FUSE_DESKEW, keep_overhang=False, overhang_fill=0.0)
    frame_c, _ = get_deskewed_data_shape(SHAPE, ANGLE, RATIO, False, AVG)
    tilted = {"deskew": dk_c, "stabilization": {"affine_transform_zyx_list": [
        tilted_rotation(1.0 + t, (0.3, -0.5 * t, 0.25 * t), frame_c).tolist()
        for t in range(FUSE_T)]}}
    raw_c = raw[:, :1]
    out_c, launches_c = counted(lambda: fuse_arrays(raw_c, ["GFP"], tilted, device=dev))
    with all_plain():
        plain_c = fuse_arrays(raw_c, ["GFP"], tilted, device=dev)
    _, c_err = rel_err(out_c, plain_c)
    require(c_err <= 1e-5, f"fuse (c) rel err {c_err:.3g} > 1e-5")
    want_lc = {"deskew": 1, "resample_pass": 7}
    require(launches_c == want_lc, f"fuse (c) launches {launches_c}, want {want_lc}")
    print(f"22c fuse_arrays, deskew + general per-timepoint matrices (rotations about "
          f"(1, 1, 1)), frame {tuple(frame_c)}: rel err {c_err:.3g} vs H's plain route "
          f"(tol 1e-5); launches {launches_c}")
    del out_c, plain_c

    # (d) over the budget: flat-field -> deskew (mean fill) -> warp. In
    # budget the warp reads the deskew with Y reversed and the flip folded
    # into its matrix; over it, the standard frame and the matrix as given:
    # equal maps whose float32 coordinates round apart by a few ulp in each
    # of the warp's two passes. The bound: COORD_ULPS ulp of the largest
    # coordinate, twice, times the largest step between neighbouring voxels
    # of the warp's input (the flat-fielded, deskewed, filled volume).
    over = {"flat_field": {"channel_names": ["GFP"]}, "deskew": FUSE_DESKEW,
            "stabilization": {"affine_transform_zyx_list": [
                (m_reg @ m).tolist() for m in m_stab]}}
    smooth_raw = (smooth_rand(SHAPE, gen) * 65535.0).round().to(torch.int32).to(torch.uint16)
    ulp = 2.0 ** (math.floor(math.log2(max(frame))) - 23)
    for label, raw_d in (("the users' data", raw[:1, :1]), ("smooth data", smooth_raw[None, None])):
        in_budget = fuse_arrays(raw_d, ["GFP"], over, device=dev)
        t0 = time.perf_counter()
        chunked = fuse_arrays(raw_d, ["GFP"], over, max_batch_bytes=FUSE_BUDGET, device=dev)
        over_s = time.perf_counter() - t0
        require(chunked.device.type == "cpu", "fuse (d): the over-budget result is not on the host")
        _, d_err = rel_err(chunked.to(dev), in_budget)
        warp_in = fill_overhang(deskew_zyx(flat_field_zyx(raw_d[0, 0], device=dev), ANGLE, RATIO,
                                           True, AVG, device=dev))
        step = max(float(warp_in.diff(dim=d).abs().max()) for d in range(3))
        d_tol = 2 * COORD_ULPS * ulp * step / float(in_budget.abs().max())
        del warp_in
        require(d_err <= d_tol, f"fuse (d) on {label}: rel err {d_err:.3g} > {d_tol:.3g}")
        print(f"22d fuse_arrays over the budget ({FUSE_BUDGET >> 20} MiB: flat-field in Y slabs, "
              f"deskew in X slabs, chunked fill, chunked in-plane warp), one volume of {label}: "
              f"rel err {d_err:.3g} vs in budget (tol {d_tol:.3g}), {over_s:.2f} s (host clock)")
    del smooth_raw, in_budget, chunked
    # Its stages alone: the deskew's X slabs bit-equal, the chunked fill
    # equal to the whole fill.
    dk = {"ls_angle_deg": ANGLE, "px_to_scan_ratio": RATIO, "keep_overhang": True,
          "average_window": AVG}
    # The chunk sizes the over-budget route takes at FUSE_BUDGET
    # (biahub_tpu/fuse.py:203-272, :350-356).
    vol_bytes = 4 * (z * y * x + int(np.prod(frame)))
    x_chunk = -(-x // -(-vol_bytes // FUSE_BUDGET))
    y_chunk = max(8, FUSE_BUDGET // (16 * frame[0] * frame[2]))
    w_chunk = tuple(max(32, s // -(-8 * int(np.prod(frame)) // FUSE_BUDGET)) for s in frame)
    vol = raw[0, 0].to(torch.float32)
    whole = deskew_zyx(vol, ANGLE, RATIO, True, AVG, device=dev)
    slabs = deskew_slabbed(vol.cpu(), dk, x_chunk, dev)
    require(torch.equal(slabs.to(dev), whole), "fuse (d): deskew X slabs differ from the whole")
    filled = fill_overhang(whole)
    chunk_filled = fill_overhang_chunked(slabs, "mean", y_chunk, dev).to(dev)
    require(torch.equal(chunk_filled, filled), "fuse (d): the chunked fill differs from the whole")
    # The chunked warps against the whole warps on smooth data: an in-plane
    # matrix within 1e-5, a general one within the multipass tolerance.
    # Smooth data (a box of 9 voxels twice): the tolerance the reference states
    # for the chunked multipass warp holds on smooth data.
    smooth = torch.nn.functional.avg_pool3d(smooth_rand(tuple(frame), gen)[None, None], 9, 1, 4,
                                            count_include_pad=False)[0, 0] * 1000.0
    host = smooth.cpu()
    for label, m, tol in (("in-plane", m_reg @ m_stab[1], 1e-5),
                          ("translation", np.array([[1, 0, 0, 0.4], [0, 1, 0, -3.3],
                                                    [0, 0, 1, 2.7], [0, 0, 0, 1.0]]), 1e-5),
                          ("general", tilted_rotation(1.5, (0.2, 0.4, -0.6), frame), MULTIPASS_TOL)):
        whole_w = affine_warp_auto(smooth, m, tuple(frame), device=dev)
        got_w = torch.empty(tuple(frame))

        def write(zs, ys, xs, data):
            got_w[zs, ys, xs] = data.cpu()

        chunked_affine_warp_zyx(lambda zs, ys, xs: host[zs, ys, xs], m, tuple(frame),
                                tuple(frame), w_chunk, write_fn=write, device=dev)
        got_w = got_w.to(dev)
        # The fill mask is float32 in each chunk's own coordinates, as the
        # reference's is: a voxel whose exact input coordinate lies within
        # EDGE_EPS of the volume's edge may be filled in one and sampled in
        # the other. Every such flip must lie there; the rest is compared.
        flips = (got_w == 0) != (whole_w == 0)
        near = edge_voxels(m, tuple(frame), tuple(frame), dev)
        require(not bool((flips & ~near).any()),
                f"fuse (d): chunked {label} warp's mask differs away from the edge")
        _, w_err = rel_err(got_w[~flips], whole_w[~flips])
        require(w_err <= tol, f"fuse (d): chunked {label} warp rel err {w_err:.3g} > {tol}")
        print(f"22d chunked {label} warp, chunks {w_chunk} of {tuple(frame)}: rel err "
              f"{w_err:.3g} vs the whole warp (tol {tol}); {int(flips.sum())} voxels filled in "
              f"one and not the other, each within {EDGE_EPS} of the edge")
        del got_w, whole_w, flips, near
    print(f"22d deskew X slabs of {x_chunk} bit-equal to the whole deskew, the fill in Y "
          f"slabs of {y_chunk} equal to the whole fill")
    del whole, slabs, filled, chunk_filled, smooth, host

    # (e) the deskew verb on arrays against its own X-slab route.
    vols_e = raw[:1]
    got_e, launches_e = counted(lambda: deskew_arrays(vols_e, FUSE_DESKEW, device=dev))
    require(launches_e == {"deskew": 1}, f"deskew_arrays launches {launches_e}")
    slab_e = deskew_arrays(vols_e, FUSE_DESKEW, max_batch_bytes=FUSE_BUDGET, device=dev)
    _, e_err = rel_err(slab_e.to(dev), got_e)
    require(e_err <= 1e-6, f"deskew_arrays: X-slab route rel err {e_err:.3g}")
    ms_e = host_ms(lambda: deskew_arrays(vols_e, FUSE_DESKEW, device=dev)) / vols_e[0].shape[0]
    print(f"22e deskew_arrays, example_deskew_settings.yml, {tuple(vols_e.shape)} -> "
          f"{tuple(got_e.shape)}: X-slab route within {e_err:.3g}; {ms_e:.4f} ms/volume; "
          f"launches {launches_e}")
    ff_e, launches_ff = counted(lambda: flat_field_arrays(vols_e, names, {"channel_names": None},
                                                          device=dev))
    require(launches_ff == {}, f"flat_field_arrays launched kernels: {launches_ff}")
    require(bool(torch.isfinite(ff_e).all()), "flat_field_arrays output is not finite")
    del got_e, slab_e, ff_e

    # (f) the register verb on arrays, cropped to the overlap.
    src = torch.rand((1, 1) + LAPSE_SHAPE, generator=gen, device=dev)
    tgt = torch.rand((1, 1) + LAPSE_SHAPE, generator=gen, device=dev)
    m_f = inplane_about_centre(2.0, (3.0, -4.5), LAPSE_SHAPE)
    settings_f = {"source_channel_names": ["Phase3D"], "target_channel_name": "GFP",
                  "affine_transform_zyx": m_f.tolist(), "keep_overhang": False}
    (out_f, names_f, voxel_f), launches_f = counted(lambda: register_arrays(
        src, ["Phase3D"], settings_f, (0.4, 0.116, 0.116), tgt, ["GFP"], device=dev))
    ones = affine_warp_auto(torch.ones(LAPSE_SHAPE, device=dev), m_f, LAPSE_SHAPE, device=dev)
    from biahub_tpu_torch.register import find_lir
    crop = find_lir((ones > 0).cpu().numpy())
    shape_f = tuple(s.stop - s.start for s in crop)
    require(names_f == ["GFP", "Phase3D"], f"register_arrays channels {names_f}")
    require(tuple(out_f.shape) == (1, 2) + shape_f, f"register_arrays shape {out_f.shape}")
    require(torch.equal(out_f[0, 0], tgt[0, 0][crop]), "register_arrays: the copied target differs")
    shifted = m_f.copy()
    shifted[:3, 3] += m_f[:3, :3] @ np.array([s.start for s in crop], float)
    want_f = affine_warp_auto(src[0, 0], shifted, shape_f, device=dev)
    require(torch.equal(out_f[0, 1], want_f), "register_arrays: the warped source differs")
    want_lf = {"warp_zy": 2, "warp_x": 2}
    require(launches_f == want_lf, f"register_arrays launches {launches_f}, want {want_lf}")
    print(f"22f register_arrays {LAPSE_SHAPE}, keep_overhang false: crop {shape_f} (the LIR "
          f"of the warped frame), target copied cropped, source equal to affine_warp_auto; "
          f"voxel size {np.round(voxel_f, 4).tolist()}; launches {launches_f}")


def yaml_flow(obj) -> str:
    """``obj`` as one line of YAML flow style that the port's reader (and
    PyYAML) read back as ``obj``: floats with a dot before an exponent."""
    if isinstance(obj, dict):
        return "{" + ", ".join(f"{k}: {yaml_flow(v)}" for k, v in obj.items()) + "}"
    if isinstance(obj, (list, tuple)):
        return "[" + ", ".join(yaml_flow(v) for v in obj) + "]"
    if isinstance(obj, bool):
        return "true" if obj else "false"
    if obj is None:
        return "null"
    if isinstance(obj, float):
        text = repr(obj)
        return text.replace("e", ".0e") if "e" in text and "." not in text else text
    if isinstance(obj, int):
        return str(obj)
    return json.dumps(str(obj))


def run_verb(argv: list[str]) -> tuple[float, dict, dict, str]:
    """``python -m biahub_tpu_torch.cli`` as ``cli.main(argv)`` on the card:
    its host-clock seconds, the launches it made, its runner's
    ``RUN_STATS`` and its stdout. Fails unless it returns 0."""
    from biahub_tpu_torch.cli.main import main as cli_main

    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc, launches = counted(lambda: cli_main(argv))
    seconds = time.perf_counter() - t0
    text = buf.getvalue()
    require(rc == 0, f"{' '.join(argv[:1])} verb exited {rc}")
    stats = [json.loads(line[len("RUN_STATS:"):]) for line in text.splitlines()
             if line.startswith("RUN_STATS:")]
    return seconds, launches, (stats[-1] if stats else {}), text


def fuse_plate_settings() -> tuple[tuple[int, int, int], dict]:
    """The fuse verb's settings on the plates of phases 23, 27 and 29 (22a's
    stages: flat-field on GFP, deconvolve, the example deskew, register and
    stabilize per timepoint in the plane) and their deskewed frame."""
    from biahub_tpu_torch.kernels.deskew import get_deskewed_data_shape

    frame, _ = get_deskewed_data_shape(SHAPE, ANGLE, RATIO, True, AVG)
    m_reg = inplane_about_centre(FUSE_REG_DEG, FUSE_REG_SHIFT, frame)
    return frame, {
        "flat_field": {"channel_names": ["GFP"]},
        "deconvolve": {"regularization_strength": REG}, "deskew": FUSE_DESKEW,
        "registration": {"affine_transform_zyx": m_reg.tolist()},
        "stabilization": {"affine_transform_zyx_list": [
            inplane_about_centre(0.2 * t, (0.5 * t, -0.75 * t), frame).tolist()
            for t in range(FUSE_T)]}}


def chunk_stamps(root) -> dict:
    """Modification times of the chunk files of a plate."""
    return {p: p.stat().st_mtime_ns for p in root.rglob("*")
            if p.is_file() and not p.name.startswith(".") and p.name != "zarr.json"
            and ".biahub_tpu_progress" not in p.parts}


def plates_phase(dev: torch.device, psf: np.ndarray) -> None:
    """Phase 23: the verbs on plates through the command line (module
    docstring)."""
    import shutil
    import tempfile
    from pathlib import Path

    from biahub_tpu_torch import deskew_arrays, flat_field_arrays, fuse_arrays
    from biahub_tpu_torch.device import gpu_info
    from biahub_tpu_torch.io.ngff import TransformationMeta, open_ome_zarr
    from biahub_tpu_torch.kernels.deconvolve import compute_transfer_function

    card = gpu_info()
    tmp = Path(tempfile.mkdtemp(prefix="biahub_plates_"))
    try:
        names = ["GFP", "Phase3D"]
        scale = [1.0, 1.0, FUSE_DESKEW["scan_step_um"], FUSE_DESKEW["pixel_size_um"],
                 FUSE_DESKEW["pixel_size_um"]]
        gen = torch.Generator(device=dev).manual_seed(0)
        raw = torch.randint(0, 65536, (FUSE_T, FUSE_C) + SHAPE, generator=gen, device=dev,
                            dtype=torch.int32).to(torch.uint16)
        t0 = time.perf_counter()
        plate = open_ome_zarr(tmp / "raw.zarr", layout="hcs", mode="w", channel_names=names)
        plate.create_position("A", "1", "0").create_image(
            "0", raw.cpu().numpy(), transform=[TransformationMeta(type="scale", scale=scale)])
        psf_plate = open_ome_zarr(tmp / "psf.zarr", layout="hcs", mode="w",
                                  channel_names=["PSF"])
        psf_plate.create_position("0", "0", "0").create_image(
            "0", psf[None, None], transform=[TransformationMeta(type="scale", scale=scale)])
        write_s = time.perf_counter() - t0
        frame, users = fuse_plate_settings()
        (tmp / "fuse.yml").write_text(yaml_flow(users) + "\n")
        position = str(tmp / "raw.zarr" / "A" / "1" / "0")
        out = tmp / "fused.zarr"
        argv = ["fuse", "-i", position, "-c", str(tmp / "fuse.yml"), "-o", str(out), "-p",
                str(tmp / "psf.zarr"), "--resume"]
        n_units = FUSE_T * FUSE_C
        print(f"23. plates in {tmp}: raw {FUSE_T}x{FUSE_C} uint16 {SHAPE} written in "
              f"{write_s:.2f} s by the port's writer (uncompressed OME-Zarr 0.4)")

        seconds, launches, stats, text = run_verb(argv)
        want_l = {"fwd_yx": n_units, "z_filter": n_units, "inv_yx": n_units, "deskew": 2,
                  "warp_zy": 2, "warp_x": 2}
        require(launches == want_l, f"fuse verb launches {launches}, want {want_l}")
        require(stats.get("n_units") == n_units, f"fuse verb computed {stats.get('n_units')}")
        got = open_ome_zarr(out / "A" / "1" / "0").data[...]
        t0 = time.perf_counter()
        tf = compute_transfer_function(psf, SHAPE)  # the verb's host FFT, as the reference's
        tf_s = time.perf_counter() - t0
        tf_half = torch.from_numpy(np.ascontiguousarray(tf[..., : SHAPE[2] // 2 + 1])).to(dev)
        del tf
        want = fuse_arrays(raw, names, users, tf_half, device=dev).cpu().numpy()
        require(got.shape == want.shape == (FUSE_T, FUSE_C) + tuple(frame),
                f"fuse verb shape {got.shape}, want {want.shape}")
        require(np.array_equal(got.view(np.int32), want.view(np.int32)),
                "fuse verb: the plate differs from fuse_arrays")
        del want
        arrays_ms = host_ms(lambda: fuse_arrays(raw, names, users, tf_half, device=dev),
                            reps=FUSE_REPS) / n_units
        wall = stats["wall_s"]
        keys = ("read_s", "h2d_s", "device_s", "d2h_s", "write_s")
        shares = ", ".join(f"{k[:-2]} {1e3 * stats[k] / n_units:.3f} ms/volume "
                           f"({stats[k] / wall:.1%})" for k in keys)
        print(f"23 fuse verb (cli.main, T {FUSE_T}, C {FUSE_C}, uint16 {SHAPE} -> float32 "
              f"{tuple(frame)}, 22a's settings): {1e3 * seconds / n_units:.4f} ms/volume "
              f"(host clock, the whole call: plates, transfer function, filter, runs; the "
              f"transfer function's host FFT alone {tf_s:.2f} s), the runner "
              f"{1e3 * wall / n_units:.4f} ms/volume; split of the runner's wall: {shares}; "
              f"the rest {1e3 * (wall - sum(stats[k] for k in keys)) / n_units:.3f} "
              f"ms/volume; read {stats['bytes_read'] / 2**20:.1f} MiB, written "
              f"{stats['bytes_written'] / 2**20:.1f} MiB (page cache, warm); fuse_arrays "
              f"{arrays_ms:.4f} ms/volume (host clock, {FUSE_REPS} runs, the arrays on the "
              f"card); launches {launches}; bit-equal to fuse_arrays; card {card}")

        stamps = chunk_stamps(out)
        _, launches_r, stats_r, text_r = run_verb(argv)
        require(text_r.count("Resume: skipping 2 finished units") == 2,
                "fuse --resume: the finished units were not skipped")
        require(not launches_r and not stats_r.get("n_units"),
                f"fuse --resume computed units (launches {launches_r})")
        require(stamps and chunk_stamps(out) == stamps, "fuse --resume rewrote chunks")
        require(np.array_equal(open_ome_zarr(out / "A" / "1" / "0").data[...].view(np.int32),
                               got.view(np.int32)), "fuse --resume changed the plate")
        del got
        print("23 fuse --resume: 0 units computed, no launch, the plate's chunks untouched")

        deskew_cfg = {k: v for k, v in FUSE_DESKEW.items() if k != "scan_step_um"}
        (tmp / "deskew.yml").write_text(yaml_flow(deskew_cfg) + "\n")
        seconds_d, launches_d, stats_d, _ = run_verb(
            ["deskew", "-i", position, "-c", str(tmp / "deskew.yml"), "-o",
             str(tmp / "deskewed.zarr")])
        got_d = open_ome_zarr(tmp / "deskewed.zarr" / "A" / "1" / "0").data[...]
        want_d = deskew_arrays(raw, deskew_cfg, device=dev).cpu().numpy()
        require(np.array_equal(got_d.view(np.int32), want_d.view(np.int32)),
                "deskew verb: the plate differs from deskew_arrays")
        print(f"23 deskew verb ({tuple(got_d.shape)} float32): "
              f"{1e3 * seconds_d / n_units:.4f} ms/volume (host clock), the runner "
              f"{1e3 * stats_d['wall_s'] / n_units:.4f}; bit-equal to deskew_arrays; "
              f"launches {launches_d}")
        del got_d, want_d, raw

        small = np.random.default_rng(3).random((2, 2, 16, 64, 128)).astype(np.float32)
        small_plate = open_ome_zarr(tmp / "small.zarr", layout="hcs", mode="w",
                                    channel_names=names)
        small_plate.create_position("A", "1", "0").create_image(
            "0", small, transform=[TransformationMeta(type="scale", scale=scale)])
        (tmp / "ff.yml").write_text(yaml_flow({"channel_names": ["GFP"],
                                               "output_ome_zarr_version": "0.5"}) + "\n")
        run_verb(["flat-field", "-i", str(tmp / "small.zarr" / "A" / "1" / "0"), "-c",
                  str(tmp / "ff.yml"), "-o", str(tmp / "ff.zarr")])
        ff = open_ome_zarr(tmp / "ff.zarr" / "A" / "1" / "0")
        require(ff.version == "0.5" and (tmp / "ff.zarr" / "zarr.json").exists(),
                "flat-field verb: the output is not OME-Zarr 0.5")
        want_ff = flat_field_arrays(small, names, {"channel_names": ["GFP"]},
                                    device=dev).cpu().numpy()
        require(np.array_equal(ff.data[...].view(np.int32), want_ff.view(np.int32)),
                "flat-field verb (0.5): the plate differs from flat_field_arrays")
        print("23 flat-field verb into OME-Zarr 0.5 (2x2 (16, 64, 128)): bit-equal to "
              "flat_field_arrays, read back as written")

        filtered = tmp / "filtered.zarr"
        open_ome_zarr(filtered, layout="fov", mode="w", channel_names=["a"]).create_zeros(
            "0", (1, 1, 2, 4, 4), np.float32)
        meta = json.loads((filtered / "0" / ".zarray").read_text())
        meta["filters"] = [{"id": "delta", "dtype": "<f4"}]
        (filtered / "0" / ".zarray").write_text(json.dumps(meta))
        try:
            open_ome_zarr(filtered).data[...]
            raised = ""
        except ValueError as exc:
            raised = str(exc)
        require("delta" in raised, "a v2 filter did not raise naming itself")
        print(f"23 a v2 filter raises: {raised.split(': ', 1)[-1]}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# Phase 24: reconstruct's timelapse depth (cut from T_RECON), its plate's
# scale (example_reconstruct_settings.yml's voxel size) and the patch of
# estimate-psf.
T_PLATE_RECON = 2
RECON_SCALE = [1.0, 1.0, 2.0, 0.325, 0.325]
PSF_SETTINGS = {f"axis{i}_patch_size": n for i, n in enumerate(PSF_PATCH)}


def estimate_plates_phase(dev: torch.device) -> None:
    """Phase 24: the reconstruction and estimate verbs on plates through the
    command line (module docstring)."""
    import shutil
    import tempfile
    from pathlib import Path

    from biahub_tpu_torch import (
        ArrayPosition,
        compute_transfer_function_arrays,
        estimate_psf_arrays,
        estimate_stabilization_arrays,
        optimize_registration_arrays,
        reconstruct_arrays,
        register_arrays,
    )
    from biahub_tpu_torch.cli.yaml_reader import load_file
    from biahub_tpu_torch.device import gpu_info
    from biahub_tpu_torch.estimate_registration import estimate_registration_arrays
    from biahub_tpu_torch.io.ngff import TransformationMeta, open_ome_zarr

    card = gpu_info()
    tmp = Path(tempfile.mkdtemp(prefix="biahub_estimate_"))
    phase_t0 = time.perf_counter()

    def plate(name: str, arrays: dict, names: list, scale=(1.0,) * 5) -> list[str]:
        root = open_ome_zarr(tmp / name, layout="hcs", mode="w", channel_names=names)
        for key, arr in arrays.items():
            root.create_position(*key.split("/")).create_image(
                "0", arr.cpu().numpy(),
                transform=[TransformationMeta(type="scale", scale=list(scale))])
        return [str(tmp / name / key) for key in arrays]

    def config(name: str, settings: dict) -> str:
        (tmp / name).write_text(yaml_flow(settings) + "\n")
        return str(tmp / name)

    def arrays_call(fn):
        """``fn()`` and its host-clock ms (the arrays already on the card)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

    def line(verb: str, seconds: float, arrays_ms: float, launches: dict, note: str) -> None:
        print(f"24 {verb}: {1e3 * seconds:.1f} ms for the whole call (host clock, cli.main), "
              f"its *_arrays function {arrays_ms:.1f} ms on the same arrays; {note}; "
              f"launches {launches}; card {card}")

    def launched(launches: dict, names) -> bool:
        return all(launches.get(n, 0) >= 1 for n in names)

    try:
        # -- reconstruct: compute-tf, then apply-inv-tf through the runner ---
        tfs = compute_transfer_function_arrays(LAPSE_SHAPE, RECON_SETTINGS, device=dev)
        stack = render_polarization(dev, tfs["phase"], torch.Generator(device=dev)
                                    .manual_seed(24))[0][:T_PLATE_RECON]
        del tfs
        pos = plate("pol.zarr", {"A/1/0": stack}, RECON_CHANNELS, RECON_SCALE)
        out = tmp / "recon" / "out.zarr"
        seconds, launches, stats, _ = run_verb(["reconstruct", "-i", *pos, "-c", config(
            "recon.yml", RECON_SETTINGS), "-o", str(out)])
        want_l = {"fwd_yx": T_PLATE_RECON, "z_filter_complex": T_PLATE_RECON,
                  "inv_yx": T_PLATE_RECON}
        require(launches == want_l, f"reconstruct verb launches {launches}, want {want_l}")
        got = open_ome_zarr(out / "A" / "1" / "0").data[...]
        want, arrays_ms = arrays_call(lambda: reconstruct_arrays(stack, RECON_CHANNELS,
                                                                 RECON_SETTINGS, device=dev))
        want = want.cpu().numpy()
        require(got.shape == want.shape == (T_PLATE_RECON, 5) + LAPSE_SHAPE
                and np.array_equal(got.view(np.int32), want.view(np.int32)),
                "reconstruct verb: the plate differs from reconstruct_arrays")
        wall = stats["wall_s"]
        keys = ("read_s", "h2d_s", "device_s", "d2h_s", "write_s")
        split = ", ".join(f"{k[:-2]} {1e3 * stats[k] / T_PLATE_RECON:.2f} ms/timepoint "
                          f"({stats[k] / wall:.1%})" for k in keys)
        line("reconstruct", seconds, arrays_ms, launches,
             f"T {T_PLATE_RECON} x 5 uint16 states {LAPSE_SHAPE} -> 5 float32 channels, "
             f"bit-equal to reconstruct_arrays; apply-inv-tf's runner "
             f"{1e3 * wall / T_PLATE_RECON:.2f} ms/timepoint: {split}; read "
             f"{stats['bytes_read'] / 2**20:.1f} MiB, written "
             f"{stats['bytes_written'] / 2**20:.1f} MiB (page cache, warm)")
        del stack, got, want
        shutil.rmtree(tmp / "pol.zarr")
        shutil.rmtree(tmp / "recon")

        # -- estimate-stabilization, phase-cross-corr -------------------------
        lapse, drift, _, _ = pcc_timelapse(dev)
        pos = plate("pcc.zarr", {"A/1/0": lapse}, ["Phase3D"])
        seconds, launches, _, _ = run_verb(["estimate-stabilization", "-i", *pos, "-o",
                                            str(tmp / "pcc"), "-c",
                                            config("pcc.yml", PCC_SETTINGS)])
        got = load_file(tmp / "pcc" / "xyz_stabilization_settings" / "A_1_0.yml")
        want, arrays_ms = arrays_call(lambda: estimate_stabilization_arrays(
            {"A/1/0": ArrayPosition(lapse, [1.0] * 5, ["Phase3D"])}, PCC_SETTINGS,
            device=dev)["xyz"]["A_1_0"])
        require(got["affine_transform_zyx_list"] == want,
                "estimate-stabilization (PCC) verb: transforms differ from the arrays route")
        require(np.array_equal(np.asarray(want)[:, :3, 3], drift),
                "estimate-stabilization (PCC) verb: the drift is not recovered exactly")
        require(launched(launches, ("fwd_yx", "z_cross", "inv_yx"))
                and launches["z_cross"] == T_LAPSE - 1,
                f"estimate-stabilization (PCC) verb launches {launches}")
        t0 = time.perf_counter()
        host = open_ome_zarr(pos[0]).data[:, 0]
        read_ms = 1e3 * (time.perf_counter() - t0)
        _, h2d_ms = arrays_call(lambda: torch.from_numpy(host).to(dev))
        line("estimate-stabilization (phase-cross-corr)", seconds, arrays_ms, launches,
             f"{T_LAPSE} x float32 {LAPSE_SHAPE} read from the plate, the YAML's transforms "
             f"equal to estimate_stabilization_arrays', the drift exact; apart, reading the "
             f"channel ({host.nbytes / 2**20:.0f} MiB, page cache, warm) {read_ms:.1f} ms and "
             f"its copy to the card from pageable memory {h2d_ms:.1f} ms")
        del host
        del lapse
        shutil.rmtree(tmp / "pcc.zarr")

        # -- estimate-stabilization, beads; estimate-psf ----------------------
        lapse, _ = beads_timelapse(dev)
        pos = plate("beads.zarr", {"A/1/0": lapse}, ["GFP"])
        seconds, launches, _, _ = run_verb(["estimate-stabilization", "-i", *pos, "-o",
                                            str(tmp / "beads"), "-c",
                                            config("beads.yml", BEADS_SETTINGS)])
        got = load_file(tmp / "beads" / "xyz_stabilization_settings.yml")
        want, arrays_ms = arrays_call(lambda: estimate_stabilization_arrays(
            {"A/1/0": ArrayPosition(lapse, [1.0] * 5, ["GFP"])}, BEADS_SETTINGS,
            device=dev)["xyz"]["A_1_0"])
        require(got["affine_transform_zyx_list"] == want,
                "estimate-stabilization (beads) verb: transforms differ from the arrays route")
        saved = sorted(p.name for p in (tmp / "beads" / "xyz_transforms").glob("*.npy"))
        require(saved == [f"{t}.npy" for t in range(1, T_BEADS)],
                f"estimate-stabilization (beads) verb: transform files {saved}")
        require(launched(launches, ("block_max_argmin", "resample_pass")),
                f"estimate-stabilization (beads) verb launches {launches}")
        line("estimate-stabilization (beads)", seconds, arrays_ms, launches,
             f"{T_BEADS} x float32 {LAPSE_SHAPE}, the YAML's transforms equal to "
             "estimate_stabilization_arrays', xyz_transforms/ written")
        shutil.rmtree(tmp / "beads.zarr")

        pos = plate("psf.zarr", {"0/0/0": lapse[0:1], "0/1/0": lapse[1:2]}, ["GFP"])
        seconds, launches, _, _ = run_verb(["estimate-psf", "-i", *pos, "-c", config(
            "psf.yml", PSF_SETTINGS), "-o", str(tmp / "psf_out.zarr")])
        got = open_ome_zarr(tmp / "psf_out.zarr" / "0" / "0" / "0").data[0, 0]
        want, arrays_ms = arrays_call(lambda: estimate_psf_arrays(
            lapse[:2, 0], (1.0, 1.0, 1.0), PSF_PATCH, device=dev).cpu().numpy())
        require(np.array_equal(got.view(np.int32), want.view(np.int32)),
                "estimate-psf verb: the PSF differs from estimate_psf_arrays")
        require(launches == {"block_max_argmin": 2}, f"estimate-psf verb launches {launches}")
        line("estimate-psf", seconds, arrays_ms, launches,
             f"2 positions, patch {PSF_PATCH}, bit-equal to estimate_psf_arrays")
        del lapse
        shutil.rmtree(tmp / "psf.zarr")
        shutil.rmtree(tmp / "psf_out.zarr")

        # -- estimate-registration (ants), optimize-registration, register ---
        ref, mov, truth, initial, _ = registration_pair(dev)
        src = plate("src.zarr", {"0/0/0": mov[None, None]}, ["GFP"])
        tgt = plate("tgt.zarr", {"0/0/0": ref[None, None]}, ["Phase3D"])
        ants = {"target_channel_name": "Phase3D", "source_channel_name": "GFP",
                "estimation_method": "ants",
                "affine_transform_settings": {"approx_transform": initial.tolist()}}
        estimated = tmp / "reg" / "registration.yml"
        seconds, launches, _, _ = run_verb(["estimate-registration", "-s", *src, "-t", *tgt,
                                            "-o", str(estimated), "-c",
                                            config("ants.yml", ants)])
        got = load_file(estimated)["affine_transform_zyx"]
        want, arrays_ms = arrays_call(lambda: estimate_registration_arrays(
            mov[None, None], ref[None, None], ["GFP"], ["Phase3D"], ants, [1.0] * 5,
            device=dev)["affine_transform_zyx"])
        require(got == want, "estimate-registration verb: the transform differs from "
                "estimate_registration_arrays")
        require(launched(launches, ("resample_pass", "resample_pass_deriv",
                                    "resample_pass_adjoint")),
                f"estimate-registration verb launches {launches}")
        far = float(np.abs(np.asarray(got)[:3, 3] - truth[:3, 3]).max())
        line("estimate-registration (ants)", seconds, arrays_ms, launches,
             f"one timepoint float32 {LAPSE_SHAPE}, equal to estimate_registration_arrays, "
             f"{far:.3g} voxels from the truth in the translation column")

        optimized = tmp / "reg" / "optimized.yml"
        seconds, launches, _, _ = run_verb(["optimize-registration", "-s", *src, "-t", *tgt,
                                            "-c", str(estimated), "-o", str(optimized)])
        got = np.asarray(load_file(optimized)["affine_transform_zyx"])
        start = np.asarray(load_file(estimated)["affine_transform_zyx"], np.float32)
        runs = [arrays_call(lambda: optimize_registration_arrays(
            mov[None], ref[None], start, crop=True, device=dev)) for _ in range(2)]
        (want, arrays_ms), (again, _) = runs
        run_to_run = float(np.abs(want - again).max())
        verb_err = float(np.abs(got - want).max())
        require(verb_err <= run_to_run, f"optimize-registration verb: {verb_err:.3g} from "
                f"optimize_registration_arrays, beyond its run-to-run {run_to_run:.3g}")
        require(launched(launches, ("resample_pass", "resample_pass_deriv",
                                    "resample_pass_adjoint")),
                f"optimize-registration verb launches {launches}")
        line("optimize-registration", seconds, arrays_ms, launches,
             f"crop, {verb_err:.3g} from optimize_registration_arrays (two runs of it "
             f"{run_to_run:.3g} apart)")

        registered = tmp / "registered.zarr"
        seconds, launches, _, _ = run_verb(["register", "-s", *src, "-t", *tgt, "-c",
                                            str(optimized), "-o", str(registered)])
        got = open_ome_zarr(registered / "0" / "0" / "0").data[...]
        (want, _, _), arrays_ms = arrays_call(lambda: register_arrays(
            mov[None, None], ["GFP"], load_file(optimized), (1.0, 1.0, 1.0), ref[None, None],
            ["Phase3D"], device=dev))
        want = want.cpu().numpy()
        require(got.shape == want.shape and np.array_equal(got.view(np.int32),
                                                           want.view(np.int32)),
                "register verb on the optimized YAML: the plate differs from register_arrays")
        require(launched(launches, ("resample_pass",)), f"register verb launches {launches}")
        line("register (the optimized YAML)", seconds, arrays_ms, launches,
             f"{tuple(got.shape)} float32, bit-equal to register_arrays")
        del ref, mov, got, want
        torch.cuda.empty_cache()
        print(f"24: {time.perf_counter() - phase_t0:.1f} s for the phase")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# Phase 25: the stitching and assembly plates. A 3 x 3 well of tiles at the
# pitch of settings/example_stitch_settings.yml (about 884 px in Y, 881 in
# X), each a window of one smooth random mosaic with up to STITCH_JITTER px
# of integer jitter, its stage position in the plate's micromanager
# metadata up to STAGE_ERROR px off; the three plates of the pipeline's
# assemble step in the deskewed frame; the headline FOV as a plate for the
# deconvolve verb's sharded route.
STITCH_GRID = 3
STITCH_TILE = (2, 2, 16, 1024, 1024)
STITCH_PITCH = (884, 881)
STITCH_JITTER = 3
STAGE_ERROR = 5.0
STITCH_PIXEL_UM = 0.116
STITCH_NAMES = ["GFP", "RFP"]
ASSEMBLY_TZYX = (2, 86, 1024, 897)
ASSEMBLY_PLATES = {"deskew": ["GFP", "mCherry"], "reconstruct": ["Phase3D"],
                   "virtual_stain": ["nucleus", "membrane"]}
PYRAMID_LEVELS = 4
T_SHARD_PLATE = 2


def f16_ulp(v: torch.Tensor) -> torch.Tensor:
    """``np.spacing`` of float16 values, as float32: 2**(e - 11) for |v| in
    [2**(e-1), 2**e), at least 2**-24 (the subnormals' spacing)."""
    a = v.float().abs()
    ulp = torch.ldexp(torch.ones_like(a), (torch.frexp(a).exponent - 11).clamp_min(-24))
    return torch.where(a == 0, torch.full_like(a, 2.0 ** -24), ulp)


def ulp_close(got: np.ndarray, want: np.ndarray, dev: torch.device, mask=None) -> bool:
    """``got`` within one float16 ulp of the value of ``want`` (both float16
    (T, C, ...) arrays) wherever ``mask`` (over the trailing axes) holds;
    compared on the card a (t, c) volume at a time."""
    m = None if mask is None else torch.from_numpy(mask).to(dev)
    for t, c in np.ndindex(*want.shape[:2]):
        g = torch.from_numpy(got[t, c]).to(dev)
        w = torch.from_numpy(want[t, c]).to(dev)
        ok = (g.float() - w.float()).abs() <= f16_ulp(w)
        if not bool(ok.all() if m is None else ok[..., m].all()):
            return False
    return True


def pyramid_levels_equal(pyr, levels: int, dev: torch.device) -> list:
    """Each level of ``pyr`` against the 2 x 2 float32 mean of the level
    before (as NumPy's float16 ``mean`` sums in float32; four float16 values
    of one binade or two add exactly in float32, so the order of the sum
    does not matter), cast to float16 on the card; the levels' shapes, or
    None where one differs."""
    shapes = [tuple(pyr["0"].shape[-2:])]
    for lv in range(1, levels):
        prev, level = pyr[str(lv - 1)], pyr[str(lv)]
        for t, c in np.ndindex(*prev.shape[:2]):
            p = torch.from_numpy(prev[t, c]).to(dev).float()
            y2, x2 = max(p.shape[-2] // 2, 1), max(p.shape[-1] // 2, 1)
            want = (p[:, :2 * y2, :2 * x2].reshape(p.shape[0], y2, 2, x2, 2).sum((2, 4))
                    / 4).half()
            got = torch.from_numpy(level[t, c]).to(dev)
            if got.shape != want.shape or not torch.equal(got.view(torch.int16),
                                                          want.view(torch.int16)):
                return None
        shapes.append(tuple(level.shape[-2:]))
    return shapes


def blend_kernel_names(stack: torch.Tensor, offsets: np.ndarray, padded: torch.Tensor,
                       pad, tmp) -> set:
    """The device operations of one ``blend_chunk`` call and its cast to
    float16, read from its own torch.profiler trace by
    ``summarize_device_trace``."""
    from biahub_tpu_torch.kernels.stitch_blend import blend_chunk
    from biahub_tpu_torch.runtime.profiling import summarize_device_trace

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        blend_chunk(padded, offsets, stack, 1.0, pad).to(torch.float16)
        sync()
    os.makedirs(tmp / "blend_trace", exist_ok=True)
    prof.export_chrome_trace(str(tmp / "blend_trace" / "blend.pt.trace.json.gz"))
    return {name for name, _, _ in summarize_device_trace(str(tmp / "blend_trace"),
                                                          file=io.StringIO())}


def assembly_plates_phase(dev: torch.device, psf: np.ndarray) -> None:
    """Phase 25: estimate-stitch, stitch, concatenate, flip, pyramid and the
    deconvolve verb's sharded route on plates (module docstring)."""
    import shutil
    import tempfile
    from pathlib import Path

    from biahub_tpu_torch import ArrayPosition, Mesh, deconvolve_arrays
    from biahub_tpu_torch.cli.yaml_reader import load_file
    from biahub_tpu_torch.deconvolve import deconvolve
    from biahub_tpu_torch.device import gpu_info
    from biahub_tpu_torch.io.ngff import TransformationMeta, open_ome_zarr
    from biahub_tpu_torch.kernels.stitch_blend import pad_distance_map
    from biahub_tpu_torch.runtime.profiling import summarize_device_trace
    from biahub_tpu_torch.stitch import CARD_CHUNKS, chunk_stack, fov_edge_distance

    card = gpu_info()
    tmp = Path(tempfile.mkdtemp(prefix="biahub_assembly_"))
    phase_t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(25)
    rng = np.random.default_rng(25)
    saved_env = {k: os.environ.get(k) for k in ("BIAHUB_TPU_PROFILE", "BIAHUB_TPU_HOST_BLEND",
                                                 "BIAHUB_TPU_SHARDED_FFT")}

    def set_env(name: str, value: str | None) -> None:
        if value is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = value

    def line(verb: str, seconds: float, note: str) -> None:
        print(f"25 {verb}: {1e3 * seconds:.1f} ms for the whole call (host clock); {note}; "
              f"card {card}; {time.perf_counter() - phase_t0:.1f} s into the phase")

    try:
        # -- the tiles of one well, cut from one mosaic ----------------------
        T, C, Z, TY, TX = STITCH_TILE
        n = STITCH_GRID
        grid = [(r, c) for r in range(n) for c in range(n)]
        jitter = rng.integers(-STITCH_JITTER, STITCH_JITTER + 1, (n, n, 2))
        offsets = {(r, c): np.array([r * STITCH_PITCH[0], c * STITCH_PITCH[1]]) + jitter[r, c]
                   for r, c in grid}
        low = np.min(list(offsets.values()), axis=0)
        offsets = {k: v - low for k, v in offsets.items()}
        extent = tuple(int(v) for v in np.max(list(offsets.values()), axis=0) + (TY, TX))
        mosaic = torch.stack([smooth_rand((Z,) + extent, gen) for _ in range(T * C)]).view(
            (T, C, Z) + extent).cpu().numpy()
        names = [f"A/1/{r:03d}{c:03d}" for r, c in grid]
        scale = [1.0, 1.0, 1.0, STITCH_PIXEL_UM, STITCH_PIXEL_UM]
        t0 = time.perf_counter()
        plate = open_ome_zarr(tmp / "tiles.zarr", layout="hcs", mode="w",
                              channel_names=STITCH_NAMES)
        entries = []
        for (r, c), name in zip(grid, names):
            y, x = offsets[(r, c)]
            plate.create_position("A", "1", f"{r:03d}{c:03d}").create_image(
                "0", mosaic[..., y:y + TY, x:x + TX],
                transform=[TransformationMeta(type="scale", scale=scale)])
            sy, sx = (offsets[(r, c)] + rng.uniform(-STAGE_ERROR, STAGE_ERROR, 2)) * \
                STITCH_PIXEL_UM
            entries.append({"Label": name, "DefaultXYStage": "XYStage", "DevicePositions": [
                {"Device": "XYStage", "Position_um": [float(sx), float(sy)]},
                {"Device": "ZStage", "Position_um": [12.5]}]})
        plate.update_zattrs({"Summary": {"StagePositions": entries}})
        inputs = [str(tmp / "tiles.zarr" / name) for name in names]
        print(f"25. plates in {tmp}: a {n}x{n} well of {STITCH_TILE} float32 tiles (mosaic "
              f"{extent}, pitch {STITCH_PITCH}, jitter up to {STITCH_JITTER} px, stage "
              f"metadata up to {STAGE_ERROR} px off) written in {time.perf_counter() - t0:.2f} "
              "s by the port's writer")

        # -- estimate-stitch with the strips' PCC -----------------------------
        est = tmp / "estimated.yml"
        seconds, _, _, _ = run_verb(["estimate-stitch", "-i", *inputs, "-o", str(est),
                                     "--pcc-channel-name", STITCH_NAMES[0]])
        table = load_file(est)["total_translation"]
        placed = np.array([table[name][1:] for name in names]) - table[names[0]][1:]
        true = np.array([offsets[k] for k in grid]) - offsets[(0, 0)]
        worst = float(np.abs(placed - true).max())
        require(worst <= 1.0, f"estimate-stitch: a tile {worst:.3g} px from its true offset")
        line("estimate-stitch (--pcc-channel-name)", seconds,
             f"{len(names)} tiles, {2 * n * (n - 1)} strip correlations, every tile within "
             f"{worst:.3g} px of its true offset relative to tile 0")

        # -- stitch on the true offsets: the card, the host route, traced ----
        true_yaml = tmp / "true.yml"
        true_yaml.write_text(yaml_flow({"total_translation": {
            name: [0.0, float(offsets[k][0]), float(offsets[k][1])]
            for k, name in zip(grid, names)}}) + "\n")
        argv = ["stitch", "-i", *inputs, "-c", str(true_yaml), "-b", "1.0", "-o"]
        torch.cuda.empty_cache()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        seconds, _, _, text = run_verb(argv + [str(tmp / "card.zarr")])
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        stats = [json.loads(x[len("STITCH_STATS:"):]) for x in text.splitlines()
                 if x.startswith("STITCH_STATS:")][-1]
        got = open_ome_zarr(tmp / "card.zarr" / "A" / "1" / "0").data[...]
        require(got.shape == (T, C, Z) + extent and got.dtype == np.float16,
                f"stitch: mosaic {got.shape} {got.dtype}")
        cover = np.zeros(extent, bool)
        for y, x in offsets.values():
            cover[y + 1:y + TY - 1, x + 1:x + TX - 1] = True
        truth16 = mosaic.astype(np.float16)
        require(ulp_close(got, truth16, dev, cover),
                "stitch: the mosaic differs from the true mosaic by more than a float16 ulp")
        require(not np.any(got[..., ~cover]), "stitch: voxels of no tile's weight are not 0")
        keys = ("read_s", "stack_s", "h2d_s", "blend_s", "d2h_s", "write_s")
        split = ", ".join(f"{k[:-2]} {1e3 * stats[k]:.1f} ms" for k in keys)
        line("stitch (card blend, -b 1.0)", seconds,
             f"mosaic {got.shape} float16 within one float16 ulp of the truth wherever a tile "
             f"weighs, 0 elsewhere ({int((~cover).sum())} px a plane); the workers' sums "
             f"({stats['workers']} workers, {stats['chunks']} chunks): {split}; well wall "
             f"{1e3 * stats['wall_s']:.1f} ms; read and sent to the card "
             f"{stats['bytes_read'] / 2**30:.3f} GiB, written "
             f"{stats['bytes_written'] / 2**30:.3f} GiB (page cache, warm); peak card memory "
             f"{peak / 2**30:.2f} GiB (at most {CARD_CHUNKS} chunk stacks on the card)")

        set_env("BIAHUB_TPU_HOST_BLEND", "1")
        seconds_h, _, _, text_h = run_verb(argv + [str(tmp / "host.zarr")])
        set_env("BIAHUB_TPU_HOST_BLEND", saved_env["BIAHUB_TPU_HOST_BLEND"])
        stats_h = [json.loads(x[len("STITCH_STATS:"):]) for x in text_h.splitlines()
                   if x.startswith("STITCH_STATS:")][-1]
        host = open_ome_zarr(tmp / "host.zarr" / "A" / "1" / "0").data[...]
        require(ulp_close(got, host, dev) and ulp_close(host, got, dev),
                "stitch: the card's blend differs from the host route by more than a float16 ulp")
        line("stitch (BIAHUB_TPU_HOST_BLEND=1)", seconds_h,
             f"within one float16 ulp of the card's blend; the workers' reads "
             f"{1e3 * stats_h['read_s']:.1f} ms, NumPy blend {1e3 * stats_h['blend_s']:.1f} ms, "
             f"writes {1e3 * stats_h['write_s']:.1f} ms")
        del host

        set_env("BIAHUB_TPU_PROFILE", str(tmp / "trace"))
        seconds_p, _, _, _ = run_verb(argv + [str(tmp / "traced.zarr")])
        set_env("BIAHUB_TPU_PROFILE", saved_env["BIAHUB_TPU_PROFILE"])
        rows = summarize_device_trace(str(tmp / "trace"), file=io.StringIO())
        traced = open_ome_zarr(tmp / "traced.zarr" / "A" / "1" / "0").data[...]
        require(np.array_equal(traced.view(np.int16), got.view(np.int16)),
                "stitch under the profiler differs from the untraced run")
        chunk0 = (slice(0, Z), slice(0, TY), slice(0, TX))
        shifts = {name: [0.0, float(offsets[k][0]), float(offsets[k][1])]
                  for k, name in zip(grid, names)}
        offs, stack = chunk_stack(chunk0, shifts, np.arange(C), open_ome_zarr(tmp / "tiles.zarr"),
                                  STITCH_TILE, dev)
        padded = pad_distance_map(fov_edge_distance((Z, TY, TX)), (Z, TY, TX), dev)
        blend_ops = blend_kernel_names(stack, offs, padded, (Z, TY, TX), tmp)
        del stack, padded
        table_names = {name for name, _, _ in rows}
        require(blend_ops and blend_ops <= table_names,
                f"stitch trace: the blend's operations {sorted(blend_ops - table_names)} are "
                "not in its device table")
        print(f"25 stitch under BIAHUB_TPU_PROFILE=<dir>: {1e3 * seconds_p:.1f} ms for the "
              f"whole call (host clock), bit-equal to the untraced run; the blend's "
              f"{len(blend_ops)} device operations (one blend_chunk of chunk 0 traced alone) "
              f"all in the verb's table; device time by op, top 15:")
        for name, ms, count in rows[:15]:
            print(f"25   {ms:10.3f} ms  x{count:4d}  {name[:100]}")
        shutil.rmtree(tmp / "trace")
        shutil.rmtree(tmp / "traced.zarr")
        shutil.rmtree(tmp / "host.zarr")
        shutil.rmtree(tmp / "tiles.zarr")
        del mosaic, truth16, traced

        # -- flip and pyramid on a copy of the mosaic --------------------------
        shutil.copytree(tmp / "card.zarr", tmp / "flip.zarr")
        flip_pos = str(tmp / "flip.zarr" / "A" / "1" / "0")
        seconds, _, _, _ = run_verb(["flip", "-i", flip_pos, "-x"])
        flipped = open_ome_zarr(flip_pos).data[...]
        require(np.array_equal(flipped.view(np.int16), got[..., ::-1].view(np.int16)),
                "flip -x: the plate differs from NumPy's flip")
        line("flip -x", seconds, f"{got.nbytes / 2**30:.3f} GiB float16 read and written in "
             "place, bit-equal to NumPy's flip")
        del got, flipped
        seconds, _, _, _ = run_verb(["pyramid", "-i", flip_pos, "--levels",
                                     str(PYRAMID_LEVELS)])
        pyr = open_ome_zarr(flip_pos)
        require(pyr.array_names() == [str(lv) for lv in range(PYRAMID_LEVELS)],
                f"pyramid: arrays {pyr.array_names()}")
        shapes = pyramid_levels_equal(pyr, PYRAMID_LEVELS, dev)
        require(shapes is not None, "pyramid: a level differs from the 2x2 mean of the one "
                "before")
        line(f"pyramid --levels {PYRAMID_LEVELS}", seconds,
             f"levels {shapes} bit-equal to the cascade of 2x2 means (float32 sums)")
        del pyr
        shutil.rmtree(tmp / "flip.zarr")
        shutil.rmtree(tmp / "card.zarr")

        # -- the assemble step: resolve mode, then --cluster debug --resume ----
        t0 = time.perf_counter()
        sources = {}
        for name, channels in ASSEMBLY_PLATES.items():
            src = open_ome_zarr(tmp / f"{name}.zarr", layout="hcs", mode="w",
                                channel_names=channels)
            arr = torch.rand((ASSEMBLY_TZYX[0], len(channels)) + ASSEMBLY_TZYX[1:],
                             generator=gen, device=dev).cpu().numpy()
            src.create_position("A", "1", "0").create_image(
                "0", arr, transform=[TransformationMeta(type="scale",
                                                        scale=[1.0, 1.0, 0.2, 0.116, 0.116])])
            sources[name] = arr
        write_s = time.perf_counter() - t0
        template = tmp / "concat.yml"
        template.write_text(yaml_flow({"concat_data_paths": ["placeholder"],
                                       "time_indices": "all",
                                       "channel_names": ["all"] * len(ASSEMBLY_PLATES)}) + "\n")
        resolved = tmp / "resolved.yml"
        seconds_r, _, _, _ = run_verb(
            ["concatenate", "-c", str(template), "-o", str(resolved)]
            + [a for name in ASSEMBLY_PLATES for a in ("--concat-data-paths",
                                                       str(tmp / f"{name}.zarr/*/*/*"))])
        require(load_file(resolved)["concat_data_paths"] == [
            str(tmp / f"{name}.zarr/*/*/*") for name in ASSEMBLY_PLATES],
            "concatenate resolve mode: the paths were not injected")
        out = tmp / "assembled.zarr"
        argv_c = ["concatenate", "--cluster", "debug", "--resume", "-c", str(resolved), "-o",
                  str(out)]
        seconds, _, _, _ = run_verb(argv_c)
        assembled = open_ome_zarr(out / "A" / "1" / "0")
        channels = [ch for chs in ASSEMBLY_PLATES.values() for ch in chs]
        require(assembled.version == "0.5" and assembled.channel_names == channels,
                f"concatenate: version {assembled.version}, channels {assembled.channel_names}")
        c_out = 0
        for name, arr in sources.items():
            for c in range(arr.shape[1]):
                require(np.array_equal(assembled.data[:, c_out].view(np.int32),
                                       arr[:, c].view(np.int32)),
                        f"concatenate: channel {channels[c_out]} differs from {name}'s")
                c_out += 1
        nbytes = sum(a.nbytes for a in sources.values())
        stamps = chunk_stamps(out)
        seconds_2, _, _, _ = run_verb(argv_c)
        require(stamps and chunk_stamps(out) == stamps, "concatenate --resume rewrote chunks")
        line("concatenate (assemble step: --cluster debug --resume into OME-Zarr 0.5)", seconds,
             f"{len(ASSEMBLY_PLATES)} plates (T {ASSEMBLY_TZYX[0]}, {ASSEMBLY_TZYX[1:]} float32, "
             f"written in {write_s:.2f} s), {c_out} channels bit-equal to the inputs; "
             f"{nbytes / 2**30:.3f} GiB read and written: {nbytes / 1e9 / seconds:.3f} GB/s "
             f"each way (page cache, warm); resolve mode {1e3 * seconds_r:.1f} ms; a second "
             f"--resume {1e3 * seconds_2:.1f} ms, nothing written")
        del sources, assembled
        for name in ASSEMBLY_PLATES:
            shutil.rmtree(tmp / f"{name}.zarr")
        shutil.rmtree(out)

        # -- the deconvolve verb's sharded route on a plate --------------------
        vols = torch.rand((T_SHARD_PLATE, 1) + SHAPE, generator=gen, device=dev).cpu().numpy()
        dscale = [1.0, 1.0, 0.2, 0.116, 0.116]
        raw = open_ome_zarr(tmp / "raw.zarr", layout="hcs", mode="w", channel_names=["GFP"])
        raw.create_position("A", "1", "0").create_image(
            "0", vols, transform=[TransformationMeta(type="scale", scale=dscale)])
        psf_plate = open_ome_zarr(tmp / "psf.zarr", layout="hcs", mode="w",
                                  channel_names=["PSF"])
        psf_plate.create_position("0", "0", "0").create_image(
            "0", psf[None, None], transform=[TransformationMeta(type="scale", scale=dscale)])
        (tmp / "decon.yml").write_text(yaml_flow({"regularization_strength": REG}) + "\n")
        position = tmp / "raw.zarr" / "A" / "1" / "0"
        mesh = Mesh.virtual(dev, SHARD_N)
        set_env("BIAHUB_TPU_SHARDED_FFT", "1")
        buf = io.StringIO()
        sync()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            _, launches = counted(lambda: deconvolve(
                [position], tmp / "psf.zarr", tmp / "decon.yml", tmp / "sharded" / "out.zarr",
                device=dev, mesh=mesh))
        seconds_s = time.perf_counter() - t0
        set_env("BIAHUB_TPU_SHARDED_FFT", saved_env["BIAHUB_TPU_SHARDED_FFT"])
        require(f"sharded over {SHARD_N} local devices" in buf.getvalue(),
                "deconvolve verb: the sharded route was not taken")
        want_l = {k: SHARD_N * T_SHARD_PLATE for k in ("fwd_yx", "z_filter", "inv_yx")}
        require(launches == want_l, f"sharded deconvolve verb launches {launches}, "
                f"want {want_l}")
        got = open_ome_zarr(tmp / "sharded" / "out.zarr" / "A" / "1" / "0").data[...]
        want = deconvolve_arrays({"A/1/0": ArrayPosition(vols, dscale, ["GFP"])}, psf, dscale,
                                 {"regularization_strength": REG}, mesh=mesh, sharded=True,
                                 device=dev)[0]["A/1/0"].cpu().numpy()
        require(np.array_equal(got.view(np.int32), want.view(np.int32)),
                "sharded deconvolve verb: the plate differs from deconvolve_arrays(sharded=True)")
        seconds_b, launches_b, _, _ = run_verb(
            ["deconvolve", "-i", str(position), "-p", str(tmp / "psf.zarr"), "-c",
             str(tmp / "decon.yml"), "-o", str(tmp / "batched" / "out.zarr")])
        batched = open_ome_zarr(tmp / "batched" / "out.zarr" / "A" / "1" / "0").data[...]
        err = float(np.abs(got - batched).max() / np.abs(batched).max())
        require(err <= FFT_TOL, f"sharded deconvolve verb: rel err {err:.3g} from the batched "
                f"verb > {FFT_TOL}")
        line(f"deconvolve (BIAHUB_TPU_SHARDED_FFT=1, Mesh.virtual({dev}, {SHARD_N}))",
             seconds_s, f"T {T_SHARD_PLATE} x float32 {SHAPE}: "
             f"{1e3 * seconds_s / T_SHARD_PLATE:.1f} ms/volume against the batched verb's "
             f"{1e3 * seconds_b / T_SHARD_PLATE:.1f} ms/volume (both whole calls: plates, "
             f"transfer function, runs); bit-equal to deconvolve_arrays(sharded=True), rel "
             f"err {err:.3g} from the batched verb (tol {FFT_TOL}); launches {launches} "
             f"({SHARD_N} each a volume), the batched verb's {launches_b}")
        del vols, got, want, batched
        print(f"25: {time.perf_counter() - phase_t0:.1f} s for the phase")
    finally:
        for name, value in saved_env.items():
            set_env(name, value)
        shutil.rmtree(tmp, ignore_errors=True)


# Phase 26: the model verbs. The example settings' UNeXt2 (fcmae), on the
# deskewed FOV that reconstruct feeds it; cellpose's default CPnet width on
# two channels of 8 slices, rescaled by SEG_DIAMETER; a rendered time-lapse
# of moving nuclei for track.
T_STAIN = 2
STAIN_MODEL = {"in_channels": 1, "out_channels": 2, "in_stack_depth": 15,
               "encoder_blocks": [3, 3, 9, 3], "dims": [96, 192, 384, 768],
               "decoder_conv_blocks": 2, "stem_kernel_size": [5, 4, 4]}
STAIN_OUTPUTS = ["nuclei_prediction", "membrane_prediction"]
# max |card - CPU float32| / max |CPU float32| of one window (and of CPnet's
# output on one slice) under BIAHUB_TPU_MODEL_PRECISION=highest and default.
MODEL_HIGHEST_TOL = 1e-4
MODEL_DEFAULT_TOL = 1e-2
SEG_TCZYX = (1, 2, 8, 1024, 484)
SEG_DIAMETER = 40.0
CPNET_WIDTH = (2, 32, 64, 128, 256)
# The flow round trip: slices of rendered instance masks.
ROUND_TRIP_Z = 4
TRACK_TYX = (8, 1024, 484)
TRACK_NUCLEI = (10, 4)  # a grid of rows x columns of nuclei
TRACK_SCALE = [1.0, 1.0, 1.0, 0.325, 0.325]
# The wiring run's stack: the track run's frames repeated over this depth.
WIRING_DEPTH = 5


def label_mismatch(a: np.ndarray, b: np.ndarray) -> int:
    """Pixels where two label images disagree up to a permutation of ids:
    each label of ``a`` maps to the label of ``b`` it overlaps most, and
    the other way; the larger count of pixels off that map."""
    def one_way(p, q):
        pairs, counts = np.unique(np.stack([p.ravel(), q.ravel()]), axis=1, return_counts=True)
        best = {}
        for (i, j), n in zip(pairs.T.tolist(), counts.tolist()):
            if n > best.get(i, (None, -1))[1]:
                best[i] = (j, n)
        return int(p.size - sum(n for _, n in best.values()))
    return max(one_way(a, b), one_way(b, a))


def render_masks(shape, rng: np.random.Generator) -> np.ndarray:
    """(Z, Y, X) uint32 instance masks: per slice, ellipses on a jittered
    48 px grid, radii 10 to 18 px, no two overlapping."""
    Z, Y, X = shape
    yy, xx = np.mgrid[:Y, :X]
    out = np.zeros(shape, np.uint32)
    for z in range(Z):
        label = 0
        for cy in range(24, Y - 24, 48):
            for cx in range(24, X - 24, 48):
                ry, rx = rng.uniform(10, 18, 2)
                py, px = cy + rng.uniform(-3, 3), cx + rng.uniform(-3, 3)
                window = (slice(int(py - ry - 1), int(py + ry + 2)),
                          slice(int(px - rx - 1), int(px + rx + 2)))
                inside = (((yy[window] - py) / ry) ** 2 + ((xx[window] - px) / rx) ** 2) < 1
                label += 1
                out[z][window][inside] = label
    return out


def moving_nuclei(rng: np.random.Generator):
    """(T, Y, X) float32 nuclei predictions in [0, 1] (Gaussian blobs of
    sigma 6 px) moving in straight lines, and their centres (T, N, 2)."""
    T, Y, X = TRACK_TYX
    rows, cols = TRACK_NUCLEI
    start = np.array([(Y * (r + 0.5) / rows, X * (c + 0.5) / cols)
                      for r in range(rows) for c in range(cols)])
    start += rng.uniform(-8, 8, start.shape)
    velocity = rng.uniform(-3, 3, start.shape)
    centres = start[None] + np.arange(T)[:, None, None] * velocity[None]
    yy, xx = np.mgrid[:Y, :X]
    frames = np.zeros((T, Y, X), np.float32)
    for t in range(T):
        for cy, cx in centres[t]:
            window = (slice(max(int(cy) - 30, 0), int(cy) + 31),
                      slice(max(int(cx) - 30, 0), int(cx) + 31))
            blob = np.exp(-((yy[window] - cy) ** 2 + (xx[window] - cx) ** 2) / (2 * 6.0 ** 2))
            frames[t][window] = np.maximum(frames[t][window], blob)
    return frames, centres


def model_plates_phase(dev: torch.device) -> None:
    """Phase 26: virtual-stain, segment and track on plates through the
    command line (module docstring)."""
    import shutil
    import tempfile
    from pathlib import Path

    import torch.nn.functional as F

    from biahub_tpu_torch.cli.yaml_reader import load_file
    from biahub_tpu_torch.device import gpu_info
    from biahub_tpu_torch.io.ngff import TransformationMeta, open_ome_zarr
    from biahub_tpu_torch.models import model_precision
    from biahub_tpu_torch.models.convert import (
        load_cpnet_checkpoint,
        load_into,
        load_torch_checkpoint,
    )
    from biahub_tpu_torch.models.cpnet import CPnet
    from biahub_tpu_torch.models.unext2 import UNeXt2
    from biahub_tpu_torch.segment import threshold_instance_labels
    from biahub_tpu_torch.segmentation.engine import (
        _assemble_channels,
        _normalize,
        cpnet_segment_czyx,
        load_engine,
    )
    from biahub_tpu_torch.segmentation.flows import (
        compute_masks_zyx,
        follow_flows,
        masks_to_flows,
    )
    from biahub_tpu_torch.track import run_preprocessing_pipeline
    from biahub_tpu_torch.tracking.engine import track_from_foreground_contour
    from biahub_tpu_torch.virtual_stain import load_model, normalize_with_stats, predict_timepoint

    card = gpu_info()
    tmp = Path(tempfile.mkdtemp(prefix="biahub_models_"))
    phase_t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(26)
    rng = np.random.default_rng(26)
    saved_precision = os.environ.get("BIAHUB_TPU_MODEL_PRECISION")

    def set_precision(mode: str | None) -> None:
        if mode is None:
            os.environ.pop("BIAHUB_TPU_MODEL_PRECISION", None)
        else:
            os.environ["BIAHUB_TPU_MODEL_PRECISION"] = mode

    def line(verb: str, text: str) -> None:
        print(f"26 {verb}: {text}; card {card}; {time.perf_counter() - phase_t0:.1f} s into "
              "the phase")

    def peak_reset() -> None:
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)

    def peak_gib() -> float:
        return torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else 0.0

    def position(plate: Path) -> str:
        return str(plate / "A" / "1" / "0")

    try:
        set_precision(None)
        # -- virtual-stain: the example settings' UNeXt2 at full width --------
        Z, Y, X = LAPSE_SHAPE
        phase = torch.stack([smooth_rand(LAPSE_SHAPE, gen) for _ in range(T_STAIN)]).cpu().numpy()
        recon = tmp / "reconstruct.zarr"
        plate = open_ome_zarr(recon, layout="hcs", mode="w", channel_names=["Phase3D"])
        plate.create_position("A", "1", "0").create_image(
            "0", phase[:, None], transform=[TransformationMeta(type="scale", scale=RECON_SCALE)])
        torch.manual_seed(26)
        net = UNeXt2(**STAIN_MODEL)
        with torch.no_grad():
            for name, p in net.named_parameters():
                if name.endswith(("grn.gamma", "grn.beta")):
                    p.uniform_(-0.5, 0.5)
        ckpt = tmp / "unext2.pth"
        torch.save(net.state_dict(), ckpt)
        config = {"architecture": "fcmae", "model_config": STAIN_MODEL, "ckpt_path": str(ckpt),
                  "source_channel": "Phase3D", "output_channels": STAIN_OUTPUTS,
                  "sliding_window_step": 1, "rotation_tta": False}
        cfg = tmp / "virtual_stain.yml"
        cfg.write_text(yaml_flow(config) + "\n")
        stain = tmp / "virtual_stain.zarr"
        peak_reset()
        seconds, _, _, _ = run_verb(["virtual-stain", "-i", position(recon), "-c", str(cfg),
                                     "-o", str(stain)])
        peak = peak_gib()
        got = open_ome_zarr(position(stain), mode="r").data[...]
        require(got.shape == (T_STAIN, 2, Z, Y, X) and got.dtype == np.float32
                and bool(np.isfinite(got).all()), f"virtual-stain: output {got.shape} {got.dtype}")
        model = load_model(config, dev)
        for t in range(T_STAIN):
            sync()
            t0 = time.perf_counter()
            arrays = predict_timepoint(phase[t][None], ["Phase3D"], config, model, None, dev)
            per_timepoint = time.perf_counter() - t0
            require(np.array_equal(arrays, got[t]),
                    f"virtual-stain: timepoint {t} differs from predict_timepoint on the card")
        window = torch.from_numpy(normalize_with_stats(phase[0], None)[None]).to(dev)[:, :15]
        window_ms = time_ms(lambda: model[0](window))
        windows = Z - 15 + 1
        tta_config = dict(config, rotation_tta=True)
        sync()
        t0 = time.perf_counter()
        tta = predict_timepoint(phase[0][None], ["Phase3D"], tta_config, model, None, dev)
        tta_seconds = time.perf_counter() - t0
        require(bool(np.isfinite(tta).all()) and not np.array_equal(tta, got[0]),
                "virtual-stain: rotation TTA")
        line("virtual-stain", f"{T_STAIN} x {LAPSE_SHAPE} Phase3D through UNeXt2 "
             f"{STAIN_MODEL['dims']} / {STAIN_MODEL['encoder_blocks']} (stem "
             f"{STAIN_MODEL['stem_kernel_size']}, depth 15, step 1: {windows} windows a "
             f"timepoint, Y, X padded to {Y - Y % -32}, {X - X % -32}), "
             f"BIAHUB_TPU_MODEL_PRECISION default: "
             f"{1e3 * seconds:.1f} ms for the whole call (host clock), "
             f"{1e3 * per_timepoint:.1f} ms a timepoint (predict_timepoint, host clock), "
             f"{window_ms:.3f} ms a window (CUDA events), peak card memory {peak:.2f} GiB; "
             f"the plate bit-equal to predict_timepoint at every timepoint; rotation TTA on "
             f"one timepoint {1e3 * tta_seconds:.1f} ms ({4 * windows} windows)")
        pad_x = -X % 32
        padded = F.pad(window[None], (0, pad_x, 0, -Y % 32, 0, 0), mode="replicate")
        cpu_net = load_into(UNeXt2(**STAIN_MODEL), load_torch_checkpoint(str(ckpt))).eval()
        t0 = time.perf_counter()
        with torch.no_grad():
            ref = cpu_net(padded.cpu())
        cpu_seconds = time.perf_counter() - t0
        dev_net = load_into(UNeXt2(**STAIN_MODEL), load_torch_checkpoint(str(ckpt))).to(dev).eval()
        errs = {}
        for mode in ("highest", "default"):
            set_precision(mode)
            with model_precision():
                out = dev_net(padded)
            errs[mode] = rel_err(out.cpu(), ref)[1]
            window_mode_ms = time_ms(lambda: model[0](window))
            line("virtual-stain precision", f"{mode}: one full-width window "
                 f"{tuple(padded.shape)} within {errs[mode]:.3g} x max|ref| of the CPU float32 "
                 f"run ({1e3 * cpu_seconds:.0f} ms on the host), {window_mode_ms:.3f} ms a window")
        set_precision(None)
        require(errs["highest"] <= MODEL_HIGHEST_TOL,
                f"virtual-stain: highest {errs['highest']:.3g} > {MODEL_HIGHEST_TOL}")
        require(errs["default"] <= MODEL_DEFAULT_TOL,
                f"virtual-stain: default {errs['default']:.3g} > {MODEL_DEFAULT_TOL}")
        del model, dev_net, cpu_net, window, padded, ref, out, arrays, tta, got
        peak_reset()

        # -- segment: threshold_otsu and a CPnet at cellpose's default width --
        T, C, Zs, Ys, Xs = SEG_TCZYX
        seg_data = torch.stack([smooth_rand((Zs, Ys, Xs), gen, width=5)
                                for _ in range(T * C)]).view(
            SEG_TCZYX).cpu().numpy()
        seg_in = tmp / "seg_in.zarr"
        plate = open_ome_zarr(seg_in, layout="hcs", mode="w", channel_names=["nuclei", "membrane"])
        plate.create_position("A", "1", "0").create_image(
            "0", seg_data, transform=[TransformationMeta(type="scale", scale=RECON_SCALE)])
        torch.manual_seed(27)
        cp = CPnet(nbase=CPNET_WIDTH)
        with torch.no_grad():
            for m in cp.modules():
                if isinstance(m, torch.nn.BatchNorm2d):
                    m.running_mean.uniform_(-0.5, 0.5)
                    m.running_var.uniform_(0.5, 2.0)
        cp_ckpt = tmp / "cpnet.pt"
        torch.save(cp.state_dict(), cp_ckpt)
        # CPnet's output on one slice against the host's float32 run; its
        # median cell probability is the verb's threshold, so that random
        # weights still give foreground to follow.
        x = _normalize(_assemble_channels(seg_data[0][:, :1], (1, 2), 2))
        x = F.pad(torch.from_numpy(x), (0, -Xs % 16, 0, -Ys % 16), mode="replicate")
        cpu_cp = load_into(CPnet(nbase=CPNET_WIDTH), load_cpnet_checkpoint(str(cp_ckpt))[0]).eval()
        with torch.no_grad():
            ref = cpu_cp(x)[0]
        threshold = round(float(ref[0, 2].median()), 4)
        dev_cp = load_engine(str(cp_ckpt), str(dev))[0]
        notes = []
        for mode, tol in (("highest", MODEL_HIGHEST_TOL), ("default", MODEL_DEFAULT_TOL)):
            set_precision(mode)
            with model_precision():
                out = dev_cp(x.to(dev))[0]
            err = rel_err(out.cpu(), ref)[1]
            notes.append(f"{mode} within {err:.3g} x max|ref| (tol {tol}), "
                         f"{time_ms(lambda: dev_cp(x.to(dev))):.3f} ms a slice")
            require(err <= tol, f"segment: CPnet {mode} error {err:.3g} > {tol}")
        set_precision(None)
        line("segment precision", f"CPnet's output on one slice {tuple(x.shape)} against the "
             f"CPU float32 run: {'; '.join(notes)} (CUDA events)")
        del dev_cp, cpu_cp, ref, out, x

        eval_args = {"channels": [1, 2], "diameter": SEG_DIAMETER, "flow_threshold": None,
                     "cellprob_threshold": threshold}
        seg_cfg = tmp / "segment.yml"
        seg_cfg.write_text(yaml_flow({"models": {
            "nuclei": {"path_to_model": "threshold_otsu", "eval_args": {"min_size": 20},
                       "preprocessing": []},
            "cells": {"path_to_model": str(cp_ckpt), "eval_args": eval_args,
                      "preprocessing": []}}}) + "\n")
        seg_out = tmp / "segment.zarr"
        peak_reset()
        seconds, _, _, _ = run_verb(["segment", "-i", position(seg_in), "-c", str(seg_cfg),
                                     "-o", str(seg_out)])
        peak = peak_gib()
        labels = open_ome_zarr(position(seg_out), mode="r").data[...]
        require(labels.shape == (T, 2, Zs, Ys, Xs) and labels.dtype == np.uint32,
                f"segment: labels {labels.shape} {labels.dtype}")
        otsu = np.stack([threshold_instance_labels(v, min_size=20) for v in seg_data[0]]).max(0)
        require(np.array_equal(labels[0, 0], otsu), "segment: threshold_otsu differs from the host")
        require(int(labels[0, 1].max()) > 0, "segment: CPnet found no cell")
        one = seg_data[0][:, :1]
        seg_kwargs = dict(eval_args, channels=(1, 2))
        card_labels = cpnet_segment_czyx(one, str(cp_ckpt), device=dev, **seg_kwargs)
        set_precision("highest")
        highest_labels = cpnet_segment_czyx(one, str(cp_ckpt), device=dev, **seg_kwargs)
        set_precision(None)
        plain_labels = cpnet_segment_czyx(one, str(cp_ckpt), device="cpu", **seg_kwargs)
        # Under highest the network is float32 on the card and the labels
        # follow the CPU route's; TF32's are printed, not bounded.
        highest_off = label_mismatch(highest_labels, plain_labels)
        require(highest_off == 0, f"segment: CPnet slice 0 under highest differs from the "
                f"plain route in {highest_off} pixels")
        line("segment", f"{SEG_TCZYX} float32, threshold_otsu and CPnet {CPNET_WIDTH} (random "
             f"weights and BatchNorm statistics, diameter {SEG_DIAMETER}: rescaled to "
             f"{round(Ys * 30 / SEG_DIAMETER)} x {round(Xs * 30 / SEG_DIAMETER)}, cellprob "
             f"threshold {threshold}): {1e3 * seconds:.1f} ms for the whole call (host clock), "
             f"peak card memory {peak:.2f} GiB; {int(otsu.max())} Otsu instances bit-equal to "
             f"the host function, {len(np.unique(labels[0, 1])) - 1} CPnet labels; slice 0's "
             f"labels ({int(card_labels.max())} on the card under TF32, the default, "
             f"{int(highest_labels.max())} under highest, {int(plain_labels.max())} on the "
             f"plain route) differ from the plain route's in "
             f"{label_mismatch(card_labels, plain_labels)} (TF32, unbounded) and "
             f"{highest_off} (highest, bound 0) of "
             f"{card_labels.size} pixels up to a permutation")

        masks = render_masks((ROUND_TRIP_Z, Ys, Xs), rng)
        t0 = time.perf_counter()
        flows = np.stack([masks_to_flows(m) for m in masks]) * 5.0
        flows_s = time.perf_counter() - t0
        cellprob = np.where(masks > 0, 4.0, -4.0).astype(np.float32)
        card_masks = compute_masks_zyx(torch.from_numpy(flows).to(dev),
                                       torch.from_numpy(cellprob).to(dev))
        t0 = time.perf_counter()
        plain_masks = compute_masks_zyx(torch.from_numpy(flows), torch.from_numpy(cellprob))
        plain_s = time.perf_counter() - t0
        fg = torch.from_numpy(cellprob > 0).to(dev)
        dPm = torch.from_numpy(flows / np.float32(5.0)).to(dev) * fg[:, None]
        follow_ms = time_ms(lambda: follow_flows(dPm, fg))
        for z in range(ROUND_TRIP_Z):
            n = int(masks[z].max())
            require(int(card_masks[z].max()) == n,
                    f"round trip: slice {z} has {int(card_masks[z].max())} of {n} instances")
            require(label_mismatch(card_masks[z], plain_masks[z]) == 0,
                    f"round trip: slice {z} differs from the plain route")
        off = max(label_mismatch(card_masks[z], masks[z]) for z in range(ROUND_TRIP_Z))
        require(off <= 0.02 * masks[0].size, f"round trip: {off} pixels off the rendered masks")
        line("segment flow round trip", f"{ROUND_TRIP_Z} slices of {int(masks.max())} rendered "
             f"instances at {Ys} x {Xs} (masks_to_flows {1e3 * flows_s:.0f} ms on the host): "
             f"compute_masks_zyx on the card recovers every instance (at most {off} pixels a "
             f"slice off the rendered masks), equal to the plain route up to a permutation "
             f"(plain route {1e3 * plain_s:.0f} ms); follow_flows (200 steps, "
             f"{int(fg.sum())} foreground pixels) {follow_ms:.2f} ms a volume on the card "
             "(CUDA events)")
        del flows, dPm, fg

        # -- track: the example settings on moving nuclei ----------------------
        frames, centres = moving_nuclei(rng)
        Tt = frames.shape[0]
        track_in = tmp / "track_in.zarr"
        plate = open_ome_zarr(track_in, layout="hcs", mode="w",
                              channel_names=["nuclei_prediction"])
        plate.create_position("A", "1", "0").create_image(
            "0", frames[:, None, None],
            transform=[TransformationMeta(type="scale", scale=TRACK_SCALE)])
        settings = load_file(Path(__file__).resolve().parent / "settings" /
                             "example_track_settings.yml")
        track_cfg = tmp / "track.yml"
        track_cfg.write_text(yaml_flow(settings) + "\n")
        track_out = tmp / "track.zarr"
        seconds, _, _, _ = run_verb(["track", "-i", position(track_in), "-c", str(track_cfg),
                                     "-o", str(track_out)])
        got = open_ome_zarr(position(track_out), mode="r").data[...]
        require(got.shape == (Tt, 1, 1) + TRACK_TYX[1:] and got.dtype == np.uint32,
                f"track: labels {got.shape} {got.dtype}")
        with contextlib.redirect_stdout(io.StringIO()):
            data = run_preprocessing_pipeline({"nuclei_prediction": frames[:, None]},
                                              settings["input_images"])
        want, table = track_from_foreground_contour(
            data["foreground"].mean(axis=1), data["contour"].mean(axis=1),
            scale=TRACK_SCALE[-2:], max_distance=50.0)
        require(np.array_equal(got[:, 0, 0], want), "track: the plate differs from the engine")
        ids = np.zeros(centres.shape[:2], np.int64)
        for t in range(Tt):
            for n, (cy, cx) in enumerate(centres[t]):
                ids[t, n] = got[t, 0, 0, int(round(cy)), int(round(cx))]
        require(bool((ids > 0).all()) and bool((ids == ids[:1]).all())
                and len(set(ids[0].tolist())) == ids.shape[1],
                "track: a rendered nucleus lost or swapped its identity")
        csv = (track_out / "A/1/0/tracks_A_1_0.csv").read_text().splitlines()
        require(len(csv) == 1 + len(table["track_id"]), "track: the CSV's rows")
        line("track", f"{Tt} x {TRACK_TYX[1:]} moving nuclei ({ids.shape[1]}), the example "
             f"settings (detect_foreground sigma 15, max_distance 50): {1e3 * seconds:.1f} ms "
             f"for the whole call (host clock); labels bit-equal to the engine on arrays, every "
             f"nucleus one track over all {Tt} frames, {len(csv) - 1} CSV rows")

        # -- the pipeline's order: virtual-stain -> concatenate -> track -------
        # The track run's nuclei as a Phase3D stack, stained through
        # virtual-stain's TorchScript route by a model that passes its input
        # through as both outputs. (Random UNeXt2 weights would hand track
        # noise: tens of thousands of fragments a frame, for which the
        # linker's Hungarian assignment is quadratic in memory and cubic in
        # time.)
        class PassThrough(torch.nn.Module):
            def forward(self, x: torch.Tensor) -> torch.Tensor:
                return torch.cat([x, x], dim=1)

        script = tmp / "pass_through.pt"
        torch.jit.script(PassThrough()).save(str(script))
        raw = tmp / "wiring_raw.zarr"
        plate = open_ome_zarr(raw, layout="hcs", mode="w", channel_names=["Phase3D"])
        pos = plate.create_position("A", "1", "0")
        pos.create_image("0", np.repeat(frames[:, None, None], WIRING_DEPTH, axis=2),
                         transform=[TransformationMeta(type="scale", scale=TRACK_SCALE)])
        pos.update_zattrs({"normalization": {"Phase3D": {"fov_statistics": {
            "median": 0.0, "iqr": 1.0}}}})
        vs_cfg = tmp / "virtual_stain_script.yml"
        vs_cfg.write_text(yaml_flow({
            "ckpt_path": str(script), "source_channel": "Phase3D", "n_output_channels": 2,
            "sliding_window_z": WIRING_DEPTH, "output_channels": STAIN_OUTPUTS}) + "\n")
        stained = tmp / "wiring_stained.zarr"
        seconds_v, _, _, _ = run_verb(["virtual-stain", "-i", position(raw), "-c", str(vs_cfg),
                                       "-o", str(stained)])
        concat_cfg = tmp / "concatenate.yml"
        concat_cfg.write_text(yaml_flow({
            "concat_data_paths": [position(raw), position(stained)],
            "channel_names": [["Phase3D"], STAIN_OUTPUTS], "time_indices": "all",
            "output_ome_zarr_version": "0.4"}) + "\n")
        assembled = tmp / "assembled.zarr"
        seconds_c, _, _, _ = run_verb(["concatenate", "-c", str(concat_cfg), "-o",
                                       str(assembled)])
        wired = tmp / "track_wired.zarr"
        seconds_t, _, _, _ = run_verb(["track", "-i", position(assembled), "-c",
                                       str(track_cfg), "-o", str(wired)])
        names = open_ome_zarr(position(assembled), mode="r").channel_names
        wired_labels = open_ome_zarr(position(wired), mode="r").data[...]
        require(names == ["Phase3D"] + STAIN_OUTPUTS, f"concatenate: channels {names}")
        require(wired_labels.shape == (Tt, 1, 1) + TRACK_TYX[1:],
                f"wired track: labels {wired_labels.shape}")
        wired_ids = np.array([[wired_labels[t, 0, 0, int(round(cy)), int(round(cx))]
                               for cy, cx in centres[t]] for t in range(Tt)])
        require(bool((wired_ids > 0).all()) and bool((wired_ids == wired_ids[:1]).all())
                and len(set(wired_ids[0].tolist())) == wired_ids.shape[1],
                "wired track: a nucleus lost or swapped its identity")
        off = label_mismatch(wired_labels[:, 0, 0], got[:, 0, 0])
        line("pipeline order", f"virtual-stain (TorchScript on the card, {Tt} x "
             f"{WIRING_DEPTH} x {TRACK_TYX[1:]}: {1e3 * seconds_v:.1f} ms), concatenate "
             f"({1e3 * seconds_c:.1f} ms) into {names}, track on the assembled plate "
             f"({1e3 * seconds_t:.1f} ms): labels {wired_labels.shape}, every nucleus one "
             f"track; {off} pixels differ from the track run on the 2D plate up to a "
             "permutation")
    finally:
        set_precision(saved_precision)
        shutil.rmtree(tmp, ignore_errors=True)



# Phase 27: the store's codecs and the last eight entries. Phase 23's fuse
# input and a camera-like copy in the reference's three written layouts (the
# sharded one as concatenate writes it with chunks_czyx (1, 64, 256, 1024)
# and shards_ratio (1, 1, 4, 1, 1): a shard a volume); characterize-psf on
# one volume of the beads frame with CODEC_PSF_BEADS rendered beads
# CODEC_PSF_STEP voxels apart; estimate-crop's arms and their boxes;
# estimate-bleaching's decay (minutes a frame, the lifetime in minutes).
CODEC_LAYOUTS = (("v2 blosc-zstd", "0.4", None), ("v3 bytes+zstd", "0.5", None),
                 ("v3 sharded", "0.5", [1, 1, 4, 1, 1]))
CODEC_SHARD_CHUNKS = [1, 1, 64, 256, 1024]
CODEC_PSF_FRAME = (118, 1043, 518)
CODEC_PSF_STEP = 240
CODEC_PSF_PEAK = 2000.0
CROP_TZYX = (2, 86, 1024, 484)
CROP_BOXES = {"lf": ((4, 80), (40, 1000), (20, 470)), "ls": ((8, 84), (20, 980), (30, 460))}
BLEACH_TCZYX = (6, 2, 86, 1024, 484)
BLEACH_MINUTES, BLEACH_TAU = 10.0, 30.0
BLEACH_MEAN_TOL, BLEACH_TAU_TOL = 1e-6, 0.01
FWHM_TOL = 0.10


def binning_sum_rule(czyx: np.ndarray, factor) -> np.ndarray:
    """The reference's ``binning_czyx`` in sum mode (process_data.py:36),
    for the check of process-with-config."""
    bz, by, bx = factor
    C, Z, Y, X = czyx.shape
    nz, ny, nx = Z // bz, Y // by, X // bx
    out = np.zeros((C, nz, ny, nx), np.float32)
    top = np.iinfo(czyx.dtype).max if np.issubdtype(czyx.dtype, np.integer) else 65535
    for c in range(C):
        out[c] = czyx[c, : nz * bz, : ny * by, : nx * bx].astype(np.float32).reshape(
            nz, bz, ny, by, nx, bx).sum(axis=(1, 3, 5))
        if out[c].max() > 0 and out[c].max() - out[c].min() > 0:
            out[c] = (out[c] - out[c].min()) * top / (out[c].max() - out[c].min())
    return out.astype(czyx.dtype)


def codecs_phase(dev: torch.device, psf: np.ndarray) -> None:
    """Phase 27: the store's codecs at full size and the last eight CLI
    entries (module docstring)."""
    import csv
    import ctypes.util
    import pickle
    import shutil
    import tempfile
    from pathlib import Path

    import biahub_tpu_torch.characterize_psf as cpsf
    import biahub_tpu_torch.estimate_bleaching as bleach
    from biahub_tpu_torch.cli.yaml_reader import load_file
    from biahub_tpu_torch.device import gpu_info
    from biahub_tpu_torch.io.ngff import TransformationMeta, open_ome_zarr
    from biahub_tpu_torch.kernels.deskew import get_deskewed_data_shape
    from biahub_tpu_torch.kernels.peaks import detect_peaks

    card = gpu_info()
    tmp = Path(tempfile.mkdtemp(prefix="biahub_codecs_"))
    phase_t0 = time.perf_counter()
    here = Path(__file__).resolve().parent

    def line(what: str, text: str) -> None:
        print(f"27 {what}: {text}; card {card}; {time.perf_counter() - phase_t0:.1f} s into "
              "the phase")

    def du(path) -> int:
        return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())

    zstd_lib, blosc_lib = ctypes.util.find_library("zstd"), ctypes.util.find_library("blosc")
    line("libraries", f"find_library('zstd') = {zstd_lib!r}, find_library('blosc') = "
         f"{blosc_lib!r}")
    require(zstd_lib is not None, "phase 27: ctypes.util.find_library('zstd') finds no libzstd")
    try:
        names = ["GFP", "Phase3D"]
        scale = [1.0, 1.0, FUSE_DESKEW["scan_step_um"], FUSE_DESKEW["pixel_size_um"],
                 FUSE_DESKEW["pixel_size_um"]]
        tc = [(t, c) for t in range(FUSE_T) for c in range(FUSE_C)]
        gen = torch.Generator(device=dev).manual_seed(0)
        kinds = {"uniform": torch.randint(0, 65536, (FUSE_T, FUSE_C) + SHAPE, generator=gen,
                                          device=dev, dtype=torch.int32).to(torch.uint16)}
        gen27 = torch.Generator(device=dev).manual_seed(27)
        field = 100.0 + 1000.0 * smooth_rand(SHAPE, gen27)
        kinds["camera"] = torch.stack([torch.stack([
            torch.poisson(field, generator=gen27) for _ in range(FUSE_C)])
            for _ in range(FUSE_T)]).clamp_(max=65535).to(torch.int32).to(torch.uint16)
        del field
        kinds = {k: v.cpu().numpy() for k, v in kinds.items()}
        raw_mb = kinds["uniform"].nbytes / 1e6

        # -- the codecs: each layout written and read on the I/O threads -----
        positions = []
        for row, (kind, data) in zip("AB", kinds.items()):
            for col, (layout, version, ratio) in enumerate(
                    (("uncompressed", "0.4", None),) + CODEC_LAYOUTS, start=1):
                root = tmp / f"{kind}_{col}.zarr"
                plate = open_ome_zarr(root, layout="hcs", mode="w", channel_names=names,
                                      version=version)
                pos = plate.create_position(row, str(col), "0")
                arr = pos.create_zeros(
                    "0", data.shape, data.dtype,
                    chunks=CODEC_SHARD_CHUNKS if ratio else None, shards_ratio=ratio,
                    compressor=None if col == 1 else "zstd",
                    transform=[TransformationMeta(type="scale", scale=scale)])
                t0 = time.perf_counter()
                for f in [arr.write_async(key, data[key]) for key in tc]:
                    f.result()
                write_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                back = [f.result() for f in [arr.read_async(key) for key in tc]]
                read_s = time.perf_counter() - t0
                require(all(np.array_equal(b, data[key]) for b, key in zip(back, tc)),
                        f"codecs: {kind} {layout} does not read back bit-equal")
                del back
                t0 = time.perf_counter()
                for key in tc:
                    arr[key]
                serial_s = time.perf_counter() - t0
                ratio_c = data.nbytes / du(root / row / str(col) / "0" / "0")
                positions.append(root / row / str(col) / "0")
                line(f"codec {kind} {layout}", f"{FUSE_T}x{FUSE_C} uint16 {SHAPE} "
                     f"({raw_mb:.1f} MB): write {1e3 * write_s:.1f} ms ({raw_mb / write_s:.1f} "
                     f"MB/s encode and file), read {1e3 * read_s:.1f} ms ({raw_mb / read_s:.1f} "
                     f"MB/s file and decode; page cache warm), {len(tc)} volumes on the "
                     f"{len(tc)} I/O threads; one after another on one thread the read takes "
                     f"{1e3 * serial_s:.1f} ms ({serial_s / read_s:.2f}x the threads' time); ratio "
                     f"{ratio_c:.3f}; read back bit-equal")

        # -- the fuse verb on every plate at once (one transfer function) ----
        psf_plate = open_ome_zarr(tmp / "psf.zarr", layout="hcs", mode="w",
                                  channel_names=["PSF"])
        psf_plate.create_position("0", "0", "0").create_image(
            "0", psf[None, None], transform=[TransformationMeta(type="scale", scale=scale)])
        frame, users = fuse_plate_settings()
        (tmp / "fuse.yml").write_text(yaml_flow(users) + "\n")
        out = tmp / "fused.zarr"
        seconds, launches, stats, _ = run_verb(
            ["fuse", "-i", *map(str, positions), "-c", str(tmp / "fuse.yml"), "-o", str(out),
             "-p", str(tmp / "psf.zarr")])
        n_units = len(positions) * len(tc)
        for name in ("fwd_yx", "z_filter", "inv_yx"):
            require(launches.get(name) == n_units,
                    f"fuse on the codecs' plates: {name} launched {launches.get(name)} times")
        for name in ("deskew", "warp_zy", "warp_x"):
            require(launches.get(name, 0) >= 1, f"fuse on the codecs' plates: {name} not "
                    "launched")
        fused = {}
        for p in positions:
            key = "/".join(p.parts[-3:])
            fused[key] = open_ome_zarr(out / key).data[...]
        for row in "AB":
            want = fused[f"{row}/1/0"].view(np.int32)
            for col in (2, 3, 4):
                require(np.array_equal(fused[f"{row}/{col}/0"].view(np.int32), want),
                        f"fuse: the {CODEC_LAYOUTS[col - 2][0]} plate ({row}) differs from the "
                        "uncompressed plate's")
        line("fuse verb on the codecs' plates", f"{len(positions)} positions (2 kinds x the "
             f"uncompressed and 3 compressed layouts), {n_units} (t, c) volumes, phase 23's "
             f"settings: {1e3 * seconds:.1f} ms for the whole call (host clock; the runner "
             f"{1e3 * stats['wall_s']:.1f} ms, its reads waited {1e3 * stats['read_s']:.1f} "
             f"ms, its writes {1e3 * stats['write_s']:.1f} ms); every compressed plate's "
             f"output bit-equal to the uncompressed plate's; launches {launches}")

        # -- the output volume written uncompressed and at zstd level 1 ------
        vol_out = fused["B/1/0"]
        del fused
        shutil.rmtree(out)
        for p in positions[1:]:
            shutil.rmtree(p.parents[2])
        mb_out = vol_out.nbytes / 1e6
        notes = []
        for label, version, compressor in (("uncompressed", "0.4", None),
                                           ("v2 blosc-zstd", "0.4", "zstd"),
                                           ("v3 bytes+zstd", "0.5", "zstd")):
            pos = open_ome_zarr(tmp / f"out_{label.split()[0]}.zarr", layout="fov", mode="w",
                                channel_names=names, version=version)
            arr = pos.create_zeros("0", vol_out.shape, vol_out.dtype, compressor=compressor)
            t0 = time.perf_counter()
            for f in [arr.write_async(key, vol_out[key]) for key in tc]:
                f.result()
            w = time.perf_counter() - t0
            notes.append(f"{label} {1e3 * w:.1f} ms ({mb_out / w:.1f} MB/s, ratio "
                         f"{vol_out.nbytes / du(tmp / f'out_{label.split()[0]}.zarr' / '0'):.3f})")
        line("output write", f"the fused camera-like volume ({tuple(vol_out.shape)} float32, "
             f"{mb_out:.1f} MB) on the I/O threads: " + "; ".join(notes))
        del vol_out
        for label in ("uncompressed", "v2", "v3"):
            shutil.rmtree(tmp / f"out_{label}.zarr")

        # -- process-with-config: the example binning on phase 23's plate ----
        proc = load_file(here / "settings" / "example_process_with_config_settings.yml")
        proc["processing_functions"][0]["input_channels"] = [names[0]]
        factor = proc["processing_functions"][0]["kwargs"]["binning_factor_zyx"]
        (tmp / "proc.yml").write_text(yaml_flow(proc) + "\n")
        seconds_p, _, _, _ = run_verb(["process-with-config", "-i", str(positions[0]), "-c",
                                       str(tmp / "proc.yml"), "-o", str(tmp / "binned.zarr")])
        binned = open_ome_zarr(tmp / "binned.zarr" / "A/1/0").data[...]
        want = np.stack([binning_sum_rule(kinds["uniform"][t], factor)
                         for t in range(FUSE_T)]).astype(np.float32)
        require(binned.shape == want.shape and np.array_equal(binned.view(np.int32),
                                                              want.view(np.int32)),
                "process-with-config: the plate differs from binning_czyx's rule")
        line("process-with-config", f"the example binning {factor} (sum) of phase 23's plate "
             f"-> {binned.shape} float32: {1e3 * seconds_p:.1f} ms for the whole call (host "
             "clock, on the host as the reference); bit-equal to the rule in NumPy")
        del binned, want, kinds

        # -- characterize-psf on one volume of the beads frame ---------------
        _, voxel = get_deskewed_data_shape(SHAPE, ANGLE, RATIO, True, AVG,
                                           FUSE_DESKEW["pixel_size_um"])
        zs, ys, xs = CODEC_PSF_FRAME
        rng = np.random.default_rng(27)
        centres = torch.tensor([[zs / 2 + rng.uniform(-0.5, 0.5), y + rng.uniform(-0.5, 0.5),
                                 x + rng.uniform(-0.5, 0.5)]
                                for y in range(CODEC_PSF_STEP // 2, ys - 30, CODEC_PSF_STEP)
                                for x in range(CODEC_PSF_STEP // 2, xs - 30, CODEC_PSF_STEP)],
                               dtype=torch.float64, device=dev)
        grid = torch.stack(torch.meshgrid(*[torch.arange(n, device=dev, dtype=torch.float64)
                                            for n in CODEC_PSF_FRAME], indexing="ij"), -1)
        sig = torch.tensor(BEAD_SIGMA, dtype=torch.float64, device=dev)
        beads = torch.zeros(CODEC_PSF_FRAME, dtype=torch.float64, device=dev)
        r = 6
        for cz, cy, cx in centres.tolist():
            sl = tuple(slice(int(c) - r, int(c) + r + 1) for c in (cz, cy, cx))
            d = (grid[sl] - torch.tensor([cz, cy, cx], dtype=torch.float64, device=dev)) / sig
            beads[sl] += CODEC_PSF_PEAK * torch.exp(-0.5 * (d * d).sum(-1))
        beads += torch.normal(100.0, 3.0, CODEC_PSF_FRAME, generator=gen27, device=dev,
                              dtype=torch.float64)
        beads = torch.round(beads).clamp_(0, 65535).to(torch.int32).to(torch.uint16)
        del grid
        bead_np = beads.cpu().numpy()
        bead_plate = open_ome_zarr(tmp / "beads.zarr", layout="hcs", mode="w",
                                   channel_names=["GFP"])
        bead_plate.create_position("0", "0", "0").create_image(
            "0", bead_np[None, None],
            transform=[TransformationMeta(type="scale", scale=[1.0, 1.0, *voxel])])
        detect_s = []
        real_detect = cpsf.detect_peaks

        def timed_detect(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out_peaks = real_detect(*args, **kwargs)
            torch.cuda.synchronize()
            detect_s.append(time.perf_counter() - t0)
            return out_peaks

        cpsf.detect_peaks = timed_detect
        try:
            seconds_c, launches_c, _, _ = run_verb([
                "characterize-psf", "-i", str(tmp / "beads.zarr" / "0/0/0"), "-c",
                str(here / "settings" / "example_characterize_settings.yml"), "-o",
                str(tmp / "psf_report")])
        finally:
            cpsf.detect_peaks = real_detect
        require(launches_c.get("block_max_argmin") == 1,
                f"characterize-psf: G launched {launches_c.get('block_max_argmin')} times")
        with open(tmp / "psf_report" / "peaks.pkl", "rb") as f:
            peaks = pickle.load(f)
        settings_c = load_file(here / "settings" / "example_characterize_settings.yml")
        with plain_kernels(), contextlib.redirect_stdout(io.StringIO()):
            plain_peaks = detect_peaks(
                beads, block_size=tuple(settings_c["block_size"]),
                nms_distance=settings_c["nms_distance"],
                min_distance=settings_c["min_distance"],
                threshold_abs=settings_c["threshold_abs"],
                max_num_peaks=settings_c["max_num_peaks"],
                exclude_border=tuple(settings_c["exclude_border"]),
                blur_kernel_size=settings_c["blur_kernel_size"], device=dev)
        require(np.array_equal(peaks, plain_peaks), "characterize-psf: the peaks differ from "
                "the plain route's")
        require(len(peaks) == len(centres), f"characterize-psf: {len(peaks)} peaks of "
                f"{len(centres)} beads")
        with open(tmp / "psf_report" / "psf_gaussian_fit.csv") as f:
            rows = list(csv.DictReader(f))
        fwhm_notes = []
        for axis, (name, sigma, um) in enumerate(zip("zyx", BEAD_SIGMA, voxel)):
            want_fwhm = 2 * math.sqrt(2 * math.log(2)) * sigma * um
            got_fwhm = float(np.mean([float(r[f"zyx_{name}_fwhm"]) for r in rows]))
            require(abs(got_fwhm / want_fwhm - 1) <= FWHM_TOL,
                    f"characterize-psf: mean {name} FWHM {got_fwhm:.4f} um, rendered "
                    f"{want_fwhm:.4f}")
            fwhm_notes.append(f"{name} {got_fwhm:.4f} (rendered {want_fwhm:.4f})")
        require((tmp / "psf_report" / "psf_analysis_report.html").exists()
                and (tmp / "psf_report" / "psf_1d_peak_width.csv").exists(),
                "characterize-psf: the report's files")
        line("characterize-psf", f"{len(centres)} integer-valued beads (sigma {BEAD_SIGMA} "
             f"voxels) in {CODEC_PSF_FRAME} uint16 at {np.round(voxel, 4).tolist()} um, the "
             f"example settings: {1e3 * seconds_c:.1f} ms for the whole call (host clock), "
             f"detect_peaks {1e3 * detect_s[0]:.1f} ms of it (the volume to the card, G, the "
             f"candidates' filtering), the rest {1e3 * (seconds_c - detect_s[0]):.1f} ms on "
             f"the host (patches, {len(rows)} Gaussian fits, report); G launched once; "
             f"peaks equal to the plain route's; mean FWHM um " + ", ".join(fwhm_notes))
        del beads, bead_np

        # -- estimate-crop on two arms with zero borders ---------------------
        for arm, box in CROP_BOXES.items():
            data = np.zeros((CROP_TZYX[0], 1) + CROP_TZYX[1:], np.uint16)
            inner = (slice(None), slice(None)) + tuple(slice(a, b) for a, b in box)
            data[inner] = torch.randint(1, 65536, data[inner].shape, generator=gen27,
                                        device=dev, dtype=torch.int32).to(
                torch.uint16).cpu().numpy()
            plate = open_ome_zarr(tmp / f"{arm}.zarr", layout="hcs", mode="w",
                                  channel_names=[arm])
            plate.create_position("A", "1", "0").create_image("0", data)
        (tmp / "concat.yml").write_text(yaml_flow({
            "concat_data_paths": ["lf.zarr/*/*/*", "ls.zarr/*/*/*"],
            "time_indices": "all", "channel_names": ["all", "all"]}) + "\n")
        seconds_e, _, _, _ = run_verb(["estimate-crop", "-c", str(tmp / "concat.yml"), "-o",
                                       str(tmp / "cropped.yml")])
        cropped = load_file(tmp / "cropped.yml")
        truth = [[max(a[0], b[0]), min(a[1], b[1])]
                 for a, b in zip(CROP_BOXES["lf"], CROP_BOXES["ls"])]
        got_crop = [cropped["Z_slice"], cropped["Y_slice"], cropped["X_slice"]]
        require(got_crop == truth, f"estimate-crop: {got_crop}, want {truth}")
        line("estimate-crop", f"two (T {CROP_TZYX[0]}, {CROP_TZYX[1:]}) uint16 arms with zero "
             f"borders: {1e3 * seconds_e:.1f} ms for the whole call (host clock); the crop "
             f"{got_crop} is the boxes' intersection")

        # -- estimate-bleaching on a rendered decay ---------------------------
        T_b, C_b = BLEACH_TCZYX[:2]
        lam = [[(300.0 + 200.0 * c) * math.exp(-t * BLEACH_MINUTES / BLEACH_TAU) + 200.0
                for c in range(C_b)] for t in range(T_b)]
        bleach_np = np.stack([np.stack([torch.poisson(
            torch.full(BLEACH_TCZYX[2:], lam[t][c], device=dev), generator=gen27).to(
            torch.int32).to(torch.uint16).cpu().numpy() for c in range(C_b)])
            for t in range(T_b)])
        plate = open_ome_zarr(tmp / "bleach.zarr", layout="hcs", mode="w",
                              channel_names=["GFP", "mCherry"])
        plate.create_position("A", "1", "0").create_image("0", bleach_np)
        plate.update_zattrs({"Summary": {"Interval_ms": BLEACH_MINUTES * 60000}})
        record = {}
        real_stats, real_fit = bleach.bleaching_statistics, bleach.fit_bleaching

        def stats_rec(*args, **kwargs):
            record["stats"] = real_stats(*args, **kwargs)
            return record["stats"]

        def fit_rec(*args, **kwargs):
            record["fits"] = real_fit(*args, **kwargs)
            return record["fits"]

        bleach.bleaching_statistics, bleach.fit_bleaching = stats_rec, fit_rec
        try:
            seconds_b, _, _, text_b = run_verb(["estimate-bleaching", "-i",
                                                str(tmp / "bleach.zarr" / "A/1/0"), "-o",
                                                str(tmp / "bleaching")])
        finally:
            bleach.bleaching_statistics, bleach.fit_bleaching = real_stats, real_fit
        means, stds = record["stats"]
        host_means = bleach_np.mean(axis=(2, 3, 4), dtype=np.float64)
        worst = float(np.max(np.abs(means / host_means - 1)))
        require(worst <= BLEACH_MEAN_TOL, f"estimate-bleaching: card means {worst:.3g} off numpy's")
        taus = [float(p[1]) for p in record["fits"]]
        require(all(abs(tau / BLEACH_TAU - 1) <= BLEACH_TAU_TOL for tau in taus),
                f"estimate-bleaching: lifetimes {taus}, rendered {BLEACH_TAU}")
        require(text_b.count("Curve fit successful!") == C_b, "estimate-bleaching: the fits' lines")
        line("estimate-bleaching", f"{BLEACH_TCZYX} uint16, {BLEACH_MINUTES} minutes a frame, "
             f"rendered lifetime {BLEACH_TAU} minutes: {1e3 * seconds_b:.1f} ms for the whole "
             f"call (host clock); card means within {worst:.3g} of numpy's (tol "
             f"{BLEACH_MEAN_TOL}); fitted lifetimes {[round(t, 4) for t in taus]} minutes "
             f"(tol {BLEACH_TAU_TOL:.0%})")
        del bleach_np

        # -- estimate-deskew, check-disk-space, nf, crop-background ----------
        rect = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 100.0], [100 * RATIO, 0.0, 100.0],
                         [100 * RATIO, 0.0, 0.0]])
        np.savetxt(tmp / "rect.csv", rect, delimiter=",")
        theta = math.radians(ANGLE)
        np.savetxt(tmp / "line.csv", np.array([[0.0, 0.0], [math.cos(theta) * RATIO, 1.0]]),
                   delimiter=",")
        run_verb(["estimate-deskew", "-i", str(positions[0]), "-o", str(tmp / "deskew.yml"),
                  "--pixel-size-um", str(FUSE_DESKEW["pixel_size_um"]), "--scan-step-um",
                  str(FUSE_DESKEW["scan_step_um"]), "--rect-points", str(tmp / "rect.csv"),
                  "--line-points", str(tmp / "line.csv")])
        measured = load_file(tmp / "deskew.yml")
        require(measured["ls_angle_deg"] == ANGLE and measured["px_to_scan_ratio"] == RATIO,
                f"estimate-deskew: {measured}")
        _, _, _, text_d = run_verb(["check-disk-space", "-i", str(positions[0].parents[2]),
                                    "-o", str(tmp / "next.zarr")])
        _, _, _, text_n = run_verb(["nf", "list-positions", str(positions[0].parents[2])])
        require(text_n.split() == ["A/1/0"], f"nf list-positions: {text_n!r}")
        (tmp / "videos").mkdir()
        (tmp / "videos" / "a.mp4").write_bytes(b"not a video")
        _, _, _, text_v = run_verb(["crop-background", str(tmp / "videos"),
                                    str(tmp / "cropped_videos")])
        require("No crop detected for" in text_v, f"crop-background: {text_v!r}")
        line("estimate-deskew, check-disk-space, nf, crop-background",
             f"the point files give {measured['ls_angle_deg']} deg and ratio "
             f"{measured['px_to_scan_ratio']}; check-disk-space: "
             f"{text_d.strip().splitlines()[-1]!r}; nf list-positions: {text_n.split()}; "
             f"crop-background (ffmpeg {'found' if shutil.which('ffmpeg') else 'absent'}): "
             f"{text_v.strip().splitlines()[-1]!r}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# Phase 28: the last library modules. optimize_matches on PERF.md row 11's
# beads frame: MATCH_BEADS rendered beads, the moving frame an affine offset
# of the reference (MATCH_TRUTH_*), the approximate warp part of the way
# there; the card's route against the CPU route on a crop (MATCH_CROP, a
# pair rendered at that shape). Transform.apply, the manual verb on plates,
# the host helper's LIR on the register verb's mask, render_frame's
# composite.
MATCH_FRAME = (118, 1043, 518)
MATCH_CROP = (32, 160, 128)
MATCH_BEADS = 400
MATCH_TRUTH_DEG, MATCH_TRUTH_SHIFT = (0.6, -0.4, 0.8), (1.5, -2.0, 2.5)
MATCH_TRUTH_SCALE = (1.0, 1.01, 0.99)  # the affine part: Y and X stretched
MANUAL_SCALES = ([1.0, 1.0, 0.174, 0.1494, 0.1494], [1.0, 1.0, 0.2, 0.1, 0.1])
MANUAL_POINTS = 6


def affine_offset(shape, frac: float = 1.0) -> np.ndarray:
    """``frac`` of phase 28's offset: a rigid drift about the centre with
    the Y and X axes stretched about it (output -> input)."""
    m = rigid_about_centre(np.multiply(MATCH_TRUTH_DEG, frac),
                           np.multiply(MATCH_TRUTH_SHIFT, frac), shape)
    centre = (np.asarray(shape) - 1) / 2
    scale = np.eye(4)
    scale[:3, :3] = np.diag(1 + frac * (np.asarray(MATCH_TRUTH_SCALE) - 1))
    scale[:3, 3] = centre - scale[:3, :3] @ centre
    return m @ scale


def bead_pair(shape, n: int, seed: int, dev: torch.device):
    """(reference, moving) rendered at ``shape``: bead q at q in the
    reference and at truth @ q in the moving frame (each rendered anew)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    points = np.random.default_rng(seed).uniform(10, np.asarray(shape) - 10, (n, 3))
    truth = affine_offset(shape)
    moved = points @ truth[:3, :3].T + truth[:3, 3]
    return (render_beads(torch.tensor(points, device=dev), shape, gen),
            render_beads(torch.tensor(moved, device=dev), shape, gen))


def chosen_score(mov, ref, approx, bms: dict, ats: dict, dev) -> float:
    """The overlap score of the optimize_matches trial with ``bms``."""
    from biahub_tpu_torch.registration import beads

    peak_settings = (bms["source_peaks_settings"], bms["target_peaks_settings"])
    mov_peaks, ref_peaks = beads.peaks_from_beads(beads._warp(mov, approx, ref.shape, dev), ref,
                                                  *peak_settings, device=dev)
    matches = beads.matches_from_beads(mov_peaks, ref_peaks, bms)
    _, inv = beads.transform_from_matches(matches, mov_peaks, ref_peaks, ats)
    peaks = beads.peaks_from_beads(beads._warp(mov, approx @ inv, ref.shape, dev), ref,
                                   *peak_settings, device=dev)
    return beads.overlap_score(*peaks, radius=bms["qc_settings"]["score_centroid_mask_radius"])


def leftovers_phase(dev: torch.device, records: dict) -> None:
    """Phase 28: optimize_matches, Transform.apply, the manual method of
    estimate-registration, the host helper and render_frame (module
    docstring)."""
    import importlib.util
    import shutil
    import tempfile
    from pathlib import Path

    from biahub_tpu_torch import _native
    from biahub_tpu_torch import register as treg
    from biahub_tpu_torch.cli.main import main as cli_main
    from biahub_tpu_torch.cli.yaml_reader import load_file
    from biahub_tpu_torch.device import gpu_info
    from biahub_tpu_torch.estimate_registration import (
        HEADLESS_MESSAGE,
        registration_from_point_pairs,
    )
    from biahub_tpu_torch.io.ngff import TransformationMeta, open_ome_zarr
    from biahub_tpu_torch.registration.beads import optimize_matches
    from biahub_tpu_torch.transforms import Transform
    from biahub_tpu_torch.transforms.lir import largest_interior_rectangle_plain
    from biahub_tpu_torch.visualize.animation_utils import composite_channels, render_frame

    card = gpu_info()
    phase_t0 = time.perf_counter()
    ats = {"transform_type": "affine"}

    # -- (a) optimize_matches at full width, then card against CPU on a crop
    ref, mov = bead_pair(MATCH_FRAME, MATCH_BEADS, 28, dev)
    approx = affine_offset(MATCH_FRAME, 0.5)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        best, launches = counted(lambda: optimize_matches(mov, ref, approx, {}, ats, device=dev))
        call_ms = 1e3 * (time.perf_counter() - t0)
    require(launches.get("block_max_argmin", 0) >= 1 and launches.get("resample_pass", 0) >= 1,
            f"optimize_matches launches {launches}: G and H must both run")
    grid_line = [ln for ln in buf.getvalue().splitlines() if ln.startswith("Starting grid")]
    score = chosen_score(mov, ref, approx, best, ats, dev)
    require(score >= 0.9, f"optimize_matches: the chosen trial's overlap {score:.4f} < 0.9")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with contextlib.redirect_stdout(io.StringIO()), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        optimize_matches(mov, ref, approx, {}, ats, device=dev)
        torch.cuda.synchronize()
    device_ms = sum(getattr(ev, "self_device_time_total", 0) for ev in prof.key_averages()
                    if ev.device_type == DeviceType.CUDA) / 1e3
    # G's and H's launches here join those of their path (phase 9's runs,
    # one dict the two records share: each record gets its own sum).
    for name in ("block_max_argmin", "resample_pass"):
        runs = records[name]["runs"]
        records[name]["runs"] = {**runs, name: runs.get(name, 0) + launches[name]}
    hm = best["hungarian_match_settings"]
    fm = best["filter_matches_settings"]
    print(f"28a optimize_matches {MATCH_FRAME}, {MATCH_BEADS} beads, affine offset, the "
          f"default grid (16 trials; {grid_line[0] if grid_line else 'no grid line'}): "
          f"{call_ms:.1f} ms for the call (host clock), device {device_ms:.1f} ms "
          f"(torch.profiler, a second call), host share {1 - device_ms / call_ms:.1%}; chosen "
          f"k {hm['edge_graph_settings']['k']}, quantiles {fm['min_distance_quantile']}/"
          f"{fm['max_distance_quantile']}, direction {fm['direction_threshold']}, overlap "
          f"{score:.4f}; launches {launches}; card {card}")
    del ref, mov

    ref_c, mov_c = bead_pair(MATCH_CROP, 40, 281, dev)
    approx_c = affine_offset(MATCH_CROP, 0.5)
    with contextlib.redirect_stdout(io.StringIO()):
        card_best = optimize_matches(mov_c, ref_c, approx_c, {}, ats, device=dev)
        cpu_best = optimize_matches(mov_c.cpu(), ref_c.cpu(), approx_c, {}, ats, device="cpu")
        card_score = chosen_score(mov_c, ref_c, approx_c, card_best, ats, dev)
        cpu_score = chosen_score(mov_c.cpu(), ref_c.cpu(), approx_c, cpu_best, ats,
                                 torch.device("cpu"))
    require(card_best == cpu_best, "optimize_matches: the card's chosen settings differ from "
            "the CPU route's")
    require(card_score == cpu_score, f"optimize_matches: the card's score {card_score} differs "
            f"from the CPU route's {cpu_score}")
    print(f"28a optimize_matches on a {MATCH_CROP} pair (40 beads): the card's chosen settings "
          f"and score ({card_score:.4f}) equal the CPU route's")
    del ref_c, mov_c

    # -- (b) Transform.apply, in-plane (E, F) and general (H) ----------------
    vol = bead_pair(MATCH_FRAME, MATCH_BEADS, 282, dev)[0]
    general = affine_offset(MATCH_FRAME)
    inplane = inplane_about_centre(2.0, (-3.0, 2.25), MATCH_FRAME)
    for kind, m, want_kernels in (("in-plane", inplane, ("warp_zy", "warp_x")),
                                  ("general", general, ("resample_pass",))):
        t = Transform(np.linalg.inv(m))  # forward: apply warps with its inverse, m
        got, launches_t = counted(lambda: t.apply(vol, device=dev))
        with all_plain():
            plain = t.apply(vol, device=dev)
        _, err = rel_err(got, plain)
        require(err <= WARP_TOL, f"Transform.apply ({kind}): rel err {err:.3g} > {WARP_TOL}")
        require(all(launches_t.get(k, 0) >= 1 for k in want_kernels),
                f"Transform.apply ({kind}) launches {launches_t}")
        ms = time_ms(lambda: t.apply(vol, device=dev))
        print(f"28b Transform.apply {kind} on {MATCH_FRAME}: rel err {err:.3g} of the plain "
              f"route (tol {WARP_TOL}); {ms:.4f} ms; launches {launches_t}")
    del vol, got, plain

    tmp = Path(tempfile.mkdtemp(prefix="biahub_leftovers_"))
    try:
        # -- (c) the manual method through the command line -----------------
        paths = []
        gen = torch.Generator(device=dev).manual_seed(283)
        for name, scale, names in (("src", MANUAL_SCALES[0], ["GFP", "BF"]),
                                   ("tgt", MANUAL_SCALES[1], ["Phase3D"])):
            root = open_ome_zarr(tmp / f"{name}.zarr", layout="hcs", mode="w",
                                 channel_names=names)
            root.create_position("0", "0", "0").create_image(
                "0", torch.rand((1, len(names)) + LAPSE_SHAPE, generator=gen,
                                device=dev).cpu().numpy(),
                transform=[TransformationMeta(type="scale", scale=scale)])
            paths.append(str(tmp / f"{name}.zarr" / "0" / "0" / "0"))
        rng = np.random.default_rng(283)
        src_pts = rng.uniform(0, LAPSE_SHAPE, (MANUAL_POINTS, 3))
        tgt_pts = src_pts @ affine_offset(LAPSE_SHAPE)[:3, :3].T + [2.0, -5.0, 7.5]
        np.save(tmp / "src.npy", src_pts)
        (tmp / "tgt.csv").write_text("index,axis-0,axis-1,axis-2\n" + "".join(
            f"{i},{z},{y},{x}\n" for i, (z, y, x) in enumerate(tgt_pts.tolist())))
        manual = {"target_channel_name": "Phase3D", "source_channel_name": "GFP",
                  "estimation_method": "manual",
                  "manual_registration_settings": {"time_index": 0,
                                                   "affine_90degree_rotation": 0,
                                                   "affine_fliplr": False},
                  "affine_transform_settings": {"transform_type": "similarity"},
                  "verbose": True}
        (tmp / "manual.yml").write_text(yaml_flow(manual) + "\n")
        pair = ["estimate-registration", "-s", paths[0], "-t", paths[1], "-c",
                str(tmp / "manual.yml")]
        seconds, launches_m, _, _ = run_verb(
            [*pair, "-o", str(tmp / "reg" / "manual.yml"), "--source-points",
             str(tmp / "src.npy"), "--target-points", str(tmp / "tgt.csv")])
        got_m = np.asarray(load_file(tmp / "reg" / "manual.yml")["affine_transform_zyx"])
        want_m = registration_from_point_pairs(
            src_pts, tgt_pts, LAPSE_SHAPE, LAPSE_SHAPE, MANUAL_SCALES[0][-3:],
            MANUAL_SCALES[1][-3:], True, 0, False, "pre_aligned")
        far_m = float(np.abs(got_m - want_m).max())
        require(far_m <= 1e-12, f"manual verb: {far_m:.3g} from registration_from_point_pairs")
        err_buf = io.StringIO()
        with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(err_buf):
            rc = cli_main([*pair, "-o", str(tmp / "headless" / "manual.yml")])
        require(rc == 1 and HEADLESS_MESSAGE in err_buf.getvalue(),
                f"manual verb without point files: exit {rc}, stderr {err_buf.getvalue()!r}")
        print(f"28c estimate-registration manual (similarity, {MANUAL_POINTS} point pairs, .npy "
              f"and napari CSV): {1e3 * seconds:.1f} ms for the whole call, {far_m:.3g} from "
              f"registration_from_point_pairs on the host; launches {launches_m}; without "
              f"point files exit 1 with the headless message")

        # -- (d) the host helper: LIR of the register verb's mask -----------
        mask = (treg.apply_affine_transform(
            torch.ones(LAPSE_SHAPE, device=dev), general_lapse(), LAPSE_SHAPE,
            device=dev) > 0).cpu().numpy()
        crop = treg.find_lir(mask)
        native_ms = host_ms(lambda: treg.find_lir(mask))
        saved = treg.largest_interior_rectangle
        treg.largest_interior_rectangle = largest_interior_rectangle_plain
        try:
            loop_crop = treg.find_lir(mask)
            loop_ms = host_ms(lambda: treg.find_lir(mask), reps=1)
        finally:
            treg.largest_interior_rectangle = saved
        require(crop == loop_crop, f"find_lir: the helper's {crop} differs from the loop's "
                f"{loop_crop}")
        print(f"28d find_lir on the register verb's mask {LAPSE_SHAPE} (crop "
              f"{[(c.start, c.stop) for c in crop]}): compiled helper {native_ms:.2f} ms, "
              f"Python loop {loop_ms:.1f} ms (host clock), equal; the helper "
              f"{_native._target(_native._compiler()).name}")

        (tmp / "register.yml").write_text(yaml_flow(
            {"source_channel_names": ["GFP"], "target_channel_name": "Phase3D",
             "affine_transform_zyx": general_lapse().tolist()}) + "\n")
        walls = {"helper": [], "loop": []}
        outputs = {}
        for turn, which in enumerate(("loop", "helper", "helper", "loop")):
            if which == "loop":
                treg.largest_interior_rectangle = largest_interior_rectangle_plain
            try:
                out = tmp / f"registered{turn}.zarr"
                sec, launches_r, _, _ = run_verb(["register", "-s", paths[0], "-t", paths[1],
                                                  "-c", str(tmp / "register.yml"), "-o",
                                                  str(out)])
            finally:
                treg.largest_interior_rectangle = saved
            walls[which].append(1e3 * sec)
            outputs.setdefault(which, open_ome_zarr(out / "0" / "0" / "0").data[...])
            shutil.rmtree(out)
        require(np.array_equal(outputs["helper"].view(np.int32), outputs["loop"].view(np.int32)),
                "register verb: the helper's plate differs from the loop's")
        print(f"28d register verb {LAPSE_SHAPE}, general matrix, cropped to the LIR: "
              f"{', '.join(f'{w:.1f}' for w in walls['loop'])} ms with the Python loop, "
              f"{', '.join(f'{w:.1f}' for w in walls['helper'])} with the compiled helper "
              f"(whole call, host clock, in turns loop, helper, helper, loop); plates equal; "
              f"launches {launches_r}; card {card}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # -- (e) render_frame's composite on the card against the CPU's --------
    gen = torch.Generator(device=dev).manual_seed(284)
    channels = [torch.rand(LAPSE_SHAPE[1:], generator=gen, device=dev) * 4000 for _ in range(3)]
    frame = composite_channels(channels, device=dev)
    cpu_frame = composite_channels([c.cpu() for c in channels], device="cpu")
    require(torch.equal(frame.cpu(), cpu_frame), "composite_channels: the card's frame differs "
            "from the CPU route's")
    limits = [(float(c.min()), float(c.max())) for c in channels]
    comp_ms = time_ms(lambda: composite_channels(channels, limits, device=dev))
    has_pil = importlib.util.find_spec("PIL") is not None
    if has_pil:
        render_frame(channels, limits, pixel_size_um=0.116, scale_bar_um=10.0, text="t",
                     device=dev)
    else:
        try:
            render_frame(channels, limits, device=dev)
        except ImportError as e:
            require("PIL" in str(e), f"render_frame without PIL: {e}")
        else:
            require(False, "render_frame without PIL did not raise ImportError")
    print(f"28e composite_channels (3 channels, {LAPSE_SHAPE[1:]}): equal to the CPU route's "
          f"frame; {comp_ms:.4f} ms; PIL {'present' if has_pil else 'absent'}, render_frame "
          f"{'drew bars and text' if has_pil else 'raised its ImportError'}")
    print(f"28: {time.perf_counter() - phase_t0:.1f} s for the phase")


def general_lapse() -> np.ndarray:
    """The register verb's matrix in phase 28: phase 28's offset at the
    deskewed FOV (a general 3D matrix: H, and a cropped LIR)."""
    return affine_offset(LAPSE_SHAPE)


# Phase 29: the batch verbs over several shards: SHARDS_N shards of one
# card (Mesh.virtual), then every card of the process where it has more
# than one; the process-group sharded FFT as PG_FFT_RANKS NCCL processes,
# one card each, on the headline volume (PG_FFT_LIMIT_S seconds each).
SHARDS_N = 4
PG_FFT_RANKS = 2
PG_FFT_LIMIT_S = 300
SHARD_KERNELS = {"fuse": ("fwd_yx", "z_filter", "inv_yx", "deskew", "warp_zy", "warp_x"),
                 "deconvolve": ("fwd_yx", "z_filter", "inv_yx")}


def launches_by_stream(fn) -> tuple[object, dict, dict]:
    """``fn()``'s result, its launches (as :func:`counted`) and the same
    launches by (card, stream) they were made on: each shard of the runner
    launches on a stream of its own."""
    from biahub_tpu_torch.kernels import _build

    by_stream: dict = {}
    count = _build.count_launch

    def count_where(name: str) -> None:
        count(name)
        st = torch.cuda.current_stream()
        per = by_stream.setdefault((st.device.index, st.cuda_stream), {})
        per[name] = per.get(name, 0) + 1

    _build.count_launch = count_where
    try:
        out, launches = counted(fn)
    finally:
        _build.count_launch = count
    return out, launches, by_stream


def shards_phase(dev: torch.device, psf: np.ndarray) -> None:
    """Phase 29: the fuse and deconvolve verbs through the runner over one
    shard, over ``Mesh.virtual(dev, SHARDS_N)`` and over every card; the
    process-group sharded FFT (module docstring)."""
    import shutil
    import subprocess
    import tempfile
    from pathlib import Path

    from biahub_tpu_torch import deconvolve as deconvolve_verb
    from biahub_tpu_torch import fuse as fuse_verb
    from biahub_tpu_torch.device import gpu_info
    from biahub_tpu_torch.io.ngff import TransformationMeta, open_ome_zarr
    from biahub_tpu_torch.kernels.deconvolve import compute_transfer_function, deconvolve_zyx
    from biahub_tpu_torch.parallel.mesh import Mesh, get_mesh

    card = gpu_info()
    n_cards = torch.cuda.device_count()
    tmp = Path(tempfile.mkdtemp(prefix="biahub_shards_"))
    phase_t0 = time.perf_counter()
    try:
        names = ["GFP", "Phase3D"]
        scale = [1.0, 1.0, FUSE_DESKEW["scan_step_um"], FUSE_DESKEW["pixel_size_um"],
                 FUSE_DESKEW["pixel_size_um"]]
        gen = torch.Generator(device=dev).manual_seed(29)
        raw = torch.randint(0, 65536, (FUSE_T, FUSE_C) + SHAPE, generator=gen, device=dev,
                            dtype=torch.int32).to(torch.uint16).cpu().numpy()
        plate = open_ome_zarr(tmp / "raw.zarr", layout="hcs", mode="w", channel_names=names)
        plate.create_position("A", "1", "0").create_image(
            "0", raw, transform=[TransformationMeta(type="scale", scale=scale)])
        del raw
        psf_plate = open_ome_zarr(tmp / "psf.zarr", layout="hcs", mode="w",
                                  channel_names=["PSF"])
        psf_plate.create_position("0", "0", "0").create_image(
            "0", psf[None, None], transform=[TransformationMeta(type="scale", scale=scale)])
        _, users = fuse_plate_settings()
        (tmp / "fuse.yml").write_text(yaml_flow(users) + "\n")
        (tmp / "deconvolve.yml").write_text(yaml_flow({"regularization_strength": REG}) + "\n")
        positions = [tmp / "raw.zarr" / "A" / "1" / "0"]
        n_units = FUSE_T * FUSE_C

        def run(verb: str, mesh: Mesh, out: Path):
            if verb == "fuse":
                fuse_verb.fuse(positions, tmp / "fuse.yml", out, psf_dirpath=tmp / "psf.zarr",
                               cluster="local", monitor=False, device=dev, mesh=mesh)
            else:
                deconvolve_verb.deconvolve(positions, tmp / "psf.zarr", tmp / "deconvolve.yml",
                                           out, monitor=False, device=dev, mesh=mesh)

        def shard_run(verb: str, mesh: Mesh, tag: str) -> np.ndarray:
            """The verb over ``mesh``: its plate, after the checks that each
            shard launched the verb's kernels and the runner saw the mesh."""
            out = tmp / f"{verb}-{tag}.zarr"
            buf = io.StringIO()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                _, launches, by_stream = launches_by_stream(lambda: run(verb, mesh, out))
            seconds = time.perf_counter() - t0
            stats = [json.loads(line[len("RUN_STATS:"):]) for line in buf.getvalue().splitlines()
                     if line.startswith("RUN_STATS:")][-1]
            require(stats["n_shards"] == mesh.size and stats["n_units"] == n_units,
                    f"29 {verb} over {tag}: RUN_STATS {stats}")
            full = [key for key, per in by_stream.items()
                    if all(per.get(k, 0) >= 1 for k in SHARD_KERNELS[verb])]
            require(len(full) >= mesh.size,
                    f"29 {verb} over {tag}: {len(full)} of {mesh.size} shards launched "
                    f"{SHARD_KERNELS[verb]} ({by_stream})")
            if mesh.size > 1:
                cards = sorted({key[0] for key in full})
                require(cards == sorted({d.index for d in mesh.devices}),
                        f"29 {verb} over {tag}: kernels launched on cards {cards}")
            wall = stats["wall_s"]
            split = ", ".join(f"{k[:-2]} {1e3 * stats[k] / n_units:.3f} ms/volume "
                              f"({stats[k] / wall:.1%})"
                              for k in ("read_s", "h2d_s", "device_s", "d2h_s", "write_s"))
            print(f"29 {verb} verb over {tag} ({mesh.size} shards, T {FUSE_T}, C {FUSE_C}, "
                  f"uint16 {SHAPE}): {1e3 * seconds:.1f} ms the whole call (host clock), "
                  f"{1e3 * seconds / n_units:.1f} ms/volume; the runner {1e3 * wall:.1f} ms; "
                  f"split of its wall: {split}; launches {launches}; streams with every "
                  f"kernel {len(full)}; card {card}; "
                  f"{time.perf_counter() - phase_t0:.1f} s into the phase")
            return open_ome_zarr(out / "A" / "1" / "0").data[...]

        one: dict = {}
        for verb in ("fuse", "deconvolve"):
            one[verb] = shard_run(verb, Mesh((dev,)), "1 shard")
            got = shard_run(verb, Mesh.virtual(dev, SHARDS_N), f"Mesh.virtual({dev}, {SHARDS_N})")
            require(np.array_equal(got.view(np.int32), one[verb].view(np.int32)),
                    f"29a {verb}: the plate over {SHARDS_N} shards differs from one shard's")
            print(f"29a {verb}: the plate over {SHARDS_N} shards of one card bit-equal to one "
                  "shard's; each shard launched the verb's kernels")
        if n_cards > 1:
            cards = get_mesh(device="cuda")
            for verb in ("fuse", "deconvolve"):
                got = shard_run(verb, cards, f"get_mesh() ({n_cards} cards)")
                require(np.array_equal(got.view(np.int32), one[verb].view(np.int32)),
                        f"29b {verb}: the plate over {n_cards} cards differs from one card's")
                print(f"29b {verb}: the plate over {n_cards} cards bit-equal to one card's")
        else:
            print("29b did not run: this process has one card (torch.cuda.device_count() == "
                  "1); a mesh of real cards needs two or more")
        del one

        if n_cards >= PG_FFT_RANKS:
            vol = np.random.default_rng(29).random(SHAPE, dtype=np.float32)
            tf_half = compute_transfer_function(psf, SHAPE)[..., : SHAPE[2] // 2 + 1]
            np.save(tmp / "volume.npy", vol)
            np.save(tmp / "tf_half.npy", tf_half)
            want = deconvolve_zyx(vol, tf_half, REG, device=dev).cpu().numpy()
            procs = []
            port = free_port()
            for rank in range(PG_FFT_RANKS):
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "--pg-fft-worker", str(rank),
                     str(PG_FFT_RANKS), str(port), str(tmp)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            outputs = []
            try:
                for p in procs:
                    outputs.append(p.communicate(timeout=PG_FFT_LIMIT_S)[0])
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            for rank, (p, text) in enumerate(zip(procs, outputs)):
                require(p.returncode == 0, f"29c rank {rank} exited {p.returncode}:\n{text}")
            got = np.concatenate([np.load(tmp / f"pg-{rank}.npy")
                                  for rank in range(PG_FFT_RANKS)])
            err = float(np.abs(got - want).max() / np.abs(want).max())
            require(err <= 1e-5, f"29c process-group FFT rel err {err:.3g} > 1e-5")
            lines = [ln for text in outputs for ln in text.splitlines()
                     if ln.startswith("PG-FFT ")]
            print(f"29c process-group sharded FFT ({PG_FFT_RANKS} NCCL processes, one card "
                  f"each, {SHAPE}): rel err {err:.3g} against the one-process route (tol "
                  f"1e-5), bit-equal {np.array_equal(got.view(np.int32), want.view(np.int32))}; "
                  f"{'; '.join(lines)}; card {card}")
        else:
            print(f"29c did not run: the process-group FFT takes {PG_FFT_RANKS} processes on "
                  f"{PG_FFT_RANKS} cards and this machine has {n_cards}; NCCL refuses two "
                  "ranks on one card")
        print(f"29 done in {time.perf_counter() - phase_t0:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def pg_fft_worker(argv: list[str]) -> int:
    """One rank of phase 29c: ``chip_smoke.py --pg-fft-worker RANK NRANKS
    PORT DIR``. Starts the group on ``tcp://localhost:PORT`` (NCCL with a
    card, rank r on card r; gloo on the CPU otherwise), runs
    ``deconvolve_zyx_sharded`` over the global mesh on its rows of
    ``DIR/volume.npy`` and writes its slabs to ``DIR/pg-RANK.npy``, with
    the sharded call's CUDA-event median (:func:`time_ms`)."""
    from pathlib import Path

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from biahub_tpu_torch.parallel import distributed
    from biahub_tpu_torch.parallel.mesh import Mesh, get_global_mesh
    from biahub_tpu_torch.parallel.sharded_fft import (
        deconvolve_zyx_sharded,
        gather,
        prepare_sharded_filter,
    )

    rank, nranks, port, tmp = int(argv[0]), int(argv[1]), argv[2], Path(argv[3])
    cuda = torch.cuda.is_available()
    dev = torch.device("cuda", rank) if cuda else torch.device("cpu")
    if cuda:
        torch.cuda.set_device(dev)
    distributed.maybe_initialize_distributed(f"tcp://localhost:{port}", nranks, rank)
    vol = np.load(tmp / "volume.npy", mmap_mode="r")
    rows = vol.shape[0] // nranks
    mine = torch.from_numpy(np.array(vol[rank * rows:(rank + 1) * rows])).to(dev)
    mesh = get_global_mesh(Mesh((dev,)))
    prepared = prepare_sharded_filter(vol.shape, np.load(tmp / "tf_half.npy"), REG, mesh)
    slabs = deconvolve_zyx_sharded(mine, None, mesh, prepared=prepared)
    np.save(tmp / f"pg-{rank}.npy", gather(slabs, "cpu").numpy())
    note = ""
    if cuda:
        ms = time_ms(lambda: deconvolve_zyx_sharded(mine, None, mesh, prepared=prepared))
        note = f", {ms:.4f} ms a volume (CUDA-event median of the sharded call)"
    distributed.barrier("pg-fft-done")
    print(f"PG-FFT rank {rank}/{nranks} on {dev}{note}", flush=True)
    torch.distributed.destroy_process_group()
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--pg-fft-worker"]:
        return pg_fft_worker(sys.argv[2:])
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
    from biahub_tpu_torch import _native

    t0 = time.perf_counter()
    _native.library()
    print(f"host helper: {time.perf_counter() - t0:.1f} s ({_native._compiler()} "
          f"{' '.join(_native.CXX_FLAGS)} _native/fastops.cpp)")

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
    gbx_phase(dev, records)
    fuse_phase(dev, tf_half)
    plates_phase(dev, psf)
    estimate_plates_phase(dev)
    assembly_plates_phase(dev, psf)
    model_plates_phase(dev)
    codecs_phase(dev, psf)
    leftovers_phase(dev, records)
    shards_phase(dev, psf)

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
