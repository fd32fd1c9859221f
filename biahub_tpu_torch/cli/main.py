"""``python -m biahub_tpu_torch.cli <verb> ...``: the port's command line.

The verbs and options of the reference's ``biahub`` command
(``biahub_tpu/cli/main.py``), all 29 of its entries: the plate verbs,
the estimate verbs, the model verbs, ``process-with-config``,
``characterize-psf``, ``check-disk-space``, ``crop-background`` and the
``nf`` group (``nf list-positions``). A bad option exits with status
2 and the verb's usage; a failure the reference reports as a
``click.ClickException`` (:class:`~biahub_tpu_torch.cli.parsing.
CommandError`) prints ``Error: <message>`` and exits with status 1. The
verbs run on the card and raise without one; :func:`main` takes the device
as a Python argument (the tests pass ``device="cpu"``). A verb runs
inside :func:`~biahub_tpu_torch.runtime.profiling.profiled_section`:
``BIAHUB_TPU_PROFILE=1`` prints its wall time, ``BIAHUB_TPU_PROFILE=<dir>``
also writes its trace there and prints its device-time table.
"""

from __future__ import annotations

import argparse
import os
import sys

from biahub_tpu_torch.cli import parsing as P
from biahub_tpu_torch.runtime.profiling import profiled_section

__all__ = ["COMMANDS", "PORTED", "main"]

# The reference's verbs, in its order (biahub_tpu/cli/main.py:84-141).
COMMANDS = [
    ("estimate-bleaching", "Estimate bleaching from raw data"),
    ("estimate-deskew", "Routine for estimating deskewing parameters"),
    ("deskew", "Deskew a single position across T and C axes"),
    ("estimate-registration", "Estimate affine transform between timepoints or arms"),
    ("flat-field", "Apply flat field correction to selected channels"),
    ("flip", "Flip images in a dataset"),
    ("optimize-registration", "Optimize transform based on match filtering"),
    ("pyramid", "Create pyramid levels for a dataset"),
    ("register", "Apply an affine transformation to a single position"),
    ("estimate-stitch", "Estimate stitching parameters for positions"),
    ("stitch", "Stitch positions in wells of a zarr store"),
    ("concatenate", "Concatenate datasets (with optional cropping)"),
    ("estimate-stabilization", "Estimate translation matrices for XYZ stabilization"),
    ("stabilize", "Apply stabilization transforms to dataset"),
    ("estimate-crop", "Estimate crop region for dual-channel alignment"),
    ("compute-tf", "Compute transfer function using PSF"),
    ("apply-inv-tf", "Apply inverse transfer function to dataset"),
    ("reconstruct", "Reconstruct a dataset using config"),
    ("fuse", "Fuse deconvolve/deskew/warps into one device program"),
    ("estimate-psf", "Estimate point spread function from beads"),
    ("deconvolve", "Deconvolve across T and C axes using a PSF"),
    ("characterize-psf", "Characterize point spread function (PSF)"),
    ("segment", "Segment a position using pretrained model or pipeline"),
    ("virtual-stain", "Run virtual staining"),
    ("process-with-config", "Process data with YAML-defined functions"),
    ("track", "Track objects in 2D/3D time-lapse microscopy"),
    ("check-disk-space", "Check disk space using du -sb"),
    ("crop-background", "Crop video backgrounds with ffmpeg"),
    ("nf", "Nextflow utilities"),
]

_PLATE_VERB = [P.sbatch_filepath, P.cluster, P.monitor, P.init_only, P.resume, P.num_processes]

# verb: its options and arguments (as the reference's decorators order them)
PORTED = {
    "deskew": [P.input_position_dirpaths, P.config_filepath, P.output_dirpath, *_PLATE_VERB],
    "flat-field": [P.input_position_dirpaths, P.config_filepath, P.output_dirpath,
                   *_PLATE_VERB],
    "fuse": [P.input_position_dirpaths, P.config_filepath, P.output_dirpath,
             lambda p: P.psf_dirpath(p, required=False), *_PLATE_VERB],
    "deconvolve": [P.input_position_dirpaths, lambda p: P.psf_dirpath(p, required=True),
                   P.config_filepath, P.output_dirpath, P.sbatch_filepath, P.local, P.monitor],
    "register": [P.source_position_dirpaths, P.target_position_dirpaths, P.config_filepath,
                 P.output_dirpath, P.local, P.sbatch_filepath, P.monitor],
    "stabilize": [P.input_position_dirpaths, P.output_dirpath, P.config_filepaths,
                  P.sbatch_filepath, P.local, P.monitor],
    "compute-tf": [P.input_position_dirpaths, P.config_filepath, P.output_dirpath],
    "apply-inv-tf": [P.input_position_dirpaths, P.transfer_function_dirpath,
                     P.config_filepath, P.output_dirpath, P.sbatch_filepath, P.cluster,
                     P.monitor, P.init_only],
    "reconstruct": [P.input_position_dirpaths, P.config_filepath, P.output_dirpath,
                    P.sbatch_filepath, P.cluster, P.monitor],
    "estimate-stabilization": [P.input_position_dirpaths, P.output_dirpath,
                               P.config_filepath, P.sbatch_filepath, P.local],
    "estimate-psf": [P.input_position_dirpaths, P.config_filepath, P.output_dirpath],
    "estimate-registration": [P.source_position_dirpaths, P.target_position_dirpaths,
                              P.output_filepath, P.config_filepath, P.sbatch_filepath,
                              P.local, P.registration_channels, P.point_files],
    "optimize-registration": [P.source_position_dirpaths, P.target_position_dirpaths,
                              P.config_filepath, P.output_filepath, P.display_viewer],
    "estimate-stitch": [P.input_position_dirpaths, P.output_filepath,
                        P.estimate_stitch_options, P.local, P.monitor],
    "stitch": [P.input_position_dirpaths, P.config_filepath, P.output_dirpath,
               P.sbatch_filepath, P.local, P.stitch_options, P.monitor],
    "concatenate": [P.config_filepath, P.output_dirpath, P.sbatch_filepath, P.cluster,
                    P.monitor, P.init_only, P.resume, P.num_processes, P.concat_data_paths],
    "flip": [P.input_position_dirpaths, P.flip_options],
    "pyramid": [P.input_position_dirpaths, P.sbatch_filepath, P.local, P.pyramid_options],
    "segment": [P.input_position_dirpaths, P.config_filepath, P.output_dirpath,
                P.sbatch_filepath, P.local, P.monitor],
    "virtual-stain": [P.input_position_dirpaths, P.config_filepath, P.output_dirpath,
                      P.sbatch_filepath, P.cluster, P.local, P.monitor, P.init_only],
    "track": [P.input_position_dirpaths, P.config_filepath, P.output_dirpath,
              P.sbatch_filepath, P.cluster, P.monitor, P.init_only, P.input_images_path],
    "estimate-bleaching": [P.input_position_dirpaths, P.output_dirpath],
    "estimate-deskew": [P.input_position_dirpaths, P.output_filepath,
                        P.estimate_deskew_options],
    "estimate-crop": [P.config_filepath, P.output_filepath, P.sbatch_filepath, P.local,
                      P.lf_mask_radius],
    "characterize-psf": [P.input_position_dirpaths, P.config_filepath, P.output_dirpath],
    "process-with-config": [P.input_position_dirpaths, P.config_filepath, P.output_dirpath,
                            P.sbatch_filepath, P.local, P.monitor],
    "check-disk-space": [P.disk_space_options],
    "crop-background": [P.crop_background_arguments],
    "nf": [P.nf_commands],
}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m biahub_tpu_torch.cli",
        description="command-line tools for biahub (PyTorch/CUDA port)")
    sub = parser.add_subparsers(dest="verb", metavar="<verb>")
    for name, help_text in COMMANDS:
        verb = sub.add_parser(name, help=help_text, description=help_text)
        for add in PORTED[name]:
            add(verb)
    return parser


def _existing(path, what: str, directory: bool):
    if path is None:
        return None
    ok = os.path.isdir(path) if directory else os.path.isfile(path)
    if not ok:
        raise P.UsageError(f"{what} '{path}' does not exist")
    return path


def _run(ns: argparse.Namespace, device) -> None:
    """Call the verb's store-level function with the parsed options."""
    verb = ns.verb
    config = _existing(ns.config_filepath, "config file", False) if hasattr(
        ns, "config_filepath") else None
    if getattr(ns, "sbatch_filepath", None) is not None:
        _existing(ns.sbatch_filepath, "sbatch file", False)
    if verb in ("concatenate", "estimate-crop", "check-disk-space", "crop-background", "nf"):
        _run_without_positions(ns, config)
        return
    if verb in ("register", "estimate-registration", "optimize-registration"):
        sources = P.position_dirpaths(ns.source_position_dirpaths)
        targets = P.position_dirpaths(ns.target_position_dirpaths)
    else:
        inputs = P.position_dirpaths(ns.input_position_dirpaths)
    if verb in ("estimate-stitch", "stitch", "flip", "pyramid"):
        _run_assembly_verb(ns, device, config, inputs)
    elif verb in ("virtual-stain", "segment", "track"):
        _run_model_verb(ns, device, config, inputs)
    elif verb in ("estimate-bleaching", "estimate-deskew", "characterize-psf",
                  "process-with-config"):
        _run_host_verb(ns, device, config, inputs)
    elif verb == "estimate-registration":
        from biahub_tpu_torch.estimate_registration import estimate_registration

        for points in (ns.source_points, ns.target_points):
            _existing(points, "point file", False)
        estimate_registration(sources, targets, ns.output_filepath, config,
                              ns.registration_target_channel, ns.registration_source_channel,
                              ns.sbatch_filepath, ns.local, ns.source_points,
                              ns.target_points, ns.source_points_frame, device=device)
    elif verb == "optimize-registration":
        from biahub_tpu_torch.optimize_registration import optimize_registration

        optimize_registration(sources, targets, config, ns.output_filepath,
                              ns.display_viewer, device=device)
    elif verb == "compute-tf":
        from biahub_tpu_torch.compute_transfer_function import compute_transfer_function

        compute_transfer_function(inputs[0], config, ns.output_dirpath, device=device)
        print(f"Transfer function computed and saved to {ns.output_dirpath}.")
    elif verb == "apply-inv-tf":
        from biahub_tpu_torch.apply_inverse_transfer_function import (
            apply_inverse_transfer_function,
        )

        apply_inverse_transfer_function(
            inputs, _existing(ns.transfer_function_dirpath, "transfer function store", True),
            config, ns.output_dirpath, ns.sbatch_filepath, ns.cluster, ns.monitor,
            ns.init_only, device=device)
    elif verb == "reconstruct":
        from biahub_tpu_torch.reconstruct import reconstruct

        reconstruct(inputs, config, ns.output_dirpath, ns.sbatch_filepath, ns.cluster,
                    ns.monitor, device=device)
    elif verb == "estimate-stabilization":
        from biahub_tpu_torch.estimate_stabilization import estimate_stabilization

        estimate_stabilization(inputs, ns.output_dirpath, config, ns.sbatch_filepath, ns.local,
                               device=device)
    elif verb == "estimate-psf":
        from biahub_tpu_torch.estimate_psf import estimate_psf

        estimate_psf(inputs, config, ns.output_dirpath, device=device)
    else:
        _run_plate_verb(ns, device, config, sources if verb == "register" else inputs,
                        targets if verb == "register" else None)


def _run_without_positions(ns: argparse.Namespace, config) -> None:
    """concatenate, estimate-crop, check-disk-space, crop-background and nf."""
    if ns.verb == "concatenate":
        from biahub_tpu_torch.concatenate import concatenate_verb

        concatenate_verb(config, ns.output_dirpath, ns.sbatch_filepath, ns.cluster, ns.monitor,
                         ns.init_only, ns.resume, tuple(ns.concat_data_paths),
                         ns.num_processes)
    elif ns.verb == "estimate-crop":
        from biahub_tpu_torch.estimate_crop import estimate_crop

        estimate_crop(config, ns.output_filepath, ns.lf_mask_radius, ns.sbatch_filepath,
                      ns.local)
    elif ns.verb == "check-disk-space":
        from biahub_tpu_torch.cli.disk import check_disk_space_with_du

        if check_disk_space_with_du(ns.input_path, ns.output_path, ns.margin, ns.verbose):
            print("Disk space check passed. Good to go!")
        else:
            print("Disk space check failed. Not enough space available.")
    elif ns.verb == "crop-background":
        from biahub_tpu_torch.visualize.crop_background import crop_background

        crop_background(_existing(ns.input_dir, "input directory", True), ns.output_dir)
    else:
        from biahub_tpu_torch.io.ngff import open_ome_zarr

        plate = open_ome_zarr(_existing(ns.plate_path, "plate", True), mode="r")
        for name, _ in plate.positions():
            print(name)


def _run_host_verb(ns: argparse.Namespace, device, config, inputs) -> None:
    """estimate-bleaching, estimate-deskew, characterize-psf and
    process-with-config."""
    if ns.verb == "estimate-bleaching":
        from biahub_tpu_torch.estimate_bleaching import estimate_bleaching

        estimate_bleaching(inputs, ns.output_dirpath, device=device)
    elif ns.verb == "estimate-deskew":
        from biahub_tpu_torch.estimate_deskew import estimate_deskew

        for points in (ns.rect_points, ns.line_points):
            _existing(points, "point file", False)
        estimate_deskew(ns.output_filepath, ns.pixel_size_um, ns.scan_step_um,
                        ns.px_to_scan_ratio, ns.ls_angle_deg, ns.rect_points, ns.line_points,
                        ns.interactive)
    elif ns.verb == "characterize-psf":
        from biahub_tpu_torch.characterize_psf import characterize_psf

        characterize_psf(inputs, config, ns.output_dirpath, device=device)
    else:
        from biahub_tpu_torch.process_data import process_with_config

        process_with_config(inputs, config, ns.output_dirpath, ns.sbatch_filepath, ns.local,
                            ns.monitor)


def _run_assembly_verb(ns: argparse.Namespace, device, config, inputs) -> None:
    """estimate-stitch, stitch, flip and pyramid."""
    if ns.verb == "estimate-stitch":
        from biahub_tpu_torch.estimate_stitch import estimate_stitch

        estimate_stitch(inputs, ns.output_filepath, ns.fliplr, ns.flipud, ns.flipxy,
                        ns.pcc_channel_name, ns.pcc_z_index, ns.add_offset, ns.local,
                        ns.monitor, device=device)
    elif ns.verb == "stitch":
        from biahub_tpu_torch.stitch import stitch

        stitch(inputs, config, ns.output_dirpath, ns.sbatch_filepath, ns.local, ns.verbose,
               ns.blending_exponent, ns.debug, ns.monitor, device=device)
    elif ns.verb == "flip":
        from biahub_tpu_torch.flip import flip

        flip(inputs, ns.x, ns.y)
    else:
        from biahub_tpu_torch.pyramid import pyramid_verb

        pyramid_verb(inputs, ns.levels, ns.method, ns.sbatch_filepath, ns.local)


def _run_model_verb(ns: argparse.Namespace, device, config, inputs) -> None:
    """virtual-stain, segment and track."""
    if ns.verb == "virtual-stain":
        from biahub_tpu_torch.virtual_stain import virtual_stain

        virtual_stain(inputs, config, ns.output_dirpath, ns.sbatch_filepath, ns.cluster,
                      ns.local, ns.monitor, ns.init_only, device=device)
    elif ns.verb == "segment":
        from biahub_tpu_torch.segment import segment

        segment(inputs, config, ns.output_dirpath, ns.sbatch_filepath, ns.local, ns.monitor,
                device=device)
    else:
        from biahub_tpu_torch.track import track

        track(inputs, config, ns.output_dirpath, ns.sbatch_filepath, ns.cluster, ns.monitor,
              ns.init_only, _existing(ns.input_images_path, "input images path", True),
              device=device)


def _run_plate_verb(ns: argparse.Namespace, device, config, inputs, targets) -> None:
    """The main path's verbs: fuse, deconvolve, deskew, flat-field,
    register and stabilize."""
    common = {"output_dirpath": ns.output_dirpath, "sbatch_filepath": ns.sbatch_filepath,
              "monitor": ns.monitor, "device": device}
    if config is not None:
        common["config_filepath"] = config
    if ns.verb in ("deskew", "flat-field", "fuse"):
        common.update(cluster=ns.cluster, init_only=ns.init_only, resume=ns.resume)
    else:
        common["local"] = ns.local
    if ns.verb == "register":
        from biahub_tpu_torch.register import register

        register(inputs, targets, **common)
    elif ns.verb == "stabilize":
        from biahub_tpu_torch.stabilize import stabilize

        stabilize(inputs, config_filepaths=P.config_paths(ns.config_filepaths), **common)
    elif ns.verb == "deskew":
        from biahub_tpu_torch.deskew import deskew

        deskew(inputs, **common)
    elif ns.verb == "flat-field":
        from biahub_tpu_torch.flat_field import flat_field

        flat_field(inputs, **common)
    elif ns.verb == "deconvolve":
        from biahub_tpu_torch.deconvolve import deconvolve

        deconvolve(inputs, psf_dirpath=_existing(ns.psf_dirpath, "PSF store", True), **common)
    elif ns.verb == "fuse":
        from biahub_tpu_torch.fuse import fuse

        fuse(inputs, psf_dirpath=_existing(ns.psf_dirpath, "PSF store", True), **common)


def main(argv=None, device="cuda") -> int:
    """Run one verb; returns the exit status. Usage errors exit with
    status 2 (argparse); a
    :class:`~biahub_tpu_torch.cli.parsing.CommandError` returns 1 with its
    message on stderr; any other failure of the run raises."""
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = build_parser()
    ns = parser.parse_args(argv)
    if ns.verb is None:
        parser.print_help(sys.stderr)
        return 2
    if os.environ.get("BIAHUB_TPU_COORDINATOR") or os.environ.get("BIAHUB_TPU_DISTRIBUTED"):
        from biahub_tpu_torch.parallel.distributed import maybe_initialize_distributed

        maybe_initialize_distributed()
    try:
        with profiled_section(ns.verb):
            _run(ns, device)
    except P.UsageError as exc:
        sub = parser._subparsers._group_actions[0].choices[ns.verb]
        if ns.verb == "nf":
            sub = sub._subparsers._group_actions[0].choices[ns.nf_command]
        sub.error(str(exc))
    except P.CommandError as exc:
        print(f"Error: {exc}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
