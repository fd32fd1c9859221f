"""``python -m biahub_tpu_torch.cli <verb> ...``: the port's command line.

The verbs and options of the reference's ``biahub`` command
(``biahub_tpu/cli/main.py``) for what the port runs on plates: ``fuse``,
``deconvolve``, ``deskew``, ``flat-field``, ``register`` and
``stabilize``. Every other verb of the reference exits with status 2 and
says that it is not ported yet. The verbs run on the card and raise without
one; :func:`main` takes the device as a Python argument (the tests pass
``device="cpu"``).
"""

from __future__ import annotations

import argparse
import os
import sys

from biahub_tpu_torch.cli import parsing as P

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

# verb: the options after -i/-c/-o (as the reference's decorators order them)
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
}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m biahub_tpu_torch.cli",
        description="command-line tools for biahub (PyTorch/CUDA port)")
    sub = parser.add_subparsers(dest="verb", metavar="<verb>")
    for name, help_text in COMMANDS:
        if name in PORTED:
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
    common = {}
    if hasattr(ns, "config_filepath"):
        common["config_filepath"] = _existing(ns.config_filepath, "config file", False)
    common["output_dirpath"] = ns.output_dirpath
    if getattr(ns, "sbatch_filepath", None) is not None:
        _existing(ns.sbatch_filepath, "sbatch file", False)
    common["sbatch_filepath"] = ns.sbatch_filepath
    common["monitor"] = ns.monitor
    common["device"] = device
    if ns.verb in ("deskew", "flat-field", "fuse"):
        common.update(cluster=ns.cluster, init_only=ns.init_only, resume=ns.resume)
    else:
        common["local"] = ns.local
    if ns.verb == "register":
        from biahub_tpu_torch.register import register

        register(P.position_dirpaths(ns.source_position_dirpaths),
                 P.position_dirpaths(ns.target_position_dirpaths), **common)
        return
    inputs = P.position_dirpaths(ns.input_position_dirpaths)
    if ns.verb == "stabilize":
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
    """Run one verb; returns the exit status. Unported verbs return 2 with
    a message; usage errors exit with status 2 (argparse); a failure of the
    run raises."""
    argv = list(sys.argv[1:] if argv is None else argv)
    names = [name for name, _ in COMMANDS]
    if argv and argv[0] in names and argv[0] not in PORTED:
        print(f"biahub_tpu_torch: the verb '{argv[0]}' is not ported yet; the port runs "
              f"{', '.join(PORTED)}.", file=sys.stderr)
        return 2
    parser = build_parser()
    ns = parser.parse_args(argv)
    if ns.verb is None:
        parser.print_help(sys.stderr)
        return 2
    if os.environ.get("BIAHUB_TPU_COORDINATOR") or os.environ.get("BIAHUB_TPU_DISTRIBUTED"):
        from biahub_tpu_torch.parallel.distributed import maybe_initialize_distributed

        maybe_initialize_distributed()
    try:
        _run(ns, device)
    except P.UsageError as exc:
        sub = parser._subparsers._group_actions[0].choices[ns.verb]
        sub.error(str(exc))
    return 0


if __name__ == "__main__":
    sys.exit(main())
