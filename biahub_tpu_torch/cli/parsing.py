"""The verbs' options, as argparse arguments.

Counterpart of ``biahub_tpu/cli/parsing.py``: the same flags, short names
and defaults. Position lists take every following argument (``-i
plate.zarr/*/*/*`` as the shell expands it); patterns the shell left
unexpanded are expanded here, and the positions are sorted in natural
order (``2`` before ``10``).
"""

from __future__ import annotations

import argparse
import glob
import re
from pathlib import Path

__all__ = [
    "UsageError",
    "CommandError",
    "natsorted",
    "position_dirpaths",
    "config_paths",
    "input_position_dirpaths",
    "source_position_dirpaths",
    "target_position_dirpaths",
    "config_filepath",
    "config_filepaths",
    "output_dirpath",
    "output_filepath",
    "psf_dirpath",
    "transfer_function_dirpath",
    "registration_channels",
    "point_files",
    "display_viewer",
    "sbatch_filepath",
    "local",
    "cluster",
    "init_only",
    "monitor",
    "resume",
    "num_processes",
    "estimate_stitch_options",
    "stitch_options",
    "concat_data_paths",
    "flip_options",
    "pyramid_options",
    "input_images_path",
    "estimate_deskew_options",
    "lf_mask_radius",
    "disk_space_options",
    "crop_background_arguments",
    "nf_commands",
]

_NAT_SPLIT = re.compile(r"(\d+)")


class UsageError(Exception):
    """A bad command-line value: the command exits with status 2 and its usage."""


class CommandError(Exception):
    """A failure the command reports as the reference's ``click.
    ClickException``: ``Error: <message>`` on stderr, exit status 1, no
    traceback."""


def _natural_key(s) -> tuple:
    return tuple(int(tok) if tok.isdigit() else tok.lower() for tok in _NAT_SPLIT.split(str(s)))


def natsorted(values):
    """Natural-order sort: '2' before '10'."""
    return sorted(values, key=_natural_key)


def _expand(values) -> list[str]:
    out = []
    for v in values:
        out.extend(glob.glob(v) if glob.has_magic(v) else [v])
    return out


def position_dirpaths(values) -> list[Path]:
    """The position directories named by ``values``, in natural order;
    raises on none, or on an HCS plate in place of a position."""
    from biahub_tpu_torch.io.ngff import Plate, open_ome_zarr

    paths = [p for p in map(Path, natsorted(_expand(values))) if p.is_dir()]
    if not paths:
        raise UsageError(f"No input positions found in {tuple(values)}")
    if isinstance(open_ome_zarr(paths[0], mode="r"), Plate):
        raise UsageError(
            "Please supply a single position instead of an HCS plate. Likely "
            "fix: replace 'input.zarr' with 'input.zarr/0/0/0'"
        )
    return paths


def config_paths(values) -> list[Path]:
    """Settings files matching ``values``: existing ``.yml``/``.yaml`` files."""
    matched = []
    for pattern in values:
        expanded = glob.glob(pattern)
        if not expanded:
            raise UsageError(f"No files matched pattern: {pattern}")
        matched.extend(expanded)
    out = []
    for p in natsorted(map(Path, matched)):
        if not p.is_file():
            raise UsageError(f"Expected a file, not a directory: {p}")
        if p.suffix.lower() not in (".yml", ".yaml"):
            raise UsageError(f"Expected a .yml file, got: {p}")
        out.append(p)
    return out


def _positions(parser, flags, dest, help_text) -> None:
    parser.add_argument(*flags, dest=dest, nargs="+", required=True, metavar="PATH",
                        help=help_text)


def input_position_dirpaths(parser: argparse.ArgumentParser) -> None:
    _positions(parser, ("--input-position-dirpaths", "-i"), "input_position_dirpaths",
               'Paths to input positions, for example: "input.zarr/0/0/0", '
               '"input.zarr/0/0/[0-9]", or "input.zarr/*/*/*"')


def source_position_dirpaths(parser: argparse.ArgumentParser) -> None:
    _positions(parser, ("--source-position-dirpaths", "-s"), "source_position_dirpaths",
               'Paths to source positions, for example: "source.zarr/0/0/0" or '
               '"source.zarr/*/*/*"')


def target_position_dirpaths(parser: argparse.ArgumentParser) -> None:
    _positions(parser, ("--target-position-dirpaths", "-t"), "target_position_dirpaths",
               'Paths to target positions, for example: "target.zarr/0/0/0" or '
               '"target.zarr/*/*/*"')


def config_filepath(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--config-filepath", "-c", required=True, type=Path,
                        help="Path to YAML configuration file.")


def config_filepaths(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--config-filepaths", "-c", nargs="+", required=True, metavar="PATH",
                        help="Paths to YAML configuration files. All must be existing files "
                             "with .yml extension.")


def output_dirpath(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--output-dirpath", "-o", required=True, type=Path,
                        help="Path to output directory")


def output_filepath(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--output-filepath", "-o", required=True, type=Path,
                        help="Path to output file")


def transfer_function_dirpath(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--transfer-function-dirpath", "-t", required=True, type=Path,
                        help="Path to the transfer function zarr written by compute-tf")


def registration_channels(parser: argparse.ArgumentParser) -> None:
    """estimate-registration's ``-rt`` and ``-rs`` (the latter repeats)."""
    parser.add_argument("--registration-target-channel", "-rt", default=None,
                        help="Name of the target channel to be used when registration params "
                             "are applied. If not provided, the target channel from the "
                             "config file will be used.")
    parser.add_argument("--registration-source-channel", "-rs", action="append", default=[],
                        help="Name of the source channels to be used when registration params "
                             "are applied. May be passed multiple times. If not provided, the "
                             "source channels from the config file will be used.")


def point_files(parser: argparse.ArgumentParser) -> None:
    """The manual method's headless point files."""
    parser.add_argument("--source-points", default=None,
                        help="Manual method, headless: (N, 3) ZYX source point file "
                             "(.csv/.npy) picked on the pre-aligned overlay.")
    parser.add_argument("--target-points", default=None,
                        help="Manual method, headless: (N, 3) ZYX target point file "
                             "(.csv/.npy) matching --source-points pair for pair.")
    parser.add_argument("--source-points-frame", choices=["pre_aligned", "original"],
                        default="pre_aligned",
                        help="Frame of --source-points: 'pre_aligned' or 'original'. "
                             "(default: pre_aligned)")


def display_viewer(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--display-viewer", "-d", action="store_true",
                        help="Display the registered channels in a napari viewer")


def psf_dirpath(parser: argparse.ArgumentParser, required: bool) -> None:
    parser.add_argument("--psf-dirpath", "-p", required=required, type=Path, default=None,
                        help="Path to psf.zarr" + ("" if required else
                                                   " (required when the config has a "
                                                   "deconvolve stage)"))


def sbatch_filepath(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--sbatch-filepath", "-sb", default=None,
                        help="Resource override file accepted for compatibility with the "
                             "Slurm-era CLI; overrides are printed, execution is on the card.")


def num_processes(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--num-processes", "-j", type=int, default=1,
                        help="Number of parallel processes")


def local(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--local", "-l", action="store_true",
                        help="Run jobs locally (compatibility flag; always local).")


def cluster(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--cluster", type=str.lower, choices=["slurm", "local", "debug"],
                        default="slurm",
                        help="Execution mode: 'debug' runs batches synchronously; 'local' "
                             "(and 'slurm', kept for compatibility) pipeline them. "
                             "(default: slurm)")


def init_only(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--init", "--init-only", dest="init_only", action="store_true",
                        help="Only initialize the output store and exit; skip per-position "
                             "processing.")


def monitor(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--monitor", "-m", action="store_true",
                        help="Monitor progress of submitted jobs.")


def resume(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--resume", action=argparse.BooleanOptionalAction, default=False,
                        help="Skip the (time, channel) units this position already finished "
                             "in an earlier attempt. A changed config invalidates prior "
                             "records. (default: --no-resume)")


def estimate_stitch_options(parser: argparse.ArgumentParser) -> None:
    """estimate-stitch's flips, PCC refinement and ``--add_offset``."""
    parser.add_argument("--fliplr", action="store_true",
                        help="Flip images left-right before stitching")
    parser.add_argument("--flipud", action="store_true",
                        help="Flip images up-down before stitching")
    parser.add_argument("--flipxy", action="store_true",
                        help="Flip images along the diagonal before stitching")
    parser.add_argument("--pcc-channel-name", default=None, type=str,
                        help="Channel name to use for phase cross-correlation optimization "
                             "(default: None, disables optimization)")
    parser.add_argument("--pcc-z-index", default=0, type=int,
                        help="Z slice index to use for phase cross-correlation optimization "
                             "(default: 0)")
    parser.add_argument("--add_offset", action="store_true",
                        help="add the offset to estimated shifts, needed for OPS experiments")


def stitch_options(parser: argparse.ArgumentParser) -> None:
    """stitch's ``-v``, ``-b`` and ``--debug``."""
    parser.add_argument("--verbose", "-v", action="store_true",
                        help="Verbose stitching output. Default is False.")
    parser.add_argument("--blending-exponent", "-b", type=float, default=1.0,
                        help="Exponent for blending weights. 0.0 is average blending, 1.0 is "
                             "linear blending, and >1.0 is progressively sharper S-curve "
                             "blending.")
    parser.add_argument("--debug", action="store_true", help="Run in debug mode")


def concat_data_paths(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--concat-data-paths", action="append", default=[], type=str,
                        help="Resolve mode: inject these concat_data_paths into the config and "
                             "write the resolved config to -o (a YAML file), then exit. Repeat "
                             "the flag once per source store.")


def flip_options(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("-x", action="store_true", help="Enable the x flag.")
    parser.add_argument("-y", action="store_true", help="Enable the y flag.")


def pyramid_options(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--levels", "-lv", type=int, default=4,
                        help="Total number of resolution levels including level 0. E.g., "
                             "levels=4 creates 0, 1, 2, 3. (default: 4)")
    parser.add_argument("--method", "-m", default="mean",
                        choices=["stride", "median", "mode", "mean", "min", "max"],
                        help="Downsampling method to use. (default: mean)")


def input_images_path(parser: argparse.ArgumentParser) -> None:
    """track's ``--input-images-path`` (an existing path)."""
    parser.add_argument("--input-images-path", default=None,
                        help="Pixel-data source filling the first null input_images path (used "
                             "by pipelines). If omitted, that null path falls back to the -i "
                             "input plate.")


def estimate_deskew_options(parser: argparse.ArgumentParser) -> None:
    """estimate-deskew's measurements, point files and ``--interactive``."""
    parser.add_argument("--pixel-size-um", type=float, default=None,
                        help="Image pixel size (um).")
    parser.add_argument("--scan-step-um", type=float, default=None,
                        help="Estimated galvo scan step (um).")
    parser.add_argument("--px-to-scan-ratio", type=float, default=None,
                        help="Measured px_to_scan_ratio (skip the rectangle measurement).")
    parser.add_argument("--ls-angle-deg", type=float, default=None,
                        help="Measured light-sheet angle in degrees (skip the line "
                             "measurement).")
    parser.add_argument("--rect-points", default=None,
                        help="(4, 3) rectangle-corner file (.csv/.npy) in (scan, tilt, "
                             "coverslip) order, exported from any viewer; measures "
                             "px_to_scan_ratio.")
    parser.add_argument("--line-points", default=None,
                        help="(2, 2) coverslip-normal line file (.csv/.npy) on the X "
                             "projection; measures the light-sheet angle.")
    parser.add_argument("--interactive", action="store_true",
                        help="Measure in napari as the reference does (requires napari).")


def lf_mask_radius(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--lf-mask-radius", type=float, default=None,
                        help="(Optional) Radius of the circular mask given as fraction of "
                             "image width to apply to the phase channel.")


def disk_space_options(parser: argparse.ArgumentParser) -> None:
    """check-disk-space's ``-i``, ``-o``, ``--margin`` and ``--verbose``
    (on by default, as in the reference)."""
    parser.add_argument("--input-path", "-i", required=True,
                        help="Path whose size determines the space the output will need.")
    parser.add_argument("--output-path", "-o", required=True,
                        help="Destination whose filesystem is checked for free space.")
    parser.add_argument("--margin", type=float, default=1.1,
                        help="Safety margin for the disk space check (1.1 = 10%% extra). "
                             "(default: 1.1)")
    parser.add_argument("--verbose", action="store_true", default=True,
                        help="Print detailed diagnostics.")


def crop_background_arguments(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("input_dir", metavar="INPUT_DIR",
                        help="Folder of the *.mp4 videos (an existing folder).")
    parser.add_argument("output_dir", metavar="OUTPUT_DIR", help="Folder of the crops.")


def nf_commands(parser: argparse.ArgumentParser) -> None:
    """The ``nf`` group: ``list-positions PLATE_PATH``."""
    sub = parser.add_subparsers(dest="nf_command", metavar="<command>", required=True)
    lp = sub.add_parser("list-positions",
                        help="Print one row/col/fov position key per line for Nextflow "
                             "fan-out.")
    lp.add_argument("plate_path", metavar="PLATE_PATH", help="An existing plate folder.")
