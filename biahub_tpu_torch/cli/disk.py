"""Disk-space preflight.

Counterpart of ``biahub_tpu/cli/disk.py`` (the check-disk-space verb and
stabilize's preflight).
"""

from __future__ import annotations

import shutil
import subprocess
from pathlib import Path

__all__ = ["get_size_bytes", "check_disk_space_with_du"]


def get_size_bytes(path: str | Path) -> int:
    """Total size of a file or directory (``du -sb``, else a walk)."""
    try:
        out = subprocess.run(["du", "-sb", str(path)], capture_output=True, text=True,
                             check=True)
        return int(out.stdout.split()[0])
    except (subprocess.CalledProcessError, FileNotFoundError, ValueError, IndexError):
        p = Path(path)
        if p.is_file():
            return p.stat().st_size
        return sum(f.stat().st_size for f in p.rglob("*") if f.is_file())


def check_disk_space_with_du(input_path: str | Path, output_path: str | Path,
                             margin: float = 1.1, verbose: bool = False) -> bool:
    """True when the output's filesystem has ``margin`` x the input's size free."""
    input_size = get_size_bytes(input_path)
    required = int(input_size * margin)
    out_parent = Path(output_path).resolve()
    while not out_parent.exists():
        out_parent = out_parent.parent
    free = shutil.disk_usage(out_parent).free
    if verbose:
        print(f"Disk preflight: input={input_size / 2**30:.2f} GiB, "
              f"required={required / 2**30:.2f} GiB, free={free / 2**30:.2f} GiB")
    return free >= required
