"""Plots: matplotlib only where it is installed.

A plot is never a verb's result, so a verb asked for one where matplotlib
is missing (the card's machine has none) writes everything else and says on
stderr which file it did not write.
"""

from __future__ import annotations

import sys
from pathlib import Path

__all__ = ["pyplot"]


def pyplot(output_path):
    """``matplotlib.pyplot`` on the Agg backend, with ``output_path``'s
    folder made; or None, after one stderr line naming ``output_path``, when
    matplotlib is not installed."""
    try:
        import matplotlib
    except ImportError:
        print(f"biahub_tpu_torch: matplotlib is not installed; plot {output_path} not "
              "written", file=sys.stderr)
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    Path(output_path).parent.mkdir(parents=True, exist_ok=True)
    return plt
