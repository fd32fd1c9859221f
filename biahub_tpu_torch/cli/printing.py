"""Console output helpers.

Counterpart of ``biahub_tpu/cli/printing.py``, without click: the headline
is green where standard output is a terminal and plain elsewhere, as
``click.echo`` prints a styled line; settings are the port's dicts.
"""

from __future__ import annotations

import sys

__all__ = ["echo_headline", "echo_settings"]


def echo_headline(headline: str) -> None:
    print(f"\x1b[32m{headline}\x1b[0m" if sys.stdout.isatty() else headline)


def echo_settings(settings: dict) -> None:
    for key, value in settings.items():
        print(f"  {key}: {value}")
