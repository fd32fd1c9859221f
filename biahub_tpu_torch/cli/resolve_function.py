"""Allow-listed name -> function lookup for the settings' processing steps.

Counterpart of ``biahub_tpu/cli/resolve_function.py``: only NumPy's
functions (``np.<name>``), ``ultrack.imgproc``'s where that package imports,
and functions registered through ``custom_functions`` may be named in a
settings file; any other name raises the reference's error.
"""

from __future__ import annotations

import numpy as np

__all__ = ["VALID_MODULES", "FUNCTION_MAP", "resolve_function"]

VALID_MODULES = {"np": np}

try:  # optional; absent on the card's machine
    import ultrack  # type: ignore

    VALID_MODULES["ultrack.imgproc"] = ultrack.imgproc
except ImportError:
    pass

#: Filled on the first lookup: listing NumPy's callables imports its lazy
#: submodules (``numpy.testing`` runs ``lscpu``), which an import must not.
FUNCTION_MAP: dict = {}


def _function_map() -> dict:
    if not FUNCTION_MAP:
        FUNCTION_MAP.update({
            f"{module_name}.{func}": getattr(module, func)
            for module_name, module in VALID_MODULES.items()
            for func in dir(module)
            if callable(getattr(module, func)) and not func.startswith("__")
        })
    return FUNCTION_MAP


def resolve_function(function_name: str, custom_functions: dict | None = None):
    """The callable named ``function_name``; ``custom_functions`` are
    registered first (and stay registered, as in the reference)."""
    function_map = _function_map()
    if custom_functions is not None:
        function_map.update(custom_functions)
    if function_name not in function_map:
        raise ValueError(
            f"Invalid function '{function_name}'. Allowed functions: "
            f"{list(function_map.keys())}"
        )
    return function_map[function_name]
