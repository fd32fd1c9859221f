"""A YAML writer for the values that settings files hold.

The card's machine has no pyyaml. :func:`dump` writes what PyYAML's
``yaml.dump(value, default_flow_style=False, sort_keys=False)`` writes for
dicts (in insertion order), lists, strings, ints, floats, bools and None:
block style with two-space indents, lists under a key at the key's indent,
nested lists as ``- - 1.0``, empty ones as ``[]`` and ``{}``; floats as
``repr`` (``.0`` put before an exponent that has no dot, ``.inf``,
``-.inf``, ``.nan``); strings plain where PyYAML writes them plain, else in
single quotes, or in double quotes with PyYAML's escapes where they hold
characters outside printable ASCII or line breaks (PyYAML writes line
breaks in single quotes; both read back the same). A string that would read back as
another type (``'1.0'``, ``'yes'``, ``'null'``, ``''``) is quoted. Long
strings are written on one line, where PyYAML folds plain ones at 80
columns, and an object that occurs twice is written out twice, where PyYAML
writes an anchor and an alias; both read back the same. Any other value (a tuple, a numpy scalar,
a tensor) raises ``TypeError`` naming its key: convert it first (the
reference's ``.tolist()`` calls).
"""

from __future__ import annotations

import re
from pathlib import Path

__all__ = ["dump", "dump_file"]

# PyYAML's implicit resolvers (resolver.py): a plain scalar that matches one
# of these reads back as something other than a string.
_IMPLICIT = [re.compile(p, re.X) for p in (
    r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON|off|Off|OFF)$",
    r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
        |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
        |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
        |[-+]?\.(?:inf|Inf|INF)
        |\.(?:nan|NaN|NAN))$""",
    r"""^(?:[-+]?0b[0-1_]+
        |[-+]?0[0-7_]+
        |[-+]?(?:0|[1-9][0-9_]*)
        |[-+]?0x[0-9a-fA-F_]+
        |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""",
    r"^(?:<<)$",
    r"^(?:~|null|Null|NULL|)$",
    r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
        |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?
         (?:[Tt]|[ \t]+)[0-9][0-9]?
         :[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?
         (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""",
    r"^(?:=)$",
    r"^(?:!|&|\*)$",
)]
_BREAKS = "\n\x85\u2028\u2029"
_WHITESPACE = "\0 \t\r" + _BREAKS
_ESCAPES = {"\0": "0", "\x07": "a", "\x08": "b", "\x09": "t", "\x0a": "n", "\x0b": "v",
            "\x0c": "f", "\x0d": "r", "\x1b": "e", '"': '"', "\\": "\\", "\x85": "N",
            "\xa0": "_", "\u2028": "L", "\u2029": "P"}


def _style(s: str) -> str:
    """PyYAML's choice for a string in block context (emitter.py's
    ``analyze_scalar`` and ``choose_scalar_style``): '' plain, "'" or '"'."""
    if any(p.match(s) for p in _IMPLICIT):
        return "'"  # '' reads back as null, the rest as their types
    block_indicators = s.startswith(("---", "..."))
    leading = s[0] in " " + _BREAKS
    trailing = s[-1] in " " + _BREAKS
    special = line_breaks = False
    preceded = True
    for i, ch in enumerate(s):
        followed = i + 1 >= len(s) or s[i + 1] in _WHITESPACE
        if i == 0:
            if ch in "#,[]{}&*!|>'\"%@`" or (ch in "?:-" and followed):
                block_indicators = True
        elif (ch == ":" and followed) or (ch == "#" and preceded):
            block_indicators = True
        if ch in _BREAKS:
            line_breaks = True
        if not (ch == "\n" or " " <= ch <= "~"):
            special = True  # PyYAML's default allow_unicode=False escapes the rest
        preceded = ch in _WHITESPACE
    if special or line_breaks:
        return '"'  # escaped; PyYAML writes line breaks in single quotes
    if leading or trailing or block_indicators:
        return "'"
    return ""


def _double_quoted(s: str) -> str:
    out = []
    for ch in s:
        if ch in _ESCAPES:
            out.append("\\" + _ESCAPES[ch])
        elif " " <= ch <= "~":
            out.append(ch)
        elif ch <= "\xff":
            out.append(f"\\x{ord(ch):02X}")
        elif ch <= "\uffff":
            out.append(f"\\u{ord(ch):04X}")
        else:
            out.append(f"\\U{ord(ch):08X}")
    return '"' + "".join(out) + '"'


def _float(x: float) -> str:
    if x != x:
        return ".nan"
    if x in (float("inf"), float("-inf")):
        return ".inf" if x > 0 else "-.inf"
    text = repr(x).lower()
    return text.replace("e", ".0e", 1) if "." not in text and "e" in text else text


def _scalar(value, where: str) -> str:
    kind = type(value)
    if value is None:
        return "null"
    if kind is bool:
        return "true" if value else "false"
    if kind is int:
        return str(value)
    if kind is float:
        return _float(value)
    if kind is str:
        style = _style(value)
        if style == "'":
            return "'" + value.replace("'", "''") + "'"
        return _double_quoted(value) if style == '"' else value
    raise TypeError(f"YAML writer: {where or 'the document'} is a {kind.__module__}."
                    f"{kind.__qualname__}; convert it to a plain Python value first "
                    "(e.g. with .tolist())")


def _inline(value, where: str) -> str:
    if type(value) is dict:
        return "{}"
    if type(value) is list:
        return "[]"
    return _scalar(value, where)


def _mapping(d: dict, col: int, inline: bool, where: str) -> str:
    out = []
    for i, (key, value) in enumerate(d.items()):
        at = f"{where}.{key}" if where else str(key)
        lead = "" if (i == 0 and inline) else " " * col
        if key == "":
            raise TypeError(f"YAML writer: {where or 'the document'} has an empty key")
        text = lead + _scalar(key, at + " (a key)") + ":"
        if type(value) is dict and value:
            out.append(text + "\n" + _mapping(value, col + 2, False, at))
        elif type(value) is list and value:
            out.append(text + "\n" + _sequence(value, col, False, at))
        else:
            out.append(text + " " + _inline(value, at) + "\n")
    return "".join(out)


def _sequence(seq: list, col: int, inline: bool, where: str) -> str:
    out = []
    for i, value in enumerate(seq):
        at = f"{where}[{i}]"
        lead = ("" if (i == 0 and inline) else " " * col) + "- "
        if type(value) is dict and value:
            out.append(lead + _mapping(value, col + 2, True, at))
        elif type(value) is list and value:
            out.append(lead + _sequence(value, col + 2, True, at))
        else:
            out.append(lead + _inline(value, at) + "\n")
    return "".join(out)


def dump(value) -> str:
    """``value`` as PyYAML's ``yaml.dump(value, default_flow_style=False,
    sort_keys=False)`` writes it; ``value`` is a dict or a list."""
    if type(value) not in (dict, list):
        raise TypeError(f"YAML writer: a document is a dict or a list, not {value!r}")
    if not value:
        return _inline(value, "") + "\n"
    if type(value) is dict:
        return _mapping(value, 0, False, "")
    return _sequence(value, 0, False, "")


def dump_file(value, path: str | Path) -> None:
    """Write :func:`dump` of ``value`` to ``path``; the file is whole or absent
    if the write fails."""
    text = dump(value)
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(text)
    tmp.replace(path)
