"""biahub_tpu_torch's YAML reader against ``yaml.safe_load``.

Every settings file of the repository reads as PyYAML reads it (one case
per file), as do the implicit types PyYAML resolves differently from YAML
1.2 (``1e-3`` is a string, ``yes`` a bool, ``017`` octal); what the reader
does not support raises with its line number.
"""

import math
from pathlib import Path

import pytest
import yaml

from biahub_tpu_torch.cli.yaml_reader import YamlError, load

SETTINGS = sorted(Path(__file__).resolve().parents[1].glob("settings/*.yml"))


def same(a, b) -> bool:
    """Equal values of equal types (NaN equal to NaN)."""
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


@pytest.mark.parametrize("path", SETTINGS, ids=[p.name for p in SETTINGS])
def test_settings_files_read_as_safe_load(path):
    text = path.read_text()
    assert same(load(text), yaml.safe_load(text))


SCALARS = """\
a: 1e-3
b: 1.0e-3
c: -1.5e+3
d: 017
e: 0x1F
f: 0b101
g: -.inf
h: .NaN
i: [yes, No, on, OFF, true, FALSE]
j: [~, null, Null, ]
k: 'it''s # not a comment'
l: "tab\\there \\u00e9"
m: 1_000
n: +12
o: plain text with:colon, and a comma
p: 0o17
q: -0
"""

NESTED = """\
# a comment
top:
  seq:
  - 1
  - key: value  # trailing comment
    other: [a, {b: [1, 2]}]
  - - x
    - y
  -
    - deep
  empty:
  flow: [[1.0, 0.0],
         [0.0, 1.0]]
  map: {k: v, n: 3,
        m: null}
last: ""
"""


@pytest.mark.parametrize("text", [SCALARS, NESTED, "- a\n- b: 1\n  c: [1]\n", "[1, 2]\n", ""])
def test_documents_read_as_safe_load(text):
    assert same(load(text), yaml.safe_load(text))


@pytest.mark.parametrize("text,line", [
    ("a: 1\nb: &anchor 2\n", 2), ("a: 1\nb: *alias\n", 2), ("a: !!float 1\n", 1),
    ("a: |\n  block\n", 1), ("a: >\n  folded\n", 1), ("a: 1\nb: plain\n  continued\n", 3),
    ("---\na: 1\n", 1), ("when: 2001-12-14\n", 1), ("t: 1:30\n", 1), ("a: [1, 2\n", 1),
    ("a:\n\t- 1\n", 2), ("<<: {a: 1}\n", 1),
])
def test_unsupported_constructs_raise_with_the_line(text, line):
    with pytest.raises(YamlError, match=f"^line {line}: "):
        load(text)
