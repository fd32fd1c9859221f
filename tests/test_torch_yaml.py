"""biahub_tpu_torch's YAML reader against ``yaml.safe_load``, and its YAML
writer against ``yaml.dump``.

Every settings file of the repository reads as PyYAML reads it (one case
per file), as do the implicit types PyYAML resolves differently from YAML
1.2 (``1e-3`` is a string, ``yes`` a bool, ``017`` octal); what the reader
does not support raises with its line number. The writer's text of each
settings file reads back equal through both readers (one case per file);
on the reference's settings models, and on seeded random documents of
nested dicts, lists and scalars, it is PyYAML's text (``yaml.dump(...,
default_flow_style=False, sort_keys=False)``) character for character.
"""

import math
import random
import string
from pathlib import Path

import numpy as np
import pytest
import yaml

from biahub_tpu.cli.utils import model_to_yaml as reference_model_to_yaml
from biahub_tpu.settings import RegistrationSettings, StabilizationSettings
from biahub_tpu_torch.cli.utils import model_to_yaml
from biahub_tpu_torch.cli.yaml_reader import YamlError, load, load_file
from biahub_tpu_torch.cli.yaml_writer import dump
from biahub_tpu_torch.convert import registration_settings_dump, stabilization_settings_dump

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


@pytest.mark.parametrize("path", SETTINGS, ids=[p.name for p in SETTINGS])
def test_settings_files_write_and_read_back(path):
    value = load(path.read_text())
    text = dump(value)
    assert same(yaml.safe_load(text), value)
    assert same(load(text), value)
    assert text == yaml.dump(value, default_flow_style=False, sort_keys=False)


def reference_models() -> list:
    """The estimate verbs' outputs as the reference's models hold them: a
    float64 4x4 per timepoint (reprs of every length), the voxel sizes as
    ints and floats, a None field."""
    rng = np.random.default_rng(5)
    mats = [np.eye(4) + np.pad(rng.normal(0, 1e-3, (3, 4)), ((0, 1), (0, 0)))
            for _ in range(3)]
    mats[1][:3, 3] = [1e-17, -2.5e20, 12.0]
    transforms = [m.tolist() for m in mats]
    fields = dict(stabilization_estimation_channel="Phase3D", stabilization_type="affine",
                  stabilization_method="ants", stabilization_channels=["GFP", "Phase3D"])
    return [
        (StabilizationSettings(**fields, affine_transform_zyx_list=transforms,
                               output_voxel_size=[1, 1, 0.174, 0.1494, 0.1494]),
         stabilization_settings_dump(*fields.values(), transforms,
                                     [1, 1, 0.174, 0.1494, 0.1494])),
        (RegistrationSettings(source_channel_names=["GFP", "yes", "0.5"],
                              target_channel_name="Phase 3D: 1", affine_transform_zyx=transforms[1]),
         registration_settings_dump(["GFP", "yes", "0.5"], "Phase 3D: 1", transforms[1])),
    ]


@pytest.mark.parametrize("i", [0, 1], ids=["StabilizationSettings", "RegistrationSettings"])
def test_model_to_yaml_writes_the_references_text(i, tmp_path):
    model, settings = reference_models()[i]
    assert settings == model.model_dump()
    reference_model_to_yaml(model, tmp_path / "ref.yml")
    model_to_yaml(settings, tmp_path / "port.yml")
    assert (tmp_path / "port.yml").read_text() == (tmp_path / "ref.yml").read_text()
    assert same(load_file(tmp_path / "port.yml"), yaml.safe_load((tmp_path / "ref.yml")
                                                                  .read_text()))


def random_document(rng: random.Random, depth: int = 0):
    alphabet = string.ascii_letters + string.digits + " -_.:#,[]{}'\"!&*?|>%@`~=<+/\\\té"

    def text():
        if rng.random() < 0.3:
            return rng.choice(["yes", "No", "null", "~", "1.0", "1e3", "0x1F", "017", "-",
                               "- x", "x:", "a: b", "2024-01-05", "<<", "=", "0.5", " x",
                               "x ", "---x", "...", ".inf", "-.5", "+1", "all"])
        return "".join(rng.choice(alphabet) for _ in range(rng.randint(1, 8)))

    def value(d):
        c = rng.random()
        if d < 3 and c < 0.25:
            return {text(): value(d + 1) for _ in range(rng.randint(0, 4))}
        if d < 3 and c < 0.5:
            return [value(d + 1) for _ in range(rng.randint(0, 4))]
        return rng.choice([None, True, False, "", rng.randint(-5, 10 ** 12),
                           rng.random() * 10 ** rng.randint(-30, 30), math.inf, -math.inf,
                           1e17, 1e-5, -0.0, text()])

    return {text(): value(depth + 1) for _ in range(rng.randint(1, 5))}


@pytest.mark.parametrize("seed", range(4))
def test_random_documents_write_as_pyyaml(seed):
    rng = random.Random(seed)
    for _ in range(250):
        doc = random_document(rng)
        assert dump(doc) == yaml.dump(doc, default_flow_style=False, sort_keys=False)


def test_the_writer_refuses_what_it_cannot_write():
    for bad, where in (({"a": (1, 2)}, "a"), ({"a": [np.float64(1.0)]}, r"a\[0\]"),
                       ({"a": {"b": np.eye(2)}}, "a.b")):
        with pytest.raises(TypeError, match=f"^YAML writer: {where} is a "):
            dump(bad)
    with pytest.raises(TypeError, match="a document is a dict or a list"):
        dump("text")
