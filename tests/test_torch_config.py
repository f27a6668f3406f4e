"""The port's YAML reader and config helpers (``spnerf_tpu_torch/utils/
config.py``) against ``yaml.safe_load`` and the JAX package's helpers
(``spnerf_tpu/utils/config.py``), and the port's copies of the configs.

Equality is exact: the reader must give what PyYAML's SafeLoader gives
for the subset it reads, and raise naming the line for anything else.
"""

import math
from pathlib import Path

import pytest
import yaml

from spnerf_tpu.utils import config as jconfig
from spnerf_tpu_torch.utils import config as tconfig

ROOT = Path(__file__).resolve().parents[1]
NAMES = sorted(p.name for p in (ROOT / "spnerf_tpu/configs").glob("*.yaml"))


def test_the_port_has_the_eleven_configs():
    assert len(NAMES) == 11
    assert sorted(p.name for p in (ROOT / "spnerf_tpu_torch/configs")
                  .glob("*.yaml")) == NAMES


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("package", ["spnerf_tpu", "spnerf_tpu_torch"])
def test_load_config_equals_yaml(package, name):
    path = ROOT / package / "configs" / name
    assert tconfig.load_config(path) == yaml.safe_load(path.read_text())


@pytest.mark.parametrize("name", NAMES)
def test_config_copies_are_byte_equal(name):
    assert (ROOT / "spnerf_tpu_torch/configs" / name).read_bytes() == \
        (ROOT / "spnerf_tpu/configs" / name).read_bytes()


SUBSET = [
    "", "# only a comment\n", "coco", "'x'", '"x"', "''", "1e-4", "1.0e-4",
    "1.e+4", "0.0005", ".5", "-.inf", "+.INF", ".NaN", "null", "Null", "~",
    "true", "True", "TRUE", "false", "False", "yes", "Off", "tRue", "10",
    "-7", "+12", "010", "0x1F", "0b101", "1_000", "1:30", "1:30.5", "0o7",
    "[8,8,16,16]", "[ 1, [2, 3], {x: [4]} ]", "{a: 1}", "{}", "[]",
    "[1,2,]", "{a, b: 2}", "'it''s'", '"a\\tb\\u00e9\\x41"',
    "a: 1", "a: 1\na: 2", "key : v", "a: ''", "a: http://x.y/z", "a: x#y",
    "a: 'x' # c", "a: -1", "a: [-1, -b]", "a: [a b, c]", "a: {b: }",
    "a:\n    plain", "a:\n  b:\n    c: 1\n  d: 2\ne: 3",
    "a: [1,\n  2, # c\n 3]\nb: x", "a: {b: [1,\n    2], c: 'd'}\n",
    "a:  \n\n   # c\n   b: 1\n", "a: 1 # trailing\n# whole line\nb: 2\n",
    "a: 1.5e3", "a: 1.5E+3", "a: 1e3", "a: nan", "a: .inf", "1: one",
    "true: x", "a: b\r\nc: d\r\n",
]


@pytest.mark.parametrize("text", SUBSET)
def test_loads_equals_yaml_on_the_subset(text):
    want = yaml.safe_load(text)
    got = tconfig.loads(text)
    if isinstance(want, float) and math.isnan(want):
        assert isinstance(got, float) and math.isnan(got)
        return
    assert got == want and type(got) is type(want)
    if isinstance(want, dict):
        assert [type(v) for v in got.values()] == \
            [type(v) for v in want.values()]
        assert list(got) == list(want)


OUTSIDE = [
    ("a: !!str 1", 1, "tags"), ("a: &x 1", 1, "anchors"),
    ("a: 1\nb: *x", 2, "anchors"), ("a: |\n  x", 1, "block scalars"),
    ("a: >\n  x", 1, "block scalars"), ("- 1", 1, "block sequences"), ("-", 1, "block sequences"),
    ("a:\n- 1", 2, "block sequences"), ("a:\n  - 1", 2, "block sequences"),
    ("---\na: 1", 1, "document markers"), ("a: 1\n...\n", 2, "document"),
    ("%YAML 1.1\na: 1", 1, "directives"), ("a: 2001-12-14", 1, "timestamps"),
    ("? a\n: b", 1, "complex keys"), ("a: [1, 2", 1, "unclosed"),
    ("a: 1\nb: {c: [1,\n 2]\n", 2, "unclosed"),
    ("a: 'x", 1, "quoted scalar"), ("a:\n  b: 1\n c: 2", 3, ""),
    ("a:\n\tb: 1", 2, "tabs"), ("a: b: c", 1, "mapping values"),
    ("a: 1\nb: [a, b: c]", 2, "single-pair"), ("a: x\n  y", 2, ""),
    ('a: "x\\q"', 1, "escape"), ("<<: 1", 1, "keys"),
]


@pytest.mark.parametrize("text,line,what", OUTSIDE)
def test_outside_the_subset_raises_naming_the_line(text, line, what):
    with pytest.raises(ValueError, match=f"^line {line}: .*{what}"):
        tconfig.loads(text)


def test_load_config_names_the_file(tmp_path):
    path = tmp_path / "bad.yaml"
    path.write_text("data:\n    name: 'x'\n    list:\n        - 1\n")
    with pytest.raises(ValueError, match=r"bad\.yaml: line 4: block seq"):
        tconfig.load_config(path)


OVERRIDES = [
    ("train.learning_rate", "1e-4"), ("train.num_iters", "500"),
    ("model.vgg_cn", "[8, 8, 16]"), ("pretrained", "null"),
    ("data.name", "coco"), ("train.lr", "0.5"),
    ("train.pallas_desc_loss", "true"), ("a.b", "c"), ("x", "1e-4"),
    ("model.vgg_cn", "[8,8,16,16]"), ("flag", "false"), ("m", "{a: 1}"),
    ("s", "'x'"), ("e", ""), ("n", "nan"), ("deep.er.key", "{b: [1, {c: d}]}"),
]


@pytest.mark.parametrize("dotted,value", OVERRIDES)
def test_set_by_dotted_key_equals_jax(dotted, value):
    base = {"train": {"learning_rate": 0.001, "num_iters": 100, "lr": 1.0},
            "model": {"vgg_cn": [64] * 8}}
    want = jconfig.set_by_dotted_key(base, dotted, value)
    got = tconfig.set_by_dotted_key(base, dotted, value)
    if dotted == "n":
        assert math.isnan(got["n"]) and math.isnan(want["n"])
    else:
        assert got == want
    assert base["train"]["num_iters"] == 100  # not mutated


def test_apply_overrides_equals_jax():
    items = [f"{k}={v}" for k, v in OVERRIDES if k != "n"]
    base = {"train": {"lr": 1.0}}
    assert tconfig.apply_overrides(base, items) == \
        jconfig.apply_overrides(base, items)
    for bad in (["train.lr"], ["x=1", "y"]):
        with pytest.raises(ValueError, match="dotted.key=value"):
            tconfig.apply_overrides({}, bad)


def test_dict_update_and_parse_primitives_equal_jax():
    base = {"a": {"b": 1, "c": 2}, "d": 3}
    for upd in ({"a": {"b": 10}}, {"a": 5}, {"e": {"f": 1}}, None):
        assert tconfig.dict_update(base, upd) == jconfig.dict_update(base, upd)
    assert base["a"]["b"] == 1
    prims = ("p1", "p2", "p3")
    for names in ("all", None, "p2", ["p1", "p3"]):
        assert tconfig.parse_primitives(names, prims) == \
            jconfig.parse_primitives(names, prims)
    with pytest.raises(ValueError, match="Unknown primitives"):
        tconfig.parse_primitives(["p9"], prims)
