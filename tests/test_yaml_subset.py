"""The in-repo reader for the YAML subset scene files use: parity with
PyYAML's safe_load on every scene, and malformed input rejected."""
import glob
import math
import os

import pytest

from hobbyraytracer_tpu.scene.schema import SceneError, load_scene_desc
from hobbyraytracer_tpu.scene.yaml_subset import YamlError, loads

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")
SCENE_FILES = sorted(os.path.basename(p)
                     for p in glob.glob(os.path.join(SCENES, "*.yaml")))


def test_every_scene_is_covered():
    assert len(SCENE_FILES) == 8


@pytest.mark.parametrize("name", SCENE_FILES)
def test_scene_parity_with_pyyaml(name):
    yaml = pytest.importorskip("yaml")
    with open(os.path.join(SCENES, name)) as f:
        text = f.read()
    assert loads(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text,expect", [
    ("a: 1\nb: -2.5\nc: .5\nd: 1.0e+3\ne: 1e3\n",
     {"a": 1, "b": -2.5, "c": 0.5, "d": 1000.0, "e": "1e3"}),
    ("t: true\nf: Off\nn: ~\nm: null\ns: hello world\n",
     {"t": True, "f": False, "n": None, "m": None, "s": "hello world"}),
    ("q: 'it''s # not a comment'\nd: \"a\\\"b\"  # comment\n",
     {"q": "it's # not a comment", "d": 'a"b'}),
    ("l: [1, [2, 3], 'x', {k: v}]\n", {"l": [1, [2, 3], "x", {"k": "v"}]}),
    ("s:\n- 1\n-\n  - 2\n- k: v\n  j: w\n",
     {"s": [1, [2], {"k": "v", "j": "w"}]}),
    ("# only comments\n\n", None),
    ("o:\n  - {t: tri, v: [1, 2],\n     m: x}  # spans lines\n",
     {"o": [{"t": "tri", "v": [1, 2], "m": "x"}]}),
])
def test_scalars_and_structures(text, expect):
    assert loads(text) == expect


def test_special_floats():
    v = loads("a: .inf\nb: -.Inf\nc: .nan\n")
    assert v["a"] == math.inf and v["b"] == -math.inf
    assert math.isnan(v["c"])


@pytest.mark.parametrize("text", [
    "a: [1, 2\n",            # unclosed flow list
    "a: 'x\n",               # unterminated quote
    "a:\n\tb: 1\n",          # tab indentation
    "a: 1\n  b: 2\n",        # bad indentation
    "- a\nb: 1\n",           # sequence then mapping at one level
    "a: &x 1\n",             # anchors unsupported
    "a: |\n  text\n",        # block scalars unsupported
    "a: b: c\n",             # mapping value in a plain scalar
    "a: [1,, 2]\n",          # empty flow entry
    "a: [1,\n  2\n",         # flow list never closed
    "a: 1\n---\nb: 2\n",     # several documents
])
def test_malformed_input_raises(text):
    with pytest.raises(YamlError):
        loads(text)


def test_malformed_scene_is_scene_error(tmp_path):
    p = tmp_path / "bad.yaml"
    p.write_text("film:\n  width: [640\n")
    with pytest.raises(SceneError, match="line 2"):
        load_scene_desc(str(p))
