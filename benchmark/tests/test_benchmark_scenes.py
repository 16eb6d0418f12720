"""The scene writer and the reference's refusal: the benchmark's
configurations write the same scene text as before the lens keys came
(pinned by SHA-256), a lens writes ``APERTURE`` and ``FOCAL`` after
``UP``, and a configuration with a key the reference does not trace, or
an unknown one, is refused by the writer and the reference alike, with
the key named."""

from __future__ import annotations

import copy
import hashlib
import json

import pytest

from benchmark.harness import scenes
from benchmark.reference import tables as RT
from benchmark.tests import tiny

# sha256 of the scene file each configuration writes, as the benchmark
# first wrote it
SCENE_SHA256 = {
    "cornell":
        "ce70d2bd37731bb852ddb4873e1e5f368575b8cf6293961d3d19f55ad5fcabb2",
    "cornell_bigmesh":
        "2a4fe35393c15aa3d8b40ba1bc7f31d9121de92f0960d66cd42c2996b1021847",
}


def _config(name):
    return json.loads((tiny.REPO / "benchmark" / "configs" /
                       f"{name}.json").read_text())


@pytest.mark.parametrize("name", sorted(SCENE_SHA256))
def test_scene_text_is_unchanged(tmp_path, name):
    path, _ = scenes.write_scene(_config(name), tmp_path)
    with open(path, "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == SCENE_SHA256[name]


def test_lens_is_written_after_up():
    cfg = tiny.glass_config(_config("cornell"))
    lines = scenes.scene_text(cfg, {}).split("\n")
    at = lines.index("UP 0.0 1.0 0.0")
    assert lines[at + 1:at + 4] == ["APERTURE 0.25", "FOCAL 11.5", ""]
    cam = RT.pack(RT.scene_from_config(cfg, {}))["cam"][0]
    assert cam[14:].tolist() == [0.25, 11.5]
    assert RT.pack(RT.scene_from_config(_config("cornell"), {}))[
        "cam"][0][14:].tolist() == [0.0, 1.0]


# where each untraced feature would sit in a configuration
UNTRACED = [("materials", "checker", [4.0, 0.1, 0.1, 0.1]),
            ("materials", "bump", [8.0, 0.3]),
            ("materials", "sss", [2.0, 0.9, 0.5, 0.4]),
            ("materials", "texture", "pattern.png"),
            ("materials", "bumptex", ["pattern.png", 0.5]),
            ("objects", "motion", [0.0, 0.5, 0.0])]


def _with(part, key, value):
    cfg = copy.deepcopy(_config("cornell"))
    if part == "camera":
        cfg["camera"][key] = value
    else:
        cfg[part][-1][key] = value
    return cfg


def _refused(cfg, words):
    for fn in (lambda: scenes.scene_text(cfg, {}),
               lambda: RT.scene_from_config(cfg, {})):
        with pytest.raises(ValueError) as e:
            fn()
        for w in words:
            assert w in str(e.value), (w, str(e.value))


@pytest.mark.parametrize("part,key,value", UNTRACED,
                         ids=[k for _, k, _ in UNTRACED])
def test_untraced_feature_is_refused(part, key, value):
    _refused(_with(part, key, value),
             (repr(key), RT.UNTRACED[key], "does not trace"))


@pytest.mark.parametrize("part", ["materials", "camera", "objects"])
def test_unknown_key_is_refused(part):
    _refused(_with(part, "shininess", 1.0), ("unknown key", "'shininess'"))


@pytest.mark.parametrize("key", ["aperture", "focal"])
def test_half_a_lens_is_refused(key):
    _refused(_with("camera", key, 0.5), (repr(key),))
