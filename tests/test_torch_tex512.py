"""Image textures (K4) on a large map and on the reference's Pallas
kernel: the plain PyTorch version against ``_run_planes`` on
cornell_tex512 (cornell_tex.txt with the 512x512 pattern, as the
reference's bench builds it; 32x32, depth 4, 2 spp), against the Pallas
kernel in interpret mode (``_run``, the texels packed four bytes a word)
on cornell_tex (16x16, depth 3, 1 spp), and the CLI on cornell_tex.txt
against ``pathtrace_batch_planes``.  Bound as in
``tests/test_torch_features.py``."""

import dataclasses
import os

import numpy as np

import pathtrace_tpu as pt
from pathtrace_tpu.render.plane_engine import pathtrace_batch_planes
from pathtrace_tpu_torch import cli
from pathtrace_tpu_torch.io import image_io
from test_torch_features import check_against_reference

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_trace_plain_matches_planes_on_512_map():
    assert check_against_reference("cornell_tex512", (32, 32), 4, 2) > 0.4


def test_trace_plain_matches_pallas_interpret():
    check_against_reference("cornell_tex", (16, 16), 3, 1, interpret=True)


def test_cli_texture_scene_matches_reference(tmp_path, monkeypatch):
    seen = []
    to_display = image_io.to_display

    def spy(accum, *args):
        seen.append(np.array(accum))
        return to_display(accum, *args)

    monkeypatch.setattr(image_io, "to_display", spy)
    path = os.path.join(REPO, "scenes", "cornell_tex.txt")
    assert cli.main([path, "--device", "cpu", "--res", "48", "27",
                     "--depth", "4", "--spp", "2",
                     "--out", str(tmp_path / "t.png")]) == 0
    (accum,) = seen
    scene = dataclasses.replace(pt.load_scene(path), resolution=(48, 27),
                                trace_depth=4)
    ref_rad, _ = pathtrace_batch_planes(scene, 1, 2)
    d = np.abs(accum - np.asarray(ref_rad)).max(axis=-1)
    assert (d > 1e-3).mean() < 0.005
