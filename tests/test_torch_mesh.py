"""K3, triangle meshes, in the plain PyTorch version against the
reference's tracer under XLA (``_run_planes``, 32x32, depth 4, 2 spp):
cornell_mesh and cornell_bigmesh, with NEE (the shadow rays walk the
BVH too) and with Russian roulette; and the CLI on cornell_mesh.txt
against ``pathtrace_batch_planes``, at a non-square size.

The port walks the BVH per ray; the reference walks it per (32,128) tile
and tests every ray of the tile against every leaf any of them reached.
The winners agree except where rounding at a box face decides, which the
tie-flip bound of ``tests/test_torch_megakernel.py`` covers (under 0.5%
of pixels off by more than 1e-3, counts within rtol 0.02, bounce 0
exact).  Found bit-equal on every configuration without NEE; with NEE
about half the pixels are a few ulps off (XLA's CPU build contracts
mul-adds into FMAs, as on the primitive scenes).
"""

import dataclasses
import os

import numpy as np
import pytest

import pathtrace_tpu as pt
from pathtrace_tpu.render.plane_engine import pathtrace_batch_planes
from pathtrace_tpu_torch import cli
from pathtrace_tpu_torch.io import image_io
from test_torch_features import check_against_reference

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("config", [
    "cornell_mesh", "cornell_bigmesh", "cornell_mesh-nee", "cornell_mesh-rr"])
def test_mesh_trace_plain_matches_planes(config):
    check_against_reference(config, (32, 32), 4, 2)


def test_cli_mesh_matches_planes(tmp_path, monkeypatch):
    seen = []
    to_display = image_io.to_display

    def spy(accum, *args):
        seen.append(np.array(accum))
        return to_display(accum, *args)

    monkeypatch.setattr(image_io, "to_display", spy)
    path = os.path.join(REPO, "scenes", "cornell_mesh.txt")
    assert cli.main([path, "--device", "cpu", "--res", "48", "27",
                     "--depth", "4", "--spp", "2",
                     "--out", str(tmp_path / "m.png")]) == 0
    (accum,) = seen
    assert accum.shape == (48 * 27, 3)
    scene = dataclasses.replace(pt.load_scene(path), resolution=(48, 27),
                                trace_depth=4)
    ref_rad, _ = pathtrace_batch_planes(scene, 1, 2)
    d = np.abs(accum - np.asarray(ref_rad)).max(axis=-1)
    assert (d > 1e-3).mean() < 0.005
