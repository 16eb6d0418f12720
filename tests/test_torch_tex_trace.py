"""Image textures (K4) in the plain PyTorch version, against the
reference's own tracer under XLA (``_run_planes``, 32x32, depth 4, 2
spp), on cornell_tex.txt (an albedo map on a cube, a BUMPTEX map on a
sphere) with and without NEE, and on a variant with a checker on the
textured material (the odd cells replace the textured albedo).  The
port's tables go to both, the texels as the reference's float32 layout.
Bound as in ``tests/test_torch_features.py``: under 0.5% of pixels above
1e-3, counts within rtol 0.02, bounce 0 exact.  XLA's CPU build contracts
mul-adds into fused multiply-adds (the bilinear chain, the BUMPTEX
projection), so some pixels differ in the last bits.
"""

import os

import pytest
import torch

from pathtrace_tpu_torch import cli
from pathtrace_tpu_torch.ops.cuda import megakernel as K
from test_torch_features import check_against_reference
import torch_scenes as S


@pytest.mark.parametrize("config", ["cornell_tex", "cornell_tex-nee",
                                    "tex_checker"])
def test_trace_plain_matches_planes(config):
    assert check_against_reference(config, (32, 32), 4, 2) > 0.4


@pytest.mark.parametrize("mode", ["tex_geom", "btex_geom"])
def test_each_texture_mode_changes_the_render(mode):
    # with a chart mode off, the same tables render differently where
    # the map is (with NEE, so that every surface hit adds light)
    job = S.job("cornell_tex-nee", (32, 32), 3)
    assert job[mode]
    off = dict(job, **{mode: ()})
    if not off["tex_geom"] and not off["btex_geom"]:
        off["texels"] = None
    on_rad, _ = K.trace_plain(**job, it0=1, n_spp=1)
    off_rad, _ = K.trace_plain(**off, it0=1, n_spp=1)
    changed = (on_rad - off_rad).abs().amax(-1) > 1e-3
    assert int(changed.sum()) >= 8, int(changed.sum())


def test_checker_odd_cells_replace_the_texture():
    # on the checker variant the odd cells take the checker colour, so
    # fewer pixels see the map than on cornell_tex
    job = S.job("tex_checker", (32, 32), 3)
    job = K.Job(**dict(job, lights=K.pack_lights(S.load("cornell_tex"),
                                                 "cpu")[0]))
    rad, _ = K.trace_plain(**job, it0=1, n_spp=1)
    flat, _ = K.trace_plain(**dict(job, tex_geom=tuple(
        K.NO_CHART for _ in job["tex_geom"])), it0=1, n_spp=1)
    base = S.job("cornell_tex-nee", (32, 32), 3)
    rad0, _ = K.trace_plain(**base, it0=1, n_spp=1)
    flat0, _ = K.trace_plain(**dict(base, tex_geom=tuple(
        K.NO_CHART for _ in base["tex_geom"])), it0=1, n_spp=1)
    seen = int(((rad - flat).abs().amax(-1) > 1e-6).sum())
    seen0 = int(((rad0 - flat0).abs().amax(-1) > 1e-6).sum())
    assert 0 < seen < seen0


@pytest.mark.parametrize("kw", [{}, {"nee": True}, {"rr": True},
                                {"nee": True, "rr": True}])
def test_texture_scene_renders(kw):
    scene = S.load("cornell_tex", res=(8, 8), depth=5)
    rad, counts = K.pathtrace_batch_cuda(scene, 1, 2, device="cpu", **kw)
    assert rad.shape == (64, 3) and bool(torch.isfinite(rad).all())
    assert int(counts[0]) == 2 * 64 and counts.shape == (5,)


@pytest.mark.parametrize("flags", [[], ["--nee", "--rr"]])
@pytest.mark.parametrize("name", ["cornell_tex", "cornell_bumpmesh",
                                  "cornell_bigmesh_tex"])
def test_cli_renders_texture_scenes_on_the_cpu(tmp_path, name, flags):
    # the plain version through the CLI, with and without NEE and RR
    out = tmp_path / "t.png"
    assert cli.main([os.path.join(S.REPO, "scenes", f"{name}.txt"),
                     "--device", "cpu", "--res", "8", "8", "--depth", "4",
                     "--spp", "1", "--out", str(out), *flags]) == 0
    assert out.exists()
