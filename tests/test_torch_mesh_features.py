"""K3 with K1's feature sections on a MESH geom, and K3 against the
reference's Pallas kernel in interpret mode.

The plain version against ``_run_planes`` (32x32, depth 4, 2 spp) on
variants of cornell_mesh (``tests/torch_scenes.py``): its icosahedron
made glass with a checker and moving, bumped, and instanced twice; and
against ``_run(interpret=True)`` (16x16, depth 3, 1 spp) on cornell_mesh
and cornell_bigmesh.  Bound: the tie-flip bound of
``tests/test_torch_mesh.py``.
"""

import pytest

from pathtrace_tpu_torch.ops.cuda import megakernel as K
from test_torch_features import check_against_reference
import torch_scenes as S


@pytest.mark.parametrize("config,sections", [
    ("mesh_glass_checker_motion", ("glass", "checker", "motion blur")),
    ("mesh_bump", ("bump",)),
    ("mesh_twice", ()),
])
def test_mesh_features_match_planes(config, sections):
    job = S.job(config, (8, 8), 2)
    assert {K.FEATURE_NAMES[i] for i, on in enumerate(job["features"])
            if on} == set(sections)
    assert job["bvh_meta"] and (len(job["bvh_meta"]) == 2) == (
        config == "mesh_twice")
    check_against_reference(config, (32, 32), 4, 2)


@pytest.mark.parametrize("config", ["cornell_mesh", "cornell_bigmesh"])
def test_mesh_trace_plain_matches_pallas_interpret(config):
    check_against_reference(config, (16, 16), 3, 1, interpret=True)
