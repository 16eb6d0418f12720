"""Image textures (K4) on triangle meshes in the plain PyTorch version,
against the reference's tracer: ``_run_planes`` (32x32, depth 4, 2 spp)
on cornell_bumpmesh.txt (a BUMPTEX map on the UV-mapped grid plane: the
per-triangle UV gradients), cornell_bigmesh_tex.txt (a 512x512 albedo map
on the walls beside the 81,920-triangle mesh: the 24-column triangle rows
without a map on the mesh) and a variant with an albedo map on the grid
plane (vt interpolation); the Pallas kernel in interpret mode (16x16,
depth 3, 1 spp) on cornell_bumpmesh.  Bound as in
``tests/test_torch_features.py``."""

import pytest

from test_torch_features import check_against_reference


@pytest.mark.parametrize("config", ["cornell_bumpmesh",
                                    "cornell_bigmesh_tex", "mesh_tex"])
def test_trace_plain_matches_planes(config):
    assert check_against_reference(config, (32, 32), 4, 2) > 0.4


def test_trace_plain_matches_pallas_interpret():
    check_against_reference("cornell_bumpmesh", (16, 16), 3, 1,
                            interpret=True)
