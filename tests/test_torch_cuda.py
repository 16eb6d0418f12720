"""K1 (with its NEE section K2, its mesh section K3 and its texture
section K4), the CUDA kernel, and the traversal probe K9, against their
plain PyTorch versions on a GPU.

Every test here needs a CUDA GPU (marker ``cuda``) and skips without
one: the kernel has no CPU mode.  This file imports neither JAX nor the
JAX package, so on a machine with a GPU but no JAX it runs as

    python -m pytest --noconftest -q tests/test_torch_cuda.py

The kernel is built with ``-fmad=false`` and IEEE division and square
root, as its plain version rounds, so the bound is the tie-flip bound of
the CPU tests (under 0.5% of pixels off by more than 1e-3).
"""

import dataclasses
import os

import pytest
import torch

import pathtrace_tpu_torch as ptt
from pathtrace_tpu_torch.core import types as T
from pathtrace_tpu_torch.ops.cuda import megakernel as K
from pathtrace_tpu_torch.ops.cuda import probe as P
import torch_scenes as S
from torch_digest import digest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    return torch.device("cuda")


def _scene(name, res, depth=8):
    s = ptt.load_scene(os.path.join(REPO, "scenes", f"{name}.txt"))
    return dataclasses.replace(s, resolution=res, trace_depth=depth)


def _assert_tie_flip_bound(rad, ref, counts, ref_counts):
    d = (rad - ref).abs().amax(dim=-1)
    assert float((d > 1e-3).float().mean()) < 0.005
    torch.testing.assert_close(counts.double(), ref_counts.double(),
                               rtol=0.005, atol=0)


@pytest.mark.parametrize("name,res", [("cornell", (96, 80)),
                                      ("sphere", (96, 80)),
                                      ("cornell", (33, 7))])
def test_k1_matches_plain(cuda, name, res):
    scene = _scene(name, res)
    tables = K.pack_scene(scene, cuda)
    before = K.LAUNCHES[0]
    rad, counts = K.trace_k1(*tables, scene.geoms.type, *res, 8, 1, 3)
    torch.cuda.synchronize()
    assert K.LAUNCHES[0] == before + 1
    assert rad.shape == (res[0] * res[1], 3) and rad.device.type == "cuda"
    ref, ref_counts = K.trace_plain(*tables, scene.geoms.type, *res, 8, 1, 3)
    assert int(counts[0]) == 3 * res[0] * res[1]
    _assert_tie_flip_bound(rad, ref, counts, ref_counts)


def test_k1_pixel_range(cuda):
    scene = _scene("cornell", (40, 30), 4)
    tables = K.pack_scene(scene, cuda)
    args = (scene.geoms.type, 40, 30, 4, 9, 2)
    whole, counts = K.trace_k1(*tables, *args)
    tail, _ = K.trace_k1(*tables, *args, pix0=500)
    assert torch.equal(tail, whole[500:])
    assert int(counts[0]) == 2 * 40 * 30


def test_pathtrace_batch_cuda_runs_the_kernel(cuda):
    scene = _scene("cornell", (64, 48))
    before = K.LAUNCHES[0]
    rad, counts = ptt.pathtrace_batch(scene, 1, 2, device="cuda")
    assert K.LAUNCHES[0] == before + 1
    ref, ref_counts = ptt.pathtrace_batch(scene, 1, 2, device="cpu")
    _assert_tie_flip_bound(rad.cpu(), ref, counts.cpu(), ref_counts)


def test_k1_rejects_bad_tables(cuda):
    scene = _scene("cornell", (8, 8))
    cam, mats, gmat = K.pack_scene(scene, cuda)
    args = (scene.geoms.type, 8, 8, 8, 1, 1)
    with pytest.raises(ValueError, match="mats"):
        K.trace_k1(cam, mats.double(), gmat, *args)
    with pytest.raises(ValueError, match="gmat"):
        K.trace_k1(cam, mats, gmat[:, :36], *args)
    with pytest.raises(ValueError, match="on cpu"):
        K.trace_k1(cam, mats.cpu(), gmat, *args)


@pytest.mark.parametrize("config", [c for c in S.CONFIGS if c != "cornell"])
def test_features_match_plain(cuda, config):
    # each feature build of K1 (and K2 with NEE) on its configuration
    job = S.job(config, (96, 80), 8, cuda)
    mask = K.feature_mask(job["features"], job["lights"] is not None,
                          job["rr"])
    before = K.LAUNCHES[mask]
    rad, counts = K.trace_k1(**job, it0=1, n_spp=2)
    torch.cuda.synchronize()
    assert K.LAUNCHES[mask] == before + 1
    assert bool(torch.isfinite(rad).all())
    assert int(counts[0]) == 2 * 96 * 80
    ref, ref_counts = K.trace_plain(**job, it0=1, n_spp=2)
    _assert_tie_flip_bound(rad, ref, counts, ref_counts)


@pytest.mark.parametrize("name", ["cornell", "sphere"])
def test_feature_free_build_is_bit_equal(cuda, name):
    # the feature-free library (mask 0) rounds as the plain version does,
    # bit for bit, as the first K1 did
    job = K.prepare(_scene(name, (96, 80)), cuda)
    assert K.feature_mask(job["features"], False, False) == 0
    got = K.trace_k1(**job, it0=1, n_spp=3)
    want = K.trace_plain(**job, it0=1, n_spp=3)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    if name == "cornell":
        # the first, feature-free K1 (built alone, H100, CUDA 12.8) gave
        # these bits: sha256 of the float32 radiance, first 16 digits
        assert digest(got[0]) == "56f1410781372ccc"


def test_k1_rejects_mismatched_lights(cuda):
    job = S.job("cornell-nee", (8, 8), 2, cuda)
    with pytest.raises(ValueError, match="lights"):
        K.trace_k1(**dict(job, lights=job["lights"][:, :64]), it0=1, n_spp=1)


@pytest.mark.parametrize("config", [
    "cornell_mesh", "cornell_bigmesh", "cornell_mesh-nee",
    "mesh_glass_checker_motion", "mesh_twice"])
def test_mesh_matches_plain(cuda, config):
    # the mesh builds of K1 (K3, and K2's shadow walk with NEE)
    job = S.job(config, (96, 80), 8, cuda)
    mask = K.feature_mask(job["features"], job["lights"] is not None,
                          job["rr"], mesh=True)
    before = K.LAUNCHES[mask]
    rad, counts = K.trace_k1(**job, it0=1, n_spp=2)
    torch.cuda.synchronize()
    assert K.LAUNCHES[mask] == before + 1
    assert bool(torch.isfinite(rad).all())
    assert int(counts[0]) == 2 * 96 * 80
    ref, ref_counts = K.trace_plain(**job, it0=1, n_spp=2)
    _assert_tie_flip_bound(rad, ref, counts, ref_counts)


def test_k1_rejects_bad_mesh_tables(cuda):
    job = S.job("cornell_mesh", (8, 8), 2, cuda)
    with pytest.raises(ValueError, match="tri"):
        K.trace_k1(**dict(job, tri=job["tri"][:, :12]), it0=1, n_spp=1)
    with pytest.raises(ValueError, match="bvh_meta"):
        K.trace_k1(**dict(job, nodes=job["nodes"][:3]), it0=1, n_spp=1)


def test_mesh_build_is_bit_equal(cuda):
    # the mesh build without textures (mask 512) rounds as the plain
    # version does, and gives the bits that the mesh build gave before
    # the texture builds existed (H100, CUDA 12.8; tests/torch_digest.py
    # run on both versions): sha256 of the float32 radiance, first 16
    # digits
    job = S.job("cornell_mesh", (96, 80), 8, cuda)
    assert K.scene_mask(S.load("cornell_mesh")) == K.MESH_BIT
    got = K.trace_k1(**job, it0=1, n_spp=3)
    want = K.trace_plain(**job, it0=1, n_spp=3)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert digest(got[0]) == "42eec1d67a3c3d90"


@pytest.mark.parametrize("nee", [False, True])
@pytest.mark.parametrize("config", [c for c in S.TEX_CONFIGS
                                    if not c.endswith("-nee")])
def test_textures_match_plain(cuda, config, nee):
    # the texture builds of K1 (K4, with K2 and K3 where the scene asks)
    job = S.job(config, (96, 80), 8, cuda)
    if nee:
        job["lights"] = K.pack_lights(S.load(*S.TEX_CONFIGS[config][:2]),
                                      cuda)[0]
    mask = K.feature_mask(job["features"], nee, job["rr"],
                          T.MESH in job["geom_types"],
                          bool(job["tex_geom"]), bool(job["btex_geom"]))
    assert mask & (K.TEX_BIT | K.BTEX_BIT)
    before = K.LAUNCHES[mask]
    rad, counts = K.trace_k1(**job, it0=1, n_spp=2)
    torch.cuda.synchronize()
    assert K.LAUNCHES[mask] == before + 1
    assert bool(torch.isfinite(rad).all())
    assert int(counts[0]) == 2 * 96 * 80
    ref, ref_counts = K.trace_plain(**job, it0=1, n_spp=2)
    _assert_tie_flip_bound(rad, ref, counts, ref_counts)


@pytest.mark.parametrize("name", ["cornell_tex", "cornell_bumpmesh",
                                  "cornell_bigmesh_tex"])
def test_texture_scenes_with_nee_and_rr_match_plain(cuda, name):
    # the texture builds with NEE and Russian roulette on each file
    scene = _scene(name, (96, 80))
    job = K.prepare(scene, cuda, nee=True, rr=True)
    mask = K.scene_mask(scene, nee=True, rr=True)
    assert mask & K.NEE_BIT and mask & K.RR_BIT
    before = K.LAUNCHES[mask]
    rad, counts = K.trace_k1(**job, it0=1, n_spp=2)
    torch.cuda.synchronize()
    assert K.LAUNCHES[mask] == before + 1
    ref, ref_counts = K.trace_plain(**job, it0=1, n_spp=2)
    _assert_tie_flip_bound(rad, ref, counts, ref_counts)


@pytest.mark.parametrize("flags", [[], ["--nee", "--rr"]])
@pytest.mark.parametrize("name", ["cornell_tex", "cornell_bumpmesh",
                                  "cornell_bigmesh_tex"])
def test_cli_renders_texture_scenes_on_the_card(cuda, tmp_path, name, flags):
    from pathtrace_tpu_torch import cli

    path = os.path.join(REPO, "scenes", f"{name}.txt")
    mask = K.scene_mask(ptt.load_scene(path), nee=bool(flags),
                        rr=bool(flags))
    before = K.LAUNCHES[mask]
    out = tmp_path / "t.png"
    assert cli.main([path, "--res", "96", "80", "--spp", "2",
                     "--out", str(out), *flags]) == 0
    assert out.exists() and K.LAUNCHES[mask] == before + 1


def test_k1_rejects_bad_texture_tables(cuda):
    job = S.job("cornell_tex", (8, 8), 2, cuda)
    with pytest.raises(ValueError, match="texels"):
        K.trace_k1(**dict(job, texels=job["texels"].float()), it0=1,
                   n_spp=1)
    with pytest.raises(ValueError, match="inside a table"):
        K.trace_k1(**dict(job, texels=job["texels"][:100]), it0=1, n_spp=1)
    with pytest.raises(ValueError, match="tri"):
        mesh = S.job("cornell_bumpmesh", (8, 8), 2, cuda)
        K.trace_k1(**dict(mesh, tri=mesh["tri"][:, :16].contiguous()),
                   it0=1, n_spp=1)


@pytest.mark.parametrize("bundle", [(32, 128), (1, 32), (3, 50)])
def test_k9_matches_plain(cuda, bundle):
    scene = ptt.load_scene(os.path.join(REPO, "scenes",
                                        "cornell_bigmesh.txt"))
    tri, nodes, meta = K.pack_mesh(scene, cuda)
    before = P.LAUNCHES["k9_probe"]
    got = P.probe_k9(nodes, tri, meta[0], *bundle)
    assert P.LAUNCHES["k9_probe"] == before + 1
    assert got == P.probe_plain(nodes, tri, meta[0], *bundle)
    assert got[0] == meta[0][2] and got[1] > 0
