"""K1 (with its NEE section K2, its mesh section K3 and its linear fold
K3-linear, and its texture section K4), the CUDA kernel, the span kernel
K5 of the split and sorted engines, the scan K6, the traversal probe K9,
the material gradients K7 and the reverse sweep K8 (with its mesh
builds), against their plain PyTorch versions on a GPU; the engines
against K1, and K7's and K8's radiance against K1's, bit for bit.

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
from pathtrace_tpu_torch.ops.cuda import matgrad as MG
from pathtrace_tpu_torch.ops.cuda import megakernel as K
from pathtrace_tpu_torch.ops.cuda import vjp as VJ
from pathtrace_tpu_torch.ops import scan as SC
from pathtrace_tpu_torch.ops.cuda import probe as P
from pathtrace_tpu_torch.ops.cuda import span as SP
from pathtrace_tpu_torch.scene.bvh import without_bvh
import torch_gradcheck as GC
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


def test_k1_counts_per_sample_over_chunks(cuda):
    # 70 samples at depth 8 take two of K1's count chunks (64 samples a
    # block): each sample's row is that sample's own launch's
    job = K.prepare(_scene("cornell", (24, 16)), cuda)
    rad, per = K.trace_k1(**job, it0=5, n_spp=70, per_sample=True)
    assert tuple(per.shape) == (70, 8)
    for s in (0, 1, 63, 64, 69):
        _, one = K.trace_k1(**job, it0=5 + s, n_spp=1, per_sample=True)
        assert torch.equal(per[s], one[0])
    assert torch.equal(K.trace_k1(**job, it0=5, n_spp=70)[1], per.sum(0))
    assert int(per[:, 0].min()) == 24 * 16


@pytest.mark.parametrize("n_spp", [1, 3, 65])
def test_k1_per_sample_counts_are_the_plain_versions(cuda, n_spp):
    # the lane schedule's counts, each sample's (65: past one count
    # chunk), are the plain version's; the summed form's are their sum
    job = K.prepare(_scene("cornell", (40, 24)), cuda)
    rad, per = K.trace_k1(**job, it0=2, n_spp=n_spp, per_sample=True)
    ref, ref_per = K.trace_plain(**job, it0=2, n_spp=n_spp, per_sample=True)
    assert torch.equal(rad, ref) and torch.equal(per, ref_per)
    assert torch.equal(K.trace_k1(**job, it0=2, n_spp=n_spp)[1], per.sum(0))


def test_k1_tiles_and_two_calls_give_the_same_bits(cuda):
    # pix0/n_local tiles of the image (the library's own range) put
    # together give the whole image's bits and counts; two calls give the
    # same bits
    from pathtrace_tpu_torch.ops.cuda import build

    job = K.prepare(_scene("cornell_glass", (72, 50)), cuda)
    whole, counts = K.trace_k1(**job, it0=4, n_spp=3)
    again, again_counts = K.trace_k1(**job, it0=4, n_spp=3)
    assert torch.equal(whole, again) and torch.equal(counts, again_counts)
    mask, args = K.kernel_tables(
        job["cam"], job["mats"], job["gmat"], job["geom_types"],
        job["features"], job["lights"], job["rr"], job["tri"], job["nodes"],
        job["bvh_meta"], job["texels"], job["tex_geom"], job["btex_geom"])
    lib = build.load_k1(mask)
    tiles, total = [], torch.zeros_like(counts)
    for pix0, n_local in ((0, 1000), (1000, 1), (1001, 1599), (2600, 1000)):
        rad = torch.empty((n_local, 3), device=cuda)
        part = torch.zeros_like(counts)
        err = lib.pt_k1_trace(*args, 72, 50, 8, 4, 3, pix0, n_local,
                              rad.data_ptr(), part.data_ptr(), 0,
                              torch.cuda.current_stream().cuda_stream)
        K.launch_error("K1", lib, err)
        tiles.append(rad)
        total += part
    assert torch.equal(torch.cat(tiles), whole) and torch.equal(total, counts)
    rad = torch.empty((10, 3), device=cuda)
    assert lib.pt_k1_trace(*args, 72, 50, 8, 4, 3, 3595, 10, rad.data_ptr(),
                           total.data_ptr(), 0, 0) != 0  # past the image


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


@pytest.mark.parametrize("name", ["cornell", "cornell_mesh"])
def test_k1_count_digests_are_pinned(cuda, name):
    # the counts per sample of tests/torch_digest.py's jobs (96x80 d8, 3
    # spp from iteration 1) are the ones K1 gave before its lane schedule
    # (H100, CUDA 12.8): sha256 of the int64 counts, first 16 digits
    job = K.prepare(_scene(name, (96, 80)), cuda)
    _, counts = K.trace_k1(**job, it0=1, n_spp=3, per_sample=True)
    assert digest(counts) == {"cornell": "a52ad48147c2ae95",
                              "cornell_mesh": "a9bc73f86ac50c28"}[name]


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


@pytest.mark.parametrize("bundle,max_steps", [
    ((1, 32), P.MAX_STEPS), ((2, 40), P.MAX_STEPS), ((32, 128), 1),
    ((32, 128), 37), ((2, 40), 300), ((32, 128), 0)])
def test_k9_bundles_and_step_caps_match_plain(cuda, bundle, max_steps):
    # the cluster's walk is the plain version's on a bundle that fills a
    # block or part of one, and under a cap that stops it anywhere
    scene = ptt.load_scene(os.path.join(REPO, "scenes",
                                        "cornell_bigmesh.txt"))
    tri, nodes, meta = K.pack_mesh(scene, cuda)
    got = P.probe_k9(nodes, tri, meta[0], *bundle, max_steps)
    assert got == P.probe_plain(nodes, tri, meta[0], *bundle, max_steps)


# ----------------------------------------------------------------------------
# K5 (the split and sorted engines) and K6 (the scan)
# ----------------------------------------------------------------------------

ALL_CONFIGS = sorted({**S.CONFIGS, **S.MESH_CONFIGS, **S.TEX_CONFIGS})


def _engine_job(config, cuda, res=(96, 80), depth=8):
    name, edits, nee, rr = {**S.CONFIGS, **S.MESH_CONFIGS,
                            **S.TEX_CONFIGS}[config]
    scene = S.load(name, edits, res, depth)
    return scene, K.prepare(scene, cuda, nee=nee, rr=rr)


@pytest.mark.parametrize("engine", ["split", "sorted"])
@pytest.mark.parametrize("config", ALL_CONFIGS)
def test_k5_engines_bit_equal_to_k1(cuda, config, engine):
    # every feature build: the engine's image and live counts are K1's,
    # bit for bit, and the engine went through K5 (and K6 when split)
    scene, job = _engine_job(config, cuda)
    mask = K.scene_mask(scene, job["lights"] is not None, job["rr"])
    want = K.trace_k1(**job, it0=1, n_spp=2)
    before, scans = SP.LAUNCHES[mask], SC.LAUNCHES["k6_scan"]
    if engine == "split":
        got = SP.split_batch(job, 1, 2, 3)
    else:
        got = SP.sorted_batch(job, 1, 2, *SP.sort_box(scene, cuda))
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert SP.LAUNCHES[mask] == before + (4 if engine == "split" else 16)
    assert SC.LAUNCHES["k6_scan"] == scans + (2 if engine == "split" else 0)


@pytest.mark.parametrize("split", [1, 7, 8, 20])
def test_k5_split_clamp_and_sphere(cuda, split):
    # sphere at split 1: every tile dies at bounce 0, so the table is
    # empty and the resumed span's blocks all exit; split >= depth clamps
    scene = _scene("sphere", (50, 37))
    want = K.trace_k1(**K.prepare(scene, cuda), it0=3, n_spp=2)
    got = ptt.pathtrace_batch_split(scene, 3, 2, split=split, device="cuda")
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_k5_depth_one(cuda):
    scene = _scene("cornell", (33, 7), 1)
    want = K.trace_k1(**K.prepare(scene, cuda), it0=1, n_spp=2)
    before = dict(SP.LAUNCHES)
    got = ptt.pathtrace_batch_split(scene, 1, 2, device="cuda")
    assert dict(SP.LAUNCHES) == before  # depth 1 goes to K1
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    got = ptt.pathtrace_batch_sorted(scene, 1, 2, device="cuda")
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_k5_matches_its_plain_version(cuda):
    # each engine on the card against its plain version on the card (the
    # span and the scan plain), the same tables: within the tie-flip bound
    scene, job = _engine_job("cornell_glass-nee", cuda)
    for split, sort in ((2, False), (None, True)):
        got = SP.engine(scene, job, split, sort)[1](1, 1)
        want = SP.engine(scene, job, split, sort, plain=True)[1](1, 1)
        _assert_tie_flip_bound(got[0], want[0], got[1], want[1])


@pytest.mark.parametrize("sorted_engine", [False, True])
def test_k5_leaves_a_dead_rays_planes_as_they_were(cuda, sorted_engine):
    # a ray that enters a span dead reads live alone and writes nothing;
    # a sorted span handed a live count of 0 writes nothing at all and
    # adds 0 to the count it leaves
    scene, job = _engine_job("sss", cuda, (48, 40), 5)
    keys = K.state_keys(job["features"], False, sorted_engine)
    n = 48 * 40
    state = torch.empty((len(keys), n), device=cuda)
    counts = torch.zeros(5, dtype=torch.int64, device=cuda)
    SP.trace_span(job, state, keys, 0, 2, 1, counts)
    dead = state[SP.LIVE_KEY] == 0
    assert 0 < int(dead.sum()) < n
    gen = torch.Generator(device=cuda).manual_seed(2)
    noise = torch.randn(state.shape, generator=gen, device=cuda)
    noise[SP.LIVE_KEY] = state[SP.LIVE_KEY]
    if sorted_engine:
        noise[-1] = state[-1]
    for d1 in (3, 5):
        st = noise.clone()
        SP.trace_span(job, st, keys, 2, d1, 1, counts)
        assert torch.equal(st[:, dead].view(torch.int32),
                           noise[:, dead].view(torch.int32))
        want = noise.clone()
        SP.span_plain(job, want, keys, 2, d1, 1, counts.clone())
        assert torch.equal(st.view(torch.int32), want.view(torch.int32))
    if sorted_engine:
        st, out = noise.clone(), torch.zeros(1, dtype=torch.int32, device=cuda)
        before = SP.LAUNCHES.copy()
        SP.trace_span(job, st, keys, 2, 3, 1, counts,
                      n_live=torch.zeros(1, dtype=torch.int32, device=cuda),
                      live_out=out)
        torch.cuda.synchronize()
        assert sum(SP.LAUNCHES.values()) == sum(before.values()) + 1
        assert torch.equal(st.view(torch.int32), noise.view(torch.int32))
        assert int(out) == 0


def test_k5_sorted_live_counts_are_the_next_bounces(cuda):
    # the count each sorted span leaves on the card is the count of the
    # paths live entering the next bounce
    scene, job = _engine_job("cornell_mesh", cuda)
    box = SP.sort_box(scene, cuda)
    handed = []
    trace_span = SP.trace_span

    def spy(*args, **kw):
        trace_span(*args, **kw)
        if kw.get("live_out") is not None:
            handed.append(int(kw["live_out"]))

    SP.trace_span = spy
    try:
        rad, counts = SP.sorted_batch(job, 1, 1, *box)
    finally:
        SP.trace_span = trace_span
    assert len(handed) == 8 and handed[:-1] == counts.tolist()[1:]


N_SCAN = [1, 127, 128, 129, 4097, 640000, 2 ** 21 + 3]


@pytest.mark.parametrize("n", N_SCAN)
def test_k6_matches_plain_and_cumsum(cuda, n):
    g = torch.Generator().manual_seed(n)
    for x in ((torch.rand(n, generator=g) < 0.4).to(torch.int32),
              torch.randint(0, 1000, (n,), generator=g, dtype=torch.int32)):
        before = SC.LAUNCHES["k6_scan"]
        got = SC.scan_int(x.to(cuda))
        assert SC.LAUNCHES["k6_scan"] == before + 1
        want = SC.prefix_sum_plain(x)
        assert torch.equal(got.cpu(), want)
        assert torch.equal(want, (torch.cumsum(x.long(), 0) - x).int())
        assert torch.equal(SC.prefix_sum(x.to(cuda)).cpu(), want.float())


def test_k6_one_scratch_over_growing_and_shrinking_calls(cuda):
    # one launch a scan, on the one scratch the wrapper keeps per device
    # (grown, never shrunk): each call's tag keeps it from reading the
    # status words an earlier call left
    sizes = [5000, 2073600, 1, 640000, 4097, 16200, 3 * SC.TILE + 5,
             2 ** 21 + 7]
    g = torch.Generator().manual_seed(9)
    kept = None
    for n in sizes + sizes[::-1]:
        x = (torch.rand(n, generator=g) < 0.4).to(torch.int32).to(cuda)
        before = SC.LAUNCHES["k6_scan"]
        got = SC.scan_int(x)
        assert SC.LAUNCHES["k6_scan"] == before + 1
        assert torch.equal(got, torch.cumsum(x, 0, dtype=torch.int32) - x)
        if n == max(sizes):
            kept = SC._K6[x.device.index][1].data_ptr()
        elif kept is not None:
            assert SC._K6[x.device.index][1].data_ptr() == kept


def test_k6_compact_indices_is_the_stable_partition(cuda):
    g = torch.Generator().manual_seed(5)
    mask = torch.rand(16200, generator=g) < 0.3
    perm, n_live = SC.compact_indices(mask.to(cuda))
    assert int(n_live) == int(mask.sum())
    assert torch.equal(perm.cpu().long(),
                       torch.argsort((~mask).int(), stable=True))
    dense, n = SC.compact(mask.to(cuda), {"i": torch.arange(16200,
                                                             device=cuda)})
    assert torch.equal(dense["i"].cpu(), perm.cpu().long())


def test_k5_k6_reject_bad_tables(cuda):
    scene, job = _engine_job("cornell", cuda, (16, 8), 4)
    keys = K.state_keys(job["features"], False)
    state = torch.empty((len(keys), 128), device=cuda)
    counts = torch.zeros(4, dtype=torch.int64, device=cuda)
    n_live = torch.ones((), dtype=torch.int32, device=cuda)
    tbl = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="tile table"):
        SP.trace_span(job, state, keys, 1, 4, 1, counts, tbl.long(), n_live)
    with pytest.raises(ValueError, match="tile table"):
        SP.trace_span(job, state, keys, 1, 4, 1, counts,
                      torch.zeros(2, dtype=torch.int32, device=cuda), n_live)
    with pytest.raises(ValueError, match="tile table"):
        SP.trace_span(job, state, keys, 1, 4, 1, counts, tbl, None)
    with pytest.raises(ValueError, match="state keys"):
        SP.trace_span(job, state, keys[1:], 0, 1, 1, counts)
    with pytest.raises(ValueError, match="state"):
        SP.trace_span(job, state[:, :100], keys, 0, 1, 1, counts)
    with pytest.raises(ValueError, match="span"):
        SP.trace_span(job, state, keys, 3, 5, 1, counts)
    with pytest.raises(ValueError, match="1-D"):
        SC.scan_int(torch.zeros((2, 3), dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="1-D"):
        SC.scan_int(torch.zeros(0, dtype=torch.int32, device=cuda))


@pytest.mark.parametrize("flags", [["--split-depth", "1"],
                                   ["--engine", "sorted", "--nee"]])
def test_cli_engines_on_the_card(cuda, tmp_path, flags):
    from pathtrace_tpu_torch import cli

    path = os.path.join(REPO, "scenes", "cornell_mesh.txt")
    before = sum(SP.LAUNCHES.values())
    out = tmp_path / "e.png"
    assert cli.main([path, "--res", "96", "80", "--spp", "2",
                     "--out", str(out), *flags]) == 0
    assert out.exists() and sum(SP.LAUNCHES.values()) > before


# ----------------------------------------------------------------------------
# K7 (the material gradients) and K8 (the reverse sweep)
# ----------------------------------------------------------------------------

def _k8_args(job, ct):
    return (job["cam"], job["mats"], job["gmat"], job["geom_types"],
            job["width"], job["height"], job["depth"], 1, 2, job["lights"],
            ct, job["tri"], job["nodes"], job["bvh_meta"], job["features"])


def _masked_ct(rad, ref, seed=0):
    """A random cotangent, zero on the pixels where the kernel's forward
    and the plain version's differ (tie flips), as the reference's tests
    mask them."""
    gen = torch.Generator(device=rad.device).manual_seed(seed)
    ct = torch.rand(rad.shape, generator=gen, device=rad.device)
    return torch.where(((rad - ref).abs().amax(-1) < 1e-4)[:, None], ct, 0.0)


@pytest.mark.parametrize("nee", [False, True])
def test_k8_forward_equals_k1(cuda, nee):
    # K8's forward sweep runs K1's init_state and bounce: the same bits
    job = K.prepare(_scene("cornell", (96, 80)), cuda, nee=nee)
    want, _ = K.trace_k1(**job, it0=1, n_spp=2)
    ct = torch.ones((96 * 80, 3), device=cuda)
    got, grads = VJ.trace_k8(*_k8_args(job, ct))
    assert torch.equal(got, want)
    assert len(grads) == (4 if nee else 3)


def test_k7_forward_equals_k1(cuda):
    scene = _scene("cornell", (96, 80))
    want, want_counts = K.trace_k1(**K.prepare(scene, cuda), it0=1, n_spp=2)
    before = MG.LAUNCHES[0]
    got, g = MG.material_grads(scene, torch.ones((96 * 80, 3)), 1, 2)
    assert MG.LAUNCHES[0] == before + 1
    assert torch.equal(got, want)
    assert g["color"].shape == (scene.materials.count, 3)


@pytest.mark.parametrize("nee", [False, True])
def test_k8_matches_plain(cuda, nee):
    # every table's gradient at 64x64 d4: the reference's rtol 2e-4 /
    # atol 3e-4, on the NEE fireflies' part of the cotangent with
    # GC.FIREFLY_SHARE of that part's largest entry (tests/torch_gradcheck.py)
    scene = _scene("cornell", (64, 64), 4)
    job = K.prepare(scene, cuda, nee=nee)
    rad, _ = K.trace_k1(**job, it0=1, n_spp=2)
    ref, _ = K.trace_plain(**job, it0=1, n_spp=2)
    ct = _masked_ct(rad, ref)
    ff = GC.fireflies(rad, 2, scene.materials.emittance)
    assert bool(ff.any()) == nee  # cornell at 64x64 has NEE fireflies
    names = ("cam", "mats", "gmat", "lights")
    for c, share in zip(GC.split(ct, ff), (None, GC.FIREFLY_SHARE)):
        if not bool(c.any()):
            continue
        before = VJ.LAUNCHES[K.NEE_BIT if nee else 0]
        _, got = VJ.trace_k8(*_k8_args(job, c))
        assert VJ.LAUNCHES[K.NEE_BIT if nee else 0] == before + 1
        _, want = VJ.k8_plain(*_k8_args(job, c))
        rows = GC.compare(zip(names, got), zip(names, want), *GC.K8_TOL,
                          share)
        assert all(row[-1] for row in rows), rows


@pytest.mark.parametrize("nee", [False, True])
@pytest.mark.parametrize("name", ["cornell_glass", "cornell_checker"])
def test_k8_sections_match_plain(cuda, name, nee):
    # K8's section builds (glass, imperfect specular, DoF; motion,
    # checker): K1's radiance bit for bit, every table at the bare
    # tolerance of test_k8_matches_plain at 64x64 d4, equal bits twice
    scene = _scene(name, (64, 64), 4)
    job = K.prepare(scene, cuda, nee=nee)
    mask = K.scene_mask(scene, nee)
    assert mask & (K.NEE_BIT - 1)
    rad, _ = K.trace_k1(**job, it0=1, n_spp=2)
    ref, _ = K.trace_plain(**job, it0=1, n_spp=2)
    ct = _masked_ct(rad, ref)
    before = VJ.LAUNCHES[mask]
    rad8, first = VJ.trace_k8(*_k8_args(job, ct))
    assert VJ.LAUNCHES[mask] == before + 1 and torch.equal(rad8, rad)
    assert all(torch.equal(a, b) for a, b in
               zip(first, VJ.trace_k8(*_k8_args(job, ct))[1]))
    ff = GC.fireflies(rad, 2, scene.materials.emittance)
    names = ("cam", "mats", "gmat", "lights")
    for c, share in zip(GC.split(ct, ff), (None, GC.FIREFLY_SHARE)):
        if not bool(c.any()):
            continue
        _, got = VJ.trace_k8(*_k8_args(job, c))
        _, want = VJ.k8_plain(*_k8_args(job, c))
        rows = GC.compare(zip(names, got), zip(names, want), *GC.K8_TOL,
                          share)
        assert all(row[-1] for row in rows), rows


@pytest.mark.parametrize("nee", [False, True])
def test_k8_two_calls_give_equal_gradients(cuda, nee):
    # every sum is exact (128-bit integers added with integer atomics,
    # which commute) and rounded to float32 once: the same bits every
    # call, whatever order the threads add in
    job = K.prepare(_scene("cornell", (64, 64), 4), cuda, nee=nee)
    ct = torch.rand((64 * 64, 3), device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(3))
    _, a = VJ.trace_k8(*_k8_args(job, ct))
    _, b = VJ.trace_k8(*_k8_args(job, ct))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# K8's digests at 64x64 d4, 1 spp (tests/torch_digest.py --k8): radiance,
# rounded tables; those of the reverse sweep that traced its winners and
# shadow rays again, whose bits carrying them keeps
K8_DIGESTS = {
    0: ("22767a99bc40ecf7", "8037406d538dace3"),
    7: ("10ce831b5297b86e", "106e07f256b871b5"),
    24: ("0f49d66e9e40cbc4", "b091089cb0688847"),
    103: ("9eca4ddf6a7bf6bd", "9078fefaa892a156"),
    128: ("32c88f0bb51b269d", "352605660ee6bab8"),
    135: ("fd299ef8d8e2277a", "b2731acca9e938cf"),
    152: ("10703fb6e67c5f27", "d044a42f9672d87a"),
    231: ("d808f80cb8f7fe2d", "c3ec8b8a73fdfa5b"),
    512: ("725b0e5df5cebeca", "dac6df6f21d19a52"),
    537: ("16b08a466d02a81c", "7a0f230ace56b7ee"),
    544: ("508e7d7c1098e8ab", "afa1e9a7a99378ad"),
    640: ("b10e1d8c71141f28", "4c97e9f1e5350aa8"),
    665: ("27c3a26bab325650", "460e5ac5e83d713d"),
    672: ("83029ee344d0278e", "d90f57b95ff2e18b"),
}


@pytest.mark.parametrize("mask", sorted(VJ.MASKS))
def test_k8_digests_are_pinned(cuda, mask):
    # two calls give the same bits, and the pinned ones
    import torch_digest as TD

    (scene, nee), = [(sc, nee) for sc, nee, m in TD.k8_scenes(REPO, ptt, K)
                     if m == mask]
    got = [TD.k8_digest(torch, K, VJ, scene, nee, mask) for _ in range(2)]
    assert got[0] == got[1] == K8_DIGESTS[mask]


def test_k8_flags_a_term_that_is_not_finite(cuda):
    # a NaN in one pixel's cotangent makes the entries its path reaches
    # NaN; the sums are exact, so every other entry keeps the bits it has
    # without that pixel
    job = K.prepare(_scene("cornell", (64, 64), 4), cuda, nee=True)
    ct = torch.rand((64 * 64, 3), device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(6))
    pix = 32 * 64 + 32
    ct[pix] = 0.0
    _, want = VJ.trace_k8(*_k8_args(job, ct))
    ct[pix] = float("nan")
    _, got = VJ.trace_k8(*_k8_args(job, ct))
    hit = torch.cat([g.isnan().flatten() for g in got])
    assert 0 < int(hit.sum()) < hit.numel()
    for g, w in zip(got, want):
        assert torch.equal(g[~g.isnan()], w[~g.isnan()])


def test_k7_two_calls_give_equal_gradients(cuda):
    scene = _scene("cornell", (64, 64), 4)
    ct = torch.rand((64 * 64, 3), device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(4))
    a = MG.material_grads(scene, ct, 1, 2)[1]
    b = MG.material_grads(scene, ct, 1, 2)[1]
    for key in a:
        assert torch.equal(a[key], b[key]), key


def test_k7_matches_plain(cuda):
    scene = _scene("cornell", (64, 64), 4)
    job = K.prepare(scene, cuda)
    mtab = MG.material_table(scene, cuda)
    mat_of = tuple(int(m) for m in scene.geoms.material_id)
    rad, _ = K.trace_k1(**job, it0=1, n_spp=2)
    ref, _ = K.trace_plain(**job, it0=1, n_spp=2)
    ct = _masked_ct(rad, ref)
    before = MG.LAUNCHES[0]
    _, got_counts, got = MG.trace_k7(job, mtab, mat_of, ct, 1, 2)
    assert MG.LAUNCHES[0] == before + 1
    _, want_counts, want = MG.k7_plain(job, mtab, mat_of, ct, 1, 2)
    assert torch.equal(got_counts, want_counts)
    # the reference's tolerance for cornell (tests/test_grad_kernel.py)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("nee", [False, True])
def test_render_vjp_on_the_card(cuda, nee):
    # the entry point on K8 against the same entry point on K8's plain
    # version, on the card, every parameter group, 64x64 d4
    scene = _scene("cornell", (64, 64), 4)
    job = K.prepare(scene, cuda, nee=nee)
    rad, _ = K.trace_k1(**job, it0=1, n_spp=1)
    ref, _ = K.trace_plain(**job, it0=1, n_spp=1)
    ct = _masked_ct(rad, ref)
    got_rad, _ = ptt.render_vjp(scene, ct, 1, 1, nee=nee)
    assert got_rad.device.type == "cuda" and torch.equal(got_rad, rad)
    from pathtrace_tpu_torch.render import diff as D

    # the tolerance of test_k8_matches_plain, by parameter group
    ff = GC.fireflies(rad, 1, scene.materials.emittance)
    for c, share in zip(GC.split(ct, ff), (None, GC.FIREFLY_SHARE)):
        if not bool(c.any()):
            continue
        _, g = ptt.render_vjp(scene, c, 1, 1, nee=nee)
        _, want = ptt.render_vjp(scene, c, 1, 1, nee=nee, plain=True)
        rows = GC.compare(D.named_leaves(g), D.named_leaves(want),
                          *GC.K8_TOL, share)
        assert all(row[-1] for row in rows), rows


def test_material_grads_on_the_card(cuda):
    scene = _scene("cornell", (48, 40), 3)
    ct = torch.rand((48 * 40, 3),
                    generator=torch.Generator().manual_seed(5))
    rad, g = ptt.material_grads(scene, ct, 1, 2)
    assert rad.device.type == "cuda"
    want_rad, want = ptt.material_grads(scene, ct, 1, 2, plain=True)
    assert torch.equal(rad, want_rad)
    for key in want:
        torch.testing.assert_close(g[key], want[key], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["cornell_mesh", "cornell_tex"])
def test_render_vjp_rejects_what_k8_does_not_trace(cuda, name):
    # cornell_mesh renders with its BVH (test_k8_mesh_matches_plain);
    # stripped of it, it raises, as the reference's render_vjp_pallas does;
    # the sections render (test_k8_sections_match_plain)
    scene = _scene(name, (16, 16), 2)
    if scene.mesh.count:
        scene = without_bvh(scene)
    with pytest.raises(NotImplementedError,
                       match="BVH" if scene.mesh.count else "ROADMAP"):
        VJ.render_vjp(scene, torch.ones((256, 3)), 1, 1)


def test_k8_rejects_bad_tables(cuda):
    job = K.prepare(_scene("cornell", (16, 16), 2), cuda)
    ct = torch.ones((256, 3), device=cuda)
    with pytest.raises(ValueError, match="ct"):
        VJ.trace_k8(*_k8_args(job, ct[:100]))
    with pytest.raises(ValueError, match="depth"):
        VJ.trace_k8(*_k8_args(dict(job, depth=VJ.MAX_DEPTH + 1), ct))


@pytest.mark.parametrize("nee", [False, True])
@pytest.mark.parametrize("config", ["cornell_mesh",
                                    "mesh_glass_checker_motion",
                                    "cornell_bumpmesh"])
def test_k3_linear_matches_plain(cuda, config, nee):
    # K3-linear (a mesh stripped of its BVH, every triangle folded) against
    # its plain version, and, but on bumpmesh, whose BUMPTEX the linear
    # fold leaves inert, against K3 on the same mesh with its BVH: the same
    # winners but for ties
    name, edits, _, _ = {**S.MESH_CONFIGS, **S.TEX_CONFIGS}[config]
    scene = S.load(name, edits, (96, 80), 8)
    flat = without_bvh(scene)
    job = K.prepare(flat, cuda, nee=nee)
    mask = K.scene_mask(flat, nee)
    assert mask & K.LINEAR_BIT and job["nodes"] is None
    before = K.LAUNCHES[mask]
    rad, counts = K.trace_k1(**job, it0=1, n_spp=2)
    torch.cuda.synchronize()
    assert K.LAUNCHES[mask] == before + 1
    assert int(counts[0]) == 2 * 96 * 80
    ref, ref_counts = K.trace_plain(**job, it0=1, n_spp=2)
    _assert_tie_flip_bound(rad, ref, counts, ref_counts)
    if config != "cornell_bumpmesh":
        bvh, bvh_counts = K.trace_k1(**K.prepare(scene, cuda, nee=nee),
                                     it0=1, n_spp=2)
        _assert_tie_flip_bound(rad, bvh, counts, bvh_counts)


@pytest.mark.parametrize("engine", ["split", "sorted"])
def test_k3_linear_engines_bit_equal_to_k1(cuda, engine):
    # K5 is in every K1 library: the engines fold every triangle as K1 does
    scene = without_bvh(S.load("cornell_mesh", (), (96, 80), 8))
    job = K.prepare(scene, cuda, nee=True)
    mask = K.scene_mask(scene, True)
    want = K.trace_k1(**job, it0=1, n_spp=2)
    before = SP.LAUNCHES[mask]
    if engine == "split":
        got = SP.split_batch(job, 1, 2, 3)
    else:
        got = SP.sorted_batch(job, 1, 2, *SP.sort_box(scene, cuda))
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert SP.LAUNCHES[mask] > before


@pytest.mark.parametrize("nee", [False, True])
def test_k8_mesh_matches_plain(cuda, nee):
    # K8's mesh builds (masks 512, 640): the radiance K1's, bit for bit,
    # and every table's gradient against the plain version (the mesh
    # tables constants) at 64x64 d4, tolerance as test_k8_matches_plain
    scene = _scene("cornell_mesh", (64, 64), 4)
    job = K.prepare(scene, cuda, nee=nee)
    mask = K.MESH_BIT | (K.NEE_BIT if nee else 0)
    rad, _ = K.trace_k1(**job, it0=1, n_spp=2)
    ref, _ = K.trace_plain(**job, it0=1, n_spp=2)
    ct = _masked_ct(rad, ref)
    ff = GC.fireflies(rad, 2, scene.materials.emittance)
    names = ("cam", "mats", "gmat", "lights")
    for c, share in zip(GC.split(ct, ff), (None, GC.FIREFLY_SHARE)):
        if not bool(c.any()):
            continue
        before = VJ.LAUNCHES[mask]
        rad8, got = VJ.trace_k8(*_k8_args(job, c))
        assert VJ.LAUNCHES[mask] == before + 1
        assert torch.equal(rad8, rad)
        _, want = VJ.k8_plain(*_k8_args(job, c))
        rows = GC.compare(zip(names, got), zip(names, want), *GC.K8_TOL,
                          share)
        assert all(row[-1] for row in rows), rows
    # two calls, the same bits
    a, b = (VJ.trace_k8(*_k8_args(job, ct))[1] for _ in range(2))
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_render_vjp_on_a_mesh_on_the_card(cuda):
    scene = _scene("cornell_mesh", (48, 40), 3)
    ct = torch.rand((48 * 40, 3), generator=torch.Generator().manual_seed(8))
    rad, g = ptt.render_vjp(scene, ct, 1, 1, nee=True)
    assert rad.device.type == "cuda" and g["tri_verts"] is None
    _, want = ptt.render_vjp(scene, ct, 1, 1, nee=True, plain=True)
    from pathtrace_tpu_torch.render import diff as D

    rows = GC.compare(D.named_leaves(g), D.named_leaves(want), *GC.K8_TOL,
                      GC.FIREFLY_SHARE)
    assert all(row[-1] for row in rows), rows


def test_k8_rejects_the_linear_form(cuda):
    job = K.prepare(without_bvh(_scene("cornell_mesh", (16, 16), 2)), cuda)
    with pytest.raises(ValueError, match="BVH"):
        VJ.trace_k8(*_k8_args(job, torch.ones((256, 3), device=cuda)))


def test_k7_over_several_flushes_matches_plain(cuda):
    # 64x64 d8 at 64 spp: the default flush rule folds the block's 8192
    # paths at once; 1024 paths a flush cuts them into 8 chunks.  The
    # exact sums give the same bits either way, and the plain version's
    # values within the reference's tolerance
    scene = _scene("cornell", (64, 64), 8)
    job = K.prepare(scene, cuda)
    mtab = MG.material_table(scene, cuda)
    mat_of = tuple(int(m) for m in scene.geoms.material_id)
    rad, counts = K.trace_k1(**job, it0=1, n_spp=64)
    ref, _ = K.trace_plain(**job, it0=1, n_spp=64)
    ct = _masked_ct(rad, ref)
    assert MG.k7_flush_paths(8) >= 64 * 128
    got = MG.trace_k7(job, mtab, mat_of, ct, 1, 64)
    split = MG.trace_k7(job, mtab, mat_of, ct, 1, 64, flush_paths=1024)
    for a, b in zip(got, split):
        assert torch.equal(a, b)
    assert torch.equal(got[0], rad) and torch.equal(got[1], counts)
    _, want_counts, want = MG.k7_plain(job, mtab, mat_of, ct, 1, 64)
    assert torch.equal(got[1], want_counts)
    torch.testing.assert_close(got[2], want, rtol=GC.K7_TOL[0],
                               atol=GC.K7_TOL[1])
    with pytest.raises(ValueError, match="flushes"):
        MG.trace_k7(job, mtab, mat_of, ct, 1, 1,
                    flush_paths=MG.k7_flush_paths(8) + 1)
    with pytest.raises(RuntimeError):  # under one sample of a block's pool
        MG.trace_k7(job, mtab, mat_of, ct, 1, 1, flush_paths=64)


def test_k7_on_a_mesh_matches_plain(cuda):
    scene = _scene("cornell_mesh", (64, 64), 4)
    job = K.prepare(scene, cuda)
    mtab = MG.material_table(scene, cuda)
    mat_of = tuple(int(m) for m in scene.geoms.material_id)
    rad, counts = K.trace_k1(**job, it0=1, n_spp=2)
    ref, _ = K.trace_plain(**job, it0=1, n_spp=2)
    ct = _masked_ct(rad, ref)
    before = MG.LAUNCHES[K.MESH_BIT]
    got_rad, got_counts, got = MG.trace_k7(job, mtab, mat_of, ct, 1, 2)
    assert MG.LAUNCHES[K.MESH_BIT] == before + 1
    assert torch.equal(got_rad, rad) and torch.equal(got_counts, counts)
    _, _, want = MG.k7_plain(job, mtab, mat_of, ct, 1, 2)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
