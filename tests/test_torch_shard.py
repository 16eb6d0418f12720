"""Multi-device rendering (``pathtrace_tpu_torch/parallel/shard.py``) on
two gloo ranks on the CPU, against single-process renders of the port and
against the reference's ``parallel/shard.py`` on the 8-device CPU mesh.

Two worker processes (``tests/torch_shard_worker.py``) run every case of
``tests/torch_shard_cases.py`` once for the module, meeting through a
file store in a temporary directory; this process never joins a group.
The holds: both ranks return the same bits; a pixel-sharded image is
bit-equal to one process's render of the whole image; a sample-sharded
one is bit-equal to the rank-ordered sum of each rank's one-process
render and within rtol 1e-6 of one process's render of all the samples;
counts exact.  The grad steps against one process's composition of the
same route, at the tolerance of the reference's own sharded grad tests
(rtol 1e-3 / atol 2e-6, ``tests/test_parallel.py:160``), losses within
1e-7.  Against the reference: the wavefront within the tie bound of
``tests/torch_wavefront_ref.py``, the planes engine within rtol 1e-6, and
``sharded_grad_step`` at the reference's bounds (rtol 2e-3 / atol 1e-5,
loss within 1e-6, ``tests/test_parallel.py:68-84``) with the target each
engine's own image on the reference's tie flips
(``tests/torch_wavefront_grad_ref.py``).
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import pathtrace_tpu as pt
from pathtrace_tpu.parallel import shard as ps
from pathtrace_tpu_torch.ops.cuda import megakernel as K
from pathtrace_tpu_torch.ops.cuda import vjp
from pathtrace_tpu_torch.parallel import shard
from pathtrace_tpu_torch.render import diff as D

import torch_shard_cases as C
import torch_wavefront_ref as W
from test_torch_vjp import grad_groups

WORKER = os.path.join(C.REPO, "tests", "torch_shard_worker.py")
WORLD = 2


@pytest.fixture(scope="module")
def scenes():
    return {name: C.scene(name) for name in C.SCENES}


@pytest.fixture(scope="module")
def reference(scenes):
    """The reference's sharded wavefront, planes and grad step on the
    8-device mesh at cornell 16x16 d3, and the grad step's targets: zero
    but on the pixels where the port's image and the reference's part
    (each engine's own image there)."""
    mesh = ps.make_mesh()
    js = dataclasses.replace(
        pt.load_scene(os.path.join(C.REPO, "scenes", "cornell.txt"),
                      native=False), resolution=C.SCENES["cornell"][1],
        trace_depth=C.SCENES["cornell"][2])
    n = C.CASES["sample"][2]
    out = dict(
        sample=ps.render_sample_sharded(js, 1, n, mesh),
        pixel=ps.render_pixel_sharded(js, 1, C.CASES["pixel"][2], mesh),
        planes=ps.render_sample_sharded_planes(js, 1, n, mesh))
    out = {k: tuple(np.asarray(x) for x in v) for k, v in out.items()}
    port = C.one_process("wavefront", scenes["cornell"], 1, n)[0].numpy()
    flip = np.abs(port - out["sample"][0]).max(axis=-1) > 1e-3
    assert flip.sum() <= max(1, 0.005 * flip.size), np.nonzero(flip)
    out["flip"] = flip
    out["target"] = np.where(flip[:, None], port / n, 0).astype(np.float32)
    t_ref = np.where(flip[:, None], out["sample"][0] / n, 0).astype(
        np.float32)
    out["grad"] = ps.sharded_grad_step(js, t_ref, 1, n, mesh)
    return out


@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):
    """Each rank's results (a dict of numpy arrays), rank 0 first."""
    tmp = tmp_path_factory.mktemp("shard")
    np.save(tmp / "target.npy", reference["target"])
    outs = [tmp / f"rank{r}.npz" for r in range(WORLD)]
    env = dict(os.environ, PYTHONPATH=C.REPO)
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(WORLD), str(tmp / "store"),
         str(outs[r]), str(tmp / "target.npy")], env=env, cwd=C.REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return [dict(np.load(o)) for o in outs]


def _by_key(res, prefix):
    return {k[len(prefix):]: v for k, v in res.items()
            if k.startswith(prefix)}


@pytest.mark.parametrize("key", sorted(C.CASES))
def test_sharded_render_matches_one_process(ranks, scenes, key):
    fn, sc, n, kw, engine, mode = C.CASES[key]
    rad, counts = ranks[0][f"{key}.rad"], ranks[0][f"{key}.counts"]
    for r in ranks[1:]:  # every rank holds the same bits
        np.testing.assert_array_equal(r[f"{key}.rad"], rad)
        np.testing.assert_array_equal(r[f"{key}.counts"], counts)
    whole = [x.numpy() for x in C.one_process(engine, scenes[sc], 1, n,
                                              **kw)]
    np.testing.assert_array_equal(counts, whole[1])
    assert rad.dtype == np.float32 and counts.dtype == np.int64
    if mode == "pixels":
        np.testing.assert_array_equal(rad, whole[0])
        return
    per = n // WORLD
    parts = [C.one_process(engine, scenes[sc], 1 + r * per, per, **kw)[0]
             for r in range(WORLD)]
    np.testing.assert_array_equal(rad, sum(parts).numpy())
    np.testing.assert_allclose(rad, whole[0], rtol=1e-6, atol=0)
    assert rad.sum() > 0


def _one_process_grad(key, sc, target):
    """(loss, gradients) of one process on the same route as ``key``."""
    fn, _, n, kw = C.GRADS[key]
    if fn == "sharded_grad_step_pallas":
        rad, _ = K.trace_k1(K.prepare(sc, "cpu", nee=kw["nee"]), 1, n)
        img = rad / n
        loss = torch.mean((img - target) ** 2)
        ct = 2.0 * (img - target) / float(img.shape[0] * 3 * n)
        return loss, vjp.render_vjp(sc, ct, 1, n, nee=kw["nee"],
                                    device="cpu")[1]
    engine = "planes" if fn == "sharded_grad_step_planes" else "wavefront"
    return D.render_loss_and_grad(sc, target, 1, n, nee=kw.get("nee", False),
                                  engine=engine, device="cpu")


@pytest.mark.parametrize("key", sorted(C.GRADS))
def test_sharded_grad_step_matches_one_process(ranks, reference, scenes,
                                               key):
    fn, sc, n, kw = C.GRADS[key]
    got = _by_key(ranks[0], f"{key}.g.")
    for r in ranks[1:]:
        assert _by_key(r, f"{key}.g.").keys() == got.keys()
        for name, g in _by_key(r, f"{key}.g.").items():
            np.testing.assert_array_equal(g, got[name])
        assert r[f"{key}.loss"] == ranks[0][f"{key}.loss"]
    target = torch.as_tensor(reference["target"] if key == "grad" else
                             np.zeros((scenes[sc].pixel_count, 3),
                                      np.float32))
    loss, want = _one_process_grad(key, scenes[sc], target)
    want = grad_groups(want)
    assert got.keys() == want.keys()
    assert abs(float(ranks[0][f"{key}.loss"]) - float(loss)) < 1e-7
    for name in sorted(want):
        np.testing.assert_allclose(got[name], want[name], rtol=1e-3,
                                   atol=2e-6, err_msg=name)
    mesh_scene = scenes[sc].mesh.count > 0
    assert bool(ranks[0][f"{key}.tri_verts_none"]) == (
        mesh_scene and fn == "sharded_grad_step_pallas")
    if mesh_scene and fn == "sharded_grad_step_planes":
        assert np.abs(got["tri_verts"]).sum() > 0
    assert np.abs(got["materials.emittance"]).sum() > 0


def test_mesh_of_part_of_the_ranks_and_broadcast(ranks, scenes):
    # make_mesh(1): rank 0's mesh of one renders alone; rank 1 gets None
    assert not ranks[0]["sub.none"] and ranks[1]["sub.none"]
    rad, counts = C.one_process("k1", scenes["cornell"], 1, 2)
    np.testing.assert_array_equal(ranks[0]["sub.rad"], rad.numpy())
    np.testing.assert_array_equal(ranks[0]["sub.counts"], counts.numpy())
    for r in ranks:
        assert int(r["broadcast"]) == 7


@pytest.mark.parametrize("key", ["sample", "pixel", "sample-planes",
                                 "grad"])
def test_matches_the_reference(ranks, reference, key):
    got = ranks[0]
    if key == "grad":
        loss, want = reference["grad"]
        assert abs(float(got["grad.loss"]) - float(loss)) < 1e-6
        want = grad_groups(want)
        assert _by_key(got, "grad.g.").keys() == want.keys()
        for name, g in _by_key(got, "grad.g.").items():
            np.testing.assert_allclose(g, want[name], rtol=2e-3, atol=1e-5,
                                       err_msg=name)
        return
    rad, counts = got[f"{key}.rad"], got[f"{key}.counts"]
    ref = reference["planes" if key == "sample-planes" else key]
    if key == "sample-planes":  # the planes engine: bit for bit per sample
        np.testing.assert_allclose(rad, ref[0], rtol=1e-6, atol=0)
        np.testing.assert_array_equal(counts, ref[1])
        return
    # the wavefront: the reference's jitted tie flips (XLA's FMAs)
    d = np.abs(rad - ref[0]).max(axis=-1)
    assert (d > 1e-3).mean() < W.TIE_SHARE, np.nonzero(d > 1e-3)
    np.testing.assert_allclose(counts.astype(np.float64),
                               np.asarray(ref[1], np.float64), rtol=0.02)


class _Ranks:
    """A mesh of two ranks for the checks that raise before any
    collective: no process group is made."""
    mesh = shard.Mesh(group=None, rank=0, size=2,
                      device=torch.device("cpu"))


@pytest.mark.parametrize("fn", [
    "render_sample_sharded", "render_sample_sharded_pallas",
    "render_sample_sharded_sorted", "render_sample_sharded_planes",
    "sharded_grad_step", "sharded_grad_step_planes",
    "sharded_grad_step_pallas"])
def test_samples_not_divisible_raise(scenes, fn):
    args = (np.zeros((256, 3), np.float32),) if "grad" in fn else ()
    with pytest.raises(ValueError, match="n_iters 3 not divisible by 2"):
        getattr(shard, fn)(scenes["cornell"], *args, 1, 3, _Ranks.mesh)


@pytest.mark.parametrize("fn", [
    "render_pixel_sharded", "render_pixel_sharded_pallas",
    "render_pixel_sharded_planes"])
def test_pixels_not_divisible_raise(scenes, fn):
    odd = dataclasses.replace(scenes["cornell"], resolution=(3, 3))
    with pytest.raises(ValueError, match="pixel count 9 not divisible"):
        getattr(shard, fn)(odd, 1, 2, _Ranks.mesh)


@pytest.mark.parametrize("case", ["textured", "mesh without a BVH"])
def test_grad_step_pallas_refuses(scenes, case):
    from pathtrace_tpu_torch.scene.bvh import without_bvh

    sc = (scenes["tex"] if case == "textured" else
          without_bvh(scenes["mesh"]))
    target = np.zeros((sc.pixel_count, 3), np.float32)
    with pytest.raises(NotImplementedError, match="sharded_grad_step_pallas"):
        shard.sharded_grad_step_pallas(sc, target, 1, 2, _Ranks.mesh)


def test_make_mesh_needs_a_group():
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        shard.make_mesh(device="cpu")


@pytest.mark.parametrize("tiles", [(0, 96, 160), (0, 1, 100, 255),
                                   (0, 128)], ids=["3", "edges", "halves"])
def test_pixel_tiles_put_together_are_the_image(scenes, tiles):
    # trace_plain's (and on the CPU trace_k1's) pix0/n_local slabs
    job = K.prepare(scenes["cornell"], "cpu", nee=True)
    whole, counts = K.trace_plain(**job, it0=3, n_spp=2)
    bounds = list(tiles) + [whole.shape[0]]
    total = torch.zeros_like(counts)
    for fn in (lambda **kw: K.trace_plain(**job, **kw),
               lambda **kw: K.trace_k1(job, **kw)):
        parts = []
        for a, b in zip(bounds, bounds[1:]):
            rad, c = fn(it0=3, n_spp=2, pix0=a, n_local=b - a)
            assert rad.shape == (b - a, 3)
            parts.append(rad)
            total += c
        assert torch.equal(torch.cat(parts), whole)
    assert torch.equal(total, 2 * counts)
