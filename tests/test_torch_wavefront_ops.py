"""The wavefront's operations against the reference's, on seeded inputs.

``ops/intersect.py``, ``ops/bsdf.py``, the samplers of ``ops/lights.py``,
the rest of ``core/vecmath.py`` and ``render/integrator.raygen`` of the
port against ``pathtrace_tpu``'s functions of the same names on the same
numpy inputs (the reference's under ``jax.jit`` on the CPU).  Tolerance:
1e-5 absolute on the intersection's point, normal, distance and UV (XLA
contracts some mul-adds into FMAs on the CPU, a few ulps at the cornell
box's coordinates of up to 10); the winning geom and the hit flag equal
on every ray whose two nearest candidates are not within 1e-4 of each
other (a near tie may go either way); 1e-6 on the rest.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from pathtrace_tpu.core import vecmath as jvm
from pathtrace_tpu.ops import bsdf as JB
from pathtrace_tpu.ops import intersect as JX
from pathtrace_tpu.ops import lights as JL
from pathtrace_tpu.render import integrator as JI
from pathtrace_tpu_torch import convert
from pathtrace_tpu_torch.core import vecmath as vm
from pathtrace_tpu_torch.ops import bsdf as B
from pathtrace_tpu_torch.ops import intersect as X
from pathtrace_tpu_torch.ops import lights as L
from pathtrace_tpu_torch.render import integrator as I

from torch_scenes import REPO, scene_text

N_RAYS = 3000


def _jscene(name, edits=()):
    from pathtrace_tpu.scene.parser import parse_scene

    return parse_scene(scene_text(name, edits), base_dir=f"{REPO}/scenes")


def _t(a):
    return torch.tensor(np.array(a))


def _rays(seed, n=N_RAYS, lo=(-4.5, 0.5, -4.5), hi=(4.5, 9.5, 4.5)):
    """Seeded origins in the cornell box's inside and unit directions."""
    rs = np.random.default_rng(seed)
    o = rs.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d


def _near_tie(dists):
    """(N,) bool: the two nearest of the (N, K) candidate distances are
    hits within 1e-4 of each other."""
    s = np.sort(dists, axis=1)
    return (s[:, 0] < 1e30) & (s[:, 1] - s[:, 0]
                               < 1e-4 * np.maximum(s[:, 0], 1.0))


# name -> (scene file, variant edits, want_uv)
ISECT_CASES = {
    "cornell": ("cornell", (), False),
    "cornell_tex": ("cornell_tex", (), True),
    "cornell_mesh": ("cornell_mesh", (), False),
    "mesh_bump": ("cornell_mesh", ("MESH_BUMP",), True),
    "mesh_motion": ("cornell_mesh", ("MESH_GLASS", "MESH_MOTION"), False),
}


@pytest.mark.parametrize("case", sorted(ISECT_CASES))
def test_intersect_scene_matches_reference(case):
    import torch_scenes

    name, edit_names, want_uv = ISECT_CASES[case]
    js = _jscene(name, tuple(getattr(torch_scenes, e) for e in edit_names))
    scene = convert.from_jax_scene(js)
    fwd, inv, inv_t = (np.asarray(a) for a in JI.geom_transforms(js.geoms))
    o, d = _rays(3)
    rs = np.random.default_rng(4)
    mesh = js.mesh.count > 0
    vel = (None if js.geoms.velocity is None
           else np.asarray(js.geoms.velocity))
    time = rs.uniform(0, 1, N_RAYS).astype(np.float32) if vel is not None \
        else None
    tang = None
    if any(t >= 0 for t in js.bump_texture_ids) and mesh:
        uv = (np.asarray(js.mesh.tri_uv) if js.mesh.tri_uv is not None
              else np.broadcast_to(np.float32([[0, 0], [1, 0], [0, 1]]),
                                   (js.mesh.count, 3, 2)))
        tang = np.concatenate([np.asarray(a) for a in
                               JX.triangle_uv_gradients(
                                   np.asarray(js.mesh.tri_verts), uv)], -1)
    tri = np.asarray(js.mesh.tri_verts) if mesh else None
    tri_geom = np.asarray(js.mesh.tri_geom) if mesh else None
    tri_uv = (np.asarray(js.mesh.tri_uv) if mesh and js.mesh.tri_uv
              is not None else None)

    ref = jax.jit(lambda o, d, t: JX.intersect_scene(
        o, d, js.geoms.type, fwd, inv, inv_t, tri_verts=tri,
        tri_geom=tri_geom, velocity=vel, time=t, tri_uv=tri_uv,
        want_uv=want_uv, tri_tang=tang))(o, d, time)
    got = X.intersect_scene(
        _t(o), _t(d), scene.geoms.type, _t(fwd), _t(inv), _t(inv_t),
        tri_verts=None if tri is None else _t(tri), tri_geom=tri_geom,
        velocity=None if vel is None else _t(vel),
        time=None if time is None else _t(time),
        tri_uv=None if tri_uv is None else _t(tri_uv), want_uv=want_uv,
        tri_tang=None if tang is None else _t(tang))

    # every candidate's distance (the primitives' and the triangles'), to
    # find the near ties
    cand = []
    for g, kind in enumerate(js.geoms.type):
        o_g = o if vel is None else o - time[:, None] * vel[g]
        if kind == 0:
            cand.append(np.asarray(JX._one_sphere(o_g, d, fwd[g], inv[g],
                                                  inv_t[g])[0]))
        elif kind == 1:
            cand.append(np.asarray(JX._one_box(o_g, d, fwd[g], inv[g])[0]))
    for g in sorted(set(tri_geom.tolist()) if mesh else ()):
        on = tri_geom == g
        o_g = o if vel is None else o - time[:, None] * vel[g]
        cand.append(np.asarray(JX.intersect_triangles(
            o_g, d, tri[on], tri_geom[on], fwd, inv, inv_t)[0]).T)
    cand = np.concatenate([np.atleast_2d(c).reshape(-1, N_RAYS) for c in cand])
    clear = ~_near_tie(cand.T)
    assert clear.mean() > 0.99
    keys = ["geom_idx", "hit", "outside"]
    for k in keys:
        np.testing.assert_array_equal(got[k].numpy()[clear],
                                      np.asarray(ref[k])[clear], err_msg=k)
    fields = ["dist", "point", "normal"] + (["uv"] if want_uv else []) + (
        ["tang"] if tang is not None else [])
    hit = clear & np.asarray(ref["hit"])
    assert hit.mean() > 0.5  # the box is open at the front
    for k in fields:
        np.testing.assert_allclose(got[k].numpy()[hit],
                                   np.asarray(ref[k])[hit], rtol=0,
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("kind", ["boxes", "spheres", "triangles"])
def test_batched_intersections_match_reference(kind):
    # each test on the geoms of its kind: cornell's cubes and sphere,
    # cornell_mesh's triangles
    js = _jscene("cornell_mesh" if kind == "triangles" else "cornell")
    fwd, inv, inv_t = (np.asarray(a) for a in JI.geom_transforms(js.geoms))
    if kind != "triangles":
        on = np.asarray(js.geoms.type) == (1 if kind == "boxes" else 0)
        fwd, inv, inv_t = fwd[on], inv[on], inv_t[on]
    o, d = _rays(5, n=500)
    if kind == "boxes":
        args = (fwd, inv)
        ref, got = JX.intersect_boxes(o, d, *args), X.intersect_boxes(
            _t(o), _t(d), *map(_t, args))
    elif kind == "spheres":
        args = (fwd, inv, inv_t)
        ref, got = JX.intersect_spheres(o, d, *args), X.intersect_spheres(
            _t(o), _t(d), *map(_t, args))
    else:
        tv, tg = np.asarray(js.mesh.tri_verts), np.asarray(js.mesh.tri_geom)
        ref = JX.intersect_triangles(o, d, tv, tg, fwd, inv, inv_t)
        got = X.intersect_triangles(_t(o), _t(d), _t(tv), tg, _t(fwd),
                                    _t(inv), _t(inv_t))
    hit = np.asarray(ref[0]) < 1e30
    assert hit.any()
    np.testing.assert_array_equal(got[0].numpy() < 1e30, hit)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    for a, b in zip(got[:3], ref[:3]):
        np.testing.assert_allclose(a.numpy()[hit], np.asarray(b)[hit],
                                   rtol=0, atol=1e-5)


def test_triangle_uv_gradients_live_in_intersect():
    # moved from render/integrator, which re-exports it
    assert I.triangle_uv_gradients is X.triangle_uv_gradients


def _materials(n, seed):
    """Per-ray materials: diffuse, mirror, imperfect specular, a
    diffuse/specular mix and glass, in turn."""
    rs = np.random.default_rng(seed)
    kind = np.arange(n) % 5
    f = np.float32
    mat = dict(
        color=rs.uniform(0.1, 1, (n, 3)).astype(f),
        spec_color=rs.uniform(0.1, 1, (n, 3)).astype(f),
        spec_exponent=np.where(kind == 2, rs.uniform(1, 200, n), 0).astype(f),
        has_reflective=np.select([kind == 1, kind == 2, kind == 3],
                                 [1.0, 1.0, 0.4], 0.0).astype(f),
        has_refractive=(kind == 4).astype(f),
        ior=np.where(kind == 4, rs.uniform(1.2, 2.0, n), 0).astype(f),
        emittance=np.zeros(n, f),
    )
    return mat


def test_sample_bsdf_matches_reference_on_every_lobe():
    n = 4000
    rs = np.random.default_rng(7)
    nrm = rs.normal(size=(n, 3))
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(
        np.float32)
    wi = rs.normal(size=(n, 3))
    wi = wi / np.linalg.norm(wi, axis=1, keepdims=True)
    # toward the surface: against the normal
    wi = np.where((wi * nrm).sum(1, keepdims=True) > 0, -wi, wi).astype(
        np.float32)
    outside = rs.uniform(size=n) < 0.5
    mat = _materials(n, 8)
    u = {k: rs.uniform(size=n).astype(np.float32) for k in (
        "lobe", "diff_u1", "diff_u2", "fresnel", "spec_u1", "spec_u2")}
    ref = jax.jit(JB.sample_bsdf)(wi, nrm, outside, mat, u)
    got = B.sample_bsdf(_t(wi), _t(nrm), _t(outside),
                        {k: _t(v) for k, v in mat.items()},
                        {k: _t(v) for k, v in u.items()})
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]),
                               rtol=1e-6, atol=1e-6)
    for a, b in zip(got[2:], ref[2:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # every lobe was taken: diffuse, specular, reflect and refract
    took_diffuse, took_refract = got[2].numpy(), got[3].numpy()
    glass = mat["has_refractive"] > 0
    assert took_diffuse.any() and (~took_diffuse & ~glass).any()
    assert (took_refract & glass).any() and (~took_refract & glass).any()


@pytest.mark.parametrize("kind", ["cube", "sphere"])
def test_light_sampling_and_nee_contribution_match_reference(kind):
    js = _jscene("cornell")
    # the cube light of cornell.txt, or its sphere
    g = (js.light_indices[0] if kind == "cube"
         else list(js.geoms.type).index(0))
    fwd, _, inv_t = (np.asarray(a) for a in JI.geom_transforms(js.geoms))
    rs = np.random.default_rng(11)
    n = 2000
    u_sel, u1, u2 = (rs.uniform(size=n).astype(np.float32) for _ in range(3))
    if kind == "cube":
        ref = jax.jit(JL.sample_cube_light)(fwd[g], u_sel, u1, u2)
        got = L.sample_cube_light(_t(fwd[g]), _t(u_sel), _t(u1), _t(u2))
    else:
        ref = jax.jit(JL.sample_sphere_light)(fwd[g], inv_t[g], u1, u2)
        got = L.sample_sphere_light(_t(fwd[g]), _t(inv_t[g]), _t(u1),
                                    _t(u2))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)

    point, _ = _rays(12, n=n)
    nrm = rs.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    albedo, thr = (rs.uniform(size=(n, 3)).astype(np.float32)
                   for _ in range(2))
    occluded = rs.uniform(size=n) < 0.3
    emission = np.float32([15.0, 14.0, 13.0])
    lp, ln, area = (np.asarray(a) for a in ref)
    want = JL.nee_contribution(point, nrm, albedo, thr, lp, ln, area,
                               emission, occluded)
    have = L.nee_contribution(_t(point), _t(nrm), _t(albedo), _t(thr),
                              _t(lp), _t(ln), _t(area), _t(emission),
                              _t(occluded))
    assert np.abs(np.asarray(want)).max() > 0
    np.testing.assert_allclose(have.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_vecmath_rest_matches_reference():
    rs = np.random.default_rng(13)
    a, b = (rs.normal(size=(500, 3)).astype(np.float32) for _ in range(2))
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    eta = rs.uniform(0.5, 2.0, (500, 1)).astype(np.float32)
    m = rs.normal(size=(4, 4)).astype(np.float32)
    pairs = [
        (vm.norm(_t(a)), jvm.norm(a)),
        (vm.normalize(_t(a), eps=1e-20), jvm.normalize(a, eps=1e-20)),
        (vm.reflect(_t(a), _t(b)), jvm.reflect(a, b)),
        (vm.refract(_t(a), _t(b), _t(eta)), jvm.refract(a, b, eta)),
        (vm.luminance(_t(a)), jvm.luminance(a)),
        (vm.transform_point(_t(m), _t(a)), jvm.transform_point(m, a)),
        (vm.transform_dir(_t(m), _t(a)), jvm.transform_dir(m, a)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    # some of the refractions are total internal reflections: zero
    tir = np.all(np.asarray(pairs[3][1]) == 0, axis=1)
    assert tir.any() and not tir.all()


@pytest.mark.parametrize("dof", [False, True], ids=["pinhole", "dof"])
def test_raygen_matches_reference(dof):
    js = dataclasses.replace(_jscene("cornell"), resolution=(40, 30))
    if dof:
        js = dataclasses.replace(js, camera=dataclasses.replace(
            js.camera, aperture=np.float32(0.4),
            focal_dist=np.float32(9.0)))
    scene = I.resident(convert.from_jax_scene(js), "cpu")
    pix = np.arange(js.pixel_count, dtype=np.int32)
    ref = jax.jit(lambda p: JI.raygen(js.camera, 40, 30, 3, p))(pix)
    got = I.raygen(scene.camera, 40, 30, 3, torch.arange(js.pixel_count))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)
    if dof:  # the lens moved the origins
        assert np.ptp(got[0].numpy(), axis=0).max() > 0.1


def test_take_rows_folds_small_tables_and_indexes_large_ones():
    idx = torch.tensor([2, 0, 1, 2])
    small = torch.arange(12.0).reshape(3, 4)
    assert torch.equal(I._take_rows(small, idx), small[idx])
    big = torch.arange(70.0 * 2).reshape(70, 2)
    idx_big = torch.tensor([69, 3, 0])
    assert torch.equal(I._take_rows(big, idx_big), big[idx_big])
    assert torch.equal(I._take_rows(np.array([5, 7, 9]), idx),
                       torch.tensor([9, 5, 7, 9]))
