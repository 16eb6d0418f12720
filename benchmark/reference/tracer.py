"""The reference tracer: the megakernel's plain version, written out
again in plain PyTorch for the scenes the benchmark runs (spheres, cubes
and BVH meshes; diffuse, mirror, imperfect-specular, glass and emissive
materials; a pinhole or thin-lens camera; next-event estimation; Russian
roulette), one element a path, in the program's operation order, so that
it rounds as the program's own plain version does.  :func:`trace`
renders any set of pixels, so a check can take a sample of them.

Three sections beside the diffuse and mirror lobes, each specialised, as
the program's are, on a static fact of the scene (``tables["features"]``),
so that a scene without it runs none of its operations:

* the thin lens in raygen (``has_dof``): an aperture sample
  (``DOF_U``, ``DOF_V``), the ray from it through the focal plane;
* Schlick glass (``has_glass``): the ``FRESNEL`` choice between the
  mirror and Snell's refraction (the mirror under total internal
  reflection), by the hit's facing, on spheres, cubes and meshes alike;
  the refracted ray pushed past the interface, glass's throughput
  (``specrgb`` reflected, ``rgb`` refracted, no division by the choice),
  and under NEE no direct light at a glass hit and the emission seen
  after it;
* the imperfect specular lobe (``has_imperfect``): a power-cosine sample
  (``SPEC_U1``, ``SPEC_U2``) about the mirror direction where ``specex``
  > 0.

Each carries the program's ``needed`` marks and ``tally`` names, so that
``work/recount.py`` counts such a scene as the program's count does.
Checker, bump, subsurface scattering, motion blur and textures are not
traced: ``tables.check_config`` refuses them.

Two mesh walks give the same winner (the nearest hit in object space,
the lowest triangle row on a tie): ``"skip"``, the stackless skip-link
walk one node a step that the kernel runs, which carries the work marks
of ``bound.py`` (the frozen rooflines count it, ``work/recount.py``), and
``"frontier"``, a breadth-first walk over (ray, node) pairs in a few
large steps, which the checks run because it is fast.

``dtype`` computes in another precision (the control: bfloat16); the
BVH's integer columns stay exact.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from . import rng
from .bound import needed as _needed
from .bound import read as _read
from .bound import tally as _tally
from .rng import Draw
from .tables import CUBE, MESH, PI, SPHERE

TWO_PI = 6.2831853071795864769252867665590057683943
SQRT_OF_ONE_THIRD = 0.5773502691896257645091487805019574556476
RAY_OFFSET = 1e-4
NO_HIT = 1e30
WALK_CHUNK = 1 << 20   # rays a frontier walk takes at once


def _c32(x):
    import numpy as np
    return float(np.float32(x))


class _SafeDiv(torch.autograd.Function):
    """``a / b``, whose derivative is zero where the incoming one is
    zero: the cube's slab divides by a direction component that may be
    exactly 0, and autograd would take 0 * inf = NaN on lanes that never
    select that axis."""

    @staticmethod
    def forward(ctx, a, b):
        out = a / b
        ctx.save_for_backward(b, out)
        return out

    @staticmethod
    def backward(ctx, g):
        b, out = ctx.saved_tensors
        zero = g == 0
        ga = torch.where(zero, 0.0, g / b)
        gb = torch.where(zero, 0.0, -g * out / b)
        return ga, gb


def _sdiv(a, b):
    return _SafeDiv.apply(a, b) if torch.is_grad_enabled() else a / b


def _normalize3(x, y, z):
    inv = torch.reciprocal(torch.sqrt(x * x + y * y + z * z))
    return x * inv, y * inv, z * inv


def _div(a, t):
    return (a.expand_as(t) if torch.is_tensor(a)
            else torch.full_like(t, a)) / t


def _rows(table, geom):
    pad = torch.zeros((1, table.shape[1]), dtype=table.dtype,
                      device=table.device)
    return torch.cat([table, pad])[geom]


def _clip01(x):
    return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_ones(()))


def _object_ray(m, ox, oy, oz, dx, dy, dz):
    rox = m[12] * ox + m[13] * oy + m[14] * oz + m[15]
    roy = m[16] * ox + m[17] * oy + m[18] * oz + m[19]
    roz = m[20] * ox + m[21] * oy + m[22] * oz + m[23]
    rdx = m[12] * dx + m[13] * dy + m[14] * dz
    rdy = m[16] * dx + m[17] * dy + m[18] * dz
    rdz = m[20] * dx + m[21] * dy + m[22] * dz
    return (ox, oy, oz), (rox, roy, roz, *_normalize3(rdx, rdy, rdz))


def _slab(mn, mx, o, ird):
    t1 = (mn - o) * ird
    t2 = (mx - o) * ird
    ta = torch.minimum(t1, t2)
    tb = torch.maximum(t1, t2)
    return (torch.where(torch.isnan(ta), -float("inf"), ta),
            torch.where(torch.isnan(tb), float("inf"), tb))


def _moller_trumbore(ray, row, bary=False):
    rox, roy, roz, rdx, rdy, rdz = ray[:6]
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = row[:, :9].unbind(1)
    pvx = rdy * e2z - rdz * e2y
    pvy = rdz * e2x - rdx * e2z
    pvz = rdx * e2y - rdy * e2x
    det = pvx * e1x + pvy * e1y + pvz * e1z
    ok = torch.abs(det) > 1e-12
    inv_det = torch.reciprocal(torch.where(ok, det, 1.0))
    tvx, tvy, tvz = rox - v0x, roy - v0y, roz - v0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    vv = (rdx * qvx + rdy * qvy + rdz * qvz) * inv_det
    tt = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    hit = ok & (u >= 0.0) & (vv >= 0.0) & (u + vv <= 1.0) & (tt > 0.0)
    return (tt, hit, u, vv) if bary else (tt, hit)


def _skip_walk(ray, t0, want, nodes, tri, tri_off):
    """The skip-link walk, per ray, one node a step: enter a node whose
    box the ray meets before ``t_loc`` (``t0`` at first), else skip it;
    in a leaf, a triangle nearer than ``t_loc`` wins.  Returns the
    winner's row of ``tri`` a ray (-1: none)."""
    widx = torch.full_like(t0, -1, dtype=torch.int64)
    live = torch.nonzero(want).squeeze(1)
    rays = torch.stack(ray, dim=1)[live]
    t_loc = t0[live]
    win = torch.full_like(live, -1)
    cur = torch.zeros_like(live)
    n_nodes = nodes.shape[0]
    while live.numel():
        with _needed("walk", compacted=True):
            node = nodes[cur]
            _read(nodes, "nodes", cur, 9)
            tax, tbx = _slab(node[:, 0], node[:, 3], rays[:, 0], rays[:, 6])
            tay, tby = _slab(node[:, 1], node[:, 4], rays[:, 1], rays[:, 7])
            taz, tbz = _slab(node[:, 2], node[:, 5], rays[:, 2], rays[:, 8])
            tnear = torch.maximum(torch.maximum(tax, tay),
                                  torch.clamp_min(taz, 0.0))
            tfar = torch.minimum(torch.minimum(tbx, tby), tbz)
            box_hit = (tnear <= tfar) & (tnear < t_loc)
        skip, start, count = node[:, 6:9].to(torch.int64).unbind(1)
        is_leaf = count > 0
        leaf = torch.nonzero(box_hit & is_leaf).squeeze(1)
        if leaf.numel():
            first = tri_off + start[leaf]
            cnt = count[leaf]
            lray = rays[leaf].unbind(1)
            lt, lw = t_loc[leaf], win[leaf]
            for k in range(int(cnt.max())):
                row = torch.where(k < cnt, first + k, first)
                with _needed("walk", k < cnt, compacted=True):
                    _read(tri, "tri", row, 9)
                    tt, hit = _moller_trumbore(lray, tri[row])
                    upd = (k < cnt) & hit & (tt < lt)
                lt = torch.where(upd, tt, lt)
                lw = torch.where(upd, row, lw)
            t_loc[leaf], win[leaf] = lt, lw
        cur = torch.where(is_leaf | ~box_hit, skip, cur + 1)
        done = cur >= n_nodes
        if bool(done.any()):
            widx[live[done]] = win[done]
            keep = ~done
            live, rays, t_loc, win, cur = (
                live[keep], rays[keep], t_loc[keep], win[keep], cur[keep])
    return widx


def _frontier_walk(ray, t0, want, nodes, links, tri, tri_off):
    """The same winner as :func:`_skip_walk` (the least distance below
    ``t0``, the lowest row on a tie), breadth first: every (ray, node)
    pair of a level at once, each box met before ``t0`` giving its two
    children (a leaf its triangles), in chunks of ``WALK_CHUNK`` rays.
    ``links`` is (skip, leaf start, leaf count) of each node, int64."""
    skip, start, count = links
    widx = torch.full_like(t0, -1, dtype=torch.int64)
    every = torch.nonzero(want).squeeze(1)
    rays_all = torch.stack(ray, dim=1)
    for c0 in range(0, every.numel(), WALK_CHUNK):
        ids = every[c0:c0 + WALK_CHUNK]
        n = ids.numel()
        rays, bound = rays_all[ids], t0[ids]
        best = torch.full_like(bound, float("inf"))
        cand_r, cand_t, cand_row = [], [], []
        pr = torch.arange(n, device=ids.device)
        pn = torch.zeros_like(pr)
        while pr.numel():
            node = nodes[pn]
            r = rays[pr]
            tax, tbx = _slab(node[:, 0], node[:, 3], r[:, 0], r[:, 6])
            tay, tby = _slab(node[:, 1], node[:, 4], r[:, 1], r[:, 7])
            taz, tbz = _slab(node[:, 2], node[:, 5], r[:, 2], r[:, 8])
            tnear = torch.maximum(torch.maximum(tax, tay),
                                  torch.clamp_min(taz, 0.0))
            tfar = torch.minimum(torch.minimum(tbx, tby), tbz)
            hit = (tnear <= tfar) & (tnear < bound[pr])
            is_leaf = count[pn] > 0
            lf = torch.nonzero(hit & is_leaf).squeeze(1)
            if lf.numel():
                lr, ln = pr[lf], pn[lf]
                first, cnt = tri_off + start[ln], count[ln]
                lray = rays[lr].unbind(1)
                for k in range(int(cnt.max())):
                    row = torch.where(k < cnt, first + k, first)
                    tt, th = _moller_trumbore(lray, tri[row])
                    ok = (k < cnt) & th & (tt < bound[lr])
                    cand_r.append(lr[ok])
                    cand_t.append(tt[ok])
                    cand_row.append(row[ok])
            inner = torch.nonzero(hit & ~is_leaf).squeeze(1)
            left = pn[inner] + 1
            pr = torch.cat([pr[inner], pr[inner]])
            pn = torch.cat([left, skip[left]])
        if not cand_r:
            continue
        cr, ct, crow = (torch.cat(x) for x in (cand_r, cand_t, cand_row))
        best = best.scatter_reduce(0, cr, ct.to(best.dtype), "amin")
        at_best = ct == best[cr]
        win = torch.full((n,), 2 ** 62, dtype=torch.int64, device=ids.device)
        win = win.scatter_reduce(0, cr[at_best], crow[at_best], "amin")
        widx[ids] = torch.where(win < 2 ** 62, win, -1)
    return widx


def _nearest(ox, oy, oz, dx, dy, dz, gmat, geom_types, shadow=False,
             mesh=None, want=None):
    """The nearest hit over the geoms by world distance (strict ``<``:
    ties keep the geom folded first), the spheres and cubes in index
    order, then each mesh (its walk, then one fold of the winning
    triangle).  Returns ``dist``, ``geom`` (-1: miss), ``hit`` and, unless
    ``shadow``, the world point ``p*``, normal ``n*`` and ``outside``."""
    zeros = torch.zeros_like(ox)
    h = SimpleNamespace(dist=torch.full_like(ox, NO_HIT),
                        geom=torch.full_like(ox, -1, dtype=torch.int64))
    if not shadow:
        h.px, h.py, h.pz = ox, oy, oz
        h.nx = h.ny = h.nz = zeros
        h.outside = torch.zeros_like(ox, dtype=torch.bool)

    def fold(g, m, hit, q, go, shade=None):
        qx, qy, qz = q
        pxw = m[0] * qx + m[1] * qy + m[2] * qz + m[3]
        pyw = m[4] * qx + m[5] * qy + m[6] * qz + m[7]
        pzw = m[8] * qx + m[9] * qy + m[10] * qz + m[11]
        ddx, ddy, ddz = go[0] - pxw, go[1] - pyw, go[2] - pzw
        dist = torch.sqrt(torch.where(hit, ddx * ddx + ddy * ddy + ddz * ddz,
                                      1.0))
        dist = torch.where(hit, dist, NO_HIT)
        better = dist < h.dist
        h.dist = torch.where(better, dist, h.dist)
        h.geom = torch.where(better, g, h.geom)
        if shadow:
            return

        def sel(a, b):
            return torch.where(better, a, b)

        with _needed(lanes=better):
            n0, out0 = shade()
        h.px, h.py, h.pz = sel(pxw, h.px), sel(pyw, h.py), sel(pzw, h.pz)
        h.nx, h.ny, h.nz = sel(n0[0], h.nx), sel(n0[1], h.ny), \
            sel(n0[2], h.nz)
        h.outside = sel(out0, h.outside)

    for g, gtype in enumerate(geom_types):
        if gtype == MESH:
            continue
        m = gmat[g]
        go, (rox, roy, roz, rdx, rdy, rdz) = _object_ray(m, ox, oy, oz, dx,
                                                         dy, dz)
        if gtype == SPHERE:
            vdd = rox * rdx + roy * rdy + roz * rdz
            rad2 = vdd * vdd - (rox * rox + roy * roy + roz * roz - 0.25)
            has_root = rad2 >= 0
            sq = torch.sqrt(torch.where(has_root, rad2, 1.0))
            t1 = -vdd + sq
            t2 = -vdd - sq
            both_neg = (t1 < 0) & (t2 < 0)
            both_pos = (t1 > 0) & (t2 > 0)
            t_use = torch.where(both_pos, torch.minimum(t1, t2),
                                torch.maximum(t1, t2))
            hit = has_root & ~both_neg
            tofs = t_use - RAY_OFFSET
            qx, qy, qz = rox + tofs * rdx, roy + tofs * rdy, roz + tofs * rdz

            def shade():
                nx0 = m[24] * qx + m[25] * qy + m[26] * qz
                ny0 = m[27] * qx + m[28] * qy + m[29] * qz
                nz0 = m[30] * qx + m[31] * qy + m[32] * qz
                nx0, ny0, nz0 = _normalize3(nx0, ny0, nz0)
                flip = torch.where(both_pos, 1.0, -1.0)
                return (nx0 * flip, ny0 * flip, nz0 * flip), both_pos
        elif gtype == CUBE:
            tmin = torch.full_like(ox, -1e38)
            tmax = torch.full_like(ox, 1e38)
            nmin = [zeros] * 3
            nmax = [zeros] * 3
            nan_axis = torch.zeros_like(ox, dtype=torch.bool)
            for ax, (qo, qd) in enumerate(
                    [(rox, rdx), (roy, rdy), (roz, rdz)]):
                t1 = _sdiv(-0.5 - qo, qd)
                t2 = _sdiv(0.5 - qo, qd)
                ta = torch.minimum(t1, t2)
                tb = torch.maximum(t1, t2)
                nan_axis = nan_axis | torch.isnan(t1) | torch.isnan(t2)
                upd_min = (ta > 0) & (ta > tmin)
                tmin = torch.where(upd_min, ta, tmin)
                upd_max = tb < tmax
                tmax = torch.where(upd_max, tb, tmax)
                if not shadow:
                    sign = torch.where(t2 < t1, 1.0, -1.0)
                    nmin = [torch.where(upd_min, sign if k == ax else 0.0,
                                        nmin[k]) for k in range(3)]
                    nmax = [torch.where(upd_max, sign if k == ax else 0.0,
                                        nmax[k]) for k in range(3)]
            hit = (tmax >= tmin) & (tmax > 0) & ~nan_axis
            inside = tmin <= 0
            t_use = torch.where(inside, tmax, tmin)
            tofs = t_use - RAY_OFFSET
            qx, qy, qz = rox + tofs * rdx, roy + tofs * rdy, roz + tofs * rdz

            def shade():
                nox, noy, noz = (torch.where(inside, nmax[k], nmin[k])
                                 for k in range(3))
                # the box normal through the forward transform, as the
                # course's intersections.h does
                n0 = _normalize3(m[0] * nox + m[1] * noy + m[2] * noz,
                                 m[4] * nox + m[5] * noy + m[6] * noz,
                                 m[8] * nox + m[9] * noy + m[10] * noz)
                return n0, ~inside
        else:
            raise ValueError(f"unknown geom type {gtype}")
        fold(g, m, hit, (qx, qy, qz), go, shade)

    tri, nodes, bvh_meta, walk, links = (mesh if mesh is not None
                                         else (None, None, (), None, None))
    want = torch.ones_like(ox, dtype=torch.bool) if want is None else want
    for g, node_off, n_nodes, tri_off, n_tris in bvh_meta:
        m = gmat[g]
        go, ray = _object_ray(m, ox, oy, oz, dx, dy, dz)
        rox, roy, roz, rdx, rdy, rdz = ray
        with torch.no_grad():
            wdx = m[0] * rdx + m[1] * rdy + m[2] * rdz
            wdy = m[4] * rdx + m[5] * rdy + m[6] * rdz
            wdz = m[8] * rdx + m[9] * rdy + m[10] * rdz
            s_ray = torch.sqrt(wdx * wdx + wdy * wdy + wdz * wdz)
            t0 = (h.dist / torch.clamp_min(s_ray, 1e-20)
                  * _c32(1.0 + 1e-5) + RAY_OFFSET + 1e-4)
            full = (*ray, _div(1.0, rdx), _div(1.0, rdy), _div(1.0, rdz))
            sub = nodes[node_off:node_off + n_nodes]
            if walk == "skip":
                widx = _skip_walk(full, t0, want, sub, tri, tri_off)
            else:
                widx = _frontier_walk(
                    full, t0, want, sub,
                    tuple(x[node_off:node_off + n_nodes] for x in links),
                    tri, tri_off)
        with _needed(lanes=lambda: widx >= 0):
            row = _rows(tri, widx)
            tt, hit, bu, bv = _moller_trumbore(ray, row, bary=True)
            hit = hit & (widx >= 0)
            tofs = tt - RAY_OFFSET
            qx, qy, qz = rox + tofs * rdx, roy + tofs * rdy, roz + tofs * rdz

            def shade():
                _read(tri, "tri shading", widx, 3)
                nox, noy, noz = (torch.where(hit, row[:, 9 + k],
                                             float(k == 0))
                                 for k in range(3))
                face = rdx * nox + rdy * noy + rdz * noz
                flip = torch.where(face < 0.0, 1.0, -1.0)
                n0 = _normalize3(
                    (m[24] * nox + m[25] * noy + m[26] * noz) * flip,
                    (m[27] * nox + m[28] * noy + m[29] * noz) * flip,
                    (m[30] * nox + m[31] * noy + m[32] * noz) * flip)
                return n0, hit & (face < 0.0)
            fold(g, m, hit, (qx, qy, qz), go, shade)
    h.hit = h.dist < NO_HIT
    return h


def _nee_add(rad, thr, h, n, albedo, has_diffuse, it, pix, dep, lights,
             gmat, geom_types, mesh):
    """Direct light at the hits: per light one area sample and one shadow
    ray, weight albedo / pi, where ``has_diffuse`` and the light is seen
    (a light that is not a sphere is sampled as a cube)."""
    nx, ny, nz = n
    rad = list(rad)
    for k, lr in enumerate(lights):
        with _needed("nee", has_diffuse):
            li, ltype = int(lr[0]), int(lr[1])
            base = Draw.NEE_BASE + 3 * k
            u_sel = _u(it, pix, dep, base + 0, h.px)
            u1 = _u(it, pix, dep, base + 1, h.px)
            u2 = _u(it, pix, dep, base + 2, h.px)
            if ltype == SPHERE:
                z = 1.0 - 2.0 * u1
                r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
                phi = u2 * _c32(TWO_PI)
                wx, wy, wz = r * torch.cos(phi), r * torch.sin(phi), z
                hx, hy, hz = 0.5 * wx, 0.5 * wy, 0.5 * wz
                lpx = lr[12] * hx + lr[13] * hy + lr[14] * hz + lr[21]
                lpy = lr[15] * hx + lr[16] * hy + lr[17] * hz + lr[22]
                lpz = lr[18] * hx + lr[19] * hy + lr[20] * hz + lr[23]
                lnx = lr[24] * wx + lr[25] * wy + lr[26] * wz
                lny = lr[27] * wx + lr[28] * wy + lr[29] * wz
                lnz = lr[30] * wx + lr[31] * wy + lr[32] * wz
                n_len = torch.sqrt(lnx * lnx + lny * lny + lnz * lnz)
                w_area = (_c32(PI) * lr[33]) * n_len
                inv_nl = torch.reciprocal(n_len)
                lnx, lny, lnz = lnx * inv_nl, lny * inv_nl, lnz * inv_nl
            else:
                ss = u1 - 0.5
                tt = u2 - 0.5
                zeros = torch.zeros_like(u1)
                lpx = lpy = lpz = lnx = lny = lnz = zeros
                prev = 0.0
                for f in range(6):
                    hi = lr[6 + f]
                    mface = (u_sel >= prev) & (u_sel < hi) if f < 5 \
                        else u_sel >= prev
                    o, eb, ec = 12 + 3 * f, 30 + 3 * f, 48 + 3 * f
                    nn = 66 + 3 * f
                    with _needed(lanes=mface):
                        lpx = torch.where(
                            mface, lr[o] + ss * lr[eb] + tt * lr[ec], lpx)
                        lpy = torch.where(mface, lr[o + 1] + ss * lr[eb + 1]
                                          + tt * lr[ec + 1], lpy)
                        lpz = torch.where(mface, lr[o + 2] + ss * lr[eb + 2]
                                          + tt * lr[ec + 2], lpz)
                    lnx = torch.where(mface, lr[nn], lnx)
                    lny = torch.where(mface, lr[nn + 1], lny)
                    lnz = torch.where(mface, lr[nn + 2], lnz)
                    prev = hi
                w_area = lr[5]

            wlx, wly, wlz = lpx - h.px, lpy - h.py, lpz - h.pz
            r2 = wlx * wlx + wly * wly + wlz * wlz
            r2_safe = torch.clamp_min(r2, 1e-8)
            dist_l = torch.sqrt(torch.clamp_min(r2, 1e-12))
            inv_dl = torch.reciprocal(dist_l)
            sdx, sdy, sdz = wlx * inv_dl, wly * inv_dl, wlz * inv_dl
            sh = _nearest(h.px, h.py, h.pz, sdx, sdy, sdz, gmat, geom_types,
                          shadow=True, mesh=mesh, want=has_diffuse)
            tol = torch.clamp_min(5e-3 * dist_l, 1e-3)
            visible = sh.hit & (sh.geom == li) & (
                torch.abs(sh.dist - dist_l) < tol)
            w_ok = has_diffuse & visible
            with _needed(lanes=w_ok):
                cos_s = torch.clamp_min(nx * sdx + ny * sdy + nz * sdz, 0.0)
                cos_l = torch.clamp_min(
                    -(lnx * sdx + lny * sdy + lnz * sdz), 0.0)
                gterm = cos_s * cos_l / r2_safe * w_area
                for c in range(3):
                    e_pi = _c32(1.0 / PI) * lr[2 + c]
                    rad[c] = rad[c] + torch.where(
                        w_ok, thr[c] * albedo[c] * e_pi * gterm, 0.0)
    return rad


def _imperfect_specular(m_ex, mrx, mry, mrz, u_s1, u_s2):
    """Power-cosine sample about the mirror direction (GPU Gems 3
    ch. 20) where ``m_ex`` > 0; the mirror direction elsewhere."""
    s3 = _c32(SQRT_OF_ONE_THIRD)
    n1 = torch.reciprocal(m_ex + 1.0)
    cos_t = torch.pow(torch.clamp_min(u_s1, 1e-12), n1)
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    phi = u_s2 * _c32(TWO_PI)
    use_xm = torch.abs(mrx) < s3
    use_ym = ~use_xm & (torch.abs(mry) < s3)
    nmx = torch.where(use_xm, 1.0, 0.0).to(mrx.dtype)
    nmy = torch.where(use_ym, 1.0, 0.0).to(mrx.dtype)
    nmz = torch.where(use_xm | use_ym, 0.0, 1.0).to(mrx.dtype)
    q1x, q1y, q1z = _normalize3(mry * nmz - mrz * nmy, mrz * nmx - mrx * nmz,
                                mrx * nmy - mry * nmx)
    q2x, q2y, q2z = _normalize3(mry * q1z - mrz * q1y, mrz * q1x - mrx * q1z,
                                mrx * q1y - mry * q1x)
    cp, sp = torch.cos(phi), torch.sin(phi)
    imx = cos_t * mrx + cp * sin_t * q1x + sp * sin_t * q2x
    imy = cos_t * mry + cp * sin_t * q1y + sp * sin_t * q2y
    imz = cos_t * mrz + cp * sin_t * q1z + sp * sin_t * q2z
    use_imp = m_ex > 0.0
    return (torch.where(use_imp, imx, mrx), torch.where(use_imp, imy, mry),
            torch.where(use_imp, imz, mrz))


def _u(it, pix, dep, draw, like):
    """A uniform draw in the precision of ``like``."""
    return rng.uniform(it, pix, dep, draw).to(like.dtype)


def _init_state(sc, it, pix, width, height):
    """Raygen: the antialias jitter, the ray through the pixel, then the
    thin lens."""
    (pos_x, pos_y, pos_z, v_x, v_y, v_z, r_x, r_y, r_z,
     u_x, u_y, u_z, tan_x, tan_y, aperture, focal) = sc.cam
    fx = (pix % width).to(sc.dtype)
    fy = torch.div(pix, width, rounding_mode="floor").to(sc.dtype)
    ujx = rng.uniform(it, pix, 0, Draw.AA_X).to(sc.dtype)
    ujy = rng.uniform(it, pix, 0, Draw.AA_Y).to(sc.dtype)
    sx = (fx + ujx) * _c32(2.0 / width) - 1.0
    sy = (fy + ujy) * _c32(2.0 / height) - 1.0
    dx = v_x - r_x * (tan_x * sx) - u_x * (tan_y * sy)
    dy = v_y - r_y * (tan_x * sx) - u_y * (tan_y * sy)
    dz = v_z - r_z * (tan_x * sx) - u_z * (tan_y * sy)
    dx, dy, dz = _normalize3(dx, dy, dz)
    ox = pos_x.expand_as(dx).contiguous()
    oy = pos_y.expand_as(dx).contiguous()
    oz = pos_z.expand_as(dx).contiguous()
    if sc.has_dof and aperture > 0.0:
        # the origin on the aperture, the ray through the focal plane
        u1 = _u(it, pix, 0, Draw.DOF_U, dx)
        u2 = _u(it, pix, 0, Draw.DOF_V, dx)
        r_lens = aperture * torch.sqrt(u1)
        theta = u2 * _c32(TWO_PI)
        lc, ls = r_lens * torch.cos(theta), r_lens * torch.sin(theta)
        off_x = r_x * lc + u_x * ls
        off_y = r_y * lc + u_y * ls
        off_z = r_z * lc + u_z * ls
        cos_v = dx * v_x + dy * v_y + dz * v_z
        ft = _div(focal, torch.clamp_min(cos_v, 1e-6))
        pfx, pfy, pfz = ox + dx * ft, oy + dy * ft, oz + dz * ft
        ox, oy, oz = ox + off_x, oy + off_y, oz + off_z
        dx, dy, dz = _normalize3(pfx - ox, pfy - oy, pfz - oz)
        _tally("dof", lambda: torch.ones_like(dx, dtype=torch.bool))
    one, zero = torch.ones_like(dx), torch.zeros_like(dx)
    st = dict(ox=ox, oy=oy, oz=oz, dx=dx, dy=dy, dz=dz, tr=one, tg=one,
              tb=one, rr=zero, rg=zero, rb=zero,
              live=torch.ones_like(dx, dtype=torch.bool))
    if sc.lights is not None:
        st["emit_ok"] = torch.ones_like(dx, dtype=torch.bool)
    return st


def _bounces(sc, st, it, pix, depth, counts):
    """Every bounce of the paths ``st``; adds the live count entering
    each bounce into ``counts[d]`` and returns the radiance (r, g, b)."""
    nee = sc.lights is not None
    has_glass, has_imperfect = sc.has_glass, sc.has_imperfect
    mats_t, gmat_t, gmat, lights = sc.mats, sc.gmat_t, sc.gmat, sc.lights
    ox, oy, oz, dx, dy, dz = (st[k] for k in ("ox", "oy", "oz", "dx", "dy",
                                               "dz"))
    thr_acc = [st["tr"], st["tg"], st["tb"]]
    rad = [st["rr"], st["rg"], st["rb"]]
    live = st["live"]
    emit_ok = st.get("emit_ok", torch.ones_like(live))
    s3 = _c32(SQRT_OF_ONE_THIRD)
    for d in range(depth):
        counts[d] += live.sum()
        with _needed("trace", live):
            h = _nearest(ox, oy, oz, dx, dy, dz, gmat, sc.geom_types,
                         mesh=sc.mesh, want=live)
        with _needed("surface", lambda: live & h.hit):
            row = _rows(mats_t, h.geom)
            albedo = [row[:, 0], row[:, 1], row[:, 2]]
            nx, ny, nz = h.nx, h.ny, h.nz
            emit = row[:, 10]
            emissive = emit > 0.0

        lit = live & h.hit & emissive
        if nee:
            lit = lit & emit_ok
        with _needed("surface", lit):
            rad = [rad[c] + torch.where(lit, thr_acc[c] * albedo[c] * emit,
                                        0.0) for c in range(3)]

        cont = live & h.hit & ~emissive
        dep = d + 1
        with _needed("scatter", cont):
            is_glass = (row[:, 8] > 0.0) if has_glass \
                else torch.zeros_like(cont)
            with _needed(lanes=lambda: ~is_glass):
                u_lobe = _u(it, pix, dep, Draw.LOBE, ox)
                p_spec = _clip01(row[:, 7])
                take_spec = u_lobe < p_spec
                p_safe = torch.clamp_min(
                    torch.where(take_spec, p_spec, 1.0 - p_spec), 1e-8)
            spec = take_spec & ~is_glass

            with _needed(lanes=lambda: ~take_spec & ~is_glass):
                u_d1 = _u(it, pix, dep, Draw.DIFF_U1, ox)
                u_d2 = _u(it, pix, dep, Draw.DIFF_U2, ox)
                up = torch.sqrt(u_d1)
                over = torch.sqrt(torch.clamp_min(1.0 - up * up, 0.0))
                around = u_d2 * _c32(TWO_PI)
                use_x = torch.abs(nx) < s3
                use_y = ~use_x & (torch.abs(ny) < s3)
                nn_x = torch.where(use_x, 1.0, 0.0).to(ox.dtype)
                nn_y = torch.where(use_y, 1.0, 0.0).to(ox.dtype)
                nn_z = torch.where(use_x | use_y, 0.0, 1.0).to(ox.dtype)
                p1x, p1y, p1z = _normalize3(ny * nn_z - nz * nn_y,
                                            nz * nn_x - nx * nn_z,
                                            nx * nn_y - ny * nn_x)
                p2x, p2y, p2z = _normalize3(ny * p1z - nz * p1y,
                                            nz * p1x - nx * p1z,
                                            nx * p1y - ny * p1x)
                ca, sa = torch.cos(around), torch.sin(around)
                ddf = (up * nx + ca * over * p1x + sa * over * p2x,
                       up * ny + ca * over * p1y + sa * over * p2y,
                       up * nz + ca * over * p1z + sa * over * p2z)

            with _needed(lanes=spec | is_glass):
                ndoti = nx * dx + ny * dy + nz * dz
            mirror = spec
            if has_glass:
                with _needed(lanes=is_glass):
                    # Schlick's choice between the mirror and Snell's
                    # refraction (the mirror under total internal
                    # reflection), not divided by its probability
                    u_fr = _u(it, pix, dep, Draw.FRESNEL, ox)
                    cos_i = torch.clamp(-ndoti, 0.0, 1.0)
                    ior = row[:, 9]
                    r0 = (1.0 - ior) / (1.0 + ior)
                    r0 = r0 * r0
                    mm = torch.clamp_min(1.0 - cos_i, 0.0)
                    refl_p = r0 + (1.0 - r0) * mm * mm * mm * mm * mm
                    eta = torch.where(
                        h.outside,
                        torch.reciprocal(torch.clamp_min(ior, 1e-6)), ior)
                    kk = 1.0 - eta * eta * (1.0 - ndoti * ndoti)
                    k_ok = kk >= 0.0
                    choose_refl = (u_fr < refl_p) | ~k_ok
                took_refract = is_glass & ~choose_refl
                mirror = spec | (is_glass & choose_refl)
                with _needed(lanes=took_refract):
                    sqk = torch.sqrt(torch.where(k_ok, kk, 1.0))
                    rf = [eta * dk - (eta * ndoti + sqk) * nk
                          for dk, nk in ((dx, nx), (dy, ny), (dz, nz))]
            with _needed(lanes=mirror):
                mr = (dx - 2.0 * ndoti * nx, dy - 2.0 * ndoti * ny,
                      dz - 2.0 * ndoti * nz)
            sp = mr
            if has_imperfect:
                with _needed(lanes=lambda: spec & (row[:, 6] > 0.0)):
                    sp = _imperfect_specular(
                        row[:, 6], *mr,
                        _u(it, pix, dep, Draw.SPEC_U1, ox),
                        _u(it, pix, dep, Draw.SPEC_U2, ox))
            ndir = [torch.where(take_spec, sp[k], ddf[k]) for k in range(3)]
            with _needed(lanes=lambda: ~is_glass):
                thr = [torch.where(take_spec, row[:, 3 + k], albedo[k])
                       / p_safe for k in range(3)]
            took_diffuse = ~take_spec
            if has_glass:
                ndir = [torch.where(is_glass,
                                    torch.where(choose_refl, mr[k], rf[k]),
                                    ndir[k]) for k in range(3)]
                thr = [torch.where(is_glass,
                                   torch.where(choose_refl, row[:, 3 + k],
                                               albedo[k]), thr[k])
                       for k in range(3)]
                took_diffuse = took_diffuse & ~is_glass
            op = [h.px, h.py, h.pz]
            if has_glass:
                # a refracted ray starts past the interface
                with _needed(lanes=took_refract):
                    push = _rows(gmat_t, h.geom)[:, 36]
                    op = [torch.where(took_refract, op[k] + push * ndir[k],
                                      op[k]) for k in range(3)]
            if nee:
                has_diffuse = cont & ~(row[:, 8] > 0.0)
                rad = _nee_add(rad, thr_acc, h, (nx, ny, nz), albedo,
                               has_diffuse, it, pix, dep, lights, gmat,
                               sc.geom_types, sc.mesh)
            # the lanes of the program's K8 section adjoints
            # (``bound.k8_extra``): an imperfect lobe, a refraction
            if has_imperfect:
                imperfect = cont & spec & (row[:, 6] > 0.0)
                _tally("imperfect", lambda: imperfect)
            if has_glass:
                _tally("refraction", lambda: cont & took_refract)
            if sc.rr and d >= 3:
                nt = [thr_acc[k] * thr[k] for k in range(3)]
                p_srv = torch.clamp(
                    torch.maximum(nt[0], torch.maximum(nt[1], nt[2])),
                    0.05, 1.0)
                survive = _u(it, pix, dep, Draw.RR, ox) < p_srv
                cont = cont & survive
                with _needed(lanes=survive):
                    boost = torch.where(survive, torch.reciprocal(p_srv),
                                        1.0)
                    thr = [t * boost for t in thr]
            with _needed(lanes=cont):
                ox, oy, oz = (torch.where(cont, op[k], v)
                              for k, v in enumerate((ox, oy, oz)))
                dx, dy, dz = (torch.where(cont, ndir[k], v)
                              for k, v in enumerate((dx, dy, dz)))
                thr_acc = [torch.where(cont, thr_acc[k] * thr[k],
                                       thr_acc[k]) for k in range(3)]
        emit_ok = ~took_diffuse
        live = cont
    return rad


def _scene(tables, walk, rr, dtype):
    """What :func:`_init_state` and :func:`_bounces` read of the tables,
    the small ones as rows of 0-d tensors (which carry the graph of a
    table that requires grad), in ``dtype``."""
    glass, imperfect, dof = tables["features"]
    mesh = None
    if tables["bvh_meta"]:
        nodes = tables["nodes"]
        links = tuple(nodes[:, k].to(torch.int64) for k in (6, 7, 8))
        mesh = (tables["tri"].to(dtype), nodes.to(dtype), tables["bvh_meta"],
                walk, links)
    lights = tables["lights"]
    return SimpleNamespace(
        cam=tables["cam"].to(dtype).reshape(-1).unbind(),
        mats=tables["mats"].to(dtype),
        gmat_t=tables["gmat"].to(dtype),
        gmat=[row.unbind() for row in tables["gmat"].to(dtype)],
        lights=([row.unbind() for row in lights.to(dtype)]
                if lights is not None else None),
        geom_types=tuple(tables["geom_types"]), mesh=mesh, rr=rr, dtype=dtype,
        has_glass=glass, has_imperfect=imperfect, has_dof=dof)


def trace_paths(tables, its, pixels, walk="frontier", rr=False,
                dtype=torch.float32, block=1 << 21):
    """One path for each (iteration, pixel) pair of ``its`` and ``pixels``
    (int64 tensors of one length, the iterations taken modulo 2^32), on
    the device of the tables, in blocks of ``block`` paths.  Returns (rad
    (N, 3) in ``dtype``, counts (depth,) int64: the paths live entering
    each bounce, summed over the pairs)."""
    sc = _scene(tables, walk, rr, dtype)
    device = tables["cam"].device
    width, height, depth = tables["width"], tables["height"], tables["depth"]
    its = torch.as_tensor(its, dtype=torch.int64).to(device) & 0xFFFFFFFF
    pixels = torch.as_tensor(pixels, dtype=torch.int64).to(device)
    counts = torch.zeros(depth, dtype=torch.int64, device=device)
    out = []
    for b0 in range(0, pixels.numel(), block):
        it, pix = its[b0:b0 + block], pixels[b0:b0 + block]
        rad = _bounces(sc, _init_state(sc, it, pix, width, height), it, pix,
                       depth, counts)
        out.append(torch.stack(rad, dim=-1))
    return torch.cat(out), counts


def trace(tables, it0, n_spp, pixels=None, walk="frontier", rr=False,
          per_sample=False, dtype=torch.float32):
    """``n_spp`` samples from iteration ``it0`` of the pixels ``pixels``
    (global ids; None: the whole image), sample by sample as the
    program's plain version runs them.  Returns (rad (N, 3) summed over
    the samples, counts (n_spp, depth) with ``per_sample``, else summed
    over the samples, (depth,))."""
    sc = _scene(tables, walk, rr, dtype)
    device = tables["cam"].device
    width, height, depth = tables["width"], tables["height"], tables["depth"]
    pixel = (torch.arange(width * height, dtype=torch.int64, device=device)
             if pixels is None else pixels.to(device=device,
                                              dtype=torch.int64))
    acc = [torch.zeros(pixel.shape, device=device, dtype=dtype)
           for _ in range(3)]
    counts = torch.zeros((n_spp, depth), dtype=torch.int64, device=device)
    for s in range(n_spp):
        it = (it0 + s) & 0xFFFFFFFF
        rad = _bounces(sc, _init_state(sc, it, pixel, width, height), it,
                       pixel, depth, counts[s])
        acc = [a + r for a, r in zip(acc, rad)]
    return (torch.stack(acc, dim=-1),
            counts if per_sample else counts.sum(0))
