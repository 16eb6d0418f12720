"""The reference's scene and tables, worked out again from a
configuration's own numbers (``benchmark/configs/<name>.json``) and the
OBJ file the benchmark writes for it: the camera basis and its thin lens
(aperture and focal distance), each geom's forward, inverse and
inverse-transpose transforms, the material rows, the NEE light table,
the triangle rows and a median-split BVH with skip links.  The layouts
and the operation order are those the program's plain version reads,
written out here again (float32 on the CPU, explicit mul-adds), so that
the reference rounds as that version does.

A configuration names only what the reference traces
(:func:`check_config`): spheres, cubes and meshes; diffuse, mirror,
imperfect-specular (``specex``), glass (``refr``, ``refrior``) and
emissive materials; a pinhole or thin-lens camera.  Motion blur, checker,
bump, subsurface scattering and image textures are refused with a
``ValueError``, left for a later repair of the reference.

Every table is a function of the geoms' translations, which may require
grad: :func:`pack` then carries their graph into ``gmat`` and ``lights``
(the inverse-light check differentiates through it).
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

PI = 3.1415926535897932384626422832795028841971
TRANSMISSION_PUSH = 5e-4
SPHERE, CUBE, MESH = 0, 1, 2
LIGHT_COLS = 128
LEAF_K = 8          # triangles a BVH leaf holds at most
NODE_COLS = 16      # aabb min (3), max (3), skip, leaf start, leaf count, pad

# the keys a configuration's materials, camera and objects may carry
MATERIAL_KEYS = ("rgb", "specex", "specrgb", "refl", "refr", "refrior",
                 "emittance")
CAMERA_KEYS = ("res", "fovy", "iterations", "depth", "file", "eye", "view",
               "up", "aperture", "focal")   # the lens: both or neither
OBJECT_KEYS = ("shape", "material", "trans", "rotat", "scale")
# the course's features that the reference does not trace yet, by the
# key a configuration would give them
UNTRACED = dict(checker="checker", bump="bump", sss="subsurface scattering",
                motion="motion blur", texture="texture",
                bumptex="bump texture")


@dataclasses.dataclass
class Scene:
    """A configuration's scene: materials and geoms as dicts of floats,
    the camera, and the triangle soup of its MESH geoms (object space)."""

    materials: list
    geoms: list
    camera: dict
    width: int
    height: int
    depth: int
    iterations: int
    tri_verts: np.ndarray   # (T, 3, 3) float32
    tri_geom: np.ndarray    # (T,) int32

    @property
    def pixel_count(self):
        return self.width * self.height

    @property
    def light_indices(self):
        return tuple(i for i, g in enumerate(self.geoms)
                     if self.materials[g["material"]]["emittance"] > 0)

    @property
    def features(self):
        """(has_glass, has_imperfect, has_dof): the static facts the
        tracer specialises its sections on, as the program's
        ``scene_features`` reads them (any material refracts, any has a
        specular exponent, the lens is open)."""
        m = self.materials
        return (any(np.float32(x["refr"]) > 0 for x in m),
                any(np.float32(x["spec_exponent"]) > 0 for x in m),
                bool(np.float32(self.camera["aperture"]) > 0))

    def translations(self):
        """The geoms' translations, (G, 3) float32."""
        return torch.tensor([g["translation"] for g in self.geoms],
                            dtype=torch.float32)


def read_obj(path):
    """The triangles of an OBJ file's ``v`` and ``f`` lines (faces fanned),
    (T, 3, 3) float32."""
    verts, tris = [], []
    with open(path) as f:
        for line in f:
            p = line.split()
            if not p:
                continue
            if p[0] == "v":
                verts.append([float(x) for x in p[1:4]])
            elif p[0] == "f":
                idx = [int(t.split("/")[0]) for t in p[1:]]
                idx = [i - 1 if i > 0 else len(verts) + i for i in idx]
                tris += [(idx[0], idx[k], idx[k + 1])
                         for k in range(1, len(idx) - 1)]
    return np.asarray(verts, np.float32)[np.asarray(tris, np.int64)]


def _check_keys(where, entry, known):
    for key in entry:
        if key in known:
            continue
        if key in UNTRACED:
            raise ValueError(
                f"{where}: {key!r} ({UNTRACED[key]}) is a feature the "
                f"benchmark's reference does not trace")
        raise ValueError(f"{where}: unknown key {key!r}")


def check_config(cfg):
    """Raises ``ValueError`` naming the first key of ``cfg``'s materials,
    camera or objects that the reference does not know: an untraced
    feature (:data:`UNTRACED`) or any other; and a lens with only one of
    its two keys."""
    for i, m in enumerate(cfg["materials"]):
        _check_keys(f"material {i}", m, MATERIAL_KEYS)
    cam = cfg["camera"]
    _check_keys("camera", cam, CAMERA_KEYS)
    if ("aperture" in cam) != ("focal" in cam):
        raise ValueError("camera: 'aperture' and 'focal' come together")
    for i, o in enumerate(cfg["objects"]):
        _check_keys(f"object {i}", o, OBJECT_KEYS + (
            ("obj",) if o.get("shape") == "mesh" else ()))


def scene_from_config(cfg, obj_paths):
    """The :class:`Scene` of configuration ``cfg`` (its JSON as a dict);
    ``obj_paths`` maps each mesh object's index to its OBJ file.  Raises
    ``ValueError`` for a key the reference does not trace
    (:func:`check_config`)."""
    check_config(cfg)
    cam = cfg["camera"]
    mats = [dict(color=m["rgb"], spec_exponent=m["specex"],
                 spec_color=m["specrgb"], refl=m["refl"], refr=m["refr"],
                 ior=m["refrior"], emittance=m["emittance"])
            for m in cfg["materials"]]
    geoms, tv, tg = [], [], []
    for i, o in enumerate(cfg["objects"]):
        kind = {"sphere": SPHERE, "cube": CUBE, "mesh": MESH}[o["shape"]]
        geoms.append(dict(type=kind, material=o["material"],
                          translation=o["trans"], rotation=o["rotat"],
                          scale=o["scale"]))
        if kind == MESH:
            t = read_obj(obj_paths[i])
            tv.append(t)
            tg.append(np.full(t.shape[0], i, np.int32))
    return Scene(
        materials=mats, geoms=geoms,
        camera=dict(eye=cam["eye"], view=cam["view"], up=cam["up"],
                    fovy=cam["fovy"], aperture=cam.get("aperture", 0.0),
                    focal=cam.get("focal", 1.0)),
        width=cam["res"][0], height=cam["res"][1], depth=cam["depth"],
        iterations=cam["iterations"],
        tri_verts=(np.concatenate(tv) if tv
                   else np.zeros((0, 3, 3), np.float32)),
        tri_geom=np.concatenate(tg) if tg else np.zeros(0, np.int32))


# --- vector math, float32, explicit mul-adds ---------------------------------

def _f32(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def _dot(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])[..., None]


def _normalize(v):
    return v / torch.sqrt(_dot(v, v))


def _cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def _mat3_vec(m, v):
    return torch.stack(
        [m[..., i, 0] * v[..., 0] + m[..., i, 1] * v[..., 1]
         + m[..., i, 2] * v[..., 2] for i in range(3)], dim=-1)


def _mat3_mat(a, b):
    return torch.stack([torch.stack(
        [a[..., i, 0] * b[..., 0, j] + a[..., i, 1] * b[..., 1, j]
         + a[..., i, 2] * b[..., 2, j] for j in range(3)], dim=-1)
        for i in range(3)], dim=-2)


def _rot_axis(c, s, axis):
    z, o = torch.zeros_like(c), torch.ones_like(c)
    rows = ([[o, z, z], [z, c, -s], [z, s, c]] if axis == 0 else
            [[c, z, s], [z, o, z], [-s, z, c]] if axis == 1 else
            [[c, -s, z], [s, c, z], [z, z, o]])
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _rotation(deg):
    rad = deg * (PI / 180.0)
    c, s = torch.cos(rad), torch.sin(rad)
    r = _mat3_mat(_rot_axis(c[..., 0], s[..., 0], 0),
                  _rot_axis(c[..., 1], s[..., 1], 1))
    return _mat3_mat(r, _rot_axis(c[..., 2], s[..., 2], 2))


def _homogeneous(m):
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0]).expand(m.shape[:-2] + (1, 4))
    return torch.cat([m, bottom], dim=-2)


def transforms(translation, rotation, scale):
    """``T @ Rx @ Ry @ Rz @ S`` (degrees), its analytic inverse and the
    inverse's transpose, (G, 4, 4) each."""
    rs = _rotation(rotation) * scale[..., None, :]
    fwd = _homogeneous(torch.cat([rs, translation[..., :, None]], dim=-1))
    rt = _rotation(rotation).transpose(-1, -2)
    inv_s = 1.0 / (scale + torch.where(scale >= 0, 1e-12, -1e-12))
    lin = rt * inv_s[..., :, None]
    inv = _homogeneous(torch.cat(
        [lin, -_mat3_vec(lin, translation)[..., :, None]], dim=-1))
    return fwd, inv, inv.transpose(-1, -2)


# --- light tables ------------------------------------------------------------

def _sum3(v):
    return v[0] + v[1] + v[2]


def _cube_light(fwd):
    """Per face (+x, -x, +y, -y, +z, -z) of a transformed unit cube:
    origin, edges b and c, outward unit normal, area."""
    cols = [fwd[:3, j] for j in range(3)]
    trans = fwd[:3, 3]
    out = dict(origin=[], e_b=[], e_c=[], normal=[], area=[])
    for axis in range(3):
        b, c = (axis + 1) % 3, (axis + 2) % 3
        cr = torch.stack([cols[b][1] * cols[c][2] - cols[b][2] * cols[c][1],
                          cols[b][2] * cols[c][0] - cols[b][0] * cols[c][2],
                          cols[b][0] * cols[c][1] - cols[b][1] * cols[c][0]])
        area = torch.sqrt(_sum3(cr * cr))
        for sign in (1.0, -1.0):
            orient = _sum3(cr * cols[axis])
            n = cr * (torch.where(orient >= 0, 1.0, -1.0) * sign)
            n = n / torch.clamp_min(torch.sqrt(_sum3(n * n)), 1e-20)
            out["origin"].append(trans + cols[axis] * (0.5 * sign))
            out["e_b"].append(cols[b])
            out["e_c"].append(cols[c])
            out["normal"].append(n)
            out["area"].append(area)
    return {k: torch.stack(v) for k, v in out.items()}


def _sphere_det3(fwd):
    c0, c1, c2 = (fwd[:3, j] for j in range(3))
    cr = torch.stack([c1[1] * c2[2] - c1[2] * c2[1],
                      c1[2] * c2[0] - c1[0] * c2[2],
                      c1[0] * c2[1] - c1[1] * c2[0]])
    return torch.abs(_sum3(c0 * cr))


# --- the BVH -------------------------------------------------------------------

def _build_one(lo, hi, cent, idx, nodes, order):
    my = len(nodes)
    bmin, bmax = lo[idx].min(axis=0), hi[idx].max(axis=0)
    if len(idx) <= LEAF_K:
        start = len(order)
        order.extend(int(i) for i in idx)
        nodes.append([*bmin, *bmax, 0.0, float(start), float(len(idx))])
    else:
        nodes.append([*bmin, *bmax, 0.0, 0.0, 0.0])
        axis = int(np.argmax(bmax - bmin))
        srt = idx[np.argsort(cent[idx, axis], kind="stable")]
        half = len(srt) // 2
        _build_one(lo, hi, cent, srt[:half], nodes, order)
        _build_one(lo, hi, cent, srt[half:], nodes, order)
    nodes[my][6] = float(len(nodes))  # skip: the first node after the subtree


def build_bvh(tv):
    """A median-split BVH over triangles ``tv`` (t, 3, 3), object space,
    nodes in depth-first pre-order with skip links, leaves of at most
    ``LEAF_K`` triangles: (nodes (N, 16) float32, order (t,) int32, the
    original triangle at each leaf-contiguous row)."""
    lo, hi = tv.min(axis=1), tv.max(axis=1)
    cent = (lo + hi) * 0.5
    nodes, order = [], []
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 64 + 4 * int(np.ceil(np.log2(len(tv) + 1)))))
    try:
        _build_one(lo, hi, cent, np.arange(len(tv)), nodes, order)
    finally:
        sys.setrecursionlimit(old)
    out = np.zeros((len(nodes), NODE_COLS), np.float32)
    out[:, :9] = np.asarray(nodes, np.float32)[:, :9]
    return out, np.asarray(order, np.int32)


# --- the tables ----------------------------------------------------------------

def pack(scene, translation=None, device="cpu", nee=False):
    """The tables the tracer reads, on ``device``: ``cam`` (1,16: eye,
    view, right, up, tan_x, tan_y, aperture, focal),
    ``mats`` (G,24), ``gmat`` (G,40), with ``nee`` ``lights`` (L,128), the
    triangle rows ``tri`` (T,16) and ``nodes`` with ``bvh_meta`` (one
    (geom, node_off, n_nodes, tri_off, n_tris) entry a mesh), and the
    statics.  ``translation`` (G,3), which may require grad, replaces the
    configuration's translations.  ``features`` holds
    :attr:`Scene.features`."""
    w, h = scene.width, scene.height
    c = scene.camera
    view = _normalize(_f32(c["view"]))
    right = _normalize(_cross(view, _f32(c["up"])))
    up = _normalize(_cross(right, view))
    tan_y = torch.tan(_f32(c["fovy"]) * (PI / 180.0))
    tan_x = tan_y * (w / h)
    cam = torch.cat([_f32(c["eye"]), view, right, up,
                     torch.stack([tan_x, tan_y, _f32(c["aperture"]),
                                  _f32(c["focal"])])]
                    ).reshape(1, 16)

    g = scene.geoms
    mats = []
    for geom in g:
        m = scene.materials[geom["material"]]
        row = [*m["color"], *m["spec_color"], m["spec_exponent"], m["refl"],
               m["refr"], m["ior"], m["emittance"]] + [0.0] * 13
        row[18:21] = [1.0, 1.0, 1.0]  # a medium's albedo: none
        mats.append(row)
    mats = _f32(mats)

    t = scene.translations() if translation is None else translation
    t = t.to(device="cpu", dtype=torch.float32)
    r = _f32([x["rotation"] for x in g])
    s = _f32([x["scale"] for x in g])
    fwd, inv, inv_t = transforms(t, r, s)
    n_g = len(g)
    push = TRANSMISSION_PUSH * torch.amax(torch.abs(s), dim=-1)[:, None]
    gmat = torch.cat([fwd[:, :3, :].reshape(-1, 12),
                      inv[:, :3, :].reshape(-1, 12),
                      inv_t[:, :3, :3].reshape(-1, 9),
                      torch.zeros((n_g, 3)), push, torch.zeros((n_g, 3))],
                     dim=1)

    lights = None
    if nee and scene.light_indices:
        rows = []
        for li in scene.light_indices:
            kind = g[li]["type"]
            m = scene.materials[g[li]["material"]]
            row = torch.zeros(LIGHT_COLS)
            row[0], row[1] = float(li), float(kind)
            row[2:5] = _f32(m["color"]) * _f32(m["emittance"])
            if kind == SPHERE:
                row[12:21] = fwd[li][:3, :3].reshape(-1)
                row[21:24] = fwd[li][:3, 3]
                row[24:33] = inv_t[li][:3, :3].reshape(-1)
                row[33] = _sphere_det3(fwd[li])
            else:
                tab = _cube_light(fwd[li])
                area = tab["area"]
                total = area[0]
                for a in area[1:]:
                    total = total + a
                row[5] = total
                row[6:12] = torch.cumsum(area, 0) / torch.clamp_min(total,
                                                                    1e-20)
                row[12:30] = tab["origin"].reshape(-1)
                row[30:48] = tab["e_b"].reshape(-1)
                row[48:66] = tab["e_c"].reshape(-1)
                row[66:84] = tab["normal"].reshape(-1)
            rows.append(row)
        lights = torch.stack(rows).to(device)

    tri = nodes = None
    meta = []
    if len(scene.tri_verts):
        parts_n, parts_o = [], []
        node_off = tri_off = 0
        for gi in range(n_g):
            sel = np.nonzero(scene.tri_geom == gi)[0]
            if not sel.size:
                continue
            nd, order = build_bvh(scene.tri_verts[sel])
            parts_n.append(nd)
            parts_o.append(sel[order])
            meta.append((gi, node_off, nd.shape[0], tri_off, sel.size))
            node_off += nd.shape[0]
            tri_off += sel.size
        tv = torch.as_tensor(scene.tri_verts[np.concatenate(parts_o)])
        v0, e1, e2 = tv[:, 0], tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0]
        n = torch.stack([e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1],
                         e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2],
                         e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]], dim=1)
        norm = n[:, 0] * n[:, 0] + n[:, 1] * n[:, 1] + n[:, 2] * n[:, 2]
        norm = torch.sqrt(norm.double()).float()[:, None]
        n = n / torch.clamp_min(norm, 1e-20)
        tri = torch.cat([v0, e1, e2, n, torch.zeros((tv.shape[0], 4))],
                        dim=1).to(device)
        nodes = torch.as_tensor(np.concatenate(parts_n)).to(device)
    return dict(cam=cam.to(device), mats=mats.to(device),
                gmat=gmat.to(device), lights=lights, tri=tri, nodes=nodes,
                bvh_meta=tuple(meta),
                geom_types=tuple(x["type"] for x in g), width=w, height=h,
                depth=scene.depth, features=scene.features)
