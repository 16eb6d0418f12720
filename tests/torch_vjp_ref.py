"""What the tests of K8's sections share: their rigs and the reference's
gradients.

A rig is a shipped scene file, edited by the variants of
``pathtrace_tpu_torch.scene.variants`` (and the tests' own), cut to some of
its objects (:func:`keep_objects`, which keeps the reference's compile
short: it unrolls every geom at every bounce) and to a small size.
:func:`reference_case` gives the reference's gradient of ``sum(ct *
radiance)``: ``jax.vjp`` of its planes engine
(``render/plane_engine._batch_jit_planes``, the megakernel's own trace
under XLA, with ``bvh_grad=True`` on meshes), at a random cotangent that
is zero where the port's forward and the reference's differ by 1e-4 or
more (a hit or a lobe that flips), as ``tests/test_torch_vjp.py`` masks
them.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np

import pathtrace_tpu as pt
from pathtrace_tpu.ops.pallas.megakernel import _scene_features
from pathtrace_tpu.render import diff as JD
from pathtrace_tpu.render.plane_engine import _batch_jit_planes
from pathtrace_tpu_torch import convert
from pathtrace_tpu_torch.ops.cuda import megakernel as K
from pathtrace_tpu_torch.ops.cuda import vjp as VJ

from test_torch_vjp import ATOL, RTOL, grad_groups, masked_ct
from torch_scenes import REPO, scene_text


def keep_objects(text, keep):
    """Scene ``text`` with only the objects of indices ``keep`` (in that
    order), renumbered from 0."""
    head, *blocks = re.split(r"(?m)^(?=OBJECT \d+\n)", text)
    out = [head]
    for new, old in enumerate(keep):
        out.append(re.sub(r"^OBJECT \d+", f"OBJECT {new}", blocks[old]))
    return "".join(out).rstrip("\n") + "\n"


def rig(name, edits=(), keep=None, res=(16, 16), depth=4):
    """(the reference's scene, the port's) of scene file ``name`` with the
    text replacements ``edits``, cut to the objects ``keep`` (all: None),
    at ``res`` and ``depth``."""
    text = scene_text(name, edits)
    if keep is not None:
        text = keep_objects(text, keep)
    # the OBJ paths of the mesh files are relative to scenes/
    text = text.replace("mesh icosahedron.obj",
                        f"mesh {REPO}/scenes/icosahedron.obj")
    js = dataclasses.replace(pt.parse_scene(text), resolution=res,
                             trace_depth=depth)
    return js, convert.from_jax_scene(js)


def reference_case(js, scene, nee):
    """(ct, the reference's gradients as ``grad_groups``) on the rig."""
    feat = _scene_features(js)

    def fwd(params):
        rad, _ = _batch_jit_planes(JD.merge_params(js, params), 1, 1, feat,
                                   nee, False, (), (), (), bvh_grad=True)
        return rad

    rad_ref, vjp_fn = jax.vjp(fwd, JD.split_params(js))
    rad, _ = K.trace_plain(**K.prepare(scene, "cpu", nee=nee), it0=1,
                           n_spp=1)
    ct = masked_ct(rad_ref, rad.numpy())
    (gref,) = vjp_fn(jnp.asarray(ct))
    return ct, grad_groups(gref)


def assert_matches(scene, nee, ct, want, rtol=RTOL, atol=ATOL):
    """``render_vjp(device="cpu")`` of the rig: every parameter group the
    reference gives, finite and within ``rtol`` / ``atol`` of it (the
    reference's own tolerance by default); ``tri_verts`` None on a mesh."""
    _, g = VJ.render_vjp(scene, ct, 1, 1, nee=nee, device="cpu")
    got = grad_groups(g)
    if scene.mesh.count:
        # the triangles are constants of the sweep (the reference's
        # render_vjp_pallas gives None too)
        assert g["tri_verts"] is None
        want = {k: v for k, v in want.items() if k != "tri_verts"}
    assert set(got) == set(want)
    for name in sorted(want):
        if want[name].size == 0:
            continue
        assert np.isfinite(got[name]).all(), name
        np.testing.assert_allclose(got[name], want[name], rtol=rtol,
                                   atol=atol, err_msg=name)
