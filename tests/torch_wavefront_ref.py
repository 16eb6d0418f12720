"""The wavefront on one configuration through the reference and the port.

``run(name)`` renders ``CASES[name]`` at 32x32, depth 4, 2 samples a
pixel (iterations 1 and 2) with the reference's
``pathtrace_tpu.pathtrace_batch`` (its wavefront, jitted on the CPU),
the reference's numpy oracle of the same integrator
(``reference_oracle.oracle_iteration``), and the port's
``render/integrator.pathtrace_batch`` with ``compaction="mask"`` and
``"sort"`` and ``megakernel.trace_plain`` on the CPU, once a process.

The bounds.  Against the oracle and ``trace_plain``, the tie bound:
under 0.5% of pixels off by more than 1e-3, bounce 0's count exact and
the others within 0.5%.  Against the reference's jitted wavefront, the
bounds the reference holds that wavefront to against its own oracle:
0.5% of pixels (1% with NEE, ``tests/test_nee.py:161``) and counts within
2% (``tests/test_integrator.py:25``).  On the CPU XLA contracts mul-adds
into FMAs, and on cornell's walls, 0.01 thick, the hit point's 1e-4
object-space back-off is 1e-6 in the world, about 2 ulps at the wall's
coordinate of 5: a rounding moves the point into the wall and its next
ray hits the wall itself (seen on cornell with NEE: the jitted shadow
ray meets the back wall at 1e-6, the oracle's and the port's reach the
light).  The port agrees with the oracle there.
"""

import dataclasses
import functools
import os

import numpy as np

import pathtrace_tpu as pt
from pathtrace_tpu.reference_oracle import oracle_iteration
from pathtrace_tpu.scene.parser import parse_scene
from pathtrace_tpu_torch import convert
from pathtrace_tpu_torch.ops.cuda import megakernel as K
from pathtrace_tpu_torch.render import integrator as I

import torch_scenes as S

RES, DEPTH, SPP = (32, 32), 4, 2
TIE_SHARE = 0.005
COUNT_RTOL = 0.005
# name -> (scene file, text edits of scene/variants, nee, rr)
CASES = {
    "cornell": ("cornell", (), False, False),
    "cornell-nee": ("cornell", (), True, False),
    "sphere": ("sphere", (), False, False),
    "sphere-nee": ("sphere", (), True, False),
    "cornell_glass": ("cornell_glass", (), False, False),
    "cornell_glass-nee": ("cornell_glass", (), True, False),
    "cornell_mesh": ("cornell_mesh", (), False, False),
    "cornell_mesh-nee": ("cornell_mesh", (), True, False),
    "cornell-rr": ("cornell", (), False, True),
    "bump": ("cornell_glass", (S.BUMP,), False, False),
    "sss": ("cornell_glass", (S.SSS,), False, False),
    "cornell_checker": ("cornell_checker", (), False, False),
    "mesh_glass_checker_motion": ("cornell_mesh",
                                  (S.MESH_GLASS, S.MESH_MOTION), False,
                                  False),
    "cornell_tex": ("cornell_tex", (), False, False),
}


def jax_scene(name):
    scene, edits, _, _ = CASES[name]
    js = parse_scene(S.scene_text(scene, edits),
                     base_dir=os.path.join(S.REPO, "scenes"))
    return dataclasses.replace(js, resolution=RES, trace_depth=DEPTH)


@functools.lru_cache(maxsize=None)
def run(name):
    """{engine: (radiance (P,3) numpy, counts (SPP, DEPTH) numpy)} for
    "reference", "oracle", "mask", "sort" and "plain"."""
    _, _, nee, rr = CASES[name]
    js = jax_scene(name)
    out = {}
    rad, counts = pt.pathtrace_batch(js, 1, SPP, nee=nee, rr=rr)
    out["reference"] = np.asarray(rad), np.asarray(counts)
    its = [oracle_iteration(js, i, nee=nee, rr=rr) for i in range(1, SPP + 1)]
    out["oracle"] = (sum(np.asarray(r, np.float32) for r, _ in its),
                     np.stack([np.asarray(c) for _, c in its]))
    scene = convert.from_jax_scene(js)
    for compaction in ("mask", "sort"):
        rad, counts = I.pathtrace_batch(scene, 1, SPP, compaction, nee=nee,
                                        rr=rr, device="cpu")
        out[compaction] = rad.numpy(), counts.numpy()
    rad, counts = K.trace_plain(**K.prepare(scene, "cpu", nee=nee, rr=rr),
                                it0=1, n_spp=SPP, per_sample=True)
    out["plain"] = rad.numpy(), counts.numpy()
    return out


def hold(got, want, share, count_rtol):
    """``got`` against ``want`` ((radiance, counts) each): under
    ``share`` of pixels off by more than 1e-3, bounce 0 counting every
    pixel in both, the other bounces within ``count_rtol``."""
    d = np.abs(got[0] - want[0]).max(axis=-1)
    assert (d > 1e-3).mean() < share, (d > 1e-3).mean()
    n_pix = RES[0] * RES[1]
    assert (got[1][:, 0] == n_pix).all() and (want[1][:, 0] == n_pix).all()
    np.testing.assert_allclose(got[1].astype(np.float64),
                               want[1].astype(np.float64), rtol=count_rtol,
                               atol=0)


def check(name, against):
    """The port's mask run held against ``against``'s, with the bound
    of the module's docstring."""
    out = run(name)
    if against == "reference":
        share = 0.01 if CASES[name][2] else TIE_SHARE
        hold(out["mask"], out["reference"], share, 0.02)
    else:
        hold(out["mask"], out[against], TIE_SHARE, COUNT_RTOL)


def check_sort(name):
    """``compaction="sort"`` bit-equal to ``"mask"``, image and counts."""
    out = run(name)
    np.testing.assert_array_equal(out["sort"][0], out["mask"][0])
    np.testing.assert_array_equal(out["sort"][1], out["mask"][1])
    assert out["mask"][1].dtype == np.int64
