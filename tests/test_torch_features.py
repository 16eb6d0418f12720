"""K1's feature sections in the plain PyTorch version, against the
reference's own tracer.

Glass, imperfect specular, depth of field, motion blur, checker, bump,
subsurface scattering and Russian roulette.  The port's packed tables,
handed over as numpy, go through ``trace_plain`` and through the
reference's ``_make_tracer``: here under XLA (``_run_planes``, 32x32,
depth 4, 2 spp); in ``test_torch_interpret.py`` in the Pallas kernel's
interpret mode.  Bound, as in ``tests/test_torch_megakernel.py``: under
0.5% of pixels may differ by more than 1e-3 (a last-bit change at an edge
flips a whole path), the live counts agree within rtol 0.02, and bounce
0 counts every pixel exactly.  NEE (K2) is in ``test_torch_lights.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtrace_tpu.ops.pallas.megakernel import _run
from pathtrace_tpu.render.plane_engine import _run_planes
from pathtrace_tpu_torch.ops.cuda import megakernel as K
from test_torch_megakernel import assert_tie_flip_bound
import torch_scenes as S

_planes = jax.jit(_run_planes, static_argnames=(
    "resolution", "trace_depth", "geom_types", "n_spp", "features",
    "nee_lights", "bvh_meta", "rr_mode", "tex_geom", "btex_geom"))


def texel_tables(texels, packed):
    """The port's texel words in the reference's layouts: per channel a
    (rows, 128) float32 table of k/255 (``_pack_textures``, the planes
    engine), or with ``packed`` an int32 table of four u8 texels a word
    (the kernel's)."""
    w = texels.numpy().astype(np.int64)
    out = []
    for c in range(3):
        q = (w >> (8 * c)) & 255
        if packed:
            q = np.concatenate([q, np.zeros(-len(q) % 4, np.int64)])
            q = q.reshape(-1, 4)
            q = q[:, 0] | (q[:, 1] << 8) | (q[:, 2] << 16) | (q[:, 3] << 24)
            q = q.astype(np.uint32).view(np.int32)
        else:
            q = q.astype(np.float32) / np.float32(255.0)
        out.append(np.concatenate([q, np.zeros(-len(q) % 128, q.dtype)])
                   .reshape(-1, 128))
    return tuple(out)


def reference(job, n_spp, interpret=False):
    """The reference's tracer on the port's tables: (rad, counts)."""
    lights = job["lights"]
    statics = () if lights is None else tuple(
        (int(r[0]), int(r[1])) for r in lights.tolist())

    def np_or_none(t):
        return None if t is None else t.numpy()

    args = (job["cam"].numpy(), job["mats"].numpy(), job["gmat"].numpy(),
            np_or_none(job["tri"]), np_or_none(lights),
            jnp.asarray(1, jnp.int32))
    res = (job["width"], job["height"])
    mesh = dict(nodes=np_or_none(job["nodes"]), bvh_meta=job["bvh_meta"])
    if job.get("texels") is not None:
        mesh.update(tex_geom=job["tex_geom"], btex_geom=job["btex_geom"],
                    texs=texel_tables(job["texels"], interpret))
    if interpret:
        out = _run(*args, res, job["depth"], job["geom_types"],
                   interpret=True, n_spp=n_spp, features=job["features"],
                   nee_lights=statics, rr_mode=job["rr"], **mesh)
    else:
        out = _planes(*args, resolution=res, trace_depth=job["depth"],
                      geom_types=job["geom_types"], n_spp=n_spp,
                      features=job["features"], nee_lights=statics,
                      rr_mode=job["rr"], **mesh)
    return tuple(np.asarray(x) for x in out)


def check_against_reference(config, res, depth, n_spp, interpret=False):
    """trace_plain against the reference on ``config``'s tables; returns
    the share of bit-equal pixels."""
    job = S.job(config, res, depth)
    rad, counts = K.trace_plain(**job, it0=1, n_spp=n_spp)
    assert rad.shape == (res[0] * res[1], 3) and rad.dtype == torch.float32
    assert bool(torch.isfinite(rad).all())
    assert int(counts[0]) == n_spp * res[0] * res[1]
    ref_rad, ref_counts = reference(job, n_spp, interpret)
    assert int(ref_counts[0]) == int(counts[0])
    assert_tie_flip_bound(rad, ref_rad, counts, ref_counts)
    share = float((rad.numpy() == ref_rad).all(axis=-1).mean())
    print(f"{config} {res[0]}x{res[1]} d{depth} {n_spp}spp "
          f"{'interpret' if interpret else 'planes'}: bit-equal share "
          f"{share:.4f}, max abs diff {np.abs(rad.numpy() - ref_rad).max():.3g}")
    return share


@pytest.mark.parametrize("config", [
    "cornell-rr", "cornell_glass", "cornell_checker", "bump", "sss"])
def test_trace_plain_matches_planes(config):
    check_against_reference(config, (32, 32), 4, 2)


@pytest.mark.parametrize("config,section", [
    ("bump", "bump"), ("sss", "subsurface scattering"),
    ("cornell_checker", "checker"), ("cornell_checker", "motion blur"),
    ("cornell_glass", "glass"), ("cornell_glass", "depth of field"),
    ("cornell_glass", "imperfect specular"),
])
def test_each_section_changes_the_render(config, section):
    # the configurations above exercise every section: with it off, the
    # same tables render differently (with NEE, so that every surface hit
    # adds light)
    job = S.job(config, (32, 32), 5)
    job = K.Job(**dict(job, lights=K.pack_lights(
        S.load(*S.CONFIGS[config][:2]), "cpu")[0]))
    i = K.FEATURE_NAMES.index(section)
    assert job["features"][i]
    off = dict(job, features=tuple(f and k != i
                                   for k, f in enumerate(job["features"])))
    on_rad, _ = K.trace_plain(**job, it0=1, n_spp=1)
    off_rad, _ = K.trace_plain(**off, it0=1, n_spp=1)
    changed = (on_rad - off_rad).abs().amax(-1) > 1e-3
    assert int(changed.sum()) >= 4, int(changed.sum())


def test_russian_roulette_changes_the_render():
    job = S.job("cornell-rr", (32, 32), 5)
    on_rad, on_counts = K.trace_plain(**job, it0=1, n_spp=2)
    off_rad, off_counts = K.trace_plain(**dict(job, rr=False), it0=1, n_spp=2)
    assert not torch.equal(on_rad, off_rad)
    # roulette starts at bounce 3 and only ends paths
    assert torch.equal(on_counts[:4], off_counts[:4])
    assert int(on_counts[4]) < int(off_counts[4])


def test_feature_mask():
    assert K.feature_mask(K.NO_FEATURES, False, False) == 0
    assert K.feature_mask((True,) + (False,) * 6, False, False) == 1
    assert K.feature_mask((False,) * 6 + (True,), True, True) == \
        (1 << 6) | K.NEE_BIT | K.RR_BIT
    masks = {K.feature_mask(S.job(c, (8, 8), 2)["features"],
                            S.CONFIGS[c][2], S.CONFIGS[c][3])
             for c in S.CONFIGS}
    assert len(masks) == 8  # the configurations build 8 kernel variants
