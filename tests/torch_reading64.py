#!/usr/bin/env python3
"""Where the port's K8 gradients part from the reference's on a rig: float32
rounding or a fault?  A reading in float64.

    JAX_PLATFORMS=cpu python tests/torch_reading64.py bump|mesh-bump|sss

On the NEE rig of ``tests/test_torch_vjp_bump.py`` (``bump``),
``tests/test_torch_vjp_meshsec.py`` (``mesh-bump``) or
``tests/test_torch_vjp_sss.py`` (``sss``), the reference's planes engine
(``render/plane_engine._run_planes``) and the port's plain version
(``megakernel.trace_plain``) run on the same packed tables (the
reference's ``_pack_scene``/``_pack_lights`` in float32) four times: each
in float32, and each in float64 on the same tables cast up (the reference
under ``jax_enable_x64`` with ``jnp.float32`` read as float64, its
constants still rounded to float32 as the port's are, in a process of its
own; the port's draws in float64 too).  One cotangent, random, zero on the pixels where any
two of the four forwards differ by 1e-4 or more (a hit or a lobe that
flips), gives the gradient of sum(ct * rad) with respect to every table in
each reading.  Printed per table: the largest entry, and the largest
difference between the two float32 readings, between the two float64
readings, and of each float32 reading from its float64 one.  If the
float64 readings agree where the float32 ones part, the gap is float32
rounding (XLA's CPU build contracts multiply-adds into FMAs; the port
rounds each product), which the rig's sections magnify.  Takes a few
minutes, the two reference processes running at once.
"""

import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
NAMES = ("cam", "mats", "gmat", "lights")


# rig: (test module, key of its RIGS)
RIGS = {"bump": ("test_torch_vjp_bump", "bump"),
        "mesh-bump": ("test_torch_vjp_meshsec", "bump-nee"),
        "sss": ("test_torch_vjp_sss", True)}


def rig(name):
    """(the reference's scene, the port's) of rig ``name``."""
    import importlib

    sys.path[:0] = [REPO, HERE]
    module, key = RIGS[name]
    return importlib.import_module(module).RIGS[key]()


def _save(path, **arrays):
    """np.savez to ``path`` through a private name, so that a reader never
    sees half a file."""
    tmp = path + ".part.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def _wait(path, procs=()):
    while not os.path.exists(path):
        time.sleep(0.5)
        if any(p.poll() for p in procs):
            raise RuntimeError("a reference process failed")


class _Float32As64:
    """What ``jnp.float32`` reads as in the reference's float64 reading: a
    float64 dtype, and as a function a constant rounded to float32 (the
    port's ``_c32`` constants) held in float64, or an array cast to
    float64."""

    dtype = np.dtype(np.float64)

    def __new__(cls, x=0.0):
        import jax.numpy as jnp

        if isinstance(x, (int, float, np.integer, np.floating)):
            return jnp.float64(np.float32(x))
        return jnp.asarray(x, dtype=jnp.float64)


def reference(mode, name, work):
    """The reference's reading in a process of its own: ``mode`` "32" or
    "64".  Writes the tables (32) and the radiance, waits for the
    cotangent, writes the gradients."""
    import jax
    import jax.numpy as jnp

    if mode == "64":
        jax.config.update("jax_enable_x64", True)
    from pathtrace_tpu.ops.pallas import megakernel as mk
    from pathtrace_tpu.ops.pallas.megakernel import _scene_features
    from pathtrace_tpu.render.plane_engine import _run_planes

    js, _ = rig(name)
    nee_lights = mk._pack_lights(js)[1]
    if mode == "32":
        cam, mats, gmat, tri, nodes = mk._pack_scene(js)
        lights, _ = mk._pack_lights(js)
        mesh_tabs = {} if tri is None else dict(tri=tri, nodes=nodes)
        _save(os.path.join(work, "tables.npz"), cam=cam, mats=mats,
              gmat=gmat, lights=lights, **mesh_tabs)
    else:
        _wait(os.path.join(work, "tables.npz"))
        jnp.float32 = _Float32As64
    dtype = np.float64 if mode == "64" else np.float32
    with np.load(os.path.join(work, "tables.npz")) as f:
        tables = [jnp.asarray(f[n].astype(dtype)) for n in NAMES]
        tri, nodes = ((jnp.asarray(f["tri"].astype(dtype)),
                       jnp.asarray(f["nodes"].astype(dtype)))
                      if "tri" in f else (None, None))

    def fwd(cam, mats, gmat, lights):
        return _run_planes(cam, mats, gmat, tri, lights, 1,
                           tuple(js.resolution), int(js.trace_depth),
                           tuple(js.geoms.type), 1, _scene_features(js),
                           nee_lights, nodes=nodes, bvh_meta=js.mesh.bvh_meta,
                           bvh_grad=True)[0]

    rad, vjp_fn = jax.vjp(fwd, *tables)
    _save(os.path.join(work, f"rad{mode}.npz"), rad=np.asarray(rad))
    _wait(os.path.join(work, "ct.npz"))
    with np.load(os.path.join(work, "ct.npz")) as f:
        ct = f["ct"].astype(np.asarray(rad).dtype)
    grads = vjp_fn(jnp.asarray(ct))
    _save(os.path.join(work, f"grads{mode}.npz"),
          **{n: np.asarray(g) for n, g in zip(NAMES, grads)})


def port(tables, mesh_tabs, dtype, scene, ct=None):
    """The port's plain version on ``tables`` and the mesh tables
    ``mesh_tabs`` (tri, nodes; None) in ``dtype``: (rad, the gradients of
    sum(ct * rad), or None without ``ct``)."""
    import torch
    from pathtrace_tpu_torch.core import rng
    from pathtrace_tpu_torch.ops.cuda import megakernel as K

    if dtype == torch.float64 and not hasattr(rng, "_uniform32"):
        # the draws in float64 too (the same values: 24-bit integers over
        # 2^24), as the reference's under jax_enable_x64, so that nothing
        # computed from them rounds to float32
        rng._uniform32 = rng.uniform
        rng.uniform = lambda *a, **k: rng._uniform32(*a, **k).double()
    elif dtype == torch.float32 and hasattr(rng, "_uniform32"):
        rng.uniform = rng._uniform32
        del rng._uniform32
    leaf = [torch.tensor(t, dtype=dtype, requires_grad=True) for t in tables]
    tri, nodes = (None, None) if mesh_tabs is None else (
        torch.tensor(t, dtype=dtype) for t in mesh_tabs)
    meta = scene.mesh.bvh_meta
    width, height = scene.resolution
    rad, _ = K.trace_plain(*leaf[:3], tuple(scene.geoms.type), width, height,
                           int(scene.trace_depth), 1, 1,
                           features=K.scene_features(scene), lights=leaf[3],
                           tri=tri, nodes=nodes, bvh_meta=meta)
    if ct is None:
        return rad.detach().numpy(), None
    rad.backward(torch.as_tensor(ct, dtype=dtype))
    return rad.detach().numpy(), [t.grad.numpy() for t in leaf]


def main():
    if len(sys.argv) > 1 and sys.argv[1] == "--reference":
        reference(sys.argv[2], sys.argv[3], sys.argv[4])
        return 0
    import torch

    name = sys.argv[1] if len(sys.argv) > 1 else "bump"
    _, scene = rig(name)
    print(f"rig {name}: {scene.resolution} d{scene.trace_depth}, NEE",
          flush=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   PYTHONPATH=REPO + os.pathsep + os.environ.get(
                       "PYTHONPATH", ""))
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--reference", mode,
             name, work], env=env) for mode in ("32", "64")]
        _wait(os.path.join(work, "tables.npz"), procs)
        with np.load(os.path.join(work, "tables.npz")) as f:
            tables = [f[n] for n in NAMES]
            mesh_tabs = (f["tri"], f["nodes"]) if "tri" in f else None
        dtypes = (("32", torch.float32), ("64", torch.float64))
        rads = {f"port{b}": port(tables, mesh_tabs, t, scene)[0]
                for b, t in dtypes}
        for mode in ("32", "64"):
            _wait(os.path.join(work, f"rad{mode}.npz"), procs)
            with np.load(os.path.join(work, f"rad{mode}.npz")) as f:
                rads[f"ref{mode}"] = f["rad"]
        vals = [r.astype(np.float64) for r in rads.values()]
        agree = np.ones(vals[0].shape[0], bool)
        for a in vals:
            for b in vals:
                agree &= np.abs(a - b).max(-1) < 1e-4
        ct = np.where(agree[:, None],
                      np.random.RandomState(0).rand(agree.shape[0], 3), 0.0)
        _save(os.path.join(work, "ct.npz"), ct=ct)
        print(f"forwards: {agree.mean():.4f} of the pixels within 1e-4 in "
              f"all four readings; float32 forwards bit-equal on "
              f"{(rads['ref32'] == rads['port32']).all(-1).mean():.4f}, "
              f"max |ref32 - port32| "
              f"{np.abs(rads['ref32'] - rads['port32']).max():.3g}, max "
              f"|ref64 - port64| "
              f"{np.abs(rads['ref64'] - rads['port64']).max():.3g}",
              flush=True)
        grads = {f"port{b}": port(tables, mesh_tabs, t, scene, ct)[1]
                 for b, t in dtypes}
        for mode in ("32", "64"):
            _wait(os.path.join(work, f"grads{mode}.npz"), procs)
            with np.load(os.path.join(work, f"grads{mode}.npz")) as f:
                grads[f"ref{mode}"] = [f[n] for n in NAMES]
        for p in procs:
            if p.wait():
                raise RuntimeError("a reference process failed")
    for i, table in enumerate(NAMES):
        g = {k: v[i].astype(np.float64) for k, v in grads.items()}

        def gap(a, b):
            return np.abs(g[a] - g[b]).max()

        print(f"{table}: max |g| {np.abs(g['ref64']).max():.6g}; float32 "
              f"reference - port {gap('ref32', 'port32'):.6g}; float64 "
              f"reference - port {gap('ref64', 'port64'):.6g}; float32 - "
              f"float64: reference {gap('ref32', 'ref64'):.6g}, port "
              f"{gap('port32', 'port64'):.6g}", flush=True)
    print(f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
