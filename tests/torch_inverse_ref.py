"""The inverse-rendering loop, reference against port, on the CPU.

    JAX_PLATFORMS=cpu python3 tests/torch_inverse_ref.py [RES SPP DEPTH STEPS]

On cornell.txt at RES x RES (default 200, the reference example's), SPP
samples (8), depth DEPTH (8), with NEE, the loop of
``examples/inverse_light.py``: the target render, the ceiling light moved
by (1.5, 0, 1.0), then STEPS (5) steps along the gradient of the image's
mean squared error (lr 150, each step capped at 0.3).  The reference's
side renders and differentiates with its planes engine
(``render/plane_engine._batch_jit_planes`` under ``jax.grad``, the
megakernel's own trace under XLA); the port's runs
``render/inverse.inverse_light(..., device="cpu")`` (K8's plain version).
Prints the light's first gradient from both on the reference's first
cotangent, and each loop's max-norm position error after every step.
About ten minutes at the default size.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import pathtrace_tpu as pt  # noqa: E402
from pathtrace_tpu.ops.pallas.megakernel import _scene_features  # noqa: E402
from pathtrace_tpu.render import diff as JD  # noqa: E402
from pathtrace_tpu.render.plane_engine import _batch_jit_planes  # noqa: E402
from pathtrace_tpu_torch import convert  # noqa: E402
from pathtrace_tpu_torch.ops.cuda import vjp  # noqa: E402
from pathtrace_tpu_torch.render.inverse import inverse_light  # noqa: E402

LIGHT, OFFSET, LR, MAX_STEP = 0, (1.5, 0.0, 1.0), 150.0, 0.3


def step(g):
    upd = LR * np.asarray(g, np.float64)
    norm = np.linalg.norm(upd)
    return -(upd * (MAX_STEP / norm) if norm > MAX_STEP else upd)


def reference_loop(js, spp, steps):
    """The example's loop on the reference's planes engine: (the errors
    of the start and of each step, the first cotangent, the first
    gradient of the light)."""
    feat = _scene_features(js)
    n_pix = js.pixel_count

    def render(params):
        rad, _ = _batch_jit_planes(JD.merge_params(js, params), 1, spp,
                                   feat, True, False, (), (), (),
                                   bvh_grad=True)
        return rad

    fwd = jax.jit(render)
    grad = jax.jit(jax.grad(lambda p, ct: jnp.sum(ct * render(p))))
    params = JD.split_params(js)
    true_pos = np.asarray(params["translation"])[LIGHT].copy()
    target = np.asarray(fwd(params)) / spp
    tr = np.asarray(params["translation"]).copy()
    tr[LIGHT] += np.asarray(OFFSET, np.float32)
    errors = [float(np.abs(tr[LIGHT] - true_pos).max())]
    first = None
    for _ in range(steps):
        params = dict(params, translation=jnp.asarray(tr))
        img = np.asarray(fwd(params)) / spp
        ct = ((img - target) * (2.0 / (n_pix * 3 * spp))).astype(np.float32)
        g = np.asarray(grad(params, jnp.asarray(ct))["translation"])[LIGHT]
        if first is None:
            first = (ct, g, tr.copy())
        tr = tr.copy()
        tr[LIGHT] = (tr[LIGHT] + step(g)).astype(np.float32)
        errors.append(float(np.abs(tr[LIGHT] - true_pos).max()))
    return errors, first


def main(argv):
    res, spp, depth, steps = ((int(a) for a in argv) if argv
                              else (200, 8, 8, 5))
    js = dataclasses.replace(pt.load_scene(f"{REPO}/scenes/cornell.txt"),
                             resolution=(res, res), trace_depth=depth)
    ref_errors, (ct, g_ref, tr) = reference_loop(js, spp, steps)
    cur = dataclasses.replace(js, geoms=dataclasses.replace(
        js.geoms, translation=tr))
    _, g = vjp.render_vjp(convert.from_jax_scene(cur), ct, 1, spp, nee=True,
                          device="cpu")
    g_port = g["translation"][LIGHT].numpy()
    print(f"cornell {res}x{res} d{depth} {spp}spp NEE, light moved by "
          f"{OFFSET}: d loss / d translation of the light: reference "
          f"{g_ref.tolist()}, port {g_port.tolist()}; first step: reference "
          f"{step(g_ref).tolist()}, port {step(g_port).tolist()}", flush=True)
    print(f"position errors, start and {steps} steps: reference {ref_errors}",
          flush=True)
    port_errors = inverse_light(convert.from_jax_scene(js), steps=steps,
                                spp=spp, device="cpu")
    print(f"position errors, start and {steps} steps: port {port_errors}",
          flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
