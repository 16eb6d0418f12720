"""pathtrace_tpu_torch — the path tracer on PyTorch and CUDA (NVIDIA Hopper).

The port of ``pathtrace_tpu`` (JAX on a TPU), which stays beside it as
the reference.  Module paths follow the reference's.  Today the port
renders every scene of spheres, cubes and triangle meshes (a BVH per
mesh, built at load time), with every material and camera feature of
the reference, image textures (albedo TEXTURE and BUMPTEX height maps),
NEE and Russian roulette, traced by the hand-written CUDA megakernel K1
(``csrc/megakernel.cu``) on a GPU, or by its plain PyTorch version on the
CPU.  The split and sorted engines (``pathtrace_batch_split``,
``pathtrace_batch_sorted``) trace the same image in spans of bounces on
the span kernel K5, the split engine's tile table on the scan K6
(``prefix_sum``, ``compact_indices``, ``compact``).  The gradients of a
render: ``material_grads`` (the material-gradient kernel K7) and
``render_vjp`` (the reverse sweep K8, chained through the packing to the
parameters of ``split_params``/``merge_params``; meshes through their
BVH winners), and ``render_loss_and_grad``/``render_mean`` with
``engine="planes"`` (autograd over the plain trace, ``tri_verts``
included).  A mesh stripped of its BVH renders on K3-linear, the fold of
every triangle.  The wavefront integrator (``render/integrator.py``,
torch ops on the device, its sort-compaction on the scan K6) gives
:func:`pathtrace_iteration`, ``render.integrator.pathtrace_batch`` (the
CLI's ``--engine xla``), the default ``engine="wavefront"`` of
``render_mean`` and ``render_loss_and_grad`` and
``render_value_and_pixel_grad``; the package's :func:`pathtrace_batch`
and :func:`render` stay on K1.  Texel gradients: a map of
``scene.textures`` swapped for a tensor that requires grad is
differentiated by both engines of ``render_mean`` (the planes engine
reads a float texel table, ``pack_textures_f32``, which also renders a
map off the u8 grid), :func:`planes_iteration` and
:func:`pathtrace_iteration`.  The progressive render: the CLI's
checkpoints, resume, previews and interactive camera
(``utils/checkpoint.py``,
``render/interact.py``, ``tools/watch.py``), ``utils/profiling.py``, and
the inverse loops ``inverse_light``, ``inverse_albedo`` (K1 and K7) and
``inverse_mesh`` (the planes engine) of ``render/inverse.py``.
Multi-device rendering and the sharded grad steps
(``parallel/shard.py``, one process a device on ``torch.distributed``,
the CLI's ``--shard``), and the native host runtime (``native/``: the C++
scene parser, OBJ loader and image writers, which :func:`load_scene` and
``io/image_io.save_png`` use when their library builds).  Every entry
point takes a ``device``, the card by default.
"""

from __future__ import annotations

import torch

from .core import types
from .core.types import Camera, Geoms, Materials, Scene, TriMesh
from .ops.cuda.matgrad import material_grads
from .ops.cuda.megakernel import (
    pack_lights, pack_mesh, pack_scene, pack_textures, pack_textures_f32,
    pathtrace_batch_cuda, prepare, trace_k1,
)
from .ops.cuda.span import pathtrace_batch_sorted, pathtrace_batch_split
from .ops.cuda.vjp import render_vjp
from .ops.scan import compact, compact_indices, prefix_sum
from .render.diff import (
    merge_params, planes_iteration, render_loss_and_grad, render_mean,
    render_value_and_pixel_grad, split_params,
)
from .render.integrator import pathtrace_iteration
from .render.interact import InteractiveSession, apply_camera_motion
from .scene.parser import derived_fov, load_scene, parse_scene
from .utils import checkpoint, profiling

__version__ = "0.1.0"

COMPACTIONS = ("mask", "sort")


def __getattr__(name):
    # render/inverse.py is also ``python -m``'s entry point: importing it
    # here at the package's import would load it twice under runpy
    if name in ("inverse_albedo", "inverse_light", "inverse_mesh"):
        from .render import inverse

        return getattr(inverse, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _check_compaction(compaction):
    if compaction not in COMPACTIONS:
        raise ValueError(f"compaction must be one of {COMPACTIONS}, not "
                         f"{compaction!r}")


def pathtrace_batch(scene, it0, n_iters, compaction="mask", remat=True,
                    nee=False, rr=False, device="cuda"):
    """``n_iters`` samples per pixel starting at iteration ``it0``, with
    next-event estimation if ``nee`` and Russian roulette if ``rr``:
    (accumulated radiance (P,3) f32, live counts (n_iters, depth) int64,
    the paths entering each bounce of each sample), both on ``device``,
    as the reference's (whose counts are int32: the port keeps int64,
    K1's 64-bit global counts).

    The arguments are the reference's ``pathtrace_batch``'s, but K1, the
    port's main path, traces every sample here: ``compaction="sort"``
    gives the image of ``"mask"`` (K1 masks dead lanes, as the
    reference's tiled engines do) and ``remat`` (memory under autodiff)
    changes nothing.  The reference's function, the wavefront, is
    ``render.integrator.pathtrace_batch`` (``--engine xla`` on the CLI),
    whose ``"sort"`` densifies the live rays on K6."""
    _check_compaction(compaction)
    return trace_k1(prepare(scene, device, nee=nee, rr=rr), it0, n_iters,
                    per_sample=True)


def render(scene, n_iters=None, chunk=8, compaction="mask", callback=None,
           nee=False, device="cuda", rr=False):
    """Progressive render to completion, ``chunk`` samples per launch;
    returns the accumulated image (P,3) on ``device`` (divide by
    ``n_iters`` for display).  ``callback(done, accum, counts)`` runs
    after each chunk, with the chunk's counts as :func:`pathtrace_batch`
    returns them: (samples of the chunk, depth), int64 (the reference's
    are int32).  ``compaction`` as :func:`pathtrace_batch`'s: K1 traces
    every chunk; ``render.integrator.render`` is the wavefront's."""
    _check_compaction(compaction)
    n_iters = n_iters if n_iters is not None else scene.iterations
    # the tables stay resident on the device across chunks
    job = prepare(scene, device, nee=nee, rr=rr)
    accum = torch.zeros((scene.pixel_count, 3), dtype=torch.float32,
                        device=device)
    done = 0
    while done < n_iters:
        step = min(chunk, n_iters - done)
        rad, counts = trace_k1(job, done + 1, step, per_sample=True)
        accum += rad
        done += step
        if callback is not None:
            callback(done, accum, counts)
    return accum
