"""Multi-device rendering and differentiation on ``torch.distributed``.

Counterpart of ``pathtrace_tpu/parallel/shard.py``.  The reference runs
one process over a ``jax.sharding.Mesh`` of devices; here, as PyTorch
does, each device has a process of its own (``torchrun``), and a
:class:`Mesh` is this process's view of the group: the process group,
its rank, the group's size and its device.  Two decompositions, as the
reference's:

* **sample-parallel**: rank r renders the whole image at iterations
  ``it0 + r*per .. it0 + (r+1)*per - 1`` (``per = n_iters // size``),
  then one ``all_reduce`` sums the images;
* **pixel-parallel**: rank r renders the slab of pixels ``[r*local,
  (r+1)*local)`` at every iteration; each rank writes its slab into a
  zero (P,3) image and one ``all_reduce`` puts the image together
  (adding zeros is exact).

Every random draw is keyed on (iteration, global pixel id, bounce, draw),
so a pixel-sharded image is bit-identical to one process's render, and a
sample-sharded one is the sum of the ranks' renders (for two ranks,
exactly the rank-ordered sum: one float addition commutes).  Every
function returns the same values on every rank.

The collectives are ``all_reduce`` and ``broadcast`` alone, the two that
gloo runs on CUDA tensors too, so two gloo ranks can share one card
(NCCL refuses two ranks on one GPU).  The grad steps all-reduce the
image outside autograd, compute the same loss and cotangent on every
rank, run the local backward against it and sum each gradient over the
ranks: the exact global gradient, with no division by the size (an
autograd-aware all-reduce would sum the cotangent over the ranks in its
backward, giving size times the gradient, the trap the reference's
``psum / ndev`` works around).

The reference's texture-ceiling fallbacks and its ``interpret``,
``stream`` and ``tex_stream`` arguments are TPU-only and not ported;
``mesh.device`` being the CPU runs every kernel's plain version.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..ops.cuda import megakernel as K
from ..render import diff as D


def initialize_distributed(device="cuda", **kwargs) -> None:
    """``torch.distributed.init_process_group(**kwargs)`` (the
    reference's ``jax.distributed.initialize`` passthrough); unless
    ``kwargs`` names a backend, nccl for a CUDA ``device``, gloo for the
    CPU."""
    kwargs.setdefault("backend", "nccl" if torch.device(device).type ==
                      "cuda" else "gloo")
    dist.init_process_group(**kwargs)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in a group of processes, one a device."""
    group: object         # the torch.distributed process group
    rank: int             # this process's rank in it
    size: int             # its number of processes
    device: torch.device  # this process's device


def local_device(device="cuda"):
    """``device`` for this process: ``cuda`` without an index is
    ``cuda:{LOCAL_RANK % device_count}``; raises without a GPU."""
    device = K.resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))
                              % torch.cuda.device_count())
    return device


def make_mesh(n_devices: Optional[int] = None,
              device="cuda") -> Optional[Mesh]:
    """The :class:`Mesh` of the first ``n_devices`` ranks of the default
    group (all of them by default) on this process's
    :func:`local_device`.  Every rank of the default group must call it
    (a group of part of the ranks is made collectively); a rank outside
    the first ``n_devices`` gets None."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "initialize_distributed first")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 0 < n <= world:
        raise ValueError(f"n_devices={n_devices} of a world of {world}")
    group = (dist.group.WORLD if n == world else
             dist.new_group(list(range(n))))
    rank = dist.get_rank()
    if rank >= n:
        return None
    return Mesh(group, rank, n, local_device(device))


def join_world(device="cuda"):
    """Join the group that ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK`` and the rendezvous address in the
    environment) or, without it, a world of this process alone, on
    :func:`initialize_distributed`'s backend for ``device``.  Returns
    whether it made the group (False: one exists already); the caller
    destroys what it made."""
    if dist.is_initialized():
        return False
    if "WORLD_SIZE" in os.environ:
        initialize_distributed(device)
    else:
        initialize_distributed(device, store=dist.HashStore(), rank=0,
                               world_size=1)
    return True


def broadcast(obj, mesh):
    """Rank 0's ``obj`` (any picklable value) on every rank of
    ``mesh``."""
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=mesh.group,
                               device=mesh.device)
    return box[0]


def _sum(t, mesh):
    """``t`` summed over the ranks of ``mesh``, in place (one
    ``all_reduce``)."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    return t


def _share(n, mesh, what):
    """``n // mesh.size``; raises ``ValueError`` unless it divides."""
    if n % mesh.size:
        raise ValueError(f"{what} {n} not divisible by {mesh.size} devices")
    return n // mesh.size


def _first_iteration(it0, n_iters, mesh):
    """(this rank's first iteration, its number of iterations)."""
    per = _share(n_iters, mesh, "n_iters")
    return it0 + mesh.rank * per, per


def _samples(run, it0, n_iters, mesh):
    """Sample-sharded: ``run(first, per)``, one process's render of this
    rank's iterations, summed over the ranks.  Counts summed over the
    samples, (depth,), are summed over the ranks; each sample's rows (the
    wavefront's, (per, depth)) go to their place in (n_iters, depth)."""
    first, per = _first_iteration(it0, n_iters, mesh)
    rad, counts = run(first, per)
    if counts.dim() == 2:
        rows = counts.new_zeros((n_iters, counts.shape[1]))
        rows[first - it0:first - it0 + per] = counts
        counts = rows
    return _sum(rad, mesh), _sum(counts, mesh)


def _pixels(run, n_pixels, it0, n_iters, mesh):
    """Pixel-sharded: ``run(it0, n_iters, pix0, local)``, one process's
    render of this rank's slab of the ``n_pixels``, written into a zero
    (P,3) image at ``pix0`` and summed over the ranks (adding zeros is
    exact); the counts summed over the ranks."""
    local = _share(n_pixels, mesh, "pixel count")
    pix0 = mesh.rank * local
    rad, counts = run(it0, n_iters, pix0, local)
    img = rad.new_zeros((n_pixels, 3))
    img[pix0:pix0 + local] = rad
    return _sum(img, mesh), _sum(counts, mesh)


def _k1(scene, mesh, nee, rr):
    """One process's K1 render, the tables resident on the mesh's
    device: ``run(it0, n, pix0=0, n_local=None)``."""
    job = K.prepare(scene, mesh.device, nee=nee, rr=rr)

    def run(it0, n, pix0=0, n_local=None):
        return K.trace_k1(job, it0, n, pix0=pix0, n_local=n_local)
    return run


def _planes(scene, mesh, nee, rr):
    """One process's planes-engine render (``megakernel.trace_plain``
    over the float texel table, so any map renders)."""
    job = K.prepare(scene, mesh.device, nee=nee, rr=rr, texels="f32")

    def run(it0, n, pix0=0, n_local=None):
        return K.trace_plain(**job, it0=it0, n_spp=n, pix0=pix0,
                             n_local=n_local)
    return run


def _wavefront(scene, mesh, compaction, nee, rr):
    """One process's wavefront render (``render/integrator.trace_pixels``
    a sample at a time, as ``integrator.pathtrace_batch``): radiance and
    each sample's counts (n, depth)."""
    from ..render import integrator

    sc = integrator.resident(scene, mesh.device)

    def run(it0, n, pix0=0, n_local=None):
        end = scene.pixel_count if n_local is None else pix0 + n_local
        pixel_ids = torch.arange(pix0, end, device=mesh.device)
        acc = torch.zeros((end - pix0, 3), dtype=torch.float32,
                          device=mesh.device)
        counts = torch.zeros((n, int(scene.trace_depth)), dtype=torch.int64,
                             device=mesh.device)
        for i in range(n):
            rad, counts[i] = integrator.trace_pixels(
                sc, it0 + i, pixel_ids, compaction, False, nee, rr)
            acc = acc + rad
        return acc, counts
    return run


# ---------------------------------------------------------------------------
# forward rendering
# ---------------------------------------------------------------------------

def render_sample_sharded(scene, it0, n_iters, mesh, compaction="mask",
                          nee=False, rr=False):
    """Samples sharded over the mesh on the wavefront: (accum (P,3),
    counts (n_iters, depth) int64, each sample's row).  ``n_iters`` must
    be a multiple of the mesh size."""
    return _samples(_wavefront(scene, mesh, compaction, nee, rr), it0,
                    n_iters, mesh)


def render_pixel_sharded(scene, it0, n_iters, mesh, compaction="mask",
                         nee=False, rr=False):
    """Pixel slabs sharded over the mesh on the wavefront: (accum (P,3),
    counts (n_iters, depth) int64 summed over the slabs).  The pixel
    count must be a multiple of the mesh size."""
    return _pixels(_wavefront(scene, mesh, compaction, nee, rr),
                   scene.pixel_count, it0, n_iters, mesh)


def render_sample_sharded_pallas(scene, it0, n_iters, mesh, nee=False,
                                 rr=False):
    """Samples sharded over the mesh on the megakernel K1: this rank's
    iterations in one ``trace_k1`` call, then one image and one counts
    ``all_reduce``: (accum (P,3), counts (depth,) int64)."""
    return _samples(_k1(scene, mesh, nee, rr), it0, n_iters, mesh)


def render_pixel_sharded_pallas(scene, it0, n_iters, mesh, nee=False,
                                rr=False):
    """Pixel slabs sharded over the mesh on the megakernel K1: this
    rank's slab in one ``trace_k1`` call (``pix0``, ``n_local``): (accum
    (P,3), counts (depth,) int64)."""
    return _pixels(_k1(scene, mesh, nee, rr), scene.pixel_count, it0,
                   n_iters, mesh)


def render_sample_sharded_sorted(scene, it0, n_iters, mesh, nee=False,
                                 rr=False):
    """Samples sharded over the mesh on the sorted engine (the span
    kernel K5, ``ops/cuda/span.py``): each rank sorts its own rays, then
    one image and one counts ``all_reduce``: (accum (P,3), counts
    (depth,) int64)."""
    from ..ops.cuda import span

    job = K.prepare(scene, mesh.device, nee=nee, rr=rr)
    return _samples(span.engine(scene, job, sort=True)[1], it0, n_iters,
                    mesh)


def render_sample_sharded_planes(scene, it0, n_iters, mesh, nee=False,
                                 rr=False):
    """Samples sharded over the mesh on the planes engine (the
    megakernel's plain version): (accum (P,3), counts (depth,) int64)."""
    return _samples(_planes(scene, mesh, nee, rr), it0, n_iters, mesh)


def render_pixel_sharded_planes(scene, it0, n_iters, mesh, nee=False,
                                rr=False):
    """Pixel slabs sharded over the mesh on the planes engine: (accum
    (P,3), counts (depth,) int64)."""
    return _pixels(_planes(scene, mesh, nee, rr), scene.pixel_count, it0,
                   n_iters, mesh)


def make_sharded_renderer(scene, compaction="mask", mode="samples",
                          engine="xla", nee=False, rr=False, device="cuda"):
    """The CLI's hook: ``fn(it0, step) -> (accum, counts)`` over the mesh
    of every rank (:func:`make_mesh` on ``device``), the scene's tables
    resident for the whole render.  ``pallas`` renders on K1,
    ``planes`` on the planes engine, and every other engine (``sorted``
    too, as the reference's) on the wavefront with ``compaction``;
    ``mode`` is ``"samples"`` or ``"pixels"``."""
    if mode not in ("samples", "pixels"):
        raise ValueError(f"mode must be 'samples' or 'pixels', not {mode!r}")
    mesh = make_mesh(device=device)
    if engine == "pallas":
        run = _k1(scene, mesh, nee, rr)
    elif engine == "planes":
        run = _planes(scene, mesh, nee, rr)
    else:
        run = _wavefront(scene, mesh, compaction, nee, rr)
    if mode == "pixels":
        return lambda it0, step: _pixels(run, scene.pixel_count, it0, step,
                                         mesh)
    return lambda it0, step: _samples(run, it0, step, mesh)


# ---------------------------------------------------------------------------
# differentiable steps
# ---------------------------------------------------------------------------

def _loss_and_cotangent(total, target, n_iters, mesh):
    """Every rank's (loss, cotangent) from this rank's radiance sum
    ``total`` (P,3), detached: the image summed over the ranks and
    divided by ``n_iters``, loss = mean((img - target)^2), and d loss /
    d (a rank's radiance sum) = 2 (img - target) / (P * 3 * n_iters)."""
    img = _sum(total.detach().clone(), mesh) / float(n_iters)
    target = torch.as_tensor(target, dtype=torch.float32).to(
        img.device).reshape(img.shape)
    loss = torch.mean((img - target) ** 2)
    ct = 2.0 * (img - target) / float(img.shape[0] * 3 * n_iters)
    return loss, ct


def _sum_grads(grads, mesh):
    """``grads`` (keyed as ``split_params``; None leaves stay None)
    summed over the ranks, in one ``all_reduce`` on the mesh's device;
    each leaf back on its own device."""
    leaves = D.leaves(grads)
    flat = _sum(torch.cat([g.reshape(-1).to(mesh.device, torch.float32)
                           for g in leaves]), mesh)
    summed = iter(torch.split(flat, [g.numel() for g in leaves]))
    return D.map_params(lambda g: next(summed).view(g.shape).to(g.device),
                        grads)


def _autograd_step(scene, target, it0, n_iters, mesh, local_sum):
    """The grad step of an autograd route: ``local_sum(scene, first,
    per)`` is this rank's radiance sum (P,3) over its iterations, with
    its graph to the leaves of ``scene``.  Returns (loss, the gradients
    keyed as ``split_params``, zeros where no path depends on a
    parameter, summed over the ranks)."""
    first, per = _first_iteration(it0, n_iters, mesh)
    params = D.requires_grad(D.split_params(scene))
    rad = local_sum(D.merge_params(scene, params), first, per)
    loss, ct = _loss_and_cotangent(rad, target, n_iters, mesh)
    got = iter(torch.autograd.grad(rad, D.leaves(params), ct,
                                   allow_unused=True))

    def grad(x):
        g = next(got)
        return torch.zeros_like(x) if g is None else g

    return loss, _sum_grads(D.map_params(grad, params), mesh)


def sharded_grad_step(scene, target, it0, n_iters, mesh, compaction="mask",
                      nee=False):
    """One differentiable render step on the mesh, on the wavefront under
    autograd (each bounce recomputed in the backward pass): ``n_iters``
    sample-sharded iterations, ``loss = mean((render - target)^2)``;
    returns (loss, the gradients keyed as ``split_params``), the same on
    every rank."""
    from ..render import integrator

    def local_sum(sc, first, per):
        return integrator.pathtrace_batch(sc, first, per, compaction,
                                          remat=True, nee=nee,
                                          device=mesh.device)[0]

    return _autograd_step(scene, target, it0, n_iters, mesh, local_sum)


def sharded_grad_step_planes(scene, target, it0, n_iters, mesh, nee=True):
    """:func:`sharded_grad_step` on the planes engine under autograd
    (``render_mean(engine="planes")``'s route): a mesh's BVH walk finds
    the winner detached and its hit is recomputed, so ``tri_verts`` gets
    its gradient; textured scenes read the float texel table."""
    def local_sum(sc, first, per):
        job = K.prepare(sc, mesh.device, nee=nee, texels="f32")
        return K.trace_plain(**job, it0=first, n_spp=per)[0]

    return _autograd_step(scene, target, it0, n_iters, mesh, local_sum)


def sharded_grad_step_pallas(scene, target, it0, n_iters, mesh, nee=True):
    """:func:`sharded_grad_step` with both sweeps in kernels: K1 renders
    this rank's iterations, one image ``all_reduce`` gives the loss and
    the cotangent, the reverse sweep K8 (``ops/cuda/vjp.render_vjp``)
    runs this rank's iterations against it, and one ``all_reduce`` sums
    the gradients.  A mesh's ``tri_verts`` gradient is None (the
    triangles are constants of the sweep).  Raises
    ``NotImplementedError`` for textured scenes and for meshes without a
    BVH, as the reference does."""
    from ..ops.cuda import vjp

    if any(t >= 0 for t in scene.texture_ids) or any(
            t >= 0 for t in scene.bump_texture_ids):
        raise NotImplementedError(
            "sharded_grad_step_pallas: textured scenes use "
            "sharded_grad_step or sharded_grad_step_planes (autograd)")
    if scene.mesh.count and not scene.mesh.bvh_meta:
        raise NotImplementedError(
            "sharded_grad_step_pallas: mesh scenes need the BVH (the "
            "reverse sweep carries the walk's winners)")
    first, per = _first_iteration(it0, n_iters, mesh)
    rad, _ = K.trace_k1(K.prepare(scene, mesh.device, nee=nee), first, per)
    loss, ct = _loss_and_cotangent(rad, target, n_iters, mesh)
    _, grads = vjp.render_vjp(scene, ct, first, per, nee=nee,
                              device=mesh.device)
    return loss, _sum_grads(grads, mesh)
