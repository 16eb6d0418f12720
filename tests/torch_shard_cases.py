"""The cases of ``tests/test_torch_shard.py``, shared with its worker
(``tests/torch_shard_worker.py``), which imports no JAX.

``CASES`` are the sharded renders: key -> (function of
``parallel/shard.py``, scene, n_iters, keyword arguments, the engine
that renders the same thing in one process, "samples" or "pixels").
``GRADS`` are the grad steps: key -> (function, scene, n_iters, keyword
arguments).  ``one_process`` renders with an engine in this process on
the CPU.
"""

import dataclasses
import os

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# name -> (scene file, resolution, depth)
SCENES = {
    "cornell": ("cornell", (16, 16), 3),
    "mesh": ("cornell_mesh", (12, 12), 2),
    "tex": ("cornell_tex", (16, 12), 3),
}

CASES = {
    "sample": ("render_sample_sharded", "cornell", 8, {}, "wavefront",
               "samples"),
    "sample-sort-nee": ("render_sample_sharded", "cornell", 2,
                        dict(compaction="sort", nee=True), "wavefront",
                        "samples"),
    "pixel": ("render_pixel_sharded", "cornell", 2, {}, "wavefront",
              "pixels"),
    "pixel-mesh-rr": ("render_pixel_sharded", "mesh", 2, dict(rr=True),
                      "wavefront", "pixels"),
    "sample-pallas": ("render_sample_sharded_pallas", "cornell", 2, {},
                      "k1", "samples"),
    "sample-pallas-mesh-nee": ("render_sample_sharded_pallas", "mesh", 2,
                               dict(nee=True), "k1", "samples"),
    "pixel-pallas": ("render_pixel_sharded_pallas", "cornell", 2, {}, "k1",
                     "pixels"),
    "pixel-pallas-tex-nee": ("render_pixel_sharded_pallas", "tex", 2,
                             dict(nee=True), "k1", "pixels"),
    "sample-sorted": ("render_sample_sharded_sorted", "cornell", 2, {},
                      "sorted", "samples"),
    "sample-sorted-mesh-nee": ("render_sample_sharded_sorted", "mesh", 2,
                               dict(nee=True), "sorted", "samples"),
    "sample-planes": ("render_sample_sharded_planes", "cornell", 8, {},
                      "planes", "samples"),
    "pixel-planes-tex": ("render_pixel_sharded_planes", "tex", 2, {},
                         "planes", "pixels"),
}

GRADS = {
    "grad": ("sharded_grad_step", "cornell", 8, {}),
    "grad-planes-mesh": ("sharded_grad_step_planes", "mesh", 2,
                         dict(nee=True)),
    "grad-pallas": ("sharded_grad_step_pallas", "cornell", 2,
                    dict(nee=True)),
    "grad-pallas-mesh": ("sharded_grad_step_pallas", "mesh", 2,
                         dict(nee=True)),
}


def scene(name):
    import pathtrace_tpu_torch as ptt

    file, res, depth = SCENES[name]
    sc = ptt.load_scene(os.path.join(REPO, "scenes", f"{file}.txt"))
    return dataclasses.replace(sc, resolution=res, trace_depth=depth)


def one_process(engine, sc, it0, n, compaction="mask", nee=False, rr=False):
    """(radiance (P,3), counts) of ``n`` samples from ``it0`` on
    ``engine`` in this process, on the CPU."""
    from pathtrace_tpu_torch.ops.cuda import megakernel as K
    from pathtrace_tpu_torch.ops.cuda import span
    from pathtrace_tpu_torch.render import integrator as I

    if engine == "wavefront":
        return I.pathtrace_batch(sc, it0, n, compaction, remat=False,
                                 nee=nee, rr=rr, device="cpu")
    if engine == "k1":
        return K.trace_k1(K.prepare(sc, "cpu", nee=nee, rr=rr), it0, n)
    if engine == "sorted":
        return span.pathtrace_batch_sorted(sc, it0, n, "cpu", nee=nee, rr=rr)
    assert engine == "planes", engine
    return K.trace_plain(**K.prepare(sc, "cpu", nee=nee, rr=rr,
                                     texels="f32"), it0=it0, n_spp=n)
