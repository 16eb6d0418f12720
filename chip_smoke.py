#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pathtrace_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code non-zero):

1. the card: ``nvidia-smi`` name and power limit;
2. the scenes: the primitive ones, the triangle-mesh ones with their
   load and BVH-build seconds (``scenes/gen_icosphere7.obj``, the
   hugemesh's OBJ, is made by ``tools/gen_mesh.py 7`` when absent), and
   the image-texture ones;
3. build every variant of the CUDA kernel K1 that the phases run, one per
   feature set (with NEE, its section K2; with meshes, its section K3;
   with image textures, its section K4), and the traversal probe K9, from
   ``pathtrace_tpu_torch/csrc``, all ``nvcc`` processes at once (timed;
   each build's registers and spills printed);
4. the main path per configuration, 1 spp, through ``pathtrace_batch``
   (launch counts reset before and read after), held against the plain
   PyTorch version on the same tables.  At 800x800, depth 8: cornell.txt
   and sphere.txt (feature-free), cornell with NEE and with Russian
   roulette, cornell_glass.txt with and without NEE, cornell_checker.txt,
   and a bump + SSS variant of cornell_glass.  At the mesh files' own
   1920x1080, depth 8: cornell_mesh.txt with and without NEE,
   cornell_bigmesh.txt, a glass + checker + motion variant of
   cornell_mesh, and cornell_hugemesh.txt.  Image textures at the files'
   own size, depth 8: cornell_tex.txt with and without NEE, cornell_tex512
   (cornell_tex.txt with the 512x512 pattern, as the reference's bench
   builds it), a checker on cornell_tex's textured material and
   cornell_bumpmesh.txt at 800x800, cornell_bigmesh_tex.txt at 1920x1080.
   Under 0.5% of pixels may differ by more than 1e-3, bounce 0 must count
   every pixel and the other bounces must agree within 0.5% (the counts
   come per sample, (n_iters, depth), as the reference's); the share of
   bit-equal pixels is printed;
5. the main path through the CLI entry point (``cli.main``, default
   ``--device cuda``), launch counts reset before and read after:
   cornell.txt, cornell_glass.txt --nee and cornell_tex.txt at 800x800
   and cornell_mesh.txt at 1920x1080, 64 spp, to PNGs, which must have a
   plausible mean, a red left third and a green right third;
6. K9: the probe's 32x128 ray bundle over the bigmesh tables, CUDA
   against plain (final cursor, steps, leaves, tsum equal), the 1x32 and
   2x40 bundles and a cap of 300 steps, each equal to plain; then K1's
   lane schedule and K5's live prefix (``schedule_holds``): K1's pinned
   digests of radiance and counts (``K1_DIGESTS``, the bits before the
   lane schedule), each sample's counts equal to the plain version's at
   1, 3 and 65 samples, ``pix0``/``n_local`` tiles and two calls with the
   whole image's bits, and a sorted span handed a live count of 0 that
   leaves the state as it was;
7. timing, warm, tables resident on the device, CUDA events, median of k
   calls (runs listed), for each kernel (8 spp per call) and, on the
   first configuration of each feature mask (the kernels line's), its
   plain version (1 spp per call, 3 calls): each primitive variant at
   800x800 depth 8; the mesh variants at 1920x1080 depth 8,
   cornell_bigmesh and cornell_hugemesh at 1920x1080 and cornell_bigmesh
   at 800x800; cornell_tex, cornell_tex512 and cornell_bumpmesh at
   800x800 and cornell_bigmesh_tex at 1920x1080, and for information
   cornell_tex's kernel with every chart off
   (the same build) and with the build without textures; K9 (around
   the call, and on the device alone, ``torch.profiler``).  Mrays/s
   counts live path segments.  Beside each time, its
   bound: the least time the card could take for the same work, the larger
   of ops / 67 TFLOP/s and bytes / 3.35 TB/s (the H100 SXM data sheet's
   float32 and memory rates), from ``ops/cuda/bound.py``'s count of the
   work that one sample needs.  ops: the plain version's float
   operations, each section only on the lanes that need it (a live
   path, the lobe it takes, a winner with a map, a leaf's triangles),
   selects not counted; printed by section.  bytes: the scene tables once,
   the distinct BVH nodes, triangle rows and texels read (the columns
   needed), and 12 bytes written per pixel.

8. the split and sorted engines, on the span kernel K5 (and the split
   engine's tile table on the scan K6), through ``pathtrace_batch_split``
   and ``pathtrace_batch_sorted`` (launch counts reset before and read
   after), 1 spp, depth 8, at the files' own size: **bit-equal to K1**,
   every pixel and every live count.  Split: sphere.txt at split 1 (every
   tile dies at bounce 0), cornell.txt at split 3, with NEE, the
   cornell_glass bump + SSS variant, cornell_tex.txt, cornell_bigmesh.txt.
   Sorted: cornell.txt, cornell_mesh.txt with NEE, its glass + checker +
   motion variant, cornell_bigmesh.txt at 800x800 and at its 1920x1080,
   cornell_hugemesh.txt and cornell_bigmesh_tex.txt;
9. K5 against its plain version (the engines' plain versions on the same
   tables) within the tie-flip bound: split on the primitive and texture
   configurations above at 800x800 and on cornell_mesh.txt, sorted on
   cornell.txt, the cornell_mesh configurations and cornell_bigmesh_tex;
   each engine's K5 time per iteration (CUDA events around each launch),
   its plain version's, and K5's bound: K1's counted work on the same
   scene, plus the state the spans must read and write for this run's
   paths, by where each ray is at the end of each span
   (``bound.span_state_bytes``; the sorted engine's gather is a torch op,
   not K5's work); the kernels line gives one K5 row per feature mask and
   engine, its times and bound per launch (an iteration's over its
   launches: 2 for the split engine, one a bounce for the sorted);
10. K6 (one launch a scan, the decoupled look-back) against its plain
   version and ``torch.cumsum(x) - x``, exactly equal, at 640,000 and
   2,073,600 random 0/1 masks and at the tile-table sizes 5,000 (800x800)
   and 16,200 (1920x1080); its time (CUDA events around the Python call,
   median of 21) beside the plain version's, that of
   ``torch.cumsum(x, dtype=int32) - x`` (the same function) and its bound
   (``bound.scan_bytes``: each value read and written once);
11. ``cli.main`` with ``--split-depth 1`` on sphere.txt (its PNG must be
   K1's) and ``--engine sorted`` on cornell_mesh.txt (orientation), 64
   spp, launch counts checked;
12. the engines' time, warm, CUDA events, median of k calls, each beside
   K1's on the same scene in the same call: split sphere 800x800 at
   split 1, split cornell 800x800 at split 3, sorted cornell 800x800,
   sorted cornell_bigmesh 800x800 and sorted cornell_hugemesh 1920x1080;
   the sorted engine's breakdown into spans, ``sort_perm``, ``permute``
   and the un-permute;
13. the gradients on cornell.txt, 1 spp, with a random cotangent that is
   zero on the pixels where K1 and its plain version differ: the reverse
   sweep K8 (``k8_vjp_fwd`` + ``k8_vjp_rev``, without and with NEE)
   bit-equal to K1 in its radiance, and every table's gradient against its plain version
   (autograd over ``trace_plain`` on the card), at 64x64 depth 4 and at
   800x800 depth 8, and at 64x64 depth 4 also every parameter group of
   ``render_vjp`` against the same entry point on the plain version; the
   material gradients K7 (``k7_grads``), its radiance and counts
   bit-equal to K1's, the same way, and at 64x64 d8 16 spp flushing
   every 1024 paths (``K7_FLUSH``: each block adds its table into the
   global one twice), bit-equal to the default flush rule's table.  Tolerance
   (``tests/torch_gradcheck.py``): the reference's rtol / atol (K8 2e-4
   / 3e-4, K7 1e-5 / 1e-4), K8's cotangent split between the NEE
   fireflies (held with a share of their part's largest gradient) and
   the other pixels (held at the reference's tolerance as it stands;
   with NEE at full size, where float32 rounding over millions of
   pixels outgrows it, with the reference's tolerance plus twice the
   plain version's own distance from its float64 reading, on the pixels
   whose float64 radiance is the float32 one's; each table's limit
   beyond the bare tolerance is printed as a share of its largest
   gradient, and a share over 1 fails); two K8 calls
   give the same bits.  The same for K8's mesh builds (masks 512 and 640,
   the BVH walk's winner carried to the reverse sweep) and K7's mesh build
   on cornell_mesh.txt at 64x64 d4 and at its 1920x1080 d8, and
   ``render_vjp`` on the mesh rig of the reference's
   ``tests/test_vjp_kernel.py`` with and without NEE (``tri_verts`` None);
14. the gradients' main path, launch counts reset before and read after:
   ``render_vjp`` on cornell 800x800 d8, 1 spp, with NEE and a cotangent
   of ones (the reference bench's "NEE grad-step") and without NEE,
   ``material_grads`` on the same, and five steps of inverse rendering
   (``render/inverse.inverse_light``: the reference's
   ``examples/inverse_light.py`` loop, NEE, the light moved by (1.5, 0,
   1.0), lr 150, steps capped at 0.3) on cornell 200x200 d8 at 8 spp (the
   example's defaults: each step's error printed, and its first step
   must land within 1e-4 of the same loop's on K8's plain version), at
   64x64 d8 at 8 spp and at 24x24 d2 at 2 spp (the size the reference's
   own test runs, ``tests/test_examples.py:39-45``), where the light's
   position error must fall below its start; then the mesh gradients'
   main path, counts reset before and read after: ``render_vjp`` on
   cornell_mesh.txt at 1920x1080 d8, 1 spp, with NEE (ones) and without,
   ``material_grads`` on it, and one ``render_loss_and_grad(engine=
   "planes")`` step (autograd over the plain trace on the card, no
   kernel) on cornell_mesh at 48x48 d3 NEE 4 spp, whose ``tri_verts``
   gradient must not be zero;
15. the gradients' times, warm, CUDA events, median of k calls: the grad
   step through ``render_vjp`` (the packing and its backward on the host
   included), K8 without and with NEE and K7 (1 spp a call), K1 on the
   same tables beside them (K7 beside K1 at 1 spp a call: their ratio is
   the fold's cost), each with its bound: K1's counted work of one
   sample plus ``bound.k8_extra``/``bound.k7_extra`` (K7's fold, and
   K8 without NEE, whose only gradient that is not zero is the
   materials': the fold's ops a path and a scatter; K8 with NEE: the
   adjoints' least ops counted from the kernel's code and the stored
   state of each live bounce written and read once; all: the cotangent
   and the gradient table); K8's mesh builds on cornell_mesh at 1920x1080
   and cornell_bigmesh at 800x800, and K7's on cornell_mesh, the same way;
16. K8's section builds (glass, imperfect specular, depth of field,
   motion, checker, bump, SSS: ``K8_SECTION_CONFIGS``, masks 7, 24, 103,
   537, 544 and each with NEE): at 64x64 d4 and at full size
   (cornell_glass, cornell_checker and the bump + SSS variant at 800x800
   d8, the glass + checker + motion and the bump mesh variants at
   1920x1080 d8), with and without NEE, as in phase 13 (radiance
   bit-equal to K1, two calls' bits equal, the tables at the reference's
   tolerance, with NEE at full size within twice the plain version's own
   distance from its float64 reading beside it; with bump and NEE, whose
   float32 readings part by more than the bare tolerance at any size, on
   both parts of the cotangent and at 64x64 d4 too; at 64x64 d4
   ``render_vjp``'s parameter groups within the tables' tolerance
   carried through the packing, ``torch_gradcheck.chain_bound``); their
   main path, launch counts reset before and read after: the sections'
   grad step (``render_vjp`` on
   cornell_glass 800x800 d8 NEE, a cotangent of ones, which launches K8
   mask 135 once and gives K1's radiance), then ``render_vjp`` with and
   without NEE on each configuration at its own size; and each build's
   time beside K1's and its bound (``bound.k8_extra`` with the sections'
   adjoints on the lanes the plain version tallies), as phase 15;
17. the digests of ``tests/torch_digest.py --k8 --k6`` (K8's radiance and
   rounded tables of every build at 64x64 d4, K6's output at the four
   scan sizes, held to ``cumsum(x) - x``), so that two checkouts compare
   line by line, and the times of the K8 builds PERF.md breaks down
   (``K8_BREAKDOWN``).

18. (run after phase 12) the wavefront integrator
   (``render/integrator.py``, torch ops on the card): its main path,
   ``pathtrace_batch`` 1 spp with ``compaction="mask"`` and ``"sort"``
   (launch counts reset before and read after), on cornell.txt 800x800 d8
   and cornell_mesh.txt 1920x1080 d8, each with and without NEE: sort
   bit-equal to mask, the scan K6 launched depth times a sample in sort
   mode and never in mask mode, within the tie-flip bound of K1 on the
   same sample (counts as phase 4's); K6's densify permutation on
   cornell's 640,000 rays after bounce 0 equal to ``torch.argsort(~live,
   stable=True)``; ``cli.main`` with ``--engine xla --compaction sort`` and
   with ``--engine planes`` on cornell.txt 800x800, 8 spp, orientation as
   phase 5's; ``render_loss_and_grad(engine="wavefront")`` against
   ``engine="planes"`` on cornell 128x128 d4 NEE 2 spp (each engine's
   target its own image on the pixels where the images part, so those
   add to neither gradient; the material leaves at rtol 2e-3 / atol 2e-5,
   every other leaf's largest difference printed); one wavefront grad
   step at 800x800 d8 1 spp with ``remat=True``, its ms and peak memory;
   the wavefront's ms/iter, mask and sort, with and without NEE, beside
   K1's on the same scene, and K6's share of a sort iteration (its device
   time, ``torch.profiler``).  The kernels line gives K6 a second row, the
   densify route: its launches from this phase, its times and bound at
   640,000 values from phase 10.
19. (run last) the progressive render and the texel gradients: its main
   path, launch counts reset before and read after (K1's and K7's added to the
   kernels line): ``cli.main`` on cornell.txt 800x800 d8 16 spp (chunks
   of 8, K1) with ``--checkpoint-every 8`` and ``--preview-every 8``, then
   stopped at 8 and ``--resume``d to 16 (bit-equal to the render that
   never stopped; the preview PNG decodes), and with ``--interactive``, a
   camera key sent as the first preview is written (the image equal, bit
   for bit, to a fresh render of the moved camera); a 64-spp CLI loop on
   cornell 800x800 under ``utils.profiling.trace`` in a fresh process
   (``--busy-share``), the device's busy share of it from the profiler's
   records alone; ``render/inverse.inverse_albedo`` at the example's
   800x800 50 spp, 30 steps (K1 and K7; the error below 0.7x its start)
   and ``inverse_mesh`` at its 48x48 d3 4 spp, ``MESH_STEPS`` steps (the
   planes engine, every triangle folded; the loss below 0.8x its
   start), each step's ms; the
   checkpoint saves' ms; the planes engine's float-texel forward on
   cornell_tex 800x800 d8 within the tie bound of K1; texel gradients on
   cornell_tex 800x800 d8 1 spp NEE through the planes engine and the
   wavefront (not zero, the two at rtol 1e-3 / atol 1e-7 on the pixels
   where their forwards agree), each engine's step alone, its ms and
   peak memory.
20. multi-device rendering (``parallel/shard.py``) and the native host
   runtime (``native/``).  Two gloo ranks on ``cuda:0``, processes of
   their own (``--shard-rank``), meeting through a file store, with the
   launch counts set to 0 before the sharded routes and read after:
   ``render_pixel_sharded_pallas``, ``render_sample_sharded_pallas`` and
   ``render_sample_sharded_sorted`` on cornell 800x800 d8 at 8 spp, the
   planes and wavefront routes (the sample-sharded wavefront with
   ``compaction="sort"``, on K6) at 200x200 d8 2 spp, and
   ``sharded_grad_step_pallas`` with NEE at 1 spp a rank (K1, then K8);
   then rank 0 alone in a world of one on NCCL, K1 pixel- and
   sample-sharded.  Both ranks hold the same bits; pixel-sharded images
   are bit-equal to one process's render, sample-sharded ones bit-equal
   to the rank-ordered sum of each rank's samples rendered in one process
   and within rtol 1e-6 of one process's render of all of them, counts
   exact; the grad step's loss within 1e-6 relative and its gradients
   within rtol 1e-3 plus 1e-6 of each leaf's largest entry of one
   process's K1 + ``render_vjp`` on the same loss.  Times (host clock,
   the card synchronized, median of 5): K1 sample-sharded on the two
   gloo ranks and on the NCCL rank beside unsharded K1, and one
   ``all_reduce`` of the 800x800 image on each.  ``cli.main --shard``
   under ``torch.distributed.run --nproc_per_node 1`` (NCCL) at 8 spp,
   its accumulation and PNG equal to the unsharded CLI's, whose PNG the
   native writer wrote and which reads back equal to Pillow's; the
   native parser (``load_scene(native=True)``) on every scene file, tree
   equal to the Python parser's, and its time on cornell_bigmesh.txt
   and its OBJ beside the Python parser's.

K3-linear, the fold of every triangle of a mesh without a BVH, runs as
the other K1 builds do: phase 4 on cornell_mesh.txt stripped of its BVH
(with and without NEE, and its glass + checker + motion variant) at
1920x1080 d8 and cornell_bumpmesh.txt stripped at 800x800 (whose BUMPTEX
the linear fold leaves inert, as the reference's does), each also held
against K3 on the same configuration with its BVH (the same winners but
for ties; not bumpmesh); phase 7 times them, and for information
K3-linear and K3 on cornell_bigmesh.txt at 128x128 d8, 1 spp (the work a
BVH saves); phases 8-9 run the sorted engine on the stripped cornell_mesh
with NEE.

The line before the last is a JSON object describing each kernel; the
last line is ``{"ok": true, "device": {...}}``.  Without a CUDA GPU it
prints no result and exits non-zero.  It imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
TIE_SHARE = 0.005      # share of pixels allowed to differ by > 1e-3
COUNT_RTOL = 0.005     # per-bounce live counts after bounce 0
SPP_PER_CALL = 8
K1_SITE = "pathtrace_tpu/ops/pallas/megakernel.py:2424"   # _kernel
K2_SITE = "pathtrace_tpu/ops/pallas/megakernel.py:2223"   # _nee_add
K3_SITE = "pathtrace_tpu/ops/pallas/megakernel.py:1069"   # the bvh_meta walk
K4_SITE = "pathtrace_tpu/ops/pallas/megakernel.py:1719"   # _bilin3
K9_SITE = "tools/probe_trav.py:32"                        # kernel
K5_SITE = "pathtrace_tpu/ops/pallas/megakernel.py:3923"   # _span_kernel
K6_SITE = "pathtrace_tpu/ops/scan.py:43"                  # _scan_kernel
K7_SITE = "pathtrace_tpu/ops/pallas/megakernel.py:2551"   # _grad_accumulate
K8_SITE = "pathtrace_tpu/ops/pallas/megakernel.py:3494"   # _vjp_kernel
# the kernels line's name of K8: its pair of kernels (a launch a chunk)
K8 = "k8_vjp_fwd+k8_vjp_rev"
K3_LINEAR_SITE = "pathtrace_tpu/ops/pallas/megakernel.py:870"  # tri_body
GRAD_SMALL = ((64, 64), 4)  # resolution, depth: the reference's tolerance
# K7 where each block flushes its table more than once: 64x64 d8, 16 spp,
# a flush every 1024 paths, 8 samples of a block's pool of 128 pixels
# (resolution, depth, spp, paths a flush); the default rule,
# k7_flush_paths(8) = 65535 paths, flushes once there
K7_FLUSH = ((64, 64), 8, 16, 1024)
HUGEMESH_OBJ = os.path.join("scenes", "gen_icosphere7.obj")
# (label, scene file, text replacements of
# pathtrace_tpu_torch.scene.variants, nee, rr); the first of each feature
# set is the one timed
CONFIGS = [
    ("cornell", "cornell", (), False, False),
    ("sphere", "sphere", (), False, False),
    ("cornell NEE", "cornell", (), True, False),
    ("cornell RR", "cornell", (), False, True),
    ("cornell_glass", "cornell_glass", (), False, False),
    ("cornell_glass NEE", "cornell_glass", (), True, False),
    ("cornell_checker", "cornell_checker", (), False, False),
    ("cornell_glass bump+SSS", "cornell_glass", ("BUMP", "SSS"), False,
     False),
]
# the same, at the files' own 1920x1080 depth 8
MESH_CONFIGS = [
    ("cornell_mesh", "cornell_mesh", (), False, False),
    ("cornell_mesh NEE", "cornell_mesh", (), True, False),
    ("cornell_bigmesh", "cornell_bigmesh", (), False, False),
    ("cornell_mesh glass+checker+motion", "cornell_mesh",
     ("MESH_GLASS", "MESH_MOTION"), False, False),
    ("cornell_hugemesh", "cornell_hugemesh", (), False, False),
]
# K3-linear: mesh configurations stripped of their BVH, every triangle
# folded, at the files' own size, depth 8; each is also held against K3 on
# the same configuration with its BVH (the label without " linear"), but
# cornell_bumpmesh, whose BUMPTEX the linear fold leaves inert
LINEAR_CONFIGS = [
    ("cornell_mesh linear", "cornell_mesh", (), False, False),
    ("cornell_mesh linear NEE", "cornell_mesh", (), True, False),
    ("cornell_mesh linear glass+checker+motion", "cornell_mesh",
     ("MESH_GLASS", "MESH_MOTION"), False, False),
    ("cornell_bumpmesh linear", "cornell_bumpmesh", (), False, False),
]
# the image-texture configurations, at the files' own size (800x800, and
# 1920x1080 for cornell_bigmesh_tex), depth 8; those timed are marked.
# cornell_tex512 is the reference bench's scene of that name.
TEX_CONFIGS = [
    ("cornell_tex", "cornell_tex", (), False, False, True),
    ("cornell_tex NEE", "cornell_tex", (), True, False, False),
    ("cornell_tex512", "cornell_tex", ("TEX512",), False, False, True),
    ("cornell_tex checker", "cornell_tex", ("TEX_CHECKER",), False, False,
     False),
    ("cornell_bumpmesh", "cornell_bumpmesh", (), False, False, True),
    ("cornell_bigmesh_tex", "cornell_bigmesh_tex", (), False, False, True),
]


# (label, configuration label above, resolution or None for the file's,
# split or None for the sorted engine): held bit-equal to K1
ENGINE_CONFIGS = [
    ("split sphere s1", "sphere", None, 1),
    ("split cornell s3", "cornell", None, 3),
    ("split cornell NEE s3", "cornell NEE", None, 3),
    ("split cornell_glass bump+SSS s3", "cornell_glass bump+SSS", None, 3),
    ("split cornell_tex s3", "cornell_tex", None, 3),
    ("split cornell_bigmesh s3", "cornell_bigmesh", None, 3),
    ("sorted cornell", "cornell", None, None),
    ("sorted cornell_mesh NEE", "cornell_mesh NEE", None, None),
    ("sorted cornell_mesh glass+checker+motion",
     "cornell_mesh glass+checker+motion", None, None),
    ("sorted cornell_bigmesh 800", "cornell_bigmesh", (800, 800), None),
    ("sorted cornell_bigmesh", "cornell_bigmesh", None, None),
    ("sorted cornell_hugemesh", "cornell_hugemesh", None, None),
    ("sorted cornell_bigmesh_tex", "cornell_bigmesh_tex", None, None),
    ("sorted cornell_mesh linear NEE", "cornell_mesh linear NEE", None,
     None),
]
# held within the tie-flip bound of the plain version; the first of each
# feature mask gives K5's numbers in the kernels line (its scene is the
# one K1 is timed on, so the count of its work is made once)
PLAIN_ENGINE_CONFIGS = [
    ("split cornell s3", "cornell", None, 3),
    ("split sphere s1", "sphere", None, 1),
    ("split cornell NEE s3", "cornell NEE", None, 3),
    ("split cornell_glass bump+SSS s3", "cornell_glass bump+SSS", None, 3),
    ("split cornell_tex s3", "cornell_tex", None, 3),
    ("split cornell_mesh s3", "cornell_mesh", None, 3),
    ("sorted cornell", "cornell", None, None),
    ("sorted cornell_mesh", "cornell_mesh", None, None),
    ("sorted cornell_mesh NEE", "cornell_mesh NEE", None, None),
    ("sorted cornell_mesh glass+checker+motion",
     "cornell_mesh glass+checker+motion", None, None),
    ("sorted cornell_bigmesh_tex", "cornell_bigmesh_tex", None, None),
    ("sorted cornell_mesh linear NEE", "cornell_mesh linear NEE", None,
     None),
]
# timed beside K1
TIMED_ENGINE_CONFIGS = [
    ("split sphere s1", "sphere", None, 1),
    ("split cornell s3", "cornell", None, 3),
    ("sorted cornell", "cornell", None, None),
    ("sorted cornell_bigmesh 800", "cornell_bigmesh", (800, 800), None),
    ("sorted cornell_hugemesh", "cornell_hugemesh", None, None),
]
K5_RUNS = 5  # engine runs of 1 spp whose span times give K5's median
# K8's section builds: (label, scene file, text replacements, full): each
# held at 64x64 d4 with and without NEE, and with NEE at its own size where
# ``full`` (the four configurations of the sections' grad step); the label
# is a forward configuration's where one has the scene
K8_SECTION_CONFIGS = [
    ("cornell_glass", "cornell_glass", ()),
    ("cornell_checker", "cornell_checker", ()),
    ("cornell_glass bump+SSS", "cornell_glass", ("BUMP", "SSS")),
    ("cornell_mesh glass+checker+motion", "cornell_mesh",
     ("MESH_GLASS", "MESH_MOTION")),
    ("cornell_mesh bump", "cornell_mesh", ("MESH_BUMP",)),
]
SCAN_SIZES = (640000, 2073600, 5000, 16200)
# the K8 builds whose time PERF.md breaks down: without NEE, with it, mesh
# with NEE, the mesh variant with NEE
K8_BREAKDOWN = (0, 128, 640, 665)
SCAN_TIMED = 5000  # the tile table of an 800x800 image: the kernels line
SCAN_DENSIFY = 640000  # the wavefront's rays at 800x800: its K6 row
# phase 19's inverse_mesh steps at the example's 48x48 d3 (the reference
# test's 5): a step of the planes engine on the mesh takes seconds on the
# card, host-bound, and the loss falls below 0.8x its start in one step
MESH_STEPS = 5
# the shard phase (20): the K1 routes at the file's 800x800 d8, SHARD_SPP
# samples; the planes and wavefront routes at SHARD_SMALL d8, 2 samples
SHARD_SPP = 8
SHARD_SMALL = (200, 200)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def load(ptt, name, edits):
    """Scene file ``name`` with the variants named ``edits``."""
    from pathtrace_tpu_torch.scene import variants

    with open(os.path.join(HERE, "scenes", f"{name}.txt")) as f:
        text = variants.edit_text(
            f.read(), [getattr(variants, e) for e in edits])
    return ptt.parse_scene(text, base_dir=os.path.join(HERE, "scenes"))


def load_mesh_scene(ptt, name, edits):
    """A mesh scene, with its load and BVH-build seconds printed (the
    build is timed again apart from the load that includes it)."""
    from pathtrace_tpu_torch.scene import bvh

    t0 = time.perf_counter()
    scene = load(ptt, name, edits)
    t_load = time.perf_counter() - t0
    t0 = time.perf_counter()
    bvh.build_mesh_bvh(scene.mesh.tri_verts, scene.mesh.tri_geom,
                       scene.geoms.count)
    t_bvh = time.perf_counter() - t0
    print(f"load {name}{' (edited)' if edits else ''}: {t_load:.2f} s, "
          f"of which the BVH build {t_bvh:.2f} s; {scene.mesh.count} "
          f"triangles, bvh_meta {scene.mesh.bvh_meta}", flush=True)
    return scene


def kernel_name(K, mask):
    on = [n for i, n in enumerate(K.FEATURE_NAMES) if mask >> i & 1]
    if mask & K.RR_BIT:
        on.append("russian roulette")
    name = "k1_trace+k2_nee" if mask & K.NEE_BIT else "k1_trace"
    if mask & K.MESH_BIT:
        name += "+k3_linear" if mask & K.LINEAR_BIT else "+k3_mesh"
    if mask & (K.TEX_BIT | K.BTEX_BIT):
        name += "+k4_tex"
        on += [n for bit, n in ((K.TEX_BIT, "albedo map"),
                                (K.BTEX_BIT, "bump map")) if mask & bit]
    return f"{name}[{','.join(on)}]" if on else name


def small_table_bytes(torch, job):
    """The bytes of a ``prepare`` job's scene tables, each read once:
    every tensor but the mesh tables and the texels (counted by the rows
    read), and the int tables the wrapper makes (types, bvh_meta, the
    texture charts)."""
    n = sum(v.numel() * v.element_size() for k, v in job.items()
            if isinstance(v, torch.Tensor) and k not in (
                "tri", "nodes", "texels"))
    return n + 4 * (len(job["geom_types"]) * (1 + 6)
                    + 5 * len(job["bvh_meta"]))


def compare(ptt, K, torch, label, scene, nee, rr, mask):
    """The main path (pathtrace_batch) for one configuration, 1 spp,
    against trace_plain; returns (launches, max abs error)."""
    width, height = scene.resolution
    n_pix = width * height
    K.LAUNCHES.clear()
    rad, counts = ptt.pathtrace_batch(scene, 1, 1, device="cuda", nee=nee,
                                      rr=rr)
    torch.cuda.synchronize()
    launches = K.LAUNCHES[mask]
    if launches != 1 or sum(K.LAUNCHES.values()) != 1:
        raise RuntimeError(f"{label}: launches {dict(K.LAUNCHES)}, want one "
                           f"of mask {mask}")
    job = K.prepare(scene, "cuda", nee=nee, rr=rr)
    ref, ref_counts = K.trace_plain(**job, it0=1, n_spp=1)
    torch.cuda.synchronize()
    if rad.shape != (n_pix, 3) or not bool(torch.isfinite(rad).all()):
        raise RuntimeError(f"{label}: bad radiance {tuple(rad.shape)}")
    if tuple(counts.shape) != (1, scene.trace_depth):
        raise RuntimeError(f"{label}: counts of shape {tuple(counts.shape)}"
                           f", want (n_iters, depth)")
    counts = counts[0]
    diff = (rad - ref).abs().amax(dim=-1)
    share = float((diff > 1e-3).float().mean())
    max_err = float(diff.max())
    counts, ref_counts = counts.tolist(), ref_counts.tolist()
    print(f"compare {label} {width}x{height} d{len(counts)} 1spp (mask "
          f"{mask}): share>1e-3 {share:.6f} max_abs_err {max_err:.3g} exact "
          f"{float((diff == 0).float().mean()):.6f} counts kernel {counts} "
          f"plain {ref_counts}", flush=True)
    if share >= TIE_SHARE:
        raise RuntimeError(f"{label}: {share:.4%} of pixels differ > 1e-3")
    if counts[0] != n_pix or ref_counts[0] != n_pix:
        raise RuntimeError(f"{label}: bounce-0 count is not {n_pix}")
    for d, (a, b) in enumerate(zip(counts, ref_counts)):
        if abs(a - b) > COUNT_RTOL * max(b, 1):
            raise RuntimeError(f"{label}: bounce {d} count {a} vs {b}")
    return launches, max_err


def cli_main_path(K, np, scene_file, flags, orient=True, spp=64):
    """The main path as a user runs it; returns K1's launches by mask.
    With ``orient``, the left third must be red and the right green."""
    from PIL import Image

    from pathtrace_tpu_torch import cli

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "render.png")
        K.LAUNCHES.clear()
        rc = cli.main([os.path.join(HERE, "scenes", scene_file),
                       "--spp", str(spp), "--out", out, *flags])
        launches = dict(K.LAUNCHES)
        if rc != 0 or not os.path.exists(out):
            raise RuntimeError(f"CLI returned {rc}, wrote no {out}")
        img = np.asarray(Image.open(out), dtype=np.float32) / 255.0
    mean = float(img.mean())
    third = img.shape[1] // 3
    left = img[:, :third].reshape(-1, 3).mean(axis=0)
    right = img[:, -third:].reshape(-1, 3).mean(axis=0)
    print(f"cli {scene_file} {' '.join(flags)} {spp}spp: {img.shape} mean "
          f"{mean:.4f} left rgb {left.round(4).tolist()} right rgb "
          f"{right.round(4).tolist()} launches by mask {launches}",
          flush=True)
    # (sphere.txt, without orientation, is a lit disk on black)
    if not (np.isfinite(mean) and (0.02 if orient else 0.005) < mean < 0.6):
        raise RuntimeError(f"implausible image mean {mean}")
    if orient and not (left[0] > left[1] and right[1] > right[0]):
        raise RuntimeError("orientation: left third must be red, right green")
    return launches


def probe_phase(K, P, scene):
    """K9 on the bigmesh tables: the reference's 32x128 bundle through
    the wrapper (launch count reset before and read after), against the
    plain version; then the 1x32 and 2x40 bundles and a cap on the steps
    that stops the walk midway.  Returns the launches."""
    tri, nodes, meta = K.pack_mesh(scene, "cuda")
    P.LAUNCHES.clear()
    got = P.probe_k9(nodes, tri, meta[0])
    launches = P.LAUNCHES["k9_probe"]
    want = P.probe_plain(nodes, tri, meta[0])
    print(f"k9 bigmesh {P.BUNDLE[0]}x{P.BUNDLE[1]} rays: (n, steps, leaves, "
          f"tsum) cuda {got} plain {want}; launches {launches}", flush=True)
    if got != want or launches != 1:
        raise RuntimeError(f"K9: cuda {got} != plain {want} or launches "
                           f"{launches} != 1")
    err = max(abs(a - b) for a, b in zip(got, want))
    for args in ((1, 32), (2, 40), (32, 128, 300)):
        got = P.probe_k9(nodes, tri, meta[0], *args)
        want = P.probe_plain(nodes, tri, meta[0], *args)
        print(f"k9 bigmesh {args}: cuda {got} plain {want}", flush=True)
        if got != want:
            raise RuntimeError(f"K9 {args}: cuda {got} != plain {want}")
    return launches, err, (nodes, tri, meta[0])


def median_ms(fn, torch, k, warm=True):
    """Median over k calls of fn's CUDA-event time, after one warm call
    (unless the caller made it)."""
    if warm:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(k):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times), times, out


T_START = time.perf_counter()
# (label, width, height) -> (ops by section, bytes read by table, table
# bytes) of one iteration, counted by time_variant
WORK = {}


def phase_done(name):
    print(f"phase {name} done at {time.perf_counter() - T_START:.1f} s",
          flush=True)


def fmt_work(work):
    return ", ".join(f"{k} {v:.4g}" for k, v in sorted(work.items()))


def time_variant(K, B, torch, label, job, mask, card, spp_kernel, k_kernel,
                 spp_plain, k_plain):
    """Kernel and plain ms/iter of one configuration (runs printed), and
    the bound of one iteration: (ms, plain ms, bound ms, bound by); with
    ``k_plain`` 0 the plain version is not timed (plain ms None)."""
    width, height = job["width"], job["height"]
    ms_k, runs_k, (_, counts) = median_ms(
        lambda: K.trace_k1(job, 1, spp_kernel), torch, k_kernel)
    # the plain version's warm call is its first sample, counted
    tallies = {}
    _, ops_by, bytes_by = B.count_work(
        lambda: K.trace_plain(**job, it0=1, n_spp=1), tallies)
    WORK[label, width, height] = (ops_by, bytes_by,
                                  small_table_bytes(torch, job), tallies)
    ms_p = runs_p = None
    if k_plain:
        ms_p, runs_p, _ = median_ms(
            lambda: K.trace_plain(**job, it0=1, n_spp=spp_plain), torch,
            k_plain, warm=False)
    segs = int(counts.sum()) / spp_kernel  # live segments per iteration
    n_pix = width * height
    ops = sum(ops_by.values())
    n_bytes = (small_table_bytes(torch, job) + sum(bytes_by.values())
               + 12 * n_pix)
    bound_ms, bound_by = B.bound(ops, n_bytes)
    for version, ms, runs, spp in (("kernel", ms_k, runs_k, spp_kernel),
                                   ("plain", ms_p, runs_p, spp_plain)):
        if ms is None:
            continue
        print(f"time {version} {label} {width}x{height} d{job['depth']} "
              f"{spp}spp/call ({kernel_name(K, mask)}): median {ms:.4f} "
              f"ms/call = {ms / spp:.4f} ms/iter, "
              f"{segs / (ms / spp / 1e3) / 1e6:.1f} Mrays/s ({segs:.0f} live "
              f"segments/iter; runs {[round(t, 4) for t in runs]}) on {card}",
              flush=True)
    print(f"bound {label} {width}x{height}: {bound_ms:.4f} ms/iter by "
          f"{bound_by} ({ops:.4g} ops needed: {fmt_work(ops_by)}; "
          f"{n_bytes} bytes, of which read rows: {fmt_work(bytes_by)}); "
          f"kernel at {bound_ms / (ms_k / spp_kernel):.2%} of it; library "
          f"call: none", flush=True)
    return (ms_k / spp_kernel, ms_p and ms_p / spp_plain, bound_ms,
            bound_by)


def tex_breakdown(K, torch, scene, card):
    """For information: cornell_tex's kernel time with the texture build
    as it renders, with every chart off (the same build, no tap taken),
    and with the build without textures (mask 0) on the same geometry."""
    job = K.prepare(scene, "cuda")
    off = tuple(K.NO_CHART for _ in job["geom_types"])
    runs = [("maps on", job),
            ("charts off, same build",
             K.Job(**dict(job, tex_geom=off, btex_geom=off))),
            ("mask-0 build", K.Job(**dict(job, texels=None, tex_geom=(),
                                          btex_geom=())))]
    for what, j in runs:
        ms, _, _ = median_ms(
            lambda: K.trace_k1(j, 1, SPP_PER_CALL), torch, 9)
        print(f"texture breakdown cornell_tex 800x800 d8, {what}: "
              f"{ms / SPP_PER_CALL:.4f} ms/iter on {card}", flush=True)


def engine_scene(scenes, config, res):
    """The scene of configuration ``config`` (its nee, rr), at ``res``."""
    scene, nee, rr = scenes[config]
    if res is not None:
        scene = dataclasses.replace(scene, resolution=res)
    return scene, nee, rr


def run_engine(ptt, scene, nee, rr, split, it0=1, n=1, device="cuda"):
    """One call of the split (``split``) or sorted (None) engine."""
    if split is None:
        return ptt.pathtrace_batch_sorted(scene, it0, n, device=device,
                                          nee=nee, rr=rr)
    return ptt.pathtrace_batch_split(scene, it0, n, split=split,
                                     device=device, nee=nee, rr=rr)


def engine_equal(ptt, K, SP, SC, torch, label, scene, nee, rr, split):
    """The main path on an engine, 1 spp, launch counts reset before and
    read after, against K1 on the same scene: every pixel and every count
    equal.  Returns (K5 launches by mask, K6 launches)."""
    width, height = scene.resolution
    want, want_counts = ptt.pathtrace_batch(scene, 1, 1, device="cuda",
                                            nee=nee, rr=rr)
    want_counts = want_counts.sum(0)  # the engines sum over the samples
    K.LAUNCHES.clear()
    SP.LAUNCHES.clear()
    SC.LAUNCHES.clear()
    rad, counts = run_engine(ptt, scene, nee, rr, split)
    torch.cuda.synchronize()
    k5, k6 = dict(SP.LAUNCHES), SC.LAUNCHES["k6_scan"]
    depth = int(scene.trace_depth)
    mask = K.scene_mask(scene, nee, rr)
    want_k5 = {mask: 2 if split else depth}
    if k5 != want_k5 or k6 != (1 if split else 0) or K.LAUNCHES:
        raise RuntimeError(f"{label}: K5 launches {k5} (want {want_k5}), "
                           f"K6 {k6}, K1 {dict(K.LAUNCHES)}")
    same = torch.equal(rad, want) and torch.equal(counts, want_counts)
    n_eq = float((rad == want).all(dim=-1).float().mean())
    print(f"engine {label} {width}x{height} d{depth} 1spp (mask {mask}): "
          f"bit-equal to K1 {same} (pixels equal {n_eq:.6f}), counts "
          f"{counts.tolist()} K1 {want_counts.tolist()}; launches K5 {k5} "
          f"K6 {k6}", flush=True)
    if not same:
        raise RuntimeError(f"{label}: the engine is not bit-equal to K1")
    return k5, k6


# K1's pinned digests (sha256 of the float32 radiance, and of the int64
# counts per sample, first 16 hex digits) of ``tests/torch_digest.py``'s
# jobs: the bits K1 gave before its lane schedule (H100, CUDA 12.8)
K1_DIGESTS = {"cornell": ("56f1410781372ccc", "a52ad48147c2ae95"),
              "cornell_mesh": ("42eec1d67a3c3d90", "a9bc73f86ac50c28")}


def schedule_holds(ptt, K, SP, TD, build, torch, cornell):
    """K1's lane schedule and K5's live prefix on the card: the pinned
    digests of radiance and counts; each sample's counts and radiance
    equal to the plain version's at 1, 3 and 65 samples (65: past one
    count chunk); pix0/n_local tiles of the library put together give the
    whole image's bits and counts, and two calls give the same bits; a
    sorted span handed a live count of 0 leaves the state as it was."""
    for name, mask in TD.JOBS:
        scene = dataclasses.replace(
            ptt.load_scene(os.path.join(HERE, "scenes", f"{name}.txt")),
            resolution=TD.RES, trace_depth=TD.DEPTH)
        job = K.prepare(scene, "cuda")
        rad, _ = K.trace_k1(job, 1, TD.SPP)
        _, counts = K.trace_k1(job, 1, TD.SPP, per_sample=True)
        got = (TD.digest(rad), TD.digest(counts))
        print(f"k1 digest {name} (mask {mask}): radiance {got[0]} counts "
              f"{got[1]}, pinned {K1_DIGESTS[name]}", flush=True)
        if got != K1_DIGESTS[name]:
            raise RuntimeError(f"K1's digests of {name} moved")
    job = K.prepare(dataclasses.replace(cornell, resolution=(160, 120)),
                    "cuda")
    for n_spp in (1, 3, 65):
        rad, per = K.trace_k1(job, 2, n_spp, per_sample=True)
        ref, ref_per = K.trace_plain(**job, it0=2, n_spp=n_spp,
                                     per_sample=True)
        ok = torch.equal(rad, ref) and torch.equal(per, ref_per)
        print(f"k1 per sample, {n_spp} spp 160x120 d8: radiance and counts "
              f"equal to the plain version's {ok}", flush=True)
        if not ok:
            raise RuntimeError(f"K1's per-sample form at {n_spp} spp is not "
                               f"its plain version")
    whole, counts = K.trace_k1(job, 4, 3)
    again, again_counts = K.trace_k1(job, 4, 3)
    lib = build.load_k1(job.mask)
    tiles, total = [], torch.zeros_like(counts)
    for pix0, n_local in ((0, 5000), (5000, 1), (5001, 9999), (15000, 4200)):
        rad = torch.empty((n_local, 3), device="cuda")
        part = torch.zeros_like(counts)
        err = lib.pt_k1_trace(*job.args, 160, 120, 8, 4, 3, pix0, n_local,
                              rad.data_ptr(), part.data_ptr(), None, 0,
                              torch.cuda.current_stream().cuda_stream)
        K.launch_error("K1", lib, err)
        tiles.append(rad)
        total += part
    ok = (torch.equal(whole, again) and torch.equal(counts, again_counts)
          and torch.equal(torch.cat(tiles), whole)
          and torch.equal(total, counts))
    print(f"k1 two calls and four pix0/n_local tiles: the same bits {ok}",
          flush=True)
    if not ok:
        raise RuntimeError("K1's tiles or two calls differ")
    keys = K.state_keys(job["features"], False, True)
    state = torch.empty((len(keys), 160 * 120), device="cuda")
    counts = torch.zeros(8, dtype=torch.int64, device="cuda")
    SP.trace_span(job, state, keys, 0, 1, 4, counts)
    state = SP.permute(state, SP.sort_perm(state, *SP.sort_box(cornell,
                                                               "cuda")))
    before, out = state.clone(), torch.zeros(1, dtype=torch.int32,
                                             device="cuda")
    SP.trace_span(job, state, keys, 1, 2, 4, counts,
                  n_live=torch.zeros(1, dtype=torch.int32, device="cuda"),
                  live_out=out)
    ok = torch.equal(state.view(torch.int32), before.view(torch.int32)) \
        and int(out) == 0 and int(counts[1]) == 0
    print(f"k5 sorted span handed a live count of 0: the state as it was "
          f"{ok}", flush=True)
    if not ok:
        raise RuntimeError("K5 with a live count of 0 moved the state")


def live_tile_rays(K, SP, torch, job, split):
    """The rays of the tiles the split engine's resumed span runs (1 spp,
    iteration 1): the tiles with a live path after bounce ``split``."""
    n_pix = job["width"] * job["height"]
    keys = K.state_keys(job["features"], job["lights"] is not None)
    state = torch.empty((len(keys), n_pix), device="cuda")
    counts = torch.zeros(job["depth"], dtype=torch.int64, device="cuda")
    SP.trace_span(job, state, keys, 0, split, 1, counts)
    live = state[SP.LIVE_KEY] != 0
    n_tiles = -(-n_pix // SP.TILE)
    tlive = torch.nn.functional.pad(live, (0, n_tiles * SP.TILE - n_pix))
    tlive = tlive.view(n_tiles, SP.TILE).any(1)
    return int(tlive.repeat_interleave(SP.TILE)[:n_pix].sum())


def engine_vs_plain(ptt, K, B, SP, torch, label, scene, nee, rr, split,
                    config):
    """K5 (the engine on the card) against its plain version (the
    engine's plain version on the card, same tables), 1 spp, within the
    tie-flip bound; then K5's time per iteration in a second run (CUDA
    events around each launch), the plain version's (one call, host
    clock after a synchronize) and K5's bound.  Returns (max abs error,
    K5 ms, plain ms, bound ms, bound by), each time per launch: an
    iteration's over its launches (the split engine's 2, the sorted
    engine's one a bounce)."""
    width, height = scene.resolution
    n_pix = width * height
    depth = int(scene.trace_depth)
    rad, counts = run_engine(ptt, scene, nee, rr, split)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    job = K.prepare(scene, "cuda", nee=nee, rr=rr)
    ref, ref_counts = SP.engine(scene, job, split, split is None,
                                plain=True)[1](1, 1)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    diff = (rad - ref).abs().amax(dim=-1)
    share = float((diff > 1e-3).float().mean())
    max_err = float(diff.max())
    print(f"k5 vs plain {label} {width}x{height} d{depth} 1spp: share>1e-3 "
          f"{share:.6f} max_abs_err {max_err:.3g} exact "
          f"{float((diff == 0).float().mean()):.6f} counts kernel "
          f"{counts.tolist()} plain {ref_counts.tolist()}; plain engine "
          f"{plain_ms:.1f} ms", flush=True)
    if share >= TIE_SHARE or counts[0] != n_pix or ref_counts[0] != n_pix:
        raise RuntimeError(f"{label}: K5 against its plain version: "
                           f"{share:.4%} of pixels differ > 1e-3, or "
                           f"bounce 0 does not count every pixel")
    for d, (a, b) in enumerate(zip(counts.tolist(), ref_counts.tolist())):
        if abs(a - b) > COUNT_RTOL * max(b, 1):
            raise RuntimeError(f"{label}: bounce {d} count {a} vs {b}")
    runs = []
    try:
        for _ in range(K5_RUNS):
            SP.EVENTS = []
            run_engine(ptt, scene, nee, rr, split)
            torch.cuda.synchronize()
            runs.append(sum(a.elapsed_time(b) for name, a, b in SP.EVENTS
                            if name == "span"))
    finally:
        SP.EVENTS = None
    ms = statistics.median(runs)
    # the bound: K1's work on this scene (its count from time_variant,
    # or made here; K1's image write is not K5's) and the state the spans
    # must move
    if (config, width, height) not in WORK:
        forward_work(K, B, torch, config, job)
    ops_by, bytes_by, table_bytes, _ = WORK[config, width, height]
    # the state K5 must move, by where each ray is at the end of each
    # span (this run's counts; the resumed span runs the live tiles' rays)
    n_keys = len(K.state_keys(job["features"], nee, split is None))
    if split is None:
        # a later span runs the tiles below the live count it is handed
        spans = [(0, 1, n_pix)] + [
            (d, d + 1, min(n_pix, -(-int(counts[d]) // SP.TILE) * SP.TILE))
            for d in range(1, depth)]
    else:
        spans = [(0, split, n_pix),
                 (split, depth, live_tile_rays(K, SP, torch, job, split))]
    n_state = B.span_state_bytes(n_keys, counts.tolist(), spans,
                                 split is None)
    n_bytes = table_bytes + sum(bytes_by.values()) + n_state
    bound_ms, bound_by = B.bound(sum(ops_by.values()), n_bytes)
    print(f"time k5 {label} {width}x{height} d{depth}: K5 {ms:.4f} ms/iter "
          f"(its launches, median of {K5_RUNS} runs "
          f"{[round(t, 4) for t in runs]}), plain engine {plain_ms:.1f} "
          f"ms/iter; "
          f"bound {bound_ms:.4f} ms by {bound_by} ({sum(ops_by.values()):.4g}"
          f" ops of K1's count, {n_bytes} bytes of which state {n_state}); "
          f"K5 at {bound_ms / ms:.2%} of it; library call: none", flush=True)
    n_launch = depth if split is None else 2
    print(f"time k5 {label}: per launch ({n_launch} an iteration) K5 "
          f"{ms / n_launch:.4f} ms, plain {plain_ms / n_launch:.4f} ms, "
          f"bound {bound_ms / n_launch:.6f} ms", flush=True)
    return (max_err, ms / n_launch, plain_ms / n_launch,
            bound_ms / n_launch, bound_by)


def scan_phase(B, SC, torch, card):
    """K6 against its plain version and torch.cumsum(x) - x at each of
    SCAN_SIZES (random 0/1 masks from a seed): exactly equal; then the
    times of K6, the plain version and torch.cumsum(x) - x (int32), and
    K6's bound.
    Returns {n: (max abs error, ms, plain ms, cumsum ms, bound ms, by)}."""
    out = {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for n in SCAN_SIZES:
        x = (torch.rand(n, device="cuda", generator=gen) < 0.4).to(
            torch.int32)
        got, plain = SC.scan_int(x), SC.prefix_sum_plain(x)
        lib = (torch.cumsum(x, 0, dtype=torch.int32) - x)
        err = int((got - plain).abs().max())
        if not (torch.equal(got, plain) and torch.equal(got, lib)):
            raise RuntimeError(f"K6 at {n}: not equal to its plain version "
                               f"or to torch.cumsum(x) - x")
        ms, runs, _ = median_ms(lambda: SC.scan_int(x), torch, 21)
        ms_p, _, _ = median_ms(lambda: SC.prefix_sum_plain(x), torch, 21)
        ms_l, _, _ = median_ms(
            lambda: torch.cumsum(x, 0, dtype=torch.int32) - x, torch, 21)
        bound_ms, bound_by = B.bound(n, B.scan_bytes(n))
        print(f"k6 scan n={n}: equal to plain and to cumsum - x; K6 median "
              f"{ms:.4f} ms (runs {[round(t, 4) for t in runs]}), plain "
              f"{ms_p:.4f} ms, torch.cumsum(x, dtype=int32) - x "
              f"{ms_l:.4f} ms on {card}; bound "
              f"{bound_ms:.6f} ms by {bound_by} ({B.scan_bytes(n)} bytes); "
              f"K6 at {bound_ms / ms:.2%} of it; K6 / library "
              f"{ms / ms_l:.3f}", flush=True)
        out[n] = (err, ms, ms_p, ms_l, bound_ms, bound_by)
    return out


def cli_engines(ptt, K, SP, SC, np, torch):
    """The engines through the CLI, 64 spp: --split-depth 1 on sphere.txt
    (its PNG must be the default engine's), --engine sorted on
    cornell_mesh.txt (orientation); launch counts reset before and read
    after.  Returns (K5 launches by (mask, engine), K6 launches)."""
    from PIL import Image

    k5, k6 = {}, 0
    with tempfile.TemporaryDirectory() as tmp:
        for scene_file, flags, orient in (
                ("sphere.txt", ["--split-depth", "1"], False),
                ("cornell_mesh.txt", ["--engine", "sorted"], True)):
            SP.LAUNCHES.clear()
            SC.LAUNCHES.clear()
            launches = cli_main_path(K, np, scene_file, flags, orient)
            n5, n6 = dict(SP.LAUNCHES), SC.LAUNCHES["k6_scan"]
            print(f"cli {scene_file} {' '.join(flags)}: K5 launches {n5}, K6 "
                  f"{n6}, K1 {launches}", flush=True)
            if not n5 or launches or (flags[0] == "--split-depth") != (
                    n6 > 0):
                raise RuntimeError(f"the CLI with {flags} did not run on K5 "
                                   f"(and K6 for the split engine) alone")
            eng = "split" if flags[0] == "--split-depth" else "sorted"
            for m, n in n5.items():
                k5[m, eng] = k5.get((m, eng), 0) + n
            k6 += n6
            if not orient:
                # the split engine's PNG is the default engine's
                a = os.path.join(tmp, "split.png")
                b = os.path.join(tmp, "k1.png")
                from pathtrace_tpu_torch import cli
                path = os.path.join(HERE, "scenes", scene_file)
                cli.main([path, "--spp", "64", "--out", a, *flags])
                cli.main([path, "--spp", "64", "--out", b])
                if not np.array_equal(np.asarray(Image.open(a)),
                                      np.asarray(Image.open(b))):
                    raise RuntimeError(f"{scene_file}: the split engine's "
                                       f"PNG is not K1's")
                print(f"cli {scene_file}: the split engine's PNG equals "
                      f"K1's", flush=True)
    return k5, k6


def time_engines(ptt, K, SP, torch, scenes, card):
    """Each engine's ms/iter beside K1's on the same scene (warm, CUDA
    events, median of k calls of 4 spp), and the sorted engine's
    breakdown (one call of 4 spp with events around each step)."""
    spp = 4
    for label, config, res, split in TIMED_ENGINE_CONFIGS:
        scene, nee, rr = engine_scene(scenes, config, res)
        width, height = scene.resolution
        job = K.prepare(scene, "cuda", nee=nee, rr=rr)
        run = SP.engine(scene, job, split, split is None)[1]
        engine = lambda: run(1, spp)  # noqa: E731
        k1 = lambda: K.trace_k1(job, 1, spp)  # noqa: E731
        ms_k1a, runs_a, _ = median_ms(k1, torch, 5)
        ms_e, runs_e, _ = median_ms(engine, torch, 5)
        ms_k1b, runs_b, _ = median_ms(k1, torch, 5, warm=False)
        print(f"time engine {label} {width}x{height} d{scene.trace_depth}: "
              f"{ms_e / spp:.4f} ms/iter (runs {[round(t, 3) for t in runs_e]}"
              f", {spp} spp a call), K1 {ms_k1a / spp:.4f} before and "
              f"{ms_k1b / spp:.4f} after (runs {[round(t, 3) for t in runs_a]}"
              f" {[round(t, 3) for t in runs_b]}); engine / K1 "
              f"{ms_e / min(ms_k1a, ms_k1b):.2f} on {card}", flush=True)
        SP.EVENTS = []
        try:
            engine()
            torch.cuda.synchronize()
            steps = {}
            for name, a, b in SP.EVENTS:
                steps[name] = steps.get(name, 0.0) + a.elapsed_time(b) / spp
        finally:
            SP.EVENTS = None
        print(f"breakdown engine {label}: "
              + ", ".join(f"{k} {v:.4f}" for k, v in steps.items())
              + f" ms/iter (one call, events around each step; K5's spans "
              f"{steps.get('span', 0.0) / sum(steps.values()):.2%} of them) "
              f"on {card}", flush=True)


def masked_ct(torch, rad, ref, seed):
    """A random cotangent (seeded, on the card), zero on the pixels where
    the kernel's forward and the plain version's differ (tie flips), as
    the reference's gradient tests mask them."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    ct = torch.rand(rad.shape, generator=gen, device="cuda")
    return torch.where(((rad - ref).abs().amax(-1) < 1e-4)[:, None], ct, 0.0)


def held(GC, label, got, want, tol, share=None):
    """Each (name, gradient) of ``got`` against ``want``'s
    (``tests/torch_gradcheck.compare``: ``tol`` the reference's (rtol,
    atol), ``share`` a share of max|w|).  Prints each; raises on a miss
    or on a gradient that is not finite.  Returns the largest absolute
    difference."""
    rows = GC.compare(got, want, *tol, share)
    for name, scale, err, ratio, need, ok in rows:
        print(f"  {label} {name}: max |g| {scale:.6g}, max |diff| {err:.6g}"
              f" ({ratio:.3g} of atol + rtol |g| at worst), share of max |g|"
              f" needed {need:.3g} (allowed {share or 0.0:.3g}) "
              f"{'ok' if ok else 'MISS'}", flush=True)
    missed = [row[0] for row in rows if not row[-1]]
    if missed:
        raise RuntimeError(f"{label}: {missed} against the plain version")
    return max((row[2] for row in rows), default=0.0)


def held_own(GC, torch, label, names, got, plain, w64, tol):
    """Each table of the kernel's gradient ``got`` against the plain
    version's ``plain`` within the reference's (rtol, atol) ``tol`` plus
    twice the plain version's own distance from its float64 reading
    ``w64`` (``tests/torch_gradcheck.compare_own``).  Prints each table:
    its limit beyond the bare tolerance as a share of its largest
    gradient, and its worst entry.  Raises on a miss, on a gradient that
    is not finite, or on a limit that exceeds its table's largest
    gradient (a limit that could not fail).  Returns the largest absolute
    difference of the kernel from the plain version."""
    rows = GC.compare_own(zip(names, got), zip(names, plain),
                          zip(names, w64), *tol)
    for (name, scale, err, ratio, need, room, ok), g, w, w6 in zip(
            rows, got, plain, w64):
        w, w6 = w.double(), w6.to(g.device)
        bound = tol[1] + tol[0] * w.abs() + 2.0 * (w - w6).abs()
        at = ((g.double() - w).abs() / bound).argmax()
        idx = tuple(int(i) for i in torch.unravel_index(at, g.shape))
        k64, p64 = ((x.double() - w6).abs().max() for x in (g, w))
        print(f"  {label} {name}: max |g| {scale:.6g}; limit beyond the "
              f"bare tolerance at most {room:.3g} of it; kernel max |diff| "
              f"{err:.6g}, {ratio:.3g} of its bound at worst, over the bare"
              f" tolerance by at most {need:.3g} x |plain - float64|; "
              f"float64: kernel max |diff| {float(k64):.6g}, float32 plain "
              f"{float(p64):.6g}; worst entry {idx}: kernel "
              f"{float(g.reshape(-1)[at]):.6f} float32 plain "
              f"{float(w.reshape(-1)[at]):.6f} float64 "
              f"{float(w6.reshape(-1)[at]):.6f} bound "
              f"{float(bound.reshape(-1)[at]):.6g} "
              f"{'ok' if ok else 'MISS'}", flush=True)
    missed = [row[0] for row in rows if not row[-1]]
    if missed:
        raise RuntimeError(f"{label}: {missed} against the plain version")
    return max((row[2] for row in rows), default=0.0)


def k8_vs_plain(K, VJ, GC, torch, label, scene, nee, full=False):
    """K8 on the tables of ``scene``, 1 spp, against K1 (its radiance, bit
    for bit) and against its plain version, with the cotangent split
    between the NEE fireflies and the other pixels (``GC.split``): every
    table's gradient and, at the small size, every parameter group of
    ``render_vjp`` (the entry point on K8 and on K8's plain version), each
    with :func:`held`.  With NEE at full size (``full``) the other pixels
    are held within twice the plain version's own distance from its
    float64 reading (:func:`held_own`), on the pixels whose float64
    radiance is the float32 one's; in a build with bump and NEE, whose
    float32 readings part by more than the bare tolerance at any size, so
    are both parts at any size (PERF.md §2).  A build with sections holds
    ``render_vjp``'s parameter groups to the bound the tables' tolerance
    gives through the packing (``GC.chain_bound``).  Returns (the largest
    abs error of the tables on either part of the cotangent, the plain
    version's ms on the other pixels' part, one call on the host clock)."""
    job = K.prepare(scene, "cuda", nee=nee)
    width, height, depth = job["width"], job["height"], job["depth"]
    mask = K.scene_mask(scene, nee)
    sections = bool(mask & (K.NEE_BIT - 1))
    # bump with NEE: the tilted normal magnifies float32 rounding past the
    # bare tolerance at any size, on both parts of the cotangent
    bump_nee = nee and bool(mask & 32)
    rad, _ = K.trace_k1(job, 1, 1)
    ref, _ = K.trace_plain(**job, it0=1, n_spp=1)
    ct = masked_ct(torch, rad, ref, 0)

    def trace(cam, mats, gmat, lights=None):
        return K.trace_plain(cam, mats, gmat, job["geom_types"], width,
                             height, depth, 1, 1, features=job["features"],
                             lights=lights, tri=job["tri"], nodes=job["nodes"],
                             bvh_meta=job["bvh_meta"])[0]

    rad8, got = VJ.trace_k8(job, 1, 1, ct)
    twice = all(torch.equal(a, b)
                for a, b in zip(got, VJ.trace_k8(job, 1, 1, ct)[1]))
    same = torch.equal(rad8, rad)
    ff = GC.fireflies(rad, 1, scene.materials.emittance)
    print(f"k8 {label} {width}x{height} d{depth} 1spp (mask {mask}): "
          f"radiance bit-equal to K1 {same}; two calls give the same bits "
          f"{twice}; cotangent on {float((ct[:, 0] > 0).float().mean()):.6f}"
          f" of the pixels; {int(ff.sum())} fireflies (radiance "
          f"{[round(float(x), 4) for x in rad.amax(-1)[ff][:8]]})",
          flush=True)
    if not (same and twice):
        raise RuntimeError(f"{label}: K8's radiance is not K1's, or two "
                           f"calls differ")
    names = ("cam", "mats", "gmat", "lights")
    tables = [job["cam"], job["mats"], job["gmat"]] + (
        [job["lights"]] if nee else [])
    err, plain_ms = 0.0, None
    from pathtrace_tpu_torch.render import diff as D

    for part, c in zip(("other pixels", "fireflies"), GC.split(ct, ff)):
        judge = bump_nee or (nee and full and part == "other pixels")
        share = GC.FIREFLY_SHARE if part == "fireflies" else None
        if judge:
            t0 = time.perf_counter()
            rad64, grads64 = GC.reading64(trace, tables)
            agree = GC.same_paths(ref, rad64)
            del rad64
            c = torch.where(agree[:, None], c, 0.0)
            print(f"  {label} {part}: the float64 plain version's forward "
                  f"{time.perf_counter() - t0:.1f} s; "
                  f"{int((~agree).sum())} pixels take another path there "
                  f"and leave the cotangent", flush=True)
        if not bool(c.any()):
            continue
        _, g = VJ.trace_k8(job, 1, 1, c)
        if judge:
            t0 = time.perf_counter()
            w64 = grads64(c)
            del grads64
            print(f"  {label} {part}: the float64 gradients "
                  f"{time.perf_counter() - t0:.1f} s; "
                  f"card memory at most "
                  f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB",
                  flush=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, w = VJ.k8_plain(job, 1, 1, c)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        plain_ms = ms if plain_ms is None else plain_ms
        print(f"  {label} {part}: plain version {ms:.1f} ms", flush=True)
        if judge:
            err = max(err, held_own(GC, torch, f"{label} {part}", names,
                                    g, w, w64, GC.K8_TOL))
        else:
            err = max([err] + [float((a - b).abs().max())
                               for a, b in zip(g, w)])
            held(GC, f"{label} {part}", zip(names, g), zip(names, w),
                 GC.K8_TOL, share)
        if full:
            continue
        _, gp = VJ.render_vjp(scene, c, 1, 1, nee=nee)
        _, wp = VJ.render_vjp(scene, c, 1, 1, nee=nee, plain=True)
        if scene.mesh.count and gp["tri_verts"] is not None:
            raise RuntimeError(f"{label}: render_vjp gave tri_verts")
        if not sections:
            held(GC, f"{label} render_vjp {part}", D.named_leaves(gp),
                 D.named_leaves(wp), GC.K8_TOL, share)
            continue
        # the tables' own bound (held_own's where they were held by it),
        # through the packing
        rtol, atol = GC.K8_TOL
        extra = ([2.0 * (b.double() - b6.to(b.device)).abs() for b, b6 in
                  zip(w, w64)] if judge else [0.0] * len(w))
        bounds = [atol + rtol * b.abs() + x + (share or 0.0) * b.abs().max()
                  for b, x in zip(w, extra)]
        rows = GC.compare_chained(
            D.named_leaves(gp), D.named_leaves(wp),
            GC.chain_bound(scene, nee, bounds), rtol, atol)
        for name, scale, e, ratio, need, ok in rows:
            print(f"  {label} render_vjp {part} {name}: max |g| {scale:.6g},"
                  f" max |diff| {e:.6g} ({ratio:.3g} of atol + rtol |g| + "
                  f"the tables' bound through the packing at worst) "
                  f"{'ok' if ok else 'MISS'}", flush=True)
        missed = [row[0] for row in rows if not row[-1]]
        if missed:
            raise RuntimeError(f"{label} render_vjp {part}: {missed} "
                               f"against the plain version")
    return err, plain_ms


def k7_vs_plain(K, MG, GC, torch, label, scene, spp=1, flush_paths=None):
    """K7 on the tables of ``scene``, ``spp`` samples, against K1
    (radiance and counts, bit for bit) and its plain version (the
    gradient table by parameter, :func:`held`; without NEE there are no
    fireflies); with ``flush_paths``, K7 flushing that often, whose bits
    must be those of the default flush rule.  Returns (max abs error,
    plain ms, the job, the material table, the geoms' materials)."""
    job = K.prepare(scene, "cuda")
    mtab = MG.material_table(scene, "cuda")
    mat_of = tuple(int(m) for m in scene.geoms.material_id)
    rad, counts = K.trace_k1(job, 1, spp)
    ref, _ = K.trace_plain(**job, it0=1, n_spp=spp)
    ct = masked_ct(torch, rad, ref, 1)
    rad7, counts7, got = MG.trace_k7(job, mtab, mat_of, ct, 1, spp)
    per_flush = MG.k7_flush_paths(job["depth"])
    if flush_paths is not None:
        split = MG.trace_k7(job, mtab, mat_of, ct, 1, spp, flush_paths)
        if not all(torch.equal(a, b)
                   for a, b in zip(split, (rad7, counts7, got))):
            raise RuntimeError(f"{label}: K7 flushing every {flush_paths} "
                               f"paths is not the default rule's bits")
        rad7, counts7, got = split
        per_flush = flush_paths
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, want = MG.k7_plain(job, mtab, mat_of, ct, 1, spp)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    same = torch.equal(rad7, rad) and torch.equal(counts7, counts)
    print(f"k7 {label} {job['width']}x{job['height']} d{job['depth']} "
          f"{spp}spp: radiance and counts bit-equal to K1 {same}; at most "
          f"{per_flush} paths a block between flushes (the default rule's "
          f"bits); plain version {plain_ms:.1f} ms", flush=True)
    if not same:
        raise RuntimeError(f"{label}: K7's radiance or counts are not K1's")
    rows = (("color", slice(0, 3)), ("spec_color", slice(3, 6)),
            ("emittance", slice(6, 7)), ("has_reflective", slice(7, 8)))
    err = held(GC, label, [(n, got[r]) for n, r in rows],
               [(n, want[r]) for n, r in rows], GC.K7_TOL)
    return err, plain_ms, job, mtab, mat_of


def grad_main_path(ptt, K, MG, VJ, np, torch, cornell):
    """The gradients' main path (launch counts reset before and read
    after): the NEE grad step, ``render_vjp`` without NEE,
    ``material_grads``, five steps of inverse rendering.  Returns the
    launches by kernel."""
    from pathtrace_tpu_torch.render import diff as D
    from pathtrace_tpu_torch.render.inverse import inverse_light

    n_pix = cornell.pixel_count
    ct = torch.rand((n_pix, 3), generator=torch.Generator().manual_seed(7))
    loops = {"200x200 d8 8spp": (dataclasses.replace(
        cornell, resolution=(200, 200)), 8), "64x64 d8 8spp": (
        dataclasses.replace(cornell, resolution=(64, 64)), 8),
        "24x24 d2 2spp": (dataclasses.replace(
            cornell, resolution=(24, 24), trace_depth=2), 2)}
    first = {}

    def show(what):
        def callback(step, pos, err):
            first.setdefault(what, pos)
            print(f"inverse_light {what} step {step}: light at "
                  f"{[float(x) for x in pos]}, position error {err}",
                  flush=True)
        return callback

    for counter in (K.LAUNCHES, MG.LAUNCHES, VJ.LAUNCHES):
        counter.clear()
    rad, g_nee = ptt.render_vjp(cornell, torch.ones((n_pix, 3)), 1, 1,
                                nee=True)
    _, g = ptt.render_vjp(cornell, ct, 1, 1)
    rad_m, g_m = ptt.material_grads(cornell, ct, 1, 1)
    errors = {what: inverse_light(scene, steps=5, spp=spp, device="cuda",
                                  callback=show(what))
              for what, (scene, spp) in loops.items()}
    torch.cuda.synchronize()
    launches = {"k7_grads": MG.LAUNCHES[0], K8: VJ.LAUNCHES[0],
                f"{K8}+k2_nee": VJ.LAUNCHES[K.NEE_BIT],
                "k1_trace+k2_nee": K.LAUNCHES[K.NEE_BIT]}
    print(f"gradients' main path: launches {launches}; inverse_light "
          f"position errors {errors}", flush=True)
    scene, spp = loops["200x200 d8 8spp"]
    inverse_light(scene, steps=1, spp=spp, device="cuda", plain=True,
                  callback=show("plain"))
    step_err = float(np.abs(first["plain"] - first["200x200 d8 8spp"]).max())
    print(f"inverse_light 200x200 d8 8spp, first step on K8 against its "
          f"plain version: {step_err}", flush=True)
    if not step_err <= 1e-4:
        raise RuntimeError(f"inverse_light: K8's first step is {step_err} "
                           f"from the plain version's")
    if not all(launches.values()):
        raise RuntimeError(f"the gradients' main path skipped a kernel: "
                           f"{launches}")
    for what, leaves in (("grad step", D.leaves(g_nee)),
                         ("render_vjp", D.leaves(g)),
                         ("material_grads", list(g_m.values()))):
        if not all(bool(torch.isfinite(t).all()) for t in leaves):
            raise RuntimeError(f"{what}: a gradient is not finite")
    want, _ = ptt.pathtrace_batch(cornell, 1, 1, nee=True)
    want_m, _ = ptt.pathtrace_batch(cornell, 1, 1)
    if not (torch.equal(rad, want) and torch.equal(rad_m, want_m)):
        raise RuntimeError("the gradients' radiance is not K1's")
    if float(g_nee["translation"].abs().max()) == 0.0:
        raise RuntimeError("the NEE grad step gave no geometry gradient")
    for what in ("64x64 d8 8spp", "24x24 d2 2spp"):
        err = errors[what]
        if not err[-1] < err[0]:
            raise RuntimeError(f"inverse_light {what}: the position error "
                               f"went from {err[0]} to {err[-1]}")
    return launches


def linear_vs_k3(ptt, K, torch, label, scene, bvh_scene, nee, rr):
    """K3-linear's image against K3's on the same configuration with its
    BVH, 1 spp: the same winners but for ties (the tie-flip bound; the
    pixels off by more than 1e-3 are counted)."""
    rad, counts = ptt.pathtrace_batch(scene, 1, 1, nee=nee, rr=rr)
    want, want_counts = ptt.pathtrace_batch(bvh_scene, 1, 1, nee=nee, rr=rr)
    counts, want_counts = counts[0], want_counts[0]
    diff = (rad - want).abs().amax(-1)
    share = float((diff > 1e-3).float().mean())
    print(f"k3_linear vs k3 {label} {scene.resolution[0]}x"
          f"{scene.resolution[1]}: {int((diff > 1e-3).sum())} pixels off by "
          f"more than 1e-3 (share {share:.6f}), exact "
          f"{float((diff == 0).float().mean()):.6f}, counts {counts.tolist()}"
          f" K3 {want_counts.tolist()}", flush=True)
    if share >= TIE_SHARE:
        raise RuntimeError(f"{label}: K3-linear's winners are not K3's")
    for a, b in zip(counts.tolist(), want_counts.tolist()):
        if abs(a - b) > COUNT_RTOL * max(b, 1):
            raise RuntimeError(f"{label}: counts {counts} vs K3's")


def mesh_rig_phase(ptt, GC, torch):
    """``render_vjp`` on the mesh rig of the reference's
    ``tests/test_vjp_kernel.py`` (``tests/torch_scenes.mesh_rig``), with
    and without NEE, on K8 against the same entry point on K8's plain
    version (:func:`held`)."""
    from pathtrace_tpu_torch.render import diff as D
    from torch_scenes import mesh_rig

    rig = mesh_rig()
    ct = torch.rand((rig.pixel_count, 3),
                    generator=torch.Generator().manual_seed(9))
    for nee in (False, True):
        rad, g = ptt.render_vjp(rig, ct, 1, 1, nee=nee)
        rad_p, w = ptt.render_vjp(rig, ct, 1, 1, nee=nee, plain=True)
        print(f"mesh rig {rig.resolution} d{rig.trace_depth} nee {nee}: "
              f"radiance max |diff| {float((rad - rad_p).abs().max()):.3g}, "
              f"tri_verts {g['tri_verts']}", flush=True)
        if g["tri_verts"] is not None:
            raise RuntimeError("mesh rig: render_vjp gave tri_verts")
        held(GC, f"mesh rig nee {nee}", D.named_leaves(g),
             D.named_leaves(w), GC.K8_TOL, GC.FIREFLY_SHARE)


def mesh_grad_main_path(ptt, K, MG, VJ, torch, mesh):
    """The mesh gradients' main path (launch counts reset before and read
    after): ``render_vjp`` on cornell_mesh with NEE (a cotangent of ones,
    the grad step) and without, ``material_grads`` on it, and one step of
    ``render_loss_and_grad(engine="planes")`` (autograd over the plain
    trace, no kernel) on cornell_mesh at 48x48 d3 NEE 4 spp, whose
    ``tri_verts`` gradient must not be zero.  Returns the launches by
    kernel."""
    from pathtrace_tpu_torch.render import diff as D

    n_pix = mesh.pixel_count
    ct = torch.rand((n_pix, 3), generator=torch.Generator().manual_seed(11))
    small = dataclasses.replace(mesh, resolution=(48, 48), trace_depth=3)
    for counter in (K.LAUNCHES, MG.LAUNCHES, VJ.LAUNCHES):
        counter.clear()
    rad, g_nee = ptt.render_vjp(mesh, torch.ones((n_pix, 3)), 1, 1,
                                nee=True)
    _, g = ptt.render_vjp(mesh, ct, 1, 1)
    rad_m, g_m = ptt.material_grads(mesh, ct, 1, 1)
    t0 = time.perf_counter()
    loss, g_p = ptt.render_loss_and_grad(
        small, torch.zeros((small.pixel_count, 3)), 1, 4, nee=True,
        engine="planes")
    torch.cuda.synchronize()
    planes_ms = (time.perf_counter() - t0) * 1e3
    launches = {f"{K8}+k3_mesh": VJ.LAUNCHES[K.MESH_BIT],
                f"{K8}+k2_nee+k3_mesh": VJ.LAUNCHES[K.MESH_BIT | K.NEE_BIT],
                "k7_grads+k3_mesh": MG.LAUNCHES[K.MESH_BIT]}
    tv = float(g_p["tri_verts"].abs().max())
    print(f"mesh gradients' main path: launches {launches} (K1 "
          f"{dict(K.LAUNCHES)}); render_loss_and_grad planes 48x48 d3 NEE "
          f"4spp: loss {float(loss):.6g}, max |d tri_verts| {tv:.6g}, "
          f"{planes_ms:.1f} ms (host clock)", flush=True)
    if not all(launches.values()) or K.LAUNCHES:
        raise RuntimeError(f"the mesh gradients' main path: launches "
                           f"{launches}, K1 {dict(K.LAUNCHES)}")
    if not tv > 0.0:
        raise RuntimeError("the planes engine gave no tri_verts gradient")
    for what, grads in (("grad step", g_nee), ("render_vjp", g)):
        if grads["tri_verts"] is not None:
            raise RuntimeError(f"{what}: tri_verts is not None on a mesh")
        if not all(bool(torch.isfinite(t).all()) for t in D.leaves(grads)):
            raise RuntimeError(f"{what}: a gradient is not finite")
    if not all(bool(torch.isfinite(t).all()) for t in g_m.values()):
        raise RuntimeError("material_grads: a gradient is not finite")
    want, _ = ptt.pathtrace_batch(mesh, 1, 1, nee=True)
    want_m, _ = ptt.pathtrace_batch(mesh, 1, 1)
    if not (torch.equal(rad, want) and torch.equal(rad_m, want_m)):
        raise RuntimeError("the mesh gradients' radiance is not K1's")
    if float(g_nee["translation"].abs().max()) == 0.0:
        raise RuntimeError("the mesh grad step gave no geometry gradient")
    return launches


def time_k8(K, VJ, B, torch, label, name, job, nee, card):
    """K8's time on ``job`` beside K1's on the same tables, 1 spp a call,
    with its bound (K1's counted work plus ``bound.k8_extra``, the
    sections' adjoints on the lanes the plain version tallies).  Returns
    (ms, bound ms, bound by)."""
    width, height = job["width"], job["height"]
    n_pix = width * height
    ones = torch.ones((n_pix, 3), device="cuda")
    ms_k8, runs_k8, (_, tabs) = median_ms(
        lambda: VJ.trace_k8(job, 1, 1, ones), torch, 9)
    ms_k1, runs_k1, (_, counts) = median_ms(
        lambda: K.trace_k1(job, 1, 1), torch, 9)
    ops, n_bytes, tallies = forward_work(K, B, torch, label, job)
    if not nee:
        tallies = {}
    extra_ops, extra_bytes = B.k8_extra(
        counts.tolist(), n_pix, sum(t.numel() for t in tabs), nee,
        mesh=bool(job["bvh_meta"]), sss=job["features"][6], tallies=tallies)
    bound_ms, bound_by = B.bound(ops + extra_ops, n_bytes + extra_bytes)
    print(f"time {name} {label} {width}x{height} d{job['depth']} 1spp: "
          f"kernel median {ms_k8:.4f} ms (runs "
          f"{[round(t, 4) for t in runs_k8]}), K1 on the same tables "
          f"{ms_k1:.4f} ms (runs {[round(t, 4) for t in runs_k1]}) on {card};"
          f" bound {bound_ms:.4f} ms by {bound_by} ({ops:.4g} ops of K1's "
          f"count + {extra_ops:.4g}, the sections' lanes {tallies}; "
          f"{n_bytes + extra_bytes} bytes, of which {extra_bytes} K8's "
          f"own); kernel at {bound_ms / ms_k8:.2%} of it; library call: "
          f"none", flush=True)
    return ms_k8, bound_ms, bound_by


def k8_name(K, mask):
    """The kernels line's name of K8's build of ``mask``."""
    return kernel_name(K, mask).replace("k1_trace", K8)


def section_grad_main_path(ptt, K, VJ, torch, scenes):
    """K8's section builds on the gradients' main path, launch counts reset
    before and read after: the sections' grad step (``render_vjp`` on
    cornell_glass 800x800 d8, NEE, a cotangent of ones, 1 spp), which must
    launch K8 (mask 135) once and give K1's radiance, then ``render_vjp``
    with and without NEE on each configuration of ``K8_SECTION_CONFIGS``
    at its own size (``scenes``: label -> scene).  Returns the launches by
    kernel name."""
    from pathtrace_tpu_torch.render import diff as D

    glass = scenes["cornell_glass"]
    VJ.LAUNCHES.clear()
    K.LAUNCHES.clear()
    rad, g = ptt.render_vjp(glass, torch.ones((glass.pixel_count, 3)), 1,
                            1, nee=True)
    torch.cuda.synchronize()
    step = dict(VJ.LAUNCHES)
    mask = K.scene_mask(glass, True)
    print(f"sections' grad step cornell_glass 800x800 d8 NEE: launches "
          f"{step}; |d aperture| {float(g['camera'].aperture.abs()):.6g}, "
          f"|d focal_dist| {float(g['camera'].focal_dist.abs()):.6g}, max "
          f"|d ior| {float(g['materials'].ior.abs().max()):.6g}, max "
          f"|d spec_exponent| "
          f"{float(g['materials'].spec_exponent.abs().max()):.6g}",
          flush=True)
    if step != {mask: 1} or K.LAUNCHES:
        raise RuntimeError(f"the sections' grad step: K8 launches {step}, "
                           f"K1 {dict(K.LAUNCHES)}")
    want, _ = ptt.pathtrace_batch(glass, 1, 1, nee=True)
    K.LAUNCHES.clear()
    if not torch.equal(rad, want):
        raise RuntimeError("the sections' grad step: its radiance is not "
                           "K1's")
    if not all(float(x.abs().max()) > 0 for x in (
            g["camera"].aperture, g["camera"].focal_dist,
            g["materials"].ior, g["materials"].spec_exponent)):
        raise RuntimeError("the sections' grad step: a section's own "
                           "gradient is zero")
    grads = [("grad step", glass, g)]
    for label, *_ in K8_SECTION_CONFIGS:
        scene = scenes[label]
        ct = torch.rand((scene.pixel_count, 3),
                        generator=torch.Generator().manual_seed(13))
        for nee in (False, True):
            grads.append((f"{label} NEE {nee}", scene,
                          ptt.render_vjp(scene, ct, 1, 1, nee=nee)[1]))
    torch.cuda.synchronize()
    launches = {k8_name(K, m): n for m, n in VJ.LAUNCHES.items()}
    print(f"sections' gradients' main path: launches {launches} (K1 "
          f"{dict(K.LAUNCHES)})", flush=True)
    for what, scene, gr in grads:
        if scene.mesh.count and gr["tri_verts"] is not None:
            raise RuntimeError(f"{what}: tri_verts is not None on a mesh")
        if not all(bool(torch.isfinite(t).all()) for t in D.leaves(gr)):
            raise RuntimeError(f"{what}: a gradient is not finite")
    want = {k8_name(K, K.scene_mask(scenes[label], nee))
            for label, *_ in K8_SECTION_CONFIGS for nee in (False, True)}
    if K.LAUNCHES or set(launches) != want:
        raise RuntimeError(f"the sections' gradients' main path: launches "
                           f"{launches}, K1 {dict(K.LAUNCHES)}")
    return launches


def time_k7(K, MG, B, torch, label, name, k7_job, card):
    """K7's time on ``k7_job`` (``k7_vs_plain``'s job, material table and
    geoms' materials), 1 spp a call, with its bound.  Returns (ms, bound
    ms, bound by)."""
    job, mtab, mat_of = k7_job
    n_pix = job["width"] * job["height"]
    ct = torch.rand((n_pix, 3), device="cuda")
    ms_k7, runs_k7, (_, counts, _) = median_ms(
        lambda: MG.trace_k7(job, mtab, mat_of, ct, 1, 1), torch, 9)
    # K1's same build at 1 spp a call: K7 / K1 is the fold's own cost
    ms_k1, runs_k1, _ = median_ms(
        lambda: K.trace_k1(job, 1, 1), torch, 9)
    ops, n_bytes, _ = forward_work(K, B, torch, label, job)
    extra_ops, extra_bytes = B.k7_extra(counts.tolist(), n_pix,
                                        mtab.shape[0])
    bound_ms, bound_by = B.bound(ops + extra_ops, n_bytes + extra_bytes)
    print(f"time {name} {label} {job['width']}x{job['height']} "
          f"d{job['depth']} 1spp: kernel median {ms_k7:.4f} ms (runs "
          f"{[round(t, 4) for t in runs_k7]}) on {card}; bound "
          f"{bound_ms:.4f} ms by {bound_by} ({ops:.4g} ops of K1's count + "
          f"{extra_ops:.4g} of the fold; {n_bytes + extra_bytes} bytes); "
          f"kernel at {bound_ms / ms_k7:.2%} of it; library call: none; "
          f"K1 at 1 spp a call {ms_k1:.4f} ms (runs "
          f"{[round(t, 4) for t in runs_k1]}), K7 / K1 {ms_k7 / ms_k1:.3f}",
          flush=True)
    return ms_k7, bound_ms, bound_by


def forward_work(K, B, torch, label, job):
    """(ops, bytes, the lanes of K8's section adjoints) of one sample of
    K1 on ``job``: the count made by time_variant for ``label`` at this
    size, or made here (``bound.count_work`` and its tallies)."""
    key = (label, job["width"], job["height"])
    if key not in WORK:
        tallies = {}
        _, ops_by, bytes_by = B.count_work(
            lambda: K.trace_plain(**job, it0=1, n_spp=1), tallies)
        WORK[key] = (ops_by, bytes_by, small_table_bytes(torch, job),
                     tallies)
    ops_by, bytes_by, table_bytes, tallies = WORK[key]
    return (sum(ops_by.values()),
            table_bytes + sum(bytes_by.values())
            + 12 * job["width"] * job["height"], tallies)


def time_gradients(ptt, K, MG, VJ, B, torch, cornell, card, k7_job):
    """The grad step's time, and K8's (without and with NEE) and K7's
    beside K1's on the same tables, with their bounds.  Returns {kernel:
    (ms, bound ms, bound by)}."""
    n_pix = cornell.pixel_count
    ones = torch.ones((n_pix, 3), device="cuda")
    ms, runs, _ = median_ms(
        lambda: ptt.render_vjp(cornell, ones, 1, 1, nee=True), torch, 5)
    print(f"time grad step cornell 800x800 d8 NEE 1spp (render_vjp, the "
          f"packing and its backward on the host included): median "
          f"{ms:.4f} ms (runs {[round(t, 4) for t in runs]}) on {card}",
          flush=True)
    out = {name: time_k8(K, VJ, B, torch, label, name,
                         K.prepare(cornell, "cuda", nee=nee), nee, card)
           for name, label, nee in ((K8, "cornell", False),
                                    (f"{K8}+k2_nee", "cornell NEE", True))}
    out["k7_grads"] = time_k7(K, MG, B, torch, "cornell", "k7_grads", k7_job,
                              card)
    return out


def _flip_share(torch, rad, ref):
    """(share of pixels off by more than 1e-3, max abs error, share of
    bit-equal pixels)."""
    d = (rad - ref).abs().amax(dim=-1)
    return (float((d > 1e-3).float().mean()), float(d.max()),
            float((d == 0).float().mean()))


def wavefront_holds(K, SC, I, torch, label, scene, nee):
    """The wavefront's main path (``render.integrator.pathtrace_batch``,
    1 spp, launch counts reset before and read after) with
    ``compaction="mask"`` and ``"sort"``: sort bit-equal to mask, K6
    launched depth times in sort mode and never in mask mode, no K1;
    then both within the tie bound of K1 on the same sample, counts as
    ``compare``'s.  Returns the K6 launches."""
    width, height = scene.resolution
    depth, n_pix = scene.trace_depth, width * height
    out, k6 = {}, 0
    for compaction in ("mask", "sort"):
        SC.LAUNCHES.clear()
        K.LAUNCHES.clear()
        rad, counts = I.pathtrace_batch(scene, 1, 1, compaction, remat=False,
                                        nee=nee, device="cuda")
        torch.cuda.synchronize()
        n6, n1 = SC.LAUNCHES["k6_scan"], sum(K.LAUNCHES.values())
        want = depth if compaction == "sort" else 0
        if n6 != want or n1:
            raise RuntimeError(f"wavefront {label} {compaction}: K6 launched "
                               f"{n6} times (want {want}), K1 {n1}")
        if rad.shape != (n_pix, 3) or not bool(torch.isfinite(rad).all()):
            raise RuntimeError(f"wavefront {label}: bad radiance")
        out[compaction] = rad, counts
        k6 += n6
    if not (torch.equal(out["sort"][0], out["mask"][0])
            and torch.equal(out["sort"][1], out["mask"][1])):
        raise RuntimeError(f"wavefront {label}: sort is not mask's bits")
    job = K.prepare(scene, "cuda", nee=nee)
    ref, ref_counts = K.trace_k1(job, 1, 1, per_sample=True)
    rad, counts = out["mask"]
    share, err, exact = _flip_share(torch, rad, ref)
    counts, ref_counts = counts[0].tolist(), ref_counts[0].tolist()
    print(f"wavefront {label} {width}x{height} d{depth} 1spp: sort == mask "
          f"bit for bit, K6 launches {k6} (sort), against K1: share>1e-3 "
          f"{share:.6f} max_abs_err {err:.3g} exact {exact:.6f} counts "
          f"wavefront {counts} K1 {ref_counts}", flush=True)
    if share >= TIE_SHARE:
        raise RuntimeError(f"wavefront {label}: {share:.4%} of pixels "
                           f"differ > 1e-3 from K1")
    if counts[0] != n_pix or ref_counts[0] != n_pix:
        raise RuntimeError(f"wavefront {label}: bounce-0 count is not "
                           f"{n_pix}")
    for d, (a, b) in enumerate(zip(counts, ref_counts)):
        if abs(a - b) > COUNT_RTOL * max(b, 1):
            raise RuntimeError(f"wavefront {label}: bounce {d} count {a} "
                               f"vs {b}")
    return k6


def densify_hold(SC, I, torch, scene):
    """K6 as the wavefront's densify runs it, on one bounce's live mask
    (cornell 800x800: 640,000 rays after bounce 0): the permutation
    equal to ``torch.argsort(~live, stable=True)``.  Returns the live
    count."""
    res = I.resident(scene, "cuda")
    n = res.pixel_count
    pix = torch.arange(n, device="cuda")
    o, d = I.raygen(res.camera, res.width, res.height, 1, pix)
    ones = torch.ones((n, 3), device="cuda")
    state = dict(origins=o, dirs=d, throughput=ones, radiance=0 * ones,
                 pixel=pix, live=torch.ones(n, dtype=torch.bool,
                                            device="cuda"))
    live = I._bounce(res, I._tables(res), 1, 0, state)["live"]
    SC.LAUNCHES.clear()
    perm, n_live = SC.compact_indices(live)
    dense = I._densify(dict(live=live, pixel=pix))
    torch.cuda.synchronize()
    want = torch.argsort(~live, stable=True)
    if not (torch.equal(perm.long(), want) and torch.equal(dense["pixel"],
                                                           want)):
        raise RuntimeError("K6's densify permutation is not the stable "
                           "argsort of the dead flag")
    if SC.LAUNCHES["k6_scan"] != 2 or int(n_live) != int(live.sum()):
        raise RuntimeError(f"densify: K6 launches {dict(SC.LAUNCHES)}, "
                           f"n_live {int(n_live)}")
    print(f"densify cornell {res.width}x{res.height}, {n} rays after "
          f"bounce 0: {int(n_live)} live; K6's "
          f"permutation equals torch.argsort(~live, stable=True)",
          flush=True)
    return int(n_live)


def wavefront_grads(ptt, K, torch, np, cornell, card):
    """``render_loss_and_grad(engine="wavefront")`` against
    ``engine="planes"`` on the card, cornell 128x128 d4 NEE 2 spp, each
    engine's target its own image on the pixels where the two images
    part (tie flips), zero elsewhere, so that those pixels add to
    neither gradient: the material leaves at rtol 2e-3 / atol 2e-5, every
    other leaf's largest difference printed; then one wavefront grad step
    at 800x800 d8 1 spp (each bounce recomputed in the backward pass, the
    default), its ms and peak memory."""
    from pathtrace_tpu_torch.render import diff as D

    scene = dataclasses.replace(cornell, resolution=(128, 128),
                                trace_depth=4)
    imgs = {e: D.render_mean(scene, 1, 2, nee=True, engine=e,
                             device="cuda") for e in ("wavefront", "planes")}
    flip = (imgs["wavefront"] - imgs["planes"]).abs().amax(dim=-1) > 1e-3
    out = {}
    for e, img in imgs.items():
        tgt = torch.where(flip[:, None], img, 0.0)
        out[e] = D.render_loss_and_grad(scene, tgt, 1, 2, nee=True,
                                        engine=e, device="cuda")
    (lw, gw), (lp, gp) = out["wavefront"], out["planes"]
    print(f"wavefront grads cornell 128x128 d4 NEE 2spp: {int(flip.sum())} "
          f"pixels flip between the engines; loss wavefront {float(lw):.7g} "
          f"planes {float(lp):.7g}", flush=True)
    for (name, a), (_, b) in zip(D.named_leaves(gw), D.named_leaves(gp)):
        a, b = a.detach().cpu().numpy(), b.detach().cpu().numpy()
        worst = float(np.abs(a - b).max()) if a.size else 0.0
        lim = (2e-5 + 2e-3 * np.abs(b))
        ratio = float((np.abs(a - b) / lim).max()) if a.size else 0.0
        print(f"  {name}: max |diff| {worst:.3g}, max |planes| "
              f"{float(np.abs(b).max()) if b.size else 0:.3g}, worst share of "
              f"the tolerance {ratio:.3g}", flush=True)
        if name.startswith("materials.") and not (
                np.isfinite(a).all() and ratio <= 1.0):
            raise RuntimeError(f"wavefront grads: {name} off planes' by "
                               f"{worst:.3g}")
    if not float(gw["materials"].color.abs().max()) > 0:
        raise RuntimeError("wavefront grads: zero albedo gradient")

    tgt = np.zeros((cornell.pixel_count, 3), np.float32)
    step = lambda: D.render_loss_and_grad(  # noqa: E731
        cornell, tgt, 1, 1, engine="wavefront", device="cuda")
    step()
    times = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, g = step()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not (np.isfinite(float(loss)) and all(
            bool(torch.isfinite(v).all()) for v in D.leaves(g))):
        raise RuntimeError("wavefront grad step: not finite")
    print(f"wavefront grad step cornell {cornell.width}x{cornell.height} "
          f"d{cornell.trace_depth} 1spp (remat): median "
          f"{statistics.median(times):.1f} ms (runs "
          f"{[round(t, 1) for t in times]}; host clock around a "
          f"synchronize), peak memory {peak:.2f} GiB on {card}", flush=True)


def device_ms_of(torch, fn, name, calls=2):
    """(the device time of ``fn``'s kernels whose name holds ``name``, of
    all its kernels), ms a call, from one ``torch.profiler`` window after
    a warm call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    times = [(e.key, getattr(e, "device_time_total", 0)
              or getattr(e, "cuda_time_total", 0))
             for e in prof.key_averages()]
    return (sum(t for k, t in times if name in k) / calls / 1e3,
            sum(t for _, t in times) / calls / 1e3)


def time_wavefront(K, I, torch, cornell, card):
    """The wavefront's ms/iter on cornell 800x800 d8, mask and sort, with
    and without NEE (warm, scene resident, CUDA events, median of 5 calls
    of 1 spp), K1's on the same scene beside it (8 spp a call), and K6's
    share of a sort iteration (its device time over the iteration's,
    ``torch.profiler``)."""
    res = I.resident(cornell, "cuda")
    for nee in (False, True):
        job = K.prepare(cornell, "cuda", nee=nee)
        k1, runs_k1, _ = median_ms(
            lambda: K.trace_k1(job, 1, SPP_PER_CALL), torch, 5)
        line = []
        for compaction in ("mask", "sort"):
            run = lambda: I.pathtrace_batch(  # noqa: E731
                res, 1, 1, compaction, remat=False, nee=nee, device="cuda")
            ms, runs, _ = median_ms(run, torch, 5)
            line.append(f"{compaction} {ms:.4f} (runs "
                        f"{[round(t, 3) for t in runs]})")
            if compaction == "sort":
                k6, dev = device_ms_of(torch, run, "k6_scan")
                line.append(f"K6 {k6:.5f} ms on the device a sort "
                            f"iteration = {k6 / ms:.3%} of it ({k6 / dev:.3%}"
                            f" of its device time {dev:.4f} ms)")
        print(f"time wavefront cornell {cornell.width}x{cornell.height} "
              f"d{cornell.trace_depth}{' NEE' if nee else ''} ms/iter: "
              f"{'; '.join(line)}; K1 {k1 / SPP_PER_CALL:.4f} (runs "
              f"{[round(t / SPP_PER_CALL, 4) for t in runs_k1]}) on {card}",
              flush=True)


def wavefront_phase(ptt, K, SC, torch, np, scenes, card):
    """The wavefront integrator on the card: holds, the CLI, gradients,
    times.  Returns the K6 launches of its main path."""
    from pathtrace_tpu_torch.render import integrator as I

    cornell, mesh = scenes["cornell"][0], scenes["cornell_mesh"][0]
    k6 = 0
    for label, scene, nee in (("cornell", cornell, False),
                              ("cornell NEE", cornell, True),
                              ("cornell_mesh", mesh, False),
                              ("cornell_mesh NEE", mesh, True)):
        k6 += wavefront_holds(K, SC, I, torch, label, scene, nee)
        phase_done(f"wavefront {label}")
    densify_hold(SC, I, torch, cornell)
    for flags in (["--engine", "xla", "--compaction", "sort"],
                  ["--engine", "planes"]):
        SC.LAUNCHES.clear()
        launches = cli_main_path(K, np, "cornell.txt", flags, spp=8)
        n6 = SC.LAUNCHES["k6_scan"]
        if launches or n6 != (8 * cornell.trace_depth if "xla" in flags
                              else 0):
            raise RuntimeError(f"the CLI with {flags}: K1 {launches}, K6 "
                               f"{n6}")
        k6 += n6
        phase_done(f"cli {' '.join(flags)}")
    wavefront_grads(ptt, K, torch, np, cornell, card)
    phase_done("wavefront gradients")
    time_wavefront(K, I, torch, cornell, card)
    phase_done("time wavefront")
    return k6


def _add(total, counts):
    for key, n in counts.items():
        total[key] = total.get(key, 0) + n


def progressive_main_path(np, torch, cornell, work, spy):
    """Phase 19's CLI holds on cornell 800x800 d8, 16 spp in chunks of 8
    (K1): a resume from a checkpoint at 8 bit-equal to the render that
    never stopped; the preview PNG; a camera key sent as the first
    preview is written (mid-render) gives the image of a fresh render
    with the moved camera.  ``spy`` records what the CLI displays and
    runs its hook at a preview.  Returns the moved scene's image."""
    from PIL import Image

    from pathtrace_tpu_torch import cli
    from pathtrace_tpu_torch.render import interact

    def run(*flags):
        spy["shown"].clear()
        rc = cli.main([os.path.join(HERE, "scenes", "cornell.txt"), "--res",
                       str(cornell.width), str(cornell.height), "--depth",
                       str(cornell.trace_depth), "--spp", "16", "--chunk",
                       "8", "--out", os.path.join(work, "c.png"), *flags])
        if rc != 0:
            raise RuntimeError(f"the CLI with {flags} returned {rc}")
        return spy["shown"][-1]

    whole = run("--checkpoint", os.path.join(work, "a.ckpt"),
                "--checkpoint-every", "8", "--preview-every", "8")
    preview = cli.preview_path(cornell.image_name)
    img = np.asarray(Image.open(preview))
    if img.shape != (cornell.height, cornell.width, 3):
        raise RuntimeError(f"preview {preview}: shape {img.shape}")
    part = os.path.join(work, "b.ckpt")
    run("--spp", "8", "--checkpoint", part, "--checkpoint-every", "8")
    resumed = run("--checkpoint", part, "--resume")
    if not np.array_equal(resumed, whole):
        raise RuntimeError("the resumed render is not the uninterrupted "
                           "render's bits")
    ctrl = os.path.join(work, "cam.ctrl")
    spy["hook"] = lambda: interact.send_key(ctrl, "left")
    moved = run("--preview-every", "8", "--interactive", ctrl)
    print(f"phase 19 cli cornell {cornell.width}x{cornell.height} "
          f"d{cornell.trace_depth} 16spp: resumed at 8 bit-equal to the "
          f"uninterrupted render; preview {img.shape} decodes", flush=True)
    return moved


def texel_gradients(K, I, D, torch, np, tex, card):
    """Texel gradients on cornell_tex (800x800 d8, 1 spp, NEE; the map of
    material 5) through the planes engine and the wavefront: d of the
    mean of the image over the pixels where the two forwards agree to
    1e-4 (a hit or a lobe that flips between the engines adds to neither;
    the mask from forwards without autograd), then each engine's forward
    and backward alone, timed, with its peak memory above what was
    allocated before it, its graph freed before the next one starts; not
    zero, planes against wavefront at rtol 1e-3 / atol 1e-7."""
    tid = tex.texture_ids[5]
    leaf = torch.tensor(np.asarray(tex.textures[tid]), device="cuda",
                        requires_grad=True)
    scene = dataclasses.replace(tex, textures=tuple(
        leaf if i == tid else t for i, t in enumerate(tex.textures)))
    engines = (("planes", D.planes_iteration),
               ("wavefront", I.pathtrace_iteration))
    with torch.no_grad():
        rad = {name: fn(scene, 1, nee=True, device="cuda")[0]
               for name, fn in engines}
    agree = ((rad["planes"] - rad["wavefront"]).abs().amax(dim=-1)
             < 1e-4).to(torch.float32)[:, None]
    del rad
    grads, stats = {}, {}
    for name, fn in engines:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn(scene, 1, nee=True, device="cuda")[0]
        torch.cuda.synchronize()
        forward = 1e3 * (time.perf_counter() - t0)
        (out * agree).mean().backward()
        torch.cuda.synchronize()
        step = 1e3 * (time.perf_counter() - t0)
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        grads[name] = leaf.grad.clone()
        leaf.grad = None
        del out
        stats[name] = (step, forward, peak)
    g_p, g_w = grads["planes"], grads["wavefront"]
    worst = float(((g_p - g_w).abs() / (1e-7 + 1e-3 * g_w.abs())).max())
    print(f"texel gradients cornell_tex {tex.width}x{tex.height} "
          f"d{tex.trace_depth} 1spp NEE, map {tuple(leaf.shape)}: "
          f"{int((1 - agree).sum())} pixels flip between the engines; "
          f"sum |g| planes {float(g_p.abs().sum()):.6g} wavefront "
          f"{float(g_w.abs().sum()):.6g}; max |diff| "
          f"{float((g_p - g_w).abs().max()):.3g}, worst share of rtol 1e-3 "
          f"/ atol 1e-7 {worst:.3g}; step (forward + backward, host clock "
          f"around a synchronize) planes {stats['planes'][0]:.1f} ms "
          f"(forward {stats['planes'][1]:.1f}), peak "
          f"{stats['planes'][2]:.2f} GiB, wavefront "
          f"{stats['wavefront'][0]:.1f} ms (forward "
          f"{stats['wavefront'][1]:.1f}), peak "
          f"{stats['wavefront'][2]:.2f} GiB on {card}", flush=True)
    if not (bool(torch.isfinite(g_p).all()) and float(g_p.abs().sum()) > 0):
        raise RuntimeError("texel gradients: zero or not finite")
    if worst > 1.0:
        raise RuntimeError("texel gradients: planes off the wavefront's")


def busy_share_child(work, width, height):
    """The child of :func:`busy_share`, ``python3 chip_smoke.py
    --busy-share <dir> <width> <height>``: a 64-spp CLI loop on cornell
    (chunks of 8, K1) under ``utils.profiling.trace`` in a process of its
    own, whose profiler has seen no earlier window, after one loop
    without it (the cold one, which loads the kernel).  Prints, as its
    last line, a JSON object: the card's busy ms (the profiler's device
    records merged, ``profiling.device_busy``), the first record's start
    to the last one's end, the K1 launches and the K1 records the profiler
    holds, the copies' records and ms, the loop's ms on the host clock
    (the first K1 launch to the image's display), the call's, and the
    cold loop's."""
    import torch

    from pathtrace_tpu_torch import cli
    from pathtrace_tpu_torch.io import image_io
    from pathtrace_tpu_torch.ops.cuda import megakernel as K
    from pathtrace_tpu_torch.utils import profiling

    stamps = {}
    trace_k1, to_display = K.trace_k1, image_io.to_display

    def stamp_k1(*args, **kwargs):
        stamps.setdefault("k1", time.perf_counter())
        return trace_k1(*args, **kwargs)

    def stamp_display(*args):
        stamps["display"] = time.perf_counter()
        return to_display(*args)

    K.trace_k1, image_io.to_display = stamp_k1, stamp_display
    argv = [os.path.join(HERE, "scenes", "cornell.txt"), "--res", str(width),
            str(height), "--spp", "64", "--out",
            os.path.join(work, "busy.png")]
    # the first loop of the process, without the profiler: it loads the
    # library and the kernel's module
    rc = cli.main(argv)
    cold = 1e3 * (stamps.pop("display") - stamps.pop("k1"))
    K.LAUNCHES.clear()
    with profiling.trace(os.path.join(work, "trace")) as prof:
        t0 = time.perf_counter()
        rc = rc or cli.main(argv)
        call = 1e3 * (time.perf_counter() - t0)
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    k1 = [e for e in device if "k1_trace" in e.name]
    copies = [e for e in device if "memcpy" in e.name.lower()]
    busy, span = profiling.device_busy(prof)
    print(json.dumps({
        "rc": rc, "busy_ms": busy / 1e3, "span_ms": span / 1e3,
        "k1_launches": sum(K.LAUNCHES.values()), "k1_records": len(k1),
        "k1_ms": sum(e.time_range.end - e.time_range.start
                     for e in k1) / 1e3,
        "copy_records": len(copies),
        "copy_ms": sum(e.time_range.end - e.time_range.start
                       for e in copies) / 1e3,
        "loop_ms": 1e3 * (stamps["display"] - stamps["k1"]),
        "call_ms": call, "cold_loop_ms": cold}), flush=True)
    return rc


def busy_share(cornell, work, card):
    """The card's busy share over a warm 64-spp CLI loop on cornell
    800x800 (8 K1 launches) under ``utils.profiling.trace``, measured in a
    fresh process (:func:`busy_share_child`; in this one, after the earlier
    phases' profiler windows, the profiler kept one of the loop's 8 K1
    records): the device records it holds, merged, over the loop's host
    time and over the call's.  A profile that lacks a K1 record gives no
    share ("not measured").  Returns the child's K1 launches."""
    out = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--busy-share", work,
         str(cornell.width), str(cornell.height)],
        capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise RuntimeError(f"the busy-share process exited "
                           f"{out.returncode}: {out.stderr[-2000:]}")
    r = json.loads(out.stdout.strip().splitlines()[-1])
    whole = r["k1_records"] == r["k1_launches"]
    share = (f"{r['busy_ms'] / r['loop_ms']:.4%} of the loop's "
             f"{r['loop_ms']:.1f} ms, {r['busy_ms'] / r['call_ms']:.4%} of "
             f"the call's {r['call_ms']:.1f} ms (the process's first, cold "
             f"loop {r['cold_loop_ms']:.1f} ms)" if whole else
             f"not measured: the profiler holds {r['k1_records']} of "
             f"{r['k1_launches']} K1 launches")
    print(f"phase 19 busy share, cli cornell {cornell.width}x"
          f"{cornell.height} d{cornell.trace_depth} 64spp under "
          f"utils.profiling.trace in a fresh process: the card busy "
          f"{r['busy_ms']:.3f} ms by the profiler's device records merged "
          f"(K1 {r['k1_records']} records, {r['k1_ms']:.3f} ms; copies "
          f"{r['copy_records']} records, {r['copy_ms']:.3f} ms; the first "
          f"record's start to the last one's end {r['span_ms']:.3f} ms): "
          f"{share} on {card}", flush=True)
    if r["k1_launches"] != 8 or not r["busy_ms"] > 0:
        raise RuntimeError(f"the profiled loop: {r['k1_launches']} K1 "
                           f"launches, {r['busy_ms']} ms busy")
    return r["k1_launches"]


def progressive_phase(ptt, K, MG, torch, np, scenes, card):
    """Phase 19, the progressive render and the texel gradients.  The
    main path, the launch counts reset before and read after: the CLI
    with checkpoints, resume, previews and the interactive camera on K1
    (:func:`progressive_main_path`), ``inverse_albedo``
    (K1, K7) at the example's 800x800 50 spp and ``inverse_mesh`` at its
    48x48 d3 (the planes engine), each step's ms; then the holds: the
    camera key's image against a fresh render, the losses, the planes
    engine's float-texel forward on cornell_tex against K1 (tie bound),
    :func:`texel_gradients`; between them, :func:`busy_share` in a
    process of its own.  Returns the main path's launches (K1's by mask,
    K7's)."""
    from pathtrace_tpu_torch.io import image_io
    from pathtrace_tpu_torch.render import diff as D
    from pathtrace_tpu_torch.render import integrator as I
    from pathtrace_tpu_torch.render import interact, inverse
    from pathtrace_tpu_torch.utils import checkpoint as ckpt

    cornell, tex = scenes["cornell"][0], scenes["cornell_tex"][0]
    spy = {"shown": [], "hook": None, "saves": []}
    to_display, save_png, save = (image_io.to_display, image_io.save_png,
                                  ckpt.save)

    def spy_display(accum, *args):
        spy["shown"].append(np.array(accum))
        return to_display(accum, *args)

    def spy_png(path, img):
        save_png(path, img)
        if path.endswith(".preview.png") and spy["hook"] is not None:
            hook, spy["hook"] = spy["hook"], None
            hook()

    def timed_save(*args):
        t0 = time.perf_counter()
        save(*args)
        spy["saves"].append(1e3 * (time.perf_counter() - t0))

    k1, k7 = {}, 0
    old_tmp = tempfile.tempdir
    with tempfile.TemporaryDirectory() as work:
        tempfile.tempdir = work
        image_io.to_display, image_io.save_png = spy_display, spy_png
        ckpt.save = timed_save
        try:
            K.LAUNCHES.clear()
            moved_img = progressive_main_path(np, torch, cornell, work, spy)
            _add(k1, K.LAUNCHES)
            phase_done("19: cli")

            busy_share(cornell, work, card)
            phase_done("19: busy share")
        finally:
            image_io.to_display, image_io.save_png = to_display, save_png
            ckpt.save = save
            tempfile.tempdir = old_tmp

    stamps = [time.perf_counter()]
    K.LAUNCHES.clear()
    MG.LAUNCHES.clear()
    err0, err1 = inverse.inverse_albedo(
        cornell, steps=30, spp=50, device="cuda",
        callback=lambda *a: stamps.append(time.perf_counter()))
    _add(k1, K.LAUNCHES)
    k7 += MG.LAUNCHES[0]
    steps_ms = [round(1e3 * (b - a), 1) for a, b in zip(stamps, stamps[1:])]
    print(f"phase 19 inverse_albedo cornell {cornell.width}x{cornell.height} "
          f"d{cornell.trace_depth} 50spp 30 steps: error "
          f"{err0:.4f} -> {err1:.4f}; step ms {steps_ms} (the first holds "
          f"the target); K1 {dict(K.LAUNCHES)}, K7 {dict(MG.LAUNCHES)} on "
          f"{card}", flush=True)
    if not err1 < 0.7 * err0:
        raise RuntimeError("inverse_albedo: the error did not fall below "
                           "0.7x its start")
    phase_done("19: inverse_albedo")

    mesh = dataclasses.replace(
        ptt.load_scene(os.path.join(HERE, "scenes", "cornell_bumpmesh.txt")),
        resolution=(48, 48), trace_depth=3)
    stamps = [time.perf_counter()]
    loss0, loss1 = inverse.inverse_mesh(
        mesh, steps=MESH_STEPS, spp=4, device="cuda",
        callback=lambda *a: stamps.append(time.perf_counter()))
    steps_ms = [round(1e3 * (b - a), 1) for a, b in zip(stamps, stamps[1:])]
    print(f"phase 19 inverse_mesh cornell_bumpmesh {mesh.width}x{mesh.height} "
          f"d{mesh.trace_depth} 4spp {MESH_STEPS} steps: "
          f"loss {loss0:.6g} -> {loss1:.6g}; step ms {steps_ms} (the first "
          f"holds the target) on {card}", flush=True)
    if not loss1 < 0.8 * loss0:
        raise RuntimeError("inverse_mesh: the loss did not fall below 0.8x "
                           "its start")
    phase_done("19: inverse_mesh")

    moved = dataclasses.replace(cornell, camera=interact.apply_camera_motion(
        cornell.camera, *interact.KEY_MOTION["left"]))
    job = K.prepare(moved, "cuda")
    fresh = torch.zeros((moved.pixel_count, 3), device="cuda")
    for it0 in (1, 9):
        fresh += K.trace_k1(job, it0, 8)[0]
    if not np.array_equal(moved_img, fresh.cpu().numpy()):
        raise RuntimeError("the camera key's render is not a fresh render "
                           "of the moved camera")
    print(f"phase 19 interactive: a camera key mid-render gives the fresh "
          f"render of the moved camera, bit for bit; checkpoint saves of "
          f"the {cornell.width}x{cornell.height} accumulation "
          f"(np.savez_compressed, host clock) ms "
          f"{[round(t, 1) for t in spy['saves']]}", flush=True)

    k1_rad = K.trace_k1(K.prepare(tex, "cuda"), 1, 1)[0]
    planes_rad = K.trace_plain(**K.prepare(tex, "cuda", texels="f32"), it0=1,
                               n_spp=1)[0]
    share = float(((k1_rad - planes_rad).abs().amax(dim=-1) > 1e-3)
                  .float().mean())
    print(f"phase 19 planes float texels cornell_tex {tex.width}x{tex.height} "
          f"d{tex.trace_depth} 1spp against K1: share>1e-3 {share:.6f}",
          flush=True)
    if share >= TIE_SHARE:
        raise RuntimeError("the planes engine's float texels part from K1")
    texel_gradients(K, I, D, torch, np, tex, card)
    phase_done("19: texel gradients")
    return k1, k7


def _wall_ms(torch, fn, k=5):
    """Median over k calls of fn's time on the host clock, the card
    synchronized before and after each, after one warm call."""
    fn()
    times = []
    for _ in range(k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times), times


def shard_child(rank, world, store, out):
    """A process of phase 20 on ``cuda:0`` (``python3 chip_smoke.py
    --shard-rank RANK WORLD STORE OUT``).  Joins a gloo group of WORLD
    ranks through the file store STORE and runs the sharded routes, then
    times K1 sample-sharded and one ``all_reduce`` of the image; rank 0
    then runs a world of one on NCCL: K1 pixel- and sample-sharded, their
    time beside unsharded K1's, and one ``all_reduce``.  Saves the results
    to the .npz file OUT and the launches and times to OUT.json."""
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, HERE)
    import pathtrace_tpu_torch as ptt
    from pathtrace_tpu_torch.ops import scan as SC
    from pathtrace_tpu_torch.ops.cuda import megakernel as K
    from pathtrace_tpu_torch.ops.cuda import span as SP
    from pathtrace_tpu_torch.ops.cuda import vjp as VJ
    from pathtrace_tpu_torch.parallel import shard
    from pathtrace_tpu_torch.render import diff as D

    cornell = load(ptt, "cornell", ())
    small = dataclasses.replace(cornell, resolution=SHARD_SMALL)
    counters = dict(k1=K.LAUNCHES, k5=SP.LAUNCHES, k6=SC.LAUNCHES,
                    k8=VJ.LAUNCHES)
    n = SHARD_SPP
    arrays, info = {}, {}

    def main_path(group, routes):
        # the path's launches: the counts set to 0 before, read after
        for c in counters.values():
            c.clear()
        mesh = shard.make_mesh()
        info[f"{group} backend"] = dist.get_backend(mesh.group)
        for name, fn in routes:
            out = fn(mesh)
            if name.endswith("grad"):
                arrays[f"{name}.loss"] = out[0].cpu().numpy()
                for leaf, g in D.named_leaves(out[1]):
                    arrays[f"{name}.g.{leaf}"] = g.cpu().numpy()
            else:
                arrays[f"{name}.rad"] = out[0].cpu().numpy()
                arrays[f"{name}.counts"] = out[1].cpu().numpy()
        torch.cuda.synchronize()
        info[f"{group} launches"] = {k: {str(m): v for m, v in c.items()}
                                     for k, c in counters.items()}
        return mesh

    def times(group, mesh):
        run = shard.make_sharded_renderer(cornell, engine="pallas")
        info[f"{group} k1 ms"] = _wall_ms(torch, lambda: run(1, n))
        img = torch.ones((cornell.pixel_count, 3), device=mesh.device)
        info[f"{group} all_reduce ms"] = _wall_ms(
            torch, lambda: dist.all_reduce(img, group=mesh.group))

    zeros = np.zeros((cornell.pixel_count, 3), np.float32)
    shard.initialize_distributed("cuda", backend="gloo",
                                 store=dist.FileStore(store, world),
                                 rank=rank, world_size=world)
    mesh = main_path("gloo", [
        ("gloo pixel k1", lambda m: shard.render_pixel_sharded_pallas(
            cornell, 1, n, m)),
        ("gloo sample k1", lambda m: shard.render_sample_sharded_pallas(
            cornell, 1, n, m)),
        ("gloo sample sorted", lambda m: shard.render_sample_sharded_sorted(
            cornell, 1, n, m)),
        ("gloo sample planes", lambda m: shard.render_sample_sharded_planes(
            small, 1, 2, m)),
        ("gloo pixel planes", lambda m: shard.render_pixel_sharded_planes(
            small, 1, 2, m)),
        ("gloo sample wavefront", lambda m: shard.render_sample_sharded(
            small, 1, 2, m, "sort")),
        ("gloo pixel wavefront", lambda m: shard.render_pixel_sharded(
            small, 1, 2, m)),
        ("gloo grad", lambda m: shard.sharded_grad_step_pallas(
            cornell, zeros, 1, world, m, nee=True))])
    times("gloo", mesh)
    dist.destroy_process_group()
    if rank == 0:
        shard.initialize_distributed("cuda", store=dist.HashStore(), rank=0,
                                     world_size=1)
        mesh = main_path("nccl", [
            ("nccl pixel k1", lambda m: shard.render_pixel_sharded_pallas(
                cornell, 1, n, m)),
            ("nccl sample k1", lambda m: shard.render_sample_sharded_pallas(
                cornell, 1, n, m))])
        times("nccl", mesh)
        job = K.prepare(cornell, "cuda")
        info["unsharded k1 ms"] = _wall_ms(
            torch, lambda: K.trace_k1(job, 1, n))
        dist.destroy_process_group()
    np.savez(out, **arrays)
    with open(out + ".json", "w") as f:
        json.dump(info, f)
    return 0


def _hold_render(np, label, got, want, halves=None):
    """A sharded render ``got`` (radiance, counts) against one process's
    on the same route: pixel-sharded (``halves`` None) bit-equal to
    ``want``, the render of every pixel; sample-sharded bit-equal to the
    rank-ordered sum of ``halves``, each rank's samples rendered in one
    process, and within rtol 1e-6 of ``want``, the render of all the
    samples.  Counts exact."""
    rad, counts = got
    if halves is None:
        same = np.array_equal(rad, want[0])
        what = "bit-equal to one process"
    else:
        err = float(np.max(np.abs(rad - want[0])
                           / np.maximum(np.abs(want[0]), 1e-30)))
        same = np.array_equal(rad, halves[0][0] + halves[1][0])
        what = (f"bit-equal to the rank-ordered sum, largest relative "
                f"distance from one process {err:.3g}")
        same = same and err <= 1e-6
    counts_ok = np.array_equal(counts, want[1])
    print(f"phase 20 {label}: {what} {same}, counts exact {counts_ok}",
          flush=True)
    if not (same and counts_ok):
        raise RuntimeError(f"phase 20 {label}: the sharded render is not "
                           f"one process's")


def shard_phase(ptt, K, SP, VJ, I, torch, np, cornell, parsed, card):
    """Phase 20, multi-device rendering and the native runtime.  Returns
    the sharded main path's launches: {"k1": {mask: n}, "k5": {mask: n},
    "k6": n, "k8": {mask: n}}."""
    from PIL import Image

    from pathtrace_tpu_torch import cli
    from pathtrace_tpu_torch.io import image_io
    from pathtrace_tpu_torch.native import lib as N
    from pathtrace_tpu_torch.render import diff as D
    import torch_scenes as TS

    t_phase = time.perf_counter()
    n = SHARD_SPP
    small = dataclasses.replace(cornell, resolution=SHARD_SMALL)
    with tempfile.TemporaryDirectory() as work:
        outs = [os.path.join(work, f"rank{r}.npz") for r in range(2)]
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--shard-rank",
             str(r), "2", os.path.join(work, "store"), outs[r]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(2)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=400)[0])
        finally:
            for p in procs:
                p.kill()
        if any(p.returncode != 0 for p in procs):
            raise RuntimeError("phase 20: a shard process failed:\n"
                               + "\n".join(
                                   f"rank {r} exit {p.returncode}:\n"
                                   f"{log[-3000:]}" for r, (p, log)
                                   in enumerate(zip(procs, logs))))
        ranks = [dict(np.load(o)) for o in outs]
        infos = []
        for o in outs:
            with open(o + ".json") as f:
                infos.append(json.load(f))
    print(f"phase 20 two gloo ranks on cuda:0 and one NCCL rank: "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    for key, value in ranks[1].items():  # every rank holds the same bits
        if not np.array_equal(value, ranks[0][key]):
            raise RuntimeError(f"phase 20 {key}: rank 1 is not rank 0")
    got = ranks[0]

    def host(out):
        return [x.cpu().numpy() for x in out]

    def route(one, spp=n):
        """One process's render of every sample from iteration 1, and of
        each rank's half of them."""
        halves = [host(one(1 + r * (spp // 2), spp // 2)) for r in range(2)]
        return host(one(1, spp)), halves

    job = K.prepare(cornell, "cuda")
    k1 = route(lambda i, m: K.trace_k1(job, i, m))
    srt = route(lambda i, m: SP.pathtrace_batch_sorted(cornell, i, m,
                                                       "cuda"))
    pjob = K.prepare(small, "cuda", texels="f32")
    planes = route(lambda i, m: K.trace_plain(**pjob, it0=i, n_spp=m), 2)
    wave_sort = route(lambda i, m: I.pathtrace_batch(
        small, i, m, "sort", remat=False, device="cuda"), 2)
    wave_mask = host(I.pathtrace_batch(small, 1, 2, "mask", remat=False,
                                       device="cuda"))
    for label, want, halves in (
            ("gloo pixel k1", k1[0], None),
            ("gloo sample k1", k1[0], k1[1]),
            ("gloo sample sorted", srt[0], srt[1]),
            ("gloo sample planes", planes[0], planes[1]),
            ("gloo pixel planes", planes[0], None),
            ("gloo sample wavefront", wave_sort[0], wave_sort[1]),
            ("gloo pixel wavefront", wave_mask, None),
            ("nccl pixel k1", k1[0], None),
            ("nccl sample k1", k1[0], None)):
        _hold_render(np, label, (got[f"{label}.rad"], got[f"{label}.counts"]),
                     want, halves)
    # the grad step: K1 + render_vjp in one process with the same loss
    rad, _ = K.trace_k1(K.prepare(cornell, "cuda", nee=True), 1, 2)
    img = rad / 2
    loss = float(torch.mean(img ** 2))
    _, want = VJ.render_vjp(cornell, 2.0 * img / float(img.numel() * 2), 1,
                            2, nee=True)
    worst = 0.0
    for name, w in D.named_leaves(want):
        w = w.cpu().numpy()
        g = got[f"gloo grad.g.{name}"]
        # the reference's rtol (tests/test_parallel.py:160), and an atol of
        # 1e-6 of the leaf's largest entry: each rank rounds its exact
        # table once, one process once
        tol = 1e-3 * np.abs(w) + 1e-6 * np.abs(w).max(initial=0.0)
        worst = max(worst, float(np.max(np.abs(g - w)
                                        / np.maximum(tol, 1e-30),
                                        initial=0.0)))
    loss_err = abs(float(got["gloo grad.loss"]) - loss) / loss
    print(f"phase 20 sharded_grad_step_pallas NEE 1 spp a rank: loss "
          f"{float(got['gloo grad.loss']):.9g} (one process {loss:.9g}, "
          f"relative {loss_err:.3g}), gradients at {worst:.3g} of the "
          f"tolerance (rtol 1e-3, atol 1e-6 of each leaf's largest)",
          flush=True)
    if not (worst <= 1 and loss_err <= 1e-6):
        raise RuntimeError("phase 20: the sharded grad step is not one "
                           "process's")
    info = infos[0]
    for group in ("gloo", "nccl"):
        if info[f"{group} backend"] != group:
            raise RuntimeError(f"phase 20: {group} group on "
                               f"{info[f'{group} backend']}")
    print(f"phase 20 times, cornell 800x800 d8 {n} spp a call, median of 5 "
          f"(host clock around the call, the card synchronized), on {card}: "
          f"K1 sample-sharded on 2 gloo ranks on one card "
          f"{info['gloo k1 ms'][0] / n:.4f} ms/iter (runs "
          f"{[round(t, 3) for t in info['gloo k1 ms'][1]]} ms), on 1 NCCL "
          f"rank {info['nccl k1 ms'][0] / n:.4f} ms/iter (runs "
          f"{[round(t, 3) for t in info['nccl k1 ms'][1]]}), unsharded "
          f"{info['unsharded k1 ms'][0] / n:.4f} ms/iter (runs "
          f"{[round(t, 3) for t in info['unsharded k1 ms'][1]]}); one "
          f"all_reduce of the 800x800 image (7.68 MB): gloo on CUDA "
          f"{info['gloo all_reduce ms'][0]:.4f} ms (runs "
          f"{[round(t, 3) for t in info['gloo all_reduce ms'][1]]}), NCCL "
          f"{info['nccl all_reduce ms'][0]:.4f} ms (runs "
          f"{[round(t, 3) for t in info['nccl all_reduce ms'][1]]})",
          flush=True)
    launches = dict(k1={}, k5={}, k6=0, k8={})
    for inf in infos:
        for group in ("gloo", "nccl"):
            for kind, by_mask in inf.get(f"{group} launches", {}).items():
                for m, v in by_mask.items():
                    if kind == "k6":
                        launches["k6"] += v
                    else:
                        launches[kind][int(m)] = (
                            launches[kind].get(int(m), 0) + v)
    if not (launches["k1"].get(0) and launches["k1"].get(K.NEE_BIT)
            and launches["k5"].get(0) and launches["k6"]
            and launches["k8"].get(K.NEE_BIT)):
        raise RuntimeError(f"phase 20: the sharded routes launched "
                           f"{launches}")
    print(f"phase 20 launches of the sharded main path (both ranks and the "
          f"NCCL rank): {launches}", flush=True)
    phase_done("20 sharded routes")

    # the CLI under torchrun, one process on NCCL, against the unsharded CLI
    with tempfile.TemporaryDirectory() as work:
        scene_file = os.path.join(HERE, "scenes", "cornell.txt")
        common = ["--spp", str(n)]
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", "1", "-m", "pathtrace_tpu_torch.cli",
             scene_file, "--shard", *common, "--out",
             os.path.join(work, "shard.png"), "--checkpoint",
             os.path.join(work, "shard.ckpt")], cwd=HERE,
            env=dict(os.environ, PYTHONPATH=HERE), capture_output=True,
            text=True, timeout=300)
        t_cli = time.perf_counter() - t0
        if proc.returncode != 0 or "backend nccl" not in proc.stdout:
            raise RuntimeError(f"phase 20: the CLI under torchrun exited "
                               f"{proc.returncode}:\n{proc.stdout[-3000:]}"
                               f"\n{proc.stderr[-3000:]}")
        if not N.available():
            raise RuntimeError("phase 20: the native library did not build")
        rc = cli.main([scene_file, *common, "--out",
                       os.path.join(work, "plain.png"), "--checkpoint",
                       os.path.join(work, "plain.ckpt")])
        a = np.load(os.path.join(work, "shard.ckpt"))["accum"]
        b = np.load(os.path.join(work, "plain.ckpt"))["accum"]
        png = [np.asarray(Image.open(os.path.join(work, f"{k}.png")))
               for k in ("shard", "plain")]
        # the unsharded CLI's PNG came from the native writer; Pillow's
        image_io.save_png(os.path.join(work, "pillow.png"),
                          image_io.to_display(b, cornell.width,
                                              cornell.height, n),
                          native=False)
        pillow = np.asarray(Image.open(os.path.join(work, "pillow.png")))
        same = (rc == 0 and np.array_equal(a, b)
                and np.array_equal(png[0], png[1]))
        print(f"phase 20 cli --shard under torchrun --nproc_per_node 1 "
              f"(NCCL) cornell {n} spp: {t_cli:.1f} s, accumulation and "
              f"PNG equal to the unsharded CLI's {same}; the native PNG "
              f"writer's image reads back equal to Pillow's "
              f"{np.array_equal(png[1], pillow)}", flush=True)
        if not (same and np.array_equal(png[1], pillow)):
            raise RuntimeError("phase 20: the sharded CLI's image or the "
                               "native PNG differs")
    phase_done("20 cli --shard")

    # the native parser on every scene file against the Python parser's
    from pathtrace_tpu_torch.scene.obj import load_obj

    t_native = {}
    for path in sorted(glob.glob(os.path.join(HERE, "scenes", "*.txt"))):
        name = os.path.basename(path)[:-4]
        t0 = time.perf_counter()
        native = ptt.load_scene(path, native=True)
        t_native[name] = time.perf_counter() - t0
        python = parsed.get(name) or ptt.load_scene(path, native=False)
        TS.tree_equal(native, python, name)
    big = os.path.join(HERE, "scenes", "cornell_bigmesh.txt")
    t0 = time.perf_counter()
    ptt.load_scene(big, native=False)
    t_python = time.perf_counter() - t0
    obj = os.path.join(HERE, "scenes", "icosphere6.obj")
    t_obj = [_wall_ms(torch, lambda: N.load_obj_native(obj), 3)[0],
             _wall_ms(torch, lambda: load_obj(obj), 3)[0]]
    each = ", ".join(f"{k} {v:.3f} s" for k, v in t_native.items())
    print(f"phase 20 native parser: every scene file's tree equal to the "
          f"Python parser's ({each}, each BVH build included); on the "
          f"card's host ({card}), "
          f"cornell_bigmesh.txt {1e3 * t_native['cornell_bigmesh']:.1f} ms "
          f"native, {1e3 * t_python:.1f} ms Python, one run each, its BVH "
          f"build included; its OBJ icosphere6.obj alone, median of 3 "
          f"after a warm call, "
          f"{t_obj[0]:.1f} ms native, {t_obj[1]:.1f} ms Python", flush=True)
    phase_done("20 native")
    return launches


def bigmesh_scene(mesh_configs):
    return next(c[1] for c in mesh_configs if c[0] == "cornell_bigmesh")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA GPU", file=sys.stderr)
        return 2
    import numpy as np

    sys.path.insert(0, HERE)
    import pathtrace_tpu_torch as ptt
    from pathtrace_tpu_torch.ops.cuda import bound as B
    from pathtrace_tpu_torch.ops.cuda import build
    from pathtrace_tpu_torch.ops.cuda import matgrad as MG
    from pathtrace_tpu_torch.ops.cuda import megakernel as K
    from pathtrace_tpu_torch.ops.cuda import vjp as VJ
    from pathtrace_tpu_torch.ops import scan as SC
    from pathtrace_tpu_torch.ops.cuda import probe as P
    from pathtrace_tpu_torch.ops.cuda import span as SP
    from pathtrace_tpu_torch.native import lib as N
    from pathtrace_tpu_torch.scene.bvh import without_bvh
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import torch_digest as TD
    from torch_digest import ptxas_usage
    import torch_gradcheck as GC

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {kind}", flush=True)

    configs = []
    for label, name, edits, nee, rr in CONFIGS:
        scene = load(ptt, name, edits)
        configs.append((label, scene, nee, rr, K.scene_mask(scene, nee, rr)))
    if not os.path.exists(os.path.join(HERE, HUGEMESH_OBJ)):
        t0 = time.perf_counter()
        subprocess.run([sys.executable,
                        os.path.join(HERE, "tools", "gen_mesh.py"), "7",
                        os.path.join(HERE, HUGEMESH_OBJ)], check=True,
                       timeout=300)
        print(f"generated {HUGEMESH_OBJ}: {time.perf_counter() - t0:.2f} s",
              flush=True)
    mesh_configs = []
    for label, name, edits, nee, rr in MESH_CONFIGS:
        scene = load_mesh_scene(ptt, name, edits)
        mesh_configs.append(
            (label, scene, nee, rr, K.scene_mask(scene, nee, rr)))
    linear_configs = []
    for label, name, edits, nee, rr in LINEAR_CONFIGS:
        scene = without_bvh(load(ptt, name, edits))
        linear_configs.append(
            (label, scene, nee, rr, K.scene_mask(scene, nee, rr)))
    tex_configs, tex_timed = [], []
    for label, name, edits, nee, rr, timed_here in TEX_CONFIGS:
        t0 = time.perf_counter()
        scene = load(ptt, name, edits)
        print(f"load {label}: {time.perf_counter() - t0:.2f} s; maps "
              f"{[t.shape[:2] for t in scene.textures]}, charts "
              f"{K.tex_statics(scene)}", flush=True)
        tex_configs.append(
            (label, scene, nee, rr, K.scene_mask(scene, nee, rr)))
        if timed_here:
            tex_timed.append(tex_configs[-1])
    forward = configs + mesh_configs + tex_configs + linear_configs
    masks = sorted({c[4] for c in forward})
    phase_done("scenes")

    t0 = time.perf_counter()
    k7_masks = (0, K.MESH_BIT)
    # the native host runtime (g++) builds beside the kernels (nvcc)
    native = threading.Thread(target=N.available)
    native.start()
    logs = {}
    build.build_kernels(masks, k7_masks=k7_masks, k8_masks=VJ.MASKS,
                        logs=logs)
    native.join()
    print(f"build K1 variants {masks}, K7 (masks {k7_masks}), K8 (masks "
          f"{VJ.MASKS}), K6 and K9: {time.perf_counter() - t0:.2f} s, nvcc "
          f"{' '.join(build.NVCC_FLAGS)} -DPT_FEATURES=<mask> (K7 "
          f"-DPT_GRAD=1, K8 -DPT_VJP=1)", flush=True)
    for lib, name in ([(f"k1_m{m}", f"{kernel_name(K, m)} (mask {m})")
                       for m in masks]
                      + [(f"k7_m{m}", f"k7_grads (mask {m})")
                         for m in k7_masks]
                      + [(f"k8_m{m}", f"{K8} (mask {m})")
                         for m in VJ.MASKS]
                      + [("k6_scan", "k6_scan"), ("k9_probe", "k9_probe")]):
        sec, log = logs.get(lib, (0.0, "(library found built)"))
        usage = "; ".join(f"{k}: {v}" for k, v in ptxas_usage(log).items())
        print(f"build {name}: {sec:.2f} s | {usage}", flush=True)
    phase_done("build")

    launches = dict.fromkeys(masks, 0)
    max_err = dict.fromkeys(masks, 0.0)
    for label, scene, nee, rr, mask in forward:
        n, err = compare(ptt, K, torch, label, scene, nee, rr, mask)
        launches[mask] += n
        max_err[mask] = max(max_err[mask], err)
        phase_done(f"compare {label}")
    for scene_file, flags in (("cornell.txt", []),
                              ("cornell_glass.txt", ["--nee"]),
                              ("cornell_mesh.txt", []),
                              ("cornell_tex.txt", [])):
        cli_launches = cli_main_path(K, np, scene_file, flags)
        if not cli_launches:
            raise RuntimeError(f"the CLI on {scene_file} launched no kernel")
        for mask, n in cli_launches.items():
            launches[mask] += n
        phase_done(f"cli {scene_file}")
    missing = [m for m in masks if not launches[m]]
    if missing:
        raise RuntimeError(f"the main path launched no kernel of masks "
                           f"{missing}")
    k9_launches, k9_err, k9_args = probe_phase(K, P,
                                               bigmesh_scene(mesh_configs))
    phase_done("k9")
    schedule_holds(ptt, K, SP, TD, build, torch, configs[0][1])
    phase_done("k1 and k5 schedule holds")

    scenes = {c[0]: c[1:4] for c in forward}
    for label, scene, nee, rr, _ in linear_configs:
        if not K.tex_statics(scene)[1]:  # no BUMPTEX map
            linear_vs_k3(ptt, K, torch, label, scene,
                         scenes[label.replace(" linear", "")][0], nee, rr)
    phase_done("k3_linear vs k3")
    k5_launches, k6_launches = {}, 0
    for label, config, res, split in ENGINE_CONFIGS:
        scene, nee, rr = engine_scene(scenes, config, res)
        k5, k6 = engine_equal(ptt, K, SP, SC, torch, label, scene, nee, rr,
                              split)
        eng = "split" if split else "sorted"
        for m, n in k5.items():
            k5_launches[m, eng] = k5_launches.get((m, eng), 0) + n
        k6_launches += k6
        phase_done(f"engine {label}")
    k5, k6 = cli_engines(ptt, K, SP, SC, np, torch)
    for key, n in k5.items():
        k5_launches[key] = k5_launches.get(key, 0) + n
    k6_launches += k6
    phase_done("cli engines")

    # The plain versions are timed at 1 spp a call, 3 calls, and only on
    # the first configuration of each feature mask (the kernels line's);
    # the others (bigmesh and hugemesh at 1080p: 6-9 s a sample) print
    # their kernel's time and bound only
    timed = {}
    for label, scene, nee, rr, mask in configs:
        if mask not in timed:
            timed[mask] = time_variant(
                K, B, torch, label, K.prepare(scene, "cuda", nee=nee, rr=rr),
                mask, card, SPP_PER_CALL, 9, 1, 3)
            phase_done(f"time {label}")
    for label, scene, nee, rr, mask in (mesh_configs + tex_timed
                                        + linear_configs):
        job = K.prepare(scene, "cuda", nee=nee, rr=rr)
        ms = time_variant(K, B, torch, label, job, mask, card, SPP_PER_CALL,
                          5, 1, 0 if mask in timed else 3)
        timed.setdefault(mask, ms)
        phase_done(f"time {label}")
        if label == "cornell_bigmesh":
            # the reference's bigmesh secondary metric scene, 800x800 d8,
            # here on the megakernel route
            small = dataclasses.replace(scene, resolution=(800, 800))
            time_variant(K, B, torch, label, K.prepare(small, "cuda"), mask,
                         card, SPP_PER_CALL, 5, 1, 0)
    # for information, the work a BVH saves: K3-linear and K3 on
    # cornell_bigmesh (81,920 triangles) at 128x128 d8, 1 spp a call
    big = dataclasses.replace(bigmesh_scene(mesh_configs),
                              resolution=(128, 128))
    for label, scene in (("cornell_bigmesh 128", big),
                         ("cornell_bigmesh linear 128", without_bvh(big))):
        time_variant(K, B, torch, label, K.prepare(scene, "cuda"),
                     K.scene_mask(scene), card, 1, 3, 1, 1)
    phase_done("time cornell_bigmesh linear 128x128")
    tex_breakdown(K, torch, tex_timed[0][1], card)
    phase_done("texture breakdown")
    missing = [m for m in masks if m not in timed]
    for label, scene, nee, rr, mask in tex_configs:
        if mask in missing:  # a texture build no timed configuration has
            timed[mask] = time_variant(
                K, B, torch, label, K.prepare(scene, "cuda", nee=nee, rr=rr),
                mask, card, SPP_PER_CALL, 5, 1, 3)
            missing.remove(mask)
            phase_done(f"time {label}")
    ms_k9, runs_k9, k9_res = median_ms(lambda: P.probe_k9(*k9_args), torch,
                                       9)
    k9_dev = TD.device_ms(torch, lambda: P.probe_k9(*k9_args),
                          name="k9_probe")
    _, k9_ops, k9_bytes = B.count_work(lambda: P.probe_plain(*k9_args))
    ms_k9p, runs_k9p, _ = median_ms(lambda: P.probe_plain(*k9_args), torch, 3,
                                    warm=False)
    # the nodes and triangle columns the walk reads, and its 16-byte result
    k9_bound = B.bound(sum(k9_ops.values()), sum(k9_bytes.values()) + 16)
    print(f"time k9_probe bigmesh 32x128 rays: kernel median {ms_k9:.4f} ms "
          f"(runs {[round(t, 4) for t in runs_k9]}), plain median "
          f"{ms_k9p:.4f} ms (runs {[round(t, 4) for t in runs_k9p]}) on "
          f"{card}; bound {k9_bound[0]:.6f} ms by {k9_bound[1]} "
          f"({sum(k9_ops.values()):.4g} ops; bytes read {fmt_work(k9_bytes)}"
          f" + 16 written), kernel at {k9_bound[0] / ms_k9:.2%} of it; "
          f"library call: none; on the device alone (torch.profiler) "
          f"{k9_dev:.5f} ms, {k9_res[1]} steps, {k9_res[2]} leaves, "
          f"{1e3 * k9_dev / k9_res[1]:.4f} us a step", flush=True)
    phase_done("time k9")

    k5_row = {}
    for label, config, res, split in PLAIN_ENGINE_CONFIGS:
        scene, nee, rr = engine_scene(scenes, config, res)
        row = engine_vs_plain(ptt, K, B, SP, torch, label, scene, nee, rr,
                              split, config)
        k5_row.setdefault((K.scene_mask(scene, nee, rr),
                           "sorted" if split is None else "split"), row)
        phase_done(f"k5 vs plain {label}")
    missing = sorted(set(k5_launches) - set(k5_row))
    if missing:
        raise RuntimeError(f"K5 (mask, engine) {missing} ran on the main "
                           f"path but were not measured")
    k6_row = scan_phase(B, SC, torch, card)
    phase_done("k6")
    time_engines(ptt, K, SP, torch, scenes, card)
    phase_done("time engines")
    k6_wavefront = wavefront_phase(ptt, K, SC, torch, np, scenes, card)

    cornell = scenes["cornell"][0]
    small = dataclasses.replace(cornell, resolution=GRAD_SMALL[0],
                                trace_depth=GRAD_SMALL[1])
    grad_rows = {}
    for full, scene in ((False, small), (True, cornell)):
        for name, nee in ((K8, False), (f"{K8}+k2_nee", True)):
            grad_rows[name] = k8_vs_plain(K, VJ, GC, torch, name, scene,
                                          nee, full)
            phase_done(f"{name} vs plain {scene.resolution}")
        row = k7_vs_plain(K, MG, GC, torch, "k7_grads", scene)
        grad_rows["k7_grads"], k7_job = row[:2], row[2:]
        phase_done(f"k7_grads vs plain {scene.resolution}")
    # K7 where each block flushes its table more than once (K7_FLUSH)
    res, depth, spp, per_flush = K7_FLUSH
    k7_vs_plain(K, MG, GC, torch, "k7_grads", dataclasses.replace(
        cornell, resolution=res, trace_depth=depth), spp, per_flush)
    phase_done(f"k7_grads vs plain {res} {spp} spp")
    # the mesh builds: cornell_mesh at 64x64 d4 and at its 1920x1080 d8
    mesh = scenes["cornell_mesh"][0]
    mesh_small = dataclasses.replace(mesh, resolution=GRAD_SMALL[0],
                                     trace_depth=GRAD_SMALL[1])
    for full, scene in ((False, mesh_small), (True, mesh)):
        for name, nee in ((f"{K8}+k3_mesh", False),
                          (f"{K8}+k2_nee+k3_mesh", True)):
            grad_rows[name] = k8_vs_plain(K, VJ, GC, torch, name, scene,
                                          nee, full)
            phase_done(f"{name} vs plain {scene.resolution}")
        row = k7_vs_plain(K, MG, GC, torch, "k7_grads+k3_mesh", scene)
        grad_rows["k7_grads+k3_mesh"], k7_mesh_job = row[:2], row[2:]
        phase_done(f"k7_grads+k3_mesh vs plain {scene.resolution}")
    mesh_rig_phase(ptt, GC, torch)
    phase_done("mesh rig")
    grad_launches = grad_main_path(ptt, K, MG, VJ, np, torch, cornell)
    phase_done("gradients' main path")
    grad_launches.update(mesh_grad_main_path(ptt, K, MG, VJ, torch, mesh))
    phase_done("mesh gradients' main path")
    grad_times = time_gradients(ptt, K, MG, VJ, B, torch, cornell, card,
                                k7_job)
    phase_done("time gradients")
    bigmesh800 = dataclasses.replace(bigmesh_scene(mesh_configs),
                                     resolution=(800, 800))
    for label, scene in (("cornell_bigmesh", bigmesh800),
                         ("cornell_mesh", mesh)):
        for name, nee in ((f"{K8}+k3_mesh", False),
                          (f"{K8}+k2_nee+k3_mesh", True)):
            # the cornell_mesh times are the kernels line's
            grad_times[name] = time_k8(
                K, VJ, B, torch, f"{label} NEE" if nee else label, name,
                K.prepare(scene, "cuda", nee=nee), nee, card)
    grad_times["k7_grads+k3_mesh"] = time_k7(
        K, MG, B, torch, "cornell_mesh", "k7_grads+k3_mesh", k7_mesh_job,
        card)
    phase_done("time mesh gradients")

    # K8's section builds: at 64x64 d4 and at full size, with and without
    # NEE, on the main path, and their times
    section_scenes = {
        label: scenes[label][0] if label in scenes else load(ptt, name, edits)
        for label, name, edits in K8_SECTION_CONFIGS}
    for label, *_ in K8_SECTION_CONFIGS:
        scene = section_scenes[label]
        small = dataclasses.replace(scene, resolution=GRAD_SMALL[0],
                                    trace_depth=GRAD_SMALL[1])
        for full, sc in ((False, small), (True, scene)):
            for nee in (False, True):
                name = k8_name(K, K.scene_mask(scene, nee))
                grad_rows[name] = k8_vs_plain(K, VJ, GC, torch, name, sc,
                                              nee, full)
                phase_done(f"{name} vs plain {sc.resolution}")
    grad_launches.update(section_grad_main_path(ptt, K, VJ, torch,
                                                section_scenes))
    phase_done("sections' gradients' main path")
    section_names = []
    for label, *_ in K8_SECTION_CONFIGS:
        scene = section_scenes[label]
        for nee in (False, True):
            name = k8_name(K, K.scene_mask(scene, nee))
            section_names.append(name)
            grad_times[name] = time_k8(
                K, VJ, B, torch, f"{label} NEE" if nee else label, name,
                K.prepare(scene, "cuda", nee=nee), nee, card)
    phase_done("time sections' gradients")
    print("k8 breakdown builds (PERF.md section 5), ms at full size, 1 spp: "
          + ", ".join(f"mask {m} {grad_times[k8_name(K, m)][0]:.4f}"
                      for m in K8_BREAKDOWN) + f" on {card}", flush=True)
    # the digests tests/torch_digest.py prints (--k8, --k6), to hold two
    # checkouts to each other
    for scene, nee, mask in TD.k8_scenes(HERE, ptt, K):
        rad, tabs = TD.k8_digest(torch, K, VJ, scene, nee, mask)
        print(f"k8 digest mask {mask} {TD.K8_RES[0]}x{TD.K8_RES[1]} "
              f"d{TD.K8_DEPTH}: rad {rad} tables {tabs}", flush=True)
    TD.k6_digests(HERE, torch)
    phase_done("digests")
    phase19_k1, phase19_k7 = progressive_phase(ptt, K, MG, torch, np,
                                               scenes, card)
    for mask, n in phase19_k1.items():
        launches[mask] += n
    grad_launches["k7_grads"] += phase19_k7
    if not (phase19_k1.get(0) and phase19_k7):
        raise RuntimeError(f"phase 19 launched K1 {phase19_k1}, K7 "
                           f"{phase19_k7}")
    phase_done("19")
    from pathtrace_tpu_torch.render import integrator as I

    # the configurations named after a scene file are the file unedited
    parsed = {c[0]: c[1] for c in forward if os.path.exists(
        os.path.join(HERE, "scenes", f"{c[0]}.txt"))}
    sharded = shard_phase(ptt, K, SP, VJ, I, torch, np, cornell, parsed,
                          card)
    for mask, n in sharded["k1"].items():
        launches[mask] += n
    for mask, n in sharded["k5"].items():
        k5_launches[mask, "sorted"] = k5_launches.get((mask, "sorted"),
                                                      0) + n
    k6_wavefront += sharded["k6"]
    for mask, n in sharded["k8"].items():
        grad_launches[k8_name(K, mask)] = grad_launches.get(
            k8_name(K, mask), 0) + n

    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": kernel_name(K, mask),
        "route": "cuda",
        "source": "pathtrace_tpu_torch/csrc/megakernel.cu",
        "replaces": (K3_LINEAR_SITE if mask & K.LINEAR_BIT else
                     K4_SITE if mask & (K.TEX_BIT | K.BTEX_BIT) else
                     K3_SITE if mask & K.MESH_BIT else
                     K2_SITE if mask & K.NEE_BIT else K1_SITE),
        "launches": launches[mask],
        "max_abs_err": max_err[mask],
        "ms": timed[mask][0],
        "plain_ms": timed[mask][1],
        "bound_ms": timed[mask][2],
        "bound_by": timed[mask][3],
        "library_ms": None,
    } for mask in masks] + [{
        "name": "k9_probe",
        "route": "cuda",
        "source": "pathtrace_tpu_torch/csrc/probe_trav.cu",
        "replaces": K9_SITE,
        "launches": k9_launches,
        "max_abs_err": k9_err,
        "ms": ms_k9,
        "plain_ms": ms_k9p,
        "bound_ms": k9_bound[0],
        "bound_by": k9_bound[1],
        "library_ms": None,
    }] + [{
        "name": (kernel_name(K, mask).replace("k1_trace", "k5_span")
                 + f" ({eng})"),
        "route": "cuda",
        "source": "pathtrace_tpu_torch/csrc/megakernel.cu",
        "replaces": K5_SITE,
        "launches": k5_launches[mask, eng],
        "max_abs_err": k5_row[mask, eng][0],
        "ms": k5_row[mask, eng][1],
        "plain_ms": k5_row[mask, eng][2],
        "bound_ms": k5_row[mask, eng][3],
        "bound_by": k5_row[mask, eng][4],
        "library_ms": None,
    } for mask, eng in sorted(k5_launches)] + [{
        "name": "k6_scan",
        "route": "cuda",
        "source": "pathtrace_tpu_torch/csrc/scan.cu",
        "replaces": K6_SITE,
        "launches": k6_launches,
        "max_abs_err": k6_row[SCAN_TIMED][0],
        "ms": k6_row[SCAN_TIMED][1],
        "plain_ms": k6_row[SCAN_TIMED][2],
        "bound_ms": k6_row[SCAN_TIMED][4],
        "bound_by": k6_row[SCAN_TIMED][5],
        "library_ms": k6_row[SCAN_TIMED][3],
    }, {
        "name": "k6_scan (wavefront densify)",
        "route": "cuda",
        "source": "pathtrace_tpu_torch/csrc/scan.cu",
        "replaces": K6_SITE,
        "launches": k6_wavefront,
        "max_abs_err": k6_row[SCAN_DENSIFY][0],
        "ms": k6_row[SCAN_DENSIFY][1],
        "plain_ms": k6_row[SCAN_DENSIFY][2],
        "bound_ms": k6_row[SCAN_DENSIFY][4],
        "bound_by": k6_row[SCAN_DENSIFY][5],
        "library_ms": k6_row[SCAN_DENSIFY][3],
    }] + [{
        "name": name,
        "route": "cuda",
        "source": "pathtrace_tpu_torch/csrc/megakernel.cu",
        "replaces": K7_SITE if name.startswith("k7") else K8_SITE,
        "launches": grad_launches[name],
        "max_abs_err": grad_rows[name][0],
        "ms": grad_times[name][0],
        "plain_ms": grad_rows[name][1],
        "bound_ms": grad_times[name][1],
        "bound_by": grad_times[name][2],
        "library_ms": None,
    } for name in ("k7_grads", K8, f"{K8}+k2_nee", "k7_grads+k3_mesh",
                   f"{K8}+k3_mesh", f"{K8}+k2_nee+k3_mesh",
                   *section_names)]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    import faulthandler

    faulthandler.enable()  # a crash in native code prints the Python stack
    if sys.argv[1:2] == ["--busy-share"]:
        sys.path.insert(0, HERE)
        sys.exit(busy_share_child(sys.argv[2], int(sys.argv[3]),
                                  int(sys.argv[4])))
    if sys.argv[1:2] == ["--shard-rank"]:
        sys.exit(shard_child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                             sys.argv[5]))
    sys.exit(main())
