"""The port's ``pathtrace_batch`` counts, as the reference's: the live paths
entering each bounce of each sample, shape (n_iters, depth).  K1's plain
version on the CPU on cornell.txt at 16x16, depth 4, 3 samples, against
the reference's ``pathtrace_batch`` (its JAX wavefront): the same shape,
the values within the reference's own tolerance between its kernel and
its wavefront (rtol 0.02, ``tests/test_pallas.py``: the two round
differently, and a path that flips at one bounce is counted or not at
the next); and against the reference's kernel run one sample at a time
(``pathtrace_iteration_pallas``, interpret mode), whose rounding the
plain version shares: equal.  K1 writes the same per-sample counts on the
card (``tests/test_torch_cuda.py``)."""

import dataclasses
import os

import numpy as np
import torch

import pathtrace_tpu as pt
from pathtrace_tpu.ops.pallas.megakernel import pathtrace_iteration_pallas
import pathtrace_tpu_torch as ptt
from pathtrace_tpu_torch.ops.cuda import megakernel as K

CORNELL = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scenes", "cornell.txt")
RES, DEPTH, SPP = (16, 16), 4, 3


def _scenes():
    ref = dataclasses.replace(pt.load_scene(CORNELL), resolution=RES,
                              trace_depth=DEPTH)
    port = dataclasses.replace(ptt.load_scene(CORNELL), resolution=RES,
                               trace_depth=DEPTH)
    return ref, port


def test_counts_per_sample_match_reference():
    ref, port = _scenes()
    _, want = pt.pathtrace_batch(ref, 1, SPP)
    rad, got = ptt.pathtrace_batch(port, 1, SPP, device="cpu")
    want = np.asarray(want)
    assert want.shape == (SPP, DEPTH)
    assert tuple(got.shape) == (SPP, DEPTH) and got.dtype == torch.int64
    np.testing.assert_allclose(got.numpy(), want, rtol=0.02, atol=0)
    assert rad.shape == (RES[0] * RES[1], 3)
    kernel = np.stack([np.asarray(pathtrace_iteration_pallas(
        ref, it, interpret=True)[1]) for it in range(1, SPP + 1)])
    np.testing.assert_array_equal(got.numpy(), kernel)


def test_summed_counts_are_the_per_sample_ones_summed():
    # trace_k1's callers other than pathtrace_batch take the sum
    _, port = _scenes()
    job = K.prepare(port, "cpu")
    rad, per = K.trace_k1(job, 1, SPP, per_sample=True)
    rad2, summed = K.trace_k1(job, 1, SPP)
    assert torch.equal(rad, rad2)
    assert torch.equal(per.sum(0), summed) and tuple(summed.shape) == (DEPTH,)


def test_render_callback_gets_each_samples_counts():
    # render's callback(done, accum, counts) gets the chunk's counts per
    # sample, (chunk, depth), as the reference's render passes its
    # pathtrace_batch's: cornell 8x8 d3, 3 iterations in chunks of 2
    res, depth = (8, 8), 3
    ref = dataclasses.replace(pt.load_scene(CORNELL), resolution=res,
                              trace_depth=depth)
    port = dataclasses.replace(ptt.load_scene(CORNELL), resolution=res,
                               trace_depth=depth)
    want, got = [], []
    pt.render(ref, 3, chunk=2, callback=lambda done, acc, counts: want.append(
        (done, np.asarray(acc), np.asarray(counts))))
    ptt.render(port, 3, chunk=2, device="cpu",
               callback=lambda done, acc, counts: got.append(
                   (done, acc.clone(), counts.clone())))
    assert [w[0] for w in want] == [g[0] for g in got] == [2, 3]
    assert [w[2].shape for w in want] == [(2, depth), (1, depth)]
    for (_, w_acc, w_counts), (_, g_acc, g_counts) in zip(want, got):
        assert tuple(g_counts.shape) == w_counts.shape
        assert g_counts.dtype == torch.int64
        np.testing.assert_array_equal(g_counts.numpy(), w_counts)
        np.testing.assert_allclose(g_acc.numpy(), w_acc, rtol=0, atol=1e-3)
