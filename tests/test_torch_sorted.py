"""The sorted engine (``ops/cuda/span.py``) on the CPU: the port's plain
engine bit-equal to ``trace_plain`` (K1's plain version) in every
configuration, held against the reference's ``pathtrace_batch_sorted``
in interpret mode within the tie-flip bound; its sort key against a
numpy transcription of the reference's ``sort_perm``; and the image
unchanged under any order of the rays between spans.  On the card, K5
against K1: ``tests/test_torch_cuda.py``."""

import dataclasses

import numpy as np
import pytest
import torch

from pathtrace_tpu.ops.pallas.megakernel import pathtrace_batch_sorted
import pathtrace_tpu_torch as ptt
from pathtrace_tpu_torch.ops.cuda import megakernel as K
from pathtrace_tpu_torch.ops.cuda import span as SP
import torch_engine_ref as E


@pytest.mark.parametrize("label", sorted(E.CONFIGS))
def test_sorted_bit_equal_to_trace_plain(label):
    scene, nee, rr = E.load(label)
    got = ptt.pathtrace_batch_sorted(scene, 1, 2, device="cpu", nee=nee,
                                     rr=rr)
    E.assert_bit_equal(got, E.plain_reference(scene, nee, rr))


def test_sorted_depth_one():
    scene, _, _ = E.load("cornell")
    scene = dataclasses.replace(scene, trace_depth=1)
    got = ptt.pathtrace_batch_sorted(scene, 1, 2, device="cpu")
    E.assert_bit_equal(got, E.plain_reference(scene, False, False))


@pytest.mark.parametrize("name,res,depth,nee", [
    ("cornell", (32, 32), 5, False), ("cornell", (32, 32), 5, True),
    ("sphere", (32, 32), 5, False), ("cornell_mesh", (16, 16), 3, False)])
def test_sorted_matches_reference(name, res, depth, nee):
    E.against_reference(pathtrace_batch_sorted, ptt.pathtrace_batch_sorted,
                        name, res, depth, nee)


def _key_numpy(st, lo, span):
    """The reference's sort key (``megakernel.py`` ``sort_perm``),
    transcribed in numpy float32 and int32."""
    live = st["live"] > 0.0
    q = []
    for ax, k in enumerate(("ox", "oy", "oz")):
        v = (st[k] - lo[ax]) / span[ax]
        q.append(np.clip(v * np.float32(31.0), 0.0, 31.0).astype(np.int32))
    oct_ = (((st["dx"] > 0).astype(np.int32) << 2)
            | ((st["dy"] > 0).astype(np.int32) << 1)
            | (st["dz"] > 0).astype(np.int32))
    morton = np.zeros_like(q[0])
    for b in range(5):
        morton = morton | (((q[0] >> b) & 1) << (3 * b + 2)) \
            | (((q[1] >> b) & 1) << (3 * b + 1)) \
            | (((q[2] >> b) & 1) << (3 * b))
    key = (morton << 3) | oct_
    return np.where(live, key, np.int32(1) << 29)


@pytest.mark.parametrize("name", ["cornell", "cornell_mesh"])
def test_sort_perm_matches_the_reference_key(name):
    scene = E.S.load(name, (), (32, 32), 5)
    job = K.prepare(scene, "cpu")
    keys = K.state_keys(job["features"], False, True)
    state = torch.empty((len(keys), 32 * 32))
    counts = torch.zeros(5, dtype=torch.int64)
    SP.trace_span(job, state, keys, 0, 2, 1, counts)
    # origins off the box, on its faces and a NaN-free spread of
    # directions, besides the traced ones
    r = np.random.RandomState(4)
    state[0:3, :64] = torch.from_numpy(r.uniform(-12, 12, (3, 64))
                                       .astype(np.float32))
    state[3:6, 64:128] = torch.from_numpy(r.choice(
        [-1.0, -0.0, 0.0, 0.5], (3, 64)).astype(np.float32))
    lo, span = SP.sort_box(scene, "cpu")
    t = np.asarray(scene.geoms.translation, np.float32)
    s = np.abs(np.asarray(scene.geoms.scale, np.float32))
    ref_lo = np.min(t - s, axis=0)
    ref_span = np.maximum(np.max(t + s, axis=0) - ref_lo, np.float32(1e-3))
    np.testing.assert_array_equal(lo.reshape(-1).numpy(), ref_lo)
    np.testing.assert_array_equal(span.reshape(-1).numpy(), ref_span)
    st = {k: state[i].numpy() for i, k in enumerate(keys)}
    key = _key_numpy(st, ref_lo, ref_span)
    want = np.argsort(key, kind="stable")
    assert 0 < (key == 1 << 29).sum() < key.size
    np.testing.assert_array_equal(SP.sort_perm(state, lo, span).numpy(),
                                  want)


def test_image_unchanged_under_any_order_of_the_rays():
    # a random permutation of the state between spans in place of the
    # sort: the carried pixel id keys the draws, so the image is the same
    scene, nee, rr = E.load("glass_bump_sss")
    job = K.prepare(scene, "cpu", nee=True)
    keys = K.state_keys(job["features"], True, True)
    n = 32 * 32
    g = torch.Generator().manual_seed(9)
    counts = torch.zeros(5, dtype=torch.int64)
    state = torch.empty((len(keys), n))
    SP.trace_span(job, state, keys, 0, 1, 1, counts)
    for d in range(1, 5):
        state = SP.permute(state, torch.randperm(n, generator=g))
        SP.trace_span(job, state, keys, d, d + 1, 1, counts)
    pix = state[-1].view(torch.int32).long()
    assert sorted(pix.tolist()) == list(range(n))
    rad = torch.empty((n, 3))
    rad[pix] = state[SP.RAD_KEYS].T
    want = K.trace_plain(**job, it0=1, n_spp=1)
    E.assert_bit_equal((rad, counts), want)


def test_sorted_default_device_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene, _, _ = E.load("cornell")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        ptt.pathtrace_batch_sorted(scene, 1, 1)
