"""The sorted engine (``ops/cuda/span.py``) on the CPU: the port's plain
engine bit-equal to ``trace_plain`` (K1's plain version) in every
configuration, held against the reference's ``pathtrace_batch_sorted``
in interpret mode within the tie-flip bound; its sort key against a
numpy transcription of the reference's ``sort_perm``, and against the
reference's own jnp ops where an origin is NaN; the image unchanged under
any order of the rays between spans; the live count each span leaves for
the next (the live prefix), and a span that leaves a dead ray's planes as
they were.  On the card, K5 against K1: ``tests/test_torch_cuda.py``."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

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


def _key_jnp(st, lo, span):
    """The reference's sort key, ``sort_perm`` of ``megakernel.py``
    (:4405-4427), in its own jnp ops: the clip and the int32 cast give a
    NaN origin cell 0."""
    live = jnp.asarray(st["live"]) > 0.0
    q = []
    for ax, k in enumerate(("ox", "oy", "oz")):
        v = (jnp.asarray(st[k]) - lo[ax]) / span[ax]
        q.append(jnp.clip(v * 31.0, 0.0, 31.0).astype(jnp.int32))
    oct_ = (((jnp.asarray(st["dx"]) > 0).astype(jnp.int32) << 2)
            | ((jnp.asarray(st["dy"]) > 0).astype(jnp.int32) << 1)
            | (jnp.asarray(st["dz"]) > 0).astype(jnp.int32))
    morton = jnp.zeros_like(q[0])
    for b in range(5):
        morton = morton \
            | (((q[0] >> b) & 1) << (3 * b + 2)) \
            | (((q[1] >> b) & 1) << (3 * b + 1)) \
            | (((q[2] >> b) & 1) << (3 * b))
    key = (morton << 3) | oct_
    return jnp.where(live, key, jnp.int32(1) << 29)


def test_sort_perm_gives_a_nan_origin_the_references_cell():
    # a NaN origin on a live and on a dead ray: the reference's int32 cast
    # makes the cell 0; torch's int64 cast of NaN is -2^63, no index
    scene = E.S.load("cornell", (), (16, 8), 4)
    job = K.prepare(scene, "cpu")
    keys = K.state_keys(job["features"], False, True)
    state = torch.empty((len(keys), 128))
    SP.trace_span(job, state, keys, 0, 4, 1, torch.zeros(4, dtype=torch.int64))
    g = torch.Generator().manual_seed(3)
    state[0:6] = torch.rand((6, 128), generator=g) * 6.0 - 3.0
    state[SP.LIVE_KEY] = (torch.arange(128) % 3 != 0).float()
    state[0, 5] = state[2, 5] = float("nan")   # live
    state[1, 6] = float("nan")                 # dead (6 % 3 == 0)
    assert state[SP.LIVE_KEY, 5] == 1.0 and state[SP.LIVE_KEY, 6] == 0.0
    lo, span = SP.sort_box(scene, "cpu")
    st = {k: state[i].numpy() for i, k in enumerate(keys)}
    key = np.asarray(_key_jnp(st, lo.reshape(-1).numpy(),
                              span.reshape(-1).numpy()))
    want = np.argsort(key, kind="stable")
    np.testing.assert_array_equal(SP.sort_perm(state, lo, span).numpy(),
                                  want)


def _parent_span(job, state, keys, d0, d1, it, counts, **_):
    """The span as it was before the live prefix: every ray of the image
    runs it, and every plane of every ray is written (the live counts it
    is handed are not read)."""
    sc = K.plain_scene(**job)
    slots = torch.arange(state.shape[1])
    if d0 == 0:
        pix = slots
        st = K.init_state(sc, it, pix, job["width"], job["height"])
    else:
        pix = state[-1].view(torch.int32).long()
        st = {k: state[i].clone() for i, k in enumerate(keys) if k != "pix"}
        st["live"] = st["live"].to(torch.bool)
        if "emit_ok" in st:
            st["emit_ok"] = st["emit_ok"].to(torch.bool)
    st = K.bounces(sc, st, it, pix, d0, d1, counts)
    for i, k in enumerate(keys):
        if k != "pix":
            state[i] = st[k].to(torch.float32)
    if d0 == 0:
        state[-1] = slots.to(torch.int32).view(torch.float32)


@pytest.mark.parametrize("name", ["cornell", "cornell_mesh"])
def test_sorted_live_prefix_is_the_parents_engine(name):
    # each later span runs the tiles below the live count the span before
    # it left, and its dead rays read live alone: the image and counts of
    # the engine whose spans ran every ray and wrote every plane, of
    # trace_plain, and within the tie bound of the reference's engine
    scene = E.S.load(name, (), (32, 32), 4)
    job = K.prepare(scene, "cpu")
    box = SP.sort_box(scene, "cpu")
    got = SP.sorted_batch(job, 1, 2, *box)
    spans = []

    def spy(job, state, keys, d0, d1, it, counts, tbl=None, n_live=None,
            live_out=None):
        spans.append((d0, None if n_live is None else int(n_live)))
        SP.span_plain(job, state, keys, d0, d1, it, counts, tbl, n_live,
                      live_out)

    trace_span = SP.trace_span
    try:
        SP.trace_span = spy
        again = SP.sorted_batch(job, 1, 1, *box)
        SP.trace_span = _parent_span
        parent = SP.sorted_batch(job, 1, 2, *box)
        parent_one = SP.sorted_batch(job, 1, 1, *box)
    finally:
        SP.trace_span = trace_span
    E.assert_bit_equal(got, parent)
    E.assert_bit_equal(again, parent_one)
    E.assert_bit_equal(got, K.trace_plain(**job, it0=1, n_spp=2))
    # the count each later span was handed: the paths live entering it
    assert spans == [(0, None)] + [
        (d, int(parent_one[1][d])) for d in range(1, 4)]
    share = E.against_reference(pathtrace_batch_sorted,
                                ptt.pathtrace_batch_sorted, name, (32, 32), 4)
    assert share > 0.5


@pytest.mark.parametrize("sorted_engine", [False, True])
def test_span_leaves_a_dead_rays_planes_as_they_were(sorted_engine):
    # a ray that enters a span dead reads live alone and writes nothing;
    # a span given a live count of 0 writes nothing at all
    scene, _, _ = E.load("glass_bump_sss")
    job = K.prepare(scene, "cpu")
    keys = K.state_keys(job["features"], False, sorted_engine)
    n = 32 * 32
    state = torch.empty((len(keys), n))
    counts = torch.zeros(5, dtype=torch.int64)
    SP.trace_span(job, state, keys, 0, 2, 1, counts)
    dead = state[SP.LIVE_KEY] == 0
    assert 0 < int(dead.sum()) < n
    noise = torch.randn(state.shape, generator=torch.Generator().manual_seed(2))
    noise[SP.LIVE_KEY] = state[SP.LIVE_KEY]
    if sorted_engine:
        noise[-1] = state[-1]
    for d1 in (3, 5):  # a span that is not the last, and the last
        st = noise.clone()
        SP.trace_span(job, st, keys, 2, d1, 1, counts)
        assert torch.equal(st[:, dead].view(torch.int32),
                           noise[:, dead].view(torch.int32))
        assert not torch.equal(st[:, ~dead], noise[:, ~dead])
    if sorted_engine:
        st, out = noise.clone(), torch.zeros(1, dtype=torch.int32)
        SP.trace_span(job, st, keys, 2, 3, 1, counts,
                      n_live=torch.zeros(1, dtype=torch.int32), live_out=out)
        assert torch.equal(st.view(torch.int32), noise.view(torch.int32))
        assert int(out) == 0


def test_sorted_default_device_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene, _, _ = E.load("cornell")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        ptt.pathtrace_batch_sorted(scene, 1, 1)
