"""A numpy model of K8's exact gradient sums (``csrc/megakernel.cu``:
``fx_add``, ``fx_flush``, ``fx_round``): the table's bits do not depend on
the order or the grouping of the adds, which is why two calls give the same
bits.  The digits of 32 lanes' terms, summed before one add (as a warp
could sum them), must round to the same float32 as 32 separate adds (as
the kernel makes them), and to the float32 nearest the double nearest
their exact sum; negative terms, terms under 2^-64 (which add nothing) and
terms that are not finite (which flag the entry NaN) included.  The
limb-overflow bound of the kernel's comment is pinned."""

from fractions import Fraction

import numpy as np
import pytest

from pathtrace_tpu_torch.ops.cuda import matgrad as MG

LIMBS = 11          # kFxLimbs: 11 x 12-bit digits cover the 128 bits
MAX_LIGHTS = 64     # kFxMaxLights
BLOCK, MAX_DEPTH, WARP = 128, 32, 32


def digits(v):
    """fx_add's reading of float32 ``v``: (flag, k, [d0, d1, d2]) with the
    digits signed (negated for a negative term), k the lowest limb."""
    b = int(np.float32(v).view(np.uint32))
    ex = (b >> 23) & 0xFF
    sh = ex - 86
    if ex == 0 or sh <= -24:
        return False, 0, [0, 0, 0]
    if ex == 0xFF or sh > 102:
        return True, 0, [0, 0, 0]
    m = (b & 0x7FFFFF) | 0x800000
    k = 0 if sh < 0 else sh // 12
    t = m >> -sh if sh < 0 else m << (sh - 12 * k)
    sign = -1 if b >> 31 else 1
    return False, k, [sign * ((t >> (12 * j)) & 0xFFF) for j in range(3)]


def wrap32(x):
    """A limb: int32 two's complement, wrapping as the atomics do."""
    return (x + 2 ** 31) % 2 ** 32 - 2 ** 31


class Entry:
    """One entry of a block's table: limbs and flag."""

    def __init__(self):
        self.limbs = [0] * LIMBS
        self.flag = False

    def add_lane(self, v):
        """One lane's fx_add: its own atomics."""
        flag, k, d = digits(v)
        self.flag |= flag
        for j in range(3):
            if d[j]:
                self.limbs[k + j] = wrap32(self.limbs[k + j] + d[j])

    def add_group(self, vs):
        """The lanes ``vs`` of one warp on this entry at once: each
        limb's digits summed over the lanes (__reduce_add_sync), one add a
        limb."""
        read = [digits(v) for v in vs]
        self.flag |= any(f for f, _, _ in read)
        on = [(k, d) for f, k, d in read if not f and any(d)]
        if not on:
            return
        lo, hi = min(k for k, _ in on), max(k + 2 for k, _ in on)
        for j in range(lo, hi + 1):
            s = sum(d[j - k] for k, d in on if 0 <= j - k < 3)
            assert abs(s) < 2 ** 17  # 32 digits of at most 2^12 - 1
            if s:
                self.limbs[j] = wrap32(self.limbs[j] + s)

    def flushed(self):
        """fx_flush's 128-bit value of the limbs (each sign-extended,
        weighed 2^(12 k))."""
        return sum(v << (12 * k) for k, v in enumerate(self.limbs))


def rounded(total, flag):
    """fx_round: the 128-bit two's-complement total in units of 2^-64 to
    float32, through the double (hi) + (lo) 2^-64 of its magnitude."""
    if flag:
        return np.float32(np.nan)
    mag = abs(total) % 2 ** 128
    hi, lo = mag >> 64, mag & (2 ** 64 - 1)
    v = np.float64(hi) + np.float64(lo) * np.float64(2.0 ** -64)
    return np.float32(-v if total < 0 else v)


def exact(vs):
    """The float32 nearest the double nearest the exact sum of the terms
    at or above 2^-64 (a term below adds nothing)."""
    s = sum(Fraction(float(np.float32(v))) for v in vs
            if abs(float(np.float32(v))) >= 2.0 ** -64)
    return np.float32(float(s))


def terms(seed, n=WARP, lo=-80, hi=40):
    """float32 terms of both signs over exponents lo..hi."""
    r = np.random.RandomState(seed)
    mant = r.uniform(1.0, 2.0, n)
    return (np.where(r.rand(n) < 0.5, -1.0, 1.0) * mant
            * np.exp2(r.randint(lo, hi, n))).astype(np.float32)


@pytest.mark.parametrize("seed", range(6))
def test_a_warps_digits_summed_round_as_separate_adds(seed):
    vs = terms(seed)
    one, each = Entry(), Entry()
    one.add_group(vs)
    for v in vs:
        each.add_lane(v)
    assert one.limbs == each.limbs
    got = rounded(one.flushed(), one.flag)
    assert got == rounded(each.flushed(), each.flag) == exact(vs)


def test_negative_terms_that_cancel():
    vs = np.array([3.5, -3.5, 1e-3, -2e-3, 7.25, -7.25] + [1e-3] * 26,
                  np.float32)
    one = Entry()
    one.add_group(vs)
    assert rounded(one.flushed(), False) == exact(vs)
    neg = Entry()
    neg.add_group(-vs)
    assert rounded(neg.flushed(), False) == -exact(vs)


def test_terms_under_two_to_minus_64_add_nothing():
    tiny = np.float32(2.0 ** -65)
    vs = np.array([tiny] * 16 + [np.float32(2.0 ** -64)] * 16, np.float32)
    one, each = Entry(), Entry()
    one.add_group(vs)
    for v in vs:
        each.add_lane(v)
    assert one.limbs == each.limbs
    assert rounded(one.flushed(), False) == np.float32(16 * 2.0 ** -64)
    zero = Entry()
    zero.add_group(np.array([tiny, -tiny, 0.0, np.float32(1e-45)],
                            np.float32))
    assert zero.limbs == [0] * LIMBS and not zero.flag


@pytest.mark.parametrize("bad", [np.inf, -np.inf, np.nan, 2.0 ** 62])
def test_a_term_that_is_not_finite_flags_the_entry(bad):
    vs = terms(7)
    vs[5] = bad
    one, each = Entry(), Entry()
    one.add_group(vs)
    for v in vs:
        each.add_lane(v)
    assert one.flag and each.flag and one.limbs == each.limbs
    assert np.isnan(rounded(one.flushed(), one.flag))


def test_groups_of_any_split_give_the_same_limbs():
    # the lanes on an entry may meet in any grouping (the active lanes at
    # the call): integer sums commute
    vs = terms(11, n=4 * WARP)
    whole, split = Entry(), Entry()
    for q in range(4):
        whole.add_group(vs[q * WARP:(q + 1) * WARP])
    r = np.random.RandomState(3)
    i = 0
    while i < len(vs):
        n = int(r.randint(1, WARP + 1))
        split.add_group(vs[i:i + n])
        i += n
    assert whole.limbs == split.limbs
    assert rounded(whole.flushed(), False) == exact(vs)


def test_the_limb_overflow_bound():
    # one aggregated add: at most 32 digits of at most 2^12 - 1
    assert WARP * (2 ** 12 - 1) < 2 ** 17
    # a sample: at most 128 threads x depth x (n_lights + 3) terms to an
    # entry, one digit each to a limb: under 2^19 digits, whose sum a
    # 32-bit limb holds (|sum| < 2^31), however they are grouped
    assert BLOCK * MAX_DEPTH * (MAX_LIGHTS + 3) < 2 ** 19
    assert 2 ** 19 * (2 ** 12 - 1) < 2 ** 31
    # the worst case of one sample in the model: every term the largest
    # digit in one limb, in groups of a warp, sign-extended at the flush
    worst = np.float32(np.float32(4095 * 2.0 ** -64))
    assert digits(worst) == (False, 0, [4095, 0, 0])
    n = BLOCK * MAX_DEPTH * (MAX_LIGHTS + 3)
    for sign in (1, -1):
        e = Entry()
        for _ in range(n // WARP):
            e.add_group(np.full(WARP, sign * worst, np.float32))
        assert e.limbs[0] == sign * n * 4095
        assert e.flushed() == sign * n * 4095


# K7 (csrc/megakernel.cu k7_grads): a block folds its paths into its table
# in lanes that start their next sample as a path ends, and flushes the
# table into the global one every chunk of samples, after at most
# MG.k7_flush_paths(depth) paths; each event of a path adds its terms.
K7_POOL_MAX = 8  # csrc kLanePxMax: a block's pool, pixels a lane at most


@pytest.mark.parametrize("depth", range(1, MG.MAX_DEPTH + 1))
def test_k7_flush_paths_keeps_every_limb_under_its_capacity(depth):
    n = MG.k7_flush_paths(depth)
    # at most one term an event to an entry, one digit a limb, depth
    # events a path
    assert n * depth < 2 ** 19 <= (n + 1) * depth
    assert n * depth * (2 ** 12 - 1) < 2 ** 31
    # a chunk holds at least one sample of the largest pool
    assert n >= BLOCK * K7_POOL_MAX
    if depth in (1, 8, MG.MAX_DEPTH):
        # the worst case in the model: every event of every path one term
        # of the largest digit, into one limb, of either sign
        worst = np.float32(4095 * 2.0 ** -64)
        for sign in (1, -1):
            e = Entry()
            for _ in range(n * depth):
                e.add_lane(sign * worst)
            assert e.limbs[0] == sign * n * depth * 4095


def _k7_paths(seed, n_pix, spp, depth, n_mats):
    """Random paths: (w (3,) float32, events [(material, kind)]) of each
    pixel and sample, as K7's bounce records them."""
    r = np.random.RandomState(seed)
    paths = {}
    for pix in range(n_pix):
        for s in range(spp):
            n_ev = int(r.randint(0, depth + 1))
            ev = [(int(r.randint(n_mats)), int(r.randint(5)))
                  for _ in range(n_ev)]
            w = (r.rand(3) * np.exp2(r.randint(-20, 4, 3))).astype(np.float32)
            paths[pix, s] = (w, ev)
    return paths


def _k7_terms(w, ev, mtab):
    """grad_fold's terms of one path: [(entry, value)], entry = row *
    n_mats + material."""
    n_mats, eps = mtab.shape[0], np.float32(1e-8)
    wsum = np.float32(np.float32(w[0] + w[1]) + w[2])
    out = []
    for m, kind in ev:
        col = 3 if kind in (1, 3) else 0
        for ch in range(3):
            x = mtab[m, col + ch]
            if x > eps:
                out.append(((col + ch) * n_mats + m, np.float32(w[ch] / x)))
        if kind == 2 and mtab[m, 6] > eps:
            out.append((6 * n_mats + m, np.float32(wsum / mtab[m, 6])))
        pm = np.float32(min(max(mtab[m, 7], 0.0), 1.0))
        if kind == 1 and pm > eps:
            out.append((7 * n_mats + m, -np.float32(wsum / pm)))
        if kind == 0 and np.float32(1.0 - pm) > eps:
            out.append((7 * n_mats + m,
                        np.float32(wsum / np.float32(1 - pm))))
    return out


def _k7_table(order, paths, mtab, flush_paths):
    """The rounded (8, M) table of the paths folded in ``order`` (a list
    of blocks, each a list of (pixel, sample) in the order its lanes end
    them), a block's table flushed every ``flush_paths`` paths."""
    n = 8 * mtab.shape[0]
    total = [0] * n
    flags = [False] * n
    for block in order:
        tab = [Entry() for _ in range(n)]
        for i, key in enumerate(block):
            for e, v in _k7_terms(*paths[key], mtab):
                tab[e].add_lane(v)
            if (i + 1) % flush_paths == 0 or i + 1 == len(block):
                for e in range(n):
                    total[e] += tab[e].flushed()
                    flags[e] |= tab[e].flag
                tab = [Entry() for _ in range(n)]
    return np.array([rounded(t, f) for t, f in zip(total, flags)],
                    np.float32)


def test_k7_fold_gives_the_same_bits_in_pixel_and_pool_order():
    # the lockstep kernel: pixel order, a flush after every sample; the
    # lane schedule: pools of 2 pixels a lane, the paths ending in a
    # permuted order, a flush every 96 paths: the same bits
    n_pix, spp, depth, n_mats, lanes = 8 * 8, 6, 8, 5, 16
    r = np.random.RandomState(5)
    mtab = r.rand(n_mats, 8).astype(np.float32)
    mtab[1, 7], mtab[2, 0], mtab[3, 7] = 0.0, 0.0, 1.0
    paths = _k7_paths(1, n_pix, spp, depth, n_mats)
    # repeats of one (material, kind) in a path, as walls of one material
    paths[0, 0] = (paths[0, 0][0], [(4, 0)] * depth)
    lockstep = [[(pix, s) for pix in range(b, b + lanes)]
                for b in range(0, n_pix, lanes) for s in range(spp)]
    pool = []
    for b in range(0, n_pix, 2 * lanes):
        block = [(pix, s) for pix in range(b, b + 2 * lanes)
                 for s in range(spp)]
        pool.append([block[i] for i in r.permutation(len(block))])
    want = _k7_table(lockstep, paths, mtab, lanes)
    got = _k7_table(pool, paths, mtab, 96)
    assert want.tobytes() == got.tobytes()
    # and the float64 sum of the float32 terms, rounded
    exact64 = np.zeros(8 * n_mats)
    for key in paths:
        for e, v in _k7_terms(*paths[key], mtab):
            exact64[e] += float(v)
    np.testing.assert_allclose(got, exact64.astype(np.float32), rtol=1e-6)
