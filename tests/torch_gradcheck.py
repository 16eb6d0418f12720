"""How a gradient kernel (K7, K8) is held against its plain version on the
card; used by ``chip_smoke.py`` and ``test_torch_cuda.py``.

Entry by entry, |g - w| <= atol + rtol |w| + share max|w|, with the
reference's rtol and atol (K8 2e-4 / 3e-4, ``tests/test_vjp_kernel.py``;
K7 1e-5 / 1e-4, ``tests/test_grad_kernel.py``) and a share of 0, the
reference's tolerance as it stands, but in the cases below.

A pixel whose NEE sample lands close to the light (r^2 small) comes out
far brighter than the light itself.  Its gradient terms reach 1e7 on
cornell and cancel to a few hundred in some entries (gmat's inverse rows,
and the scale that the host chains from them), and the kernel (adjoints
written by hand) and the plain version (autograd) round them in float32
along different orders.  So the cotangent is split (:func:`split`): the
pixels brighter than ``FIREFLY`` times the scene's brightest emittance,
on average over their samples (:func:`fireflies`), are held apart with
``FIREFLY_SHARE`` of their part's own largest entry, about three times
the largest share measured on an H100 (PERF.md §6).

At full size (800x800 or 1920x1080, depth 8) with NEE the other pixels'
terms still reach 1e5 to 1e7 and cancel, and over millions of pixels the
kernel's and the plain version's float32 roundings part by more than the
reference's tolerance.  There each entry is held to the reference's
tolerance plus twice the plain version's own distance from a third
reading, the plain version in float64 (:func:`reading64`, on the pixels
whose float64 radiance is the float32 one's, :func:`same_paths`):
a kernel as accurate as the plain version is that near it
(:func:`compare_own`).  Each table's limit beyond the bare tolerance, as
a share of its largest entry, is part of the row, and a share over 1 (a
limit that could not fail) is a miss.  The builds with bump and NEE are
held so at any size and on both parts of the cotangent: the tilted
normal's derivative through the inverse-transpose magnifies float32
rounding past the bare tolerance at 64x64 depth 4 already.

``render_vjp``'s parameter groups, which the host chains from the tables
through the packing, are held in K8's section builds to the tables'
bound carried through that chain on absolute values (:func:`chain_bound`,
:func:`compare_chained`; :class:`AbsTerms`): the chain divides by the
scale (the floor's 0.01) and so magnifies the tables' rounding.
"""

import torch
from torch.utils._python_dispatch import TorchDispatchMode

FIREFLY = 4.0
FIREFLY_SHARE = 1e-7
K8_TOL = (2e-4, 3e-4)  # rtol, atol
K7_TOL = (1e-5, 1e-4)
# float64 and float32 radiance within SAME_PATH * (1 + |rad|): the same path
SAME_PATH = 1e-4


def fireflies(rad, n_spp, emittance):
    """(P,) bool: the pixels whose radiance ``rad`` (P,3), summed over
    ``n_spp`` samples, is on average brighter than ``FIREFLY`` times the
    largest of ``emittance``."""
    return rad.amax(-1) / n_spp > FIREFLY * float(max(emittance))


def split(ct, mask):
    """(``ct`` off the pixels of ``mask``, ``ct`` on them)."""
    on = mask[:, None].to(ct.device)
    return torch.where(on, 0.0, ct), torch.where(on, ct, 0.0)


def compare(got, want, rtol, atol, share=None):
    """Each (name, gradient) of ``got`` against ``want``'s, with
    ``share`` a share of max|w| for every name (0 for None).  Returns a
    row a name: (name, max|w|, max|g - w|, the largest |g - w| / (atol +
    rtol |w|), the share the worst entry needed, ok), ok False also for a
    gradient that is not finite."""
    rows = []
    for (name, g), (_, w) in zip(got, want):
        if not w.numel():
            continue
        diff, scale = (g - w).abs(), float(w.abs().max())
        bare = atol + rtol * w.abs()
        over = float((diff - bare).max().clamp_min(0.0))
        ok = bool(torch.isfinite(g).all()) and over <= (share or 0.0) * scale
        rows.append((name, scale, float(diff.max()),
                     float((diff / bare).max()),
                     over / scale if scale else 0.0, ok))
    return rows


class AbsTerms(TorchDispatchMode):
    """Inside it, a backward pass sums the magnitudes of the terms of each
    gradient entry instead of the terms: every sum, difference, product,
    quotient and negation is taken on absolute values (the ops that can
    change a sign; a scatter of what they give adds magnitudes).  An
    entry is a sum of products of partials along the graph, so the pass
    gives the sum of |product| over them (and more where a partial is
    itself a difference).  ``calls`` counts the ops it changed."""

    ADD = ("add", "sub", "rsub")
    ABS = ("mul", "div", "neg", "sum")

    def __init__(self):
        super().__init__()
        self.calls = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        name = func.overloadpacket.__name__
        base, inplace = name.rstrip("_"), name.endswith("_")
        if base not in self.ADD + self.ABS:
            return func(*args, **kwargs)
        self.calls += 1
        target, args = args[0], [_abs(x) for x in args]
        if base in self.ADD:
            # a + alpha b, a - alpha b: |a| + |alpha| |b|; rsub's b - alpha
            # a: |alpha| |a| + |b|
            alpha = abs(kwargs.pop("alpha", 1))
            out = (torch.add(args[0] * alpha, args[1]) if base == "rsub"
                   else torch.add(args[0], args[1], alpha=alpha))
        else:
            out = func(*args, **kwargs)
        if inplace:
            return target.copy_(out)
        return out


def _abs(x):
    if torch.is_tensor(x):
        return x.abs() if x.is_floating_point() else x
    return abs(x) if isinstance(x, (int, float)) else x


def reading64(trace, tables):
    """The plain version in float64: ``trace(*leaves)`` is its radiance
    (P,3) on float64 copies of ``tables``.  Returns (the radiance, a
    function of a cotangent ``ct`` (P,3) giving the gradients of sum(ct *
    rad), one a table); the function runs once."""
    leaf = [t.detach().double().requires_grad_(True) for t in tables]
    rad = trace(*leaf)

    def grads(ct):
        g = torch.autograd.grad(rad, leaf, ct.double(), allow_unused=True)
        return [torch.zeros_like(t) if x is None else x
                for x, t in zip(g, leaf)]

    return rad.detach(), grads


def same_paths(rad32, rad64):
    """(P,) bool: the pixels whose float64 radiance is within
    ``SAME_PATH`` * (1 + |rad|) of the float32 one, which took the same
    path (a float64 hit, lobe or roulette that flips makes another)."""
    rad64 = rad64.to(rad32.device)
    return ((rad64 - rad32.double()).abs()
            <= SAME_PATH * (1.0 + rad32.double().abs())).all(-1)


def compare_own(got, want, w64, rtol, atol):
    """Each (name, gradient) of ``got`` against ``want``'s, entry by
    entry |g - w| <= atol + rtol |w| + 2 |w - w64|, with ``w64`` the
    float64 reading (:func:`reading64`): a kernel as accurate as the plain
    version, each of them its float32 error |w - w64| from float64, is at
    most twice that from it.  Returns a row a name: (name, max|w|,
    max|g - w|, the largest |g - w| / (that bound), the largest
    |g - w| / |w - w64| among the entries over atol + rtol |w| (0 if
    none), the limit beyond the bare tolerance as a share of the table,
    max 2 |w - w64| / max|w|, ok), ok False also for a gradient that is
    not finite and for a share over 1 (a limit that could not fail)."""
    rows = []
    for (name, g), (_, w), (_, w6) in zip(got, want, w64):
        if not w.numel():
            continue
        w, w6 = w.to(g.device).double(), w6.to(g.device)
        diff = (g.double() - w).abs()
        bare = atol + rtol * w.abs()
        own = (w - w6).abs()
        over = diff > bare
        need = float((diff[over] / own[over]).max()) \
            if bool(over.any()) else 0.0
        ratio = float((diff / (bare + 2.0 * own)).max())
        scale = float(w.abs().max())
        room = float(2.0 * own.max()) / scale if scale else (
            float("inf") if bool(own.any()) else 0.0)
        rows.append((name, scale, float(diff.max()), ratio, need, room,
                     bool(torch.isfinite(g).all()) and ratio <= 1.0
                     and room <= 1.0))
    return rows


def chain_bound(scene, nee, tables_bound):
    """The bound on each parameter of ``render/diff.split_params`` that
    a bound on each packed table's gradient gives: render_vjp carries the
    table gradients to the parameters through the packing's backward,
    and there each parameter takes sum |d table / d param| times the
    table's bound (the backward on absolute values, :class:`AbsTerms`).
    ``tables_bound``: (cam, mats, gmat(, lights)) bounds, on any device.
    Returns [(name, bound)] as ``render/diff.named_leaves``."""
    from pathtrace_tpu_torch.ops.cuda import megakernel as K
    from pathtrace_tpu_torch.render import diff as D

    params = D.requires_grad(D.split_params(scene))
    sc = D.merge_params(scene, params)
    tables = list(K.pack_scene(sc, "cpu"))
    if nee:
        tables.append(K.pack_lights(sc, "cpu")[0])
    with AbsTerms():
        torch.autograd.backward(tables, [b.detach().cpu().abs().float()
                                         for b in tables_bound])
    return D.named_leaves(D.grads(params))


def compare_chained(got, want, bounds, rtol, atol):
    """Each (name, parameter gradient) of ``got`` against ``want``'s,
    entry by entry |g - w| <= atol + rtol |w| + b, b the entry's
    :func:`chain_bound`.  Rows as :func:`compare`'s, the share column
    the largest |g - w| / b among the entries over atol + rtol |w|."""
    rows = []
    for (name, g), (_, w), (_, b) in zip(got, want, bounds):
        if not w.numel():
            continue
        w, b = w.to(g.device), b.to(g.device)
        diff = (g - w).abs()
        bare = atol + rtol * w.abs()
        over = diff > bare
        need = float((diff[over] / b[over]).max()) if bool(over.any()) \
            else 0.0
        ok = bool(torch.isfinite(g).all()) and bool(
            (diff <= bare + b).all())
        rows.append((name, float(w.abs().max()), float(diff.max()),
                     float((diff / (bare + b)).max()), need, ok))
    return rows
