"""How a gradient kernel (K7, K8) is held against its plain version on the
card; used by ``chip_smoke.py`` and ``test_torch_cuda.py``.

Entry by entry, |g - w| <= atol + rtol |w| + share max|w|, with the
reference's rtol and atol (K8 2e-4 / 3e-4, ``tests/test_vjp_kernel.py``;
K7 1e-5 / 1e-4, ``tests/test_grad_kernel.py``) and a share of 0, the
reference's tolerance as it stands, but in two cases.

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

At full size (800x800 or 1920x1080, depth 8) the other pixels' terms
still reach 1e5 to 1e7 and cancel, and over millions of pixels the
kernel's and the plain version's float32 roundings part by more than the
reference's tolerance.  There each entry is held to the reference's
tolerance plus float32's epsilon times the entry's own term magnitude
(:func:`compare_terms`): the same backward pass taken on absolute values
(:class:`AbsTerms`), the sum of |term| over the products of partials
that make the entry.  The two readings share their forward pass bit for
bit (K8's radiance is K1's, K1's the plain version's), so what parts
them is the backward's rounding, which that bound covers to first order.
A third reading, the plain version in float64 (:func:`reading64`, on
the pixels whose float64 radiance is the float32 one's,
:func:`same_paths`), shows where the float32 answer lies: its distance
from both is printed beside.
"""

import torch
from torch.utils._python_dispatch import TorchDispatchMode

FIREFLY = 4.0
FIREFLY_SHARE = 1e-7
K8_TOL = (2e-4, 3e-4)  # rtol, atol
K7_TOL = (1e-5, 1e-4)
EPS32 = float(torch.finfo(torch.float32).eps)
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
    function of a cotangent ``ct`` (P,3) giving (the gradients of
    sum(ct * rad), one a table, and their terms' magnitudes, from
    :class:`AbsTerms`)); the function runs once."""
    leaf = [t.detach().double().requires_grad_(True) for t in tables]
    rad = trace(*leaf)

    def grads(ct):
        ct = ct.double()
        g = torch.autograd.grad(rad, leaf, ct, retain_graph=True,
                                allow_unused=True)
        mode = AbsTerms()
        with mode:
            m = torch.autograd.grad(rad, leaf, ct.abs(), allow_unused=True)
        if not mode.calls:
            raise RuntimeError("the term magnitudes' pass saw no backward op")
        return ([torch.zeros_like(t) if x is None else x
                 for x, t in zip(g, leaf)],
                [torch.zeros_like(t) if x is None else x
                 for x, t in zip(m, leaf)])

    return rad.detach(), grads


def same_paths(rad32, rad64):
    """(P,) bool: the pixels whose float64 radiance is within
    ``SAME_PATH`` * (1 + |rad|) of the float32 one, which took the same
    path (a float64 hit, lobe or roulette that flips makes another)."""
    rad64 = rad64.to(rad32.device)
    return ((rad64 - rad32.double()).abs()
            <= SAME_PATH * (1.0 + rad32.double().abs())).all(-1)


def compare_terms(got, want, mags, rtol, atol):
    """Each (name, gradient) of ``got`` against ``want``'s, entry by
    entry |g - w| <= atol + rtol |w| + EPS32 * m, with m the entry's term
    magnitude in ``mags`` (:func:`reading64`).  Returns a row a name:
    (name, max|w|, max|g - w|, the largest |g - w| / (that bound), the
    largest |g - w| / (EPS32 * m) among the entries over atol + rtol |w|
    (0 if none), ok), ok False also for a gradient that is not finite."""
    rows = []
    for (name, g), (_, w), (_, m) in zip(got, want, mags):
        if not w.numel():
            continue
        w, m = w.to(g.device).double(), m.to(g.device)
        diff = (g.double() - w).abs()
        bare = atol + rtol * w.abs()
        ratio = float((diff / (bare + EPS32 * m)).max())
        over = diff > bare
        need = float((diff[over] / (EPS32 * m[over])).max()) \
            if bool(over.any()) else 0.0
        rows.append((name, float(w.abs().max()), float(diff.max()), ratio,
                     need, bool(torch.isfinite(g).all()) and ratio <= 1.0))
    return rows
