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

The other pixels of the full image, 800x800 depth 8, are held with
``FULL_SHARE``, about three times the share measured there: the plain
version's float32 sums over 640,000 pixels (the kernels' are exact) and
the NEE samples near the light that stay under the firefly line both
count there.
"""

import torch

FIREFLY = 4.0
FIREFLY_SHARE = 1e-7
FULL_SHARE = 2e-10
K8_TOL = (2e-4, 3e-4)  # rtol, atol
K7_TOL = (1e-5, 1e-4)


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
