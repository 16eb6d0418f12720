"""The check that decides ``correct``: what the timed path produced,
held against the plain reference (``benchmark/reference``), which works
out every table again from the configuration and runs once the window
has closed and the program's state is freed.

Render jobs: the last image the window finished (the program's
accumulation as it was copied to the host), on a sample of its pixels
drawn from the seed, against the reference's sum over the same samples
(``img_gap``: the summed absolute gap over the summed reference; the
channel gaps of the worst pixel, ``img_worst``, as a mean radiance); and
the live counts of one chunk of the window (the smallest, the seed
drawing among equals), against the reference's over the whole image
(``counts_gap``: the largest relative gap of a bounce).

``inverse_light``: the first steps the set-up ran through the window's
own call, each against the reference's own step from the same start (the
image's ``img_gap``; ``loss_gap``, the largest relative gap of a step's
loss; ``grad_gap``, the relative gap of the norms of the first gradient;
``step_gap``, the gap of the light's moves after the steps over the
reference's move: the step is capped at ``max_step``, so its length
alone would not see a gradient turned).

The control (``control.py``) puts the reference computed in bfloat16 in
the program's place: :func:`render_numbers` and :func:`inverse_numbers`
take the program's outputs, or the control's, in one form.
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference import tables as RT
from ..reference import tracer as RTR

SAMPLE_PIXELS = 1024


def generator(seed, salt):
    g = torch.Generator()
    g.manual_seed((seed * 1000003 + salt) % (2 ** 63))
    return g


def pixel_sample(seed, n_pix, k=SAMPLE_PIXELS):
    """``k`` distinct pixel ids drawn from ``seed``, sorted."""
    return torch.sort(torch.randperm(n_pix, generator=generator(seed, 1))[
        :min(k, n_pix)]).values


def pick_chunk(seed, chunks):
    """The chunk whose counts are checked: the smallest, drawn among
    equals from ``seed``."""
    least = min(c[1] for c in chunks)
    at = [i for i, c in enumerate(chunks) if c[1] == least]
    return chunks[at[int(torch.randint(len(at), (1,),
                                       generator=generator(seed, 2)))]]


def ref_image(tab, it0, n, pixels, dtype=torch.float32, rr=False):
    """The reference's sum over samples ``it0 .. it0 + n - 1`` of
    ``pixels``, float64 (P, 3)."""
    its = (it0 + torch.arange(n, dtype=torch.int64))[:, None].expand(
        n, pixels.numel()).reshape(-1)
    pix = pixels[None, :].expand(n, -1).reshape(-1)
    rad, _ = RTR.trace_paths(tab, its, pix, rr=rr, dtype=dtype)
    return rad.double().reshape(n, -1, 3).sum(0).cpu()


def ref_counts(tab, it0, n, n_pix, dtype=torch.float32, rr=False):
    """The reference's live counts of samples ``it0 .. it0 + n - 1`` over
    the whole image, (depth,) int64."""
    its = (it0 + torch.arange(n, dtype=torch.int64))[:, None].expand(
        n, n_pix).reshape(-1)
    pix = torch.arange(n_pix, dtype=torch.int64)[None, :].expand(
        n, -1).reshape(-1)
    return RTR.trace_paths(tab, its, pix, rr=rr, dtype=dtype)[1].cpu()


def render_numbers(img, ref, counts, ref_c, n):
    """The numbers compared for a render job: ``img`` and ``ref`` the
    program's (or the control's) and the reference's sums over ``n``
    samples of the sampled pixels, ``counts`` and ``ref_c`` one chunk's
    live counts."""
    img = torch.as_tensor(np.asarray(img), dtype=torch.float64)
    gap = (img - ref).abs()
    counts = torch.as_tensor(np.asarray(counts), dtype=torch.float64)
    ref_c = torch.as_tensor(np.asarray(ref_c), dtype=torch.float64)
    return dict(
        img_gap=float(gap.sum() / ref.abs().sum().clamp_min(1e-30)),
        img_worst=float(gap.max()) / max(n, 1),
        counts_gap=float(((counts - ref_c).abs()
                          / ref_c.clamp_min(1.0)).max()))


def check_render(run, out, dtype=torch.float32):
    """The render job's numbers: the program's outputs ``out`` against
    the reference, or, with ``dtype`` other than float32, the control's
    (the reference in ``dtype`` in the program's place)."""
    scene = RT.scene_from_config(run.config, run.obj_paths)
    tab, n_pix = RT.pack(scene, device=run.device, nee=out["nee"]), \
        scene.pixel_count
    it0, n, host = out["image"]
    pixels = pixel_sample(run.seed, n_pix)
    c_it0, c_n, c_counts = pick_chunk(run.seed, out["chunks"])
    rr = out.get("rr", False)
    ref = ref_image(tab, it0, n, pixels, rr=rr)
    ref_c = ref_counts(tab, c_it0, c_n, n_pix, rr=rr)
    if dtype != torch.float32:
        img = ref_image(tab, it0, n, pixels, dtype, rr).numpy()
        c_counts = ref_counts(tab, c_it0, c_n, n_pix, dtype, rr).numpy()
    else:
        img = host[pixels.numpy()]
    return render_numbers(img, ref, c_counts, ref_c, n)


def _ref_step(run, scene, target, tr, dtype, fault=None):
    """One reference step from light position ``tr``: (image, loss, the
    light's gradient, float64, the position after the step); ``fault``
    plants one of the program's faults in it (``half``: half the samples;
    ``altered``: the gradient's first component turned; ``stale``: the
    light left where it was)."""
    mix = run.traffic
    light = mix["light"]
    spp = mix["spp"] // 2 if fault == "half" else mix["spp"]
    t = torch.tensor(tr, dtype=torch.float32, requires_grad=True)
    tab = RT.pack(scene, translation=t, device=run.device, nee=True)
    n_pix = scene.pixel_count
    with torch.no_grad():
        img = RTR.trace(tab, run.seed + 1, spp, dtype=dtype)[0].float() / spp
    ct = (img - target) * (2.0 / (n_pix * 3 * spp))
    for s in range(spp):  # a sample's graph at a time
        rad = RTR.trace(tab, run.seed + 1 + s, 1, dtype=dtype)[0].float()
        torch.autograd.backward((rad * ct).sum(), retain_graph=True)
    g = t.grad[light].to(torch.float64).numpy()
    if fault == "altered":
        g = g * np.array([-1.0, 1.0, 1.0])
    loss = float(torch.mean((img - target) ** 2))
    upd = mix["lr"] * g
    norm = np.linalg.norm(upd)
    if norm > mix["max_step"]:
        upd = upd * (mix["max_step"] / norm)
    nxt = tr.copy()
    if fault != "stale":
        nxt[light] = (nxt[light] - upd).astype(np.float32)
    return img.cpu().numpy(), loss, g, nxt


def inverse_numbers(steps, ref_steps, start, light):
    """The numbers compared for ``inverse_light``: ``steps`` and
    ``ref_steps`` lists of (image, loss, gradient, position after)."""
    img_gap = max(float(np.abs(a[0] - b[0]).sum()
                        / max(np.abs(b[0]).sum(), 1e-30))
                  for a, b in zip(steps, ref_steps))
    loss_gap = max(abs(a[1] - b[1]) / max(abs(b[1]), 1e-30)
                   for a, b in zip(steps, ref_steps))
    gp, gr = (np.linalg.norm(s[0][2]) for s in (steps, ref_steps))
    mp, mr = (np.asarray(s[-1][3], np.float64)
              - np.asarray(start[light], np.float64)
              for s in (steps, ref_steps))
    return dict(img_gap=float(img_gap), loss_gap=float(loss_gap),
                grad_gap=float(abs(gp - gr) / max(gr, 1e-30)),
                step_gap=float(np.linalg.norm(mp - mr)
                               / max(np.linalg.norm(mr), 1e-30)))


def check_inverse(run, out, dtype=torch.float32, fault=None):
    """``inverse_light``'s numbers: the set-up's steps of the program
    (``out``) against the reference's, or with ``dtype`` other than
    float32 the control's (its target rendered in ``dtype`` too), or with
    ``fault`` the reference's with that fault planted."""
    mix = run.traffic
    light = mix["light"]
    scene = RT.scene_from_config(run.config, run.obj_paths)
    tab = RT.pack(scene, device=run.device, nee=True)

    def steps(dt, fault=None):
        with torch.no_grad():
            target = RTR.trace(tab, run.seed + 1, mix["spp"],
                               dtype=dt)[0].float() / mix["spp"]
        got, tr = [], out["start"].copy()
        for _ in out["checked"]:
            img, loss, g, tr = _ref_step(run, scene, target, tr, dt, fault)
            got.append((img, loss, g, tr[light].copy()))
        return got

    ref = steps(torch.float32)
    prog = (steps(dtype, fault) if dtype != torch.float32 or fault else
            [(c["image"], c["loss"], c["grad"], c["position"])
             for c in out["checked"]])
    return inverse_numbers(prog, ref, out["start"], light)


CHECKS = {"render": check_render, "inverse_light": check_inverse}
