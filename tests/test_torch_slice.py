"""The port's main path as a whole: CLI -> K1 (plain version on the CPU)
-> accumulation -> PNG, against the reference's Pallas path in interpret
mode.  Bounds as in ``tests/test_torch_megakernel.py`` (tie flips)."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import pathtrace_tpu as pt
from pathtrace_tpu.io import image_io as ref_io
from pathtrace_tpu.ops.pallas.megakernel import pathtrace_batch_pallas
from pathtrace_tpu.render.plane_engine import pathtrace_batch_planes
import pathtrace_tpu_torch as ptt
from pathtrace_tpu_torch import cli
from pathtrace_tpu_torch.io import image_io

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORNELL = os.path.join(REPO, "scenes", "cornell.txt")


def test_cli_slice_matches_reference(tmp_path, monkeypatch):
    seen = []
    to_display = image_io.to_display

    def spy(accum, *args):
        seen.append(np.array(accum))
        return to_display(accum, *args)

    monkeypatch.setattr(image_io, "to_display", spy)
    out = tmp_path / "c.png"
    assert cli.main([CORNELL, "--device", "cpu", "--res", "32", "32",
                     "--depth", "4", "--spp", "2", "--out", str(out)]) == 0
    assert out.exists()
    (accum,) = seen

    scene = pt.load_scene(CORNELL)
    scene = dataclasses.replace(scene, resolution=(32, 32), trace_depth=4)
    ref_rad, _ = pathtrace_batch_pallas(scene, 1, 2, interpret=True)
    d = np.abs(accum - np.asarray(ref_rad)).max(axis=-1)
    assert (d > 1e-3).mean() < 0.005

    png = np.asarray(Image.open(out))
    np.testing.assert_array_equal(
        png, ref_io.to_uint8(ref_io.to_display(accum, 32, 32, 2)))


def test_cli_glass_nee_matches_reference(tmp_path, monkeypatch):
    seen = []
    to_display = image_io.to_display

    def spy(accum, *args):
        seen.append(np.array(accum))
        return to_display(accum, *args)

    monkeypatch.setattr(image_io, "to_display", spy)
    glass = os.path.join(REPO, "scenes", "cornell_glass.txt")
    assert cli.main([glass, "--device", "cpu", "--res", "32", "32",
                     "--depth", "4", "--spp", "2", "--nee",
                     "--out", str(tmp_path / "g.png")]) == 0
    (accum,) = seen
    scene = pt.load_scene(glass)
    scene = dataclasses.replace(scene, resolution=(32, 32), trace_depth=4)
    ref_rad, _ = pathtrace_batch_planes(scene, 1, 2, nee=True)
    d = np.abs(accum - np.asarray(ref_rad)).max(axis=-1)
    assert (d > 1e-3).mean() < 0.005


@pytest.mark.parametrize("flag", [
    ["--engine", "planes"], ["--engine", "xla"], ["--shard"],
    ["--checkpoint", "x.ckpt"], ["--interactive", "ctl"],
    ["--resume"], ["--preview-every", "4"], ["--checkpoint-every", "4"],
])
def test_cli_unported_flags_raise(flag):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cli.main([CORNELL, "--device", "cpu", *flag])


@pytest.mark.parametrize("flag", [["--engine", "xla"],
                                  ["--engine", "planes"]])
def test_cli_wavefront_flags_name_item_3(flag):
    # the wavefront twin was item 3 of the ROADMAP's Queue 1 before its
    # re-anchoring; it is item 1 now
    with pytest.raises(NotImplementedError, match="Queue 1 item 1 "):
        cli.main([CORNELL, "--device", "cpu", *flag])


@pytest.mark.parametrize("flag,item", [
    (["--shard"], "item 4"), (["--checkpoint", "x.ckpt"], "item 5"),
    (["--resume"], "item 5"), (["--preview-every", "4"], "item 5"),
    (["--checkpoint-every", "4"], "item 5"),
    (["--interactive", "ctl"], "item 5")])
def test_cli_unported_flags_name_their_item(flag, item):
    with pytest.raises(NotImplementedError, match=f"Queue 1 {item} "):
        cli.main([CORNELL, "--device", "cpu", *flag])


@pytest.mark.parametrize("engine", [[], ["--engine", "sorted"]])
def test_cli_compaction_sort_masks_with_a_warning(monkeypatch, tmp_path,
                                                  capsys, engine):
    # as the reference's tiled engines: a warning, then the image of
    # --compaction mask
    got = _cli_accum(monkeypatch, tmp_path, ["--compaction", "sort", *engine])
    assert "WARNING: --compaction sort" in capsys.readouterr().out
    want = _cli_accum(monkeypatch, tmp_path, engine)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_cli_interpret_is_the_cpu_device(monkeypatch, tmp_path):
    # --interpret runs the plain versions, as --device cpu does
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "i.png"
    assert cli.main([CORNELL, "--interpret", "--res", "8", "8", "--depth",
                     "3", "--spp", "1", "--out", str(out)]) == 0
    want = tmp_path / "c.png"
    assert cli.main([CORNELL, "--device", "cpu", "--res", "8", "8",
                     "--depth", "3", "--spp", "1", "--out", str(want)]) == 0
    np.testing.assert_array_equal(np.asarray(Image.open(out)),
                                  np.asarray(Image.open(want)))


def test_entry_points_take_compaction_and_remat():
    scene = ptt.load_scene(CORNELL)
    scene = dataclasses.replace(scene, resolution=(8, 6), trace_depth=3)
    want = ptt.pathtrace_batch(scene, 1, 2, device="cpu")
    # positionally, as the reference's (scene, it0, n_iters, compaction,
    # remat, nee, rr)
    got = ptt.pathtrace_batch(scene, 1, 2, "sort", False, device="cpu")
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert want[1].shape == (2, 3)  # per sample, as the reference's
    acc = ptt.render(scene, 2, 2, "sort", device="cpu")
    assert torch.equal(acc, want[0])
    with pytest.raises(ValueError, match="compaction"):
        ptt.pathtrace_batch(scene, 1, 1, "dense", device="cpu")


def _cli_accum(monkeypatch, tmp_path, flags, scene=CORNELL):
    seen = []
    to_display = image_io.to_display

    def spy(accum, *args):
        seen.append(np.array(accum))
        return to_display(accum, *args)

    monkeypatch.setattr(image_io, "to_display", spy)
    out = tmp_path / f"{len(flags)}.png"
    assert cli.main([scene, "--device", "cpu", "--res", "20", "18",
                     "--depth", "5", "--spp", "3", "--chunk", "2",
                     "--out", str(out), *flags]) == 0
    monkeypatch.undo()
    return seen[0], np.asarray(Image.open(out))


@pytest.mark.parametrize("flags", [
    ["--split-depth", "2"], ["--split-depth", "1", "--rr"],
    ["--split-depth", "9"], ["--engine", "sorted"],
    ["--engine", "sorted", "--nee"], ["--engine", "sorted", "--split-depth",
                                      "2"]])
def test_cli_engines_render_the_default_engine_image(monkeypatch, tmp_path,
                                                     flags):
    # the split and sorted engines render K1's image, bit for bit, in
    # chunks of --chunk samples
    got = _cli_accum(monkeypatch, tmp_path, flags)
    options = [f for f in flags if f in ("--nee", "--rr")]
    want = _cli_accum(monkeypatch, tmp_path, options)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("flags", [["--nee"], ["--rr"], ["--nee", "--rr"]])
def test_cli_nee_rr_render(flags, tmp_path):
    out = tmp_path / "c.png"
    assert cli.main([CORNELL, "--device", "cpu", "--res", "8", "8",
                     "--depth", "4", "--spp", "2", "--out", str(out),
                     *flags]) == 0
    assert np.asarray(Image.open(out)).shape == (8, 8, 3)


def test_cli_cuda_without_gpu_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        cli.main([CORNELL, "--res", "8", "8", "--spp", "1",
                  "--out", str(tmp_path / "x.png")])


def test_render_chunks_equal_one_batch():
    scene = ptt.load_scene(CORNELL)
    scene = dataclasses.replace(scene, resolution=(16, 12), trace_depth=3)
    seen = []
    accum = ptt.render(scene, 5, chunk=2, device="cpu",
                       callback=lambda done, acc, counts: seen.append(done))
    assert seen == [2, 4, 5]
    # samples are keyed by iteration: chunks (1,2) (3,4) (5) summed in
    # the same order give the same bits
    want = torch.zeros_like(accum)
    for it0, n in ((1, 2), (3, 2), (5, 1)):
        want += ptt.pathtrace_batch(scene, it0, n, device="cpu")[0]
    assert torch.equal(accum, want)


def test_image_io_matches_reference(tmp_path):
    rs = np.random.default_rng(3)
    accum = rs.uniform(0, 3, (6 * 5, 3)).astype(np.float32)
    img = image_io.to_display(accum, 6, 5, 2)
    ref_img = ref_io.to_display(accum, 6, 5, 2)
    np.testing.assert_array_equal(img, ref_img)
    np.testing.assert_array_equal(image_io.to_uint8(img),
                                  ref_io.to_uint8(ref_img))
    image_io.save_hdr(str(tmp_path / "a.hdr"), img)
    ref_io.save_hdr(str(tmp_path / "b.hdr"), ref_img)
    assert (tmp_path / "a.hdr").read_bytes() == \
        (tmp_path / "b.hdr").read_bytes()
    assert image_io.render_filename("c", "t", 4) == \
        ref_io.render_filename("c", "t", 4)


def test_port_imports_no_jax():
    # a subprocess: this test process imported jax through conftest
    code = (
        "import pkgutil, sys, pathtrace_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    __import__(m.name)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'jaxlib', 'pathtrace_tpu'))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)
