"""The port's main path as a whole: CLI -> K1 (plain version on the CPU)
-> accumulation -> PNG, against the reference's Pallas path in interpret
mode.  Bounds as in ``tests/test_torch_megakernel.py`` (tie flips)."""

import dataclasses
import os
import subprocess
import sys
import tempfile
import time

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
from pathtrace_tpu_torch.ops.cuda import megakernel as K
from pathtrace_tpu_torch.render import integrator as I
from pathtrace_tpu_torch.utils import checkpoint as ckpt

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


def _shard_cli(tmp_path, flags, world=1):
    """``cli.main`` with ``--shard`` in a subprocess (no process group is
    made in this one): a world of one, or of ``world`` gloo ranks under
    ``torch.distributed.run``; (the accumulation of its checkpoint, the
    PNG, its standard output)."""
    ck, out = tmp_path / "shard.ckpt", tmp_path / "shard.png"
    launch = ([] if world == 1 else [
        "-m", "torch.distributed.run", "--standalone",
        f"--nproc_per_node={world}"])
    proc = subprocess.run(
        [sys.executable, *launch, "-m", "pathtrace_tpu_torch.cli", CORNELL,
         "--shard", "--device", "cpu", "--res", "20", "18", "--depth", "5",
         "--spp", "4", "--chunk", "2", "--out", str(out), "--checkpoint",
         str(ck), *flags], cwd=REPO, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, PYTHONPATH=REPO,
                              TMPDIR=str(tmp_path)))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    accum = np.load(ck)["accum"]
    return accum, np.asarray(Image.open(out)), proc.stdout


@pytest.mark.parametrize("flags,unsharded", [
    ([], []), (["--nee"], ["--nee"]),
    (["--engine", "planes"], ["--engine", "planes"]),
    (["--engine", "xla", "--compaction", "sort"],
     ["--engine", "xla", "--compaction", "sort"]),
    # the reference's --shard renders --engine sorted on the wavefront
    (["--engine", "sorted"], ["--engine", "xla"])],
    ids=["k1", "k1-nee", "planes", "xla-sort", "sorted"])
def test_cli_shard_renders_the_unsharded_image(monkeypatch, tmp_path, flags,
                                               unsharded):
    accum, png, out = _shard_cli(tmp_path, flags)
    assert "--shard: a world of 1 process(es), backend gloo" in out
    ck = tmp_path / "plain.ckpt"
    want = _cli_accum(monkeypatch, tmp_path, [*unsharded, "--spp", "4",
                                              "--checkpoint", str(ck)])
    np.testing.assert_array_equal(accum, np.load(ck)["accum"])
    np.testing.assert_array_equal(accum, want[0])
    np.testing.assert_array_equal(png, want[1])


@pytest.mark.parametrize("engine", [[], ["--engine", "xla"]],
                         ids=["k1", "xla"])
@pytest.mark.parametrize("flag", [
    "checkpoint", "checkpoint-every", "resume", "preview-every",
    "interactive"])
def test_cli_progressive_flags_work(monkeypatch, tmp_path, capsys, engine,
                                    flag):
    # the flags of ROADMAP Queue 1 item 5, each on K1 and the wavefront:
    # the same image as without them, and each its file
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    ck, ctl = str(tmp_path / "x.ckpt"), str(tmp_path / "ctl")
    args = {"checkpoint": ["--checkpoint", ck],
            "checkpoint-every": ["--checkpoint", ck, "--checkpoint-every",
                                 "2"],
            "resume": ["--checkpoint", ck, "--resume"],
            "preview-every": ["--preview-every", "2"],
            "interactive": ["--interactive", ctl]}[flag]
    if flag == "resume":  # a checkpoint at 2 samples to resume from
        _cli_accum(monkeypatch, tmp_path, engine + args[:2] + ["--spp", "2"])
        monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    got = _cli_accum(monkeypatch, tmp_path, engine + args)
    out = capsys.readouterr().out
    want = _cli_accum(monkeypatch, tmp_path, engine)
    np.testing.assert_array_equal(got[0], want[0])
    if flag.startswith("checkpoint") or flag == "resume":
        assert ckpt.load(ck, dataclasses.replace(
            ptt.load_scene(CORNELL), resolution=(20, 18),
            trace_depth=5))[1] == 3
    assert ("resumed at iteration 2" in out) == (flag == "resume")
    if flag == "preview-every":
        assert (tmp_path / "cornell.preview.png").exists()


@pytest.mark.parametrize("flags,nee,compaction", [
    ([], False, "mask"), (["--compaction", "sort"], False, "sort"),
    (["--compaction", "sort", "--nee"], True, "sort"),
    (["--nee"], True, "mask")], ids=["mask", "sort", "sort-nee", "mask-nee"])
def test_cli_engine_xla_renders_the_wavefront(monkeypatch, tmp_path, capsys,
                                              flags, nee, compaction):
    # --engine xla is the wavefront (render.integrator.pathtrace_batch),
    # chunk by chunk; --compaction sort densifies there, with no warning
    got = _cli_accum(monkeypatch, tmp_path, ["--engine", "xla", *flags])
    assert "WARNING" not in capsys.readouterr().out
    scene = dataclasses.replace(ptt.load_scene(CORNELL), resolution=(20, 18),
                                trace_depth=5)
    want = sum(I.pathtrace_batch(scene, it0, n, compaction, nee=nee,
                                 device="cpu")[0]
               for it0, n in ((1, 2), (3, 1)))
    np.testing.assert_array_equal(got[0], want.numpy())


@pytest.mark.parametrize("flags", [[], ["--nee"]], ids=["bsdf", "nee"])
def test_cli_engine_planes_renders_the_plain_trace(monkeypatch, tmp_path,
                                                   flags):
    # --engine planes is the megakernel's plain version on the device
    got = _cli_accum(monkeypatch, tmp_path, ["--engine", "planes", *flags])
    scene = dataclasses.replace(ptt.load_scene(CORNELL), resolution=(20, 18),
                                trace_depth=5)
    job = K.prepare(scene, "cpu", nee=bool(flags))
    want = sum(K.trace_plain(**job, it0=it0, n_spp=n)[0]
               for it0, n in ((1, 2), (3, 1)))
    np.testing.assert_array_equal(got[0], want.numpy())


@pytest.mark.parametrize("engine", ["pallas", "xla"])
def test_cli_shard_on_two_ranks_rank_0_alone_writes(monkeypatch, tmp_path,
                                                    engine):
    # two gloo ranks under torch.distributed.run: each chunk's samples
    # split between them, the image the unsharded one; one line of each
    # kind printed and one preview written, by rank 0
    accum, png, out = _shard_cli(tmp_path, ["--engine", engine,
                                            "--preview-every", "2"], world=2)
    assert "a world of 2 process(es), backend gloo" in out
    assert out.count(" saved ") == 1 and out.count("iter 2/4") == 1
    assert (tmp_path / "cornell.preview.png").exists()
    want = _cli_accum(monkeypatch, tmp_path, ["--engine", engine, "--spp",
                                              "4"])
    np.testing.assert_allclose(accum, want[0], rtol=1e-6, atol=0)


def test_cli_shard_resumes_on_two_ranks(monkeypatch, tmp_path):
    # a checkpoint at 2 samples resumed to 4 by two ranks: the image of an
    # unsharded render that never stopped; rank 0 alone says so
    _shard_cli(tmp_path, ["--spp", "2"], world=2)
    accum, _, out = _shard_cli(tmp_path, ["--resume"], world=2)
    assert out.count("resumed at iteration 2") == 1
    want = _cli_accum(monkeypatch, tmp_path, ["--spp", "4"])
    np.testing.assert_allclose(accum, want[0], rtol=1e-6, atol=0)


def test_cli_shard_interactive_quit_reaches_every_rank(tmp_path):
    # rank 0 polls the control file and sends its events to rank 1: a q
    # written once the first preview exists stops both ranks (rank 1 would
    # otherwise wait in its next all_reduce), and the image is saved
    from pathtrace_tpu_torch.render.interact import send_key

    ctl, log = tmp_path / "ctl", tmp_path / "log"
    ctl.write_text("")
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node=2", "-m", "pathtrace_tpu_torch.cli", CORNELL,
             "--shard", "--device", "cpu", "--res", "8", "8", "--depth", "2",
             "--spp", "1000000", "--chunk", "2", "--preview-every", "2",
             "--interactive", str(ctl), "--out", str(tmp_path / "q.png")],
            cwd=REPO, stdout=f, stderr=subprocess.STDOUT,
            env=dict(os.environ, PYTHONPATH=REPO, TMPDIR=str(tmp_path)))
    try:
        preview = tmp_path / "cornell.preview.png"
        deadline = time.time() + 120
        while (not preview.exists() and proc.poll() is None
               and time.time() < deadline):
            time.sleep(0.05)
        send_key(str(ctl), "q")
        assert proc.wait(timeout=120) == 0, log.read_text()
    finally:
        proc.kill()
    out = log.read_text()
    assert (tmp_path / "q.png").exists() and " saved " in out
    assert "/1000000 " in out and "iter 1000000/1000000" not in out


@pytest.mark.parametrize("engine", [[], ["--engine", "sorted"],
                                    ["--engine", "planes"]])
def test_cli_compaction_sort_masks_with_a_warning(monkeypatch, tmp_path,
                                                  capsys, engine):
    # as the reference's tiled engines: a warning naming the engine that
    # densifies, then the image of --compaction mask
    got = _cli_accum(monkeypatch, tmp_path, ["--compaction", "sort", *engine])
    out = capsys.readouterr().out
    assert "WARNING: --compaction sort" in out and "--engine xla" in out
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
    return seen[-1], np.asarray(Image.open(out))


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
