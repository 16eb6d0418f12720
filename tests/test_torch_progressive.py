"""The progressive render of the port's CLI: checkpoints and resume
(``utils/checkpoint.py``), previews, the interactive camera, and the tools
beside them (``tools/watch.py``, ``utils/profiling.py``,
``scene/parser.derived_fov``), on the CPU (the plain versions).

Resume at iteration k is bit-identical to a render that never stopped on
K1's plain version, on the split engine (``--split-depth``), on the sorted
engine and on the wavefront with ``--compaction sort``: the chunk
boundaries are the same and the accumulation is added in the same order.
"""

import dataclasses
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch
from PIL import Image

import pathtrace_tpu as pt
from pathtrace_tpu.scene.parser import derived_fov as ref_derived_fov
from pathtrace_tpu.tools import watch as ref_watch
from pathtrace_tpu.utils import checkpoint as ref_ckpt
from pathtrace_tpu.utils import profiling as ref_profiling
import pathtrace_tpu_torch as ptt
from pathtrace_tpu_torch import cli
from pathtrace_tpu_torch.io import image_io
from pathtrace_tpu_torch.ops.cuda import megakernel as K
from pathtrace_tpu_torch.render import interact
from pathtrace_tpu_torch.scene import derived_fov
from pathtrace_tpu_torch.tools import watch
from pathtrace_tpu_torch.utils import checkpoint as ckpt
from pathtrace_tpu_torch.utils import profiling

from torch_scenes import REPO

CORNELL = os.path.join(REPO, "scenes", "cornell.txt")
RES, DEPTH = (12, 10), 3
ENGINES = {"k1": [], "split": ["--split-depth", "2"],
           "sorted": ["--engine", "sorted"],
           "xla-sort": ["--engine", "xla", "--compaction", "sort"],
           "planes": ["--engine", "planes"]}


def scene_at(path=CORNELL):
    return dataclasses.replace(ptt.load_scene(path), resolution=RES,
                               trace_depth=DEPTH)


def run_cli(monkeypatch, tmp_path, args, on_preview=None):
    """``cli.main`` on cornell at RES, DEPTH, 2 samples a chunk, on the CPU,
    the temporary directory ``tmp_path``: (the accumulations it displayed,
    each image's samples and path; the previews written).
    ``on_preview(done)`` runs as each preview is written."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    shown, previews = [], []
    to_display, save_png = image_io.to_display, image_io.save_png

    def spy_display(accum, w, h, samples):
        shown.append((np.array(accum), samples))
        return to_display(accum, w, h, samples)

    def spy_png(path, img):
        save_png(path, img)
        if path.endswith(".preview.png"):
            previews.append(path)
            if on_preview is not None:
                on_preview(len(previews))

    monkeypatch.setattr(image_io, "to_display", spy_display)
    monkeypatch.setattr(image_io, "save_png", spy_png)
    assert cli.main([CORNELL, "--device", "cpu", "--res", *map(str, RES),
                     "--depth", str(DEPTH), "--chunk", "2",
                     "--out", str(tmp_path / "out.png"), *args]) == 0
    monkeypatch.undo()
    return shown, previews


@pytest.mark.parametrize("engine", ["k1", "split", "sorted", "xla-sort"])
def test_resume_is_bit_identical(monkeypatch, tmp_path, engine):
    flags = ENGINES[engine]
    whole, _ = run_cli(monkeypatch, tmp_path, ["--spp", "6", *flags])
    ck = str(tmp_path / "r.ckpt")
    part, _ = run_cli(monkeypatch, tmp_path, ["--spp", "4", "--checkpoint",
                                              ck, *flags])
    acc, it = ckpt.load(ck, scene_at())
    assert it == 4
    np.testing.assert_array_equal(acc, part[-1][0])
    resumed, _ = run_cli(monkeypatch, tmp_path, ["--spp", "6", "--checkpoint",
                                                 ck, "--resume", *flags])
    assert resumed[-1][1] == whole[-1][1] == 6
    np.testing.assert_array_equal(resumed[-1][0], whole[-1][0])
    assert ckpt.load(ck, scene_at())[1] == 6


def test_checkpoint_every_k_iterations(monkeypatch, tmp_path):
    saved = []
    save = ckpt.save
    monkeypatch.setattr(ckpt, "save", lambda path, accum, it, scene: (
        saved.append(it), save(path, accum, it, scene)))
    run_cli(monkeypatch, tmp_path, ["--spp", "7", "--checkpoint",
                                    str(tmp_path / "e.ckpt"),
                                    "--checkpoint-every", "4"])
    # after the chunk that ends at 4 (done % 4 < its 2 samples; not at 7,
    # 7 % 4 = 3 is not below 1), then the final one
    assert saved == [4, 7]


def test_resume_refuses_another_scene(monkeypatch, tmp_path):
    ck = str(tmp_path / "s.ckpt")
    run_cli(monkeypatch, tmp_path, ["--spp", "2", "--checkpoint", ck])
    with pytest.raises(ValueError, match="different scene"):
        cli.main([CORNELL, "--device", "cpu", "--res", "8", "8", "--spp",
                  "4", "--checkpoint", ck, "--resume",
                  "--out", str(tmp_path / "x.png")])
    with pytest.raises(ValueError, match="different scene"):
        ckpt.load(ck, dataclasses.replace(scene_at(), trace_depth=DEPTH + 1))


def test_checkpoint_file_is_the_references_format(tmp_path):
    scene = scene_at()
    accum = torch.rand((scene.pixel_count, 3))
    path = str(tmp_path / "f.ckpt")
    ckpt.save(path, accum, 5, scene)
    assert sorted(os.listdir(tmp_path)) == ["f.ckpt"]  # no .tmp left
    with np.load(path) as z:
        assert sorted(z.files) == ["accum", "fingerprint", "iteration"]
        assert z["accum"].dtype == np.float32 and int(z["iteration"]) == 5
    ref_path = str(tmp_path / "ref.ckpt")
    js = dataclasses.replace(pt.load_scene(CORNELL), resolution=RES,
                             trace_depth=DEPTH)
    ref_ckpt.save(ref_path, accum.numpy(), 5, js)
    with np.load(ref_path) as a, np.load(path) as b:
        assert a.files == b.files
        np.testing.assert_array_equal(a["accum"], b["accum"])
    got, it = ckpt.load(path, scene)
    assert it == 5 and np.array_equal(got, accum.numpy())


def test_fingerprint_reads_tensors_as_their_arrays():
    scene = scene_at()
    as_tensors = dataclasses.replace(scene, materials=dataclasses.replace(
        scene.materials, color=torch.as_tensor(scene.materials.color)))
    assert ckpt.scene_fingerprint(as_tensors) == ckpt.scene_fingerprint(scene)
    moved = dataclasses.replace(scene, camera=interact.apply_camera_motion(
        scene.camera, *interact.KEY_MOTION["w"]))
    assert ckpt.scene_fingerprint(moved) != ckpt.scene_fingerprint(scene)
    assert len(ckpt.scene_fingerprint(scene)) == 16


@pytest.mark.parametrize("engine", ["k1", "xla-sort"])
def test_preview_every_k_iterations(monkeypatch, tmp_path, engine):
    shown, previews = run_cli(monkeypatch, tmp_path,
                              ["--spp", "6", "--preview-every", "4",
                               *ENGINES[engine]])
    want = str(tmp_path / "cornell.preview.png")
    assert cli.preview_path("cornell") == os.path.join(
        tempfile.gettempdir(), "cornell.preview.png")
    assert previews == [want]  # after the chunk that ends at 4
    assert [s for _, s in shown] == [4, 6]
    img = np.asarray(Image.open(want))
    assert img.shape == (RES[1], RES[0], 3)
    np.testing.assert_array_equal(
        img, image_io.to_uint8(image_io.to_display(shown[0][0], *RES, 4)))


def k1_chunks(scene, n, chunk=2):
    """The CLI's accumulation of ``n`` samples of ``scene`` on K1's plain
    version, ``chunk`` samples a call, added in the CLI's order."""
    job = K.prepare(scene, "cpu")
    acc = torch.zeros((scene.pixel_count, 3))
    for it0 in range(1, n + 1, chunk):
        acc += K.trace_k1(job, it0, min(chunk, n + 1 - it0))[0]
    return acc.numpy()


@pytest.mark.parametrize("key", ["left", "w"])
def test_interactive_camera_key_restarts(monkeypatch, tmp_path, key):
    ctrl = str(tmp_path / "cam.ctrl")
    interact.send_key(ctrl, "up")  # stale: written before the render

    def press(n):
        if n == 1:
            interact.send_key(ctrl, key)

    shown, previews = run_cli(
        monkeypatch, tmp_path, ["--spp", "6", "--preview-every", "2",
                                "--interactive", ctrl], on_preview=press)
    # previews at 2, then the restart: 2, 4, 6
    assert len(previews) == 4
    scene = scene_at()
    moved = dataclasses.replace(scene, camera=interact.apply_camera_motion(
        scene.camera, *interact.KEY_MOTION[key]))
    accum, samples = shown[-1]
    assert samples == 6
    np.testing.assert_array_equal(accum, k1_chunks(moved, 6))
    assert not np.array_equal(accum, k1_chunks(scene, 6))


def test_interactive_space_saves_and_q_quits(monkeypatch, tmp_path, capsys):
    ctrl = str(tmp_path / "cam.ctrl")

    def press(n):
        interact.send_key(ctrl, "space" if n == 1 else "q")

    shown, previews = run_cli(
        monkeypatch, tmp_path, ["--spp", "10", "--preview-every", "2",
                                "--interactive", ctrl], on_preview=press)
    # space after the chunk ending at 2 saves that image; q after 4 stops
    assert len(previews) == 2
    assert [s for _, s in shown] == [2, 2, 4, 4]
    np.testing.assert_array_equal(shown[-1][0], k1_chunks(scene_at(), 4))
    assert capsys.readouterr().out.count("saved") == 2


def test_cli_stats_lines_parse(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "pathtrace_tpu_torch.cli", CORNELL,
         "--device", "cpu", "--res", "8", "8", "--depth", "3", "--spp", "5",
         "--chunk", "2", "--stats", "--out", str(tmp_path / "s.png")],
        cwd=REPO, capture_output=True, text=True, timeout=120, check=True,
        env=dict(os.environ, TMPDIR=str(tmp_path))).stdout
    stats = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    assert [s["iter"] for s in stats] == [2, 4, 5]
    for s, n in zip(stats, (2, 2, 1)):
        assert set(s) == {"iter", "ms_per_iter", "mrays_per_s",
                          "live_per_bounce"}
        assert s["ms_per_iter"] > 0 and s["mrays_per_s"] >= 0
        assert len(s["live_per_bounce"]) == 3
        assert s["live_per_bounce"][0] == 64 * n  # every camera ray
    assert (tmp_path / "s.png").exists()


def test_render_ansi_equals_the_references():
    img = np.random.default_rng(0).integers(0, 256, (9, 14, 3),
                                            dtype=np.uint8)
    for cols, rows in ((14, 5), (7, 3), (40, 40)):
        assert watch.render_ansi(img, cols, rows) == \
            ref_watch.render_ansi(img, cols, rows)
    out = watch.render_ansi(img, 14, 5)
    lines = out.split("\n")
    assert len(lines) == 4 and all(ln.endswith("\x1b[0m") for ln in lines)
    assert lines[0].count("▀") == 14
    r, g, b = img[0, 0]
    assert lines[0].startswith(f"\x1b[38;2;{r};{g};{b}m")


def test_watch_reads_keys_and_draws_the_preview(tmp_path, capsys):
    rd, wr = os.pipe()
    try:
        os.write(wr, b"\x1b[Aw \x1bq")
        assert watch._drain_keys(rd) == ["up", "w", "space", "esc", "q"]
        os.close(wr)
        wr = None
        assert watch._drain_keys(rd) == ["q"]  # end of input
    finally:
        os.close(rd)
        if wr is not None:
            os.close(wr)
    png = str(tmp_path / "p.png")
    image_io.save_png(png, np.full((4, 6, 3), 0.5, np.float32))
    assert watch.main([png, "--once"]) == 0
    assert "[6x4," in capsys.readouterr().out
    assert watch.main([str(tmp_path / "none.png"), "--once"]) == 1


def test_derived_fov_equals_the_references(cornell_scene):
    for res in ((800, 800), (640, 480), (1920, 1080)):
        got = derived_fov(dataclasses.replace(ptt.load_scene(CORNELL),
                                              resolution=res))
        assert got == ref_derived_fov(dataclasses.replace(
            cornell_scene, resolution=res))


def test_profiling_helpers(tmp_path):
    counts = np.array([[64, 40, 20], [64, 38, 21]])
    assert profiling.bounce_stats(torch.as_tensor(counts)) == \
        ref_profiling.bounce_stats(counts)
    sec, out = profiling.time_fn(lambda: torch.ones(4) * 2, iters=3)
    assert sec > 0 and torch.equal(out, torch.full((4,), 2.0))
    with profiling.trace(str(tmp_path), device="cpu") as prof:
        (torch.ones(64) * 3).sum()
    assert os.path.exists(tmp_path / "trace.json")
    assert profiling.device_busy(prof) == (0.0, 0.0)  # no card here
