"""K9, the BVH traversal probe, in the plain PyTorch version against the
reference's ``tools/probe_trav.py`` run in interpret mode on the CPU: the
same (final cursor, steps, leaves, tsum) on the bigmesh tables, the
port's own (loader, ``pack_mesh``).  The CUDA kernel against the plain
version: ``tests/test_torch_cuda.py``."""

import os
import re
import subprocess
import sys

import numpy as np
import torch

import pathtrace_tpu_torch as ptt
from pathtrace_tpu_torch.ops.cuda import megakernel as K
from pathtrace_tpu_torch.ops.cuda import probe as P

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bigmesh_tables():
    scene = ptt.load_scene(os.path.join(REPO, "scenes",
                                        "cornell_bigmesh.txt"))
    tri, nodes, meta = K.pack_mesh(scene, "cpu")
    return nodes, tri, meta[0]


def test_probe_plain_matches_reference_script():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    out = subprocess.run([sys.executable, "tools/probe_trav.py", "cpu"],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300, check=True).stdout
    m = re.search(r"final n (-?\d+) steps (-?\d+) leaves (-?\d+) "
                  r"tsum (-?\d+)", out)
    assert m, out
    want = tuple(int(x) for x in m.groups())
    assert P.probe_plain(*_bigmesh_tables()) == want


def test_probe_k9_on_cpu_is_the_plain_version():
    args = _bigmesh_tables()
    before = P.LAUNCHES.copy()
    got = P.probe_k9(*args, rows=2, lanes=40, max_steps=300)
    assert got == P.probe_plain(*args, rows=2, lanes=40, max_steps=300)
    assert got[1] <= 300 and P.LAUNCHES == before


def test_bundle_rays_round_as_the_reference():
    # the reference's bundle arithmetic, in numpy float32
    row, lane = (a.astype(np.float32) for a in
                 np.meshgrid(np.arange(32), np.arange(128), indexing="ij"))
    f = np.float32
    d = np.stack([np.ones_like(row), row * f(0.001), lane * f(0.0005)])
    n2 = np.sqrt((d * d).sum(0, dtype=np.float32))
    with np.errstate(divide="ignore"):  # a zero direction: inf, as IEEE
        ird = f(1.0) / (d / n2)
    o, got_ird = P.bundle_rays(32, 128, device="cpu")
    np.testing.assert_array_equal(o[0].numpy(),
                                  (f(-3.0) + row * f(0.01)).reshape(-1))
    np.testing.assert_array_equal(o[1].numpy(),
                                  (lane * f(0.005) - f(0.3)).reshape(-1))
    for k in range(3):
        np.testing.assert_array_equal(got_ird[k].numpy(),
                                      ird[k].reshape(-1))
    assert torch.isinf(got_ird[2][0])  # lane 0: a zero z direction


MESH_SCENES = ("cornell_mesh", "cornell_bigmesh", "cornell_bumpmesh",
               "cornell_bigmesh_tex", "cornell_hugemesh")


def test_every_skip_link_moves_forward(tmp_path):
    # K9's streamed walk loads both of the next step's nodes, n + 1 and
    # skip(n), once node n is read: it rests on the cursor only moving
    # forward, n < skip(n) <= n_nodes, on every pack_mesh BVH the repo
    # ships (the hugemesh's OBJ made by tools/gen_mesh.py 7); a leaf's
    # skip is n + 1, and an internal node's subtree is n + 1 .. skip - 1
    subprocess.run([sys.executable, os.path.join(REPO, "tools", "gen_mesh.py"),
                    "7", str(tmp_path / "gen_icosphere7.obj")], check=True,
                   stdout=subprocess.DEVNULL, timeout=120)
    for name in MESH_SCENES:
        with open(os.path.join(REPO, "scenes", f"{name}.txt")) as f:
            text = f.read()
        base = tmp_path if name == "cornell_hugemesh" else os.path.join(
            REPO, "scenes")
        scene = ptt.parse_scene(text, base_dir=str(base))
        _, nodes, meta = K.pack_mesh(scene, "cpu")
        assert meta, name
        for _, node_off, n_nodes, _, _ in meta:
            table = nodes[node_off:node_off + n_nodes].numpy()
            n = np.arange(n_nodes)
            skip = table[:, 6].astype(np.int64)
            leaf = table[:, 8] > 0
            assert np.all(n < skip) and np.all(skip <= n_nodes), name
            assert np.all(skip[leaf] == n[leaf] + 1), name
            assert skip[0] == n_nodes, name  # the root's subtree is all
