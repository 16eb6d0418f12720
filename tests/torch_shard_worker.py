"""One rank of ``tests/test_torch_shard.py``'s gloo group on the CPU.

    python tests/torch_shard_worker.py RANK WORLD STORE OUT [TARGET]

Joins the group through the file store STORE, runs every case of
``torch_shard_cases`` (the grad step "grad" against the target image in
the .npy file TARGET, zeros without it), the mesh of rank 0 alone
(``make_mesh(1)``) and a broadcast, and saves the results to the .npz
file OUT.  Imports no JAX.
"""

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from pathtrace_tpu_torch.parallel import shard  # noqa: E402
from pathtrace_tpu_torch.render import diff as D  # noqa: E402

import torch_shard_cases as C  # noqa: E402


def main(rank, world, store, out, target=None):
    shard.initialize_distributed(
        "cpu", store=dist.FileStore(store, world), rank=rank,
        world_size=world)
    mesh = shard.make_mesh(device="cpu")
    assert (mesh.rank, mesh.size, mesh.device) == (rank, world,
                                                   torch.device("cpu"))
    scenes = {name: C.scene(name) for name in C.SCENES}
    res = {}
    for key, (fn, sc, n, kw, _, _) in C.CASES.items():
        rad, counts = getattr(shard, fn)(scenes[sc], 1, n, mesh, **kw)
        res[f"{key}.rad"], res[f"{key}.counts"] = rad.numpy(), counts.numpy()
    for key, (fn, sc, n, kw) in C.GRADS.items():
        p = scenes[sc].pixel_count
        t = (np.load(target) if key == "grad" and target else
             np.zeros((p, 3), np.float32))
        loss, grads = getattr(shard, fn)(scenes[sc], t, 1, n, mesh, **kw)
        res[f"{key}.loss"] = loss.numpy()
        res[f"{key}.tri_verts_none"] = np.bool_(grads["tri_verts"] is None)
        for name, g in D.named_leaves(grads):
            res[f"{key}.g.{name}"] = g.numpy()
    sub = shard.make_mesh(1, device="cpu")
    res["sub.none"] = np.bool_(sub is None)
    if sub is not None:
        rad, counts = shard.render_sample_sharded_pallas(scenes["cornell"], 1,
                                                         2, sub)
        res["sub.rad"], res["sub.counts"] = rad.numpy(), counts.numpy()
    res["broadcast"] = np.asarray(shard.broadcast(
        [rank + 7, "seven"] if rank == 0 else None, mesh)[0])
    np.savez(out, **res)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
         *sys.argv[5:])
