"""The output bits of K1's builds without textures, to compare two
versions of the port on one card.

    python3 tests/torch_digest.py [ROOT]

For cornell.txt (the build without features, mask 0) and cornell_mesh.txt
(the mesh build, mask 512), each at 96x80, depth 8, 3 samples from
iteration 1, it prints the sha256 of the float32 radiance that
``trace_k1`` returns, first 16 hex digits.  These are the jobs of the
digests that ``test_torch_cuda.py`` pins.  ROOT is the root of a checkout
whose ``pathtrace_tpu_torch`` and ``scenes/`` are used (default: this
one).  Needs a CUDA GPU.  Imports no JAX.
"""

import dataclasses
import hashlib
import os
import sys

JOBS = (("cornell", 0), ("cornell_mesh", 512))  # scene file, feature mask
RES, DEPTH, SPP = (96, 80), 8, 3


def digest(rad):
    """sha256 of a float32 tensor's bytes, first 16 hex digits."""
    return hashlib.sha256(rad.cpu().numpy().tobytes()).hexdigest()[:16]


def main(argv):
    root = os.path.abspath(argv[0] if argv else os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("torch_digest: needs a CUDA GPU", file=sys.stderr)
        return 2
    import pathtrace_tpu_torch as ptt
    from pathtrace_tpu_torch.ops.cuda import megakernel as K

    for name, mask in JOBS:
        scene = ptt.load_scene(os.path.join(root, "scenes", f"{name}.txt"))
        scene = dataclasses.replace(scene, resolution=RES, trace_depth=DEPTH)
        K.LAUNCHES.clear()
        rad, _ = K.trace_k1(**K.prepare(scene, "cuda"), it0=1, n_spp=SPP)
        torch.cuda.synchronize()
        if dict(K.LAUNCHES) != {mask: 1}:
            raise RuntimeError(f"{name}: launches {dict(K.LAUNCHES)}, want "
                               f"one of mask {mask}")
        print(f"digest {name} {RES[0]}x{RES[1]} d{DEPTH} {SPP}spp mask "
              f"{mask} ({K.__file__}): {digest(rad)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
