"""Builds the CUDA kernels with ``nvcc`` and loads them through ctypes.

The sources under ``pathtrace_tpu_torch/csrc`` have a plain C interface
and include no PyTorch header, so one ``nvcc`` call builds each shared
library in seconds.  The build runs at first use, into
``pathtrace_tpu_torch/build/`` (not committed), under a name keyed by the
hash of the sources and flags, so an edited source is never served from
a stale library.  A failed build raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"

# Parity first: IEEE division and square root, no flush to zero, and no
# multiply-add contraction, so the kernel rounds as its plain version
# does.  Never --use_fast_math: the slab test relies on IEEE inf and NaN.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-prec-div=true", "-prec-sqrt=true", "-ftz=false",
    "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC",
)

_LIBS = {}
# (seconds, nvcc output) of each build this process ran, by library name
BUILD_INFO = {}


def nvcc_path():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (not on PATH, nor under $CUDA_HOME/bin): the "
            "CUDA kernels are built with the CUDA toolkit")
    return path


def build(name, sources):
    """Compile ``sources`` (file names in ``csrc``) into a shared library
    unless a build of the same sources and flags exists; return its
    path."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        digest.update(f.name.encode())
        digest.update(f.read_bytes())
    out = BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build to a private name, then rename: concurrent builds never
    # load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp,
           *(str(CSRC / s) for s in sources)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed building {name} (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    BUILD_INFO[name] = (seconds, proc.stdout + proc.stderr)
    return out


def load_k1():
    """The K1 library (``csrc/megakernel.cu``), built at first use."""
    if "k1" not in _LIBS:
        lib = ctypes.CDLL(str(build("k1", ["megakernel.cu"])))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.pt_k1_trace.argtypes = [
            p, p, p, p,                            # cam, mats, gmat, types
            i, i, i, i,                            # n_geoms, width, height, depth
            ctypes.c_uint, i,                      # it0, n_spp
            ctypes.c_longlong, ctypes.c_longlong,  # pix0, n_local
            p, p, p,                               # rad, counts, stream
        ]
        lib.pt_k1_trace.restype = i
        lib.pt_cuda_error_string.argtypes = [i]
        lib.pt_cuda_error_string.restype = ctypes.c_char_p
        _LIBS["k1"] = lib
    return _LIBS["k1"]
