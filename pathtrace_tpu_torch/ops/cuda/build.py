"""Builds the CUDA kernels with ``nvcc`` and loads them through ctypes.

The sources under ``pathtrace_tpu_torch/csrc`` have a plain C interface
and include no PyTorch header, so one ``nvcc`` call builds each shared
library in seconds.  The megakernel is built once per feature set (a
``-DPT_FEATURES=<mask>`` define), as Mosaic compiles the reference's once
per ``_scene_features``; each of these libraries also holds the span
kernel K5 of the same feature set.  The material-gradient kernel K7 and
the reverse sweep K8 are the same source built with ``-DPT_GRAD=1`` and
``-DPT_VJP=1``, libraries of their own (without K1 and K5), so that the
forward builds do not change.  The scan K6 and the traversal probe K9
are libraries of their own.  The build runs at first use, into
``pathtrace_tpu_torch/build/`` (not committed), under a name keyed by
the hash of the sources, flags and defines, so an edited source is never
served from a stale library.  A failed build raises with nvcc's output.
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


def _library_path(name, defines):
    digest = hashlib.sha256(" ".join(NVCC_FLAGS + defines).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        digest.update(f.name.encode())
        digest.update(f.read_bytes())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build_many(jobs, logs=None):
    """Compile each (name, sources, defines) job into a shared library
    unless a build of the same sources, flags and defines exists, all
    ``nvcc`` processes running at once; return the libraries' paths.
    ``sources`` are file names in ``csrc``; ``defines`` are nvcc flags
    such as ``-DPT_FEATURES=3``.  A dict ``logs`` gets (seconds, nvcc
    output) of each build this call ran, by library name."""
    paths, running = [], []
    for name, sources, defines in jobs:
        out = _library_path(name, tuple(defines))
        paths.append(out)
        if out.exists() or any(r[1] == out for r in running):
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build to a private name, then rename: concurrent builds never
        # load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, *defines, "-I", str(CSRC), "-o",
               tmp, *(str(CSRC / s) for s in sources)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((name, out, tmp, cmd, proc, time.perf_counter()))
    failed = []
    for name, out, tmp, cmd, proc, t0 in running:
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            if os.path.exists(tmp):  # nvcc may have removed it
                os.unlink(tmp)
            failed.append(f"nvcc failed building {name} (exit "
                          f"{proc.returncode}):\n{' '.join(cmd)}\n{log}")
            continue
        os.replace(tmp, out)
        if logs is not None:
            logs[name] = (seconds, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def build(name, sources, defines=()):
    """:func:`build_many` of one job."""
    return build_many([(name, sources, defines)])[0]


def _k1_job(mask):
    return f"k1_m{mask}", ["megakernel.cu"], (f"-DPT_FEATURES={mask}",)


def _k7_job(mask):
    return (f"k7_m{mask}", ["megakernel.cu"],
            (f"-DPT_FEATURES={mask}", "-DPT_GRAD=1"))


def _k8_job(mask):
    return (f"k8_m{mask}", ["megakernel.cu"],
            (f"-DPT_FEATURES={mask}", "-DPT_VJP=1"))


K6_JOB = ("k6_scan", ["scan.cu"], ())
K9_JOB = ("k9_probe", ["probe_trav.cu"], ())


def build_kernels(masks, k7_masks=(), k8_masks=(), logs=None):
    """Build the K1 (and K5) libraries of these feature masks, the K7
    and K8 libraries of ``k7_masks`` and ``k8_masks``, the K6 scan's and
    the K9 probe's at once, nvcc in parallel, so that later
    :func:`load_k1`, :func:`load_k7`, :func:`load_k8`, :func:`load_k6`
    and :func:`load_k9` calls find them built; ``logs`` as
    :func:`build_many`'s."""
    build_many([_k1_job(m) for m in sorted(set(masks))]
               + [_k7_job(m) for m in sorted(set(k7_masks))]
               + [_k8_job(m) for m in sorted(set(k8_masks))]
               + [K6_JOB, K9_JOB], logs)


def _load_grad(key, job, mask, entry, argtypes):
    """A K7 or K8 library: ``entry``, and the rounding and the size of
    its exact gradient table, bound."""
    if key not in _LIBS:
        lib = ctypes.CDLL(str(build(*job)))
        p, i = ctypes.c_void_p, ctypes.c_int
        getattr(lib, entry).argtypes = argtypes
        getattr(lib, entry).restype = i
        lib.pt_fx_round.argtypes = [p, i, p, p]
        lib.pt_fx_round.restype = i
        lib.pt_fx_words.argtypes = [i]
        lib.pt_fx_words.restype = i
        lib.pt_k1_features.argtypes = []
        lib.pt_k1_features.restype = i
        lib.pt_cuda_error_string.argtypes = [i]
        lib.pt_cuda_error_string.restype = ctypes.c_char_p
        if lib.pt_k1_features() != mask:
            raise RuntimeError(f"{job[0]} library built for mask "
                               f"{lib.pt_k1_features()}, wanted {mask}")
        _LIBS[key] = lib
    return _LIBS[key]


def load_k7(mask=0):
    """The K7 library (``csrc/megakernel.cu`` with ``-DPT_GRAD=1``) of
    K1 feature mask ``mask``, built at first use."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    return _load_grad(("k7", mask), _k7_job(mask), mask, "pt_k7_grads", [
        p, p, p, p, p,           # cam, mats, gmat, types, lights
        p, p, p, p, p,           # tri, nodes, meta, texels, charts
        i, i, i, ll,             # n_geoms, n_lights, n_meta, n_texels
        i, i, i,                 # width, height, depth
        ctypes.c_uint, i, i,     # it0, n_spp, flush_paths
        p, p, i,                 # mtab, mat_of, n_mats
        p, p, p, p, p,           # ct, rad, counts, gradient table, stream
    ])


def load_k8(mask=0):
    """The K8 library (``csrc/megakernel.cu`` with ``-DPT_VJP=1``) of
    feature mask ``mask`` (0, NEE's, the mesh bit's or both), built at
    first use."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib = _load_grad(("k8", mask), _k8_job(mask), mask, "pt_k8_vjp", [
        p, p, p, p, p,           # cam, mats, gmat, types, lights
        p, p, p,                 # tri, nodes, meta
        i, i, i,                 # n_geoms, n_lights, n_meta
        i, i, i,                 # width, height, depth
        ctypes.c_uint, i,        # it0, n_spp
        ll, ll, i, i,            # px0, n_px, s0, s1
        p, p, p, p, p,           # ct, rad, tape, n_live, carried sums
        p, p, p,                 # gradient table, lane counters, stream
    ])
    for fn in (lib.pt_k8_record_bytes, lib.pt_k8_carry_bytes):
        fn.argtypes, fn.restype = [], i
    return lib


def load_k1(mask=0):
    """The K1 library (``csrc/megakernel.cu``, with K5) compiled for the
    feature mask ``mask`` (``megakernel.feature_mask``), built at first
    use."""
    if mask not in _LIBS:
        lib = ctypes.CDLL(str(build(*_k1_job(mask))))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.pt_k1_trace.argtypes = [
            p, p, p, p, p,                         # cam, mats, gmat, types, lights
            p, p, p,                               # tri, nodes, meta
            p, p,                                  # texels, charts
            i, i, i,                               # n_geoms, n_lights, n_meta
            ctypes.c_longlong,                     # n_texels
            i, i, i,                               # width, height, depth
            ctypes.c_uint, i,                      # it0, n_spp
            ctypes.c_longlong, ctypes.c_longlong,  # pix0, n_local
            p, p, p, i, p,                         # rad, counts, events, per_sample, stream
        ]
        lib.pt_k1_trace.restype = i
        lib.pt_k5_span.argtypes = [
            p, p, p, p, p,                         # cam, mats, gmat, types, lights
            p, p, p,                               # tri, nodes, meta
            p, p,                                  # texels, charts
            i, i, i,                               # n_geoms, n_lights, n_meta
            ctypes.c_longlong,                     # n_texels
            i, i,                                  # width, height
            p, i, i, ctypes.c_longlong,            # state, n_keys, pix_key, n_rays
            p, p, ctypes.c_longlong, p,            # tbl, n_live, n_tiles, live_out
            i, i, i, ctypes.c_uint,                # d0, d1, depth, it
            p, p,                                  # counts, stream
        ]
        lib.pt_k5_span.restype = i
        lib.pt_k5_state_keys.argtypes = []
        lib.pt_k5_state_keys.restype = i
        lib.pt_k1_features.argtypes = []
        lib.pt_k1_features.restype = i
        lib.pt_cuda_error_string.argtypes = [i]
        lib.pt_cuda_error_string.restype = ctypes.c_char_p
        if lib.pt_k1_features() != mask:
            raise RuntimeError(
                f"K1 library built for mask {lib.pt_k1_features()}, "
                f"wanted {mask}")
        _LIBS[mask] = lib
    return _LIBS[mask]


def load_k6():
    """The K6 scan library (``csrc/scan.cu``), built at first use."""
    if "k6" not in _LIBS:
        lib = ctypes.CDLL(str(build(*K6_JOB)))
        p, ll = ctypes.c_void_p, ctypes.c_longlong
        lib.pt_k6_scan.argtypes = [p, p, p, ll, ll, p]
        lib.pt_k6_scan.restype = ctypes.c_int
        lib.pt_k6_tile.argtypes = []
        lib.pt_k6_tile.restype = ll
        lib.pt_k6_max_tag.argtypes = []
        lib.pt_k6_max_tag.restype = ll
        lib.pt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.pt_cuda_error_string.restype = ctypes.c_char_p
        _LIBS["k6"] = lib
    return _LIBS["k6"]


def load_k9():
    """The K9 traversal-probe library (``csrc/probe_trav.cu``), built at
    first use."""
    if "k9" not in _LIBS:
        lib = ctypes.CDLL(str(build(*K9_JOB)))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.pt_k9_probe.argtypes = [p, p, i, i, i, i, p, p, p]
        lib.pt_k9_probe.restype = i
        lib.pt_cuda_error_string.argtypes = [i]
        lib.pt_cuda_error_string.restype = ctypes.c_char_p
        _LIBS["k9"] = lib
    return _LIBS["k9"]
