"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

Each source is compiled by ``nvcc`` for ``sm_90a`` into an object file, all
sources at once in parallel, and the objects are linked into one shared
library with a plain C interface, loaded with :mod:`ctypes`. The library is
cached under ``_build/`` (listed in ``.gitignore``) by a hash of the sources
and flags, so a changed source rebuilds and an unchanged one loads. Every
file is written to a temporary path and renamed into place, so a concurrent
process never loads a half-written library.

Nothing here runs at import: :func:`library` builds on its first call, which
comes from a kernel wrapper handed a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_DIR, "csrc")
BUILD_DIR = os.path.join(_DIR, "_build")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v")
BUILD_TIMEOUT_S = 600

_lock = threading.Lock()
_lib = None
# What the last build did: seconds, whether the cache was hit, ptxas report.
build_info: dict = {}


def sources() -> list[str]:
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels of fps_tpu_torch are built from source at first use")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _run(procs: list[tuple[str, subprocess.Popen]]) -> str:
    """Wait for every started nvcc; raise with its output if one failed."""
    log = []
    failed = []
    for name, p in procs:
        try:
            out, _ = p.communicate(timeout=BUILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            failed.append(name)
        log.append(f"== {name}\n{out}")
        if p.returncode != 0:
            failed.append(name)
    text = "\n".join(log)
    if failed:
        raise RuntimeError(f"nvcc failed for {sorted(set(failed))}:\n{text}")
    return text


def build() -> str:
    """Compile the sources into ``_build/libfps_kernels-<hash>.so`` unless a
    library of the same hash is there; return its path."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(BUILD_DIR, f"libfps_kernels-{_digest()}.so")
    if os.path.exists(lib_path):
        build_info.update(cached=True, seconds=0.0, path=lib_path)
        return lib_path
    nvcc = _nvcc()
    t0 = time.perf_counter()
    tag = f"{os.getpid()}.tmp"
    objs = []
    procs = []
    for src in sources():
        if not src.endswith(".cu"):
            continue
        obj = os.path.join(BUILD_DIR,
                           os.path.basename(src)[:-3] + f".{tag}.o")
        objs.append(obj)
        procs.append((os.path.basename(src), subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    tmp = f"{lib_path}.{tag}"
    try:
        log = _run(procs)
        link = subprocess.Popen(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log += "\n" + _run([("link", link)])
        os.replace(tmp, lib_path)
    finally:
        for path in objs + [tmp]:
            if os.path.exists(path):
                os.remove(path)
    build_info.update(cached=False, seconds=time.perf_counter() - t0,
                      path=lib_path, log=log)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on the first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
            lib.fps_gather_rows_f32.argtypes = [vp, vp, vp, ll, ll, ci, vp]
            lib.fps_gather_rows_f32.restype = ci
            lib.fps_radix_sort_i32.argtypes = [vp, ll, ll, vp, ll, vp]
            lib.fps_radix_sort_i32.restype = ci
            lib.fps_scatter_add_f32.argtypes = [vp, vp, vp, ll, ll, ci, vp, ll,
                                                vp, ll, vp]
            lib.fps_scatter_add_f32.restype = ci
            lib.fps_gather_rows_dim1_f32.argtypes = [vp, vp, vp, ll, ll, vp]
            lib.fps_gather_rows_dim1_f32.restype = ci
            lib.fps_scatter_add_dim1_f32.argtypes = [vp, vp, vp, ll, ll, ll,
                                                     ci, ci, ci, ci, ci, ci,
                                                     vp, ll, vp]
            lib.fps_scatter_add_dim1_f32.restype = ci
            lib.fps_dim1_bucket_f32.argtypes = [vp, vp, ll, ll, ci, ci, ci, vp,
                                                ll, vp]
            lib.fps_dim1_bucket_f32.restype = ci
            lib.fps_dim1_clusters_resident.argtypes = [ci, ci]
            lib.fps_dim1_clusters_resident.restype = ci
            lib.fps_scatter_add_packed_f32.argtypes = [vp, vp, vp, ll, ll, ci,
                                                       ll, ci, ll, ci, vp, ll,
                                                       vp]
            lib.fps_scatter_add_packed_f32.restype = ci
            lib.fps_packed_clusters_resident.argtypes = [ci, ci, ci]
            lib.fps_packed_clusters_resident.restype = ci
            _lib = lib
        return _lib
