"""Build and load the port's CUDA kernel library.

The CUDA sources in ``csrc/`` (one per kernel, plus shared headers) are
compiled by ``nvcc`` for ``sm_90a`` at first use, each source by its own
``nvcc`` process in parallel, and linked into one shared library with a
plain C interface under ``build/repro_torch_kernels/`` at the repository
root.  The library's name carries a hash of the sources and flags, so an
edited source is rebuilt.  It is loaded with ``ctypes``; each kernel
module declares the argument types of its own entry points
(:func:`function`).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("fa_fwd.cu", "fa_bwd_dq.cu", "fa_bwd_dkv.cu", "ssd_fwd.cu",
           "ssd_bwd.cu")
HEADERS = ("fa_common.cuh", "fa_mma.cuh", "ssd_common.cuh")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")


@dataclass(frozen=True)
class BuildInfo:
    path: Path
    seconds: float        # wall time of this build; 0.0 when it was cached
    ptxas: dict           # source -> nvcc/ptxas output (-Xptxas -v)
    cached: bool


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((home and os.path.join(home, "bin", "nvcc")),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in HEADERS + SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> BuildInfo:
    """Compile the kernel library (each source in its own ``nvcc``, all at
    once), or find it already built from the same sources."""
    lib = BUILD_DIR / f"librepro_torch_kernels_{_digest()}.so"
    if lib.exists():
        return BuildInfo(lib, 0.0, {}, cached=True)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, Path(s).stem + ".o") for s in SOURCES]
        procs = []
        try:
            for src, obj in zip(SOURCES, objs):
                procs.append(subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c",
                     str(CSRC / src), "-o", obj],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True))
            logs = {src: p.communicate()[0] for src, p in zip(SOURCES, procs)}
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for src, p in zip(SOURCES, procs):
            if p.returncode:
                raise RuntimeError(f"nvcc failed on {src}:\n{logs[src]}")
        tmp_lib = os.path.join(tmp, lib.name)
        link = subprocess.run([nvcc, "-shared", "-o", tmp_lib, *objs],
                              capture_output=True, text=True)
        if link.returncode:
            raise RuntimeError(f"linking {lib.name} failed:\n{link.stdout}"
                               f"{link.stderr}")
        os.replace(tmp_lib, lib)
    return BuildInfo(lib, time.perf_counter() - t0, logs, cached=False)


@functools.cache
def _library() -> ctypes.CDLL:
    return ctypes.CDLL(str(build().path))


def function(name: str, argtypes: list):
    """The library's entry point ``name`` (built at first use), returning
    the launch's CUDA error code as an int."""
    fn = getattr(_library(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn
