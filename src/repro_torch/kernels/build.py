"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
into ``_build/<name>-<hash>.so`` (the hash covers the source, the shared
``csrc/*.cuh`` headers and the flags, so a stale library is never
loaded).  Nothing here runs at
import: the first wrapper call on a CUDA tensor builds what it needs,
and :func:`build` builds every source at once, one nvcc process each,
all started together.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_build"
SOURCES = ("householder_gemm", "ether_merge", "reflect_gemm_dx",
           "reflect_gemm_dw", "etherplus_gemm", "etherplus_merge",
           "etherplus_reflect_bwd", "delora_gemm", "hyperadapt_gemm",
           "method_merge", "householder_gemm_batched",
           "etherplus_reflect_batched", "delora_gemm_batched",
           "hyperadapt_gemm_batched", "merge_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
# name -> {"seconds": wall time of its nvcc, "ptxas": its -Xptxas -v lines}
BUILD_LOG: dict[str, dict] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH); the CUDA "
                           "kernels build only where the CUDA toolkit is")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{tag}.so"


def build(names=SOURCES) -> dict[str, dict]:
    """Compile every named source whose library is missing, all nvcc
    processes at once; returns BUILD_LOG.  Raises KernelBuildError with
    nvcc's output when a source does not compile."""
    todo = [n for n in names if not _lib_path(n).exists()]
    if todo:
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in todo:
            tmp = _lib_path(name).with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True), tmp, time.perf_counter())
        failed = []
        for name, (proc, tmp, t0) in procs.items():
            out, _ = proc.communicate()
            BUILD_LOG[name] = {
                "seconds": time.perf_counter() - t0,
                "ptxas": [ln for ln in out.splitlines() if "ptxas" in ln]}
            if proc.returncode:
                failed.append(f"--- {name}.cu (nvcc exit {proc.returncode})"
                              f"\n{out}")
            else:
                os.replace(tmp, _lib_path(name))
        if failed:
            raise KernelBuildError("\n".join(failed))
    return BUILD_LOG


@functools.cache
def function(name: str, symbol: str, argtypes: tuple):
    """The C function ``symbol`` of ``csrc/<name>.cu``, built on first use,
    with its argtypes set and an int return (a cudaError_t)."""
    lib = _LIBS.get(name)
    if lib is None:
        build((name,))
        lib = _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn
