"""Build and load the CUDA kernels of the port.

Each source in ``critic2_tpu_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface (no PyTorch
headers, so a build takes seconds), at first use, into
``critic2_tpu_torch/_build/``. The library name carries a hash of the
sources and flags, so an edited source is rebuilt. All missing libraries
are compiled in parallel, one nvcc process per source. A failed build
raises; nothing falls back to the plain PyTorch versions.

Run ``python -m critic2_tpu_torch.ops._ext`` on a machine with nvcc to
build every kernel and print the compiler's register report.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

# kernel library -> its source (headers in csrc/ are hashed into every one)
SOURCES = {"yt_pass": "yt_pass.cu", "yt_gs_pass": "yt_gs_pass.cu"}
NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler",
              "-fPIC"]

_libs: dict = {}
build_log: dict = {}        # library -> nvcc output of this process's build


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "of critic2_tpu_torch are built from source")
    return path


def _lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fn in sorted(os.listdir(CSRC)):
        if fn == SOURCES[name] or fn.endswith(".cuh"):
            with open(os.path.join(CSRC, fn), "rb") as fh:
                h.update(fn.encode() + fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def build(names=None) -> dict:
    """Compile every listed kernel library that is not built yet, all at
    once; returns {name: path}. Raises RuntimeError with nvcc's output when
    a build fails."""
    names = list(SOURCES) if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    procs = {}
    for n in names:
        if os.path.exists(paths[n]):
            continue
        tmp = f"{paths[n]}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, SOURCES[n])]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        build_log[n] = out
        if proc.returncode != 0:
            failed.append(f"--- {n} (nvcc exit {proc.returncode})\n{out}")
        else:
            os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(build([name])[name])
        _libs[name] = lib
    return lib


if __name__ == "__main__":
    for n, p in build().items():
        print(n, p)
        print(build_log.get(n, "(already built)"))
