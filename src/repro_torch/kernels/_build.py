"""Build and load the hand-written Hopper kernels.

Each kernel source (``<kernel>/csrc/<kernel>.cu``) compiles on first use
into its own shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -I kernels/csrc -o build/repro_torch_kernels/...

and is loaded with ``ctypes``.  The library name carries a hash of the
sources and flags, so an edited source rebuilds and a stale library is
never loaded.  ``build_all`` starts one ``nvcc`` per source at once and
waits for all of them.  Nothing here runs at import time: the CPU tests
import every module of the package on a machine with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG.parents[2] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-I", str(_PKG / "csrc")]

# kernel name -> source, relative to the kernels package
SOURCES = {
    "flash_attention": "flash_attention/csrc/flash_attention.cu",
    "flash_attention_bwd": "flash_attention/csrc/flash_attention_bwd.cu",
    "decode_attention": "decode_attention/csrc/decode_attention.cu",
    "paged_attention": "paged_attention/csrc/paged_attention.cu",
    "paged_partial": "paged_attention/csrc/paged_partial.cu",
    "verify_attention": "verify_attention/csrc/verify_attention.cu",
    "ssm_scan": "ssm_scan/csrc/ssm_scan.cu",
    "ssm_scan_bwd": "ssm_scan/csrc/ssm_scan_bwd.cu",
    "mlstm_chunk": "mlstm_chunk/csrc/mlstm_chunk.cu",
    "mlstm_chunk_bwd": "mlstm_chunk/csrc/mlstm_chunk_bwd.cu",
    "gmm": "gmm/csrc/gmm.cu",
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are compiled on "
                       "first use and need the CUDA toolkit")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((_PKG / SOURCES[name]).read_bytes())
    for hdr in sorted((_PKG / "csrc").glob("*.cuh")):
        h.update(hdr.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start ``nvcc`` for one kernel unless its library is built; ->
    (Popen, temporary output) or None."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_PKG / SOURCES[name])]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), tmp


def _finish(name: str, job) -> None:
    if job is None:
        return
    proc, tmp = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, _lib_path(name))      # atomic: never a half library


def build_all() -> None:
    """Compile every kernel library that is missing, all in parallel."""
    with _lock:
        jobs = {n: _start(n) for n in SOURCES if n not in _libs}
        for n, job in jobs.items():
            _finish(n, job)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = ctypes.CDLL(str(_lib_path(name)))
            _libs[name] = lib
        return lib
