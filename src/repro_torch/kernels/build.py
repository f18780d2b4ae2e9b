"""Build the port's CUDA kernels and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface (pointers and the stream as
``void*``, sizes as integers, a ``cudaError_t`` returned as ``int``) and is
compiled on its own by ``nvcc`` for ``sm_90a`` into
``build/repro_torch/<name>-<hash>.so`` at the repository root.  The hash
covers the source, the shared headers and the flags, so an edited kernel is
rebuilt and an unchanged one is reused.  Nothing is compiled at import
time: the first launch of a kernel (or an explicit ``build()``) does it.

Only the sources in this directory are compiled — no prebuilt kernel
package is needed, so a fresh checkout on a machine with the CUDA toolkit
builds everything itself.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("rmsnorm", "flash_attention", "flash_attention_bwd", "ssd_scan",
           "ssd_scan_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        from torch.utils.cpp_extension import CUDA_HOME
        if CUDA_HOME is not None:
            cand = os.path.join(CUDA_HOME, "bin", "nvcc")
            path = cand if os.path.exists(cand) else None
    if path is None:
        raise RuntimeError("nvcc not found (neither on PATH nor under "
                           "CUDA_HOME); the CUDA toolkit is needed to build "
                           "the port's kernels")
    return path


def lib_path(name: str) -> pathlib.Path:
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def nvcc_command(src: pathlib.Path, out: pathlib.Path) -> list:
    """The compiler command that builds one source into a shared library
    (the shared headers found in ``CSRC``)."""
    return [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(out), str(src)]


def open_library(path: pathlib.Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def build(names=SOURCES) -> dict:
    """Compile every library in ``names`` that is not built yet: one
    ``nvcc`` per source, all started together, each waited for.  Returns
    ``{"seconds": wall time, "ptxas": {name: register/smem report}}``;
    raises with the compiler's output if any build fails."""
    t0 = time.perf_counter()
    todo = [n for n in names if not lib_path(n).exists()]
    report: dict[str, str] = {}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = []
        for n in todo:
            out = lib_path(n)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = nvcc_command(CSRC / f"{n}.cu", tmp)
            procs.append((n, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        failed = []
        for n, out, tmp, p in procs:          # wait for every child first
            stdout, stderr = p.communicate()
            if p.returncode != 0:
                failed.append(f"--- nvcc {n}.cu (exit {p.returncode}) ---\n"
                              f"{stdout}{stderr}")
                continue
            os.replace(tmp, out)              # atomic: readers never see half
            report[n] = stderr
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {"seconds": time.perf_counter() - t0, "ptxas": report}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build((name,))
            lib = open_library(lib_path(name))
            _loaded[name] = lib
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero ``cudaError_t``."""
    if code != 0:
        msg = lib.repro_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
