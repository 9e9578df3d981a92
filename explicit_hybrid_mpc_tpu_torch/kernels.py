"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source is compiled by ``nvcc`` into its own shared library with a
plain C interface and loaded with ctypes -- no PyTorch headers, so a
build takes seconds, not minutes.  Libraries land in ``build/kernels/``
at the repository root (listed in .gitignore), named by the source's
content hash, so an edited source is rebuilt and an unchanged one is
reused.  Nothing here runs at import time: importing the package on a
machine without ``nvcc`` or a GPU never touches the compiler.

    python -m explicit_hybrid_mpc_tpu_torch.kernels   # build all, print
                                                      # ptxas resource use
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
import time

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "build", "kernels")

#: Kernel name -> source file under csrc/.
SOURCES = {"ipm_leg": "ipm_leg.cu", "locate": "locate.cu"}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

class KernelError(Exception):
    """A hand-written kernel failed to build or to launch.

    Deliberately not a RuntimeError: the frontier's device-failure
    recovery catches RuntimeError/OSError and re-solves on the CPU, and
    a kernel that cannot run must stop the caller instead."""


_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: Kernel name -> ptxas resource report of the build that produced it
#: (empty when the library was already on disk).
ptxas_report: dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise KernelError("nvcc not found: the CUDA kernels are built on "
                          "a machine with the CUDA toolkit")
    return path


def _lib_path(name: str) -> str:
    with open(os.path.join(CSRC, SOURCES[name]), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def build(names=None) -> dict[str, float]:
    """Compile every named kernel whose library is missing, one ``nvcc``
    per source, all started together.  Returns seconds per built
    kernel; raises KernelError with the compiler output on failure."""
    names = list(SOURCES if names is None else names)
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _lib_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), tmp, out)
    took = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        ptxas_report[name] = log
        if proc.returncode != 0:
            failed.append(f"{SOURCES[name]}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise KernelError("nvcc failed for " + "\n".join(failed))
    return took


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel `name`, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            try:
                lib = ctypes.CDLL(_lib_path(name))
            except OSError as e:
                raise KernelError(f"cannot load the {name} kernel: {e}") \
                    from e
            _libs[name] = lib
        return lib


if __name__ == "__main__":
    for k, v in build().items():
        print(f"{k}: built in {v:.1f} s")
        print(ptxas_report.get(k, ""))
    sys.exit(0)
