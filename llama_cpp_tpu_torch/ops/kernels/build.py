"""Build and load the hand-written CUDA kernels.

Each source in the package's csrc/ is compiled by nvcc into a shared library
with a plain C interface and loaded with ctypes (no PyTorch headers, so a
build takes seconds). Builds go to build/kernels/ at the checkout root,
named by a hash of the source and the shared headers (csrc/*.cuh), and start
at first use; the sources are
compiled in parallel, one nvcc process each.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("qmm.cu", "qmm_expert.cu", "flash_attn_paged.cu", "flash_attn.cu", "qmm_bench.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOGS: dict[str, str] = {}  # source -> nvcc/ptxas output of this process's build


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine "
                       "with the CUDA toolkit")


def _target(src: str) -> Path:
    h = hashlib.sha256((CSRC / src).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"{Path(src).stem}-{digest}.so"


def build_all() -> dict[str, Path]:
    """Compile every source that has no current build, all in parallel.
    Raises RuntimeError with the compiler output when one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {src: _target(src) for src in SOURCES}
    procs = {}
    for src, out in targets.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True), tmp, out)
    failed = []
    for src, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOGS[src] = log
        if proc.returncode != 0:
            failed.append(f"{src} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return targets


def library(src: str) -> ctypes.CDLL:
    """The loaded shared library built from csrc/<src>."""
    lib = _LIBS.get(src)
    if lib is None:
        lib = ctypes.CDLL(str(build_all()[src]))
        _LIBS[src] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaGetLastError() returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
