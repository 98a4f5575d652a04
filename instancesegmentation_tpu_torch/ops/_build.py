"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each source in ``csrc/`` compiles on first use into a shared library with a
plain C interface under ``build/kernels/`` at the repository root, named by
a hash of the source and the flags, so a changed source builds afresh and
an unchanged one is reused.  Every missing library is built by its own
``nvcc`` process, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("fused_chain.cu", "nms.cu", "roi_align.cu", "matching.cu", "warp_2level.cu",
           "int8_conv.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
NVCC_TIMEOUT_S = 600

#: nvcc's output (ptxas register and shared-memory report) per source built
#: in this process
build_log: dict[str, str] = {}
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def target(source: str) -> Path:
    """Path of the shared library built from ``csrc/<source>``."""
    digest = hashlib.sha256(
        (CSRC / source).read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{Path(source).stem}_{digest}.so"


def build_all() -> None:
    """Build every source whose library is missing, one nvcc per source,
    all started together; raises with nvcc's output on a failure."""
    missing = [s for s in SOURCES if not target(s).exists()]
    if not missing:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src in missing:
        so = target(src)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs.append((src, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for src, so, tmp, proc in procs:
        try:
            out, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
            errors.append(f"nvcc timed out on {src}")
            continue
        build_log[src] = out
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {src}:\n{out}")
            continue
        os.replace(tmp, so)  # atomic: a concurrent build sees all or nothing
    if errors:
        raise RuntimeError("\n".join(errors))


def library(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built on first use."""
    if source not in _libs:
        build_all()
        _libs[source] = ctypes.CDLL(str(target(source)))
    return _libs[source]
