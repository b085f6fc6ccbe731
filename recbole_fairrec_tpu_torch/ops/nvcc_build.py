"""The port's CUDA sources (``csrc/*.cu``, each with a plain C interface)
built with ``nvcc`` for ``sm_90a`` into shared libraries under ``_build/``,
once per content hash, for ctypes to load."""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")


def _nvcc(stem):
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(f"nvcc not found: the {stem} kernel cannot be built")


def build_library(source, stem, verbose=False):
    """Compile ``source`` into ``_build/<stem>-<hash>.so`` unless that exists,
    and return its path; ``verbose`` prints what ``-Xptxas -v`` reports
    (registers, shared memory, spills of each kernel)."""
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    so_path = os.path.join(BUILD_DIR, f"{stem}-{digest}.so")
    if os.path.exists(so_path):
        return so_path
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [
        _nvcc(stem), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", source, "-o", tmp,
    ]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
        if verbose:
            print(proc.stderr.strip())
        os.replace(tmp, so_path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return so_path
