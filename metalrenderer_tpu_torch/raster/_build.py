"""Build ``csrc/*.cu`` with nvcc at first use and load it with ctypes.

The shared library has a plain C interface (no PyTorch headers), so a build
takes seconds. It goes to ``metalrenderer_tpu_torch/_build/<key>/``, keyed
by a hash of the sources and the flags, so an edited source is rebuilt and
an unchanged one is reused. Nothing is built when the package is imported.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
LIB_NAME = "libmr_kernels.so"
# sm_90a: Hopper with its architecture-specific features. -fmad=false: the
# kernels' rounding must match their plain twins (no FMA contraction).
# -Xptxas=-v: registers, spills and shared memory per kernel, kept in the
# build log next to the library.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")


def nvcc_path() -> str:
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from source at first use")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16] / LIB_NAME


def build() -> Path:
    """Compile the sources unless the keyed library exists; returns its path."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    sources = [str(s) for s in sorted(CSRC_DIR.glob("*.cu"))]
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        tmp_out = Path(tmp) / LIB_NAME
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp_out), *sources]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        (out.parent / "build.log").write_text(
            " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp_out, out)
    return out


@functools.cache
def load_library() -> ctypes.CDLL:
    return ctypes.CDLL(str(build()))
