"""Build ``csrc/*.cu`` with nvcc at first use and load it with ctypes.

The shared library has a plain C interface (no PyTorch headers), so a build
takes seconds: one nvcc per source, all started together, then one link.
It goes to ``metalrenderer_tpu_torch/_build/<key>/``, keyed by a hash of
the sources and the flags, so an edited source is rebuilt and an unchanged
one is reused. Nothing is built when the package is imported.
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
              "-fmad=false", "-Xptxas=-v", "-Xcompiler", "-fPIC")


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
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        sources = sorted(CSRC_DIR.glob("*.cu"))
        objs = [str(Path(tmp) / (s.stem + ".o")) for s in sources]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", o, str(s)]
                for o, s in zip(objs, sources)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        results = [(c, p.communicate()[0], p.returncode)
                   for c, p in zip(cmds, procs)]
        tmp_out = Path(tmp) / LIB_NAME
        link = [nvcc, "-shared", "-o", str(tmp_out), *objs]
        if all(rc == 0 for _, _, rc in results):
            proc = subprocess.run(link, capture_output=True, text=True)
            results.append((link, proc.stdout + proc.stderr, proc.returncode))
        log = "".join(" ".join(c) + "\n" + text for c, text, _ in results)
        (out.parent / "build.log").write_text(log)
        failed = [(c, rc) for c, _, rc in results if rc != 0]
        if failed:
            raise RuntimeError(f"nvcc failed with code {failed[0][1]} "
                               f"({' '.join(failed[0][0])}):\n{log}")
        os.replace(tmp_out, out)
    return out


@functools.cache
def load_library() -> ctypes.CDLL:
    return ctypes.CDLL(str(build()))


# --- helpers shared by the kernel wrappers ----------------------------------

def ptr(t):
    """A tensor's device pointer for ctypes (NULL for None)."""
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def stream(device):
    """PyTorch's current CUDA stream on ``device``, for a launch."""
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check(name, t, dtype, device, shape=None):
    """Raise unless ``t`` is a contiguous ``dtype`` tensor on ``device``
    (of ``shape``, if given): what the kernels take."""
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous {dtype} tensor on "
                         f"{device}, got {t.dtype} on {t.device}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: need shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")


def raise_on(err, name):
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        import torch
        raise RuntimeError(f"{name}: CUDA error {err} "
                           f"({torch.cuda.get_device_name()})")
