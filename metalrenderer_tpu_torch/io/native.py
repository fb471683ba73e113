"""ctypes bindings for the repository's native OBJ parser.

The port's own copy of ``metalrenderer_tpu.io.native`` (that package
imports JAX). ``native/objparser.cpp`` parses 100k-triangle assets many
times faster than the Python loader (``io/obj.py``). It is built with g++
at first use into the gitignored ``metalrenderer_tpu_torch/_build/``,
keyed by a hash of the source, so a library is only ever loaded if it was
built from the source on disk. Without a toolchain ``native_available()``
is False, ``build_error()`` says why, and the loader takes Python.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import subprocess

import numpy as np

PKG_DIR = pathlib.Path(__file__).resolve().parents[1]
SOURCE = PKG_DIR.parent / "native" / "objparser.cpp"
BUILD_DIR = PKG_DIR / "_build"


def library_path() -> pathlib.Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"objparser-{digest}" / "libobjparser.so"


@functools.cache
def _load():
    """(the loaded library, None) or (None, why it could not be built)."""
    try:
        lib_path = library_path()
        if not lib_path.exists():
            lib_path.parent.mkdir(parents=True, exist_ok=True)
            # A temp file per process, then an atomic rename: concurrent
            # builds never interleave their writes in one file.
            tmp = lib_path.with_suffix(f".so.tmp{os.getpid()}")
            subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", str(tmp),
                            str(SOURCE)], check=True, capture_output=True)
            tmp.replace(lib_path)
        lib = ctypes.CDLL(str(lib_path))
    except (OSError, subprocess.CalledProcessError) as e:
        detail = getattr(e, "stderr", b"") or b""
        return None, f"{e} {detail.decode(errors='replace')}".strip()
    lib.obj_parse.restype = ctypes.c_void_p
    lib.obj_parse.argtypes = [ctypes.c_char_p]
    lib.obj_counts.restype = ctypes.c_long
    lib.obj_counts.argtypes = [ctypes.c_void_p]
    lib.obj_fill.restype = None
    lib.obj_fill.argtypes = [ctypes.c_void_p] + \
        [np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")] * 3
    lib.obj_free.restype = None
    lib.obj_free.argtypes = [ctypes.c_void_p]
    return lib, None


def native_available() -> bool:
    return _load()[0] is not None


def build_error():
    """Why the native parser could not be built or loaded (None if it was)."""
    return _load()[1]


def parse_obj_native(path):
    """OBJ -> (pos f32[N,3], uv f32[N,2], nrm f32[N,3]) numpy arrays via
    C++, or None without the native library."""
    lib = _load()[0]
    if lib is None:
        return None
    handle = lib.obj_parse(str(path).encode())
    if not handle:
        raise FileNotFoundError(path)
    try:
        n = lib.obj_counts(handle)
        pos = np.empty((n, 3), np.float32)
        uv = np.empty((n, 2), np.float32)
        nrm = np.empty((n, 3), np.float32)
        if n:
            lib.obj_fill(handle, pos, uv, nrm)
        return pos, uv, nrm
    finally:
        lib.obj_free(handle)
