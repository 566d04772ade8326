"""ctypes bindings of the port's native host library (``aosx_native.cpp``,
a copy of ``aosx/native/aosx_native.cpp``).

The library is built by g++ into ``aosx_torch/_build/`` at first use (or by
``python -m aosx_torch.native.build``), named by a hash of its source and
flags, never at import. ``available()`` is False only where no g++ is
found; a build that fails raises."""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

import numpy as np

SRC = pathlib.Path(__file__).resolve().parent / "aosx_native.cpp"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[1] / "_build"
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")


def library_path() -> pathlib.Path:
    key = hashlib.sha256(SRC.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libaosx_native-{key}.so"


def build() -> pathlib.Path:
    """Compile the library unless it is already built; returns its path."""
    so = library_path()
    if so.exists():
        return so
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native host library cannot be built")
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    r = subprocess.run([gxx, *FLAGS, str(SRC), "-o", str(tmp)], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"g++ failed for {SRC.name}:\n{r.stdout}\n{r.stderr}")
    os.replace(tmp, so)
    return so


@functools.lru_cache(maxsize=None)
def _lib():
    lib = ctypes.CDLL(str(build()))
    lib.aosx_load_pcd_xyz.restype = ctypes.c_long
    lib.aosx_load_pcd_xyz.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                                      ctypes.c_long]
    lib.aosx_thin.restype = ctypes.c_int
    lib.aosx_thin.argtypes = [ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
                              ctypes.c_int]
    lib.aosx_label.restype = ctypes.c_int
    lib.aosx_label.argtypes = [ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
                               ctypes.c_int, ctypes.c_int]
    return lib


def available() -> bool:
    """Whether the library is built or can be: a g++ is on PATH."""
    return library_path().exists() or shutil.which("g++") is not None


def load_pcd_xyz(path: str, max_points: int = 1 << 22) -> np.ndarray:
    """[N, 3] f32 xyz of a binary PCD v0.7 file."""
    out = np.empty((max_points, 3), np.float32)
    n = _lib().aosx_load_pcd_xyz(str(path).encode(),
                                 out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), max_points)
    if n < 0:
        raise IOError(f"native PCD load failed: {path}")
    load_pcd_xyz.calls += 1
    return out[:n].copy()


load_pcd_xyz.calls = 0


def thin(binary: np.ndarray, max_iters: int = 10000) -> np.ndarray:
    """Zhang-Suen to the fixpoint, bit-identical to the JAX package's oracle."""
    img = np.ascontiguousarray(binary.astype(np.uint8))
    h, w = img.shape
    _lib().aosx_thin(img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w, max_iters)
    return img


def label(mask: np.ndarray):
    """8-connected components in raster discovery order. Returns (labels, n)."""
    m = np.ascontiguousarray(mask.astype(np.uint8))
    h, w = m.shape
    out = np.empty((h, w), np.int32)
    n = _lib().aosx_label(m.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                          out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), h, w)
    return out, n
