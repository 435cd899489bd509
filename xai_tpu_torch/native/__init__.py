"""ctypes bridge to the port's native host helpers.

``superpixels.cpp`` is the port's own copy of xai_tpu's host segmenters,
byte for byte.  g++ compiles it at first use into ``native/build/``
(git-ignored), under a name that hashes the source and the flags, the way
``kernels/_build.py`` builds the CUDA sources.  There is no fallback: if
the library cannot be built, the call raises.  Bound: ``felzenszwalb``
(XRAI's and MAC's segmenter), ``slic`` (MDA's) and ``project_curve``
(MDA's and the metrics' curve projection); LIME's quickshift runs on the
card instead (``kernels/quickshift.py``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
SOURCE = HERE / "superpixels.cpp"
BUILD_DIR = HERE / "build"
# the flags of xai_tpu/native/Makefile
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
             "-fopenmp-simd", "-shared")

_lib = None
_lock = threading.Lock()


def lib_path() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes()
                          + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libxai_native-{digest[:12]}.so"


def _build(final: Path) -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) to build "
                           "xai_tpu_torch/native/superpixels.cpp")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = final.with_name(f"{final.stem}.{os.getpid()}.tmp.so")
    try:
        r = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"g++ failed on native/superpixels.cpp:\n"
                               f"{r.stdout}{r.stderr}")
        # rename into place: a concurrent process never loads half a file
        os.replace(tmp, final)
    finally:
        if tmp.exists():
            tmp.unlink()


def load() -> ctypes.CDLL:
    """The native library, built on first use and kept."""
    global _lib
    with _lock:
        if _lib is None:
            path = lib_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            # the argtypes of xai_tpu/native/__init__.py
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C")
            f64p = np.ctypeslib.ndpointer(np.float64, flags="C")
            lib.felzenszwalb.argtypes = [
                f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_float, ctypes.c_float, ctypes.c_int, i32p]
            lib.felzenszwalb.restype = ctypes.c_int
            lib.slic.argtypes = [f32p, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_float, ctypes.c_int,
                                 i32p]
            lib.slic.restype = ctypes.c_int
            lib.project_curve.argtypes = [f64p, ctypes.c_int, ctypes.c_int,
                                          ctypes.c_int, f64p]
            lib.project_curve.restype = None
            _lib = lib
        return _lib


def felzenszwalb(image: np.ndarray, scale: float, sigma: float = 0.8,
                 min_size: int = 20) -> np.ndarray:
    """XRAI's segmenter (XRAIBuilder.py:200-259): ``[H, W]`` or
    ``[H, W, C]`` float image -> ``[H, W]`` int32 labels."""
    img = np.ascontiguousarray(image, dtype=np.float32)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    labels = np.empty((h, w), np.int32)
    load().felzenszwalb(img, h, w, c, scale, sigma, min_size,
                        labels.reshape(-1))
    return labels


def slic(image: np.ndarray, n_segments: int, compactness: float = 10.0,
         max_iter: int = 10) -> np.ndarray:
    """MDA's superpixels (MDAFunctions.py:604): ``[H, W, 3]`` float RGB in
    [0, 1] -> ``[H, W]`` int32 labels 0..K-1."""
    img = np.ascontiguousarray(image, dtype=np.float32)
    h, w = img.shape[:2]
    labels = np.empty((h, w), np.int32)
    load().slic(img, h, w, n_segments, compactness, max_iter,
                labels.reshape(-1))
    return labels


def project_curve(y: np.ndarray, mode: str,
                  iters: int = 100000) -> np.ndarray:
    """Projection of a curve onto {convex (del) / concave (ins), [0, 1]
    box, fixed endpoints}: the reference's cvxopt QP
    (MASTestFunctions.py:311-350) as Dykstra's iteration, which exits
    once a sweep stops moving."""
    yv = np.ascontiguousarray(y, dtype=np.float64)
    out = np.empty_like(yv)
    load().project_curve(yv, len(yv), 0 if mode == "del" else 1, iters, out)
    return out
