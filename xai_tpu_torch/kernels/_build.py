"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by its own ``nvcc`` process for
``sm_90a`` into a shared library with a plain C interface, loaded with
``ctypes``.  No PyTorch header is compiled, so a build takes seconds, not
the minutes ``torch.utils.cpp_extension.load`` takes.  Libraries land in
``csrc/build/`` (git-ignored) under a name that hashes the source and the
flags, so an edited source is rebuilt and a stale one never loaded.

Nothing is built or loaded at import time: the first wrapper call on a
CUDA tensor builds what it needs, and ``build()`` builds every kernel at
once, all ``nvcc`` processes started together.

Each C entry point takes ``void*`` pointers, sizes, the device index and
the stream, and returns ``cudaGetLastError()`` after its launch; the
wrapper raises through :func:`check` if that is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
KERNELS = ("blur", "reveal", "quickshift", "bn_act", "layernorm")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# a mesh battery launches from one host thread a data shard
# (metrics/curves.py): the first loads are shared between them
# (the launch counters are utils/trace.py's)
_LOCK = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (needed to build the CUDA "
                           "kernels in xai_tpu_torch/csrc)")
    return path


def lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(names: Sequence[str] = KERNELS) -> Dict[str, dict]:
    """Compile every library in ``names`` that is not built yet, one
    ``nvcc`` per source, all running at once.  Returns, per compiled
    name, its seconds and the compiler's output (``-Xptxas -v``: registers
    and shared memory per kernel)."""
    todo = [n for n in names if not lib_path(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    try:
        for n in todo:
            final = lib_path(n)
            tmp = final.with_name(f"{final.stem}.{os.getpid()}.tmp.so")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True),
                        tmp)
        report = {}
        for n, (proc, tmp) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on csrc/{n}.cu:\n{log}")
            # rename into place: a concurrent process never loads half a file
            os.replace(tmp, lib_path(n))
            report[n] = {"seconds": time.perf_counter() - t0, "log": log}
        return report
    finally:
        for proc, tmp in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if tmp.exists():
                tmp.unlink()


def load(name: str) -> ctypes.CDLL:
    """Load the library for ``csrc/<name>.cu``, building it if needed.
    Each wrapper loads its library once and keeps it."""
    with _LOCK:
        build([name])
    lib = ctypes.CDLL(str(lib_path(name)))
    lib.xai_cuda_error_string.argtypes = [ctypes.c_int]
    lib.xai_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.xai_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
