"""Build and load the hand-written CUDA kernels of ``csrc/``.

Every ``.cu`` file under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a``
(NVIDIA Hopper), one ``nvcc`` process per source, all started together,
and the objects are linked into ONE shared library with a plain
``extern "C"`` interface, loaded with ``ctypes``. The library is built at
first use, from the package's own sources, into ``harkdb_tpu_torch/build/``;
its file name carries a hash of the sources and flags, so a changed source
builds anew and an unchanged one is loaded as it is.

Nothing here runs at import: the CPU never needs the library, and the
machines that run the CPU tests have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Optional, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int32
_SIGNATURES = {
    "harkdb_cuda_error_string": (ctypes.c_char_p, [ctypes.c_int]),
    "harkdb_compact_num_tiles": (_I64, [_I64]),
    "harkdb_compact": (
        ctypes.c_int, [_P, _P, _I64, ctypes.c_int, _P, _P, _P, _P, _P, _P],
    ),
    "harkdb_segscan_scratch_words": (_I64, [_I64, ctypes.c_int]),
    "harkdb_segscan": (
        ctypes.c_int,
        [ctypes.c_int, ctypes.c_int, _P, _I64, ctypes.c_int, _P, _P, _I32,
         ctypes.c_int, _P, _P],
    ),
    "harkdb_expand_fills": (
        ctypes.c_int,
        [_P, _P, _I64, _I64, ctypes.c_int, _P, _P, _P, _P, _P],
    ),
    "harkdb_smem_optin": (ctypes.c_int, []),
    "harkdb_dense_agg": (
        ctypes.c_int,
        [_P, _P, _P, _I64, _I32, ctypes.c_int, ctypes.c_int, _P,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P, _P],
    ),
    "harkdb_radix_sort_temp_bytes": (_I64, [_I64, ctypes.c_int, ctypes.c_int]),
    "harkdb_radix_sort_pairs": (
        ctypes.c_int,
        [_P, _P, _P, _P, _I64, ctypes.c_int, ctypes.c_int, _P, _I64,
         ctypes.POINTER(ctypes.c_int), _P],
    ),
    "harkdb_join_runs_scratch_words": (_I64, [_I64]),
    "harkdb_join_words": (
        ctypes.c_int,
        [_P, _P, _P, _P, _P, _P, _I64, _I64, ctypes.c_int, _P, _P, _P],
    ),
    "harkdb_join_runs": (
        ctypes.c_int,
        [_P, ctypes.c_int, _P, _I64, _I64, _P, _P, _P, _P, _P, _P, _P, _P],
    ),
}

_lib: Optional[ctypes.CDLL] = None


def _sources() -> list:
    return sorted(
        os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
        if f.endswith((".cu", ".cuh"))
    )


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH); the CUDA kernels cannot be built"
        )
    return found


def build() -> Tuple[str, str, float]:
    """Compile the kernels if the current sources have no library yet.

    Returns ``(library path, nvcc output, seconds spent compiling)``; the
    output holds ``-Xptxas -v``'s registers / shared memory / spills per
    kernel, and is empty (with 0 seconds) when the library already existed.
    Raises ``RuntimeError`` when nvcc fails.
    """
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        with open(s, "rb") as f:
            h.update(os.path.basename(s).encode() + b"\0" + f.read())
    lib_path = os.path.join(BUILD_DIR, f"libharkdb_kernels_{h.hexdigest()[:16]}.so")
    if os.path.exists(lib_path):
        return lib_path, "", 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{h.hexdigest()[:16]}.{os.getpid()}"
    t0 = time.perf_counter()
    jobs = []
    for s in srcs:
        if not s.endswith(".cu"):
            continue
        obj = os.path.join(
            BUILD_DIR, f"{os.path.basename(s)[:-3]}.{tag}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, s]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for cmd, _obj, proc in jobs:
        out, _ = proc.communicate()
        logs.append(out.strip())
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({' '.join(cmd)}):\n{out.strip()}")
    objs = [obj for _cmd, obj, _proc in jobs]
    try:
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        cmd = [nvcc, "-shared", "-o", tmp, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({' '.join(cmd)}):\n"
                               f"{(proc.stdout + proc.stderr).strip()}")
        os.replace(tmp, lib_path)   # atomic: a reader never sees half a file
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    seconds = time.perf_counter() - t0
    return lib_path, "\n".join(logs), seconds


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        path, _log, _secs = build()
        lib = ctypes.CDLL(path)
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _lib = lib
    return _lib


def check(status: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if status != 0:
        msg = library().harkdb_cuda_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg})")


def pointer_array(tensors) -> ctypes.Array:
    """Host array of the tensors' device pointers (kept alive by the caller
    together with the tensors for the duration of the launch call)."""
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
