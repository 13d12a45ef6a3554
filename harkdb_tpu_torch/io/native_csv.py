"""ctypes bridge to the native parallel CSV loader.

``native/csv_loader.cpp`` (a copy of the JAX package's loader, same C
interface) is built by ``g++`` at first use into ``harkdb_tpu_torch/build/``
and rebuilt when the source is newer than the library. The build writes a
file of its own and renames it into place, so several processes may build
at once and none loads a half-written library. A failed build raises with
the compiler's output: there is no silent fallback to pandas.

Matches pandas' dtype inference for numeric CSVs: a column whose values are
all integral becomes the engine int dtype, otherwise the float dtype.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_PKG, "io", "native", "csv_loader.cpp")
LIB = os.path.join(_PKG, "build", "csv_loader.so")
GXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
             "-pthread")

# Bytes of the data region checked for text cells before the native parse:
# the parser has no error recovery for them.
SNIFF_BYTES = 1 << 16
_NUMERIC_BYTES = frozenset(b"0123456789+-.eE, \t\r\n")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def build() -> str:
    """Compile the loader unless a library at least as new as the source
    exists. Returns the library's path; raises ``RuntimeError`` with
    g++'s output when the build fails."""
    if os.path.exists(LIB) and os.path.getmtime(LIB) >= os.path.getmtime(SRC):
        return LIB
    os.makedirs(os.path.dirname(LIB), exist_ok=True)
    tmp = f"{LIB}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = ["g++", *GXX_FLAGS, SRC, "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(
                f"building the native CSV loader failed ({' '.join(cmd)}):\n"
                f"{(proc.stderr or proc.stdout).strip()}")
        os.replace(tmp, LIB)    # atomic: a reader never sees half a file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return LIB


def library() -> ctypes.CDLL:
    """The loaded loader library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.hark_csv_dims.restype = ctypes.c_int
            lib.hark_csv_dims.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.c_char_p, ctypes.c_int64,
            ]
            lib.hark_csv_parse.restype = ctypes.c_int
            lib.hark_csv_parse.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_int64, ctypes.c_int64,
            ]
            _lib = lib
    return _lib


def _looks_numeric(path: str) -> bool:
    """The first ``SNIFF_BYTES`` after the header hold no text cell."""
    with open(path, "rb") as f:
        head = f.read(SNIFF_BYTES)
    nl = head.find(b"\n")
    if nl < 0:
        return False
    return all(b in _NUMERIC_BYTES for b in head[nl + 1:])


def native_read_csv(
    path: str, config
) -> Optional[Tuple[Dict[str, np.ndarray], List[str]]]:
    """Parse a numeric CSV natively into ``(columns, names)``. Returns None
    (the caller goes to pandas) for a file with text cells, no header line
    or rows the parser cannot read."""
    try:
        if not _looks_numeric(path):
            return None
    except OSError:
        return None
    lib = library()
    rows = ctypes.c_int64()
    cols = ctypes.c_int64()
    header = ctypes.create_string_buffer(1 << 20)
    rc = lib.hark_csv_dims(path.encode(), ctypes.byref(rows),
                           ctypes.byref(cols), header, len(header))
    if rc != 0:
        return None
    r, c = rows.value, cols.value
    names = [h.strip() for h in header.value.decode("utf-8").split(",")]
    if len(names) != c or r < 0:
        return None
    buf = np.empty((c, r), dtype=np.float64)
    rc = lib.hark_csv_parse(
        path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        r, c,
    )
    if rc != 0:
        return None
    out: Dict[str, np.ndarray] = {}
    for i, name in enumerate(names):
        col = buf[i]
        if np.all(col == np.floor(col)):
            out[name] = col.astype(config.int_dtype)
        else:
            out[name] = col.astype(config.float_dtype)
    return out, names
