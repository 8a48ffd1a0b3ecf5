"""ctypes bindings for the native C++ text parser (counterpart of
betacores_tpu/data/native_loader.py).

The parser is the repository's own ``native/loader.cpp`` (multithreaded,
chunked over an mmap of the file; dense float32 rows). At first use it is
compiled with ``g++`` and the flags of ``native/Makefile`` into
``build/native/libbcloader-<hash>.so`` at the root of the checkout (listed
in .gitignore), where the hash covers the source and the flags, so an
edited source is rebuilt and a stale library is never loaded. The build
goes to a temporary file that ``os.replace`` moves into place, so
concurrent processes are safe. Nothing is written into ``native/``, and
the library committed there is never loaded.

Without a C++ compiler the parse falls back to NumPy, as the reference's
does (the same values). With a compiler, a build that fails raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
# native/Makefile's CXXFLAGS, and -shared
CXXFLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-pthread", "-Wall", "-shared")


def _compiler() -> Optional[str]:
    """The C++ compiler (``$CXX``, else ``g++`` on the PATH), or None."""
    return shutil.which(os.environ.get("CXX", "g++"))


def library_path(cxx: str) -> Path:
    """Path of the built parser library (built with ``cxx`` if absent)."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join((os.path.basename(cxx),) + CXXFLAGS).encode())
    out = BUILD_DIR / f"libbcloader-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXXFLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed on {SOURCE}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


@functools.cache
def _get_lib() -> Optional[ctypes.CDLL]:
    """The parser library, built at first use; None without a compiler."""
    cxx = _compiler()
    if cxx is None:
        return None
    lib = ctypes.CDLL(str(library_path(cxx)))
    lib.bc_load_csv.restype = ctypes.POINTER(ctypes.c_float)
    lib.bc_load_csv.argtypes = [ctypes.c_char_p, ctypes.c_char, ctypes.c_int,
                                ctypes.c_int, ctypes.POINTER(ctypes.c_int64),
                                ctypes.POINTER(ctypes.c_int64)]
    lib.bc_load_svmlight.restype = ctypes.POINTER(ctypes.c_float)
    lib.bc_load_svmlight.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
                                     ctypes.POINTER(ctypes.c_int64),
                                     ctypes.POINTER(ctypes.c_int64)]
    lib.bc_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
    return lib


def native_available() -> bool:
    return _get_lib() is not None


def _to_array(lib, ptr, rows, cols) -> np.ndarray:
    try:
        arr = np.ctypeslib.as_array(ptr, shape=(rows.value, cols.value)).copy()
    finally:
        lib.bc_free(ptr)
    return arr


def load_csv(path: str, delimiter: str = ",", skip_header: int = 0,
             n_threads: int = 0) -> np.ndarray:
    """Dense float32 matrix from a numeric CSV."""
    lib = _get_lib()
    if lib is None:
        return _csv_numpy(path, delimiter, skip_header)
    rows, cols = ctypes.c_int64(), ctypes.c_int64()
    ptr = lib.bc_load_csv(str(path).encode(), delimiter.encode(), skip_header,
                          n_threads, ctypes.byref(rows), ctypes.byref(cols))
    if not ptr:
        raise IOError(f"native CSV parse failed: {path}")
    return _to_array(lib, ptr, rows, cols)


def load_svmlight(path: str, n_features: int = 0,
                  n_threads: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """(X, y) from svmlight/libsvm text (dense float32; 1-based indices)."""
    lib = _get_lib()
    if lib is None:
        return _svmlight_numpy(path, n_features)
    rows, cols = ctypes.c_int64(), ctypes.c_int64()
    ptr = lib.bc_load_svmlight(str(path).encode(), n_features, n_threads,
                               ctypes.byref(rows), ctypes.byref(cols))
    if not ptr:
        raise IOError(f"native svmlight parse failed: {path}")
    m = _to_array(lib, ptr, rows, cols)
    return m[:, 1:], m[:, 0]


def _csv_numpy(path: str, delimiter: str = ",", skip_header: int = 0) -> np.ndarray:
    """The numpy parse of ``load_csv`` (``np.genfromtxt``)."""
    # atleast_2d: genfromtxt returns (D,) for a one-row file while the
    # native path always returns (1, D)
    return np.atleast_2d(np.genfromtxt(path, delimiter=delimiter,
                                       skip_header=skip_header).astype(np.float32))


def _svmlight_numpy(path: str, n_features: int = 0):
    labels = []
    maxf = n_features
    with open(path) as f:
        parsed = []
        for line in f:
            parts = line.split("#")[0].split()
            if not parts:
                continue
            labels.append(float(parts[0]))
            feats = {}
            for tok in parts[1:]:
                i, v = tok.split(":", 1)
                if not i.isdigit():
                    continue  # qid:/comment tokens (legal svmlight)
                i = int(i)
                if i < 1:
                    raise ValueError(
                        f"svmlight feature indices are 1-based, got {i} in {path}")
                feats[i] = float(v)
                maxf = max(maxf, i)
            parsed.append(feats)
    X = np.zeros((len(parsed), maxf), dtype=np.float32)
    for r, feats in enumerate(parsed):
        for i, v in feats.items():
            X[r, i - 1] = v
    return X, np.asarray(labels, dtype=np.float32)
