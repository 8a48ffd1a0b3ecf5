"""Builds the port's CUDA sources (``betacores_tpu_torch/csrc/*.cu``) at
first use and loads them with ctypes.

Each source compiles with ``nvcc`` into a shared library with a plain C
interface, for Hopper (``sm_90a``), into ``build/kernels/`` at the root of
the checkout (listed in .gitignore). The library's file name carries a hash
of the source, of every header in ``csrc/`` (sources share device code
through them) and of the flags, so an edited source or header is rebuilt
and a stale library is never loaded. ``nvcc``'s report (``-Xptxas -v``: registers,
shared memory, spills) is kept beside the library as ``.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: put the CUDA toolkit's bin on PATH "
                       "or set CUDA_HOME")


def source_digest(name: str, csrc: Path = CSRC) -> str:
    """Hash of ``<csrc>/<name>.cu``, of every ``.cuh`` header beside it (by
    name and content) and of the flags: what the built library depends on."""
    digest = hashlib.sha256((csrc / f"{name}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return digest.hexdigest()[:16]


def library_path(name: str) -> Path:
    """Path of the built library for ``csrc/<name>.cu`` (built if absent)."""
    src = CSRC / f"{name}.cu"
    out = BUILD_DIR / f"lib{name}-{source_digest(name)}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and load it. The caller declares
    argtypes and restype."""
    return ctypes.CDLL(str(library_path(name)))
