"""Builds the port's native sources into shared libraries.

``csrc/<name>.cu`` (a CUDA kernel) compiles with ``nvcc``, ``csrc/<name>.cpp``
(host code: the BPE merge loop) with the host's ``g++``, each into
``_build/<name>-<hash>.so``, where the hash covers the source and the flags,
so an edited source rebuilds and an unchanged one is reused. Nothing is built
at import: the first use of a library builds it. The libraries have a plain C
interface and are loaded with ``ctypes``.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Tuple

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
HOST_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
FLAGS = {".cu": NVCC_FLAGS, ".cpp": HOST_FLAGS}


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``, else PATH."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found under {candidate} or on PATH; the CUDA toolkit "
            "is needed to build the port's kernels"
        )
    return found


def host_compiler_path() -> str:
    """``g++`` on PATH."""
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found on PATH; it builds the port's host libraries")
    return found


def flags(source: str) -> Tuple[str, ...]:
    """The compiler flags for ``csrc/<source>``, by its suffix."""
    suffix = Path(source).suffix
    if suffix not in FLAGS:
        raise ValueError(f"no compiler for {source}: expected a .cu or .cpp source")
    return FLAGS[suffix]


def library_path(source: str) -> Path:
    """Where the library built from ``csrc/<source>`` lives."""
    src = CSRC_DIR / source
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags(source)).encode())
    return BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:16]}.so"


def build(source: str) -> Tuple[Path, str]:
    """Builds ``csrc/<source>`` if needed; returns the library's path and the
    compiler's output (``-Xptxas -v`` reports registers and spills per kernel;
    empty when the library was already built). Raises if the compiler fails
    or is missing."""
    out = library_path(source)
    if out.exists():
        return out, ""
    tool = nvcc_path() if source.endswith(".cu") else host_compiler_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [tool, *flags(source), "-o", str(tmp), str(CSRC_DIR / source)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{os.path.basename(tool)} failed for {source} "
                           f"(exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)  # atomic: a reader never sees a partial library
    return out, proc.stdout
