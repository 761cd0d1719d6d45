"""Build and load the port's CUDA kernels.

``nvcc`` compiles the sources under ``ops/csrc/`` for ``sm_90a`` into a
shared library with a plain C interface, which ``ctypes`` loads: no
PyTorch headers, so the build takes seconds instead of the minutes a
``torch.utils.cpp_extension`` build takes. The library lands in
``ops/_build/`` (listed in ``.gitignore``) under a name that hashes the
sources and flags, so an edited source is rebuilt and an unchanged one is
not. The build runs at the first kernel launch, never at import; a failed
build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]

# The C entry points of csrc/*.cu and their argument types: every pointer
# (and the stream) as c_void_p, so ctypes does not cut it to 32 bits.
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "mercury_nll_fwd": [_P, _P, _P, _I, _I, _I, _P],
    "mercury_nll_bwd": [_P, _P, _P, _P, _I, _I, _I, _P],
    "mercury_score_and_draw": [_P, _P, _P, _F, _I, _I, _P, _P, _P, _P, _P],
    "mercury_table_refresh_draw": [_P, _P, _P, _P, _P, _F, _F, _I, _I, _I,
                                   _P, _P, _P, _P, _P, _P],
    "mercury_augment_normalize": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                  _I, _P],
}

_lib: Optional[ctypes.CDLL] = None
build_log = ""  # compiler output of the last build in this process


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def find_nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME, $CUDA_PATH, "
            "/usr/local/cuda and PATH): the CUDA kernels cannot be built")
    return found


def library_path(extra_flags=()) -> Path:
    h = hashlib.sha256()
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS + list(extra_flags)).encode())
    return BUILD_DIR / f"libmercury_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile the kernels unless this exact build exists. ``verbose`` adds
    ``-Xptxas -v`` (registers, shared memory, spills per kernel); the
    compiler's output is kept in ``build_log``."""
    global build_log
    extra = ["-Xptxas", "-v"] if verbose else []
    out = library_path()
    if out.exists() and not verbose:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *ARCH_FLAGS, *NVCC_FLAGS, *extra, "-o", tmp,
           *map(str, sources())]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{build_log}")
        os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built on first use and declared for ctypes."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib
