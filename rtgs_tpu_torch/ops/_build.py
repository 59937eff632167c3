"""Build and load the port's CUDA kernels.

``nvcc`` compiles the ``.cu`` sources under ``csrc/`` into one shared
library with a plain C interface, at first use, into
``rtgs_tpu_torch/_build/``; the library's name carries a hash of the
sources and flags, so an edited source rebuilds. It is loaded with
``ctypes``. Nothing here runs at import time: the CPU-only tests import
every module, and there is no ``nvcc`` there.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

_PKG = pathlib.Path(__file__).resolve().parents[1]
SRC_DIR = _PKG / "ops" / "csrc"
BUILD_DIR = _PKG / "_build"
# IEEE sqrt and division (no --use_fast_math), and no FMA contraction, so
# the kernel's t1 is bitwise the plain torch twin's.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC"]


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = pathlib.Path(home) / "bin" / "nvcc"
    if path.is_file():
        return str(path)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME or /usr/local/cuda); "
                       "the CUDA kernels are built from source at first use")


def library_path() -> pathlib.Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(SRC_DIR.glob("*.cu")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"librtgs_kernels_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the sources unless the library for them exists; the
    compiler's resource report (``-Xptxas -v``) goes to a ``.log`` beside
    the library. Returns the library's path."""
    lib = library_path()
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
               *map(str, sorted(SRC_DIR.glob("*.cu")))]
        res = subprocess.run(cmd, capture_output=True, text=True)
        lib.with_suffix(".log").write_text(res.stdout + res.stderr)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare the C entry points."""
    lib = ctypes.CDLL(str(build()))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.rtgs_keys_sid.argtypes = [vp] * 7 + [i] * 5 + [vp]
    lib.rtgs_keys_sid.restype = i
    lib.rtgs_cuda_error_string.argtypes = [i]
    lib.rtgs_cuda_error_string.restype = ctypes.c_char_p
    return lib
