"""Build and load the port's CUDA kernels.

``nvcc`` compiles the ``.cu`` sources under ``csrc/`` (one process per
source, all at once) and links them into one shared library with a plain C
interface, at first use, into ``rtgs_tpu_torch/_build/``; the library's
name carries a hash of the sources, their shared header
(``peel_common.cuh``) and the flags, so an edited source rebuilds. It is
loaded with ``ctypes``. Nothing here runs at import time: the CPU-only
tests import every module, and there is no ``nvcc`` there.
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
# the kernels' t1 is bitwise the plain torch twins' (the keys kernel's f32
# screen asks for its FMAs explicitly).
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC"]


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
    for src in sorted(SRC_DIR.glob("*.cu*")):
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
    nvcc = nvcc_path()
    tmp = pathlib.Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        objs = [str(tmp / (src.stem + ".o"))
                for src in sorted(SRC_DIR.glob("*.cu"))]
        jobs = []
        for src, obj in zip(sorted(SRC_DIR.glob("*.cu")), objs):
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
            jobs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        link = [nvcc, "-shared", *NVCC_FLAGS[:2], "-o", str(tmp / "lib.so"),
                *objs]
        log, failed = [], []
        for cmd, proc in jobs:
            out = proc.communicate()[0]
            log.append(out)
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{out}")
        if not failed:
            res = subprocess.run(link, capture_output=True, text=True)
            log.append(res.stdout + res.stderr)
            if res.returncode != 0:
                failed.append(f"{' '.join(link)}\n{res.stderr}")
        lib.with_suffix(".log").write_text("".join(log))
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        os.replace(tmp / "lib.so", lib)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


# The C entry points' parameter kinds, in order: "ptr" (a device pointer or
# the stream), "int" or "float". One table for every ``extern "C"`` launcher
# in ``csrc/*.cu`` (read without building: the tests hold it against the
# sources' parameter lists); each returns the ``cudaError_t`` of its launch
# as an int.
_P, _I, _F = "ptr", "int", "float"
SIGNATURES = {
    "rtgs_keys_sid": (_P,) * 10 + (_I,) * 5 + (_P,),
    "rtgs_peel_fwd": (_P,) * 11 + (_I,) * 5 + (_P,),
    "rtgs_peel_bwd": (_P,) * 10 + (_I,) * 5 + (_P,),
    "rtgs_peel_topk_fwd": (_P,) * 8 + (_I,) * 5 + (_P,),
    "rtgs_peel_topk_bwd": (_P,) * 9 + (_I,) * 5 + (_P,),
    "rtgs_segment_rows": (_P,) * 4 + (_I,) * 3 + (_P,),
    "rtgs_probe_micro": (_I, _P, _P, _I, _I, _I, _P, _P, _P, _I, _P),
    "rtgs_probe_ablate": (_I,) + (_P,) * 5 + (_I,) * 5 + (_F,) * 2 + (_I, _P),
    "rtgs_probe_floor": (_I, _P, _P, _P) + (_I,) * 6 + (_P,),
}
_CTYPES = {_P: ctypes.c_void_p, _I: ctypes.c_int, _F: ctypes.c_float}


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare the C entry points
    (``SIGNATURES``): with ``argtypes`` set, a pointer goes in as a plain
    Python int (``tensor.data_ptr()``) and is not cut to 32 bits."""
    lib = ctypes.CDLL(str(build()))
    for name, kinds in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = [_CTYPES[k] for k in kinds]
        fn.restype = ctypes.c_int
    lib.rtgs_cuda_error_string.argtypes = [ctypes.c_int]
    lib.rtgs_cuda_error_string.restype = ctypes.c_char_p
    return lib
