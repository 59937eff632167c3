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


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare the C entry points."""
    lib = ctypes.CDLL(str(build()))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.rtgs_keys_sid.argtypes = [vp] * 8 + [i] * 5 + [vp]
    lib.rtgs_keys_sid.restype = i
    lib.rtgs_peel_fwd.argtypes = [vp] * 7 + [i] * 5 + [vp]
    lib.rtgs_peel_fwd.restype = i
    lib.rtgs_peel_bwd.argtypes = [vp] * 8 + [i] * 5 + [vp]
    lib.rtgs_peel_bwd.restype = i
    lib.rtgs_peel_topk_fwd.argtypes = [vp] * 6 + [i] * 5 + [vp]
    lib.rtgs_peel_topk_fwd.restype = i
    lib.rtgs_peel_topk_bwd.argtypes = [vp] * 7 + [i] * 5 + [vp]
    lib.rtgs_peel_topk_bwd.restype = i
    lib.rtgs_probe_micro.argtypes = [i, vp, vp, i, i, i, vp, vp, vp, i, vp]
    lib.rtgs_probe_micro.restype = i
    lib.rtgs_probe_ablate.argtypes = ([i] + [vp] * 5 + [i] * 5
                                      + [ctypes.c_float] * 2 + [i, vp])
    lib.rtgs_probe_ablate.restype = i
    lib.rtgs_probe_floor.argtypes = [i, vp, vp, vp] + [i] * 6 + [vp]
    lib.rtgs_probe_floor.restype = i
    lib.rtgs_cuda_error_string.argtypes = [i]
    lib.rtgs_cuda_error_string.restype = ctypes.c_char_p
    return lib
