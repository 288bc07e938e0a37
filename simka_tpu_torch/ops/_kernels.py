"""Build and bind the port's hand-written CUDA kernels (``csrc/*.cu``).

The kernels have a plain C interface: ``nvcc`` compiles them into one
shared library at first use, in the git-ignored build directory
``simka_tpu_torch/_build``, and ctypes
loads it. Nothing is built or imported when this module is imported:
the CPU tests import every module, and the CPU has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import tempfile
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
_LIB_NAME = "libsimka_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels of "
        "simka_tpu_torch are built from csrc/ at first use"
    )


def build(verbose: bool = False) -> str:
    """Compile ``csrc/*.cu`` into the build directory when the library
    is missing or older than a source; return the library's path."""
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    lib_path = os.path.join(BUILD_DIR, _LIB_NAME)
    newest = max(os.path.getmtime(s) for s in sources)
    if os.path.exists(lib_path) and os.path.getmtime(lib_path) >= newest:
        return lib_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, *sources]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    if verbose:
        print(proc.stdout + proc.stderr, flush=True)
    os.replace(tmp, lib_path)
    return lib_path


def lib():
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            try:
                handle = ctypes.CDLL(build())
            except OSError as e:  # not a read failure: callers retry those
                raise RuntimeError(
                    f"the CUDA kernel library did not build or load: {e}"
                ) from e
            vp = ctypes.c_void_p
            handle.simka_compact_tile_rows.restype = ctypes.c_int64
            handle.simka_compact_tile_rows.argtypes = []
            i32, i64 = ctypes.c_int, ctypes.c_int64
            for name, args in (
                ("simka_compact_rows", [vp, i64, i32, vp, vp, vp, vp, i64,
                                        i32, vp, vp]),
                # csrc/probes.cu
                ("simka_probe_scale_f32", [vp, vp, i64, ctypes.c_float, vp]),
                ("simka_probe_map_i32", [i32, vp, vp, i64, i32, vp, vp]),
                ("simka_probe_onehot_f32", [vp, vp, i64, i32, vp]),
                ("simka_probe_max_positive", [i32, vp, i64, vp, vp]),
                ("simka_probe_gram_bf16", [i32, vp, vp, i64, i32, i32, vp,
                                           vp, vp]),
                ("simka_probe_dma", [vp, i64, vp, i64, vp, i64, i64, i64,
                                     i64, vp, vp]),
            ):
                fn = getattr(handle, name)
                fn.restype = ctypes.c_int
                fn.argtypes = args
            _lib = handle
        return _lib


def check(code: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")
