"""Build and bind the port's hand-written CUDA kernels (``csrc/*.cu``).

The kernels have a plain C interface: at first use ``nvcc`` compiles
each source into an object, all of them at once, then links the
objects into one shared library in the git-ignored build directory
``simka_tpu_torch/_build``, and ctypes loads it. Nothing is built or
imported when this module is imported: the CPU tests import every
module, and the CPU has no ``nvcc``.
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
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")

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


def sources() -> list:
    """The kernel sources, ``csrc/*.cu``."""
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def compile_library(out: str, verbose: bool = False) -> None:
    """Compile every ``csrc/*.cu`` and link them into the shared
    library ``out``: one ``nvcc`` a source, all started together, then
    one link."""
    srcs = sources()
    with tempfile.TemporaryDirectory(dir=os.path.dirname(out)) as tmp:
        objs = [os.path.join(tmp, os.path.basename(s) + ".o") for s in srcs]
        procs = [
            subprocess.Popen(
                [_nvcc(), *COMPILE_FLAGS, "-Xptxas", "-v", "-c", "-o", o, s],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for s, o in zip(srcs, objs)
        ]
        logs = [p.communicate()[0] for p in procs]
        failed = [(s, p.returncode, log) for s, p, log in
                  zip(srcs, procs, logs) if p.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"{os.path.basename(s)} ({rc}):\n{log}"
                for s, rc, log in failed))
        proc = subprocess.run([_nvcc(), *ARCH, "-shared", "-o", out, *objs],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        if verbose:
            print("".join(logs) + proc.stdout + proc.stderr, flush=True)


def build(verbose: bool = False) -> str:
    """Compile ``csrc/*.cu`` into the build directory when the library
    is missing or older than a source; return the library's path."""
    lib_path = os.path.join(BUILD_DIR, _LIB_NAME)
    newest = max(os.path.getmtime(s) for s in sources())
    if os.path.exists(lib_path) and os.path.getmtime(lib_path) >= newest:
        return lib_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        compile_library(tmp, verbose=verbose)
    except BaseException:
        os.unlink(tmp)
        raise
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
            i32, i64, u64 = ctypes.c_int, ctypes.c_int64, ctypes.c_uint64
            for name, res, args in (
                ("simka_compact_tile_rows", i64, []),
                ("simka_min_pair_segment", i32, []),
                ("simka_min_pair_scratch_words", i64, [i64, i64]),
                ("simka_pair_sums_budget", i64, [i64, i32]),
                ("simka_runs_tile_rows", i64, []),
                ("simka_segment_shared_banks", i64, []),
                ("simka_sort_tile_keys", i64, []),
                ("simka_sort_portion_tiles", i64, []),
            ):
                fn = getattr(handle, name)
                fn.restype = res
                fn.argtypes = args
            for name, args in (
                ("simka_compact_rows", [vp, i64, i32, vp, vp, vp, vp, i64,
                                        i32, vp, vp]),
                # csrc/kmers.cu
                ("simka_extract_kmers", [vp, vp, vp, i64, i64, i32, i32, i32,
                                         ctypes.c_float, vp, i32, i32, vp,
                                         vp, vp, vp]),
                # csrc/runs.cu
                ("simka_run_counts", [vp, vp, i32, i64, i64, i64, vp, vp, vp,
                                      vp]),
                ("simka_segment_stats", [vp, i32, i64, vp, i32, vp, i32, i64,
                                         vp, vp, vp, vp, vp]),
                # csrc/sort.cu
                ("simka_radix_sort", [vp, vp, i32, i32, i64, i32, vp, vp, vp,
                                      vp, vp, vp, vp]),
                # csrc/minhash.cu
                ("simka_murmur_kmers", [vp, vp, i64, u64, u64, vp, vp, vp,
                                        vp]),
                # csrc/min_distance.cu
                ("simka_min_pair_tallies", [vp] * 10 + [i64, i64, vp, vp,
                                                      vp]),
                # csrc/pair_sums.cu
                ("simka_pair_sums", [vp, vp, vp, vp, i64, i64, vp, i64, vp,
                                     vp, i32, i32, i32, vp, vp, vp]),
                # csrc/probes.cu
                ("simka_probe_map", [i32, vp, vp, i64, i32, ctypes.c_float,
                                     vp, vp]),
                ("simka_probe_onehot_f32", [vp, vp, i64, i32, vp]),
                ("simka_probe_max_positive", [i32, vp, i64, vp, vp, vp]),
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
