"""Build the package's CUDA kernels with nvcc at first use, load with ctypes.

The sources are ``opencv_opencl_tpu_torch/csrc/*.cu`` (and the ``*.cuh``
they include).  They compile, one nvcc per source and all at
once, and link to one shared library with a plain C interface for Hopper
(``sm_90a``), named after a hash of the sources and the flags, in
``opencv_opencl_tpu_torch/_build/``: an edited source gets a new library,
an unchanged one is reused.  A failed build raises with
nvcc's output; nothing falls back to another implementation.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading

__all__ = ["NVCC_FLAGS", "library_path", "load", "is_built", "ptxas_report"]

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# every pointer and the stream are c_void_p: ctypes would otherwise pass a
# Python int as a 32-bit int and cut the address
_SIGNATURES = {
    "tile_hist_launch": (_P, _I, _I, _I, _LL, _LL, _I, _I, _I, _I, _I, _I,
                         _I, _I, _I, _I, _I, _I, _P, _P),
    "build_luts_launch": (_P, _I, _I, _P, _I, ctypes.c_float, _P, _P),
    "launch_floor_launch": (_I, _P),
    "interp_launch": (_P, _LL, _LL, _P, _I, _I, _I, _I, _P, _I, _P, _P, _P,
                      _P, _P, _P, _P, _LL, _LL, _I, _I, _P),
    "interp_hist_launch": (_P, _LL, _LL, _P, _I, _I, _I, _I, _I, _I, _P, _I,
                           _P, _P, _P, _P, _P, _P, _P, _LL, _LL, _I, _P, _P),
    "apply_lut_launch": (_P, _LL, _LL, _P, _I, _I, _I, _P, _LL, _LL, _I, _P),
    "interp_cells_launch": (_P, _LL, _LL, _P, _I, _I, _P, _I, _I, _I, _I, _I,
                            _I, _I, _P, _P, _P, _P, _I, _P, _LL, _LL, _I, _P),
}

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()


def _sources() -> tuple[list[str], list[str]]:
    return (sorted(glob.glob(os.path.join(_CSRC, "*.cu"))),
            sorted(glob.glob(os.path.join(_CSRC, "*.cuh"))))


def library_path() -> str:
    """Where the library for the current sources and flags lives."""
    cu, cuh = _sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in cu + cuh:
        digest.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(_BUILD_DIR, f"libkernels_{digest.hexdigest()[:16]}.so")


def is_built() -> bool:
    return os.path.exists(library_path())


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME")
    return path


def _raise_on_failure(cmd: list[str], output: str, returncode: int) -> None:
    if returncode != 0:
        raise RuntimeError(f"nvcc failed ({returncode}): {' '.join(cmd)}\n{output}")


def _compile(out: str) -> None:
    cu, _ = _sources()
    os.makedirs(_BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    # build in a directory beside the target and rename: a concurrent loader
    # never sees a half-written library
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp:
        jobs = []
        for src in cu:
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            cmd = [nvcc, *compile_flags, "-c", "-o", obj, src]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        outputs = [(cmd, proc.communicate()[0], proc.returncode)
                   for cmd, _, proc in jobs]
        for cmd, text, returncode in outputs:
            _raise_on_failure(cmd, text, returncode)
        lib = os.path.join(tmp, "libkernels.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", lib, *(obj for _, obj, _ in jobs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        _raise_on_failure(cmd, res.stdout + res.stderr, res.returncode)
        os.replace(lib, out)


def load() -> ctypes.CDLL:
    """The kernel library, built first if the sources changed."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not os.path.exists(path):
                _compile(path)
            lib = ctypes.CDLL(path)
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def _kernel_of(line: str, kernels: tuple[str, ...]) -> str | None:
    """The kernel of ``kernels`` that a ptxas line names, the longest name
    first (one may hold another), with its template argument where the
    mangled name has one: ``tile_hist_kernel<4>``."""
    for k in sorted(kernels, key=len, reverse=True):
        if k in line:
            arg = re.search(re.escape(k) + r"ILi(-?\d+)E", line)
            return f"{k}<{arg.group(1)}>" if arg else k
    return None


def ptxas_report(kernels: tuple[str, ...], csrc: str = _CSRC) -> list[str]:
    """What ``nvcc -Xptxas -v`` says of the named kernels in the ``*.cu``
    sources of ``csrc`` (registers, shared memory, spills), one
    ``"<kernel>: <line>"`` each, a template's instances apart.  Compiles to
    no output file."""
    flags = [f for f in NVCC_FLAGS if f != "-shared"]
    keep = []
    for src in sorted(glob.glob(os.path.join(csrc, "*.cu"))):
        res = subprocess.run([_nvcc(), *flags, "-Xptxas", "-v", "-c", "-o",
                              os.devnull, src], capture_output=True, text=True)
        name = None
        for line in (res.stdout + res.stderr).splitlines():
            if "Compiling entry function" in line or "Function properties for" in line:
                name = _kernel_of(line, kernels)
            if name and ("Used" in line or "spill" in line or "Compiling" in line):
                keep.append(f"{name}: {line.strip()}")
    return keep
