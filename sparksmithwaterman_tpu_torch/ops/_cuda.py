"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

The sources are compiled by ``nvcc`` for Hopper (``sm_90a``) into one
shared library with a plain C interface, cached under ``build/kernels/``
keyed by a hash of the sources and flags, and loaded with ctypes.  Every
C entry point takes device pointers and the CUDA stream as ``void *``,
launches on that stream without synchronising, and returns
``cudaGetLastError()``; :func:`check` raises on anything but 0, so a
refused launch never passes silently.

Nothing here runs at import time: this module is imported on machines
without ``nvcc`` or a GPU, where only the plain PyTorch versions run.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
_BUILD = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build",
    "kernels",
)
_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_lib = None
# Facts about the build of this process, for reports: seconds spent in
# nvcc (0.0 when the cached library was reused) and the ptxas log.
build_info = {"seconds": 0.0, "log": "", "path": ""}

_VP = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources():
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")) + glob.glob(os.path.join(_CSRC, "*.cuh")))


def _build() -> str:
    digest = hashlib.sha256(" ".join(_FLAGS).encode())
    for path in _sources():
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + f.read())
    out = os.path.join(_BUILD, f"libswtorch_kernels-{digest.hexdigest()[:16]}.so")
    build_info["path"] = out
    if os.path.exists(out):
        return out
    os.makedirs(_BUILD, exist_ok=True)
    units = [p for p in _sources() if p.endswith(".cu")]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [_nvcc(), *_FLAGS, "-o", tmp, *units],
            capture_output=True,
            text=True,
        )
        build_info["log"] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_info['log']}")
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    build_info["seconds"] = time.perf_counter() - t0
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(_build())
            handle.swt_error_string.restype = ctypes.c_char_p
            handle.swt_error_string.argtypes = [_I]
            handle.swt_lane_best_varlen.restype = _I
            handle.swt_lane_best_varlen.argtypes = [
                _VP, _I, _I,  # packed, rows, m
                _VP, _VP, _VP, _I,  # refs, offsets, lens, c
                _I, _I, _I,  # match, mismatch, gap
                _VP, _I, _VP,  # out, device, stream
            ]
            handle.swt_argmax_lane.restype = _I
            handle.swt_argmax_lane.argtypes = [
                _VP, _I, _I,  # reads, r, m
                _VP, _LL, _I, _I,  # refs, ref_stride, c, n
                _I, _I, _I,  # match, mismatch, gap
                _VP, _VP, _VP, _I, _VP,  # best, bestd, count, device, stream
            ]
            _lib = handle
        return _lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        msg = lib().swt_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
