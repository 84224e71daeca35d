"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

The sources are compiled by ``nvcc`` for Hopper (``sm_90a``), one
process per ``.cu`` file, all started together, then linked into one
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
from concurrent.futures import ThreadPoolExecutor

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
_BUILD = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build",
    "kernels",
)
_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
_LINK_FLAGS = ["-shared"]

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


def _compile_all(nvcc: str, units, work: str) -> list:
    """Compile every unit to an object in ``work``, one nvcc process per
    unit, all running at once; return the objects."""
    objs = [os.path.join(work, os.path.basename(unit) + ".o") for unit in units]
    with ThreadPoolExecutor(max(1, len(units))) as pool:
        procs = list(pool.map(
            lambda job: subprocess.run([nvcc, *_FLAGS, "-c", "-o", *job], capture_output=True, text=True),
            zip(objs, units),
        ))
    build_info["log"] = "".join(p.stdout + p.stderr for p in procs)
    if any(p.returncode for p in procs):
        raise RuntimeError(f"nvcc failed ({[p.returncode for p in procs]}):\n{build_info['log']}")
    return objs


def _build() -> str:
    digest = hashlib.sha256(" ".join(_FLAGS + _LINK_FLAGS).encode())
    for path in _sources():
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + f.read())
    out = os.path.join(_BUILD, f"libswtorch_kernels-{digest.hexdigest()[:16]}.so")
    build_info["path"] = out
    if os.path.exists(out):
        return out
    os.makedirs(_BUILD, exist_ok=True)
    units = [p for p in _sources() if p.endswith(".cu")]
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=_BUILD) as work:
        objs = _compile_all(nvcc, units, work)
        tmp = os.path.join(work, "lib.so")
        proc = subprocess.run([nvcc, *_LINK_FLAGS, "-o", tmp, *objs], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
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
                _VP, _VP, _VP, _I,  # out, carry, carry offsets, rows per launch
                _I, _VP,  # device, stream
            ]
            handle.swt_lane_best_varlen_s16x2.restype = _I
            handle.swt_lane_best_varlen_s16x2.argtypes = [
                _VP, _I, _I,  # packed, rows, m
                _VP, _VP, _VP, _I,  # refs, offsets, lens, c
                _I, _I, _I,  # match, mismatch, gap
                _VP, _VP, _VP, _I,  # out, carry, carry offsets, rows per launch
                _I, _I, _VP,  # longest segment, device, stream
            ]
            handle.swt_argmax_lane.restype = _I
            handle.swt_argmax_lane.argtypes = [
                _VP, _I, _I,  # reads, r, m
                _VP, _LL, _I, _I,  # refs, ref_stride, c, n
                _I, _I, _I,  # match, mismatch, gap
                _VP, _VP, _VP, _VP, _I,  # best, bestd, count, carry, reads per launch
                _I, _VP,  # device, stream
            ]
            handle.swt_argmax_lane_s16x2.restype = _I
            handle.swt_argmax_lane_s16x2.argtypes = [
                _VP, _I, _I,  # reads, r, m
                _VP, _LL, _I, _I,  # refs, ref_stride, c, n
                _I, _I, _I,  # match, mismatch, gap
                _VP, _VP, _VP,  # best, bestd, count (or the segments' partials)
                _I, _I, _I, _I,  # segment stride, length, offset and count
                _VP, _LL, _I, _I,  # carry (reads wider than one pass), its elements and row length, reads per launch
                _I, _VP,  # device, stream
            ]
            handle.swt_argmax_merge.restype = _I
            handle.swt_argmax_merge.argtypes = [
                _VP, _VP, _VP, _I, _LL,  # partial best, bestd, count, segments, lanes
                _VP, _VP, _VP,  # best, bestd, count
                _I, _VP,  # device, stream
            ]
            handle.swt_band_lane_best.restype = _I
            handle.swt_band_lane_best.argtypes = [
                _VP, _I, _I,  # packed, rows, m
                _VP, _VP, _VP, _VP, _I,  # segs, offsets, seg_lens, ns, c
                _VP, _I, _I, _I,  # bnd, match, mismatch, gap
                _VP, _VP, _VP, _VP, _I,  # out, bnd_out, carry, carry offsets, rows per launch
                _I, _I, _VP, _I, _I,  # piece stride, look-back, pieces' prefix sum (or null), pieces, read lanes
                _I, _VP,  # device, stream
            ]
            handle.swt_band_lane_best_s16x2.restype = _I
            handle.swt_band_lane_best_s16x2.argtypes = handle.swt_band_lane_best.argtypes
            for grid, segments in ((handle.swt_score_grid_diag, []), (handle.swt_score_grid_diag_s16x2, []),
                                   (handle.swt_score_grid_row, [_I, _I]),
                                   (handle.swt_score_grid_row_s16x2, [_I, _I])):
                grid.restype = _I
                grid.argtypes = [
                    _VP, _I, _I,  # reads, r, m
                    _VP, _I, _I,  # refs, c, n
                    _I, _I, _I,  # match, mismatch, gap
                    _VP, _VP, _I,  # out, carry, reads per launch
                    *segments,  # K5: segment stride and length
                    _I, _VP,  # device, stream
                ]
            for listing in (handle.swt_max_cells_row, handle.swt_max_cells_row_s16x2):
                listing.restype = _I
                listing.argtypes = [
                    _VP, _I, _I,  # reads, r, m
                    _VP, _I,  # ref, n
                    _VP, _I, _I, _I,  # best, match, mismatch, gap
                    _VP, _VP, _LL,  # count, cells, capacity
                    _VP, _LL, _I,  # carry, its elements, reads per launch
                    _I, _I, _I,  # segment stride, length and skip
                    _I, _VP,  # device, stream
                ]
            handle.swt_max_cells_finish.restype = _I
            handle.swt_max_cells_finish.argtypes = [
                _VP, _I, _I, _I,  # best, r, m, n
                _VP, _VP, _LL,  # count, cells, capacity
                _VP, _I,  # scratch, keys per read
                _I, _VP,  # device, stream
            ]
            handle.swt_fill_dirs.restype = _I
            handle.swt_fill_dirs.argtypes = [
                _VP, _I, _I,  # reads, b, m
                _VP, _LL, _I,  # refs, ref_stride, n
                _I, _I, _I, _I,  # match, mismatch, gap, serial
                _VP, _VP, _VP,  # dirs, h (or null), carry
                _I, _VP,  # device, stream
            ]
            handle.swt_trace_walk.restype = _I
            handle.swt_trace_walk.argtypes = [
                _VP, _I, _I, _I,  # dirs, b, m, n
                _VP, _I, _I,  # cells, k, cap
                _VP, _VP,  # begins, codes
                _I, _VP,  # device, stream
            ]
            handle.swt_fill_list.restype = _I
            handle.swt_fill_list.argtypes = [
                _VP, _I, _I,  # reads, b, m
                _VP, _LL, _I,  # refs, ref_stride, n
                _I, _I, _I, _I,  # match, mismatch, gap, serial
                _I, _I, _VP, _LL,  # columns a lane, warps a pair, code scratch (or null), stride
                _I, _I,  # capacity, cap
                _VP, _VP, _VP, _VP, _VP,  # best, counts, cells, begins, codes
                _VP, _VP, _VP, _LL,  # lists, meta, sort scratch (or null), its keys a pair
                _I, _VP,  # device, stream
            ]
            handle.swt_fill_walk.restype = _I
            handle.swt_fill_walk.argtypes = [
                _VP, _I, _I,  # reads, b, m
                _VP, _LL, _I,  # refs, ref_stride, n
                _I, _I, _I, _I,  # match, mismatch, gap, serial
                _I, _I, _VP, _LL,  # columns a lane, warps a pair, code scratch (or null), stride
                _VP, _I,  # cells, cap
                _VP, _VP,  # begins, codes
                _I, _VP,  # device, stream
            ]
            handle.swt_fill_blocks_per_sm.restype = _I
            handle.swt_fill_blocks_per_sm.argtypes = [
                _I, _I, _I, _I,  # list, serial, m, n
                _I, _I, _I,  # columns a lane, warps a pair, capacity
                _I, ctypes.POINTER(_I),  # device, blocks (out)
            ]
            for chain in (handle.swt_step_chain_best, handle.swt_step_chain_best_s16x2):
                chain.restype = _I
                chain.argtypes = [
                    _VP, _I, _I,  # reads, rb, m
                    _I, _I,  # steps, unroll
                    _I, _I, _I, _I,  # match, mismatch, gap, masked
                    _VP, _I, _VP,  # out, device, stream
                ]
            for variants in (handle.swt_step_variant_best, handle.swt_step_variant_best_s16x2):
                variants.restype = _I
                variants.argtypes = [
                    _VP, _I, _I,  # packed, rows, m
                    _VP, _I, _I,  # refs, c, n
                    _I, _I,  # variant (0-4 = A-E), steps
                    _I, _I, _I,  # match, mismatch, gap
                    _VP, _I, _VP,  # out, device, stream
                ]
            _lib = handle
        return _lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        msg = lib().swt_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
