"""ctypes loader for the repo's native host helpers (``csrc/*.c``).

Builds ``csrc/traceback.c`` (the batched traceback walk) and
``csrc/fasta.c`` (the reference-file parser) with ``cc`` into
``build/native/``, keyed by a hash of the sources, and binds both.  The
JAX package has its own loader (``sparksmithwaterman_tpu/ops/_native.py``)
but importing it loads JAX, so the port keeps this one; the C sources
are shared and not modified.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import List, Tuple

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_ROOT, "csrc")
_BUILD = os.path.join(_ROOT, "build", "native")
_SOURCES = ("traceback.c", "fasta.c")
_FLAGS = ["-O3", "-fPIC", "-shared", "-Wall"]

_lock = threading.Lock()
_lib = None

# Error codes of swtpu_parse_ref (csrc/fasta.c).
_PARSE_ERRORS = {1: "cannot open file", 2: "file is empty", 3: "no leading metadata line", 4: "out of memory"}


def _build() -> str:
    srcs = [os.path.join(_CSRC, s) for s in _SOURCES]
    digest = hashlib.sha256(" ".join(_FLAGS).encode())
    for path in srcs:
        with open(path, "rb") as f:
            digest.update(f.read())
    out = os.path.join(_BUILD, f"libswtpu-{digest.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(_BUILD, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
    os.close(fd)
    try:
        subprocess.run(["cc", *_FLAGS, "-o", tmp, *srcs], check=True, capture_output=True)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def load() -> ctypes.CDLL:
    """The native helper library, built on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(_build())
        lib.sw_traceback_batch.restype = None
        lib.sw_traceback_batch.argtypes = [
            ctypes.POINTER(ctypes.c_int8),  # dirs
            ctypes.c_int32,  # m
            ctypes.c_int32,  # n
            ctypes.POINTER(ctypes.c_int32),  # cells
            ctypes.c_int32,  # k
            ctypes.c_char_p,  # ref
            ctypes.c_char_p,  # read
            ctypes.c_char,  # gap
            ctypes.POINTER(ctypes.c_char),  # ref_out
            ctypes.POINTER(ctypes.c_char),  # read_out
            ctypes.POINTER(ctypes.c_int32),  # lens
            ctypes.POINTER(ctypes.c_int32),  # begins
        ]
        lib.swtpu_parse_ref.restype = ctypes.c_int
        lib.swtpu_parse_ref.argtypes = [
            ctypes.c_char_p,  # path
            ctypes.c_char_p,  # delim
            ctypes.POINTER(ctypes.POINTER(ctypes.c_char)),  # seq_blob
            ctypes.POINTER(ctypes.POINTER(ctypes.c_longlong)),  # seq_off
            ctypes.POINTER(ctypes.POINTER(ctypes.c_char)),  # meta_blob
            ctypes.POINTER(ctypes.POINTER(ctypes.c_longlong)),  # meta_off
            ctypes.POINTER(ctypes.c_longlong),  # n
        ]
        lib.swtpu_free.restype = None
        lib.swtpu_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def traceback_batch(
    dirs: np.ndarray,
    cells: np.ndarray,
    ref_seq: str,
    read_seq: str,
    gap_char: str = "_",
) -> List[Tuple[int, Tuple[str, str]]]:
    """Walk every start cell of one pair over its (m, n) direction codes;
    the contract of ``ops.traceback.sites_from_fill``'s per-cell walk."""
    lib = load()
    m, n = len(read_seq), len(ref_seq)
    dirs_c = np.ascontiguousarray(dirs[:m, :n], dtype=np.int8)
    cells_c = np.ascontiguousarray(cells, dtype=np.int32)
    k = cells_c.shape[0]
    cap = m + n
    ref_out = np.empty((k, cap), dtype=np.uint8)
    read_out = np.empty((k, cap), dtype=np.uint8)
    lens = np.empty(k, dtype=np.int32)
    begins = np.empty(k, dtype=np.int32)
    lib.sw_traceback_batch(
        dirs_c.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        np.int32(m),
        np.int32(n),
        cells_c.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        np.int32(k),
        ref_seq.encode(),
        read_seq.encode(),
        gap_char.encode(),
        ref_out.ctypes.data_as(ctypes.POINTER(ctypes.c_char)),
        read_out.ctypes.data_as(ctypes.POINTER(ctypes.c_char)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        begins.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    sites = []
    for t in range(k):
        length = int(lens[t])
        sites.append(
            (
                int(begins[t]),
                (
                    ref_out[t, cap - length :].tobytes().decode(),
                    read_out[t, cap - length :].tobytes().decode(),
                ),
            )
        )
    return sites


def parse_ref(path: str | os.PathLike, delimiter: str) -> List[Tuple[str, str]]:
    """(metadata, sequence) records of a reference file, parsed in C with
    the line semantics of ``io.fasta.get_ref_seqs``.

    Raises ValueError for an empty file or one that does not start with
    metadata (the Python parser's contract), RuntimeError otherwise.
    """
    lib = load()
    seq_blob = ctypes.POINTER(ctypes.c_char)()
    seq_off = ctypes.POINTER(ctypes.c_longlong)()
    meta_blob = ctypes.POINTER(ctypes.c_char)()
    meta_off = ctypes.POINTER(ctypes.c_longlong)()
    n = ctypes.c_longlong(0)
    rc = lib.swtpu_parse_ref(
        str(path).encode(),
        delimiter.encode(),
        ctypes.byref(seq_blob),
        ctypes.byref(seq_off),
        ctypes.byref(meta_blob),
        ctypes.byref(meta_off),
        ctypes.byref(n),
    )
    if rc == 2:
        raise ValueError(f"Reference file is empty: {path}")
    if rc == 3:
        raise ValueError(
            f"Reference file does not start with metadata (delimiter {delimiter!r}): {path}"
        )
    if rc != 0:
        raise RuntimeError(f"native FASTA parse failed ({_PARSE_ERRORS.get(rc, rc)}): {path}")
    try:
        count = n.value
        soff = np.ctypeslib.as_array(seq_off, shape=(count + 1,)).tolist()
        moff = np.ctypeslib.as_array(meta_off, shape=(count + 1,)).tolist()
        seqs = ctypes.string_at(seq_blob, soff[count]).decode("latin-1")
        metas = ctypes.string_at(meta_blob, moff[count]).decode("latin-1")
        return [
            (metas[moff[i] : moff[i + 1]], seqs[soff[i] : soff[i + 1]])
            for i in range(count)
        ]
    finally:
        lib.swtpu_free(seq_blob)
        lib.swtpu_free(seq_off)
        lib.swtpu_free(meta_blob)
        lib.swtpu_free(meta_off)
