"""FASTA-ish parsing and sequence encoding, with the reference's line
semantics (the same contract as :mod:`sparksmithwaterman_tpu.io.fasta`).

- ``get_reads``: every line of a reads file is one read, ``strip()``-ed;
  the first line is skipped only if it is metadata.
- ``get_ref_seqs``: a metadata line starts a (metadata, sequence) record;
  sequence lines are concatenated untrimmed.  Parsed in C
  (``csrc/fasta.c`` through :mod:`sparksmithwaterman_tpu_torch._native`),
  or in Python when ``USE_NATIVE_PARSER`` is False.
- Encoding upper-cases, so base comparison is case-insensitive.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from sparksmithwaterman_tpu_torch import _native

# Padding codes below any printable ASCII, so a padded position never
# equals a real base or the other pad code.
READ_PAD = 0
REF_PAD = 1


def is_metadata(line: str, delimiter: str) -> bool:
    """Prefix-match metadata test."""
    return line.startswith(delimiter)


def get_reads(path: str | os.PathLike, delimiter: str) -> List[str]:
    """All reads of an input file, one read per line."""
    with open(path, "r") as f:
        lines = f.read().splitlines()
    if not lines:
        raise ValueError(f"Input file is empty: {path}")
    reads: List[str] = []
    first = lines[0].strip()
    if not is_metadata(first, delimiter):
        reads.append(first)
    for line in lines[1:]:
        reads.append(line.strip())
    return reads


# Set False to force the pure-Python parser (parity tests, debugging).
USE_NATIVE_PARSER = True


def get_ref_seqs(path: str | os.PathLike, delimiter: str) -> List[Tuple[str, str]]:
    """(metadata, sequence) records of a reference file.

    Parsed by ``csrc/fasta.c`` unless ``USE_NATIVE_PARSER`` is False; both
    parsers give the same records and raise ValueError for an empty file
    or one that does not start with metadata.  Unlike the JAX package,
    a C parser that fails to build or load raises here and does not fall
    back to the Python parser, so a broken build cannot pass unseen.
    """
    if USE_NATIVE_PARSER:
        return _native.parse_ref(path, delimiter)
    return _get_ref_seqs_py(path, delimiter)


def _get_ref_seqs_py(path: str | os.PathLike, delimiter: str) -> List[Tuple[str, str]]:
    sequences: List[Tuple[str, str]] = []
    meta = None
    chunks: List[str] = []
    with open(path, "r") as f:
        for raw in f.read().splitlines():
            if is_metadata(raw, delimiter):
                if meta is not None:
                    sequences.append((meta, "".join(chunks)))
                meta = raw
                chunks = []
            else:
                if meta is None:
                    raise ValueError(
                        f"Reference file does not start with metadata (delimiter {delimiter!r}): {path}"
                    )
                chunks.append(raw)
    if meta is None:
        raise ValueError(f"Reference file has no metadata lines: {path}")
    sequences.append((meta, "".join(chunks)))
    return sequences


def encode_seq(seq: str) -> np.ndarray:
    """Upper-cased ASCII codes of a sequence (uint8)."""
    return np.frombuffer(seq.upper().encode("latin-1"), dtype=np.uint8).copy()


def decode_seq(codes: np.ndarray) -> str:
    """The string of a code array (latin-1)."""
    return codes.tobytes().decode("latin-1")


def encode_concat(seqs: List[str]) -> Tuple[np.ndarray, np.ndarray]:
    """(flat, lens): the sequences' codes back to back in one writable
    uint8 array, and each one's length there (int64)."""
    blob = "".join(seqs)
    if blob.isascii():
        lens = np.fromiter(map(len, seqs), np.int64, count=len(seqs))
        return np.frombuffer(bytearray(blob.encode("ascii").upper()), np.uint8), lens
    encs = [encode_seq(s) for s in seqs]
    return np.concatenate(encs), np.array([e.size for e in encs], np.int64)


def encode_batch(seqs: List[str], pad_to: int, pad_value: int) -> np.ndarray:
    """Encode sequences into a (len(seqs), pad_to) uint8 array.

    One join, one ``bytes.upper`` and one scatter over the whole batch;
    non-ASCII content takes the exact per-sequence ``str.upper`` path.
    """
    out = np.full((len(seqs), pad_to), pad_value, dtype=np.uint8)
    if not seqs:
        return out
    blob = "".join(seqs)
    if not blob.isascii():
        for i, s in enumerate(seqs):
            enc = encode_seq(s)
            if enc.size > pad_to:
                raise ValueError(f"sequence length {enc.size} exceeds pad_to={pad_to}")
            out[i, : enc.size] = enc
        return out
    lens = np.fromiter((len(s) for s in seqs), np.int64, count=len(seqs))
    max_len = int(lens.max())
    if max_len > pad_to:
        raise ValueError(f"sequence length {max_len} exceeds pad_to={pad_to}")
    flat = np.frombuffer(blob.encode("latin-1").upper(), dtype=np.uint8)
    row = np.repeat(np.arange(len(seqs)), lens)
    starts = np.concatenate(([0], np.cumsum(lens)[:-1]))
    col = np.arange(flat.size) - np.repeat(starts, lens)
    out[row, col] = flat
    return out
