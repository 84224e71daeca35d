"""Recursive directory iteration: every regular file under a root, each
directory's entries in name order, depth first."""

from __future__ import annotations

import os
from typing import Iterator


def iter_files(root: str | os.PathLike) -> Iterator[str]:
    """Yield every file under ``root`` in sorted depth-first order."""
    root = os.fspath(root)
    if not os.path.exists(root):
        raise FileNotFoundError(f"Root directory not found: {root}")
    if os.path.isfile(root):
        yield root
        return
    for entry in sorted(os.listdir(root)):
        path = os.path.join(root, entry)
        if os.path.isdir(path):
            yield from iter_files(path)
        else:
            yield path
