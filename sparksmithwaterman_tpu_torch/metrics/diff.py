"""Control-vs-treatment diff of two strategies (``swtorch diff``).

Port of :mod:`sparksmithwaterman_tpu.metrics.diff`: run two strategies
on the same input and reference directories, each into its own output
directory (the reference's parallel control outputs), and compare the
reports pairwise apart from the time line (``Execution Time = N ms``,
the only content that may differ): the winner set, its order, the
alignment strings and the site indices must match byte for byte.
"""

from __future__ import annotations

import dataclasses
import difflib
import os
import re
from typing import Dict, List, Tuple

from sparksmithwaterman_tpu_torch.config import AlignConfig
from sparksmithwaterman_tpu_torch.models.pipeline import run_pipeline

_TIMING_RE = re.compile(r"Execution Time = \d+ ms")


def _normalize(text: str) -> str:
    return _TIMING_RE.sub("Execution Time = <t> ms", text)


def diff_strategies(
    config: AlignConfig,
    strategy_a: str,
    strategy_b: str,
    out_dir: str,
    device="cuda",
) -> Tuple[bool, List[Dict[str, object]]]:
    """Run two strategies on ``device`` on the same data and diff their reports.

    Writes the reports under ``out_dir/<strategy_a>/`` and
    ``out_dir/<strategy_b>/``.  Returns (all_equal, rows), each row
    ``{"file", "equal", "diff"}`` with ``diff`` a unified diff of the
    normalised reports where they diverge (empty where equal).  Raises
    ``RuntimeError`` when the strategies wrote different numbers of
    reports.
    """
    paths: Dict[str, List[str]] = {}
    for strategy in (strategy_a, strategy_b):
        cfg = dataclasses.replace(config, strategy=strategy, out_dir=os.path.join(out_dir, strategy))
        paths[strategy] = run_pipeline(cfg, device=device)

    rows: List[Dict[str, object]] = []
    all_equal = True
    pa, pb = paths[strategy_a], paths[strategy_b]
    if len(pa) != len(pb):
        raise RuntimeError(f"strategy outputs differ in count: {len(pa)} vs {len(pb)}")
    for a_path, b_path in zip(pa, pb):
        with open(a_path) as f:
            a_text = _normalize(f.read())
        with open(b_path) as f:
            b_text = _normalize(f.read())
        equal = a_text == b_text
        diff = ""
        if not equal:
            all_equal = False
            diff = "".join(
                difflib.unified_diff(
                    a_text.splitlines(keepends=True),
                    b_text.splitlines(keepends=True),
                    fromfile=f"{strategy_a}/{os.path.basename(a_path)}",
                    tofile=f"{strategy_b}/{os.path.basename(b_path)}",
                )
            )
        rows.append({"file": os.path.basename(a_path), "equal": equal, "diff": diff})
    return all_equal, rows
