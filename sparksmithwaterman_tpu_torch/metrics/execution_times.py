"""Execution-time sweeps (``swtorch bench``).

Port of :mod:`sparksmithwaterman_tpu.metrics.execution_times` (the
reference's three ``ExecutionTimes*`` harnesses, the strategy a
parameter), on the tree :func:`..engineer_data.generate` writes:

1. **read_num** — in ``input/readNum``, refs ``testRef/in``;
2. **read_len** — in ``input/readLen``, refs ``testRef/in``;
3. **ref_num**  — in ``input/ref``, refs each ``testRef/refNum/refK``;
4. **ref_len**  — in ``input/ref``, refs each ``testRef/refLen/refK``.

Every run writes the standard report (its time line read back as the
case's ``ms``) under ``out_dir/<strategy>/``, and each sweep a
``<sweep>_summary.json`` of its ``{case, ms}`` rows.  One backend per
sweep, on ``device``, serves all of the sweep's runs.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Sequence

from sparksmithwaterman_tpu_torch.config import AlignConfig
from sparksmithwaterman_tpu_torch.models.aligner import get_backend
from sparksmithwaterman_tpu_torch.models.pipeline import run_pipeline

_TIME_RE = re.compile(r"Execution Time = (\d+) ms")


def _exec_times(report_paths: Sequence[str]) -> List[int]:
    times = []
    for path in report_paths:
        with open(path) as f:
            m = _TIME_RE.search(f.read())
        times.append(int(m.group(1)) if m else -1)
    return times


def _subdirs(parent: str) -> List[str]:
    return [full for name in sorted(os.listdir(parent)) if os.path.isdir(full := os.path.join(parent, name))]


def run_sweeps(
    data_dir: str,
    out_dir: str,
    strategy: str = "batch",
    sweeps: Sequence[str] = ("read_num", "read_len", "ref_num", "ref_len"),
    device="cuda",
) -> Dict[str, List[dict]]:
    """Run the requested sweeps on ``device``; returns {sweep: [{case, ms}, ...]}."""
    results: Dict[str, List[dict]] = {}

    def config(ref_dir: str, in_dir: str, sub_out: str, out_name: str = "result") -> AlignConfig:
        return AlignConfig(
            ref_dir=ref_dir,
            in_dir=in_dir,
            out_dir=os.path.join(out_dir, strategy, sub_out),
            out_name=out_name,
            strategy=strategy,
        )

    # Sweeps 1 and 2: one run over a directory of input files, each file a case.
    for sweep, in_sub in (("read_num", "readNum"), ("read_len", "readLen")):
        if sweep not in sweeps:
            continue
        cfg = config(os.path.join(data_dir, "testRef", "in"), os.path.join(data_dir, "input", in_sub), in_sub)
        paths = run_pipeline(cfg, backend=get_backend(cfg, device))
        results[sweep] = [{"case": os.path.basename(p), "ms": ms} for p, ms in zip(paths, _exec_times(paths))]

    # Sweeps 3 and 4: one run per reference subdirectory.
    for sweep, ref_sub in (("ref_num", "refNum"), ("ref_len", "refLen")):
        if sweep not in sweeps:
            continue
        rows = []
        backend = None
        for k, ref_dir in enumerate(_subdirs(os.path.join(data_dir, "testRef", ref_sub)), start=1):
            cfg = config(ref_dir, os.path.join(data_dir, "input", "ref"), ref_sub, out_name=f"result{k}_")
            if backend is None:
                backend = get_backend(cfg, device)
            paths = run_pipeline(cfg, backend=backend)
            for p, ms in zip(paths, _exec_times(paths)):
                rows.append({"case": f"{os.path.basename(ref_dir)}/{os.path.basename(p)}", "ms": ms})
        results[sweep] = rows

    for sweep, rows in results.items():
        summary = os.path.join(out_dir, strategy, f"{sweep}_summary.json")
        os.makedirs(os.path.dirname(summary), exist_ok=True)
        with open(summary, "w") as f:
            json.dump(rows, f, indent=1)
    return results
