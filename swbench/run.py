"""One run of one cell of the port's benchmark.

    python3 swbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cell, its configuration and its traffic
mix are found by name (``swbench.spec``).  Set-up makes the reference tree
and the first input file from the seed under ``TMPDIR`` (deleted at exit),
builds or loads the kernel library under ``build/`` in the checkout, gets
the backend once from ``models.aligner.get_backend`` and runs that file to
warm up; then it makes the pool of input files that no window can
outlast while the cards run K1 under its bound (:func:`pool_size`).  The window is a closed loop with
one client: it calls ``models.pipeline.run_pipeline`` on one input file
after another for ``--seconds``; a file that ends after that counts
neither cells nor seconds.  Then the reference checks a sample of the
window's reports (``swbench.check``).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (with ``--trace 1``
also ``breakdown``), and last ``checks``, each number compared beside its
limit (``check_parts`` before it holds their parts); the same numbers end
standard error.  With ``--trace 0`` the
metrics are the cell's end-to-end ones (each named by its quantity,
``real_gcups`` or ``setup_s``, and a suffix after a dot where a group of
cells has a bound of its own), with ``--trace 1`` its per-layer ones, each
read by ``swbench/layers/<name>.py``.  A run that lacks one of its
metrics is incorrect (:func:`unread`), but for a per-layer metric whose
reader says the program has nothing of its kind (``spec.ABSENT``), and
for per-layer metrics in a run without a card (tests).  Without CUDA, or with fewer cards than
the cell asks for, the run prints no result and exits 2; with JAX or the
JAX package loaded once the window has closed, it exits 3; where the pool
of input files runs out before the window's end, it exits 4.
"""

from __future__ import annotations

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from swbench import check, gen, spec  # noqa: E402
from swbench import trace as tracing  # noqa: E402

# Top-level module names that no run may hold once its window has closed.
FORBIDDEN = ("jax", "jaxlib", "flax", "sparksmithwaterman_tpu")
# Host spans of the breakdown besides those the readers declare.
BREAKDOWN_SPANS = {
    "report": ["sparksmithwaterman_tpu_torch.models.pipeline:build_report",
               "sparksmithwaterman_tpu_torch.models.pipeline:write_str_to_file"],
}


class PoolExhausted(RuntimeError):
    """The window outlasted the pool of input files: no result."""


def pool_size(seconds: float, least_file_s: float) -> int:
    """Input files for a window of ``seconds``: as many as files of
    ``least_file_s`` fill it, and three more.

    On the card ``least_file_s`` is the least time of a file's real cells
    at K1's bound on all the cell's cards (:func:`swbench.kernels.bound_ms`):
    a run that used them up would read ``k1_roofline`` over 100%.  The
    pool is the same for every run of a cell, whatever its set-up took."""
    return int(math.ceil(seconds / max(least_file_s, 1e-3))) + 3


def least_file_s(cells: int, card: dict, chips: int, warm_s: float) -> float:
    """The least seconds of one input file: its ``cells`` at K1's bound on
    ``chips`` cards of ``card``'s peaks; without a card (tests), half the
    warm-up file's time."""
    if not card:
        return warm_s / 2.0
    from swbench import kernels

    return kernels.bound_ms(cells, 0, card["sms"] * chips, card["max_sm_clock_mhz"])[0] / 1e3


def forbidden_modules() -> list:
    """Forbidden top-level names in ``sys.modules``, compared whole."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def _align_config(cfg: dict, tmp: str):
    from sparksmithwaterman_tpu_torch.config import AlignConfig, ScoringScheme

    fields = dict(cfg["align"])
    fields["scoring"] = ScoringScheme(**fields["scoring"])
    return AlignConfig(ref_dir=os.path.join(tmp, "refs"), in_dir=os.path.join(tmp, "in"),
                       out_dir=os.path.join(tmp, "out"), delimiter=gen.DELIMITER, **fields)


def _install(tr: tracing.Trace, readers: dict, device_type: str) -> None:
    """Wrap the spans the readers declare, and bracket every launching C
    entry: the breakdown and ``busy_s`` read them all."""
    spans = {name: (targets, None) for name, targets in BREAKDOWN_SPANS.items()}
    for mod in readers.values():
        for name, targets in getattr(mod, "SPANS", {}).items():
            spans[name] = (targets, getattr(mod, "SPAN_VALUES", {}).get(name))
    for name, (targets, value) in spans.items():
        for target in targets:
            tr.span(name, target, value)
    if device_type == "cuda":
        from sparksmithwaterman_tpu_torch.ops import _cuda

        tr.bracket(_cuda.lib(), tracing.launch_entries(_cuda.lib()))


def _breakdown(tr: tracing.Trace) -> dict:
    ops: dict = {}
    for x in tr.launches_of():
        ops[x.entry] = ops.get(x.entry, 0.0) + x.ms / 1e3
    gaps = sorted(tr.gaps(), key=lambda g: -g[1])[:10]
    return {"device_ops": sorted(([k, v] for k, v in ops.items()), key=lambda e: -e[1])[:10],
            "idle_gaps": [[label, s] for label, s in gaps]}


def unread(units: dict, values: dict, absent: set, trace: bool, card: bool) -> list:
    """The cell's metrics that a correct run reads and this one did not:
    untraced, every end-to-end one; traced on a card, every per-layer one
    but those ``absent`` from the program; traced on the CPU, none, since
    the card's readers read nothing there."""
    if trace and not card:
        return []
    return [name for name in units if name not in values and name not in absent]


def run_cell(workload: str, seed: int, seconds: float, trace: bool = False, device: str = "cuda",
             root: str = spec.ROOT, t_start: float = None, patch=None, log=None) -> dict:
    """One run of ``workload``; returns the result line as a dict.

    ``device="cpu"`` runs the port's plain versions (tests); ``patch``, a
    context manager, is entered before the backend is made and left after
    the window (the control and the planted faults)."""
    import torch

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    t_start = time.perf_counter() if t_start is None else t_start
    bench = spec.load(root)
    entry = spec.cell(bench, workload)
    cfg = spec.config(bench, entry, root)
    mix = spec.traffic(entry, root)
    chips = int(entry["chips"])
    devices = [torch.device("cuda", i) for i in range(chips)] if device == "cuda" else [torch.device(device)]
    readers = {m["name"]: spec.reader(m["name"]) for m in spec.metrics(bench, entry, True)} if trace else {}

    from sparksmithwaterman_tpu_torch.models.aligner import get_backend
    from sparksmithwaterman_tpu_torch.models.pipeline import run_pipeline

    tr = tracing.Trace() if trace else None
    card = {}
    if device == "cuda":
        from sparksmithwaterman_tpu_torch.ops import _cuda

        from swbench import kernels

        _cuda.lib()
        sms, clock = kernels.card_peaks(0)
        card = {"sms": sms, "max_sm_clock_mhz": clock, "power_limit": kernels.card_power_limit(0)}
        if tr:
            tr.sms, tr.clock_mhz, tr.cards = sms, clock, chips
    tmp = tempfile.mkdtemp(prefix="swbench-")
    try:
        corpus = gen.make_corpus(cfg, seed, os.path.join(tmp, "refs"))
        in_dir = os.path.join(tmp, "in")
        files = gen.make_reads_files(corpus, mix, seed, in_dir, 0, 1)
        total_ref_bp = int(corpus.lens.sum())
        base = _align_config(cfg, tmp)

        def job(k: int):
            return dataclasses.replace(base, in_dir=files[k].path, out_dir=os.path.join(tmp, "out", str(k)))

        with patch if patch is not None else contextlib.nullcontext():
            backend = get_backend(base, device)
            mesh = getattr(backend, "mesh", None)
            if device == "cuda" and mesh is not None and mesh.size != len(devices):
                raise RuntimeError(f"the backend's mesh holds {mesh.size} entries, the cell {len(devices)} cards")
            if tr:
                _install(tr, readers, devices[0].type)
            # Warm-up: one file, and a traceback of each branch (the
            # longest reference takes the windowed one, a median one the
            # full fill), since a window's winner may take either.
            t_warm = time.perf_counter()
            run_pipeline(job(0), backend=backend, device=device)
            warm_s = time.perf_counter() - t_warm
            least_s = least_file_s(files[0].read_bp * total_ref_bp, card, chips, warm_s)
            files += gen.make_reads_files(corpus, mix, seed, in_dir, 1, pool_size(seconds, least_s))
            by_len = sorted(range(len(corpus.lens)), key=lambda k: int(corpus.lens[k]))
            for k in (by_len[-1], by_len[len(by_len) // 2]):
                backend.sites_for_ref(corpus.text(k), files[0].texts)
            for d in devices:
                if d.type == "cuda":
                    torch.cuda.synchronize(d)
            if tr:
                tr.reset()
            setup_s = time.perf_counter() - t_start
            log(f"set-up {setup_s:.3f} s: {len(corpus.lens)} references, {total_ref_bp} bp in {len(corpus.files)} "
                f"files; warm-up file {warm_s:.3f} s, {len(files) - 1} input files of {mix['reads_per_file']} reads")

            reports = {}
            error = None
            t0 = time.perf_counter()
            deadline = t0 + seconds
            t_last = t0
            file_s = []
            k = 1
            while k < len(files) and time.perf_counter() < deadline:
                try:
                    with tr.open("file") if tr else contextlib.nullcontext():
                        paths = run_pipeline(job(k), backend=backend, device=device)
                except Exception as exc:  # a failure of the system under test: reported, not raised
                    error = f"{type(exc).__name__}: {exc}"
                    log(f"input file {k} failed: {error}")
                    break
                t = time.perf_counter()
                if t > deadline:
                    break
                reports[k] = paths[0] if paths else None
                file_s.append(t - t_last)
                t_last = t
                k += 1
            if k >= len(files) and error is None:
                raise PoolExhausted(f"the pool of {len(files) - 1} input files ran out before the window's end")
            counted = sorted(reports)
            window_s = t_last - t0
            peak = max(torch.cuda.max_memory_allocated(d) for d in devices) if device == "cuda" else 0
            if tr:
                tr.close(t0, t_last, [d for d in devices if d.type == "cuda"])
        cells = sum(files[k].read_bp for k in counted) * total_ref_bp
        log(f"window {window_s:.3f} s: {len(counted)} input files, {cells} real cells; seconds a file "
            f"{' '.join(f'{x:.3f}' for x in file_s)}")

        result = {"correct": False, "attempted": len(counted) + int(error is not None), "failed": int(error is not None)}
        values, absent = {}, set()
        if trace:
            tr.remove()
            for name, mod in readers.items():
                value = mod.read(tr)
                if value is spec.ABSENT:
                    absent.add(name)
                elif value is not None:
                    values[name] = value
            for note in tr.notes:
                log(note)
        units = {m["name"]: m["unit"] for m in spec.metrics(bench, entry, trace)}
        if not trace:
            for name in units:
                quantity = name.split(".")[0]
                if quantity == "real_gcups" and window_s > 0 and cells > 0:
                    values[name] = cells / window_s / 1e9
                elif quantity == "setup_s":
                    values[name] = setup_s
        result["metrics"] = {name: {"value": values[name], "unit": unit} for name, unit in units.items()
                             if name in values}
        result["device"] = {
            "platform": "gpu" if device == "cuda" else device,
            "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
            "count": len(devices),
            "memory_peak_bytes": int(peak),
        }
        if trace:
            busy = sum(x.ms for x in tr.launches_of()) / 1e3 / len(devices)
            result["device"].update(busy_s=busy, window_s=tr.window_s)
            result["breakdown"] = _breakdown(tr)
            spans = {}
            for name, a, b, _ in tr.spans:
                if a < tr.window[1] and b > tr.window[0]:
                    spans[name] = spans.get(name, 0.0) + min(b, tr.window[1]) - max(a, tr.window[0])
            result["host_spans"] = sorted(([k, v] for k, v in spans.items()), key=lambda e: -e[1])
        result["window"] = {"seconds": window_s, "files": len(counted), "real_cells": cells}
        if card:
            result["card"] = card

        # The comparison, once the program's state is freed.
        del backend
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        numbers = check.check(corpus, [files[k] for k in counted], [reports[k] for k in counted], cfg, seed,
                              devices[0], log=log)
        log(f"check {time.perf_counter() - t_check:.3f} s over {numbers['files_checked']} input files")
        checks = {name: {"value": numbers[name], "limit": limit} for name, limit in check.LIMITS.items()}
        result["check_parts"] = {k: numbers[k] for k in check.PARTS + ("winner_total_gap", "files_checked")}
        log("check parts: " + ", ".join(f"{k} {v}" for k, v in result["check_parts"].items()))
        result["failed"] += numbers["bad_files"]
        missing = unread(units, values, absent, trace, device == "cuda")
        if missing or absent:
            log(f"metrics not read: {', '.join(missing) or 'none'}; absent from the program: "
                f"{', '.join(sorted(absent)) or 'none'}")
        result["correct"] = (error is None and bool(counted) and not missing
                             and all(c["value"] <= c["limit"] for c in checks.values()))
        result["checks"] = checks
        return result
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="One run of one cell of the port's benchmark.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    entry = spec.cell(spec.load(), args.workload)
    if not torch.cuda.is_available():
        print("swbench: CUDA is not available; no result", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(entry["chips"]):
        print(f"swbench: {args.workload} needs {entry['chips']} cards, {torch.cuda.device_count()} visible; no result",
              file=sys.stderr)
        return 2
    try:
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", t_start=_T_START)
    except PoolExhausted as exc:
        print(f"swbench: {exc}; no result", file=sys.stderr)
        return 4
    found = forbidden_modules()
    if found:
        print(f"swbench: loaded in this process: {', '.join(found)}; no result", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
