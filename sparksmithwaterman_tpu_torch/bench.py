"""Headline benchmark of the port on one NVIDIA card.

    python -m sparksmithwaterman_tpu_torch.bench [--device cuda]

The legs of the JAX package's ``bench.py``, each a function whose keyword
defaults are that bench's sizes:

- ``kernel`` (:func:`bench_kernel`): 512 reads of 128 bp x 64 refs of
  2,048 bp through K4 ``score_grid_diag``, padded GCUPS;
- ``e2e`` (:func:`bench_e2e`, the headline ``value``):
  ``TorchBatchBackend.totals`` on 512 reads of 80-150 bp x 256 refs of
  500-4,000 bp, real GCUPS (K1);
- ``pipeline``, ``corpus``, ``readscale`` (:func:`bench_pipeline`):
  ``run_pipeline`` over a generated corpus of 64 Mbp x 512 reads, 256 Mbp
  x 512 reads and 8 Mbp x 20,000 reads;
- ``longref`` (:func:`bench_longref`): 64 reads x 8 refs of 131,072 bp,
  sustained over ``best_of_async``, one ``totals`` call at a time, and the
  warm traceback of the winner in ms (K1, K2);
- ``roofline`` (:func:`bench_roofline`): the step chain of K6,
  ``ops.microbench.step_roofline``, at the kernel leg's read width (128
  lanes), every row restarting at lane 0 as each read does, in the form
  K4 takes on the kernel leg, on :func:`roofline_rows` rows (enough to
  fill the card).

Each rate is the median of ``repeats`` passes (default :data:`REPEATS`),
and each leg's ``*_spread`` lists every pass, sorted.  Then the parity
spot-checks against the serial oracle (a 2 x 2 corner of the kernel grid,
two e2e totals) and :func:`run_smoke`, every kernel of the port against
its plain version at small shapes.

It prints one JSON line with the keys of the JAX bench's line
(``BENCH_r05.json``), except that ``kernel_pct_vpu_sol`` is
``kernel_pct_roofline`` (the kernel's step rate over the step-chain
rate), ``card`` names the card and its power limit, and every leg has a
``*_spread``.  There are no floors: ``"thresholds": "none"``.  Exit code
0 when the parity checks and the smoke pass, non-zero otherwise, and 2
when ``--device cuda`` finds no card.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from sparksmithwaterman_tpu_torch.config import AlignConfig, ScoringScheme
from sparksmithwaterman_tpu_torch.core import oracle
from sparksmithwaterman_tpu_torch.io.fasta import READ_PAD, REF_PAD, encode_batch, encode_concat
from sparksmithwaterman_tpu_torch.metrics.engineer_data import reads_file, refseq_like
from sparksmithwaterman_tpu_torch.models.batch_backend import TorchBatchBackend
from sparksmithwaterman_tpu_torch.models.pipeline import run_pipeline
from sparksmithwaterman_tpu_torch.ops import cuda_score
from sparksmithwaterman_tpu_torch.ops.microbench import seconds_per_call, step_roofline
from sparksmithwaterman_tpu_torch.ops.packing import pack_reads, read_best
from sparksmithwaterman_tpu_torch.ops.recurrence import score_grid

PARAMS = (5, -3, -4)
# The roofline leg's rows: 2 rows a warp x 4 schedulers x SMs x this many
# warps a scheduler (:func:`roofline_rows`; the smallest w of 1-32 that no
# larger w beats in K6's rate by more than 5%, PERF.md; chip_smoke.py [11]
# fails otherwise), and its steps a call (a call of 10 ms or more there).
ROOFLINE_WARPS = 8
ROOFLINE_STEPS = 81_920
# Measurement passes per leg; the line reports their median.
REPEATS = 3
# The keys of the JSON line, in order.
KEYS = (
    "metric", "value", "unit", "vs_baseline", "kernel_gcups", "pipeline_gcups", "longref_gcups",
    "longref_single_gcups", "corpus_gcups", "readscale_gcups", "longref_traceback_ms", "roofline_gcups",
    "kernel_pct_roofline", "kernel_vs_e2e", "kernel_spread", "e2e_spread", "pipeline_spread", "corpus_spread",
    "readscale_spread", "longref_spread", "longref_single_spread", "longref_traceback_spread", "roofline_spread",
    "thresholds", "smoke", "threshold_detail", "env_suspect", "card",
)

_BASES = np.array(list("ACGT"))


def _seqs(rng, lens):
    return ["".join(rng.choice(_BASES, size=int(n))) for n in lens]


def _mixed_workload(rng, n_reads=512, n_refs=256):
    """The JAX bench's mixed workload: reads of 80-150 bp, refs of
    500-4,000 bp."""
    reads = _seqs(rng, rng.integers(80, 151, size=n_reads))
    refs = _seqs(rng, rng.integers(500, 4000, size=n_refs))
    return reads, refs


def _scoring(params) -> ScoringScheme:
    return ScoringScheme(match=int(params[0]), mismatch=int(params[1]), gap=int(params[2]))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _median(fn, repeats):
    """(median, every value sorted) of ``repeats`` calls of fn."""
    values = sorted(fn() for _ in range(repeats))
    return values[len(values) // 2], values


def bench_kernel(params=PARAMS, *, n_reads=512, read_len=128, n_refs=64, ref_len=2048, iters=20,
                 repeats=REPEATS, device="cuda"):
    """Uniform-batch wavefront rate through K4: (median padded GCUPS,
    spread, (reads, refs, (R, C) grid))."""
    rng = np.random.default_rng(0)
    reads = _seqs(rng, [read_len] * n_reads)
    refs = _seqs(rng, [ref_len] * n_refs)
    reads_t = torch.from_numpy(encode_batch(reads, read_len, READ_PAD)).to(device)
    refs_t = torch.from_numpy(encode_batch(refs, ref_len, REF_PAD)).to(device)
    grid = cuda_score.score_grid_diag(reads_t, refs_t, *params)
    cells = reads_t.numel() * refs_t.numel()

    def one_pass():
        return cells / seconds_per_call(lambda: cuda_score.score_grid_diag(reads_t, refs_t, *params), iters, device) / 1e9

    rate, spread = _median(one_pass, repeats)
    return rate, spread, (reads, refs, grid.cpu().numpy())


def bench_e2e(params=PARAMS, *, n_reads=512, n_refs=256, iters=5, repeats=REPEATS, device="cuda"):
    """Shipped-path rate: ``TorchBatchBackend.totals`` on the mixed
    workload, each pass the mean of ``iters`` calls: (median real GCUPS,
    spread, (reads, refs, totals))."""
    reads, refs = _mixed_workload(np.random.default_rng(1), n_reads, n_refs)
    real_cells = sum(map(len, reads)) * sum(map(len, refs))
    backend = TorchBatchBackend(AlignConfig(ref_dir=".", in_dir=".", out_dir=".", scoring=_scoring(params)), device)
    totals = backend.totals(reads, refs)  # warm

    def one_pass():
        t0 = time.perf_counter()
        for _ in range(iters):
            backend.totals(reads, refs)
        return real_cells * iters / (time.perf_counter() - t0) / 1e9

    rate, spread = _median(one_pass, repeats)
    return rate, spread, (reads, refs, totals)


def _corpus(total_bp: int, n_reads: int, corpus_root=None) -> tuple:
    """(root, meta) of the generated pipeline corpus, made once per size
    under ``corpus_root`` (default: ``swtorch_bench_corpus`` in the
    temporary directory).  It is written to a temporary directory and
    renamed into place, so a crashed or concurrent run never sees half a
    corpus."""
    base = corpus_root or os.path.join(tempfile.gettempdir(), "swtorch_bench_corpus")
    root = os.path.join(base, f"p{total_bp}_{n_reads}")
    marker = os.path.join(root, ".done")
    if not os.path.exists(marker):
        os.makedirs(base, exist_ok=True)
        tmp = tempfile.mkdtemp(prefix=os.path.basename(root) + ".tmp", dir=base)
        meta = refseq_like(os.path.join(tmp, "refs"), total_bp)
        meta["read_bp"] = reads_file(os.path.join(tmp, "inputs", "input1.fa"), n_reads)
        with open(os.path.join(tmp, ".done"), "w") as f:
            json.dump(meta, f)
        if os.path.isdir(root) and not os.path.exists(marker):
            shutil.rmtree(root)  # a partial corpus of a crashed run
        try:
            os.rename(tmp, root)
        except OSError:  # a concurrent run renamed its corpus first
            shutil.rmtree(tmp, ignore_errors=True)
        if not os.path.exists(marker):
            raise RuntimeError(f"corpus generation failed: {root}")
    with open(marker) as f:
        return root, json.load(f)


def bench_pipeline(params=PARAMS, *, total_bp=64_000_000, n_reads=512, repeats=REPEATS, device="cuda",
                   corpus_root=None):
    """Sustained ``run_pipeline`` rate over a RefSeq-shaped corpus, after
    one warm pass: (median real GCUPS, spread, (meta, report path))."""
    root, meta = _corpus(total_bp, n_reads, corpus_root)
    real_cells = meta["read_bp"] * meta["ref_bp"]

    def one_pass(tag):
        config = AlignConfig(
            ref_dir=os.path.join(root, "refs"), in_dir=os.path.join(root, "inputs"),
            out_dir=os.path.join(root, f"out_{tag}"), scoring=_scoring(params),
        )
        _sync(device)
        t0 = time.perf_counter()
        (report,) = run_pipeline(config, device=device)
        return real_cells / (time.perf_counter() - t0) / 1e9, report

    _, report = one_pass("warm")
    rate, spread = _median(lambda: one_pass("timed")[0], repeats)
    return rate, spread, (meta, report)


def bench_corpus(params=PARAMS, *, total_bp=256_000_000, n_reads=512, **kw):
    """The >= 0.25 Gbp corpus regime: 256 Mbp x 512 reads."""
    return bench_pipeline(params, total_bp=total_bp, n_reads=n_reads, **kw)


def bench_readscale(params=PARAMS, *, total_bp=8_000_000, n_reads=20_000, **kw):
    """The read-scale regime: 20,000 reads x 8 Mbp."""
    return bench_pipeline(params, total_bp=total_bp, n_reads=n_reads, **kw)


def bench_longref(params=PARAMS, *, n_reads=64, read_len=128, n_refs=8, ref_len=131_072, iters=5,
                  repeats=REPEATS, device="cuda"):
    """Long references (K1 on 131 kb refs, the windowed traceback through
    K2), one read planted in the first ref.  Each pass gives the sustained
    rate (``iters`` ``best_of_async`` flushes queued, then resolved), the
    mean rate of ``iters`` single ``totals`` calls, and one warm traceback
    of the first ref in ms.  Returns {name: (median, spread)} for
    "sustained", "single" and "traceback_ms", and (reads, refs, totals)."""
    rng = np.random.default_rng(5)
    reads = _seqs(rng, [read_len] * n_reads)
    refs = _seqs(rng, [ref_len] * n_refs)
    at = min(50_000, (ref_len - read_len) // 2)
    refs[0] = refs[0][:at] + reads[0] + refs[0][at + read_len:]
    real_cells = sum(map(len, reads)) * sum(map(len, refs))
    backend = TorchBatchBackend(AlignConfig(ref_dir=".", in_dir=".", out_dir=".", scoring=_scoring(params)), device)
    totals = backend.totals(reads, refs)  # warm
    backend.best_of(reads, refs)
    if int(totals[0]) < int(params[0]) * read_len:
        raise RuntimeError(f"longref: the planted read does not win ({int(totals[0])})")
    backend.sites_for_ref(refs[0], reads)  # warm

    def one_pass():
        t0 = time.perf_counter()
        for _ in range(iters):
            backend.totals(reads, refs)
        single = real_cells * iters / (time.perf_counter() - t0) / 1e9
        t0 = time.perf_counter()
        resolvers = [backend.best_of_async(reads, refs) for _ in range(iters)]
        best_seen = max(resolve()[0] for resolve in resolvers)
        sustained = real_cells * iters / (time.perf_counter() - t0) / 1e9
        if best_seen != int(totals.max()):
            raise RuntimeError(f"longref: async winner {best_seen} != totals max {int(totals.max())}")
        _sync(device)
        t0 = time.perf_counter()
        sites = backend.sites_for_ref(refs[0], reads)
        tb_ms = (time.perf_counter() - t0) * 1e3
        if not any(site[1][1] == reads[0] for site in sites):
            raise RuntimeError("longref: the traceback missed the planted read")
        return sustained, single, tb_ms

    passes = [one_pass() for _ in range(repeats)]
    out = {}
    for k, name in enumerate(("sustained", "single", "traceback_ms")):
        values = sorted(p[k] for p in passes)
        out[name] = (values[len(values) // 2], values)
    return out, (reads, refs, totals)


def roofline_rows(device="cuda", warps=ROOFLINE_WARPS) -> int:
    """Rows of the roofline leg on the card: 2 rows a warp (K6's 16-bit
    form) x 4 schedulers x the SMs x ``warps`` warps a scheduler, so that
    the step chain fills the card as the kernel leg's K4 launch does."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"roofline_rows sizes the leg from a card, not {device}: pass rb")
    return 2 * 4 * torch.cuda.get_device_properties(device).multi_processor_count * warps


def bench_roofline(params=PARAMS, *, rb=None, m=128, steps=ROOFLINE_STEPS, iters=20, unroll=64, repeats=REPEATS,
                   device="cuda"):
    """The step-chain ceiling through K6 at the kernel leg's read width:
    (median padded GCUPS, spread).  Every row restarts at lane 0, as each
    read of the kernel leg does, so K6 runs in the form that K4 takes there
    (:func:`..ops.cuda_score.k1_form`); raises if K6's rule
    (:func:`..ops.cuda_score.step_form`) gives another.  ``rb=None``:
    :func:`roofline_rows`."""
    rb = roofline_rows(device) if rb is None else rb
    form = cuda_score.step_form(m, steps // unroll * unroll, *params, lane0_starts=True)
    if form != cuda_score.k1_form(m, *params):
        raise RuntimeError(f"roofline: K6 would run {form}, K4 {cuda_score.k1_form(m, *params)} at m={m}")
    return _median(
        lambda: step_roofline(rb=rb, m=m, steps=steps, iters=iters, unroll=unroll, params=params, device=device,
                              lane0_starts=True),
        repeats,
    )


def _oracle_rate(reads, refs, params):
    """(serial oracle cells per second, {(read, ref): best score})."""
    scoring = _scoring(params)
    cells = 0
    scores = {}
    t0 = time.perf_counter()
    for ri, read in enumerate(reads):
        for ci, ref in enumerate(refs):
            scores[(ri, ci)] = oracle.opt_alignments(ref, read, scoring)[0]
            cells += len(read) * len(ref)
    return cells / (time.perf_counter() - t0), scores


def run_smoke(device="cuda") -> str:
    """Every kernel of the port against its plain version at small shapes
    (K1 also in every ``lane_best_packed`` mode, K4 also against the
    oracle): "pass" or "fail:<kernel>: <what>".  On the CPU the wrappers
    run the plain versions, so there it checks only the control flow."""
    rng = np.random.default_rng(42)
    dev = torch.device(device)

    def up(arr):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)

    reads = _seqs(rng, rng.integers(1, 151, size=24))
    refs = _seqs(rng, [0, 1, 64, 200, 511, 1024, 2048, 333])
    packed, start = pack_reads(reads, 256)
    flat, lens = encode_concat(refs)
    offsets = np.concatenate(([0], np.cumsum(lens)[:-1])).astype(np.int64)
    k1_args = (up(packed), up(flat), up(lens.astype(np.int32)), *PARAMS)
    refs_pad = up(encode_batch(refs[2:], 2048, REF_PAD))
    reads_enc = up(encode_batch(reads, 152, READ_PAD))
    chain_reads = up((rng.integers(2, 6, size=(8, 128)) | np.where(rng.random((8, 128)) < 0.05, 256, 0)).astype(np.int32))
    variant_refs = up(encode_batch(_seqs(rng, [96, 96]), 96, REF_PAD))
    seg_lens = np.minimum(lens[2:], 300).astype(np.int32)
    band_args = (
        up(packed), up(flat), up(offsets[2:]), up(seg_lens), up(np.full(len(seg_lens), 300, np.int32)),
        up(rng.integers(0, 50, size=(len(seg_lens),) + packed.shape).astype(np.int32)), *PARAMS,
    )
    start_t = up(start.astype(np.int64))

    def k1():
        want = read_best(cuda_score.lane_best_packed_varlen_plain(*k1_args, offsets=up(offsets)), start)
        got = [read_best(cuda_score.lane_best_packed_varlen(*k1_args, offsets=up(offsets)), start)]
        want_pad = read_best(cuda_score.lane_best_packed_varlen_plain(up(packed), refs_pad, up(np.full(6, 2048, np.int32)),
                                                                      *PARAMS), start)
        for mode in cuda_score.LANE_BEST_MODES:
            got.append(read_best(cuda_score.lane_best_packed(up(packed), refs_pad, *PARAMS, mode=mode), start))
        return [(got[0], want)] + [(g, want_pad) for g in got[1:]]

    def k2():
        got = cuda_score.argmax_lane(reads_enc[:8], refs_pad[:3], *PARAMS)
        want = cuda_score.argmax_lane_plain(reads_enc[:8], refs_pad[:3], *PARAMS)
        consumed = want[0] == want[0].amax(dim=2, keepdim=True)
        return [(g[consumed], w[consumed]) for g, w in zip(got, want)]

    def k3():
        (gl, gb), (wl, wb) = cuda_score.band_lane_best(*band_args), cuda_score.band_lane_best_plain(*band_args)
        c = len(seg_lens)
        return [(gl.reshape(c, -1)[:, start_t], wl.reshape(c, -1)[:, start_t]), (gb, wb)]

    def k4():
        got = cuda_score.score_grid_diag(reads_enc, refs_pad, *PARAMS)
        want = [[oracle.opt_alignments(f, r)[0] for f in refs[2:4]] for r in reads[:4]]
        return [(got, cuda_score.score_grid_diag_plain(reads_enc, refs_pad, *PARAMS)),
                (got[:4, :2].cpu(), torch.tensor(want, dtype=torch.int32))]

    def k5():
        return [(cuda_score.score_grid_row(reads_enc, refs_pad, *PARAMS), score_grid(reads_enc, refs_pad, *PARAMS))]

    def k6():
        return [
            (cuda_score.step_chain_best(chain_reads, steps=512, unroll=u, masked=masked),
             cuda_score.step_chain_best_plain(chain_reads, 512, u, *PARAMS, masked))
            for u, masked in ((64, False), (7, False), (64, True), (7, True))
        ]

    def k7():
        return [
            (cuda_score.step_variant_best(up(packed[:8, :128]), variant_refs, variant=v),
             cuda_score.step_variant_best_plain(up(packed[:8, :128]), variant_refs, v, 16, *PARAMS))
            for v in cuda_score.STEP_VARIANTS
        ]

    for name, check in (("K1", k1), ("K2", k2), ("K3", k3), ("K4", k4), ("K5", k5), ("K6", k6), ("K7", k7)):
        try:
            for got, want in check():
                if not torch.equal(got.to(torch.int64), want.to(torch.int64)):
                    return f"fail:{name}: {int((got.to(torch.int64) != want.to(torch.int64)).sum())} mismatched values"
        except Exception as e:  # noqa: BLE001 - a failed check is reported in the line
            return f"fail:{name}: {type(e).__name__}: {str(e)[:160]}"
    return "pass"


def card_name(device="cuda") -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    if torch.device(device).type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[torch.device(device).index or 0]


def run_bench(device="cuda", repeats=REPEATS, sizes=None):
    """Run every leg, the parity checks and the smoke.  ``sizes`` maps a
    leg name to keyword arguments of its function (the tests shrink the
    legs).  Returns (the JSON line's dict, {leg: kernel launches during
    that leg, with K1's, K2's, K4's, K6's, K7's and K8's per form as
    ``k1_<form>`` .. ``k8_<form>``})."""
    sizes = sizes or {}
    launches = {}
    forms = {"k1": cuda_score.K1_FORMS, "k2": cuda_score.K2_FORMS, "k4": cuda_score.K4_FORMS,
             "k6": cuda_score.K6_FORMS, "k7": cuda_score.K7_FORMS, "k8": cuda_score.K8_FORMS}

    def leg(name, fn):
        cuda_score.reset_launches()
        out = fn(PARAMS, repeats=repeats, device=device, **sizes.get(name, {}))
        launches[name] = {**cuda_score.LAUNCHES, **{f"{k}_{form}": n for k, counts in forms.items()
                                                    for form, n in counts.items()}}
        return out

    kernel, kernel_spread, (kreads, krefs, kgrid) = leg("kernel", bench_kernel)
    e2e, e2e_spread, (ereads, erefs, etotals) = leg("e2e", bench_e2e)
    pipeline, pipeline_spread, _ = leg("pipeline", bench_pipeline)
    corpus, corpus_spread, _ = leg("corpus", bench_corpus)
    readscale, readscale_spread, _ = leg("readscale", bench_readscale)
    longref, _ = leg("longref", bench_longref)
    roofline, roofline_spread = leg("roofline", bench_roofline)

    oracle_rate, want = _oracle_rate(kreads[:2], krefs[:2], PARAMS)
    for (ri, ci), w in want.items():
        if int(kgrid[ri, ci]) != w:
            raise RuntimeError(f"PARITY FAIL kernel ({ri},{ci}): {int(kgrid[ri, ci])} != {w}")
    _, want_e2e = _oracle_rate(ereads, erefs[:2], PARAMS)
    for ci in range(2):
        w = sum(want_e2e[(ri, ci)] for ri in range(len(ereads)))
        if int(etotals[ci]) != w:
            raise RuntimeError(f"PARITY FAIL e2e totals[{ci}]: {int(etotals[ci])} != {w}")
    smoke = run_smoke(device)

    m, n = len(kreads[0]), len(krefs[0])
    result = {
        "metric": "e2e_real_cell_rate",
        "value": e2e,
        "unit": "GCUPS",
        "vs_baseline": e2e * 1e9 / oracle_rate,
        "kernel_gcups": kernel,
        "pipeline_gcups": pipeline,
        "longref_gcups": longref["sustained"][0],
        "longref_single_gcups": longref["single"][0],
        "corpus_gcups": corpus,
        "readscale_gcups": readscale,
        "longref_traceback_ms": longref["traceback_ms"][0],
        "roofline_gcups": roofline,
        # Step rates: the kernel leg counts r*m*c*n cells but runs m+n-1
        # diagonal steps per n columns; the step chain counts steps.
        "kernel_pct_roofline": kernel * (m + n - 1) / n / roofline * 100,
        "kernel_vs_e2e": kernel / max(e2e, 1e-9),
        "kernel_spread": kernel_spread,
        "e2e_spread": e2e_spread,
        "pipeline_spread": pipeline_spread,
        "corpus_spread": corpus_spread,
        "readscale_spread": readscale_spread,
        "longref_spread": longref["sustained"][1],
        "longref_single_spread": longref["single"][1],
        "longref_traceback_spread": longref["traceback_ms"][1],
        "roofline_spread": roofline_spread,
        "thresholds": "none",
        "smoke": smoke,
        "threshold_detail": None,
        # A wide spread or a kernel slower than the whole path points at
        # the machine, not the code.
        "env_suspect": bool(
            min(kernel_spread) < 0.75 * max(kernel_spread)
            or min(e2e_spread) < 0.75 * max(e2e_spread)
            or kernel < e2e
        ),
        "card": card_name(device),
    }
    return result, launches


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m sparksmithwaterman_tpu_torch.bench",
        description="Headline benchmark of the PyTorch/CUDA port: one JSON line.",
    )
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"bench: device {args.device!r} requested but CUDA is not available", file=sys.stderr)
        return 2
    result, _ = run_bench(device)
    print(json.dumps(result))
    return 0 if result["smoke"] == "pass" else 1


if __name__ == "__main__":
    sys.exit(main())
