#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds
each one against its plain PyTorch version on the card, then drives the
port's main path (``swtorch align --strategy batch``) end to end:

0. card name and power limit, kernel build time;
1. K1 (packed lane best) against its plain version: 512 reads x 256
   RefSeq-shaped refs, every start lane; 64 reads x 8 refs of 131,072 bp
   against the row-form recurrence; edge cases (empty reads, length-0 and
   length-1 refs, all-pad rows, 512-lane rows);
2. K2 (per-lane argmax) against its plain version: 2,000 reads x one 2 kb
   ref and 64 reads x one 131 kb ref, on the lanes the traceback reads;
3. correctness leg: ``cli.main(["align", ...])`` on a ~1 Mbp RefSeq-shaped
   corpus with a 512-read input (full-fill traceback) and a 2,000-read
   input (windowed traceback through K2); each report's max score and
   winners must equal those from totals computed by the row-form
   recurrence, and the sites of the first 16 reads must equal the oracle's;
4. scale leg: ``run_pipeline`` on a 64 Mbp RefSeq-shaped corpus plus
   8 refs of 131,072 bp, 512 reads; wall time, real GCUPS, parse time.

Launch counts are reset just before phase 3 and read just after phase 4;
both kernels must have launched there.  Any failure raises and exits
non-zero.  The second-to-last line is the kernels' JSON summary; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 20261016
PARAMS = (5, -3, -4)
LONG_N = 131_072


def fail_unless(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def rand_seqs(rng, lens):
    table = np.frombuffer(b"ACGT", np.uint8)
    return [table[rng.integers(0, 4, size=int(n))].tobytes().decode() for n in lens]


def cuda_ms(fn, iters: int) -> float:
    """Mean device milliseconds of fn() over iters launches, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def register_summary(ptxas_log: str):
    """{kernel: ["L=<lanes>:<registers>r[+<spill bytes>s]", ...]} from nvcc's -Xptxas -v log."""
    import re

    out, current = collections.defaultdict(list), None
    for line in ptxas_log.splitlines():
        m = re.search(r"Compiling entry function '.*?([a-z_]+_kernel)ILi(\d+)E", line)
        if m:
            current = [m.group(1), m.group(2), 0]
        elif current and "bytes spill stores" in line:
            current[2] = int(re.search(r"(\d+) bytes spill stores", line).group(1))
        elif current and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out[current[0]].append(f"L={current[1]}:{regs}r" + (f"+{current[2]}s" if current[2] else ""))
            current = None
    return dict(out)


def parse_report(path):
    """(max score, {winner metadata: [sites]}) of a report file."""
    lines = open(path).read().split("\n")
    max_score = int(next(l for l in lines if l.startswith("Maximum alignment score = ")).split("= ")[1])
    winners, cur, i = {}, None, 0
    while i < len(lines):
        if lines[i] == "Reference:":
            cur = lines[i + 1]
            winners[cur] = []
            i += 4
        elif cur is not None and lines[i].startswith("\tIndex = "):
            winners[cur].append((int(lines[i][len("\tIndex = "):]), (lines[i + 1][1:], lines[i + 2][1:])))
            i += 4
        else:
            i += 1
    return max_score, winners


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from sparksmithwaterman_tpu_torch import cli
    from sparksmithwaterman_tpu_torch.config import AlignConfig
    from sparksmithwaterman_tpu_torch.core import oracle
    from sparksmithwaterman_tpu_torch.io import get_reads, get_ref_seqs, iter_files
    from sparksmithwaterman_tpu_torch.io.fasta import READ_PAD, REF_PAD, encode_batch, encode_concat
    from sparksmithwaterman_tpu_torch.metrics.engineer_data import reads_file, refseq_like, scale_corpus
    from sparksmithwaterman_tpu_torch.models.batch_backend import TorchBatchBackend
    from sparksmithwaterman_tpu_torch.models.pipeline import run_pipeline
    from sparksmithwaterman_tpu_torch.ops import _cuda, cuda_score
    from sparksmithwaterman_tpu_torch.ops.longseq import find_max_cells_batched, sites_for_ref_long_batched
    from sparksmithwaterman_tpu_torch.ops.packing import pack_reads, read_best
    from sparksmithwaterman_tpu_torch.ops.recurrence import score_grid

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[0] card: {smi}")
    print(f"[0] torch {torch.__version__} cuda {torch.version.cuda}; {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _cuda.lib()
    print(f"[0] kernel library {os.path.basename(_cuda.build_info['path'])}: nvcc {_cuda.build_info['seconds']:.2f} s"
          f" (load total {time.perf_counter() - t0:.2f} s)", flush=True)
    for name, widths in register_summary(_cuda.build_info["log"]).items():
        print(f"[0] ptxas {name}: {' '.join(sorted(widths, key=lambda w: int(w[2:].split(':')[0])))}")

    def up(arr):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)

    def k1_args(reads, refs, m_pack, padded=False, row_multiple=8):
        """K1's inputs on the card, the start lanes and the order of the
        refs: by default as the main path gives them (one flat reference
        buffer read by offset, longest first); with padded=True as a
        (C, N) REF_PAD-padded batch in the given order."""
        packed, start = pack_reads(reads, m_pack, row_multiple)
        if padded:
            lens = np.array([len(r) for r in refs], np.int32)
            refs_pad = up(encode_batch(refs, max(1, int(lens.max())), REF_PAD))
            return (up(packed), refs_pad, up(lens), None), start, np.arange(len(refs))
        flat, lens = encode_concat(refs)
        offsets = np.concatenate(([0], np.cumsum(lens)[:-1])).astype(np.int64)
        order = np.argsort(-lens, kind="stable")
        return (up(packed), up(flat), up(lens[order].astype(np.int32)), up(offsets[order])), start, order

    def k1(fn, args):
        packed, refs, lens, offsets = args
        return fn(packed, refs, lens, *PARAMS, offsets=offsets)

    def k1_err(args, start):
        k = read_best(k1(cuda_score.lane_best_packed_varlen, args), start)
        p = read_best(k1(cuda_score.lane_best_packed_varlen_plain, args), start)
        return int((k.to(torch.int64) - p).abs().max()) if k.numel() else 0

    # -- 1. K1 against its plain version -----------------------------------
    reads_1 = rand_seqs(rng, rng.integers(80, 151, size=512))
    refs_1 = rand_seqs(rng, rng.integers(500, 4000, size=256))
    args_1, start_1, _ = k1_args(reads_1, refs_1, 256)
    k1_max_err = k1_err(args_1, start_1)
    fail_unless(k1_max_err == 0, f"K1 differs from plain at start lanes (max abs err {k1_max_err})")
    k1_ms = cuda_ms(lambda: k1(cuda_score.lane_best_packed_varlen, args_1), 10)
    torch.cuda.synchronize()
    t = time.perf_counter()
    k1(cuda_score.lane_best_packed_varlen_plain, args_1)
    torch.cuda.synchronize()
    k1_plain_ms = (time.perf_counter() - t) * 1e3
    cells_1 = sum(map(len, reads_1)) * sum(map(len, refs_1))
    print(f"[1] K1 512 reads x 256 refs (500-4000 bp, flat buffer), rows {tuple(args_1[0].shape)}: max abs err 0; "
          f"kernel {k1_ms:.3f} ms ({cells_1 / k1_ms / 1e6:.1f} GCUPS real cells), plain {k1_plain_ms:.1f} ms", flush=True)

    reads_l = rand_seqs(rng, rng.integers(80, 151, size=64))
    refs_l = rand_seqs(rng, [LONG_N] * 8)
    args_l, start_l, _ = k1_args(reads_l, refs_l, 256)
    got_l = read_best(k1(cuda_score.lane_best_packed_varlen, args_l), start_l)
    refs_l_pad = up(encode_batch(refs_l, LONG_N, REF_PAD))
    want_l = torch.cat(
        [score_grid(up(encode_batch(reads_l, 152, READ_PAD)), refs_l_pad[c : c + 2], *PARAMS) for c in range(0, 8, 2)],
        dim=1,
    )
    err_l = int((got_l.to(torch.int64) - want_l).abs().max())
    fail_unless(err_l == 0, f"K1 at 131 kb refs differs from the row-form recurrence ({err_l})")
    kl_ms = cuda_ms(lambda: k1(cuda_score.lane_best_packed_varlen, args_l), 3)
    cells_l = sum(map(len, reads_l)) * 8 * LONG_N
    print(f"[1] K1 64 reads x 8 refs of {LONG_N} bp vs row-form recurrence: max abs err 0; "
          f"kernel {kl_ms:.3f} ms ({cells_l / kl_ms / 1e6:.1f} GCUPS real cells)", flush=True)

    edge_reads = ["", "A", "ACGT" * 10, ""] + rand_seqs(rng, rng.integers(1, 120, size=20))
    edge_refs = ["", "A", "C"] + rand_seqs(rng, [2, 700, 2049])
    for m_pack in (128, 512):
        for padded in (False, True):
            args, start, order = k1_args(edge_reads, edge_refs, m_pack, padded, row_multiple=32)
            fail_unless((args[0][-1] == 256).sum() == 1, "edge case lacks an all-pad row")
            err = k1_err(args, start)
            fail_unless(err == 0, f"K1 edge cases differ at m_pack={m_pack}, padded={padded} ({err})")
            cols = [k for k, c in enumerate(order) if len(edge_refs[c]) <= 2]
            want = np.array([[oracle.opt_alignments(edge_refs[order[k]], r)[0] for k in cols] for r in edge_reads[:8]])
            got = read_best(k1(cuda_score.lane_best_packed_varlen, args), start)[:8, cols].cpu().numpy()
            fail_unless((got == want).all(), f"K1 edge cases differ from the oracle at m_pack={m_pack}, padded={padded}")
    print("[1] K1 edge cases (empty reads, 0/1 bp refs, all-pad rows, m_pack 128 and 512, flat and padded refs): "
          "equal to plain and oracle", flush=True)

    # -- 2. K2 against its plain version -----------------------------------
    def k2_err(reads, ref):
        m_pad = max(8, -(-max(map(len, reads)) // 8) * 8)
        args = (up(encode_batch(reads, m_pad, READ_PAD)), up(encode_batch([ref], len(ref), REF_PAD)))
        k = cuda_score.argmax_lane(*args, *PARAMS)
        p = cuda_score.argmax_lane_plain(*args, *PARAMS)
        consumed = p[0] == p[0].amax(dim=2, keepdim=True)
        fail_unless(torch.equal(k[0] == k[0].amax(dim=2, keepdim=True), consumed), "K2 max lanes differ")
        err = max(int((a.to(torch.int64) - b)[consumed].abs().max()) for a, b in zip(k, p))
        return err, args

    reads_2 = rand_seqs(rng, rng.integers(80, 151, size=2000))
    ref_2 = rand_seqs(rng, [2000])[0]
    k2_max_err, args_2 = k2_err(reads_2, ref_2)
    fail_unless(k2_max_err == 0, f"K2 differs from plain on consumed lanes ({k2_max_err})")
    k2_ms = cuda_ms(lambda: cuda_score.argmax_lane(*args_2, *PARAMS), 10)
    torch.cuda.synchronize()
    t = time.perf_counter()
    cuda_score.argmax_lane_plain(*args_2, *PARAMS)
    torch.cuda.synchronize()
    k2_plain_ms = (time.perf_counter() - t) * 1e3
    print(f"[2] K2 2000 reads x 2 kb ref: max abs err 0; kernel {k2_ms:.3f} ms, plain {k2_plain_ms:.1f} ms", flush=True)
    err, args_2l = k2_err(reads_l, refs_l[0])
    fail_unless(err == 0, f"K2 at a 131 kb ref differs from plain ({err})")
    k2l_ms = cuda_ms(lambda: cuda_score.argmax_lane(*args_2l, *PARAMS), 3)
    print(f"[2] K2 64 reads x {LONG_N} bp ref: max abs err 0; kernel {k2l_ms:.3f} ms", flush=True)

    with tempfile.TemporaryDirectory(prefix="swtorch_smoke_") as work:
        # -- 3/4: the main path; launch counts cover exactly these runs ----
        slice_root = os.path.join(work, "slice")
        refseq_like(os.path.join(slice_root, "refs"), 1_000_000, seed=SEED + 3)
        reads_file(os.path.join(slice_root, "inputs", "input1.fa"), 512, seed=SEED + 4)
        reads_file(os.path.join(slice_root, "inputs", "input2.fa"), 2000, seed=SEED + 5)
        scale_root = os.path.join(work, "scale")
        corpus = scale_corpus(scale_root, long_len=LONG_N, seed=SEED + 6)

        cuda_score.reset_launches()
        t = time.perf_counter()
        rc = cli.main([
            "align", "--ref-dir", os.path.join(slice_root, "refs"),
            "--in-dir", os.path.join(slice_root, "inputs"),
            "--out-dir", os.path.join(slice_root, "out"), "--device", "cuda",
        ])
        slice_s = time.perf_counter() - t
        fail_unless(rc == 0, f"swtorch align exited {rc}")
        slice_launches = dict(cuda_score.LAUNCHES)
        print(f"[3] swtorch align: 2 inputs (512, 2000 reads) x 1 Mbp in {slice_s:.2f} s; launches {slice_launches}", flush=True)

        config = AlignConfig(
            ref_dir=os.path.join(scale_root, "refs"),
            in_dir=os.path.join(scale_root, "inputs"),
            out_dir=os.path.join(scale_root, "out"),
        )
        backend = TorchBatchBackend(config, dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        (scale_report,) = run_pipeline(config, backend=backend, device=dev)
        torch.cuda.synchronize()
        scale_s = time.perf_counter() - t
        launches = dict(cuda_score.LAUNCHES)
        fail_unless(all(n > 0 for n in launches.values()), f"a kernel of the main path never launched: {launches}")

        ref_bp, scale_read_bp = corpus["ref_bp"], corpus["read_bp"]
        parse_t = time.perf_counter()
        scale_refs = [rec for path in iter_files(config.ref_dir) for rec in get_ref_seqs(path, ">gi")]
        parse_s = time.perf_counter() - parse_t
        fail_unless(sum(len(s) for _, s in scale_refs) == ref_bp, "scale corpus size mismatch")
        print(f"[4] run_pipeline: 512 reads ({scale_read_bp} bp) x {len(scale_refs)} refs ({ref_bp} bp, "
              f"{corpus['files']} files): wall {scale_s:.3f} s, real {scale_read_bp * ref_bp / scale_s / 1e9:.1f} GCUPS; "
              f"scoring dispatch window {backend.gcups.report()}; host parse {parse_s:.3f} s", flush=True)
        print(f"[4] launches over phases 3-4: {launches}", flush=True)

        # -- checks of what the main path wrote ------------------------------
        slice_refs = [rec for path in iter_files(os.path.join(slice_root, "refs")) for rec in get_ref_seqs(path, ">gi")]
        by_len = sorted(range(len(slice_refs)), key=lambda i: len(slice_refs[i][1]))
        for k, n_reads in ((1, 512), (2, 2000)):
            reads = get_reads(os.path.join(slice_root, "inputs", f"input{k}.fa"), ">gi")
            fail_unless(len(reads) == n_reads, f"input{k} has {len(reads)} reads")
            reads_enc = up(encode_batch(reads, 152, READ_PAD))
            totals = np.zeros(len(slice_refs), np.int64)
            step = max(1, (1 << 28) // (len(reads) * 4000))
            for s in range(0, len(by_len), step):
                idx = by_len[s : s + step]
                refs_enc = encode_batch([slice_refs[i][1] for i in idx], len(slice_refs[idx[-1]][1]), REF_PAD)
                totals[idx] = score_grid(reads_enc, up(refs_enc), *PARAMS).sum(dim=0, dtype=torch.int64).cpu().numpy()
            best = int(totals.max())
            want_winners = {slice_refs[i][0] for i in np.flatnonzero(totals == best)}
            max_score, winners = parse_report(os.path.join(slice_root, "out", f"result{k}.txt"))
            fail_unless(max_score == best, f"result{k}: max score {max_score}, recurrence says {best}")
            fail_unless(set(winners) == want_winners, f"result{k}: winners {sorted(winners)} vs {sorted(want_winners)}")
            seqs = dict(slice_refs)
            n_sites = 0
            for meta, sites in winners.items():
                seq = seqs[meta]
                windowed = backend._windowed(seq, reads)
                if windowed:  # per-read lists through K2, each in row-major order
                    cells = find_max_cells_batched(reads, seq, PARAMS, device=dev)
                    per_read = sites_for_ref_long_batched(seq, reads, PARAMS, cell_lists=cells, device=dev)
                else:  # full-fill branch, one read per dispatch; each read's sites sorted by index
                    per_read = [backend.sites_for_ref(seq, [r]) for r in reads]
                merged = sorted((s for p in per_read for s in p), key=lambda site: site[0])
                fail_unless(merged == sites, f"result{k}: report sites against {meta} differ from the per-read recomputation")
                want = [oracle.opt_alignments(seq, r)[1] for r in reads[:16]]
                if not windowed:
                    want = [sorted(w, key=lambda site: site[0]) for w in want]
                fail_unless(per_read[:16] == want, f"result{k}: sites of the first 16 reads differ from the oracle for {meta}")
                n_sites += len(sites)
            print(f"[3] result{k}.txt: max score {max_score} and {len(winners)} winner(s) equal the row-form "
                  f"recurrence; all {n_sites} report sites equal the per-read recomputation "
                  f"({'windowed' if windowed else 'full-fill'} branch), whose first 16 reads equal the oracle", flush=True)

        max_score, winners = parse_report(scale_report)
        scale_seqs = dict(scale_refs)
        scale_reads = up(encode_batch(get_reads(os.path.join(config.in_dir, "input1.fa"), ">gi"), 152, READ_PAD))
        fail_unless(max_score > 0 and winners, "scale report has no winner")
        for meta in winners:
            seq = scale_seqs[meta]
            total = int(score_grid(scale_reads, up(encode_batch([seq], len(seq), REF_PAD)), *PARAMS).sum())
            fail_unless(total == max_score, f"scale winner {meta}: total {total} != reported {max_score}")
            fail_unless(winners[meta], f"scale winner {meta} has no sites")
        print(f"[4] {os.path.basename(scale_report)}: max score {max_score}, winners {sorted(winners)} "
              f"(lengths {[len(scale_seqs[w]) for w in winners]}), totals equal the row-form recurrence", flush=True)

    kernels = [
        {
            "name": "lane_best_packed_varlen",
            "route": "cuda",
            "source": "sparksmithwaterman_tpu_torch/csrc/lane_best.cu",
            "replaces": "sparksmithwaterman_tpu/ops/pallas_score.py:865",
            "also_replaces": "sparksmithwaterman_tpu/ops/pallas_score.py:1801",
            "launches": launches["lane_best_packed_varlen"],
            "max_abs_err": k1_max_err,
            "ms": k1_ms,
            "plain_ms": k1_plain_ms,
        },
        {
            "name": "argmax_lane",
            "route": "cuda",
            "source": "sparksmithwaterman_tpu_torch/csrc/argmax.cu",
            "replaces": "sparksmithwaterman_tpu/ops/pallas_score.py:2214",
            "launches": launches["argmax_lane"],
            "max_abs_err": k2_max_err,
            "ms": k2_ms,
            "plain_ms": k2_plain_ms,
        },
    ]
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "sparksmithwaterman_tpu"))
    fail_unless(not leaked, f"the run loaded JAX or the JAX package: {leaked[:5]}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
